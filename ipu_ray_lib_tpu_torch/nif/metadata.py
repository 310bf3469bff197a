"""NIF metadata parsing and writing (a jax-free copy of
``ipu_ray_lib_tpu/nif/metadata.py`` ``NifMetadata``).

Reads the ``nif_metadata.txt`` JSON emitted by the NIF training tool
(format contract of ref src/neural_networks/NifMetaData.cpp): embedding
dimension, reconstructed image shape, tone-map parameters (eps / max /
mean / log flag — when log tone-mapping is on, eps is folded into the
mean exactly as the reference does at NifMetaData.cpp:49-53), and hidden
layer size recovered from the recorded training command.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import List

import numpy as np


@dataclass
class NifMetadata:
    embedding_dimension: int = 12
    name: str = ""
    image_shape: List[int] = field(default_factory=lambda: [0, 0, 3])
    eps: float = 1e-8
    log_tone_map: bool = True
    max: float = 1.0
    mean: np.ndarray = field(default_factory=lambda: np.zeros(3, np.float32))
    hidden_size: int = 0

    @classmethod
    def load(cls, path: str) -> "NifMetadata":
        with open(path) as f:
            pt = json.load(f)
        enc = pt["encode_params"]
        mean = np.asarray(enc["mean"], np.float32)
        eps = float(enc["eps"])
        log_tone_map = bool(enc["log_tone_map"])
        if log_tone_map:
            mean = mean - np.float32(eps)  # fold inverse eps into the mean

        hidden = 0
        cmd = pt.get("train_command", [])
        for i, tok in enumerate(cmd):
            if tok == "--layer-size" and i + 1 < len(cmd):
                hidden = int(cmd[i + 1])
        return cls(
            embedding_dimension=int(pt["embedding_dimension"]),
            name=pt.get("name", ""),
            image_shape=[int(x) for x in pt["original_image_shape"]],
            eps=eps,
            log_tone_map=log_tone_map,
            max=float(enc["max"]),
            mean=mean,
            hidden_size=hidden,
        )

    def save(self, path: str, train_command=None) -> None:
        """Write the JSON that :meth:`load` reads (eps unfolded from the
        mean again when log tone-mapped)."""
        mean = self.mean + (np.float32(self.eps) if self.log_tone_map else 0)
        doc = {
            "embedding_dimension": int(self.embedding_dimension),
            "embedding_sigma": 2.0,
            "encode_params": {
                "eps": float(self.eps),
                "log_tone_map": bool(self.log_tone_map),
                "max": float(self.max),
                "mean": [float(x) for x in mean],
                "transfer_function": "log" if self.log_tone_map else "linear",
            },
            "keras_model": "",
            "name": self.name,
            "original_image_shape": list(self.image_shape),
            "train_command": train_command or [
                "train_nif.py", "--layer-size", str(self.hidden_size)],
        }
        with open(path, "w") as f:
            json.dump(doc, f, indent=2)
