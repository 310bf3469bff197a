"""Compiled-scene caching: save/load a :class:`TorchScene` and its params
as one bundle (the port's counterpart of ``ipu_ray_lib_tpu/scene/cache.py``).

The JAX package's bundle keeps the raw mesh arrays and the BVH and
rebuilds its intersector tables at load, without the scene BVH's
triangle order; on a mixed scene above the VMEM ceiling its tables then
differ from a fresh build (ROADMAP queue 3). The port's bundle keeps the
finished tables themselves, every tensor of the ``TorchScene`` as built,
so a load equals a fresh :func:`~.build.build_scene` bit for bit and
skips the import, the BVH build and the table packing alike.

The container is :mod:`.serial`'s (aligned sections, a JSON header).
The header carries :data:`FORMAT`: a bundle the JAX package wrote (which
has no such tag) is refused at load, and the JAX package's loader fails
on the port's bundles (they have no BVH sections).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..runtime.device import cuda_device
from .build import SceneParams, TorchScene
from .serial import Deserialiser, Serialiser

FORMAT = "ipu_ray_lib_tpu_torch/compiled-scene/1"


def _tensor_fields(scene: TorchScene):
    for f in dataclasses.fields(scene):
        v = getattr(scene, f.name)
        if isinstance(v, torch.Tensor):
            yield f.name, v


def save_compiled_scene(path: str, scene: TorchScene,
                        params: SceneParams) -> None:
    """Write ``scene``'s tensors (copied to the host) and ``params``."""
    s = Serialiser()
    for name, t in _tensor_fields(scene):
        s.add(name, t.detach().cpu().numpy())
    meta = {"format": FORMAT, "params": dataclasses.asdict(params),
            "payload_split": bool(scene.payload_split)}
    with open(path, "wb") as f:
        f.write(s.tobytes(meta))


def load_compiled_scene(path: str, device=None
                        ) -> tuple[TorchScene, SceneParams]:
    """(TorchScene on ``device``, SceneParams) from a bundle written by
    :func:`save_compiled_scene`. ``device`` None means the CUDA card,
    which must be present; pass ``"cpu"`` for the plain versions. Raises
    ``ValueError`` on a bundle of another format."""
    if device is None:
        device = cuda_device()
    with open(path, "rb") as f:
        buf = bytearray(f.read())  # writable: the sections become tensors
    d = Deserialiser(buf)
    if d.meta.get("format") != FORMAT:
        raise ValueError(
            f"'{path}' is not a compiled-scene bundle of this package "
            f"(format {d.meta.get('format')!r}, want {FORMAT!r}; bundles of "
            "the JAX package's cache are not interchangeable)")
    names = set(d.names())
    tensors = {f.name: torch.from_numpy(d.get(f.name)).to(device)
               for f in dataclasses.fields(TorchScene) if f.name in names}
    scene = TorchScene(payload_split=bool(d.meta["payload_split"]),
                       **tensors)
    return scene, SceneParams(**d.meta["params"])
