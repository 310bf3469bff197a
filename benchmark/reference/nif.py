"""The NIF environment light in plain torch: a direction's radiance from
the network's weights, read from the asset files with the reference's
own reader.

The network (upstream ``NifModel``): the direction's equirect angles by
the published kernel's f32 polynomials for atan2 and acos, the rotation
added and wrapped, ``u = 2 (theta / pi - 1)``, ``v = 2 (phi / 2 pi - 1)``;
the features [sin(u 2^e), sin(v 2^e), cos(u 2^e), cos(v 2^e)], e < E,
correctly rounded; the Dense stack, the features concatenated back in
where a layer's input is that much wider; ``x * max + mean`` (the mean
less eps when log tone-mapped), ``exp`` when log tone-mapped, BGR to RGB.

The configuration states the precision of the dense layers: operands
rounded to ``operand`` (bfloat16), products summed in float32. The
control rounds them to the type below (float8 e4m3, saturating).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from .h5 import load_keras_h5

_ATAN_C0 = float(np.float32(-0.0117212))
_ATAN_C = tuple(float(np.float32(c)) for c in (
    0.05265332, -0.11643287, 0.19354346, -0.33262347, 0.99997726))
_PI = float(np.float32(np.pi))
_PI_BY_2 = float(np.float32(np.pi / 2.0))
_TWO_PI = float(np.float32(2.0 * np.pi))
_INV_PI = float(np.float32(1.0 / np.pi))
_HALF_INV_PI = float(np.float32(0.5 / np.pi))
_TINY = float(np.float32(1e-30))


def _f64(fn, x):
    return fn(x.to(torch.float64)).to(torch.float32)


def _atan2(y, x):
    ax, ay = torch.abs(x), torch.abs(y)
    z = torch.minimum(ax, ay) / torch.clamp_min(torch.maximum(ax, ay), _TINY)
    z2 = z * z
    a = z2 * _ATAN_C0 + _ATAN_C[0]
    for c in _ATAN_C[1:]:
        a = a * z2 + c
    a = a * z
    a = torch.where(ay > ax, _PI_BY_2 - a, a)
    a = torch.where(x < 0.0, _PI - a, a)
    return torch.where(y < 0.0, -a, a)


def _round(x, operand: str):
    if operand == "bfloat16":
        return x.to(torch.bfloat16).to(torch.float32)
    if operand == "float8_e4m3fn":
        return torch.clamp(x, -448.0, 448.0).to(torch.float8_e4m3fn).to(
            torch.float32)
    if operand == "float32":
        return x
    raise ValueError(f"unknown operand precision {operand!r}")


class PlainNif:
    """The network of one asset directory on ``device``."""

    def __init__(self, assets_dir: str, device, rotation: float = 0.0):
        with open(os.path.join(assets_dir, "nif_metadata.txt")) as f:
            meta = json.load(f)
        enc = meta["encode_params"]
        self.E = int(meta["embedding_dimension"])
        self.log = bool(enc["log_tone_map"])
        mean = np.asarray(enc["mean"], np.float32)
        if self.log:
            mean = mean - np.float32(enc["eps"])
        self.max = float(np.float32(enc["max"]))
        self.mean = torch.from_numpy(mean).to(device)
        h5 = sorted(c for c in os.listdir(assets_dir) if c.endswith(".h5"))
        w = load_keras_h5(os.path.join(assets_dir, h5[-1]))
        self.layers = []
        width = 4 * self.E
        for l in w.layers:
            k = torch.from_numpy(np.asarray(l.kernel, np.float32)).to(device)
            b = (torch.zeros(k.shape[1], device=device) if l.bias is None else
                 torch.from_numpy(np.asarray(l.bias, np.float32)).to(device))
            concat = k.shape[0] != width
            self.layers.append((k, b, l.activation == "relu", concat))
            width = k.shape[1]
        self.rotation = float(np.float32(rotation))

    @property
    def macs(self) -> int:
        """Multiply-adds per direction: the sum of the layers' widths
        in x out."""
        return sum(int(k.shape[0]) * int(k.shape[1])
                   for k, _, _, _ in self.layers)

    def __call__(self, dirs: torch.Tensor, operand: str = "bfloat16",
                 block: int = 1 << 18) -> torch.Tensor:
        return torch.cat([self._eval(dirs[i:i + block].to(torch.float32),
                                     operand)
                          for i in range(0, dirs.shape[0], block)])

    def _eval(self, dirs, operand):
        dy = torch.clamp(dirs[:, 1], -1.0, 1.0)
        theta = _atan2(_f64(torch.sqrt, torch.clamp_min(1.0 - dy * dy, 0.0)), dy)
        phi = _atan2(dirs[:, 2], dirs[:, 0]) + self.rotation
        phi = torch.where(phi < 0.0, phi + _TWO_PI, phi)
        phi = torch.where(phi > _TWO_PI, phi - _TWO_PI, phi)
        un = 2.0 * (theta * _INV_PI - 1.0)
        vn = 2.0 * (phi * _HALF_INV_PI - 1.0)
        coeff = (2 ** torch.arange(self.E, device=dirs.device)).to(torch.float32)
        pu, pv = un[:, None] * coeff, vn[:, None] * coeff
        feats = torch.cat([_f64(torch.sin, pu), _f64(torch.sin, pv),
                           _f64(torch.cos, pu), _f64(torch.cos, pv)], dim=1)
        x = feats
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            for k, b, relu, concat in self.layers:
                if concat:
                    x = torch.cat([x, feats], dim=1)
                x = _round(x, operand) @ _round(k, operand) + b
                if relu:
                    x = torch.clamp_min(x, 0.0)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
        bgr = x * self.max + self.mean
        if self.log:
            bgr = _f64(torch.exp, bgr)
        return bgr.flip(1)
