"""Camera rays of the megakernel (``camera_ray``, megakernel.py:482-509).

The kernel's form is authoritative: the pixel position is jittered by a
gaussian scaled by the anti-alias factor, mapped through constants the
host computes in double and rounds to f32 once, and the origin is the
camera origin already offset along -z by ``RAY_EPSILON``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.constants import RAY_EPSILON
from .vec3 import normalize3


class CameraConsts(NamedTuple):
    sx: float      # f32(2 * aspect * tan(fov/2))
    sy: float      # f32(-2 * tan(fov/2))
    inv_w: float   # f32(1 / image_width)
    inv_h: float   # f32(1 / image_height)
    aa: float      # f32(anti_alias_scale)


def camera_consts(params) -> CameraConsts:
    """Per-render camera constants (values exactly representable in f32,
    held as Python floats so torch scalars and C floats take them
    unchanged)."""
    tan_theta = float(np.tan(params.fov_radians / 2.0))
    aspect = params.image_width / params.image_height
    f = lambda x: float(np.float32(x))
    return CameraConsts(
        sx=f(2.0 * aspect * tan_theta), sy=f(-2.0 * tan_theta),
        inv_w=f(1.0 / params.image_width), inv_h=f(1.0 / params.image_height),
        aa=f(params.anti_alias_scale))


def camera_ray(pr: torch.Tensor, pc: torch.Tensor, g1: torch.Tensor,
               g2: torch.Tensor, cam: CameraConsts):
    """Ray (o, d) through pixel (row pr, column pc) jittered by the
    gaussian pair (g1, g2)."""
    pu = pr + g1 * cam.aa
    pv = pc + g2 * cam.aa
    xn = pv * cam.inv_w - 0.5
    yn = pu * cam.inv_h - 0.5
    d = normalize3((xn * cam.sx, yn * cam.sy, torch.full_like(xn, -1.0)))
    zero = torch.zeros_like(xn)
    return (zero, zero, torch.full_like(xn, -float(RAY_EPSILON))), d
