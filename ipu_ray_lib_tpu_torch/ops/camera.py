"""Camera rays.

* :func:`camera_ray` — the megakernel's form (``camera_ray``,
  megakernel.py:482-509), authoritative for the path trace: the pixel
  position is jittered by a gaussian scaled by the anti-alias factor,
  mapped through constants the host computes in double and rounds to f32
  once, and the origin is the camera origin already offset along -z by
  ``RAY_EPSILON``.
* :func:`generate_camera_rays` — the form of the JAX package's
  ops/camera.py (:16-63), which the shadow trace calls without jitter and
  the per-sample path trace (render/path.py) with a threefry key: the
  pixel position plus ``anti_alias_scale`` times a pair of
  ``jax.random.normal`` draws (utils/threefry.py), origin exactly 0,
  direction ``(x / w) - 0.5`` then ``2 * xn * aspect * tan(fov / 2)`` in
  f32, in that order, then divided by its length.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import threefry
from ..utils.constants import RAY_EPSILON
from .vec3 import fma, normalize3, sqrt


def tan_half_fov(fov_radians: float) -> float:
    """tan(f32(fov) / 2) correctly rounded to f32."""
    half = np.float32(fov_radians) / np.float32(2.0)
    return float(np.float32(np.tan(np.float64(half))))


def pixel_to_ray_dir(x: torch.Tensor, y: torch.Tensor, w: int, h: int,
                     tan_theta: float) -> torch.Tensor:
    """Unit direction [R, 3] through pixel coordinates (column x, row y):
    the image plane spans the full width fov.

    The arithmetic is the JAX function's as XLA compiles it for the shadow
    trace (under ``jit``, image size and fov static): a division by the
    image size becomes a product with its f32 reciprocal, fused with the
    ``- 0.5`` into one multiply-add; ``2 * aspect * tan`` folds into one
    f32 constant; the squared length is a chain of multiply-adds."""
    f32 = np.float32
    aspect = f32(w) / f32(h)
    sx = float(f32(f32(2.0) * aspect) * f32(tan_theta))
    sy = float(f32(-2.0) * f32(tan_theta))
    xn = fma(x, float(f32(1.0) / f32(w)), -0.5)
    yn = fma(y, float(f32(1.0) / f32(h)), -0.5)
    dx, dy = xn * sx, yn * sy
    n = sqrt(fma(dy, dy, dx * dx) + 1.0)
    return torch.stack([dx / n, dy / n, -1.0 / n], dim=-1)


def pixel_grid(window_w: int, window_h: int, window_c: int, window_r: int,
               device) -> tuple[torch.Tensor, torch.Tensor]:
    """Row/column coordinates [R] (f32) of a crop window, scanline order."""
    rows = torch.arange(window_r, window_r + window_h, dtype=torch.float32,
                        device=device)
    cols = torch.arange(window_c, window_c + window_w, dtype=torch.float32,
                        device=device)
    rr, cc = torch.meshgrid(rows, cols, indexing="ij")
    return rr.reshape(-1), cc.reshape(-1)


def generate_camera_rays(rows: torch.Tensor, cols: torch.Tensor,
                         image_width: int, image_height: int,
                         fov_radians: float, anti_alias_scale: float = 0.0,
                         key: torch.Tensor | None = None):
    """(origins [R, 3] zeros, directions [R, 3]) through pixel (rows,
    cols), jittered by ``anti_alias_scale`` times ``normal(key, (2, R))``
    when a threefry ``key`` is given and the scale is positive (rows by
    the first draw, columns by the second; each jitter fused into its sum,
    as XLA compiles it)."""
    if key is not None and anti_alias_scale > 0.0:
        g = threefry.normal(key, (2,) + tuple(rows.shape), rows.device)
        aa = float(np.float32(anti_alias_scale))
        rows, cols = fma(g[0], aa, rows), fma(g[1], aa, cols)
    dirs = pixel_to_ray_dir(cols, rows, image_width, image_height,
                            tan_half_fov(fov_radians))
    return torch.zeros_like(dirs), dirs


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
