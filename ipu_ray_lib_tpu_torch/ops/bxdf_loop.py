"""BxDF sampling of the XLA-loop integrator, on [R, 3] rows.

Port of ``ipu_ray_lib_tpu/ops/bxdf.py``, which the XLA-loop path tracer
(render/streaming.py ``streaming_path_trace``) and the glue shadow trace
(render/shadow.py) call; the megakernel's own forms, on component tuples,
are ops/bxdf.py. Same formulas, but written as XLA compiles the JAX
functions inside a ``jit`` on the CPU: a product feeding a sum or
difference is one fused multiply-add (``x*y + z*w`` fuses the first
product), a sum over the last axis is :func:`~.vec3.rowdot`, and square
roots are correctly rounded. ``cos``, ``sin`` and ``log`` are torch's;
XLA's round differently in the last place for some arguments.
"""

from __future__ import annotations

import torch

from ..utils.constants import PI_BY_2, PI_BY_4, RAY_EPSILON
from .vec3 import fma, rowdot, sqrt, unit

_PI2 = float(PI_BY_2)
_PI4 = float(PI_BY_4)
_EPS = float(RAY_EPSILON)


def _cols(v):
    return tuple(v[:, c] for c in range(3))


def orthonormal_system(n):
    """Tangent basis (v2, v3) of unit normals n [R, 3]."""
    n0, n1, n2 = _cols(n)
    use_x = (torch.abs(n0) > torch.abs(n1))[:, None]
    ilx = 1.0 / sqrt(fma(n0, n0, n2 * n2))
    ily = 1.0 / sqrt(fma(n1, n1, n2 * n2))
    zero = torch.zeros_like(n0)
    v2 = torch.where(use_x, torch.stack([-n2 * ilx, zero, n0 * ilx], -1),
                     torch.stack([zero, n2 * ily, -n1 * ily], -1))
    a, b = _cols(n), _cols(v2)
    v3 = torch.stack([fma(a[1], b[2], -(a[2] * b[1])),
                      fma(a[2], b[0], -(a[0] * b[2])),
                      fma(a[0], b[1], -(a[1] * b[0]))], -1)
    return v2, v3


def sample_diffuse(normal, u1, u2):
    """Cosine-weighted direction about ``normal`` [R, 3] (concentric disc
    map, then the tangent basis)."""
    ux = 2.0 * u1 - 1.0
    uy = 2.0 * u2 - 1.0
    use_x = torch.abs(ux) > torch.abs(uy)
    r = torch.where(use_x, ux, uy)
    safe_ux = torch.where(ux == 0.0, 1.0, ux)
    safe_uy = torch.where(uy == 0.0, 1.0, uy)
    th = torch.where(use_x, _PI4 * (uy / safe_ux),
                     fma(-_PI4, ux / safe_uy, _PI2))
    zero = (ux == 0.0) & (uy == 0.0)
    x = torch.where(zero, 0.0, r * torch.cos(th))
    y = torch.where(zero, 0.0, r * torch.sin(th))
    z = sqrt(torch.clamp_min(fma(-y, y, fma(-x, x, 1.0)), 0.0))
    xb, yb = orthonormal_system(normal)
    return fma(normal, z[:, None], fma(xb, x[:, None], yb * y[:, None]))


def reflect(ray_dir, normal):
    """Mirror reflection, re-normalised."""
    cos_theta = rowdot(ray_dir, normal)
    return unit(fma(-normal, (2.0 * cos_theta)[:, None], ray_dir))


def _schlick(cos_theta, ri):
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    base = 1.0 - cos_theta
    b2 = base * base
    return fma(1.0 - r0, (b2 * b2) * base, r0)


def dielectric(direction, normal, ior, u1):
    """Schlick-weighted reflect/refract; returns (new_dir, refracted)."""
    entering = rowdot(normal, direction) <= 0.0
    n = torch.where(entering[:, None], normal, -normal)
    ri = torch.where(entering, 1.0 / ior, ior)
    ndotr = rowdot(n, direction)
    cost1 = -ndotr
    cost2 = fma(-(ri * ri), fma(-cost1, cost1, 1.0), 1.0)
    do_refract = (cost2 > 0.0) & (u1 > _schlick(cost1, ri))
    r_perp = fma(n, (-ndotr)[:, None], direction) * ri[:, None]
    par_mag = sqrt(torch.abs(1.0 - rowdot(r_perp, r_perp)))
    d_refract = fma(n, -par_mag[:, None], r_perp)
    return (torch.where(do_refract[:, None], d_refract, reflect(direction, n)),
            do_refract)


def evaluate_roulette(u1, throughput):
    """(stop, reweighted throughput): survivors are scaled by 1/p, p the
    largest throughput component."""
    p = torch.amax(throughput, dim=-1)
    stop = (p == 0.0) | (u1 > p)
    safe_p = torch.where(p == 0.0, 1.0, p)
    return stop, torch.where(stop[:, None], throughput,
                             throughput / safe_p[:, None])


def offset_ray_origin(origin, direction, normal):
    """The origin pushed off the surface along +-normal, to the side
    ``direction`` leaves on, by RAY_EPSILON scaled with the origin's
    magnitude."""
    mag = 1.0 + torch.amax(torch.abs(origin), dim=-1)
    sign = torch.sign(rowdot(normal, direction))
    sign = torch.where(sign == 0.0, 1.0, sign)
    m = mag * _EPS * sign
    return fma(normal, m[:, None], origin)
