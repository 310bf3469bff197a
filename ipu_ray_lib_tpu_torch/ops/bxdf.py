"""BxDF sampling of the megakernel (megakernel.py:237-311) and the offset
origin of the next segment (:2271-2278), on component-tuple vec3s."""

from __future__ import annotations

import torch

from ..utils.constants import PI_BY_2, PI_BY_4, RAY_EPSILON
from .vec3 import add3, cross3, dot3, inv_sqrt, normalize3, scale3, where3

_PI2 = float(PI_BY_2)
_PI4 = float(PI_BY_4)
_EPS = float(RAY_EPSILON)


def sample_diffuse(n, u1, u2):
    """Cosine-weighted hemisphere sample about n (concentric disc map)."""
    use_x = torch.abs(n[0]) > torch.abs(n[1])
    ilx = inv_sqrt(n[0] * n[0] + n[2] * n[2])
    ily = inv_sqrt(n[1] * n[1] + n[2] * n[2])
    zero = torch.zeros_like(n[0])
    v2 = where3(use_x, (-n[2] * ilx, zero, n[0] * ilx),
                (zero, n[2] * ily, -n[1] * ily))
    v3 = cross3(n, v2)
    ux = 2.0 * u1 - 1.0
    uy = 2.0 * u2 - 1.0
    use_ux = torch.abs(ux) > torch.abs(uy)
    r = torch.where(use_ux, ux, uy)
    sx = torch.where(ux == 0.0, 1.0, ux)
    sy = torch.where(uy == 0.0, 1.0, uy)
    th = torch.where(use_ux, (uy / sx) * _PI4, _PI2 - (ux / sy) * _PI4)
    z0 = (ux == 0.0) & (uy == 0.0)
    x = torch.where(z0, 0.0, r * torch.cos(th))
    y = torch.where(z0, 0.0, r * torch.sin(th))
    z = torch.sqrt(torch.clamp_min(1.0 - x * x - y * y, 0.0))
    return add3(add3(scale3(v2, x), scale3(v3, y)), scale3(n, z))


def reflect(d, n):
    ct = dot3(d, n)
    return normalize3(add3(d, scale3(n, -2.0 * ct)))


def dielectric(d, n_in, ior, u1):
    """Schlick-weighted reflect/refract; returns (new_dir, refracted)."""
    entering = dot3(n_in, d) <= 0.0
    n = where3(entering, n_in, scale3(n_in, -1.0))
    ri = torch.where(entering, torch.reciprocal(ior), ior)
    cost1 = -dot3(n, d)
    cost2 = 1.0 - ri * ri * (1.0 - cost1 * cost1)
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    base = 1.0 - cost1
    schlick = r0 + (1.0 - r0) * base * base * base * base * base
    do_refract = (cost2 > 0.0) & (u1 > schlick)
    r_perp = scale3(add3(d, scale3(n, cost1)), ri)
    par_mag = torch.sqrt(torch.abs(1.0 - dot3(r_perp, r_perp)))
    d_refr = add3(r_perp, scale3(n, -par_mag))
    return where3(do_refract, d_refr, reflect(d, n)), do_refract


def offset_origin(hit, normal, new_d):
    """Next-segment origin: the hit point pushed off the surface along the
    normal, towards the side the new direction leaves on."""
    mag = 1.0 + torch.maximum(torch.maximum(torch.abs(hit[0]),
                                            torch.abs(hit[1])),
                              torch.abs(hit[2]))
    sgn = torch.sign(dot3(normal, new_d))
    sgn = torch.where(sgn == 0.0, 1.0, sgn)
    return add3(hit, scale3(normal, mag * _EPS * sgn))
