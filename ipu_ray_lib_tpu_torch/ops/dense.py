"""All-spheres and all-discs closest hits of the glue route.

Port of ``dense_spheres`` and ``dense_discs`` (ipu_ray_lib_tpu/ops/dense.py:
185-249): every ray against every sphere (disc) of the scene's ``ap``
rows, the nearest hit per ray, the first index on ties. They follow the
triangle kernel in ``pallas_scene_intersect`` and ``pallas_path_intersect``
(ops/traversal.py). The MXU dense triangle intersector of that module
(``intersector="dense"``) is not ported (ROADMAP queue 1).

The arithmetic is the JAX functions' as XLA compiles them under ``jit``
on the CPU: their dots (``einsum``/``dot`` at ``Precision.HIGHEST`` and
``sum`` over the last axis) reduce in order with each product fused into
the running sum (:func:`sum3`), and a difference or sum fed by a product
is one fused multiply-add. The fused shadow kernel's in-kernel twins
(ops/shadow.py) run the same passes with the dots contracted elementwise
(``dot=``), which rounds differently on some sphere hits: the JAX
package's own glue and fused routes differ there too (ROADMAP queue 3).
"""

from __future__ import annotations

import torch

from ..utils.constants import MACHINE_EPSILON
from .intersect import INF
from .vec3 import fma, sqrt, sum3

_MACH_EPS = float(MACHINE_EPSILON)


def sphere_pass(ap, n_sph: int, o, d, t_min, dot=sum3):
    """(t, index, centre) of the nearest sphere hit per lane, over ``ap``
    rows [0, n_sph) (o, d: vec3 tuples; t = inf where none). ``dot``: how
    the dots round (the fused shadow kernel passes its elementwise form)."""
    rd2 = 1.0 / dot(d, d)
    cur_t = torch.full_like(d[0], INF)
    cur_i = torch.zeros(d[0].shape, dtype=torch.int32, device=d[0].device)
    cur_c = [torch.zeros_like(d[0]) for _ in range(3)]
    for s in range(n_sph):
        c = (ap[s, 1], ap[s, 2], ap[s, 3])
        r2 = ap[s, 7]
        oc = tuple(c[a] - o[a] for a in range(3))
        tca = dot(oc, d) * rd2
        lv = tuple(fma(-d[a], tca, oc[a]) for a in range(3))
        l2 = dot(lv, lv)
        td = sqrt(torch.clamp_min(r2 - l2, 0.0)) * rd2
        t0, t1 = tca - td, tca + td
        t = torch.where(t0 < t_min, t1, t0)
        miss = (tca < 0.0) | (l2 > r2) | (t < t_min) | (r2 <= 0.0)
        t = torch.where(miss | (t <= t_min), INF, t)
        upd = t < cur_t
        cur_t = torch.where(upd, t, cur_t)
        cur_i = torch.where(upd, s, cur_i)
        cur_c = [torch.where(upd, ca, cc) for ca, cc in zip(c, cur_c)]
    return cur_t, cur_i, cur_c


def disc_pass(ap, n_sph: int, n_dsc: int, o, d, t_min, dot=sum3,
              stored_offset: bool = False):
    """(t, index, normal) of the nearest disc hit per lane, over ``ap``
    rows [n_sph, n_sph + n_dsc) (t = inf where none). The plane offset
    |c . n| is computed here, or with ``stored_offset`` read from ``ap``
    (summed left to right at build time, as the fused shadow kernel
    takes it)."""
    cur_t = torch.full_like(d[0], INF)
    cur_i = torch.zeros(d[0].shape, dtype=torch.int32, device=d[0].device)
    cur_n = [torch.zeros_like(d[0]) for _ in range(3)]
    for s in range(n_dsc):
        a = ap[n_sph + s]
        c, nv = (a[1], a[2], a[3]), (a[4], a[5], a[6])
        r2 = a[7]
        d_off = a[8] if stored_offset else torch.abs(dot(c, nv))
        angle = dot(d, nv)
        t = -(dot(o, nv) + d_off) / angle
        h = tuple(fma(d[k], t, o[k]) - c[k] for k in range(3))
        d2 = dot(h, h)
        ok = ((angle != 0.0) & (t > _MACH_EPS) & (d2 < r2) & (r2 > 0.0)
              & (t > t_min))
        t = torch.where(ok, t, INF)
        upd = t < cur_t
        cur_t = torch.where(upd, t, cur_t)
        cur_i = torch.where(upd, s, cur_i)
        cur_n = [torch.where(upd, na, cn) for na, cn in zip(nv, cur_n)]
    return cur_t, cur_i, cur_n


def _cols(x):
    return tuple(x[:, a] for a in range(3))


def dense_spheres(scene, origins, dirs, t_min, best_t):
    """All-spheres closest hit: (better, t, index) per ray (origins/dirs
    [R, 3], t_min/best_t [R]); better = t < best_t."""
    t, i, _ = sphere_pass(scene.ap, scene.n_spheres, _cols(origins),
                          _cols(dirs), t_min)
    return t < best_t, t, i


def dense_discs(scene, origins, dirs, t_min, best_t):
    """All-discs closest hit: (better, t, index) per ray."""
    t, i, _ = disc_pass(scene.ap, scene.n_spheres, scene.n_discs,
                        _cols(origins), _cols(dirs), t_min)
    return t < best_t, t, i
