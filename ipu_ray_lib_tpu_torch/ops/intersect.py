"""Ray tests of the megakernel, as plain torch on component-tuple vec3s.

* :func:`slab_test` / :func:`slab_admit` — the AABB slab test
  (megakernel.py:576-616; the HBM walk's member refinement :1150-1162):
  a lane tests a block's triangles only when its own slab admits the
  block. Conservative: ``tout`` is widened by ``SLAB_SCALE``, so no hit
  the dense test would accept is lost, and the lane's closest hit is the
  one a walk over every block finds. ``slab_test`` also returns the
  entry bound ``tin`` that the HBM walk's refinement holds against the
  lane's best t (shrunk by ``SLAB_LO``).
* :func:`dense_rows` — the watertight plane + barycentric row test
  (:898-956) and :func:`barycentrics`, the same chain re-run for the
  winning row in the deferred payload pass (:1974-2018).
* :func:`analytic_hit` — spheres and discs (:2133-2191).
* The JAX package's primitive tests of ``ipu_ray_lib_tpu/ops/intersect.py``
  (:func:`intersect_box_slab`, :func:`make_ray_shear`,
  :func:`intersect_triangle_watertight`, :func:`intersect_sphere`,
  :func:`intersect_disc`), on [R, 3] rows: the threaded-BVH walk's leaf
  tests (ops/bvh.py) and ``hit_normal`` (ops/traversal.py).

Every expression keeps the kernel's operation order. The approximate
reciprocal of the dense test is what the reference evaluates off the TPU
(``pl.reciprocal(approx=True)``): ``1 / bf16(x)`` in f32, then one Newton
step.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .vec3 import fma, rowdot
from .vec3 import sqrt as vsqrt

INF = float("inf")
BIG = 1e37                       # float32(1e37) is exactly this value's f32
SLAB_SCALE = float(np.float32(1.0 + 6e-7))
SLAB_LO = float(np.float32(1.0 - 6e-7))
_EPS_CLAMP = float(np.float32(1e-3))
_MACH_EPS = float(np.float32(np.finfo(np.float32).eps * 0.5))


def recip_approx(x: torch.Tensor) -> torch.Tensor:
    """The reference's approximate reciprocal refined by one Newton step."""
    r = torch.reciprocal(x.to(torch.bfloat16).to(torch.float32))
    return r * (2.0 - x * r)


def slab_inv(d):
    """Per-component 1/d with exact zeros replaced by 1e-30."""
    return tuple(torch.reciprocal(torch.where(c == 0.0, 1e-30, c)) for c in d)


def slab_test(o, inv, active, box):
    """(admit, tin) of every lane against the AABB ``box`` ([8]: lo.xyz,
    hi.xyz, pad; or [..., 8], giving [..., R] results): ``tin`` starts at 0,
    ``tout`` at ``BIG`` (-1 for inactive lanes) and takes the exit widened
    by ``SLAB_SCALE``. Inverted padding boxes (lo = +inf) never admit."""
    col = ((lambda c: box[c]) if box.dim() == 1
           else (lambda c: box[..., c, None]))
    tin = torch.zeros_like(o[0])
    tout = torch.where(active, BIG, -1.0)
    for a in range(3):
        t0 = (col(a) - o[a]) * inv[a]
        t1 = (col(a + 3) - o[a]) * inv[a]
        tin = torch.maximum(tin, torch.minimum(t0, t1))
        tout = torch.minimum(tout, torch.maximum(t0, t1) * SLAB_SCALE)
    return (tin <= tout) & (col(0) < BIG), tin


def slab_admit(o, inv, active, box):
    """Lanes whose slab interval meets the AABB ``box`` (see
    :func:`slab_test`)."""
    return slab_test(o, inv, active, box)[0]


def _tdot(col, c0, r):
    return col(c0) * r[0] + col(c0 + 1) * r[1] + col(c0 + 2) * r[2]


def dense_rows(pb: torch.Tensor, o, d, o_mag):
    """Watertight test of the rows ``pb`` [T, 16] against every lane;
    returns (t, ok), both [T, R]."""
    def col(c):
        return pb[:, c:c + 1]

    on = _tdot(col, 3, o)
    dn = _tdot(col, 3, d)
    og1 = _tdot(col, 6, o)
    dg1 = _tdot(col, 6, d)
    og2 = _tdot(col, 9, o)
    dg2 = _tdot(col, 9, d)
    r = recip_approx(dn)
    t = (col(0) - on) * r
    b1 = og1 + t * dg1 - col(1)
    b2 = og2 + t * dg2 - col(2)
    et = (col(14) + torch.abs(on)) * torch.abs(r)
    eps = torch.clamp_max(col(12) + col(13) * (o_mag + et), _EPS_CLAMP)
    ok = ((torch.minimum(b1, b2) >= -eps) & (b1 + b2 <= 1.0 + eps)
          & (t > 0.0))
    return t, ok


def barycentrics(pc: torch.Tensor, o, d):
    """(b1, b2) of each lane's own row ``pc`` [R, 12] — the dense test's
    chain on one row per lane."""
    def col(c):
        return pc[:, c]

    on = _tdot(col, 3, o)
    dn = _tdot(col, 3, d)
    og1 = _tdot(col, 6, o)
    dg1 = _tdot(col, 6, d)
    og2 = _tdot(col, 9, o)
    dg2 = _tdot(col, 9, d)
    r = recip_approx(dn)
    t = (col(0) - on) * r
    return og1 + t * dg1 - col(1), og2 + t * dg2 - col(2)


def analytic_hit(ap: torch.Tensor, o, d, best_t: torch.Tensor):
    """Closest sphere/disc hit nearer than ``best_t`` per lane: returns
    (t [R], index [R]); t is +inf where none is nearer (index 0 then).
    Ties resolve to the lowest index."""
    def col(c):
        return ap[:, c:c + 1]

    kind, cx, cy, cz = col(0), col(1), col(2), col(3)
    nx, ny, nz, r2, doff = col(4), col(5), col(6), col(7), col(8)
    ocx, ocy, ocz = cx - o[0], cy - o[1], cz - o[2]
    tca = ocx * d[0] + ocy * d[1] + ocz * d[2]
    l2 = ocx * ocx + ocy * ocy + ocz * ocz - tca * tca
    td = torch.sqrt(torch.clamp_min(r2 - l2, 0.0))
    t0 = tca - td
    t_sph = torch.where(t0 < 0.0, tca + td, t0)
    ok_sph = (kind == 1.0) & (tca >= 0.0) & (l2 <= r2) & (t_sph > 0.0)
    dn = nx * d[0] + ny * d[1] + nz * d[2]
    on = nx * o[0] + ny * o[1] + nz * o[2]
    t_dsc = -(on + doff) / torch.where(dn == 0.0, 1.0, dn)
    hx = o[0] + d[0] * t_dsc - cx
    hy = o[1] + d[1] * t_dsc - cy
    hz = o[2] + d[2] * t_dsc - cz
    d2 = hx * hx + hy * hy + hz * hz
    ok_dsc = (kind == 2.0) & (dn != 0.0) & (t_dsc > 0.0) & (d2 < r2)
    t_ap = torch.where(ok_sph | ok_dsc,
                       torch.where(kind == 1.0, t_sph, t_dsc), INF)
    t_ap = torch.where(t_ap < best_t, t_ap, INF)
    bt = torch.amin(t_ap, dim=0)
    idx = torch.arange(ap.shape[0], device=ap.device)[:, None]
    bi = torch.amin(torch.where(t_ap <= bt, idx, ap.shape[0]), dim=0)
    return bt, bi


# ---- The JAX package's primitive tests (ipu_ray_lib_tpu/ops/intersect.py:
# 43-217), batched over rays: the plain versions the threaded-BVH walk
# (ops/bvh.py, kernel K7) and ``hit_normal`` (ops/traversal.py) run. Each
# keeps the JAX function's operation order as XLA compiles it under ``jit``
# on the CPU: a product feeding a sum or difference is one fused
# multiply-add (ops/vec3.py ``fma``) where XLA contracts it, and the
# selects are written as ``where(a > b, a, b)`` so a NaN resolves as the
# JAX ``where`` forms do. ----

def _gamma(n: int) -> float:
    ni = np.float32(np.finfo(np.float32).eps * 0.5) * n
    return float(np.float32(ni / (1.0 - ni)))


BOX_SLAB_SCALE = float(np.float32(1.0 + 2.0 * _gamma(3)))
GAMMA2, GAMMA3, GAMMA5 = _gamma(2), _gamma(3), _gamma(5)


def intersect_box_slab(origin, inv_dir, box_lo, box_hi, t0, t1):
    """Ray/AABB slab test (origin, inv_dir, box_lo, box_hi [R, 3]; t0, t1
    [R]): (hit, t0', t1'), t1' narrowed by exits widened by
    ``1 + 2 gamma(3)``."""
    for a in range(3):
        tmin = (box_lo[:, a] - origin[:, a]) * inv_dir[:, a]
        tmax = (box_hi[:, a] - origin[:, a]) * inv_dir[:, a]
        swap = tmin > tmax
        tmin, tmax = torch.where(swap, tmax, tmin), torch.where(swap, tmin, tmax)
        tmax = tmax * BOX_SLAB_SCALE
        t0 = torch.where(tmin > t0, tmin, t0)
        t1 = torch.where(tmax < t1, tmax, t1)
    return t0 <= t1, t0, t1


class RayShear(NamedTuple):
    """The permute + shear transform of each ray."""

    origin: torch.Tensor  # [R, 3]
    perm: torch.Tensor    # [R, 3] int64 (ix, iy, iz)
    sx: torch.Tensor      # [R]
    sy: torch.Tensor
    sz: torch.Tensor


def make_ray_shear(origin, direction) -> RayShear:
    """The shear of each ray: z is the axis of its largest |d| (the first
    on ties), x and y the next two in cyclic order."""
    ad = torch.abs(direction)
    iz = torch.where((ad[:, 1] > ad[:, 0]) & (ad[:, 1] >= ad[:, 2]), 1,
                     torch.where((ad[:, 2] > ad[:, 0]) & (ad[:, 2] > ad[:, 1]),
                                 2, 0))
    ix = torch.where(iz == 2, 0, iz + 1)
    iy = torch.where(ix == 2, 0, ix + 1)
    perm = torch.stack([ix, iy, iz], -1)
    dp = torch.gather(direction, 1, perm)
    inv_dz = 1.0 / dp[:, 2]
    return RayShear(origin=origin, perm=perm, sx=-dp[:, 0] * inv_dz,
                    sy=-dp[:, 1] * inv_dz, sz=inv_dz)


class TriangleHit(NamedTuple):
    t: torch.Tensor   # [R], 0 on a miss
    b0: torch.Tensor
    b1: torch.Tensor
    b2: torch.Tensor


def _amax3(a, b, c):
    a, b, c = torch.abs(a), torch.abs(b), torch.abs(c)
    return torch.maximum(torch.maximum(a, b), c)


def intersect_triangle_watertight(shear: RayShear, p0, p1, p2,
                                  t_far: float = INF) -> TriangleHit:
    """The watertight ray/triangle test (PBRT) with f32 error bounds, its
    edge-function signs widened by their own rounding bound and its
    ``t <= delta_t`` rejection (p0, p1, p2 [R, 3])."""
    pt = [torch.gather(p - shear.origin, 1, shear.perm) for p in (p0, p1, p2)]
    sx, sy, sz = shear.sx, shear.sy, shear.sz
    px = [fma(sx, q[:, 2], q[:, 0]) for q in pt]
    py = [fma(sy, q[:, 2], q[:, 1]) for q in pt]
    e0 = fma(px[1], py[2], -(py[1] * px[2]))
    e1 = fma(px[2], py[0], -(py[2] * px[0]))
    e2 = fma(px[0], py[1], -(py[0] * px[1]))

    max_xt = _amax3(*px)
    max_yt = _amax3(*py)
    max_zt0 = _amax3(*(q[:, 2] for q in pt))
    dx0 = GAMMA5 * (max_xt + max_zt0)
    dy0 = GAMMA5 * (max_yt + max_zt0)
    de = 2.0 * fma(dx0, max_yt, fma(GAMMA2 * max_xt, max_yt, dy0 * max_xt))
    mixed = (((e0 < -de) | (e1 < -de) | (e2 < -de))
             & ((e0 > de) | (e1 > de) | (e2 > de)))
    det = e0 + e1 + e2

    pz = [q[:, 2] * sz for q in pt]
    t_scaled = fma(e2, pz[2], fma(e0, pz[0], e1 * pz[1]))
    bad_neg = (det < 0) & ((t_scaled >= 0) | (t_scaled < t_far * det))
    bad_pos = (det > 0) & ((t_scaled <= 0) | (t_scaled > t_far * det))

    inv_det = 1.0 / det
    b0, b1, b2 = e0 * inv_det, e1 * inv_det, e2 * inv_det
    t = t_scaled * inv_det

    max_z = _amax3(*pz)
    delta_z = GAMMA3 * max_z
    delta_x = GAMMA5 * (max_xt + max_z)
    delta_y = GAMMA5 * (max_yt + max_z)
    delta_e = 2.0 * fma(delta_x, max_yt,
                        fma(GAMMA2 * max_xt, max_yt, delta_y * max_xt))
    max_e = _amax3(e0, e1, e2)
    delta_t = 3.0 * fma(delta_z, max_e,
                        fma(GAMMA3 * max_e, max_z, delta_e * max_z)) \
        * torch.abs(inv_det)
    miss = mixed | (det == 0) | bad_neg | bad_pos | (t <= delta_t)
    return TriangleHit(t=torch.where(miss, 0.0, t), b0=b0, b1=b1, b2=b2)


def intersect_sphere(origin, direction, t_min, centre, radius):
    """Geometric ray/sphere test (origin, direction, centre [R, 3];
    t_min, radius [R]): t, 0 on a miss. The square of the radius is
    taken here, as the BVH walk's leaf test takes it in the same fused
    computation: XLA then contracts ``r * r - l2``."""
    radius2 = radius * radius
    f = centre - origin
    rd2 = 1.0 / rowdot(direction, direction)
    tca = rowdot(f, direction) * rd2
    lv = fma(-direction, tca[:, None], f)
    l2 = rowdot(lv, lv)
    td = vsqrt(torch.clamp_min(fma(radius, radius, -l2), 0.0)) * rd2
    t0, t1 = tca - td, tca + td
    t = torch.where(t0 < t_min, t1, t0)
    miss = (tca < 0.0) | (l2 > radius2) | (t < t_min)
    return torch.where(miss, 0.0, t)


def intersect_disc(origin, direction, normal, centre, radius2,
                   zero_origin: bool = False):
    """Ray/disc test with the reference's plane offset |c . n| (origin,
    direction, normal, centre [R, 3]; radius2 [R]): t, 0 on a miss.
    ``zero_origin``: rays from (0, 0, 0), whose origin XLA folds away, so
    the hit point fuses into its difference with the centre."""
    angle = rowdot(normal, direction)
    d_off = torch.abs(rowdot(centre, normal))
    if zero_origin:
        t = -d_off / angle
        dd = fma(direction, t[:, None], -centre)
    else:
        t = -(rowdot(normal, origin) + d_off) / angle
        dd = fma(direction, t[:, None], origin) - centre
    d2 = rowdot(dd, dd)
    ok = (angle != 0.0) & (t > _MACH_EPS) & (d2 < radius2)
    return torch.where(ok, t, 0.0)
