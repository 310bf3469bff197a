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

Every expression keeps the kernel's operation order. The approximate
reciprocal of the dense test is what the reference evaluates off the TPU
(``pl.reciprocal(approx=True)``): ``1 / bf16(x)`` in f32, then one Newton
step.
"""

from __future__ import annotations

import numpy as np
import torch

INF = float("inf")
BIG = 1e37                       # float32(1e37) is exactly this value's f32
SLAB_SCALE = float(np.float32(1.0 + 6e-7))
SLAB_LO = float(np.float32(1.0 - 6e-7))
_EPS_CLAMP = float(np.float32(1e-3))


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
