"""Bundle cull: which triangle blocks each bundle of 1,024 rays may hit,
nearest first.

Port of ``bundle_cull`` / ``block_cull_lists_bundle`` /
``super_cull_lists_bundle`` (ipu_ray_lib_tpu/ops/pallas/intersect_kernel.py:
46-150). In the JAX package this is XLA,
not Pallas, so here it is plain torch on the rays' device. A bundle's
interval box (the range of its live lanes' origins and directions) is
slab-tested against every block AABB with interval arithmetic; mixed-sign
direction axes give no constraint, so the cull is conservative. Each
kept block gets a lower bound of any hit's distance (the gap between the
origin box and the block), and the blocks are ordered by it with a
**stable** sort; culled blocks sort last with an infinite bound.

The arithmetic is the JAX function's as XLA compiles it under ``jit``
(as ``fused_shadow_trace_arrays`` runs it): the squared gaps are summed
with fused multiply-adds.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.constants import gamma
from .vec3 import fma, sqrt

BR = 1024  # rays per bundle
SLAB_SCALE = float(np.float32(1.0 + 2.0 * gamma(3)))
INF = float("inf")


def bundle_cull(aabb: torch.Tensor, origins: torch.Tensor, dirs: torch.Tensor,
                t_min: torch.Tensor, t_max: torch.Tensor, n_ray_blocks: int,
                br: int = BR):
    """(counts [nrb] i32, order [nrb, nb] i32, dist_sorted [nrb, nb] f32)
    of ``n_ray_blocks`` bundles of ``br`` rays (origins/dirs [nrb*br, 3],
    t_min/t_max [nrb*br]; lanes with t_max <= 0 are dead and left out of
    the bundle box) against ``aabb`` [nb, >= 6] (lo.xyz, hi.xyz)."""
    nrb = n_ray_blocks
    blo, bhi = aabb[:, 0:3], aabb[:, 3:6]
    alive = (t_max > 0.0).reshape(nrb, br, 1)
    o_r = origins.reshape(nrb, br, 3)
    d_r = dirs.reshape(nrb, br, 3)
    olo = torch.where(alive, o_r, INF).amin(dim=1)             # [nrb, 3]
    ohi = torch.where(alive, o_r, -INF).amax(dim=1)
    dlo = torch.where(alive, d_r, INF).amin(dim=1)
    dhi = torch.where(alive, d_r, -INF).amax(dim=1)
    tmax_hi = t_max.reshape(nrb, br).amax(dim=1)               # [nrb]
    tmin_lo = torch.where(alive[..., 0], t_min.reshape(nrb, br),
                          INF).amin(dim=1)

    enter = torch.full((nrb, blo.shape[0]), -INF, dtype=torch.float32,
                       device=aabb.device)
    exit_ = torch.full_like(enter, INF)
    for a in range(3):
        pos = dlo[:, a] > 0.0
        neg = dhi[:, a] < 0.0
        same = (pos | neg)[:, None]
        i1 = 1.0 / torch.where(same[:, 0], dlo[:, a], 1.0)
        i2 = 1.0 / torch.where(same[:, 0], dhi[:, a], 1.0)
        ilo = torch.minimum(i1, i2)[:, None]
        ihi = torch.maximum(i1, i2)[:, None]
        s1_lo = blo[None, :, a] - ohi[:, None, a]
        s1_hi = blo[None, :, a] - olo[:, None, a]
        s2_lo = bhi[None, :, a] - ohi[:, None, a]
        s2_hi = bhi[None, :, a] - olo[:, None, a]

        def iprod(slo, shi):
            p1, p2, p3, p4 = slo * ilo, slo * ihi, shi * ilo, shi * ihi
            return (torch.minimum(torch.minimum(p1, p2), torch.minimum(p3, p4)),
                    torch.maximum(torch.maximum(p1, p2), torch.maximum(p3, p4)))

        lo1, hi1 = iprod(s1_lo, s1_hi)
        lo2, hi2 = iprod(s2_lo, s2_hi)
        ax_enter = torch.where(same, torch.minimum(lo1, lo2), -INF)
        ax_exit = torch.where(same, torch.maximum(hi1, hi2) * SLAB_SCALE, INF)
        enter = torch.maximum(enter, ax_enter)
        exit_ = torch.minimum(exit_, ax_exit)

    hit = ((enter <= exit_) & (enter <= tmax_hi[:, None])
           & (exit_ >= tmin_lo[:, None]) & (blo[None, :, 0] < 1e30))

    d2 = torch.zeros_like(enter)
    for a in range(3):
        gap = torch.maximum(blo[None, :, a] - ohi[:, None, a],
                            olo[:, None, a] - bhi[None, :, a])
        gap = torch.clamp_min(gap, 0.0)
        d2 = fma(gap, gap, d2)
    dist_lb = torch.where(hit, sqrt(d2), INF)
    order = torch.argsort(dist_lb, dim=1, stable=True)
    dist_sorted = torch.gather(dist_lb, 1, order)
    counts = hit.sum(dim=1).to(torch.int32)
    return counts, order.to(torch.int32), dist_sorted


def block_cull_lists_bundle(scene, origins, dirs, t_min, t_max,
                            n_ray_blocks: int, br: int = BR):
    """Bundle cull against the scene's triangle-block AABBs."""
    return bundle_cull(scene.baabb, origins, dirs, t_min, t_max,
                       n_ray_blocks, br)


def super_cull_lists_bundle(scene, origins, dirs, t_min, t_max,
                            n_ray_blocks: int, br: int = BR):
    """Bundle cull against the scene's super AABBs (8 blocks each), the
    lists of the HBM-mode kernel (ops/intersect_hbm.py)."""
    return bundle_cull(scene.saabb, origins, dirs, t_min, t_max,
                       n_ray_blocks, br)
