"""Closest hit against the blocked triangle tables (kernel K5).

Port of ``pallas_intersect`` (ipu_ray_lib_tpu/ops/pallas/intersect_kernel.py:
322-405), whose Pallas kernel ``_dense_kernel`` (:184) works on bundles of
``BR = 1024`` consecutive rays. Per bundle it walks the bundle's block
list from the bundle cull (ops/cull.py), nearest first, and after every
``CHECK_EVERY = 4`` tested blocks stops once the largest best t over the
bundle's lanes is below the next block's distance bound (no later block
can hold a nearer hit). Per lane it keeps the nearest triangle: inside a
block the lowest row wins a tie, across blocks the block first in the
list (strictly nearer replaces). For the winner it returns the raw shading
normal ``N0 + (dN1*b1 + dN2*b2)`` and the material payload rows of the
``nrm`` table.

Two implementations with one contract, for the walk and the winner's
payload:

* the CUDA kernel (``ops/cuda/intersect.cu``), each bundle a CTA whose
  lanes test only the blocks they may hit (the exact cull of
  :func:`lane_admits`; K5 walks VMEM-mode scenes, which carry the padded
  boxes), for CUDA tensors;
* :func:`dense_walk_ref`, plain torch over all bundles at once, for CPU
  tensors and for checking the kernel on the card.

Both take the cull's lists and the padded rays [8, Rp] and return the
kernel's raw outputs ``(t [Rp] f32, tri [Rp] i32, n [8, Rp] f32, m [8, Rp]
f32, pairs [nrb] i32)``: best t (t_max where nothing is hit), the winning
triangle row or -1, the raw normal in rows 0-2 of ``n`` and the winner's
``nrm`` rows 3-7 of segments 0 (in ``n``) and 1 (all of ``m``), zeros
where nothing is hit; and the blocks each bundle tested (its (bundle,
block) pairs: the work of the bundle design, 1,024 lanes per pair).
:func:`intersect_epilogue` makes of them what ``pallas_intersect`` returns.
:func:`needed_pairs` counts the work the closest hits need: the (lane,
block) pairs no walk can skip, which bound the kernels' time.
:func:`lane_admits` is the kernels' per-lane cull in plain torch: a lane
skips a block only when no row of it can hold a hit below its best t
(ops/tables.py ``padded_boxes``), so the cull changes no result.

The row test is the JAX kernel's as XLA compiles its CPU interpret mode:
a product feeding a sum is one fused multiply-add (``_dot``), the
reciprocal is ``1 / bf16(x)`` with one Newton step. The fused shadow
kernel (ops/shadow.py) runs the same walk for its primary rays.
"""

from __future__ import annotations

import numpy as np
import torch

from .cull import BR, block_cull_lists_bundle
from .intersect import INF, SLAB_LO, slab_inv, slab_test
from .tables import TB
from .vec3 import fma, unit

CHECK_EVERY = 4
_EPS_CLAMP = float(np.float32(1e-3))

# Bundles the plain version advances together: its temporaries are
# [bundles, 128, 1024] per tested block.
REF_BUNDLES = 16

# CUDA kernel launches since the last reset.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def count(stats, key, n) -> None:
    if stats is not None:
        stats[key] = stats.get(key, 0) + int(n)


def _dot(a, b):
    """a0*b0 + a1*b1 + a2*b2 as XLA contracts it elementwise."""
    return fma(a[2], b[2], fma(a[0], b[0], a[1] * b[1]))


def o_mag(o):
    return torch.maximum(torch.maximum(torch.abs(o[0]), torch.abs(o[1])),
                         torch.abs(o[2]))


def row_chain(col, o, d):
    """The plane + barycentric chain of rows against lanes (``col(c)``:
    table column c broadcast against the lanes): (t, b1, b2, on, r)."""
    tri = lambda c0: (col(c0), col(c0 + 1), col(c0 + 2))
    on, dn = _dot(tri(3), o), _dot(tri(3), d)
    r = torch.reciprocal(dn.to(torch.bfloat16).to(torch.float32))
    r = r * fma(-dn, r, 2.0)
    t = (col(0) - on) * r
    b1 = fma(t, _dot(tri(6), d), _dot(tri(6), o)) - col(1)
    b2 = fma(t, _dot(tri(9), d), _dot(tri(9), o)) - col(2)
    return t, b1, b2, on, r


def test_block(p, blk, o, d, omag, t_min, best_t, best_row):
    """One triangle block per bundle (``blk`` [n] block indices) against
    that bundle's lanes (vec3 tuples of [n, 1, BR]; t_min, best_t and
    best_row [n, BR]). Returns the new best t and row."""
    pb = p.view(-1, TB, 16)[blk]                                 # [n, TB, 16]
    t, b1, b2, on, r = row_chain(lambda c: pb[..., c:c + 1], o, d)
    et = (pb[..., 14:15] + torch.abs(on)) * torch.abs(r)
    eps = torch.clamp_max(fma(pb[..., 13:14], omag + et, pb[..., 12:13]),
                          _EPS_CLAMP)
    ok = ((torch.minimum(b1, b2) >= -eps) & (b1 + b2 <= 1.0 + eps)
          & (t > t_min[:, None]))
    tm = torch.where(ok, t, INF)
    bt = torch.amin(tm, dim=1)
    rows = torch.arange(TB, device=p.device)[None, :, None]
    bi = torch.amin(torch.where(tm <= bt[:, None], rows, TB), dim=1)
    better = (bt < best_t) & (bt < INF)
    return (torch.where(better, bt, best_t),
            torch.where(better, bi + blk[:, None].long() * TB, best_row))


def walk(p, counts, order, dists, o, d, t_min, t_max, *, members: int,
         check_every: int, stats=None, key: str = "pairs"):
    """The bundles' near-to-far walk: lane vec3s [n, 1, BR], t_min/t_max
    [n, BR]; list entry e stands for the blocks [e*members, (e+1)*members).
    Returns (best t, best row) [n, BR] and the blocks each bundle tested
    [n] i32; ``stats[key]`` gains their sum."""
    n = counts.shape[0]
    n_list = order.shape[1]
    best_t = t_max.clone()
    best_row = torch.full((n, BR), -1, dtype=torch.int64, device=p.device)
    tested = torch.zeros(n, dtype=torch.int32, device=p.device)
    omag = o_mag(o)
    counts_l = counts.long()
    live = counts_l > 0
    j = 0
    while bool(live.any()):
        idx = torch.nonzero(live).squeeze(1)
        count(stats, key, idx.numel() * members)
        tested += live.to(torch.int32) * members
        sel = lambda v: tuple(c[idx] for c in v)
        oi, di = sel(o), sel(d)
        bt, br = best_t[idx], best_row[idx]
        for m in range(members):
            bt, br = test_block(p, order[idx, j].long() * members + m, oi, di,
                                omag[idx], t_min[idx], bt, br)
        best_t = best_t.index_put((idx,), bt)
        best_row = best_row.index_put((idx,), br)
        j += 1
        live = live & (j < counts_l)
        if j % check_every == 0 and j < n_list:
            worst = torch.amax(best_t, dim=1)
            live = live & ~(worst < dists[:, j])
    return best_t, best_row, tested


def winner_payload(scene, row, o, d, *, split: bool = False):
    """(n [8, ...], m [8, ...]) of each lane's winning row (zeros where
    row < 0): n rows 0-2 the raw shading normal N0 + (dN1*b1 + dN2*b2) with
    the winner's f32 barycentrics (rounded to bf16 with ``split``, as the
    bf16 payload table of the JAX package's HBM kernel takes them), rows
    3-7 segment 0's spare rows; m the winner's segment-1 column."""
    has = row >= 0
    r = torch.clamp_min(row, 0)
    pc = scene.p[r]
    _, b1, b2, _, _ = row_chain(lambda c: pc[..., c], o, d)
    if split:
        b1 = b1.to(torch.bfloat16).to(torch.float32)
        b2 = b2.to(torch.bfloat16).to(torch.float32)
    c0 = (r // TB) * (3 * TB) + r % TB
    nrm = scene.nrm
    n = [nrm[c, c0] + (nrm[c, c0 + TB] * b1 + nrm[c, c0 + 2 * TB] * b2)
         for c in range(3)]
    n += [nrm[c, c0] for c in range(3, 8)]
    m = [nrm[c, c0 + TB] for c in range(8)]
    return (torch.where(has, torch.stack(n), 0.0),
            torch.where(has, torch.stack(m), 0.0))


def lanes(rays, n):
    """Lane views of n bundles' padded rays [8, n*BR]: (o, d) vec3s of
    [n, 1, BR], t_min, t_max [n, BR]."""
    ln = lambda row: rays[row].reshape(n, 1, BR)
    return (tuple(ln(a) for a in range(3)), tuple(ln(a) for a in range(3, 6)),
            rays[6].reshape(n, BR), rays[7].reshape(n, BR))


def walk_ref(scene, counts, order, dists, rays, *, members: int,
             check_every: int, split: bool, bundles: int = REF_BUNDLES):
    """Plain-torch version of the closest-hit kernels: (t [Rp], tri [Rp]
    i32, n [8, Rp], m [8, Rp], pairs [nrb] i32) (module docstring)."""
    outs = []
    for b in range(0, counts.shape[0], bundles):
        c = counts[b:b + bundles]
        n = c.shape[0]
        o, d, t_min, t_max = lanes(rays[:, b * BR:(b + n) * BR], n)
        best_t, row, tested = walk(scene.p, c, order[b:b + bundles],
                           dists[b:b + bundles], o, d, t_min, t_max,
                           members=members, check_every=check_every)
        nn, mm = winner_payload(scene, row, tuple(x[:, 0] for x in o),
                                tuple(x[:, 0] for x in d), split=split)
        outs.append((best_t.reshape(-1), row.reshape(-1).to(torch.int32),
                     nn.reshape(8, -1), mm.reshape(8, -1), tested))
    return tuple(torch.cat(parts, dim=-1) for parts in zip(*outs))


def dense_walk_ref(scene, counts, order, dists, rays, *,
                   bundles: int = REF_BUNDLES):
    """Plain version of K5: counts [nrb] i32, order/dists [nrb, nb] from
    the block cull, rays [8, nrb*BR] -> (t, tri, n, m, pairs)."""
    return walk_ref(scene, counts, order, dists, rays, members=1,
                    check_every=CHECK_EVERY, split=False, bundles=bundles)


def needed_pairs(scene, order, rays, out_t, tested, *, members: int) -> int:
    """The (lane, block) pairs the closest hits of one launch need: for each
    live lane, the blocks its bundle walked (the first ``tested`` [nrb] of
    the list, ``members`` blocks per entry) whose AABB the lane's own slab
    admits with an entry below the lane's final best t (``out_t``, the
    kernel's first output). A block entered beyond that cannot hold a
    nearer hit, and the bundle's early stop passes only such blocks, so a
    walk that tests fewer cannot prove its hits."""
    n_ent = torch.div(tested.long(), members, rounding_mode="floor")
    L = int(n_ent.max()) if n_ent.numel() else 0
    if L == 0:
        return 0
    # Bundles per step, so that a step's temporaries hold ~2^24 lanes.
    step = max(1, (1 << 24) // (L * members * BR))
    mem = torch.arange(members, device=order.device)
    walked = (torch.arange(L, device=order.device)[None] < n_ent[:, None])
    walked = walked.repeat_interleave(members, dim=1)[..., None]
    total = torch.zeros((), dtype=torch.int64, device=order.device)
    for b in range(0, order.shape[0], step):
        n = min(step, order.shape[0] - b)
        blk = (order[b:b + n, :L].long()[..., None] * members
               + mem).reshape(n, L * members)
        o, d, _, t_max = lanes(rays[:, b * BR:(b + n) * BR], n)
        adm, tin = slab_test(o, slab_inv(d), (t_max > 0.0)[:, None],
                             scene.baabb[blk])                # [n, L*m, BR]
        best = out_t[b * BR:(b + n) * BR].reshape(n, 1, BR)
        total += (adm & (tin * SLAB_LO < best) & walked[b:b + n]).sum()
    return int(total)


_FLAT = 2.0 ** -30     # an axis with |d_a| <= |d|inf * this is flat
_D_MIN = 2.0 ** -60    # below this |d|inf a lane tests every block
_F32_MAX = float(np.finfo(np.float32).max)


def lane_admits(box, o, d, t_min, best_t):
    """Whether a lane must test a block for a hit in (t_min, best_t): the
    exact cull of K4 and K5 (ops/cuda/rows.cuh lane_admits),
    operation for operation. ``box``: rows of the scene's ``pbox`` (lo.xyz,
    hi.xyz, kappa, kind) broadcast against the lanes' vec3s ``o``, ``d``
    and ``t_min``, ``best_t``. Always for an unbounded block (kind 1),
    never for an empty one (-1) or when no hit can be kept (t_min >=
    best_t); else when the block's padded box grown by kappa (T D + omag)
    lies in the lane's slab with an entry below best t and an exit above
    t_min (D = |d|inf, omag = |o|inf; T bounds |t| of a hit: the larger
    of |t_min| and |best_t|, or of |t_min| and the box's farthest face
    along the axis of D over D, grown by kappa omag and 2%), or when the
    lane's ray is not finite, D < 2^-60 or T is not finite."""
    col = lambda c: box[..., c]
    kind = col(7)
    ad = [torch.abs(c) for c in d]
    D = torch.maximum(torch.maximum(ad[0], ad[1]), ad[2])
    fin = (torch.isfinite(o[0]) & torch.isfinite(o[1]) & torch.isfinite(o[2])
           & torch.isfinite(d[0]) & torch.isfinite(d[1])
           & torch.isfinite(d[2]))
    omag = o_mag(o)
    first = (ad[0] >= ad[1]) & (ad[0] >= ad[2])
    pick = lambda v: torch.where(first, v[0],
                                 torch.where(ad[1] >= ad[2], v[1], v[2]))
    lo_x, hi_x, o_x = pick((col(0), col(1), col(2))), pick((col(3), col(4),
                                                            col(5))), pick(o)
    far = torch.maximum(torch.abs(lo_x - o_x), torch.abs(hi_x - o_x))
    at = torch.abs(t_min)
    T = torch.minimum(torch.maximum(at, torch.abs(best_t)),
                      torch.maximum(at, (far + col(6) * omag) * 1.02 / D))
    cull = fin & (D >= _D_MIN) & (T <= _F32_MAX)
    m = col(6) * (T * D + omag)
    tin = torch.full_like(m, -INF)
    tout = torch.full_like(m, INF)
    inside = torch.ones_like(m, dtype=torch.bool)
    lim = D * _FLAT
    for a in range(3):
        lo, hi = col(a) - m, col(a + 3) + m
        flat = ad[a] <= lim
        inv = 1.0 / torch.where(flat, 1.0, d[a])
        t1, t2 = (lo - o[a]) * inv, (hi - o[a]) * inv
        tin = torch.where(flat, tin, torch.maximum(tin, torch.minimum(t1, t2)))
        tout = torch.where(flat, tout,
                           torch.minimum(tout, torch.maximum(t1, t2)))
        inside = inside & (~flat | ((o[a] >= lo) & (o[a] <= hi)))
    slab = inside & (tin <= tout) & (tin < best_t) & (tout > t_min)
    return ((t_min < best_t) & (kind >= 0)
            & ((kind > 0) | ~cull | slab))


def walk_cuda(scene, counts, order, dists, rays, *, hbm: bool,
              counters=None):
    """The CUDA kernel K5 (K6 with ``hbm``): the plain version's results,
    a sixth output [nrb] i32, the blocks each bundle tested past its stop
    (K6 tests a wave of chunks of its list at once, ops/cuda/intersect.cu;
    0 for K5), and a seventh [nrb] i32, the (lane, block) pairs its lanes
    tested (K5's culled walk; K6: 1,024 per block). ``counters``
    ([K45_COUNTERS] int64, zeroed): a counting launch of K5."""
    from .cuda.build import launch_intersect

    Rp = rays.shape[1]
    dev = rays.device
    out_t = torch.empty(Rp, dtype=torch.float32, device=dev)
    out_i = torch.empty(Rp, dtype=torch.int32, device=dev)
    out_n = torch.empty((8, Rp), dtype=torch.float32, device=dev)
    out_m = torch.empty((8, Rp), dtype=torch.float32, device=dev)
    pairs = torch.empty(counts.shape[0], dtype=torch.int32, device=dev)
    spec = torch.empty(counts.shape[0], dtype=torch.int32, device=dev)
    lane_pairs = torch.empty(counts.shape[0], dtype=torch.int32, device=dev)
    launch_intersect(scene, counts, order, dists, rays, out_t, out_i, out_n,
                     out_m, pairs, spec, lane_pairs, hbm=hbm,
                     counters=counters)
    return out_t, out_i, out_n, out_m, pairs, spec, lane_pairs


def dense_walk_cuda(scene, counts, order, dists, rays):
    """K5 on the card; counts its launches."""
    global launches
    out = walk_cuda(scene, counts, order, dists, rays, hbm=False)
    launches += 1
    return out


def intersect_inputs(origins, dirs, t_min, t_max):
    """Pad R rays to whole bundles (directions with 1.0, t_max with -1:
    dead lanes): (o_pad, d_pad, tmin_pad, tmax_pad, rays [8, Rp])."""
    pad = -(-dirs.shape[0] // BR) * BR - dirs.shape[0]
    padr = lambda a, v=0.0: torch.nn.functional.pad(
        a, (0, 0, 0, pad) if a.dim() == 2 else (0, pad), value=v)
    o_pad, d_pad = padr(origins), padr(dirs, 1.0)
    tmin_pad, tmax_pad = padr(t_min), padr(t_max, -1.0)
    rays = torch.cat([o_pad.t(), d_pad.t(), tmin_pad[None],
                      tmax_pad[None]]).contiguous()
    return o_pad, d_pad, tmin_pad, tmax_pad, rays


def intersect_epilogue(out, t_max, R: int):
    """``pallas_intersect``'s results from the raw outputs: (t [R] = t_max
    where nothing is hit, tri [R] i32, unit normal [R, 3], payload [10, R]:
    segment 0 rows 3-7 then segment 1 rows 3-7)."""
    out_t, out_i, out_n, out_m = out[:4]
    t, idx = out_t[:R], out_i[:R]
    normal = unit(out_n[0:3, :R].t())
    payload = torch.cat([out_n[3:8, :R], out_m[3:8, :R]])
    return torch.where(idx >= 0, t, t_max), idx, normal, payload


def pallas_intersect(scene, origins, dirs, t_min, t_max):
    """Closest hit of R rays (origins/dirs [R, 3], t_min/t_max [R]) against
    the scene's blocked triangles: the kernel on a CUDA scene, the plain
    version on a CPU scene. Returns (t, tri, normal, payload) as
    :func:`intersect_epilogue`."""
    R = dirs.shape[0]
    o_pad, d_pad, tmin_pad, tmax_pad, rays = intersect_inputs(
        origins, dirs, t_min, t_max)
    lists = block_cull_lists_bundle(scene, o_pad, d_pad, tmin_pad, tmax_pad,
                                    rays.shape[1] // BR)
    dev = scene.device.type
    if dev == "cuda":
        out = dense_walk_cuda(scene, *lists, rays)
    elif dev == "cpu":
        out = dense_walk_ref(scene, *lists, rays)
    else:
        raise ValueError(f"unsupported device {scene.device}")
    return intersect_epilogue(out, t_max, R)
