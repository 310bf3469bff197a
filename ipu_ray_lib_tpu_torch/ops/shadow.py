"""The fused shadow trace (kernel K4): primary closest hit, one shadow ray
to a point light, occlusion.

Port of ``fused_shadow_trace_arrays`` / ``fused_shadow_trace``
(ipu_ray_lib_tpu/ops/pallas/shadow_kernel.py:366-524), whose Pallas
kernel ``_shadow_kernel`` (:56) works on bundles of ``BR = 1024``
consecutive rays. Per bundle it decides

* which triangle blocks the primary walk tests, and in which order: the
  bundle's list from the bundle cull (ops/cull.py), nearest first;
* when the walk stops: after every ``CHECK_EVERY = 4`` tested blocks, once
  the largest best t over the bundle's lanes is below the next block's
  distance bound;
* which blocks the occlusion walk tests: those that any lane of the
  bundle flags with a conservative slab test of its shadow ray.

Per lane it keeps the nearest triangle hit (inside a block the lowest row
wins a tie, across blocks the block first in the bundle's order), lets a
strictly nearer sphere, then a strictly nearer disc, override it, aims
the shadow ray at the light from the hit point pushed off the surface,
and reports whether anything lies between.

Two implementations with one contract:

* the CUDA kernel (``ops/cuda/shadow.cu``), each bundle a cluster of
  CTAs whose lanes test only the blocks they may hit (the exact cull of
  ``intersect_kernel.lane_admits``), for CUDA tensors;
* :func:`shadow_trace_ref`, plain torch over all bundles at once, for CPU
  tensors and for checking the kernel on the card.

Both take the cull's lists and the padded rays and return the kernel's
raw outputs: ``out_f`` [4, R] f32 (the winning triangle's raw shading
normal, hit t) and ``out_i`` [4, R] i32 (triangle row or -1, sphere index
or -1, disc index or -1, occluded 0/1). The shading floats come from
:func:`shadow_epilogue`, plain torch, as the JAX package computes them in
XLA after its kernel.

The kernel's arithmetic is the JAX kernel's, operation for operation: the
primary walk and its row test are K5's (ops/intersect_kernel.py, CUDA
``rows.cuh``) with f32 barycentrics for the shading normal, the sphere and
disc tests are the ``ops/dense.py`` passes with the dots contracted
elementwise (not K1's ``analytic_hit``), and the occlusion slab
is K4's own (``SLAB_SCALE = 1 + 2 gamma_3``, zero-direction axes decided
by whether the origin lies inside the slab). The camera rays before it
and the epilogue after it follow the JAX package as XLA compiles them
under ``jit`` on the CPU, where a product feeding a sum becomes one fused
multiply-add (ops/vec3.py ``fma``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..bvh.builder import INVALID_GEOM_ID
from ..utils.constants import RAY_EPSILON
from ..utils.profiling import span
from .cull import BR, SLAB_SCALE, block_cull_lists_bundle
from .dense import disc_pass, sphere_pass
from .intersect import INF, SLAB_LO
from .intersect_kernel import (CHECK_EVERY, REF_BUNDLES, _dot, count, lanes,
                               o_mag, test_block, walk, winner_payload)
from .traversal import from_hit, resolve_hit
from .vec3 import TINY, const3, fma, rowdot, sqrt, unit

BIG = 1e30  # K4's padding-box bound (float32(1e30) is this value's f32)
_RAY_EPS = float(RAY_EPSILON)

# K4's CUDA launches since the last reset.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _sphere_pass(ap, n_sph, o, d, t_min, bound):
    """K4's twin of ``dense_spheres``: (better, t, index, centre);
    better = t < bound."""
    t, i, c = sphere_pass(ap, n_sph, o, d, t_min, dot=_dot)
    return t < bound, t, i, c


def _disc_pass(ap, n_sph, n_dsc, o, d, t_min, bound):
    """K4's twin of ``dense_discs``: (better, t, index, normal)."""
    t, i, n = disc_pass(ap, n_sph, n_dsc, o, d, t_min, dot=_dot,
                        stored_offset=True)
    return t < bound, t, i, n


def _bundles_ref(scene, counts, order, dists, rays, light, stats):
    """The kernel's work for ``n`` bundles: rays [8, n*BR] ->
    (out_f [4, n*BR], out_i [4, n*BR])."""
    dev = rays.device
    n = counts.shape[0]
    nb = scene.num_blocks
    o, d, t_min, t_max = lanes(rays, n)

    # ---- primary walk: K5's (each bundle's list, nearest first, with the
    # bundle-wide early stop) ----
    best_t, tri, _ = walk(scene.p, counts, order, dists, o, d, t_min, t_max,
                          members=1, check_every=CHECK_EVERY, stats=stats,
                          key="primary_pairs")
    o = tuple(c[:, 0] for c in o)
    d = tuple(c[:, 0] for c in d)
    found_tri = tri >= 0
    best = torch.where(found_tri, best_t, t_max)
    n_raw = tuple(winner_payload(scene, tri, o, d)[0][:3])

    # ---- spheres, then discs, override when strictly nearer ----
    ap, n_sph, n_dsc = scene.ap, scene.n_spheres, scene.n_discs
    sb, st, si, s_c = _sphere_pass(ap, n_sph, o, d, t_min, best)
    best = torch.where(sb, st, best)
    db, dt, di, d_n = _disc_pass(ap, n_sph, n_dsc, o, d, t_min, best)
    best = torch.where(db, dt, best)
    found = found_tri | sb | db
    hit_t = torch.where(found, best, t_max)

    # ---- the kernel's own normal, hit point and shadow ray ----
    kinv = torch.clamp_min(sqrt(_dot(n_raw, n_raw)), TINY)
    kn = [c / kinv for c in n_raw]
    hp_t = torch.where(found, hit_t, 0.0)
    hit_p = [fma(d[c], hp_t, o[c]) for c in range(3)]
    spn = [hit_p[c] - s_c[c] for c in range(3)]
    sinv = torch.clamp_min(sqrt(_dot(spn, spn)), TINY)
    spn = [c / sinv for c in spn]
    default_n = (0.0, 0.0, 1.0)
    normal = [torch.where(found, torch.where(db, d_n[c],
                                             torch.where(sb, spn[c], kn[c])),
                          default_n[c]) for c in range(3)]
    loff = [float(np.float32(light[c])) - hit_p[c] for c in range(3)]
    dist = sqrt(_dot(loff, loff))
    dinv = torch.clamp_min(dist, TINY)
    sdir = [c / dinv for c in loff]
    mag = 1.0 + o_mag(hit_p)
    sgn = torch.sign(_dot(normal, sdir))
    sgn = torch.where(sgn == 0.0, 1.0, sgn)
    m_off = mag * _RAY_EPS * sgn
    sorig = [fma(normal[c], m_off, hit_p[c]) for c in range(3)]

    # ---- per-bundle block flags: any lane's conservative slab hit ----
    box = scene.baabb[:, None, None, :]                     # [nb, 1, 1, 8]
    tin = torch.full((nb, n, BR), -INF, device=dev)
    tout = torch.full((nb, n, BR), INF, device=dev)
    for a in range(3):
        lo, hi = box[..., a], box[..., a + 3]
        d_a, o_a = sdir[a][None], sorig[a][None]
        inv = 1.0 / torch.where(d_a == 0.0, 1.0, d_a)
        t1, t2 = (lo - o_a) * inv, (hi - o_a) * inv
        tn = torch.minimum(t1, t2)
        tf = torch.maximum(t1, t2) * SLAB_SCALE
        inside = (o_a >= lo) & (o_a <= hi)
        tn = torch.where(d_a == 0.0, torch.where(inside, -INF, INF), tn)
        tf = torch.where(d_a == 0.0, torch.where(inside, INF, -INF), tf)
        tin = torch.maximum(tin, tn)
        tout = torch.minimum(tout, tf)
    bhit = ((tin <= tout) & (tout >= 0.0) & (tin <= dist[None])
            & (box[..., 0] < BIG))
    flags = bhit.any(dim=2)                                   # [nb, n]

    # ---- occlusion walk over the flagged blocks, in block order ----
    so = tuple(c[:, None] for c in sorig)
    sd = tuple(c[:, None] for c in sdir)
    so_mag = o_mag(so)
    s_t = dist.clone()
    s_row = torch.full((n, BR), -1, dtype=torch.int64, device=dev)
    for blk in range(nb):
        idx = torch.nonzero(flags[blk]).squeeze(1)
        if not idx.numel():
            continue
        count(stats, "occlusion_pairs", idx.numel())
        sel = lambda v: tuple(c[idx] for c in v)
        bt, br = test_block(scene.p, torch.full_like(idx, blk), sel(so),
                             sel(sd), so_mag[idx], t_min[idx], s_t[idx],
                             s_row[idx])
        s_t = s_t.index_put((idx,), bt)
        s_row = s_row.index_put((idx,), br)
    # The (lane, block) pairs the occlusion walk needs: a live lane with a
    # primary hit needs the blocks its own shadow ray's slab admits with
    # an entry below its nearest triangle hit (or the light).
    count(stats, "occlusion_needed",
          (bhit & (tin * SLAB_LO < s_t[None])
           & (found & (t_max > 0.0))[None]).sum())
    s_tri = s_row >= 0
    s_best = torch.where(s_tri, s_t, dist)
    ssb, sst, _, _ = _sphere_pass(ap, n_sph, sorig, sdir, t_min, s_best)
    s_best = torch.where(ssb, sst, s_best)
    sdb, sdt, _, _ = _disc_pass(ap, n_sph, n_dsc, sorig, sdir, t_min, s_best)
    s_best = torch.where(sdb, sdt, s_best)
    s_found = s_tri | ssb | sdb
    occ = s_found & (torch.where(s_found, s_best, dist) < dist)

    out_f = torch.stack([*n_raw, hit_t]).reshape(4, n * BR)
    out_i = torch.stack([tri.to(torch.int32), torch.where(sb, si, -1),
                         torch.where(db, di, -1), occ.to(torch.int32)])
    return out_f, out_i.reshape(4, n * BR)


def shadow_trace_ref(scene, counts, order, dists, rays, *, light,
                     stats: dict | None = None, bundles: int = REF_BUNDLES):
    """Plain-torch version of the kernel on any device: counts [nrb] i32,
    order [nrb, nb] i32 and dists [nrb, nb] f32 from the bundle cull, rays
    [8, nrb*BR] f32 (origin, direction, t_min, t_max rows), ``light`` the
    point light (3 floats) -> (out_f [4, nrb*BR] f32, out_i [4, nrb*BR]
    i32). ``stats`` (a dict) gains ``primary_pairs`` and
    ``occlusion_pairs``: the (bundle, block) pairs each walk tested; and
    ``occlusion_needed``: the (lane, block) pairs the occlusion walk's
    hits need (the primary walk's are ``intersect_kernel.needed_pairs``
    of the kernel's hit t).
    ``bundles``: how many bundles advance together (memory, not result)."""
    nrb = counts.shape[0]
    outs = [_bundles_ref(scene, counts[b:b + bundles], order[b:b + bundles],
                         dists[b:b + bundles], rays[:, b * BR:(b + bundles) * BR],
                         light, stats)
            for b in range(0, nrb, bundles)]
    return (torch.cat([f for f, _ in outs], dim=1),
            torch.cat([i for _, i in outs], dim=1))


def shadow_trace_cuda(scene, counts, order, dists, rays, *, light,
                      pairs=None, counters=None):
    """The CUDA kernel (same arguments and results as
    :func:`shadow_trace_ref`); asynchronous on the current stream.
    ``pairs`` ([4, nrb] i32, zeroed) gains per bundle the blocks of its
    primary walk and of its occlusion union and the (lane, block) pairs
    each walk's lanes tested; ``counters`` ([K45_COUNTERS] int64, zeroed)
    makes it a counting launch."""
    global launches
    from .cuda.build import launch_shadow

    Rp = rays.shape[1]
    out_f = torch.empty((4, Rp), dtype=torch.float32, device=rays.device)
    out_i = torch.empty((4, Rp), dtype=torch.int32, device=rays.device)
    launch_shadow(scene, counts, order, dists, rays, out_f, out_i,
                  light=tuple(float(np.float32(v)) for v in light),
                  pairs=pairs, counters=counters)
    launches += 1
    return out_f, out_i


def shadow_inputs(scene, origins, dirs: torch.Tensor):
    """Pad R rays to whole bundles (directions with 1.0, t_max with -1:
    dead lanes) and cull them: (counts, order, dists, rays [8, Rp]).
    ``origins`` None: every ray starts at (0, 0, 0)."""
    R = dirs.shape[0]
    Rp = -(-R // BR) * BR
    pad = Rp - R
    dev = dirs.device
    if origins is None:
        origins = torch.zeros_like(dirs)
    o_pad = torch.nn.functional.pad(origins, (0, 0, 0, pad))
    d_pad = torch.nn.functional.pad(dirs, (0, 0, 0, pad), value=1.0)
    tmin = torch.zeros(Rp, dtype=torch.float32, device=dev)
    tmax = torch.full((Rp,), INF, dtype=torch.float32, device=dev)
    tmax[R:] = -1.0
    counts, order, dists = block_cull_lists_bundle(
        scene, o_pad, d_pad, tmin, tmax, Rp // BR)
    rays = torch.cat([o_pad.t(), d_pad.t(), tmin[None], tmax[None]]).contiguous()
    return counts, order, dists, rays


def fused_shadow_trace_arrays(scene, origins, dirs: torch.Tensor, *, light):
    """One shadow-trace dispatch over R rays (origins [R, 3] f32 or None
    for (0, 0, 0), dirs [R, 3] f32): the kernel for CUDA tensors,
    :func:`shadow_trace_ref` for CPU tensors. Returns the raw
    (out_f [4, R], out_i [4, R]) (module docstring)."""
    R = dirs.shape[0]
    dev = scene.device.type
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {scene.device}")
    with span("renderer.cull"):
        args = shadow_inputs(scene, origins, dirs)
    with span("renderer.kernel"):
        trace = shadow_trace_cuda if dev == "cuda" else shadow_trace_ref
        out_f, out_i = trace(scene, *args, light=light)
    return out_f[:, :R], out_i[:, :R]


def light_ray(origins, dirs, found, hit_t, light_pos):
    """The hit point [R, 3] (the origin where nothing is hit), the unit
    direction to the point light and its distance, as the JAX package's
    ``shadow_trace`` computes them (render/shadow.py:76-81)."""
    hp_t = torch.where(found, hit_t, 0.0)
    hit_p = (dirs * hp_t[:, None] if origins is None
             else fma(dirs, hp_t[:, None], origins))
    light = const3(*(float(np.float32(v)) for v in light_pos), dirs.device)
    light_offset = from_hit(origins, dirs, hp_t, light[None, :], 1.0)
    dist = sqrt(rowdot(light_offset, light_offset))
    return hit_p, light_offset / torch.clamp_min(dist, TINY)[:, None], dist


def shade(scene, geom, prim, found, normal, hit_t, hit_p, sdir, occ,
          ambient):
    """Albedo, lambert and rgb (render/shadow.py:86-100): the AOV tuple
    (rgb [R, 3], t [R], geom_id [R] i32, prim_id [R] i32, normal [R, 3],
    hit_p [R, 3], escaped [R] bool)."""
    g_safe = torch.clamp(geom, 0, scene.mat_id.shape[0] - 1).long()
    albedo = scene.mat_albedo[scene.mat_id[g_safe].long()]
    lambert = torch.where(occ, 0.0, rowdot(sdir, normal))
    rgb = fma(albedo, float(np.float32(ambient)), lambert[:, None] * albedo)
    rgb = torch.where(found[:, None], rgb, 0.0)
    return (rgb, torch.where(found, hit_t, INF),
            torch.where(found, geom, INVALID_GEOM_ID).to(torch.int32), prim,
            normal, torch.where(found[:, None], hit_p, 0.0), ~found)


def shadow_epilogue(scene, origins, dirs, out_f, out_i, light_pos, ambient):
    """The shading after the kernel (shadow_kernel.py:457-524): id
    resolution, normals, hit point, light direction, albedo, lambert and
    rgb, as XLA compiles them. ``origins`` None means camera rays from the
    origin (0, 0, 0): XLA then drops the zero origin, and a hit point
    feeding a difference fuses into it. Returns :func:`shade`'s tuple."""
    hit_t = out_f[3]
    geom, prim, found, normal = resolve_hit(
        scene, origins, dirs, hit_t, out_i[0], out_i[1], out_i[2],
        unit(out_f[0:3].t()))
    hit_p, sdir, _ = light_ray(origins, dirs, found, hit_t, light_pos)
    return shade(scene, geom, prim, found, normal, hit_t, hit_p, sdir,
                 out_i[3] != 0, ambient)


def fused_shadow_trace(scene, origins, dirs, light_pos, ambient):
    """Shadow trace of R rays (``origins`` None: camera rays from
    (0, 0, 0)): the kernel (or its plain version on the CPU) and the
    epilogue; returns :func:`shadow_epilogue`'s fields."""
    out_f, out_i = fused_shadow_trace_arrays(scene, origins, dirs,
                                             light=light_pos)
    with span("renderer.epilogue"):
        return shadow_epilogue(scene, origins, dirs, out_f, out_i, light_pos,
                               ambient)
