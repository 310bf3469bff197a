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
:func:`shadow_epilogue`, as the JAX package computes them in XLA after
its kernel.

The glue around the kernel, which XLA fuses in the JAX package, is two
kernels of its own on CUDA tensors (``ops/cuda/glue.cu``), so a chunk is
three launches: the prologue (:func:`shadow_inputs_cuda`, or
:func:`camera_inputs_cuda` making the camera rays from pixel
coordinates) and the epilogue (:func:`shade_cuda`, writing each AOV
straight into the caller's tensors). They equal the plain torch versions
:func:`shadow_inputs` (with ops/camera.py ``scaled_ray_dir`` and
ops/cull.py ``bundle_cull``) and :func:`shadow_epilogue` byte for byte;
those stay for CPU tensors and as the kernels' checks.

The glue route (render/shadow.py) of a ``"bvh"`` scene on the card is
three kernels of ops/cuda/glue.cu around K7's two walks (ops/bvh.py):
the rays kernel, K7's closest hit, the light kernel (the normal, the
light ray and the shadow ray's offset origin), K7's any hit and the shade
kernel (:func:`bvh_shadow_trace_cuda`: five launches; the renderer's
frame, :func:`bvh_camera_frame_cuda`: the glue kernels once a frame and
K7 twice a chunk), byte for byte the torch chain of
ops/traversal.py ``hit_normal``, :func:`light_ray`, ops/bxdf_loop.py
``offset_ray_origin`` and :func:`shade`, which the other glue routes and
CPU scenes keep.

The glue route of a ``"pallas-hbm"`` scene on the card is three kernels
of ops/cuda/glue.cu around K6's two queries (ops/intersect_hbm.py):
the prologue against the super AABBs (the camera rays or the caller's,
their padding and super cull), K6's closest hit, the light kernel (the
spheres and discs, the ids and normal, the shadow rays and their super
cull), K6 on the shadow rays and the shade kernel (the occlusion and the
shading; :func:`_hbm_glue`: :func:`hbm_shadow_trace_cuda` for a batch of
rays, :func:`hbm_camera_chunk_cuda` for the renderer's chunk), byte for
byte the torch chain of ops/intersect_kernel.py ``intersect_inputs``,
ops/cull.py ``super_cull_lists_bundle``, ops/traversal.py
``pallas_scene_intersect`` and ``scene_occluded``, :func:`light_ray`,
``offset_ray_origin`` and :func:`shade`.

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
from . import bvh
from .cull import BR, SLAB_SCALE, block_cull_lists_bundle
from .dense import disc_pass, sphere_pass
from .intersect import INF, SLAB_LO
from .intersect_kernel import (CHECK_EVERY, REF_BUNDLES, _dot, count, lanes,
                               o_mag, test_block, walk, winner_payload)
from .traversal import from_hit, resolve_hit
from .vec3 import TINY, const3, fma, rowdot, sqrt, unit

BIG = 1e30  # K4's padding-box bound (float32(1e30) is this value's f32)
_RAY_EPS = float(RAY_EPSILON)

# K4's CUDA launches since the last reset, and the glue kernels' (those
# of ops/cuda/glue.cu: the prologue and the epilogue around K4, the rays,
# light and shade kernels around K7, the prologue, light and shade kernels
# around K6).
launches = 0
glue_launches = 0


def reset_launches() -> None:
    global launches, glue_launches
    launches = glue_launches = 0


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


def _inputs_cuda(scene, R: int, aabb=None, **rays):
    """The prologue kernel over R rays (``rays``: as
    ``launch_rays_cull`` takes them), culled against ``aabb`` (default the
    scene's block AABBs): (counts, order, dists, rays)."""
    global glue_launches
    from .cuda.build import launch_rays_cull

    aabb = scene.baabb if aabb is None else aabb
    dev = aabb.device
    nrb, nb = -(-R // BR), aabb.shape[0]
    out = (torch.empty(nrb, dtype=torch.int32, device=dev),
           torch.empty((nrb, nb), dtype=torch.int32, device=dev),
           torch.empty((nrb, nb), dtype=torch.float32, device=dev),
           torch.empty((8, nrb * BR), dtype=torch.float32, device=dev))
    launch_rays_cull(aabb, out[3], *out[:3], R=R, **rays)
    glue_launches += 1
    return out


def shadow_inputs_cuda(scene, origins, dirs: torch.Tensor):
    """:func:`shadow_inputs` as one kernel (ops/cuda/glue.cu), for CUDA
    tensors: the same (counts, order, dists, rays), byte for byte."""
    return _inputs_cuda(scene, dirs.shape[0], origins=origins, dirs=dirs)


def camera_inputs_cuda(scene, rows, cols, image: tuple, scale: tuple):
    """:func:`shadow_inputs` of the camera rays through the pixels (rows,
    cols) [R] f32 (ops/camera.py ``scaled_ray_dir(cols, rows, *image,
    *scale)``, from the origin) as one kernel that makes the rays too:
    ``image`` (w, h), ``scale`` the image plane's (sx, sy), floats or 0-d
    f32 tensors on the card (a CUDA graph reads them at each replay)."""
    f32 = np.float32
    inv = [float(f32(1.0) / f32(n)) for n in image]
    return _inputs_cuda(scene, rows.shape[0],
                        camera=(rows, cols, *inv, *scale))


def _trace(scene, origins, dirs: torch.Tensor, light):
    """The cull's inputs and K4's raw outputs, padded, of R rays: the
    kernels for CUDA tensors, the plain versions for CPU tensors."""
    dev = scene.device.type
    if dev not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {scene.device}")
    with span("renderer.cull"):
        inputs = shadow_inputs_cuda if dev == "cuda" else shadow_inputs
        args = inputs(scene, origins, dirs)
    with span("renderer.kernel"):
        trace = shadow_trace_cuda if dev == "cuda" else shadow_trace_ref
        return args, *trace(scene, *args, light=light)


def fused_shadow_trace_arrays(scene, origins, dirs: torch.Tensor, *, light):
    """One shadow-trace dispatch over R rays (origins [R, 3] f32 or None
    for (0, 0, 0), dirs [R, 3] f32): the kernels for CUDA tensors,
    their plain versions for CPU tensors. Returns the raw
    (out_f [4, R], out_i [4, R]) (module docstring)."""
    R = dirs.shape[0]
    _, out_f, out_i = _trace(scene, origins, dirs, light)
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


def shade_cuda(scene, rays, out_f, out_i, R: int, light_pos, ambient, *,
               zero_origin: bool, out: dict | None = None):
    """:func:`shadow_epilogue` of the first R of the padded ``rays`` and
    K4's padded ``out_f``/``out_i`` as one kernel (ops/cuda/glue.cu), for
    CUDA tensors, byte for byte; ``zero_origin``: the rays start at (0, 0,
    0) (``origins`` None there). ``out``: the AOVs to write, name ->
    tensor [R, ...] (``ops/cuda/build.py:SHADE_OUTS``; a chunk's rows of
    the renderer's buffers); None: every AOV and ``escaped`` in fresh
    tensors, returned as :func:`shade`'s tuple."""
    global glue_launches
    from .cuda.build import SHADE_OUTS, launch_shade

    fresh = out is None
    if fresh:
        out = {k: torch.empty((R,) + shape, dtype=dt, device=rays.device)
               for k, (shape, dt) in SHADE_OUTS.items()}
    launch_shade(scene, rays, out_f, out_i, out, R=R,
                 light=tuple(float(np.float32(v)) for v in light_pos),
                 ambient=float(np.float32(ambient)), zero_origin=zero_origin)
    glue_launches += 1
    return tuple(out.values()) if fresh else None


def fused_shadow_trace(scene, origins, dirs, light_pos, ambient):
    """Shadow trace of R rays (``origins`` None: camera rays from
    (0, 0, 0)): the prologue, K4 and the epilogue, as kernels for CUDA
    tensors (or their plain versions for CPU tensors); returns
    :func:`shadow_epilogue`'s fields."""
    R = dirs.shape[0]
    args, out_f, out_i = _trace(scene, origins, dirs, light_pos)
    with span("renderer.epilogue"):
        if scene.device.type == "cuda":
            return shade_cuda(scene, args[3], out_f, out_i, R, light_pos,
                              ambient, zero_origin=origins is None)
        return shadow_epilogue(scene, origins, dirs, out_f[:, :R],
                               out_i[:, :R], light_pos, ambient)


def camera_chunk_cuda(scene, rows, cols, image: tuple, scale: tuple,
                      out: dict, light_pos, ambient) -> None:
    """One chunk of the renderer's shadow frame on the card, three
    launches: :func:`camera_inputs_cuda` (the camera rays through the
    pixels (rows, cols) [R] and their cull), K4, and :func:`shade_cuda`
    writing the AOVs of ``out`` (name -> the chunk's rows [R, ...]);
    the same bytes as ``scaled_ray_dir``, :func:`fused_shadow_trace` and
    the stores. Nothing returns to the host, so a CUDA graph captures it."""
    with span("renderer.cull"):
        args = camera_inputs_cuda(scene, rows, cols, image, scale)
    with span("renderer.kernel"):
        out_f, out_i = shadow_trace_cuda(scene, *args, light=light_pos)
    with span("renderer.epilogue"):
        shade_cuda(scene, args[3], out_f, out_i, rows.shape[0], light_pos,
                   ambient, zero_origin=True, out=out)


def _bvh_glue(scene, R: int, out: dict, light_pos, ambient, *, walk: int,
              camera=None, origins=None, dirs=None) -> None:
    """The BVH glue route of R rays on the card: the rays kernel, K7's
    closest hit in launches of ``walk`` rays, the light kernel, K7's any
    hit likewise and the shade kernel writing the AOVs of ``out`` (name ->
    [R, ...]): three glue launches and 2 ceil(R / walk) of K7. The rays:
    ``camera`` (as ``launch_bvh_rays`` takes it), or ``dirs`` [R, 3] with
    ``origins`` [R, 3] (None: the origin). Nothing returns to the host."""
    global glue_launches
    from .cuda.build import launch_bvh_light, launch_bvh_rays, launch_bvh_shade

    dev = scene.device
    f32, i32 = torch.float32, torch.int32
    vec = lambda: torch.empty((R, 3), dtype=f32, device=dev)
    ray = lambda dt=f32: torch.empty(R, dtype=dt, device=dev)
    zero = origins is None
    o = vec() if zero else origins
    if camera is not None:
        dirs = vec()
    t_min, t_max = ray(), ray()
    launch_bvh_rays(t_min, t_max, zeros=o if zero else None,
                    dirs=dirs if camera is not None else None, camera=camera)
    glue_launches += 1
    hit = (ray(), ray(i32), ray(i32))
    for s in range(0, R, walk):
        w = slice(s, s + walk)
        bvh.bvh_walk_raw(scene, o[w], dirs[w], t_min[w], t_max[w], False,
                         zero, out=tuple(h[w] for h in hit))
    light = tuple(float(np.float32(v)) for v in light_pos)
    sorig, sdir, normal, dist = vec(), vec(), vec(), ray()
    launch_bvh_light(scene, dirs, *hit, sorig, sdir, dist, normal,
                     origins=origins, light=light)
    glue_launches += 1
    # the any hit writes only its flag; t and prim go to scratch rows
    occ = ray(i32)
    scratch = (torch.empty(min(walk, R), dtype=f32, device=dev),
               torch.empty(min(walk, R), dtype=i32, device=dev))
    for s in range(0, R, walk):
        w = slice(s, s + walk)
        n = occ[w].shape[0]
        bvh.bvh_walk_raw(scene, sorig[w], sdir[w], t_min[w], dist[w], True,
                         False, out=(scratch[0][:n], occ[w], scratch[1][:n]))
    launch_bvh_shade(scene, dirs, *hit, normal, occ, out, origins=origins,
                     light=light, ambient=float(np.float32(ambient)))
    glue_launches += 1


def bvh_shadow_trace_cuda(scene, origins, dirs, light_pos, ambient):
    """render/shadow.py ``shadow_trace`` of R rays on a ``"bvh"`` scene on
    the card (``origins`` [R, 3] or None for (0, 0, 0), ``dirs`` [R, 3]
    f32) as five launches (:func:`_bvh_glue`): :func:`shade`'s tuple in
    fresh tensors, byte for byte the torch chain's."""
    from .cuda.build import SHADE_OUTS

    R = dirs.shape[0]
    out = {k: torch.empty((R,) + shape, dtype=dt, device=dirs.device)
           for k, (shape, dt) in SHADE_OUTS.items()}
    if R:
        _bvh_glue(scene, R, out, light_pos, ambient, walk=R,
                  dirs=dirs.contiguous(),
                  origins=None if origins is None else origins.contiguous())
    return tuple(out.values())


def bvh_camera_frame_cuda(scene, rows, cols, image: tuple, scale: tuple,
                          out: dict, chunk: int, light_pos, ambient) -> None:
    """The renderer's shadow frame of a ``"bvh"`` scene on the card: the
    camera rays through the padded stream's pixels (rows, cols) [R] (as
    :func:`camera_chunk_cuda` takes a chunk's) and :func:`_bvh_glue` with
    K7 a launch a ``chunk`` of rays, writing the AOVs of ``out`` (name ->
    [R, ...]); the same bytes as each chunk's ``scaled_ray_dir``, the glue
    route's torch chain and the stores."""
    f32 = np.float32
    inv = [float(f32(1.0) / f32(n)) for n in image]
    _bvh_glue(scene, rows.shape[0], out, light_pos, ambient, walk=chunk,
              camera=(rows, cols, *inv, *scale))


def _hbm_glue(scene, R: int, out: dict, light_pos, ambient, *, camera=None,
              origins=None, dirs=None) -> None:
    """The HBM glue route of R rays on the card: the prologue (padding and
    the super cull), K6's closest hit, the light kernel (the spheres and
    discs, ids, normal, the shadow rays and their super cull), K6 on the
    shadow rays and the shade kernel (the occlusion and the shading),
    writing the AOVs of ``out`` (name -> [R, ...]): three glue launches
    and two K6 queries. The rays: ``camera`` (as ``launch_rays_cull``
    takes it), or ``dirs`` [R, 3] with ``origins`` [R, 3] (None: the
    origin). Nothing returns to the host."""
    global glue_launches
    from .cuda.build import launch_hbm_light, launch_hbm_shade
    from .intersect_hbm import super_walk_cuda

    dev = scene.device
    f32, i32 = torch.float32, torch.int32
    src = (dict(camera=camera) if camera is not None
           else dict(origins=origins, dirs=dirs))
    counts, order, dists, rays = _inputs_cuda(scene, R, aabb=scene.saabb,
                                              **src)
    k6_t, k6_i, k6_n = super_walk_cuda(scene, counts, order, dists,
                                       rays)[:3]
    Rp = rays.shape[1]
    srays = torch.empty((8, Rp), dtype=f32, device=dev)
    lists = (torch.empty_like(counts), torch.empty_like(order),
             torch.empty_like(dists))
    hit_f = torch.empty((4, Rp), dtype=f32, device=dev)
    hit_i = torch.empty((3, Rp), dtype=i32, device=dev)
    light = tuple(float(np.float32(v)) for v in light_pos)
    zero = camera is not None or origins is None
    launch_hbm_light(scene, rays, k6_t, k6_i, k6_n, srays, *lists, hit_f,
                     hit_i, R=R, light=light, zero_origin=zero)
    glue_launches += 1
    s_t, s_i = super_walk_cuda(scene, *lists, srays)[:2]
    launch_hbm_shade(scene, rays, hit_f, hit_i, srays, s_t, s_i, out, R=R,
                     light=light, ambient=float(np.float32(ambient)),
                     zero_origin=zero)
    glue_launches += 1


def hbm_shadow_trace_cuda(scene, origins, dirs, light_pos, ambient):
    """render/shadow.py ``shadow_trace`` of R rays on a ``"pallas-hbm"``
    scene on the card (``origins`` [R, 3] or None for (0, 0, 0), ``dirs``
    [R, 3] f32) as :func:`_hbm_glue`: :func:`shade`'s tuple in fresh
    tensors, byte for byte the torch chain's."""
    from .cuda.build import SHADE_OUTS

    R = dirs.shape[0]
    out = {k: torch.empty((R,) + shape, dtype=dt, device=dirs.device)
           for k, (shape, dt) in SHADE_OUTS.items()}
    if R:
        _hbm_glue(scene, R, out, light_pos, ambient, dirs=dirs.contiguous(),
                  origins=None if origins is None else origins.contiguous())
    return tuple(out.values())


def hbm_camera_chunk_cuda(scene, rows, cols, image: tuple, scale: tuple,
                          out: dict, light_pos, ambient) -> None:
    """One chunk of the renderer's shadow frame of a ``"pallas-hbm"`` scene
    on the card (arguments as :func:`camera_chunk_cuda` takes them):
    :func:`_hbm_glue` of the camera rays through the pixels (rows, cols)
    [R], three glue launches around K6's two queries; the same bytes as
    ``scaled_ray_dir``, render/shadow.py ``glue_shadow_trace`` and the
    stores."""
    f32 = np.float32
    inv = [float(f32(1.0) / f32(n)) for n in image]
    _hbm_glue(scene, rows.shape[0], out, light_pos, ambient,
              camera=(rows, cols, *inv, *scale))
