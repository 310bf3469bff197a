"""Streaming path tracer with path regeneration: the full-frame loop around
the megakernel or the XLA-loop integrator (port of ``render_streaming``,
ipu_ray_lib_tpu/render/streaming.py:584, and ``streaming_path_trace``,
:85-257), optionally lit by an environment, at any scene size.

A fixed pool of R ray slots serves the window's tile-ordered pixel stream
(render/pixels.py; its coordinates reach the device once per window): slot
s owns the padded-stream pixels {s, s+R, ...}, J of them; each slot runs
its J*spp paths back to back inside the kernel. High spp renders run in
decorrelated batches of at most ``SPP_BATCH`` samples (and
``MAX_K_PER_DISPATCH`` paths per slot) with seeds ``seed + 0x9E3779B9*bi``
— the batch schedule is part of the RNG contract — and accumulate on the
device, weighted ``b/spp`` per batch in batch order.

The reference splits the frame into pixel groups only to overlap TPU
readback with compute; the union of groups equals one dispatch bit for
bit, so this module runs one group, [(0, J)]. ``b_cap`` comes from the
global J (the reference computed it per group, a known fault that binds
only when J > 32).

The walk follows ``params.intersector`` (``"pallas"``: K1's VMEM-mode
walk; ``"pallas-hbm"``: K3's HBM-mode walk, ops/megakernel.py). The mode
changes nothing here: the reference's HBM mode alters only its TPU bundle
count (streaming.py:724-725); the pool, the pixel stream, the batches and
the seeds are the same. The ``"bvh"`` and ``"dense"`` intersectors run
the XLA-loop integrator below, with or without an environment, as the
reference routes them (``_use_megakernel``, :575-582).

A NIF environment light (``env``) is evaluated once per dispatch over
every escaped path (ops/megakernel.py), so the reference's env flush
cadence and count knobs (``RAY_ENV_EVERY``/``RAY_ENV_COUNT``, scheduling
only) have no counterpart here.

Any other environment, a callable ``env(dirs [R, 3]) -> rgb [R, 3]``,
runs the XLA-loop integrator instead, as the reference routes opaque env
functions (``_use_megakernel``, :575-582): a host loop over iterations,
each one segment of every active slot through the closest-hit kernel
(K5, or K6 in HBM mode; ops/traversal.py ``pallas_path_intersect``; for
``"bvh"`` and ``"dense"`` K7 or K8 through ``scene_intersect_with_normal``
and the material gathered by geometry id), the BxDF sampling in plain
torch (ops/bxdf_loop.py) and the regeneration of finished slots. Its
slot pool is not rounded to 256. A NIF lights this loop's escapes with
the XLA env function's angles (:func:`env_term`, the env MLP kernel K2).
"""

from __future__ import annotations

import numpy as np
import torch

from ..nif.model import NifEnv
from ..ops.bxdf_loop import (dielectric, evaluate_roulette, offset_ray_origin,
                             reflect, sample_diffuse)
from ..ops.camera import pixel_to_ray_dir, tan_half_fov
from ..ops.env import env_mlp
from ..ops.megakernel import megakernel_path_trace
from ..ops.rng import normal2, uniform01
from ..ops.traversal import pallas_path_intersect, scene_intersect_with_normal
from ..ops.vec3 import fma
from ..utils.profiling import span
from .pixels import pixel_stream

SPP_BATCH = 64
MAX_K_PER_DISPATCH = 2048
MAT_DIFFUSE, MAT_SPECULAR, MAT_REFRACTIVE = 0, 1, 2
# The XLA-loop host loop reads ``active.any()`` once every this many
# iterations; an iteration with no active slot changes nothing.
ACTIVE_CHECK = 4
_U32 = 0xFFFFFFFF

def slot_pool(n_pix: int, chunk_slots: int) -> tuple[int, int]:
    """(R, J): the slot pool, a multiple of 256 no larger than the frame
    needs, and the pixels per slot."""
    R = min(chunk_slots, n_pix)
    R = min(-(-R // 256) * 256, -(-n_pix // 256) * 256)
    return R, -(-n_pix // R)


def env_term(env, dirs: torch.Tensor) -> torch.Tensor:
    """The environment's radiance [R, 3] of directions [R, 3] as the JAX
    package's XLA-loop integrator and per-sample path trace take it: a
    NifEnv with the equirect angles of the XLA env function (the env MLP
    kernel on the card), any other env as the callable it is."""
    if isinstance(env, NifEnv):
        return env_mlp(dirs, env, exact_uv=True)
    return env(dirs)


def _path_hit(scene, o, d, t_min, t_max, intersector: str) -> dict:
    """The closest hit's t, found, normal and material per ray (as
    ``pallas_path_intersect`` returns them), through ``intersector``:
    ``"bvh"`` and ``"dense"`` gather the material by geometry id."""
    if intersector in ("pallas", "pallas-hbm"):
        return pallas_path_intersect(scene, o, d, t_min, t_max,
                                     hbm=intersector == "pallas-hbm")
    hit, normal = scene_intersect_with_normal(scene, o, d, t_min, t_max,
                                              intersector)
    g = torch.clamp(hit.geom_id, 0, scene.mat_id.shape[0] - 1).long()
    mid = scene.mat_id[g].long()
    return dict(t=hit.t, found=hit.found, normal=normal,
                albedo=scene.mat_albedo[mid], mat_type=scene.mat_type[mid],
                ior=scene.mat_ior[mid], emission=scene.mat_emission[mid],
                emissive=scene.mat_emissive[mid] != 0)


def _camera_ray(params, rows, cols, pix, path_id, seed):
    """Camera rays of the slots' pixels ``pix`` (port of ``_camera_ray``,
    streaming.py:59-78): jittered by a gaussian pair keyed (path id, seed,
    0xCA3), origins pushed off (0, 0, 0) along the normal (0, 0, 1)."""
    g1, g2 = normal2(path_id, seed, 0xCA3)
    pix = torch.clamp_max(pix, rows.shape[0] - 1)  # a finished slot's k = K
    aa = float(np.float32(params.anti_alias_scale))
    pu = fma(g1, aa, rows[pix])
    pv = fma(g2, aa, cols[pix])
    d = pixel_to_ray_dir(pv, pu, params.image_width, params.image_height,
                         tan_half_fov(params.fov_radians))
    up = torch.zeros_like(d)
    up[:, 2] = 1.0
    return offset_ray_origin(torch.zeros_like(d), d, up), d


def streaming_path_trace(scene, rows, cols, seed: int, n_valid: int, *,
                         params, slots: int, j_per_slot: int, spp: int,
                         max_iters: int, env):
    """The XLA-loop integrator (port of ``streaming_path_trace``): a pool
    of ``slots`` slots, slot s serving the padded-stream pixels
    {s + j*slots}, j < ``j_per_slot``, each ``spp`` times; rows/cols
    [slots*j_per_slot] f32 on the scene's device; pixels >= ``n_valid``
    get no paths. Returns (accum [J, 3, R] radiance sums, done (a 0-d
    tensor), iters: the iterations that had an active slot)."""
    R, J = slots, j_per_slot
    K = J * spp
    dev = scene.device
    f32 = torch.float32
    slot = torch.arange(R, dtype=torch.int64, device=dev)
    seed &= _U32

    def slot_pix(k):
        j = k // spp
        return slot + j * R, j

    def slot_pid(k):
        return (slot * K + k) & _U32

    valid_j = torch.clamp(-((slot - n_valid) // R), 0, J)
    k_cap = valid_j * spp
    k = torch.zeros(R, dtype=torch.int64, device=dev)
    bounce = torch.zeros(R, dtype=torch.int64, device=dev)
    o, d = _camera_ray(params, rows, cols, slot_pix(k)[0], slot_pid(k), seed)
    tp = torch.ones((R, 3), dtype=f32, device=dev)
    color = torch.zeros((R, 3), dtype=f32, device=dev)
    active = k_cap > 0
    accum = torch.zeros((J, R, 3), dtype=f32, device=dev)
    done = torch.zeros((), dtype=torch.int64, device=dev)
    t_min = torch.zeros(R, dtype=f32, device=dev)
    ran = []

    for it in range(max_iters):
        if it % ACTIVE_CHECK == 0 and not bool(active.any()):
            break
        ran.append(active.any())
        pid = slot_pid(k)
        rng_b = (bounce + 7 + seed) & _U32
        t_max = torch.where(active, float("inf"), -1.0)
        res = _path_hit(scene, o, d, t_min, t_max, params.intersector)
        found, hit_n = res["found"], res["normal"]
        live = active & found
        hit_p = fma(d, res["t"][:, None], o)
        color = color + torch.where((live & res["emissive"])[:, None],
                                    tp * res["emission"], 0.0)
        u = [uniform01(pid, rng_b, c) for c in range(4)]

        d_diffuse = sample_diffuse(hit_n, u[0], u[1])
        d_specular = reflect(d, hit_n)
        d_dielec, refracted = dielectric(d, hit_n, res["ior"], u[2])
        mtype = res["mat_type"]
        is_diff = mtype == MAT_DIFFUSE
        is_spec = mtype == MAT_SPECULAR
        new_d = torch.where(is_diff[:, None], d_diffuse,
                            torch.where(is_spec[:, None], d_specular,
                                        d_dielec))
        scale_tp = is_diff | is_spec | ((mtype == MAT_REFRACTIVE) & refracted)
        tp_in = tp
        tp = tp * torch.where((live & scale_tp)[:, None], res["albedo"], 1.0)
        o = torch.where(live[:, None], offset_ray_origin(hit_p, new_d, hit_n),
                        o)
        d = torch.where(live[:, None], new_d, d)

        stop_r, tp_r = evaluate_roulette(u[3], tp)
        use_roulette = bounce > params.roulette_start_depth
        tp = torch.where((use_roulette & live)[:, None], tp_r, tp)
        killed = live & use_roulette & stop_r

        escaped = active & ~found
        if env is not None:
            color = color + torch.where(escaped[:, None],
                                        tp_in * env_term(env, d), 0.0)

        bounce = bounce + 1
        over = live & (bounce >= params.max_path_length)
        terminated = escaped | killed | over

        # Bank finished paths in order: each (j, slot) at most once here
        # (a slot past its last path, j = J, banks nothing).
        _, j_cur = slot_pix(k)
        accum.index_put_((torch.clamp_max(j_cur, J - 1), slot),
                         torch.where(terminated[:, None], color, 0.0),
                         accumulate=True)
        done = done + terminated.sum()

        k = torch.where(terminated, torch.clamp_max(k + 1, K), k)
        active = active & ~terminated
        bounce = torch.where(terminated, 0, bounce)
        color = torch.where(terminated[:, None], 0.0, color)

        can_spawn = ~active & (k < k_cap)
        pix, _ = slot_pix(k)
        co, cd = _camera_ray(params, rows, cols, pix, slot_pid(k), seed)
        o = torch.where(can_spawn[:, None], co, o)
        d = torch.where(can_spawn[:, None], cd, d)
        tp = torch.where(can_spawn[:, None], 1.0, tp)
        active = active | can_spawn

    iters = int(torch.stack(ran).sum()) if ran else 0
    return accum.permute(0, 2, 1), done, iters


def megakernel_route(intersector: str, env) -> bool:
    """Whether the megakernel renders (the reference's ``_use_megakernel``):
    the ``"pallas"`` and ``"pallas-hbm"`` intersectors with no env or a
    NIF."""
    return (intersector in ("pallas", "pallas-hbm")
            and (env is None or isinstance(env, NifEnv)))


def uses_megakernel(slots: int, env, intersector: str = "pallas") -> bool:
    """The megakernel route (K1/K3, with a NifEnv its record mode, env MLP
    and bank) when :func:`megakernel_route` holds and the pool of
    ``slots`` tiles into 256; otherwise the XLA-loop integrator."""
    return megakernel_route(intersector, env) and slots % 256 == 0


def trace_batch(scene, rows, cols, seed: int, n_valid: int, *, params,
                slots: int, j_per_slot: int, spp: int, env=None,
                stats: dict | None = None):
    """One batch of ``spp`` samples of the stream rows/cols [slots *
    j_per_slot] (the first ``n_valid`` real) on the route
    :func:`uses_megakernel` picks. Returns (flat [slots*j_per_slot, 3] f32
    spp-averaged radiance, done: the finished paths, a 0-d tensor).
    ``stats`` (a dict, XLA-loop integrator only) gains ``iters``."""
    R, J = slots, j_per_slot
    kw = dict(params=params, slots=R, j_per_slot=J, spp=spp,
              max_iters=J * spp * params.max_path_length + 16, env=env)
    if uses_megakernel(R, env, params.intersector):
        return megakernel_path_trace(scene, rows, cols, seed, n_valid, **kw)
    accum, done, iters = streaming_path_trace(scene, rows, cols, seed,
                                              n_valid, **kw)
    if stats is not None:
        stats["iters"] = stats.get("iters", 0) + iters
    return accum.permute(0, 2, 1).reshape(R * J, 3) / spp, done


def render_streaming(scene, params, chunk_slots: int = 1 << 17, env=None,
                     spp: int | None = None, seed: int | None = None,
                     readback_f16: bool = False, stats: dict | None = None):
    """Full-window streaming render on the scene's device at ``spp``
    samples per pixel (default ``params.samples_per_pixel``), seeded by
    ``seed`` (default ``params.rng_seed``), lit by ``env`` when given: a
    :class:`~ipu_ray_lib_tpu_torch.nif.model.NifEnv` on the scene's device
    (the megakernel), or any callable ``env(dirs [R, 3]) -> rgb [R, 3]``
    (the XLA-loop integrator). Returns (rgb [H, W, 3] float32 numpy, done:
    the number of finished paths). ``readback_f16``: the accumulated image
    is rounded to f16 on the device (to nearest even) before it is read
    back, then widened to f32. ``stats`` (a dict, XLA-loop integrator only)
    gains ``iters``."""
    spp = params.samples_per_pixel if spp is None else int(spp)
    seed = params.rng_seed if seed is None else int(seed)
    n_pix = params.window_w * params.window_h
    if megakernel_route(params.intersector, env):
        R, J = slot_pool(n_pix, chunk_slots)
    else:
        R = min(chunk_slots, n_pix)
        J = -(-n_pix // R)
    with span("streaming.upload"):
        stream = pixel_stream(params)
        rows, cols = stream.coords(scene.device, R * J)

    b_cap = max(1, MAX_K_PER_DISPATCH // J)
    flat_acc = None
    dones = []
    s = bi = 0
    while s < spp:
        b = min(SPP_BATCH, b_cap, spp - s)
        bseed = (seed + 0x9E3779B9 * bi) & _U32
        with span("streaming.batch"):
            flat_b, done_b = trace_batch(scene, rows, cols, bseed, n_pix,
                                         params=params, slots=R,
                                         j_per_slot=J, spp=b, env=env,
                                         stats=stats)
            wgt = float(np.float32(b / spp))
            flat_acc = (flat_b * wgt if flat_acc is None
                        else flat_acc + flat_b * wgt)
        dones.append(done_b)
        s += b
        bi += 1
    with span("streaming.readback"):
        if readback_f16:
            flat_acc = flat_acc.to(torch.float16)
        flat = flat_acc[:n_pix].cpu().numpy()
    with span("streaming.scatter"):
        img = stream.scatter(flat)
        done = int(torch.stack(dones).sum())
    return img, done
