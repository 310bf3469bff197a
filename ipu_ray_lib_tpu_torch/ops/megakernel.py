"""The path-trace megakernel: the whole bounce loop in one kernel.

Port of ``megakernel_path_trace`` (ipu_ray_lib_tpu/ops/pallas/
megakernel.py:2638) in VMEM mode and in HBM mode (``hbm=True``, scenes of
any size), with or without a NIF environment light. A pool of
``R`` ray slots each serves ``K = J * spp`` paths: slot s owns the
padded-stream pixels {s + j*R}, and its paths k = 0..K-1 run one after
another — trace, shade, bank the radiance of a finished path into the
slot's own accumulator column, regenerate the next camera path in place —
until every slot is done or ``max_iters`` iterations pass.

Two implementations with one contract:

* the CUDA kernel (``ops/cuda/megakernel.cu``), one thread per slot, for
  CUDA tensors — the main path;
* :func:`megakernel_path_trace_ref`, a wavefront over all slots in plain
  torch, for CPU tensors and for checking the kernel on the card.

With a NIF environment light (``env``, the JAX kernel's ``env_cfg``
branch) a finished path adds ``throughput * env(direction)`` when it
escaped. The env term never steers a path, so the work runs as a short
wavefront: the kernel (or its plain twin) traces the same paths in record
mode, writing each finished path's colour, throughput, escape flag and
direction; the env MLP (ops/env.py) evaluates all escaped records at
once; ``bank`` adds each slot's records in k order, so every pixel sums
its paths in the reference's order.

Both apply the same per-lane block cull and the same operation order,
and draw the same counter-hash random numbers (ops/rng.py): path
``k`` of slot ``s`` uses pid ``(slot0 + s)*K_tot + j0*spp + k`` (``slot0``
is 0 but for a replay of a pool's slots from slot0 on); its camera jitter
is ``normal2(pid, seed, 0xCA3)`` and its four shading draws at a bounce
are ``uniform01(pid, bounce + 7 + seed, c)``, c = 0..3.

The triangle walk, chosen by ``params.intersector``:

* ``"pallas"`` (VMEM mode, kernel K1): a lane tests the rows of every
  128-row block whose AABB its slab admits;
* ``"pallas-hbm"`` (HBM mode, kernel K3; megakernel.py:1056-1549): a lane
  walks the super-group AABBs (``sgaabb``), the 8 supers of each admitted
  group (``saabb``), and refines each admitted super's 8 member blocks
  against their AABBs and its best t at the super's entry (``tin *
  SLAB_LO < best_t``), then tests the rows of the blocks that pass, in
  ascending order. The group level changes no flag: a group's box holds
  its supers' boxes, and the slab arithmetic is monotonic.

Both keep the smallest t (strictly smaller replaces; the lowest row wins a
tie), then re-derive the winner's barycentrics and read the shading normal
N0 + (dN1*b1 + dN2*b2), albedo, type, ior and emission from the ``nrm``
table. VMEM mode rounds the barycentrics to bf16 first, as the reference's
deferred payload dot does; HBM mode takes them in f32, as the reference's
in-walk payload does (megakernel.py:1362-1365, 1403-1405). Spheres and
discs override a triangle hit only when strictly nearer.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.profiling import span
from . import bxdf
from .camera import CameraConsts, camera_consts, camera_ray
from .env import env_mlp, env_mlp_ref
from .intersect import (INF, SLAB_LO, analytic_hit, barycentrics,
                        dense_rows, slab_admit, slab_inv, slab_test)
from .rng import normal2, uniform01
from .tables import SB, TB
from .vec3 import add3, normalize3, scale3, where3

_MASK = 0xFFFFFFFF

# Number of records per path (colour 3, throughput 3, escaped, direction 3):
REC_FIELDS = 10

# Lanes per chunk of the plain HBM walk's dense test ([SB*TB, lanes]
# temporaries):
_LANE_CHUNK = 8192

# CUDA kernel launches since the last reset (the counts that show a run
# went through the kernels): the megakernel in VMEM mode (K1) and in HBM
# mode (K3), and the bank kernel.
launches = 0
hbm_launches = 0
bank_launches = 0


def reset_launches() -> None:
    global launches, hbm_launches, bank_launches
    launches = hbm_launches = bank_launches = 0


def _count(stats, key, n) -> None:
    if stats is not None:
        stats[key] = stats.get(key, 0) + n


def _walk_vmem(scene, o, d, inv, active, o_mag, best_t, best_row, stats):
    """The VMEM-mode walk: every block whose AABB the lane's slab admits.
    ``stats`` gains ``block_tests``, the admitted (segment, block) pairs."""
    p, baabb = scene.p, scene.baabb
    tri_iota = torch.arange(TB, device=p.device, dtype=torch.int64)[:, None]
    for blk in range(baabb.shape[0]):
        adm = slab_admit(o, inv, active, baabb[blk])
        if not bool(adm.any()):
            continue
        _count(stats, "block_tests", adm.sum())
        t, ok = dense_rows(p[blk * TB:(blk + 1) * TB], o, d, o_mag)
        tm = torch.where(ok & adm, t, INF)
        bt = torch.amin(tm, dim=0)
        bi = torch.amin(torch.where(tm <= bt, tri_iota, TB), dim=0)
        better = (bt < best_t) & (bt < INF)
        best_t = torch.where(better, bt, best_t)
        best_row = torch.where(better, bi + blk * TB, best_row)
    return best_t, best_row


def _walk_super(p, baabb, s, o, d, inv, o_mag, best_t, best_row, stats):
    """One admitted super ``s`` for a set of lanes: refine its SB member
    blocks against their AABBs and the lanes' best t at the super's entry
    (megakernel.py:1150-1162), test the rows of the blocks that pass, and
    fold them in ascending block order. Returns the new best t and row."""
    adm, tin = slab_test(o, inv, torch.ones_like(best_t, dtype=torch.bool),
                         baabb[s * SB:(s + 1) * SB])
    need = adm & (tin * SLAB_LO < best_t)                     # [SB, L]
    _count(stats, "block_tests", need.sum())
    t, ok = dense_rows(p[s * SB * TB:(s + 1) * SB * TB], o, d, o_mag)
    tm = torch.where(ok, t, INF).reshape(SB, TB, -1)
    bt = torch.amin(tm, dim=1)                                # [SB, L]
    tri_iota = torch.arange(TB, device=p.device, dtype=torch.int64)[:, None]
    bi = torch.amin(torch.where(tm <= bt[:, None], tri_iota, TB), dim=1)
    for m in range(SB):
        better = need[m] & (bt[m] < best_t) & (bt[m] < INF)
        best_t = torch.where(better, bt[m], best_t)
        best_row = torch.where(better, bi[m] + (s * SB + m) * TB, best_row)
    return best_t, best_row


def _walk_hbm(scene, o, d, inv, active, o_mag, best_t, best_row, stats):
    """The HBM-mode walk (module docstring). ``stats`` gains the slab
    tests at each level (``group_tests``, ``super_tests``,
    ``member_tests``) and ``block_tests``, the (segment, block) pairs
    that passed the refinement."""
    saabb, sgaabb = scene.saabb, scene.sgaabb
    ns, ng = saabb.shape[0], sgaabb.shape[0]
    g_adm = slab_test(o, inv, active, sgaabb)[0]               # [ng, R]
    in_group = g_adm.repeat_interleave(SB, dim=0)[:ns]         # [ns, R]
    s_adm = slab_test(o, inv, active, saabb)[0] & in_group
    _count(stats, "group_tests", active.sum() * ng)
    _count(stats, "super_tests", in_group.sum())
    _count(stats, "member_tests", s_adm.sum() * SB)
    # The admitting lanes of every super, super by super (one host sync):
    pairs = torch.nonzero(s_adm)
    counts = torch.bincount(pairs[:, 0], minlength=ns).tolist()
    ends = np.cumsum(counts)
    for s in np.flatnonzero(counts):
        for c0 in range(ends[s] - counts[s], ends[s], _LANE_CHUNK):
            lanes = pairs[c0:min(c0 + _LANE_CHUNK, ends[s]), 1]
            sel = lambda v: tuple(c[lanes] for c in v)
            bt, br = _walk_super(scene.p, scene.baabb, int(s), sel(o), sel(d),
                                 sel(inv), o_mag[lanes], best_t[lanes],
                                 best_row[lanes], stats)
            best_t = best_t.index_put((lanes,), bt)
            best_row = best_row.index_put((lanes,), br)
    return best_t, best_row


def _valid_paths(slot: torch.Tensor, n_valid: int, R: int, J: int, j0: int,
                 spp: int) -> torch.Tensor:
    """Per-slot path budget: slot s serves padded-stream pixels
    s + (j0 + j)*R, j < J; pixels >= n_valid are padding."""
    q = torch.div(slot - n_valid, R, rounding_mode="floor")
    return torch.clamp(-q - j0, 0, J) * spp


def _accumulate_plain(scene, rows, cols, seed: int, n_valid: int, j0: int, *,
                      R: int, J: int, spp: int, K_tot: int, max_iters: int,
                      slot0: int,
                      cam: CameraConsts, max_path_length: int,
                      roulette_start_depth: int, record: bool = False,
                      hbm: bool = False, stats: dict | None = None):
    """Plain-torch twin of the kernel: returns (accum [J, 3, R] f32, or
    with ``record`` the path records [10, J*spp, R] f32; done [R] i64).
    ``hbm`` picks the HBM-mode walk and payload. Temporaries stay [128, R]
    per triangle block (VMEM mode) or [1024, 8192] per super (HBM mode).
    ``stats`` (a dict) gains ``segments`` (ray segments traced) and the
    walk's counts (``_walk_vmem``, ``_walk_hbm``)."""
    dev = rows.device
    f32 = torch.float32
    K = J * spp
    slot = torch.arange(R, device=dev, dtype=torch.int64)
    k_cap = _valid_paths(slot, n_valid, R, J, j0, spp)
    rows2, cols2 = rows.reshape(J, R), cols.reshape(J, R)
    pid_base = (slot + slot0) * K_tot + j0 * spp
    p, nrm, ap, apay = scene.p, scene.nrm, scene.ap, scene.apay
    walk = _walk_hbm if hbm else _walk_vmem
    if stats is not None:
        for key in ("segments", "block_tests") + (
                ("group_tests", "super_tests", "member_tests") if hbm else ()):
            stats.setdefault(key, 0)

    def camera(k):
        j = torch.clamp(k // spp, max=J - 1)[None]
        g1, g2 = normal2(pid_base + k, seed, 0xCA3)
        return camera_ray(rows2.gather(0, j)[0], cols2.gather(0, j)[0],
                          g1, g2, cam)

    accum = torch.zeros(J * 3 * R, dtype=f32, device=dev)
    rec = (torch.empty((REC_FIELDS, K, R), dtype=f32, device=dev)
           if record else None)
    done = torch.zeros(R, dtype=torch.int64, device=dev)
    k = torch.zeros(R, dtype=torch.int64, device=dev)
    bounce = torch.zeros_like(k)
    active = k_cap > 0
    o, d = camera(k)
    tp = (torch.ones(R, dtype=f32, device=dev),) * 3
    color = (torch.zeros(R, dtype=f32, device=dev),) * 3
    zero = torch.zeros(R, dtype=f32, device=dev)

    it = 0
    while it < max_iters and bool(active.any()):
        it += 1
        o_mag = torch.maximum(torch.maximum(torch.abs(o[0]), torch.abs(o[1])),
                              torch.abs(o[2]))
        pid = pid_base + k

        # ---- triangle walk ----
        best_t = torch.where(active, INF, -1.0)
        best_row = torch.full((R,), -1, dtype=torch.int64, device=dev)
        _count(stats, "segments", active.sum())
        best_t, best_row = walk(scene, o, d, slab_inv(d), active, o_mag,
                                best_t, best_row, stats)

        # ---- payload of the winning triangle (bf16 barycentrics in VMEM
        # mode, f32 in HBM mode) ----
        has = best_row >= 0
        row = torch.clamp_min(best_row, 0)
        b1, b2 = barycentrics(p[row, 0:12], o, d)
        if not hbm:
            b1 = b1.to(torch.bfloat16).to(f32)
            b2 = b2.to(torch.bfloat16).to(f32)
        c0 = (row // TB) * (3 * TB) + row % TB
        seg0, seg1, seg2 = nrm[:, c0], nrm[:, c0 + TB], nrm[:, c0 + 2 * TB]
        nxyz = tuple(seg0[c] + (seg1[c] * b1 + seg2[c] * b2)
                     for c in range(3))
        pick = lambda v: torch.where(has, v, 0.0)
        normal = normalize3(tuple(pick(v) for v in nxyz))
        albedo = (pick(seg0[3]), pick(seg0[4]), pick(seg0[5]))
        tpacked = torch.round(pick(seg1[3])).to(torch.int64)
        ior = pick(seg1[4])
        emission = (pick(seg1[5]), pick(seg1[6]), pick(seg1[7]))

        # ---- spheres and discs: override only when strictly nearer ----
        bt_ap, bi_ap = analytic_hit(ap, o, d, best_t)
        pay = apay[:, bi_ap]                              # [16, R]
        apb = bt_ap < best_t
        best_t = torch.where(apb, bt_ap, best_t)
        albedo = where3(apb, (pay[0], pay[1], pay[2]), albedo)
        ior = torch.where(apb, pay[3], ior)
        tpacked = torch.where(apb, torch.round(pay[4]).to(torch.int64),
                              tpacked)
        emission = where3(apb, (pay[5], pay[6], pay[7]), emission)
        hit_ap = add3(o, scale3(d, best_t))
        n_sph = normalize3(add3(hit_ap, scale3((pay[8], pay[9], pay[10]),
                                               -1.0)))
        n_ap = where3(pay[14] > 1.5, (pay[11], pay[12], pay[13]), n_sph)
        normal = where3(apb, n_ap, normal)

        # ---- shading ----
        found = (best_t < 1e37) & (best_t > 0.0)
        live = active & found
        em_on = live & (tpacked >= 4)
        color = add3(color, where3(em_on, (tp[0] * emission[0],
                                           tp[1] * emission[1],
                                           tp[2] * emission[2]),
                                   (zero,) * 3))
        rng_b = bounce + 7 + seed
        u0, u1, u2, u3 = (uniform01(pid, rng_b, c) for c in range(4))
        hit_p = add3(o, scale3(d, best_t))
        d_diff = bxdf.sample_diffuse(normal, u0, u1)
        d_spec = bxdf.reflect(d, normal)
        d_diel, refracted = bxdf.dielectric(d, normal, ior, u2)
        mtype = tpacked & 3
        is_diff, is_spec = mtype == 0, mtype == 1
        new_d = where3(is_diff, d_diff, where3(is_spec, d_spec, d_diel))
        stp = live & (is_diff | is_spec | ((mtype == 2) & refracted))
        tp = where3(stp, (tp[0] * albedo[0], tp[1] * albedo[1],
                          tp[2] * albedo[2]), tp)
        o = where3(live, bxdf.offset_origin(hit_p, normal, new_d), o)
        d = where3(live, new_d, d)

        # ---- russian roulette ----
        p_r = torch.maximum(torch.maximum(tp[0], tp[1]), tp[2])
        stop_r = (p_r == 0.0) | (u3 > p_r)
        safe_p = torch.where(p_r == 0.0, 1.0, p_r)
        use_roulette = bounce > roulette_start_depth
        tp = where3(use_roulette & live & ~stop_r,
                    (tp[0] / safe_p, tp[1] / safe_p, tp[2] / safe_p), tp)
        killed = live & use_roulette & stop_r
        escaped = active & ~found
        bounce = bounce + 1
        over = live & (bounce >= max_path_length)
        term = escaped | killed | over

        # ---- bank (or record) finished paths ----
        if bool(term.any()):
            ts = slot[term]
            if record:
                fields = torch.stack([*color, *tp, escaped.to(f32), *d])
                rec[:, k[term], ts] = fields[:, term]
            else:
                base = (k[term] // spp) * (3 * R) + ts
                for c in range(3):
                    accum[base + c * R] += color[c][term]
        done += term.to(torch.int64)
        k = torch.where(term, torch.clamp(k + 1, max=K), k)
        active = active & ~term
        bounce = torch.where(term, 0, bounce)
        color = where3(term, (zero,) * 3, color)

        # ---- regenerate idle slots ----
        spawn = ~active & (k < k_cap)
        co, cd = camera(k)
        o = where3(spawn, co, o)
        d = where3(spawn, cd, d)
        tp = where3(spawn, (torch.ones_like(zero),) * 3, tp)
        active = active | spawn
    if stats is not None:
        stats.update({key: int(v) for key, v in stats.items()})
    return (rec if record else accum.reshape(J, 3, R)), done


def _accumulate_cuda(scene, rows, cols, seed: int, n_valid: int, j0: int, *,
                     R: int, J: int, spp: int, K_tot: int, max_iters: int,
                     slot0: int,
                     cam: CameraConsts, max_path_length: int,
                     roulette_start_depth: int, record: bool = False,
                     hbm: bool = False, counters=None):
    """Launch the CUDA kernel (K1, or K3 with ``hbm``); returns (accum
    [J, 3, R] f32, or with ``record`` the records [10, J*spp, R] f32;
    done [R] i32). ``counters`` (a counting launch of K3,
    ``cuda.build.COUNTERS``) is for the measurements of chip_smoke.py,
    which calls this function itself."""
    global launches, hbm_launches
    from .cuda.build import launch_megakernel

    dev = rows.device
    out = (torch.empty((REC_FIELDS, J * spp, R), dtype=torch.float32,
                       device=dev) if record
           else torch.zeros((J, 3, R), dtype=torch.float32, device=dev))
    done = torch.zeros(R, dtype=torch.int32, device=dev)
    launch_megakernel(
        scene, rows, cols, out, done, seed=seed, n_valid=n_valid, j0=j0,
        slot0=slot0, R=R, J=J, spp=spp, K_tot=K_tot, max_iters=max_iters,
        cam=cam, max_path_length=max_path_length,
        roulette_start_depth=roulette_start_depth, record=record, hbm=hbm,
        counters=counters)
    if hbm:
        hbm_launches += 1
    else:
        launches += 1
    return out, done


def bank_ref(rec: torch.Tensor, done: torch.Tensor, spp: int) -> torch.Tensor:
    """Plain version of the bank kernel: records [10, K, R] and done [R]
    -> accum [J, 3, R], J = K / spp. A slot adds its done[s] records in k
    order: colour, plus throughput * env (fields 7-9 hold the env RGB
    after :func:`shade_records`) when the path escaped."""
    _, K, R = rec.shape
    accum = torch.zeros((K // spp, 3, R), dtype=torch.float32,
                        device=rec.device)
    n_max = int(done.max()) if done.numel() else 0
    for k in range(n_max):
        live = torch.nonzero(done > k).squeeze(1)
        r = rec[:, k, live]
        c = torch.where(r[6] != 0.0, r[0:3] + r[3:6] * r[7:10], r[0:3])
        accum[k // spp][:, live] += c
    return accum


def bank(rec: torch.Tensor, done: torch.Tensor, spp: int) -> torch.Tensor:
    """Bank path records (the kernel for CUDA tensors, else
    :func:`bank_ref`)."""
    global bank_launches
    if rec.device.type == "cpu":
        return bank_ref(rec, done, spp)
    from .cuda.build import launch_bank

    _, K, R = rec.shape
    accum = torch.zeros((K // spp, 3, R), dtype=torch.float32,
                        device=rec.device)
    launch_bank(rec, done, accum, spp=spp)
    bank_launches += 1
    return accum


def real_records(rec: torch.Tensor, done: torch.Tensor) -> torch.Tensor:
    """[K, R] mask of the records that are real (k < done)."""
    k = torch.arange(rec.shape[1], device=rec.device)[:, None]
    return k < done.to(rec.device)[None, :]


def escaped_records(rec: torch.Tensor, done: torch.Tensor) -> torch.Tensor:
    """[K, R] mask of the records that are real (k < done) and escaped."""
    return (rec[6] != 0.0) & real_records(rec, done)


def escaped_pixels(rec: torch.Tensor, done: torch.Tensor,
                   spp: int) -> torch.Tensor:
    """[R*J] mask, in the order of the path trace's ``flat`` rows
    (j*R + s), of the pixels one of whose paths escaped: the only pixels
    the env term reaches."""
    K, R = rec.shape[1:]
    esc = escaped_records(rec, done).reshape(K // spp, spp, R)
    return esc.any(dim=1).reshape(-1)


def shade_records(rec: torch.Tensor, done: torch.Tensor, env, mlp) -> int:
    """Replace the direction fields (7-9) of the escaped records by
    ``mlp(directions, env)``, the env RGB; in place. Returns the number
    of escaped paths."""
    esc = escaped_records(rec, done)
    dirs = rec[7:10][:, esc].t().contiguous()
    if dirs.shape[0]:
        rec[7:10][:, esc] = mlp(dirs, env).t()
    return int(dirs.shape[0])


def _trace(accumulate, scene, rows, cols, seed, n_valid, *, params, slots,
           j_per_slot, spp, max_iters, j0=0, k_total=None, slot0=0,
           record=False, **extra):
    R, J = int(slots), int(j_per_slot)
    if rows.shape != (R * J,) or cols.shape != (R * J,):
        raise ValueError(f"rows/cols must be [{R * J}], got "
                         f"{tuple(rows.shape)}, {tuple(cols.shape)}")
    if rows.device != scene.device or cols.device != scene.device:
        raise ValueError("rows, cols and the scene must share a device")
    K_tot = J * spp if k_total is None else int(k_total)
    return accumulate(
        scene, rows.to(torch.float32).contiguous(),
        cols.to(torch.float32).contiguous(), int(seed) & _MASK, int(n_valid),
        int(j0), R=R, J=J, spp=int(spp), K_tot=K_tot, slot0=int(slot0),
        max_iters=int(max_iters), cam=camera_consts(params),
        max_path_length=int(params.max_path_length),
        roulette_start_depth=int(params.roulette_start_depth),
        record=record, hbm=params.intersector == "pallas-hbm", **extra)


def _accumulator(scene):
    dev = scene.device.type
    if dev == "cuda":
        return _accumulate_cuda
    if dev == "cpu":
        return _accumulate_plain
    raise ValueError(f"unsupported device {scene.device}")


def trace_records(scene, rows, cols, seed, n_valid, *, params, slots,
                  j_per_slot, spp, max_iters, j0=0, k_total=None, slot0=0):
    """The path trace in record mode alone (the kernel for CUDA tensors,
    else the plain version): returns (rec [10, J*spp, R] f32, done [R]),
    the records :func:`shade_records` and :func:`bank` take."""
    return _trace(_accumulator(scene), scene, rows, cols, seed, n_valid,
                  params=params, slots=slots, j_per_slot=j_per_slot, spp=spp,
                  max_iters=max_iters, j0=j0, k_total=k_total, slot0=slot0,
                  record=True)


def _path_trace(accumulate, mlp, bank_fn, scene, rows, cols, seed, n_valid,
                *, params, slots, j_per_slot, spp, max_iters, j0=0,
                k_total=None, slot0=0, env=None, **extra):
    R, J = int(slots), int(j_per_slot)
    if env is not None and env.device != scene.device:
        raise ValueError(f"env on {env.device}, scene on {scene.device}")
    out, done = _trace(accumulate, scene, rows, cols, seed, n_valid,
                       params=params, slots=R, j_per_slot=J, spp=spp,
                       max_iters=max_iters, j0=j0, k_total=k_total,
                       slot0=slot0, record=env is not None, **extra)
    return image(out, done, spp, env, mlp, bank_fn), done.sum(dtype=torch.int64)


def image(out, done, spp, env=None, mlp=env_mlp, bank_fn=bank):
    """One dispatch's image: ``out`` the accumulator [J, 3, R], or with
    ``env`` the records [10, J*spp, R], whose escaped directions are
    shaded by ``mlp`` (in place) and banked by ``bank_fn``. Returns
    per-pixel [R*J, 3] (padded-stream pixel s + j*R at row j*R + s),
    averaged over spp."""
    if env is None:
        accum = out
    else:
        with span("streaming.env"):
            shade_records(out, done, env, mlp)
            accum = bank_fn(out, done, int(spp))
    J, _, R = accum.shape
    return (accum.permute(0, 2, 1).reshape(R * J, 3)
            * float(np.float32(1.0 / spp)))


def megakernel_path_trace_ref(scene, rows, cols, seed, n_valid, *, params,
                              slots, j_per_slot, spp, max_iters, j0=0,
                              k_total=None, slot0=0, env=None, stats=None):
    """Plain-torch version of :func:`megakernel_path_trace` (same
    arguments, same result) on any device: the plain path trace, and
    with ``env`` the plain env MLP and bank. ``stats`` (a dict) gains the
    walk counts of ``_accumulate_plain``."""
    return _path_trace(_accumulate_plain, env_mlp_ref, bank_ref, scene, rows,
                       cols, seed, n_valid, params=params, slots=slots,
                       j_per_slot=j_per_slot, spp=spp, max_iters=max_iters,
                       j0=j0, k_total=k_total, slot0=slot0, env=env,
                       stats=stats)


def megakernel_path_trace(scene, rows, cols, seed, n_valid, *, params,
                          slots, j_per_slot, spp, max_iters, j0=0,
                          k_total=None, slot0=0, env=None):
    """Path-trace ``slots * j_per_slot`` padded-stream pixels at ``spp``.

    rows/cols: [slots*j_per_slot] f32 pixel coordinates of the stream;
    seed: u32 batch seed; n_valid: real pixel count of the stream;
    j0/k_total: this dispatch serves stream rows [j0, j0+J) of a
    k_total-paths-per-slot schedule (defaults: one dispatch); slot0:
    these slots are slots [slot0, slot0+slots) of that schedule's pool
    (their pids; default 0), so a replay of a pool's slots from the
    middle reproduces them; env: a
    :class:`~ipu_ray_lib_tpu_torch.nif.model.NifEnv` on the scene's
    device lights escaped paths (None: they add nothing).
    Returns (flat [R*J, 3] f32 spp-averaged radiance, done i64 scalar
    tensor: the number of finished paths).

    CUDA tensors run the CUDA kernels (built at first use; a failed build
    or launch raises). CPU tensors run the plain versions."""
    return _path_trace(_accumulator(scene), env_mlp, bank, scene, rows, cols,
                       seed, n_valid, params=params, slots=slots,
                       j_per_slot=j_per_slot, spp=spp, max_iters=max_iters,
                       j0=j0, k_total=k_total, slot0=slot0, env=env)
