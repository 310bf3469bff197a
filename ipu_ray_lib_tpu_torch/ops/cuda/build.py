"""Build and load the hand-written CUDA kernels (nvcc + ctypes).

Every ``.cu`` source here has a plain C entry point, so each is compiled
by ``nvcc`` into an object (all sources at once, one process each), and
the objects are linked into one shared library (no PyTorch headers:
seconds, not minutes). Its launchers are called through ctypes with
tensor ``data_ptr()``s and the current PyTorch stream, and each returns
``cudaGetLastError()``. The build runs at first use into
``ipu_ray_lib_tpu_torch/_build/``, keyed on a hash of the sources and
flags, from the sources in the repository only. A failed build or launch
raises; nothing falls back to the plain versions. Each nvcc's seconds
are logged (``runtime/config.py:log_compile``: info from 5 s) and kept in
``build_info["sources"]``.

Flags: ``sm_90a`` (Hopper), ``-O3``, ``-fmad=false`` (no FMA contraction,
so every product rounds as in the plain torch versions), IEEE division and
square root (nvcc's defaults; no ``--use_fast_math``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

import numpy as np
import torch

from ...runtime.config import log_compile

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCES = ("megakernel.cu", "env_mlp.cu", "shadow.cu", "intersect.cu",
            "bvh.cu", "dense.cu")
_HEADERS = ("rows.cuh",)  # included by shadow.cu and intersect.cu
BUILD_DIR = os.path.join(_HERE, "..", "..", "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

# The warp walks (K1, K3) test a block with its rows spread over the warp
# when at most this many lanes need it, else each needing lane over all of
# its rows. K3's: a row test costs ~55 instruction slots and spreading one
# lane's rows ~130 more (its ray's 7 shuffles, 2 reductions, the loop),
# so over a 64-row stage spreading pays below 14.7 lanes; the overhead was
# chosen on the card among 20 to 300 by the grid-512 1440^2 spp 64 frame.
# K1's (128 rows through L1): swept from 8 to 32 on an H100 by the Cornell
# 1440^2 spp 64 frame; 16 and 20 ran fastest, 32 (always spread) 1.8x slower.
K3_SPREAD = 14
K1_SPREAD = 20
# K5's and K4's culled walks split a block's 128 rows into this many
# chunks of consecutive rows; a warp item is 32 listed lanes against one.
# Chosen on an H100 by the path-B frame (K5: 4 / 8 / 16 / 32) and the
# Cornell + monkey 1440^2 shadow frame (K4: 4 / 8 / 16).
K5_SPREAD = 16
K4_SPREAD = 4
# Chunks (2 supers) of each bundle's list a wave of K6 tests (its scratch:
# [bundles, WAVE_CHUNKS, 1024] t and row). On the path-A frame 64 ran as
# fast as one wave of whole lists, with 4% fewer blocks tested past the
# stops; 16 and 32 ran 17% and 10% slower (H100).
WAVE_CHUNKS = 64

# The counters of a counting launch (K1, K3), in megakernel.cu's order:
COUNTERS = ("cyc_group", "cyc_slab", "cyc_rows", "cyc_other", "segments",
            "group_tests", "super_tests", "member_tests", "lane_blocks",
            "warp_walks", "warp_lanes", "union_blocks", "spread_blocks")

# The counters of a counting launch of K4 and K5, in rows.cuh's order:
K45_COUNTERS = ("cyc_stage", "cyc_rows", "cyc_flags", "cyc_prims",
                "cyc_epilogue", "cyc_cull", "lane_pairs", "occ_lane_pairs",
                "bundle_blocks", "occ_blocks", "max_bundle_blocks",
                "cta_blocks", "work_items", "work_rounds", "live_lanes")

_lock = threading.Lock()
_lib = None
# What the last build reported: seconds, ptxas resource usage, cache hit.
build_info: dict = {}

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
_SIGNATURES = {
    "megakernel_launch": [_P] * 12 + [_I] * 11 + [_U] + [_I] * 4 + [_P]
                         + [_I] + [_F] * 5 + [_P],
    "bank_launch": [_P] * 3 + [_I] * 3 + [_P],
    "env_mlp_launch": [_P, _P, _I, _P, _I, _P, _P, _P, _P] + [_I] * 6
                      + [_P, _P],
    "env_mlp_smem_bytes": [_I, _I],
    "shadow_launch": [_P] * 13 + [_I] * 5 + [_F] * 3 + [_P],
    "shadow_smem_bytes": [_I],
    "intersect_launch": [_P] * 18 + [_I] * 8 + [_P],
    "bvh_launch": [_P] * 16 + [_I] * 9 + [_P],
    "dense_launch": [_P] * 7 + [_I] * 2 + [_P],
}
# The counters of a counting launch of K7: node visits, leaf tests.
BVH_COUNTERS = ("node_visits", "leaf_tests")


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"),
                 shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set NVCC or CUDA_HOME)")


def _compile() -> str:
    srcs = [os.path.join(_HERE, s) for s in _SOURCES]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in srcs + [os.path.join(_HERE, x) for x in _HEADERS]:
        with open(s, "rb") as f:
            h.update(f.read())
    key = h.hexdigest()[:16]
    so = os.path.join(BUILD_DIR, f"kernels_{key}.so")
    if os.path.exists(so):
        build_info.update(seconds=0.0, cached=True, log="", sources={})
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    tag = f"{key}.{os.getpid()}"
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in srcs:  # one nvcc per source, all started together
        obj = os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    # Each nvcc's output is drained by a thread of its own, which also
    # notes the second at which that nvcc finished:
    done = [None] * len(procs)

    def drain(i):
        out, err = procs[i].communicate()
        done[i] = (out, err, time.perf_counter() - t0)

    threads = [threading.Thread(target=drain, args=(i,))
               for i in range(len(procs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    logs, failed, seconds = [], [], {}
    for src, proc, (out, err, sec) in zip(srcs, procs, done):
        name = os.path.basename(src)
        seconds[name] = sec
        log_compile(f"nvcc {name}", sec)
        logs.append(f"[{name}]\n{out}{err}".strip())
        if proc.returncode != 0:
            failed.append(f"nvcc {name} failed "
                          f"({proc.returncode}):\n{out}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                           "-shared", "-o", tmp, *objs],
                          capture_output=True, text=True)
    for obj in objs:
        os.remove(obj)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc link failed ({proc.returncode}):\n{proc.stdout}\n"
            f"{proc.stderr}")
    os.replace(tmp, so)
    build_info.update(seconds=time.perf_counter() - t0, cached=False,
                      log="\n".join(logs), sources=seconds)
    log_compile("the kernel library (nvcc and link)", build_info["seconds"])
    return so


def load() -> ctypes.CDLL:
    """The kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_compile())
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = ctypes.c_int
                fn.argtypes = argtypes
            _lib = lib
        return _lib


def _check(name: str, t: torch.Tensor, dtype, shape=None):
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")


def _check_pbox(scene, kernel: str) -> None:
    """The padded boxes of K4's and K5's cull, which only a VMEM-mode scene
    carries (scene/build.py)."""
    if scene.pbox is None:
        raise ValueError(f"{kernel} walks VMEM-mode scenes: this scene has no "
                         "padded boxes (build it with intersector='pallas')")
    _check("pbox", scene.pbox, torch.float32, (scene.baabb.shape[0], 8))


def _same_device(*ts: torch.Tensor) -> None:
    devs = {t.device for t in ts}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {err}")


def launch_megakernel(scene, rows, cols, out, done, *, seed: int,
                      n_valid: int, j0: int, slot0: int, R: int, J: int,
                      spp: int,
                      K_tot: int, max_iters: int, cam, max_path_length: int,
                      roulette_start_depth: int, record: bool = False,
                      hbm: bool = False, counters=None) -> None:
    """Launch the megakernel on the current stream (asynchronous): K1's
    VMEM-mode walk, or K3's HBM-mode warp walk with ``hbm``. ``out`` is
    the accumulator [J, 3, R] f32, zeroed, or with ``record`` the path
    records [10, J*spp, R] f32 (record mode); ``done`` [R] i32 is written.
    ``counters`` ([COUNTERS] int64, zeroed) makes it a counting launch,
    which adds the walk's counters to it."""
    f32 = torch.float32
    nb = scene.baabb.shape[0]
    ns, ng = -(-nb // 8), -(-nb // 64)
    n_ap = scene.ap.shape[0]
    _check("p", scene.p, f32, (nb * 128, 16))
    _check("nrm", scene.nrm, f32, (8, nb * 3 * 128))
    _check("baabb", scene.baabb, f32, (nb, 8))
    _check("saabb", scene.saabb, f32, (ns, 8))
    _check("sgaabb", scene.sgaabb, f32, (ng, 8))
    if nb % 8:
        raise ValueError(f"{nb} blocks are not whole supers of 8")
    _check("ap", scene.ap, f32, (n_ap, 16))
    _check("apay", scene.apay, f32, (16, n_ap))
    _check("rows", rows, f32, (J * R,))
    _check("cols", cols, f32, (J * R,))
    if record:
        _check("rec", out, f32, (10, J * spp, R))
    else:
        _check("accum", out, f32, (J, 3, R))
    _check("done", done, torch.int32, (R,))
    _same_device(scene.p, scene.nrm, scene.baabb, scene.saabb, scene.sgaabb,
                 scene.ap, scene.apay, rows, cols, out, done)
    if counters is not None:
        _check("counters", counters, torch.int64, (len(COUNTERS),))
        _same_device(rows, counters)
    lib = load()
    with torch.cuda.device(rows.device):
        err = lib.megakernel_launch(
            scene.p.data_ptr(), scene.nrm.data_ptr(), scene.baabb.data_ptr(),
            scene.saabb.data_ptr(), scene.sgaabb.data_ptr(),
            scene.ap.data_ptr(), scene.apay.data_ptr(), rows.data_ptr(),
            cols.data_ptr(), None if record else out.data_ptr(),
            out.data_ptr() if record else None, done.data_ptr(),
            R, J, spp, K_tot, nb, ns, ng, n_ap, max_path_length,
            roulette_start_depth, max_iters, seed & 0xFFFFFFFF, n_valid, j0,
            slot0, int(hbm),
            None if counters is None else counters.data_ptr(),
            K3_SPREAD if hbm else K1_SPREAD,
            cam.sx, cam.sy, cam.inv_w, cam.inv_h, cam.aa,
            _stream(rows.device))
    _raise_on(err, "megakernel")


def launch_bank(rec, done, accum, *, spp: int) -> None:
    """Bank path records: ``rec`` [10, K, R] f32, ``done`` [R] i32,
    ``accum`` [J, 3, R] f32 zeroed, J = K / spp."""
    _, K, R = rec.shape
    _check("rec", rec, torch.float32, (10, K, R))
    _check("done", done, torch.int32, (R,))
    _check("accum", accum, torch.float32, (K // spp, 3, R))
    if K % spp:
        raise ValueError(f"records of {K} paths per slot are not J*{spp}")
    _same_device(rec, done, accum)
    lib = load()
    with torch.cuda.device(rec.device):
        err = lib.bank_launch(rec.data_ptr(), done.data_ptr(),
                              accum.data_ptr(), R, K, spp,
                              _stream(rec.device))
    _raise_on(err, "bank")


def launch_env_mlp(dirs, out, env, packed, exact_uv: bool = False) -> None:
    """Env MLP of ``dirs`` [N, 3] f32 into ``out`` [N, 3] f32 (RGB): the
    f32 biases and constants of a
    :class:`~ipu_ray_lib_tpu_torch.nif.model.NifEnv`, its weights as
    ``packed`` by :func:`~ipu_ray_lib_tpu_torch.ops.env.pack_mma`;
    ``exact_uv``: the equirect angles from the double-precision arccos and
    atan2 (ops/env.py ``env_mlp``)."""
    n = dirs.shape[0]
    L = env.num_layers
    wq, stages, layers = packed["wq"], packed["stages"], packed["layers"]
    host = np.ascontiguousarray(packed["stages_host"], np.int32)
    _check("dirs", dirs, torch.float32, (n, 3))
    _check("out", out, torch.float32, (n, 3))
    _check("wq", wq, torch.int32)
    _check("b", env.b, torch.float32)
    _check("layers", layers, torch.int32, (L, 8))
    _check("stages", stages, torch.int32, host.shape)
    _check("econst", env.econst, torch.float32, (5,))
    _same_device(dirs, out, wq, env.b, layers, stages, env.econst)
    lib = load()
    E, ldx = env.config.embedding_dimension, packed["ldx"]
    smem = lib.env_mlp_smem_bytes(ldx, E)
    if smem > 232448:
        raise ValueError(f"env MLP with activation rows of {ldx} needs "
                         f"{smem} bytes of shared memory per block (227 KB "
                         "available)")
    with torch.cuda.device(dirs.device):
        err = lib.env_mlp_launch(
            dirs.data_ptr(), out.data_ptr(), n, wq.data_ptr(), wq.numel() // 4,
            env.b.data_ptr(), layers.data_ptr(), stages.data_ptr(),
            host.ctypes.data, host.shape[0], L, E, ldx,
            int(env.config.log_tone_map), int(exact_uv),
            env.econst.data_ptr(), _stream(dirs.device))
    _raise_on(err, "env_mlp")


def launch_shadow(scene, counts, order, dists, rays, out_f, out_i, *,
                  light, pairs=None, counters=None) -> None:
    """Launch the fused shadow kernel (K4) on the current stream: each
    bundle a cluster of 4 CTAs of 256 threads. ``counts`` [nrb] i32,
    ``order`` [nrb, nb] i32 and ``dists`` [nrb, nb] f32 from the bundle
    cull, ``rays`` [8, nrb*1024] f32; ``out_f`` [4, nrb*1024] f32 and
    ``out_i`` [4, nrb*1024] i32 are written; ``light`` three f32 values.
    ``pairs`` ([4, nrb] i32, zeroed) gains per bundle the blocks of its
    primary walk and of its occlusion union and the (lane, block) pairs
    each walk's lanes tested; ``counters`` ([K45_COUNTERS] int64, zeroed)
    makes it a counting launch. The scene must carry its padded boxes
    (``pbox``: a VMEM-mode scene)."""
    f32, i32 = torch.float32, torch.int32
    nb = scene.baabb.shape[0]
    nrb = counts.shape[0]
    Rp = nrb * 1024
    n_ap = scene.ap.shape[0]
    n_sph, n_dsc = scene.n_spheres, scene.n_discs
    _check("p", scene.p, f32, (nb * 128, 16))
    _check("nrm", scene.nrm, f32, (8, nb * 3 * 128))
    _check("baabb", scene.baabb, f32, (nb, 8))
    _check_pbox(scene, "K4")
    _check("ap", scene.ap, f32, (n_ap, 16))
    if n_sph + n_dsc > n_ap:
        raise ValueError(f"{n_sph} spheres + {n_dsc} discs exceed {n_ap} ap rows")
    _check("counts", counts, i32, (nrb,))
    _check("order", order, i32, (nrb, nb))
    _check("dists", dists, f32, (nrb, nb))
    _check("rays", rays, f32, (8, Rp))
    _check("out_f", out_f, f32, (4, Rp))
    _check("out_i", out_i, i32, (4, Rp))
    _same_device(scene.p, scene.nrm, scene.baabb, scene.pbox, scene.ap, counts,
                 order, dists, rays, out_f, out_i)
    if pairs is not None:
        _check("pairs", pairs, i32, (4, nrb))
        _same_device(rays, pairs)
    if counters is not None:
        _check("counters", counters, torch.int64, (len(K45_COUNTERS),))
        _same_device(rays, counters)
    lib = load()
    smem = lib.shadow_smem_bytes(nb)
    if smem > 40 * 1024:
        raise ValueError(f"{nb} blocks need {smem} bytes of block flags in "
                         "shared memory; the kernel takes up to 40 KB")
    with torch.cuda.device(rays.device):
        err = lib.shadow_launch(
            scene.p.data_ptr(), scene.nrm.data_ptr(), scene.baabb.data_ptr(),
            scene.ap.data_ptr(), scene.pbox.data_ptr(), counts.data_ptr(),
            order.data_ptr(), dists.data_ptr(), rays.data_ptr(),
            out_f.data_ptr(), out_i.data_ptr(),
            None if pairs is None else pairs.data_ptr(),
            None if counters is None else counters.data_ptr(),
            nrb, nb, n_sph, n_dsc, K4_SPREAD, *light, _stream(rays.device))
    _raise_on(err, "shadow")


def launch_intersect(scene, counts, order, dists, rays, out_t, out_i, out_n,
                     out_m, pairs, spec, lane_pairs, *, hbm: bool,
                     counters=None) -> None:
    """Launch the closest-hit kernel on the current stream: K5 over block
    lists, the culled walk with one CTA of 1,024 threads per bundle (the
    scene must carry its padded boxes, ``pbox``: a VMEM-mode scene), or
    K6 over super lists with ``hbm``, in waves: the chunks (2 supers of a bundle's list) of a wave
    tested at once over the card, then folded in walk order, one block of
    1,024 threads per bundle (intersect.cu). ``counts`` [nrb] i32,
    ``order`` [nrb, nl] i32 and ``dists`` [nrb, nl] f32 from the cull (nl
    blocks, or supers with ``hbm``), ``rays`` [8, nrb*1024] f32;
    ``out_t`` [Rp] f32, ``out_i`` [Rp] i32, ``out_n`` and ``out_m`` [8, Rp]
    f32, ``pairs`` [nrb] i32 (the blocks each bundle's walk walked),
    ``spec`` [nrb] i32 (the blocks tested past its stop; 0 for K5) and
    ``lane_pairs`` [nrb] i32 (the (lane, block) pairs its lanes tested;
    K6 tests 1,024 lanes per block) are written. A wave of
    K6 tests the next WAVE_CHUNKS chunks of every bundle that has not
    stopped; the number of waves follows from the list's width, so
    nothing waits for the device. ``counters`` ([K45_COUNTERS] int64,
    zeroed) makes a K5 launch a counting launch."""
    f32, i32 = torch.float32, torch.int32
    nb = scene.baabb.shape[0]
    nrb = counts.shape[0]
    nl = nb // 8 if hbm else nb
    Rp = nrb * 1024
    if hbm and nb % 8:
        raise ValueError(f"{nb} blocks are not whole supers of 8")
    _check("p", scene.p, f32, (nb * 128, 16))
    _check("nrm", scene.nrm, f32, (8, nb * 3 * 128))
    _check("counts", counts, i32, (nrb,))
    _check("order", order, i32, (nrb, nl))
    _check("dists", dists, f32, (nrb, nl))
    _check("rays", rays, f32, (8, Rp))
    _check("out_t", out_t, f32, (Rp,))
    _check("out_i", out_i, i32, (Rp,))
    _check("out_n", out_n, f32, (8, Rp))
    _check("out_m", out_m, f32, (8, Rp))
    _check("pairs", pairs, i32, (nrb,))
    _check("spec", spec, i32, (nrb,))
    _check("lane_pairs", lane_pairs, i32, (nrb,))
    _same_device(scene.p, scene.nrm, counts, order, dists, rays, out_t, out_i,
                 out_n, out_m, pairs, spec, lane_pairs)
    if not hbm:
        _check_pbox(scene, "K5")
        _same_device(rays, scene.pbox)
    if counters is not None:
        if hbm:
            raise ValueError("K6 has no counting launch")
        _check("counters", counters, torch.int64, (len(K45_COUNTERS),))
        _same_device(rays, counters)
    if nrb < 1:
        raise ValueError("no bundle to walk")
    if hbm and scene.p.data_ptr() % 16:
        raise ValueError("the row table is not 16-byte aligned (bulk copies)")
    dev = rays.device
    part_t = part_i = state = None
    W = n_waves = 0
    if hbm:  # K6's waves: the next WAVE_CHUNKS chunks of 2 supers each
        chunks = -(-nl // 2)
        W = min(WAVE_CHUNKS, chunks)
        n_waves = -(-chunks // W)
        part_t = torch.empty((nrb, W, 1024), dtype=f32, device=dev)
        part_i = torch.empty((nrb, W, 1024), dtype=i32, device=dev)
        state = torch.empty(nrb, dtype=i32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    lib = load()
    with torch.cuda.device(dev):
        err = lib.intersect_launch(
            scene.p.data_ptr(), scene.nrm.data_ptr(), counts.data_ptr(),
            order.data_ptr(), dists.data_ptr(), rays.data_ptr(),
            ptr(None if hbm else scene.pbox), ptr(part_t), ptr(part_i),
            ptr(state),
            out_t.data_ptr(), out_i.data_ptr(), out_n.data_ptr(),
            out_m.data_ptr(), pairs.data_ptr(), spec.data_ptr(),
            lane_pairs.data_ptr(), ptr(counters), nrb, nl, nb,
            int(hbm and scene.payload_split), W, n_waves, int(hbm),
            K5_SPREAD, _stream(dev))
    _raise_on(err, "intersect")


def launch_bvh(scene, origin, direction, t_min, t_max, out_t, out_g, out_p,
               *, any_hit: bool, zero_origin: bool = False,
               counters=None) -> None:
    """Launch the threaded-BVH walk (K7, bvh.cu) on the current stream, one
    thread per ray: ``origin``/``direction`` [R, 3] f32, ``t_min``/``t_max``
    [R] f32; ``out_t`` [R] f32, ``out_g`` and ``out_p`` [R] i32 are written
    (the best t, geometry and primitive id; with ``any_hit`` only
    ``out_g``, 1 where occluded). ``zero_origin``: the rays start at
    (0, 0, 0) and the disc test folds the origin away. ``counters``
    ([BVH_COUNTERS] int64, zeroed) makes it a counting launch."""
    f32, i32 = torch.float32, torch.int32
    R = direction.shape[0]
    nodes = scene.bvh_nodes
    _check("bvh_nodes", nodes, i32, (nodes.shape[0], 8))
    geo = {k: getattr(scene, k) for k in (
        "geom_type", "geom_index", "mesh_first_tri", "tri_v", "verts",
        "spheres", "discs")}
    for k in ("geom_type", "geom_index", "mesh_first_tri", "tri_v"):
        _check(k, geo[k], i32)
    for k in ("verts", "spheres", "discs"):
        _check(k, geo[k], f32)
    _check("tri_v", geo["tri_v"], i32, (geo["tri_v"].shape[0], 3))
    _check("spheres", geo["spheres"], f32, (geo["spheres"].shape[0], 4))
    _check("discs", geo["discs"], f32, (geo["discs"].shape[0], 7))
    _check("origin", origin, f32, (R, 3))
    _check("direction", direction, f32, (R, 3))
    _check("t_min", t_min, f32, (R,))
    _check("t_max", t_max, f32, (R,))
    _check("out_t", out_t, f32, (R,))
    _check("out_g", out_g, i32, (R,))
    _check("out_p", out_p, i32, (R,))
    _same_device(nodes, *geo.values(), origin, direction, t_min, t_max,
                 out_t, out_g, out_p)
    if counters is not None:
        _check("counters", counters, torch.int64, (len(BVH_COUNTERS),))
        _same_device(direction, counters)
    lib = load()
    with torch.cuda.device(direction.device):
        err = lib.bvh_launch(
            nodes.data_ptr(), *(geo[k].data_ptr() for k in (
                "geom_type", "geom_index", "mesh_first_tri", "tri_v", "verts",
                "spheres", "discs")),
            origin.data_ptr(), direction.data_ptr(), t_min.data_ptr(),
            t_max.data_ptr(), out_t.data_ptr(), out_g.data_ptr(),
            out_p.data_ptr(), None if counters is None else counters.data_ptr(),
            R, nodes.shape[0], geo["geom_type"].shape[0],
            geo["mesh_first_tri"].shape[0], geo["tri_v"].shape[0],
            geo["spheres"].shape[0], geo["discs"].shape[0], int(any_hit),
            int(zero_origin), _stream(direction.device))
    _raise_on(err, "bvh")


def launch_dense(rows, origin, direction, t_min, t_max, out_t,
                 out_i) -> None:
    """Launch the dense triangle closest hit (K8, dense.cu) on the current
    stream, one thread per ray: ``rows`` [T, 16] f32 (ops/dense.py
    DENSE_COLS, T a multiple of 512), ``origin``/``direction`` [R, 3],
    ``t_min``/``t_max`` [R]; ``out_t`` [R] f32 (t_max where nothing is
    hit) and ``out_i`` [R] i32 (the row, or -1) are written."""
    f32 = torch.float32
    R, T = direction.shape[0], rows.shape[0]
    _check("dense_rows", rows, f32, (T, 16))
    if T % 512:
        raise ValueError(f"{T} dense rows are not whole blocks of 512")
    _check("origin", origin, f32, (R, 3))
    _check("direction", direction, f32, (R, 3))
    _check("t_min", t_min, f32, (R,))
    _check("t_max", t_max, f32, (R,))
    _check("out_t", out_t, f32, (R,))
    _check("out_i", out_i, torch.int32, (R,))
    _same_device(rows, origin, direction, t_min, t_max, out_t, out_i)
    lib = load()
    with torch.cuda.device(direction.device):
        err = lib.dense_launch(
            rows.data_ptr(), origin.data_ptr(), direction.data_ptr(),
            t_min.data_ptr(), t_max.data_ptr(), out_t.data_ptr(),
            out_i.data_ptr(), R, T, _stream(direction.device))
    _raise_on(err, "dense")
