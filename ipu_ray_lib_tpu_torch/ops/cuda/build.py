"""Build and load the hand-written CUDA kernels (nvcc + ctypes).

``megakernel.cu`` has a plain C entry point, so it is compiled by ``nvcc``
straight into a shared library (no PyTorch headers: seconds, not minutes)
and called through ctypes with tensor ``data_ptr()``s and the current
PyTorch stream. The build runs at first use into
``ipu_ray_lib_tpu_torch/_build/``, keyed on a hash of the sources and
flags, from the sources in the repository only. A failed build or launch
raises; nothing falls back to the plain version.

Flags: ``sm_90a`` (Hopper), ``-O3``, ``-fmad=false`` (no FMA contraction,
so every product rounds as in the plain torch version), IEEE division and
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

import torch

_HERE = os.path.dirname(os.path.abspath(__file__))
_SOURCES = ("megakernel.cu",)
BUILD_DIR = os.path.join(_HERE, "..", "..", "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_lock = threading.Lock()
_lib = None
# What the last build reported: seconds, ptxas resource usage, cache hit.
build_info: dict = {}


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
    for s in srcs:
        with open(s, "rb") as f:
            h.update(f.read())
    so = os.path.join(BUILD_DIR, f"megakernel_{h.hexdigest()[:16]}.so")
    if os.path.exists(so):
        build_info.update(seconds=0.0, cached=True, log="")
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, so)
    build_info.update(seconds=time.perf_counter() - t0, cached=False,
                      log=(proc.stdout + proc.stderr).strip())
    return so


def load() -> ctypes.CDLL:
    """The kernel library, built at first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(_compile())
            fn = lib.megakernel_launch
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 9
                           + [ctypes.c_uint, ctypes.c_int, ctypes.c_int]
                           + [ctypes.c_float] * 5 + [ctypes.c_void_p])
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


def launch_megakernel(scene, rows, cols, accum, done, *, seed: int,
                      n_valid: int, j0: int, R: int, J: int, spp: int,
                      K_tot: int, max_iters: int, cam, max_path_length: int,
                      roulette_start_depth: int) -> None:
    """Launch the megakernel on the current stream (asynchronous).
    ``accum`` [J, 3, R] f32 must be zeroed; ``done`` [R] i32 is written."""
    f32 = torch.float32
    nb = scene.baabb.shape[0]
    n_ap = scene.ap.shape[0]
    _check("p", scene.p, f32, (nb * 128, 16))
    _check("nrm", scene.nrm, f32, (8, nb * 3 * 128))
    _check("baabb", scene.baabb, f32, (nb, 8))
    _check("ap", scene.ap, f32, (n_ap, 16))
    _check("apay", scene.apay, f32, (16, n_ap))
    _check("rows", rows, f32, (J * R,))
    _check("cols", cols, f32, (J * R,))
    _check("accum", accum, f32, (J, 3, R))
    _check("done", done, torch.int32, (R,))
    devs = {t.device for t in (scene.p, scene.nrm, scene.baabb, scene.ap,
                               scene.apay, rows, cols, accum, done)}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {devs}")
    lib = load()
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        err = lib.megakernel_launch(
            scene.p.data_ptr(), scene.nrm.data_ptr(), scene.baabb.data_ptr(),
            scene.ap.data_ptr(), scene.apay.data_ptr(), rows.data_ptr(),
            cols.data_ptr(), accum.data_ptr(), done.data_ptr(),
            R, J, spp, K_tot, nb, n_ap, max_path_length,
            roulette_start_depth, max_iters, seed & 0xFFFFFFFF, n_valid, j0,
            cam.sx, cam.sy, cam.inv_w, cam.inv_h, cam.aa, stream)
    if err != 0:
        raise RuntimeError(f"megakernel launch failed: CUDA error {err}")
