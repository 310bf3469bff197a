"""ctypes bindings to the native C++ binned-SAH builder.

The native builder (``csrc/bvh_builder.cpp`` at the repository root,
shared with the JAX package) implements the identical algorithm and node
encoding as :func:`.builder.build_bvh_python` but runs orders of
magnitude faster on large scenes. It is compiled at first use with the
system C++ compiler into ``ipu_ray_lib_tpu_torch/_build/``, keyed on a
hash of the source. A missing compiler, a failed build or load, or a
failed native build raises with the cause: nothing falls back to the
Python builder, which differs from this one in the rounding of some
f16 extents (tests/test_torch_bvh_build.py) and is reached only by
calling :func:`.builder.build_bvh_python` directly.

The blocked tables' triangle order is the DFS leaf order of this build,
so the port must use the same builder the JAX package uses (the native
one) for its tables to equal the reference's bit for bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import numpy as np

_lock = threading.Lock()
_lib = None

_SRC = os.path.join(os.path.dirname(__file__), "..", "..", "csrc",
                    "bvh_builder.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "..", "_build")
_CXXFLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]


def _compile() -> str:
    """Build the shared library if needed; return its path."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("no C++ compiler for the native BVH builder "
                           "(set CXX, or install g++)")
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_CXXFLAGS).encode())
    so = os.path.join(_BUILD_DIR, f"native_bvh_{digest.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *_CXXFLAGS, "-o", tmp, _SRC],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native BVH build failed ({cxx}, "
                           f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)
    return so


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_compile())
        fn = lib.bvh_build_compact
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.POINTER(ctypes.c_float),   # prim_lo
            ctypes.POINTER(ctypes.c_float),   # prim_hi
            ctypes.POINTER(ctypes.c_int32),   # geom_ids
            ctypes.POINTER(ctypes.c_int32),   # prim_ids
            ctypes.c_int64,                   # n
            ctypes.c_int32,                   # max_leaf_size
            ctypes.POINTER(ctypes.c_float),   # out mins
            ctypes.POINTER(ctypes.c_uint16),  # out exts (f16 bits)
            ctypes.POINTER(ctypes.c_int32),   # out meta
            ctypes.POINTER(ctypes.c_int32),   # out geom
            ctypes.POINTER(ctypes.c_int32),   # out miss
            ctypes.POINTER(ctypes.c_int32),   # out num nodes
            ctypes.POINTER(ctypes.c_int32),   # out max depth
        ]
        _lib = lib
        return _lib


def build_bvh_native(prim_lo, prim_hi, geom_ids, prim_ids):
    """Native build: a CompactBvh (raises if the library cannot be built
    or the build fails)."""
    from .builder import MAX_LEAF_SIZE, CompactBvh

    lib = _load()
    prim_lo = np.ascontiguousarray(prim_lo, np.float32).reshape(-1, 3)
    prim_hi = np.ascontiguousarray(prim_hi, np.float32).reshape(-1, 3)
    geom_ids = np.ascontiguousarray(geom_ids, np.int32)
    prim_ids = np.ascontiguousarray(prim_ids, np.int32)
    n = len(prim_lo)
    cap = 2 * n  # worst case: n leaves + (n-1) inner
    mins = np.empty((cap, 3), np.float32)
    exts = np.empty((cap, 3), np.uint16)
    meta = np.empty(cap, np.int32)
    geom = np.empty(cap, np.int32)
    miss = np.empty(cap, np.int32)
    num_nodes = ctypes.c_int32(0)
    max_depth = ctypes.c_int32(0)

    def ptr(a, t):
        return a.ctypes.data_as(ctypes.POINTER(t))

    rc = lib.bvh_build_compact(
        ptr(prim_lo, ctypes.c_float), ptr(prim_hi, ctypes.c_float),
        ptr(geom_ids, ctypes.c_int32), ptr(prim_ids, ctypes.c_int32),
        ctypes.c_int64(n), ctypes.c_int32(MAX_LEAF_SIZE),
        ptr(mins, ctypes.c_float), ptr(exts, ctypes.c_uint16),
        ptr(meta, ctypes.c_int32), ptr(geom, ctypes.c_int32),
        ptr(miss, ctypes.c_int32),
        ctypes.byref(num_nodes), ctypes.byref(max_depth),
    )
    if rc == -2:
        raise ValueError("Cannot compress BVH bounds into fp16 (half)")
    if rc == -1:
        raise ValueError("Cannot build a BVH over zero primitives.")
    if rc != 0:
        raise RuntimeError(f"native BVH build failed (code {rc})")
    m = num_nodes.value
    return CompactBvh(
        mins=mins[:m],
        exts=exts[:m].view(np.float16),
        meta=meta[:m],
        geom=geom[:m],
        miss=miss[:m],
        max_depth=max_depth.value,
    )
