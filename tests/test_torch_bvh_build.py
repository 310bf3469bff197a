"""The port's BVH build: the native build always, never a silent fallback.

The blocked tables (kernels K1-K6) take their triangle order from the
BVH's DFS leaf order, so the port must build with the native builder the
JAX package uses. Its numpy twin (``build_bvh_python``) runs the same
algorithm: on seeded random boxes the two give the same leaf order, node
boxes' corners and links; their f16 extents agree within one ulp, and the
cases below state how many differ.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import numpy as np
import pytest

from ipu_ray_lib_tpu_torch.bvh import builder, cbuilder


def _boxes(seed, n):
    rng = np.random.default_rng(seed)
    lo = rng.uniform(-100, 100, (n, 3)).astype(np.float32)
    return lo, lo + rng.uniform(0, 5, (n, 3)).astype(np.float32)


# (seed, boxes): f16 extents that differ by one ulp between the builds.
CASES = {(0, 2000): 0, (0, 3000): 0, (1, 2000): 0, (1, 3000): 1}


@pytest.mark.parametrize("seed,n", list(CASES))
def test_native_and_python_builds_agree(seed, n):
    lo, hi = _boxes(seed, n)
    gids = np.random.default_rng(seed + 1).integers(0, 4, n)
    pids = np.arange(n)
    native = builder.build_bvh(lo, hi, gids, pids)
    py = builder.build_bvh_python(lo, hi, gids, pids)
    assert native.num_nodes == py.num_nodes == 2 * n - 1
    assert native.max_depth == py.max_depth
    for key in ("meta", "geom", "miss", "mins"):
        assert np.array_equal(getattr(native, key), getattr(py, key)), key
    ea = native.exts.view(np.uint16).astype(np.int64)
    eb = py.exts.view(np.uint16).astype(np.int64)
    assert int(np.abs(ea - eb).max()) <= 1
    assert int((ea != eb).sum()) == CASES[(seed, n)]


def test_leaf_order_is_the_native_builds(monkeypatch):
    """build_bvh is the native build itself: the Python builder is never
    called on the way."""
    lo, hi = _boxes(3, 500)
    monkeypatch.setattr(builder, "build_bvh_python",
                        lambda *a: pytest.fail("fell back to Python"))
    got = builder.build_bvh(lo, hi, np.zeros(500, np.int64), np.arange(500))
    want = cbuilder.build_bvh_native(lo, hi, np.zeros(500, np.int64),
                                     np.arange(500))
    assert np.array_equal(got.meta, want.meta)


def test_failed_native_build_raises_with_the_compilers_error(monkeypatch,
                                                             tmp_path):
    bad = tmp_path / "bvh_builder.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(cbuilder, "_lib", None)
    monkeypatch.setattr(cbuilder, "_SRC", str(bad))
    monkeypatch.setattr(cbuilder, "_BUILD_DIR", str(tmp_path / "build"))
    lo, hi = _boxes(4, 10)
    with pytest.raises(RuntimeError, match="native BVH build failed"):
        builder.build_bvh(lo, hi, np.zeros(10, np.int64), np.arange(10))


def test_missing_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(cbuilder, "_lib", None)
    monkeypatch.setattr(cbuilder, "_BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(cbuilder.shutil, "which", lambda name: None)
    lo, hi = _boxes(5, 10)
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        builder.build_bvh(lo, hi, np.zeros(10, np.int64), np.arange(10))


def test_zero_primitives_raise_as_the_python_builder():
    empty = np.zeros((0, 3), np.float32)
    ids = np.zeros(0, np.int64)
    for build in (builder.build_bvh, builder.build_bvh_python):
        with pytest.raises(ValueError, match="zero primitives"):
            build(empty, empty, ids, ids)
