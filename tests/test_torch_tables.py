"""The port's scene tables against the JAX package's, bit for bit.

``build_scene`` in the port must produce exactly the tables the JAX
``build_scene(..., intersector="pallas")`` gives its megakernel: the
triangle rows ``p``, the normal/material table ``nrm``, the block AABBs
and the sphere/disc tables ``ap``/``apay`` (the JAX
``_analytic_tables``). Its host half, ``compile_scene``, also yields the
sub-block AABBs and triangle id maps, which stay on the host.
``from_jax_arrays`` carries a JAX scene across unchanged.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, see conftest)

from ipu_ray_lib_tpu.ops.pallas.megakernel import _analytic_tables
from ipu_ray_lib_tpu.scene.build import build_scene as jax_build_scene
from ipu_ray_lib_tpu.scene.builtin import make_cornell_box_scene as jax_cornell
from ipu_ray_lib_tpu_torch.scene.build import (build_scene, compile_scene,
                                              from_jax_arrays)
from ipu_ray_lib_tpu_torch.scene.builtin import make_cornell_box_scene

MESH = "assets/monkey_bust.glb"
SCENES = {
    "golden": dict(mesh_file=None, box_only=False),
    "monkey": dict(mesh_file=MESH, box_only=False),
    "box_only": dict(mesh_file=None, box_only=True),
}
BLOCKED = ("p", "nrm", "baabb", "baabb32", "tri_geom", "tri_prim")


@pytest.fixture(scope="module", params=sorted(SCENES))
def both(request):
    kw = SCENES[request.param]
    arrays, jparams, _ = jax_build_scene(
        jax_cornell(**kw), image_width=40, image_height=24,
        samples_per_pixel=2, intersector="pallas")
    ts, tparams = build_scene(make_cornell_box_scene(**kw), device="cpu",
                              image_width=40, image_height=24,
                              samples_per_pixel=2)
    leaves, _ = compile_scene(make_cornell_box_scene(**kw), image_width=40,
                              image_height=24, window=None,
                              samples_per_pixel=2)
    return request.param, arrays, jparams, ts, tparams, leaves


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.dtype, a.shape, a.view(np.uint8).tobytes()


@pytest.mark.parametrize("name", BLOCKED)
def test_blocked_table_bitwise(both, name):
    _, arrays, _, ts, _, leaves = both
    want = np.asarray(getattr(arrays.blocked, name))
    assert _bits(leaves[name]) == _bits(want), name
    if hasattr(ts, name):  # uploaded as it is
        assert _bits(getattr(ts, name).numpy()) == _bits(want), name


@pytest.mark.parametrize("name", ["ap", "apay"])
def test_analytic_table_bitwise(both, name):
    _, arrays, _, ts, _, _ = both
    ap, apay, n_ap = _analytic_tables(arrays)
    want = np.asarray(ap if name == "ap" else apay)
    assert ts.n_ap == n_ap
    assert _bits(getattr(ts, name).numpy()) == _bits(want)


def test_scene_params_match(both):
    _, _, jparams, _, tparams, _ = both
    j = dataclasses.asdict(jparams)
    t = dataclasses.asdict(tparams)
    assert j.pop("intersector") == t.pop("intersector") == "pallas"
    assert j == t


def test_from_jax_arrays_round_trip(both):
    _, arrays, _, ts, _, _ = both
    leaves = {k: np.asarray(v) for k, v in arrays._asdict().items()
              if k not in ("dense", "blocked")}
    leaves.update({k: np.asarray(v) for k, v in arrays.blocked._asdict().items()
                   if v is not None})
    carried = from_jax_arrays(leaves, torch.device("cpu"))
    # The JAX scene always holds its BVH and geometry: they come across
    # (held against a "bvh" build in tests/test_torch_bvh.py), where the
    # pallas build uploads none.
    assert bvh_leaves_beside(carried, ts) == BVH_LEAVES
    for f in dataclasses.fields(ts):
        got, want = getattr(carried, f.name), getattr(ts, f.name)
        if f.name in BVH_LEAVES:
            continue
        if not isinstance(want, torch.Tensor):
            assert got == want, f.name
            continue
        assert got.dtype == want.dtype, f.name
        assert torch.equal(got, want), f.name


# The leaves of the "bvh" route that a pallas build does not upload:
BVH_LEAVES = {"bvh_nodes", "verts", "normals", "tri_v", "mesh_first_tri",
              "mesh_has_normals", "geom_type", "geom_index", "spheres",
              "discs"}


def bvh_leaves_beside(carried, own) -> set:
    """The fields ``carried`` holds and ``own`` does not."""
    return {f.name for f in dataclasses.fields(own)
            if getattr(own, f.name) is None
            and getattr(carried, f.name) is not None}


def test_from_jax_arrays_names_missing_leaves():
    with pytest.raises(KeyError, match="nrm"):
        from_jax_arrays({"p": np.zeros((128, 16), np.float32)}, "cpu")


def test_bench_scene_shape():
    scene = make_cornell_box_scene(MESH, box_only=False)
    ts, _ = build_scene(scene, device="cpu", image_width=8, image_height=8)
    leaves, _ = compile_scene(scene, image_width=8, image_height=8,
                              window=None, samples_per_pixel=1)
    # 4,032 triangles -> 32 blocks of 128 rows; 2 spheres + 1 disc -> 8 rows
    assert ts.p.shape == (32 * 128, 16)
    assert ts.nrm.shape == (8, 32 * 3 * 128)
    assert ts.num_blocks == 32 and ts.n_ap == 8
    assert int((leaves["tri_geom"] >= 0).sum()) == 4032
