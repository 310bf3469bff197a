"""The dense intersector (ops/dense.py, kernel K8's plain version, and
``dense_intersect`` in ops/traversal.py) against the JAX package on the
CPU.

The tables equal ``build_dense_tables``'s leaf for leaf (packed one row
of 16 f32 per triangle). The closest hits are held bit for bit against
the JAX functions under ``jax.jit``, as its routes compile them: the dots
at ``Precision.HIGHEST`` reduce in order with each product fused into the
running sum, and ``og1 + t*dg1`` is one fused multiply-add. The rays are
tests/test_torch_bvh.py's: 2,000 seeded (50 dead lanes, a fifth with a
finite t_max) and the 48x32 camera rays from (0, 0, 0), whose origin's
dots XLA computes (it does not fold a dot of zeros). Per row the plain
version and K8 keep the first row of the strict minimum, which is the
JAX form's ``argmin`` per block of 512 and its strict ``better`` across
blocks: the Cornell + monkey scene has 4,096 padded rows, 8 blocks.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ipu_ray_lib_tpu.ops import dense as JD
from ipu_ray_lib_tpu.ops import traversal as JT
import ipu_ray_lib_tpu_torch.scene.build as TB
from ipu_ray_lib_tpu_torch.ops import dense as TD
from ipu_ray_lib_tpu_torch.ops import traversal as TT
from ipu_ray_lib_tpu_torch.scene import builtin as PB
from test_torch_bvh import (SCENES, _t, bits_diff, builds, camera_dirs,
                            seeded_rays, shadow_rays)

W, H = 48, 32


@pytest.fixture(scope="module", params=list(SCENES))
def scene(request):
    arrays, _, ts, _ = builds(request.param, intersector="dense")
    return request.param, arrays, ts


def test_tables_match_jax_leaf_for_leaf(scene):
    _, arrays, ts = scene
    jd = arrays.dense
    assert ts.dense_rows.shape == (jd.tn.shape[0], 16)
    assert ts.dense_rows.shape[0] % TD.TRI_BLOCK == 0
    for k, c in TD.DENSE_COLS.items():
        assert bits_diff(ts.dense_rows[:, c], np.asarray(getattr(jd, k))) == 0, k
    assert not ts.dense_rows[:, 14:].any()
    assert np.array_equal(ts.dense_geom.numpy(), np.asarray(jd.tri_geom))
    assert np.array_equal(ts.dense_prim.numpy(), np.asarray(jd.tri_prim))
    # the numpy tables themselves, field by field:
    own = TD.build_dense_tables(np.asarray(arrays.tri_v),
                                np.asarray(arrays.verts),
                                np.asarray(jd.tri_geom)[:0], [])._fields
    assert own == JD.DenseTables._fields


def test_empty_mesh_gets_one_padding_block():
    t = TD.build_dense_tables(np.zeros((0, 3), np.int32),
                              np.zeros((0, 3), np.float32),
                              np.zeros(0, np.int32), np.zeros(0, np.int32))
    assert t.tn.shape == (TD.TRI_BLOCK, 3) and not t.tn.any()


def test_closest_tri_matches_jax(scene):
    _, arrays, ts = scene
    o, d, t_min, t_max = seeded_rays(arrays)
    want_t, want_i = jax.jit(JD.dense_closest_tri)(arrays.dense, o, d, t_min,
                                                    t_max)
    got_t, got_i = TD.dense_closest_tri_ref(ts.dense_rows, _t(o), _t(d),
                                            _t(t_min), _t(t_max))
    assert bits_diff(got_t, want_t) == 0
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    assert got_i.dtype == torch.int32


def test_closest_tri_camera_rays_match_jax():
    arrays, _, ts, params = builds("monkey", intersector="dense",
                                   size=(W, H))
    d = camera_dirs(params)
    n = len(d)
    t_min, t_max = np.zeros(n, np.float32), np.full(n, np.inf, np.float32)
    want_t, want_i = jax.jit(lambda dt, d, lo, hi: JD.dense_closest_tri(
        dt, jnp.zeros_like(d), d, lo, hi))(arrays.dense, d, t_min, t_max)
    got_t, got_i = TD.dense_closest_tri_ref(ts.dense_rows, torch.zeros(n, 3),
                                            _t(d), _t(t_min), _t(t_max))
    assert bits_diff(got_t, want_t) == 0
    assert np.array_equal(got_i.numpy(), np.asarray(want_i))
    assert (got_i >= 0).sum() > n // 4


def test_closest_tri_in_ray_chunks_is_one_call(scene, monkeypatch):
    """The plain version's ray chunks change nothing."""
    _, arrays, ts = scene
    rays = [_t(a) for a in seeded_rays(arrays, n=700)]
    whole = TD.dense_closest_tri_ref(ts.dense_rows, *rays)
    monkeypatch.setattr(TD, "REF_RAYS", 256)
    for g, w in zip(TD.dense_closest_tri_ref(ts.dense_rows, *rays), whole):
        assert torch.equal(g, w)


def test_dense_intersect_with_normal_matches_jax(scene):
    """Triangles, then the spheres and discs; the normal recomputed after
    the fact (``hit_normal``), jitted together as the routes run them."""
    _, arrays, ts = scene
    o, d, t_min, t_max = seeded_rays(arrays, seed=2)
    want = jax.jit(lambda a, o, d, lo, hi: JT.scene_intersect_with_normal(
        a, o, d, lo, hi, "dense"))(arrays, o, d, t_min, t_max)
    hit, normal = TT.scene_intersect_with_normal(
        ts, _t(o), _t(d), _t(t_min), _t(t_max), "dense")
    for f in ("t", "geom_id", "prim_id"):
        assert bits_diff(getattr(hit, f), getattr(want[0], f)) == 0, f
    assert bits_diff(normal, want[1]) == 0
    assert int(hit.found.sum()) > 0.1 * len(o)


def test_dense_occluded_matches_jax(scene):
    """The any hit of ``"dense"``: its closest hit with t < t_max."""
    _, arrays, ts = scene
    o, d, t_min, t_max = seeded_rays(arrays)
    hit = TT.dense_intersect(ts, _t(o), _t(d), _t(t_min), _t(t_max))
    so, sd, s_min, s_max = shadow_rays(o, d, np.where(
        hit.found.numpy(), hit.t.numpy(), np.inf).astype(np.float32))
    want = jax.jit(lambda a, o, d, lo, hi: JT.scene_occluded(
        a, o, d, lo, hi, "dense"))(arrays, so, sd, s_min, s_max)
    got = TT.scene_occluded(ts, _t(so), _t(sd), _t(s_min), _t(s_max),
                            "dense")
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < int(hit.found.sum())


def test_dense_and_bvh_find_the_same_hits():
    """Both intersectors report the same nearest primitive wherever they
    agree it is hit (ties between triangles sharing an edge may differ:
    visit order against row order)."""
    arrays, _, ts, _ = builds("monkey", intersector="dense")
    rays = [_t(a) for a in seeded_rays(arrays)]
    a = TT.dense_intersect(ts, *rays)
    b = TT.bvh_intersect(ts, *rays)
    both = a.found & b.found
    assert int(both.sum()) > 0.95 * int(a.found.sum())
    same = (a.geom_id == b.geom_id) & (a.prim_id == b.prim_id)
    assert float(same[both].float().mean()) > 0.99


def test_tables_follow_the_jax_size_rule(monkeypatch):
    """Above DENSE_TABLE_MAX_TRIS the tables are skipped unless "dense" is
    asked for, and the dense route then raises as the JAX package's."""
    monkeypatch.setattr(TB, "DENSE_TABLE_MAX_TRIS", 50)
    ts, _ = TB.build_scene(PB.make_stress_scene(8), device="cpu",
                           image_width=8, image_height=8, intersector="bvh")
    assert ts.bvh_nodes is not None and ts.dense_rows is None
    ones = torch.ones(4, 3)
    with pytest.raises(RuntimeError, match="DENSE_TABLE_MAX_TRIS"):
        TT.dense_intersect(ts, ones, ones, torch.zeros(4), torch.ones(4))
    ts, _ = TB.build_scene(PB.make_stress_scene(8), device="cpu",
                           image_width=8, image_height=8, intersector="dense")
    assert ts.dense_rows.shape == (512, 16)


# ---- the kernel on the card ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_dense_kernel_matches_plain(cuda_device):
    arrays, _, ts, _ = builds("monkey", intersector="dense")
    rows = ts.dense_rows.to(cuda_device)
    rays = [_t(a).to(cuda_device) for a in seeded_rays(arrays)]
    got = TD.dense_closest_tri_cuda(rows, *rays)
    torch.cuda.synchronize()
    for g, w in zip(got, TD.dense_closest_tri_ref(rows, *rays)):
        assert torch.equal(g, w)
