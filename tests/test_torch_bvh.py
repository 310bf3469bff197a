"""The threaded-BVH walk (ops/bvh.py, kernel K7's plain version) and
``hit_normal`` (ops/traversal.py) against the JAX package on the CPU.

Each function is held bit for bit (``==`` on every element) against the
JAX function of the same name under ``jax.jit``, as the JAX package's
routes compile it (``_shadow_chunk``, the XLA-loop integrator, the
per-sample path): there ``1/direction``, the ray shear and ``hit_normal``
compile together with the walk, and XLA contracts a product feeding a sum
into one fused multiply-add. A direct call of ``bvh_intersect`` outside
``jit`` rounds op by op and is not what the port follows.

The scenes: the Cornell box with the monkey bust (4,032 triangles, 2
spheres, 1 disc, vertex normals), the spheres + discs scene of the NIF
flagship, and the stress heightfield at grid 8 (98 triangles). The rays:
2,000 seeded from spread origins in the root box (50 of them dead lanes,
t_max = -1, and a fifth with a finite t_max), the 48x32 camera rays from
(0, 0, 0) (whose zero origin XLA folds into the walk), and for the
any-hit walk the shadow rays of the hits towards a point light.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ipu_ray_lib_tpu.ops import traversal as JT
from ipu_ray_lib_tpu.scene.build import build_scene as jax_build_scene
from ipu_ray_lib_tpu.scene import builtin as JB
import ipu_ray_lib_tpu_torch.scene.build as TB
from ipu_ray_lib_tpu_torch.ops import bvh as TBVH
from ipu_ray_lib_tpu_torch.ops import traversal as TT
from ipu_ray_lib_tpu_torch.ops.camera import generate_camera_rays
from ipu_ray_lib_tpu_torch.scene import builtin as PB

ROOT = os.path.join(os.path.dirname(__file__), "..")
MONKEY = os.path.join(ROOT, "assets", "monkey_bust.glb")
N_RAYS, N_DEAD = 2000, 50
W, H = 48, 32
LIGHT = np.array([18.0, 257.0, -1060.0], np.float32)

SCENES = {
    "monkey": (lambda: JB.make_cornell_box_scene(MONKEY, box_only=False),
               lambda: PB.make_cornell_box_scene(MONKEY, box_only=False)),
    "spheres": (JB.make_primitive_scene, PB.make_primitive_scene),
    "stress8": (lambda: JB.make_stress_scene(8),
                lambda: PB.make_stress_scene(8)),
}
GEOMETRY = ("verts", "normals", "tri_v", "mesh_first_tri", "mesh_has_normals",
            "geom_type", "geom_index", "spheres", "discs")


def builds(name, intersector="bvh", size=(8, 8)):
    """(JAX arrays, JAX params, port scene, port params) of ``name``."""
    jmake, pmake = SCENES[name]
    w, h = size
    arrays, jparams, _ = jax_build_scene(jmake(), image_width=w,
                                         image_height=h,
                                         intersector=intersector)
    ts, params = TB.build_scene(pmake(), device="cpu", image_width=w,
                                image_height=h, intersector=intersector)
    return arrays, jparams, ts, params


def seeded_rays(arrays, n=N_RAYS, seed=0):
    """n rays from origins spread over the root box, unit directions;
    t_min 0, t_max inf but finite for a fifth and -1 for the first
    N_DEAD (dead lanes)."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(arrays.bvh_min[0])
    ext = np.asarray(arrays.bvh_ext[0]).astype(np.float32)
    o = (lo + rng.random((n, 3)) * ext).astype(np.float32)
    d = rng.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    t_min = np.zeros(n, np.float32)
    t_max = np.full(n, np.inf, np.float32)
    fin = rng.random(n) < 0.2
    t_max[fin] = (rng.random(fin.sum()) * ext.max()).astype(np.float32)
    t_max[:N_DEAD] = -1.0
    return o, d, t_min, t_max


def camera_dirs(params):
    rows, cols = np.meshgrid(np.arange(params.image_height),
                             np.arange(params.image_width), indexing="ij")
    _, d = generate_camera_rays(
        torch.from_numpy(rows.ravel().astype(np.float32)),
        torch.from_numpy(cols.ravel().astype(np.float32)),
        params.image_width, params.image_height, params.fov_radians)
    return d.numpy()


def shadow_rays(o, d, t):
    """Rays from the hit points (pushed 1e-3 off along the way back)
    towards LIGHT, t_max the light's distance; misses get t_max -1."""
    hit = np.isfinite(t) & (t > 0)
    p = o + d * np.where(hit, t * np.float32(0.999), 0)[:, None]
    to = LIGHT[None] - p
    dist = np.linalg.norm(to, axis=1).astype(np.float32)
    sd = (to / dist[:, None]).astype(np.float32)
    return (p.astype(np.float32), sd, np.zeros(len(o), np.float32),
            np.where(hit, dist, np.float32(-1.0)).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def bits_diff(got, want) -> int:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if want.dtype == np.float32:
        assert got.dtype == np.float32
        got, want = got.view(np.uint32), want.view(np.uint32)
    return int((got != want).sum())


@pytest.fixture(scope="module", params=list(SCENES))
def scene(request):
    arrays, jparams, ts, params = builds(request.param)
    return request.param, arrays, ts


def test_packed_nodes_and_geometry_match_jax(scene):
    _, arrays, ts = scene
    lo, hi, meta, geom, miss = TBVH.unpack_nodes(ts.bvh_nodes)
    assert bits_diff(lo, arrays.bvh_min) == 0
    want_hi = np.asarray(arrays.bvh_min) + np.asarray(
        arrays.bvh_ext).astype(np.float32)
    assert bits_diff(hi, want_hi) == 0
    for got, k in ((meta, "meta"), (geom, "geom"), (miss, "miss")):
        assert np.array_equal(got.numpy(), np.asarray(getattr(arrays,
                                                              f"bvh_{k}"))), k
    for k in GEOMETRY:
        want = np.asarray(getattr(arrays, k))
        got = getattr(ts, k).numpy()
        assert got.dtype == want.dtype and bits_diff(got, want) == 0, k


def test_pallas_scenes_carry_no_bvh_leaves():
    ts, _ = TB.build_scene(PB.make_stress_scene(8), device="cpu",
                           image_width=8, image_height=8)
    assert all(getattr(ts, k) is None for k in TB.BVH_DENSE_LEAVES)


def test_bvh_intersect_matches_jax(scene):
    name, arrays, ts = scene
    o, d, t_min, t_max = seeded_rays(arrays)
    want = jax.jit(JT.bvh_intersect)(arrays, o, d, t_min, t_max)
    got = TT.bvh_intersect(ts, _t(o), _t(d), _t(t_min), _t(t_max))
    for f in ("t", "geom_id", "prim_id"):
        assert bits_diff(getattr(got, f), getattr(want, f)) == 0, f
    found = got.found.numpy()
    assert 0.2 * N_RAYS < found.sum() < N_RAYS - N_DEAD
    assert not found[:N_DEAD].any()
    assert np.array_equal(got.t.numpy()[:N_DEAD], t_max[:N_DEAD])


def test_camera_rays_match_jax():
    """Camera rays from (0, 0, 0): the walk with the origin folded, as XLA
    folds it inside its loop; the hits include the disc."""
    arrays, jparams, ts, params = builds("monkey", size=(W, H))
    d = camera_dirs(params)
    n = len(d)
    t_min, t_max = np.zeros(n, np.float32), np.full(n, np.inf, np.float32)
    want = jax.jit(lambda a, d, lo, hi: JT.scene_intersect_with_normal(
        a, jnp.zeros_like(d), d, lo, hi, "bvh"))(arrays, d, t_min, t_max)
    hit, normal = TT.scene_intersect_with_normal(ts, None, _t(d), _t(t_min),
                                                 _t(t_max), "bvh")
    for f in ("t", "geom_id", "prim_id"):
        assert bits_diff(getattr(hit, f), getattr(want[0], f)) == 0, f
    assert bits_diff(normal, want[1]) == 0
    geoms = set(hit.geom_id.numpy().tolist())
    assert params.num_geoms - 1 in geoms  # the disc


def test_bvh_occluded_matches_jax(scene):
    """The any-hit walk on the shadow rays of the closest hits."""
    _, arrays, ts = scene
    o, d, t_min, t_max = seeded_rays(arrays)
    hit = TT.bvh_intersect(ts, _t(o), _t(d), _t(t_min), _t(t_max))
    so, sd, s_min, s_max = shadow_rays(o, d, np.where(
        hit.found.numpy(), hit.t.numpy(), np.inf).astype(np.float32))
    want = jax.jit(JT.bvh_occluded)(arrays, so, sd, s_min, s_max)
    got = TT.bvh_occluded(ts, _t(so), _t(sd), _t(s_min), _t(s_max))
    assert got.dtype == torch.bool
    assert np.array_equal(got.numpy(), np.asarray(want))
    n_occ = int(got.sum())
    assert 0 < n_occ < int(hit.found.sum())


def test_any_hit_agrees_with_closest_hit(scene):
    """The any-hit flag is set exactly where the closest hit lies inside
    (t_min, t_max)."""
    _, arrays, ts = scene
    o, d, t_min, t_max = seeded_rays(arrays, seed=3)
    t_max = np.where(np.isinf(t_max), np.float32(50.0), t_max)
    occ = TT.bvh_occluded(ts, _t(o), _t(d), _t(t_min), _t(t_max))
    hit = TT.bvh_intersect(ts, _t(o), _t(d), _t(t_min), _t(t_max))
    assert torch.equal(occ, hit.found & (hit.t < _t(t_max)))


def test_hit_normal_matches_jax(scene):
    """``hit_normal`` jitted with the walk, as the routes compile it."""
    _, arrays, ts = scene
    o, d, t_min, t_max = seeded_rays(arrays, seed=1)
    want = jax.jit(lambda a, o, d, lo, hi: JT.scene_intersect_with_normal(
        a, o, d, lo, hi, "bvh"))(arrays, o, d, t_min, t_max)
    hit, normal = TT.scene_intersect_with_normal(
        ts, _t(o), _t(d), _t(t_min), _t(t_max), "bvh")
    assert bits_diff(normal, want[1]) == 0
    assert bits_diff(hit.t, want[0].t) == 0


def test_walk_counts_its_steps():
    """The plain walk's counts (what chip_smoke.py bounds K7 with): every
    ray visits the root; a leaf test only at a leaf whose box it enters."""
    _, _, ts, _ = builds("stress8")
    arrays = builds("stress8")[0]
    o, d, t_min, t_max = seeded_rays(arrays, n=300)
    stats = {}
    TBVH.bvh_walk_ref(ts, _t(o), _t(d), _t(t_min), _t(t_max), False,
                      stats=stats)
    assert stats["node_visits"] >= 300
    assert 0 < stats["leaf_tests"] < stats["node_visits"]


def test_from_jax_arrays_carries_bvh_leaves():
    arrays, _, ts, _ = builds("monkey", intersector="dense")
    leaves = {k: np.asarray(v) for k, v in arrays._asdict().items()
              if k not in ("dense", "blocked")}
    leaves.update({k: np.asarray(v) for k, v in arrays.blocked._asdict().items()
                   if v is not None})
    leaves["dense"] = arrays.dense
    carried = TB.from_jax_arrays(leaves, "cpu")
    for k in TB.BVH_DENSE_LEAVES:
        assert torch.equal(getattr(carried, k), getattr(ts, k)), k


def test_walk_needs_the_bvh():
    _, _, ts, _ = builds("stress8", intersector="pallas")
    ones = torch.ones(4, 3)
    with pytest.raises(ValueError, match="no threaded BVH"):
        TBVH.bvh_walk(ts, ones, ones, torch.zeros(4), torch.ones(4), False)


# ---- the kernel on the card ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("any_hit", [False, True])
def test_cuda_bvh_kernel_matches_plain(cuda_device, any_hit):
    arrays, _, ts, _ = builds("monkey")
    ts = ts.to(cuda_device)
    o, d, t_min, t_max = (_t(a).to(cuda_device) for a in seeded_rays(arrays))
    got = TBVH.bvh_walk_cuda(ts, o, d, t_min, t_max, any_hit)
    torch.cuda.synchronize()
    want = TBVH.bvh_walk_ref(ts, o, d, t_min, t_max, any_hit)
    for g, w in zip(got, want):
        if w is not None:
            assert torch.equal(g, w)
