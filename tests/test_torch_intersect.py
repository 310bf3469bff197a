"""The port's closest-hit kernels K5 and K6 (their plain versions) and the
glue route's intersect functions against the JAX package on the CPU.

The JAX side runs its own functions: ``pallas_intersect`` and
``pallas_intersect_hbm`` in interpret mode (as tests/test_hbm.py runs
them), and ``pallas_scene_intersect`` / ``pallas_path_intersect`` /
``scene_occluded`` under ``jit``, as the shadow chunk and the XLA-loop
integrator run them. Everything is held bit for bit (``==`` on every
element; inf == inf):

* the super cull equals the JAX ``super_cull_lists_bundle``;
* ``dense_spheres`` / ``dense_discs`` equal the JAX functions on rays aimed
  at the primitives, and the elementwise dot of the fused shadow kernel's
  twin rounds differently (why the glue and the fused route differ on
  sphere hits, in both packages);
* ``pallas_intersect`` (K5's plain version) returns the JAX t, triangle
  row, unit normal and the 10 payload rows on the Cornell box's camera
  rays, on the rays of one diffuse bounce, on 3,000 random rays from
  spread origins (the last bundle padded), on a vertex-normal mesh, and on
  exact t ties (a duplicated grid of quads hit at its vertices and
  edges: ties inside a block go to the lowest row, across blocks to the
  first block walked);
* ``pallas_intersect_hbm`` (K6's plain version) the same, on stress24 and
  the Cornell box in HBM mode, with the f32 payload and with the payload
  split to bf16 (the VMEM ceiling and, for the split,
  ``HBM_SPLIT_MIN_TRIS`` lowered as tests/test_torch_hbm.py does);
* ``needed_pairs``, the work that bounds both kernels on the card: the
  (lane, block) pairs a lane's own slab admits before its hit, the same
  over the walked blocks as over every block;
* the glue's ``pallas_scene_intersect`` (with and without normals),
  ``pallas_path_intersect`` and ``scene_occluded`` on the Cornell box with
  its spheres and disc, in both modes.

On the card (tests marked ``cuda``) each kernel equals its plain version.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import os

import numpy as np
import pytest
import torch

import jax

import ipu_ray_lib_tpu.scene.types as JT
from ipu_ray_lib_tpu.ops.dense import dense_discs as jax_dense_discs
from ipu_ray_lib_tpu.ops.dense import dense_spheres as jax_dense_spheres
from ipu_ray_lib_tpu.ops.pallas.intersect_hbm import (
    pallas_intersect_hbm as jax_intersect_hbm)
from ipu_ray_lib_tpu.ops.pallas.intersect_kernel import (
    pallas_intersect as jax_intersect)
from ipu_ray_lib_tpu.ops.pallas.intersect_kernel import (
    super_cull_lists_bundle as jax_super_cull)
import ipu_ray_lib_tpu.ops.traversal as JTR
from ipu_ray_lib_tpu.scene.build import build_scene as jax_build_scene
from ipu_ray_lib_tpu.scene.builtin import make_cornell_box_scene as jax_cornell
import ipu_ray_lib_tpu_torch.ops.traversal as TTR
import ipu_ray_lib_tpu_torch.scene.build as TB
import ipu_ray_lib_tpu_torch.scene.types as TT
from ipu_ray_lib_tpu_torch.ops import camera as TC
from ipu_ray_lib_tpu_torch.ops import intersect_hbm as ih
from ipu_ray_lib_tpu_torch.ops import intersect_kernel as ik
from ipu_ray_lib_tpu_torch.ops.cull import super_cull_lists_bundle
from ipu_ray_lib_tpu_torch.ops.dense import (dense_discs, dense_spheres,
                                             sphere_pass)
from ipu_ray_lib_tpu_torch.ops.intersect import SLAB_LO, slab_inv, slab_test
from ipu_ray_lib_tpu_torch.ops.intersect_kernel import _dot
from ipu_ray_lib_tpu_torch.scene.builtin import make_cornell_box_scene

from test_torch_hbm import _builds, _smooth_scene

MONKEY = os.path.join(os.path.dirname(__file__), "..", "assets",
                      "monkey_bust.glb")
W, H = 48, 32
INF = np.float32(np.inf)


def _equal(a, b) -> int:
    """Elements where a != b (inf == inf; no NaN is expected)."""
    a = a.numpy() if torch.is_tensor(a) else np.asarray(a)
    b = b.numpy() if torch.is_tensor(b) else np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    return int((a != b).sum())


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def box():
    """Cornell box (box + 2 spheres + disc) in both packages, VMEM mode."""
    arrays, _, _ = jax_build_scene(jax_cornell(None, box_only=False),
                                   image_width=W, image_height=H,
                                   intersector="pallas")
    ts, params = TB.build_scene(make_cornell_box_scene(None, box_only=False),
                                device="cpu", image_width=W, image_height=H,
                                intersector="pallas")
    return arrays, ts, params


def _camera(params):
    rows, cols = TC.pixel_grid(W, H, 0, 0, device="cpu")
    d = TC.generate_camera_rays(rows, cols, W, H, params.fov_radians)[1]
    return np.zeros((W * H, 3), np.float32), d.numpy()


def _spread(ts, n, seed):
    """n random rays from origins spread over the scene, a third aimed at
    its spheres and discs."""
    rng = np.random.default_rng(seed)
    b = ts.baabb.numpy()
    lo, hi = b[:, 0:3].min(0), b[:, 3:6].max(0)
    o = rng.uniform(lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo),
                    (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    tg = ts.ap.numpy()[:, 1:4]
    k = n // 3
    d[:k] = (tg[rng.integers(0, len(tg), k)]
             + rng.normal(0, 20, (k, 3)).astype(np.float32) - o[:k])
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _bounce(arrays, o, d, seed):
    """Rays of one diffuse bounce: from the camera rays' hit points
    (pushed off the surface) into random directions of the normal's
    hemisphere."""
    R = o.shape[0]
    t, tri, n, _ = jax_intersect(arrays.blocked, o, d, np.zeros(R, np.float32),
                                 np.full(R, INF), interpret=True)
    t, n = np.asarray(t), np.asarray(n)
    hit = np.asarray(tri) >= 0
    p = o[hit] + d[hit] * t[hit, None]
    n = n[hit]
    rng = np.random.default_rng(seed)
    nd = rng.normal(size=p.shape).astype(np.float32)
    nd /= np.linalg.norm(nd, axis=1, keepdims=True)
    nd = np.where(np.sum(nd * n, 1, keepdims=True) < 0, -nd, nd)
    p = p + n * np.float32(1e-2) * (1.0 + np.abs(p).max(1, keepdims=True))
    return p.astype(np.float32), nd.astype(np.float32)


def _intersect_case(fn_jax, tables, fn_port, ts, o, d, t_max=None):
    R = o.shape[0]
    t_min = np.zeros(R, np.float32)
    t_max = np.full(R, INF) if t_max is None else t_max
    want = fn_jax(tables, o, d, t_min, t_max, interpret=True)
    got = fn_port(ts, _t(o), _t(d), _t(t_min), _t(t_max))
    return [np.asarray(w) for w in want], got


def _hold(want, got, min_hits=1):
    for w, g, name in zip(want, got, ("t", "tri", "normal", "payload")):
        assert _equal(g, w) == 0, name
    assert (want[1] >= 0).sum() >= min_hits


# ---- 1. the culls and the analytic primitives ----

def test_super_cull_matches_jax():
    """On Cornell + monkey: 32 blocks, 4 supers."""
    arrays, _, _ = jax_build_scene(jax_cornell(MONKEY, box_only=False),
                                   image_width=W, image_height=H,
                                   intersector="pallas")
    ts, _ = TB.build_scene(make_cornell_box_scene(MONKEY, box_only=False),
                           device="cpu", image_width=W, image_height=H,
                           intersector="pallas")
    o, d = _spread(ts, 2048, 3)
    tmin, tmax = np.zeros(2048, np.float32), np.full(2048, INF)
    tmax[1500:] = -1.0  # a dead tail: the second bundle's box shrinks
    want = jax.jit(jax_super_cull, static_argnums=(5,))(
        arrays.blocked, o, d, tmin, tmax, 2)
    got = super_cull_lists_bundle(ts, *map(_t, (o, d, tmin, tmax)), 2)
    assert ts.saabb.shape[0] == 4 and int(got[0].sum()) > 2
    for g, w in zip(got, want):
        assert _equal(g, w) == 0


def test_dense_spheres_and_discs_match_jax(box):
    arrays, ts, _ = box
    o, d = _spread(ts, 6000, 4)
    tmin = np.zeros(6000, np.float32)
    best = np.full(6000, 900.0, np.float32)
    for jf, tf in ((jax_dense_spheres, dense_spheres),
                   (jax_dense_discs, dense_discs)):
        table = arrays.spheres if jf is jax_dense_spheres else arrays.discs
        want = jax.jit(jf)(table, o, d, tmin, best)
        got = tf(ts, _t(o), _t(d), _t(tmin), _t(best))
        assert np.asarray(want[0]).sum() > 100
        for g, w in zip(got, want):
            assert _equal(g, w) == 0


def test_elementwise_sphere_dot_is_not_the_glues(box):
    """The fused shadow kernel's twin contracts the sphere test's dots
    elementwise; XLA reduces the glue's ``dense_spheres`` dots in order.
    They round differently on some hits: the JAX package's own glue and
    fused routes then disagree in the last bit of t there."""
    arrays, ts, _ = box
    o, d = _spread(ts, 6000, 4)
    tmin = _t(np.zeros(6000, np.float32))
    cols = lambda a: tuple(_t(a[:, c].copy()) for c in range(3))
    want = np.asarray(jax.jit(jax_dense_spheres)(
        arrays.spheres, o, d, np.zeros(6000, np.float32),
        np.full(6000, INF))[1])
    t_elem = sphere_pass(ts.ap, ts.n_spheres, cols(o), cols(d), tmin,
                         dot=_dot)[0]
    assert _equal(t_elem, want) > 0


# ---- 2. K5's plain version against the JAX kernel ----

def _tie_scene(T):
    """A 16 x 16 grid of unit quads in the plane z = -5, twice (two
    meshes): every hit ties with its copy, and rays through the grid's
    vertices and edges tie between neighbours too."""
    n = 16
    xs = np.arange(n + 1, dtype=np.float32) - n / 2
    vx, vy = np.meshgrid(xs, xs, indexing="ij")
    verts = np.stack([vx.ravel(), vy.ravel(),
                      np.full(vx.size, -5.0, np.float32)], -1)
    idx = np.arange((n + 1) ** 2).reshape(n + 1, n + 1)
    a, b, c, dd = idx[:-1, :-1], idx[1:, :-1], idx[1:, 1:], idx[:-1, 1:]
    tris = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                           np.stack([a, c, dd], -1).reshape(-1, 3)])
    scene = T.SceneDescription()
    scene.meshes = [T.HostMesh(triangles=tris, vertices=verts),
                    T.HostMesh(triangles=tris[::-1].copy(), vertices=verts)]
    zero = np.zeros(3, np.float32)
    scene.materials = [
        T.Material(np.array([0.7, 0.7, 0.7], np.float32), zero,
                   T.MaterialType.DIFFUSE),
        T.Material(np.array([0.2, 0.3, 0.9], np.float32),
                   np.array([1.0, 2.0, 3.0], np.float32),
                   T.MaterialType.SPECULAR)]
    scene.mat_ids = [0, 1]
    scene.camera = T.Camera(horizontal_fov=float(np.pi / 3))
    scene.validate()
    return scene


def _tie_rays():
    """Rays from z = 0 through the grid's vertices, edge midpoints and
    cell centres."""
    g = np.arange(-8.0, 8.5, 0.5, dtype=np.float32)
    gx, gy = np.meshgrid(g, g, indexing="ij")
    target = np.stack([gx.ravel(), gy.ravel(),
                       np.full(gx.size, -5.0, np.float32)], -1)
    o = np.zeros_like(target)
    o[:, 0:2] = target[:, 0:2] * np.float32(0.25)
    d = target - o
    return o, (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def k5_cases(box):
    arrays, ts, params = box
    o, d = _camera(params)
    cases = {"camera": _intersect_case(jax_intersect, arrays.blocked,
                                       ik.pallas_intersect, ts, o, d)}
    bo, bd = _bounce(arrays, o, d, 6)
    cases["bounce"] = _intersect_case(jax_intersect, arrays.blocked,
                                      ik.pallas_intersect, ts, bo, bd)
    so, sd = _spread(ts, 3000, 5)
    t_max = np.full(3000, INF)
    t_max[::7] = 300.0  # finite bounds for some rays
    cases["random"] = _intersect_case(jax_intersect, arrays.blocked,
                                      ik.pallas_intersect, ts, so, sd, t_max)
    sa, _, _ = jax_build_scene(_smooth_scene(JT), image_width=16,
                               image_height=16, intersector="pallas")
    ss, _ = TB.build_scene(_smooth_scene(TT), device="cpu", image_width=16,
                           image_height=16, intersector="pallas")
    rng = np.random.default_rng(7)
    mo = rng.uniform(-3, 3, (2048, 3)).astype(np.float32)
    mo[:, 2] = rng.uniform(0, 2, 2048)
    md = (np.array([0, -0.4, -3.2], np.float32)
          + rng.normal(0, 0.7, (2048, 3)).astype(np.float32) - mo)
    md = (md / np.linalg.norm(md, axis=1, keepdims=True)).astype(np.float32)
    cases["smooth"] = _intersect_case(jax_intersect, sa.blocked,
                                      ik.pallas_intersect, ss, mo, md)
    ta, _, _ = jax_build_scene(_tie_scene(JT), image_width=16,
                               image_height=16, intersector="pallas")
    tts, _ = TB.build_scene(_tie_scene(TT), device="cpu", image_width=16,
                            image_height=16, intersector="pallas")
    to, td = _tie_rays()
    cases["ties"] = _intersect_case(jax_intersect, ta.blocked,
                                    ik.pallas_intersect, tts, to, td)
    cases["ties"] += (tts,)
    return cases


@pytest.mark.parametrize("case", ["camera", "bounce", "random", "smooth",
                                  "ties"])
def test_k5_plain_matches_jax_kernel(k5_cases, case):
    want, got = k5_cases[case][:2]
    _hold(want, got, min_hits=100)
    if case == "smooth":  # the shading normal follows the barycentrics
        assert len(np.unique(want[2][want[1] >= 0][:, 0])) > 1000


def test_k5_ties_go_to_the_first_row_and_block(k5_cases):
    """Every hit of the duplicated grid ties with its copy, 2 * 128 rows
    apart or more: the winner is a row of the first copy walked, and the
    two copies' geometry ids both occur, so the order decides."""
    want, got, tts = k5_cases["ties"]
    tri = got[1].long()
    hit = tri >= 0
    assert bool(hit.all())
    geom = tts.tri_geom[tri[hit]]
    assert set(geom.tolist()) <= {0, 1}
    # the payload's material type (segment 1 row 3: type + 4 * emissive)
    # is that of the winning copy
    mtype = got[3][5][hit].round().long() & 3
    assert torch.equal(mtype, torch.where(geom == 0, 0, 1))


def test_plain_walk_counts_pairs(box):
    arrays, ts, params = box
    o, d = _camera(params)
    args = ik.intersect_inputs(_t(o), _t(d), torch.zeros(W * H),
                               torch.full((W * H,), float("inf")))
    lists = ik.block_cull_lists_bundle(ts, *args[:4], 2)
    pairs = ik.dense_walk_ref(ts, *lists, args[4])[4]
    assert pairs.dtype == torch.int32 and pairs.shape == (2,)
    assert bool((pairs > 0).all()) and bool((pairs <= lists[0]).all())


@pytest.mark.parametrize("hbm", [False, True])
def test_needed_pairs_are_every_admitted_block_before_the_hit(hbm):
    """The (lane, block) pairs that bound K5/K6: within the blocks each
    bundle walked, every block a lane's slab admits with an entry below
    its final t; the same count as over every block of the scene (the
    early stop passes no block a lane needs), and far fewer than the
    bundles' 1,024 lanes per walked block."""
    ts, params = TB.build_scene(make_cornell_box_scene(MONKEY,
                                                       box_only=False),
                                device="cpu", image_width=W, image_height=H,
                                intersector="pallas-hbm" if hbm else "pallas")
    co, cd = _camera(params)
    so, sd = _spread(ts, 1000, 5)
    o, d = np.concatenate([co, so]), np.concatenate([cd, sd])
    R = len(o)
    t_max = torch.full((R,), float("inf"))
    t_max[::7] = 300.0
    args = ik.intersect_inputs(_t(o), _t(d), torch.zeros(R), t_max)
    cull = super_cull_lists_bundle if hbm else ik.block_cull_lists_bundle
    lists = cull(ts, *args[:4], args[4].shape[1] // 1024)
    walk = ih.super_walk_ref if hbm else ik.dense_walk_ref
    out = walk(ts, *lists, args[4])
    need = ik.needed_pairs(ts, lists[1], args[4], out[0], out[4],
                           members=8 if hbm else 1)
    rays = args[4]
    adm, tin = slab_test(tuple(rays[0:3]), slab_inv(tuple(rays[3:6])),
                         rays[7] > 0, ts.baabb)
    assert need == int((adm & (tin * SLAB_LO < out[0])).sum())
    assert int((out[1] >= 0).sum()) < need < int(out[4].sum()) * 1024 // 10


# ---- 3. K6's plain version against the JAX kernel ----

@pytest.fixture(scope="module", params=[("stress24", False), ("stress24", True),
                                        ("cornell", False), ("cornell", True)],
                ids=lambda p: f"{p[0]}-{'bf16' if p[1] else 'f32'}")
def k6_case(request):
    name, split = request.param
    arrays, jparams, leaves, tparams = _builds(name, split, image_width=W,
                                               image_height=H,
                                               samples_per_pixel=1)
    ts = TB._from_leaves(leaves, "cpu")
    assert ts.payload_split == split
    assert (arrays.blocked.pay8 is not None) == split
    # The camera rays and 3,000 random rays in one batch (one JAX call):
    o, d = _camera(tparams)
    so, sd = _spread(ts, 3000, 8)
    return _intersect_case(jax_intersect_hbm, arrays.blocked,
                           ih.pallas_intersect_hbm, ts,
                           np.concatenate([o, so]), np.concatenate([d, sd]))


def test_k6_plain_matches_jax_kernel(k6_case):
    want, got = k6_case
    _hold(want, got, min_hits=100)
    n_cam = W * H
    assert (want[1][:n_cam] >= 0).sum() > 50
    assert (want[1][n_cam:] >= 0).sum() > 50


def test_super_walk_tests_whole_supers():
    ts, params = TB.build_scene(make_cornell_box_scene(None, box_only=False),
                                device="cpu", image_width=W, image_height=H,
                                intersector="pallas-hbm")
    o, d = _camera(params)
    args = ik.intersect_inputs(_t(o), _t(d), torch.zeros(W * H),
                               torch.full((W * H,), float("inf")))
    lists = super_cull_lists_bundle(ts, *args[:4], 2)
    ih.reset_launches()
    pairs = ih.super_walk_ref(ts, *lists, args[4])[4]
    assert bool((pairs > 0).all()) and bool((pairs % 8 == 0).all())
    assert bool((pairs <= 8 * lists[0]).all())
    assert ih.launches == 0


# ---- 4. the glue's intersect functions ----

@pytest.fixture(scope="module", params=["pallas", "pallas-hbm"])
def glue_scene(request, box):
    arrays, ts, params = box
    if request.param == "pallas-hbm":
        ts, params = TB.build_scene(make_cornell_box_scene(None, box_only=False),
                                    device="cpu", image_width=W,
                                    image_height=H, intersector="pallas-hbm")
        arrays, _, _ = jax_build_scene(jax_cornell(None, box_only=False),
                                       image_width=W, image_height=H,
                                       intersector="pallas-hbm")
    o, d = _spread(ts, 3000, 9)
    t_max = np.full(3000, INF)
    t_max[::5] = 150.0
    return request.param, arrays, ts, o, d, t_max


def test_scene_intersect_matches_jax(glue_scene):
    method, arrays, ts, o, d, t_max = glue_scene
    hbm = method == "pallas-hbm"
    tmin = np.zeros(len(o), np.float32)
    jhit, jn = jax.jit(lambda a, o, d, lo, hi: JTR.pallas_scene_intersect(
        a, o, d, lo, hi, with_normal=True, hbm=hbm))(arrays, o, d, tmin, t_max)
    hit, n = TTR.scene_intersect_with_normal(ts, _t(o), _t(d), _t(tmin),
                                             _t(t_max), method)
    for g, w in zip((*hit, n), (*jhit, jn)):
        assert _equal(g, w) == 0
    geom = np.asarray(jhit.geom_id)
    assert np.isin(geom, [6, 7]).sum() > 50 and (geom == 8).sum() > 20
    plain = TTR.scene_intersect(ts, _t(o), _t(d), _t(tmin), _t(t_max), method)
    assert all(torch.equal(a, b) for a, b in zip(plain, hit))


def test_scene_occluded_matches_jax(glue_scene):
    method, arrays, ts, o, d, t_max = glue_scene
    tmin = np.zeros(len(o), np.float32)
    dist = np.where(np.isinf(t_max), np.float32(200.0), t_max)
    want = jax.jit(lambda a, o, d, lo, hi: JTR.scene_occluded(
        a, o, d, lo, hi, method))(arrays, o, d, tmin, dist)
    got = TTR.scene_occluded(ts, _t(o), _t(d), _t(tmin), _t(dist), method)
    assert _equal(got, want) == 0
    assert 0 < int(got.sum()) < len(o)


def test_path_intersect_matches_jax(glue_scene):
    method, arrays, ts, o, d, t_max = glue_scene
    tmin = np.zeros(len(o), np.float32)
    want = jax.jit(lambda a, o, d, lo, hi: JTR.pallas_path_intersect(
        a, o, d, lo, hi, hbm=method == "pallas-hbm"))(arrays, o, d, tmin,
                                                       t_max)
    got = TTR.pallas_path_intersect(ts, _t(o), _t(d), _t(tmin), _t(t_max),
                                    hbm=method == "pallas-hbm")
    assert set(got) == set(want)
    for k in want:
        assert _equal(got[k], want[k]) == 0, k
    assert int(got["emissive"].sum()) > 0
    assert int((got["mat_type"] != 0).sum()) > 0


@pytest.mark.parametrize("method", ["bvh", "dense"])
def test_unported_methods_raise(box, method):
    """Once refused (hence the name), the "bvh" and "dense" methods now
    answer: ``scene_occluded`` equals the JAX package's on the glue
    scene's rays (K7's any-hit walk, K8's closest hit with t < t_max)."""
    _, ts, _ = box
    with pytest.raises(ValueError, match="no threaded BVH|no dense tables"):
        TTR.scene_occluded(ts, torch.ones(4, 3), torch.ones(4, 3),
                           torch.zeros(4), torch.ones(4), method)
    arrays, _, _ = jax_build_scene(jax_cornell(None, box_only=False),
                                   image_width=W, image_height=H,
                                   intersector=method)
    ts, _ = TB.build_scene(make_cornell_box_scene(None, box_only=False),
                           device="cpu", image_width=W, image_height=H,
                           intersector=method)
    o, d = _spread(ts, 3000, 9)
    tmin = np.zeros(len(o), np.float32)
    dist = np.full(len(o), np.float32(200.0))
    dist[::5] = 150.0
    want = jax.jit(lambda a, o, d, lo, hi: JTR.scene_occluded(
        a, o, d, lo, hi, method))(arrays, o, d, tmin, dist)
    got = TTR.scene_occluded(ts, _t(o), _t(d), _t(tmin), _t(dist), method)
    assert _equal(got, want) == 0
    assert 0 < int(got.sum()) < len(o)


# ---- 5. the kernels on the card ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("hbm", [False, True])
def test_cuda_intersect_kernels_match_plain(cuda_device, hbm):
    ts, params = TB.build_scene(make_cornell_box_scene(None, box_only=False),
                                device=cuda_device, image_width=W,
                                image_height=H,
                                intersector="pallas-hbm" if hbm else "pallas")
    o, d = _spread(ts.to("cpu"), 3000, 10)
    args = ik.intersect_inputs(_t(o).to(cuda_device), _t(d).to(cuda_device),
                               torch.zeros(3000, device=cuda_device),
                               torch.full((3000,), float("inf"),
                                          device=cuda_device))
    cull = super_cull_lists_bundle if hbm else ik.block_cull_lists_bundle
    lists = cull(ts, *args[:4], 3)
    kern = ih.super_walk_cuda if hbm else ik.dense_walk_cuda
    plain = ih.super_walk_ref if hbm else ik.dense_walk_ref
    got = kern(ts, *lists, args[4])
    torch.cuda.synchronize()
    for g, w in zip(got, plain(ts, *lists, args[4])):
        assert torch.equal(g, w)
