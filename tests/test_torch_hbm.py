"""The port's HBM mode (``intersector="pallas-hbm"``, kernel K3's plain
version) against the JAX package on the CPU.

* The HBM tables: ``saabb``, ``sgaabb`` and ``baabb`` equal the JAX
  package's bit for bit, and the port's ``p``/``nrm`` equal what the JAX
  ``pn8`` (and, with the payload split forced, the bf16 ``pay8``) hold,
  with the VMEM ceiling lowered in both packages so the JAX build skips
  its own ``p``/``nrm`` (as tests/test_hbm.py does).
* ``from_jax_arrays`` carries such a build across and renders as the
  port's own build.
* Renders equal the JAX ``render_streaming`` in HBM mode (interpret mode)
  at rtol = atol = 1e-5: the stress golden, the Cornell box, the split
  payload, a scene just past the VMEM ceiling picked by ``"auto"``.
* The mode is honoured: on a mesh with vertex normals each mode of the
  port equals the JAX package's, and the VMEM payload (bf16
  barycentrics) and the HBM payload (f32) send paths in different
  directions. (The Cornell box and the stress terrain have no vertex
  normals, so there the two modes agree bit for bit.)
* NIF-lit HBM renders hold the split tolerance of tests/test_torch_env.py
  (the module note there says why not 1e-5).
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax

import ipu_ray_lib_tpu.render.streaming as JS
import ipu_ray_lib_tpu.scene.types as JT
from ipu_ray_lib_tpu.nif.model import load_nif_env as jax_load_nif_env
from ipu_ray_lib_tpu.ops.pallas import tables as JTBL
from ipu_ray_lib_tpu.scene.build import build_scene as jax_build_scene
from ipu_ray_lib_tpu.scene.builtin import make_cornell_box_scene as jax_cornell
from ipu_ray_lib_tpu.scene.builtin import make_stress_scene as jax_stress
import ipu_ray_lib_tpu_torch.render.streaming as TS
from ipu_ray_lib_tpu_torch.render.pixels import pixel_stream
import ipu_ray_lib_tpu_torch.scene.build as TB
import ipu_ray_lib_tpu_torch.scene.types as TT
from ipu_ray_lib_tpu_torch.nif.model import load_nif_env
from ipu_ray_lib_tpu_torch.ops import megakernel as mk
from ipu_ray_lib_tpu_torch.ops.tables import HBM_SPLIT_MIN_TRIS, bf16_round
from ipu_ray_lib_tpu_torch.scene.builtin import (make_cornell_box_scene,
                                                 make_stress_scene)

from test_torch_env import hold_high_frequency, split
from test_torch_tables import BVH_LEAVES, bvh_leaves_beside

ROOT = os.path.join(os.path.dirname(__file__), "..")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "stress24_hbm32x32_spp2.npy")
URBAN = os.path.join(ROOT, "assets", "nif", "synthetic_urban_4k")
TOL = dict(rtol=1e-5, atol=1e-5)
LOW_CEILING = 8  # below both scenes' triangle counts

SCENES = {
    "stress24": (lambda: jax_stress(24), lambda: make_stress_scene(24)),
    "cornell": (lambda: jax_cornell(None, box_only=False),
                lambda: make_cornell_box_scene(None, box_only=False)),
}


def _jax_leaves(arrays) -> dict:
    leaves = {k: np.asarray(v) for k, v in arrays._asdict().items()
              if k not in ("dense", "blocked")}
    leaves.update({k: np.asarray(v) for k, v in arrays.blocked._asdict().items()
                   if v is not None})
    return leaves


def _builds(name, split_payload, **kw):
    """(JAX arrays, JAX params, port leaves, port params) of one scene in
    HBM mode with the VMEM ceiling lowered in both packages; with
    ``split_payload`` the JAX payload goes to pay8 and the port rounds."""
    jscene, tscene = SCENES[name]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JTBL, "VMEM_TABLE_MAX_TRIS", LOW_CEILING)
        mp.setattr(TB, "VMEM_TABLE_MAX_TRIS", LOW_CEILING)
        mp.setenv("RAY_HBM_SPLIT", "1" if split_payload else "0")
        arrays, jparams, _ = jax_build_scene(jscene(), intersector="pallas-hbm",
                                             **kw)
        leaves, tparams = TB.compile_scene(
            tscene(), window=None, intersector="pallas-hbm",
            payload_split=split_payload, **kw)
    return arrays, jparams, leaves, tparams


def _bits(a):
    a = np.ascontiguousarray(np.asarray(a))
    return a.dtype, a.shape, a.view(np.uint8).tobytes()


@pytest.mark.parametrize("name,split_payload", [
    ("stress24", False), ("stress24", True), ("cornell", False),
    ("cornell", True)])
def test_hbm_tables_match_jax(name, split_payload):
    arrays, _, leaves, _ = _builds(name, split_payload, image_width=8,
                                   image_height=8, samples_per_pixel=1)
    t = arrays.blocked
    assert t.p is None and t.nrm is None
    assert (t.pay8 is not None) == split_payload
    for k in ("saabb", "sgaabb", "baabb"):
        assert _bits(leaves[k]) == _bits(getattr(t, k)), k
    ns = t.num_supers
    assert leaves["saabb"].shape == (ns, 8)
    assert leaves["sgaabb"].shape == (-(-ns // 8), 8)
    p, nrm = TB.unpack_super_slabs(np.asarray(t.pn8), t.pay8)
    assert _bits(leaves["p"]) == _bits(p)
    assert _bits(leaves["nrm"]) == _bits(nrm)
    if split_payload:  # the fused build's values, rounded to bf16
        _, _, fused, _ = _builds(name, False, image_width=8, image_height=8,
                                 samples_per_pixel=1)
        assert _bits(leaves["nrm"]) == _bits(bf16_round(fused["nrm"]))
        assert not np.array_equal(fused["nrm"], leaves["nrm"])


def test_bf16_round_is_round_to_nearest_even():
    """bf16 keeps 7 mantissa bits: near 1 its step is 2**-7. Halfway cases
    go to the even neighbour, as the JAX package's ml_dtypes cast does."""
    u = 2.0 ** -7
    x = np.array([1.0, 1 + u / 2, 1 + 3 * u / 4, 1 + 5 * u / 4,
                  1 + 3 * u / 2, -(1 + u / 2), 0.0, -0.0, np.inf], np.float32)
    want = np.array([1.0, 1.0, 1 + u, 1 + u, 1 + 2 * u, -1.0, 0.0, -0.0,
                     np.inf], np.float32)
    assert _bits(bf16_round(x)) == _bits(want)
    assert np.isnan(bf16_round(np.array([np.nan], np.float32))).all()


@pytest.mark.parametrize("name,split_payload", [("stress24", False),
                                                ("cornell", True)])
def test_from_jax_arrays_unpacks_super_slabs(name, split_payload):
    kw = dict(image_width=24, image_height=24, samples_per_pixel=1)
    arrays, _, leaves, tparams = _builds(name, split_payload, **kw)
    carried = TB.from_jax_arrays(_jax_leaves(arrays), "cpu")
    own = TB._from_leaves(leaves, "cpu")
    assert bvh_leaves_beside(carried, own) == BVH_LEAVES
    for f in dataclasses.fields(own):
        got, want = getattr(carried, f.name), getattr(own, f.name)
        if f.name in BVH_LEAVES:
            continue
        if isinstance(want, torch.Tensor):
            assert torch.equal(got, want), f.name
        else:
            assert got == want, f.name
    got, d1 = TS.render_streaming(carried, tparams)
    want, d2 = TS.render_streaming(own, tparams)
    assert d1 == d2 == 24 * 24
    np.testing.assert_array_equal(got, want)


def test_render_reproduces_stress_golden():
    ts, params = TB.build_scene(make_stress_scene(24), device="cpu",
                                image_width=32, image_height=32,
                                samples_per_pixel=2, max_path_length=4,
                                intersector="pallas-hbm")
    assert params.intersector == "pallas-hbm"
    mk.reset_launches()
    rgb, done = TS.render_streaming(ts, params)
    assert done == 32 * 32 * 2 and mk.hbm_launches == mk.launches == 0
    np.testing.assert_allclose(rgb, np.load(GOLDEN), **TOL)


def test_cornell_hbm_matches_jax():
    arrays, jparams, _ = jax_build_scene(
        jax_cornell(None, box_only=False), image_width=48, image_height=48,
        samples_per_pixel=2, intersector="pallas-hbm")
    want, want_done = JS.render_streaming(arrays, jparams, spp=2)
    ts, params = TB.build_scene(make_cornell_box_scene(None, box_only=False),
                                device="cpu", image_width=48, image_height=48,
                                samples_per_pixel=2, intersector="pallas-hbm")
    rgb, done = TS.render_streaming(ts, params)
    assert done == want_done == 48 * 48 * 2
    np.testing.assert_allclose(rgb, np.asarray(want), **TOL)


def _smooth_scene(T):
    """A UV sphere mesh with vertex normals on a floor under an emissive
    quad, built with the scene types of package ``T``: its shading normal
    depends on the barycentrics."""
    n_lat, n_lon, r, c = 6, 10, 1.0, np.array([0.0, -0.4, -3.2])
    # Open at the poles: a pole's ring of f32 vertices 1e-17 apart would
    # make sliver triangles with vanishing barycentric gradients, which
    # the tables' watertight test accepts anywhere on their planes.
    th = np.linspace(0.25, np.pi - 0.25, n_lat + 1)
    ph = np.linspace(0.0, 2 * np.pi, n_lon + 1)[:-1]
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    nrm = np.stack([np.sin(tt) * np.cos(pp), np.cos(tt),
                    np.sin(tt) * np.sin(pp)], -1).reshape(-1, 3)
    idx = np.arange((n_lat + 1) * n_lon).reshape(n_lat + 1, n_lon)
    nx = np.roll(idx, -1, axis=1)
    a, b, cc, d = idx[:-1], idx[1:], nx[:-1], nx[1:]
    tris = np.concatenate([np.stack([a, b, cc], -1).reshape(-1, 3),
                           np.stack([b, d, cc], -1).reshape(-1, 3)])
    sphere = T.HostMesh(triangles=tris, vertices=c + r * nrm,
                        normals=nrm.astype(np.float32))
    quad = np.array([[0, 1, 2], [0, 2, 3]])
    floor = T.HostMesh(triangles=quad, vertices=np.array(
        [[-6, -1.4, 0], [6, -1.4, 0], [6, -1.4, -12], [-6, -1.4, -12]]))
    light = T.HostMesh(triangles=quad, vertices=np.array(
        [[-1.5, 2.5, -2], [1.5, 2.5, -2], [1.5, 2.5, -5], [-1.5, 2.5, -5]]))
    scene = T.SceneDescription()
    scene.meshes = [sphere, floor, light]
    zero = np.zeros(3, np.float32)
    scene.materials = [
        T.Material(np.array([0.75, 0.75, 0.75], np.float32), zero,
                   T.MaterialType.DIFFUSE),
        T.Material(np.array([0.5, 0.45, 0.4], np.float32), zero,
                   T.MaterialType.DIFFUSE),
        T.Material(np.array([0.78, 0.78, 0.78], np.float32),
                   np.array([12.0, 12.0, 12.0], np.float32),
                   T.MaterialType.DIFFUSE)]
    scene.mat_ids = [0, 1, 2]
    scene.camera = T.Camera(horizontal_fov=float(np.pi / 3))
    scene.validate()
    return scene


def test_hbm_mode_is_honoured():
    """On a mesh with vertex normals each mode of the port equals the JAX
    package's, and the modes differ in the port's path records: the
    escape directions follow the shading normal, whose barycentrics are
    bf16 in VMEM mode and f32 in HBM mode. (The images agree here: this
    renderer's path radiance is piecewise constant in the directions.)"""
    kw = dict(image_width=16, image_height=16, samples_per_pixel=2)
    arrays, jparams, _ = jax_build_scene(_smooth_scene(JT),
                                         intersector="pallas-hbm", **kw)
    ts, tparams = TB.build_scene(_smooth_scene(TT), device="cpu",
                                 intersector="pallas-hbm", **kw)
    records = {}
    for mode in ("pallas", "pallas-hbm"):
        params = dataclasses.replace(tparams, intersector=mode)
        want, wd = JS.render_streaming(
            arrays, dataclasses.replace(jparams, intersector=mode), spp=2)
        got, gd = TS.render_streaming(ts, params)
        assert gd == wd == 16 * 16 * 2
        np.testing.assert_allclose(got, np.asarray(want), **TOL)
        assert got.mean() > 0.05
        rows, cols = pixel_stream(params).coords(torch.device("cpu"), 256)
        rec, done = mk.trace_records(
            ts, rows, cols, 1442, 256, params=params, slots=256,
            j_per_slot=1, spp=2, max_iters=2 * params.max_path_length + 16)
        records[mode] = rec[7:10][:, mk.escaped_records(rec, done)]
    v, h = records["pallas"], records["pallas-hbm"]
    assert v.shape == h.shape and v.shape[1] > 100
    assert int((v != h).any(dim=0).sum()) > v.shape[1] // 10  # 95 of 506


@pytest.mark.parametrize("name", ["stress24", "cornell"])
def test_split_payload_matches_jax(name):
    kw = dict(image_width=32, image_height=32, samples_per_pixel=2,
              max_path_length=4)
    arrays, jparams, leaves, tparams = _builds(name, True, **kw)
    assert arrays.blocked.pay8 is not None
    want, want_done = JS.render_streaming(arrays, jparams, spp=2)
    rgb, done = TS.render_streaming(TB._from_leaves(leaves, "cpu"), tparams)
    assert done == want_done == 32 * 32 * 2
    np.testing.assert_allclose(rgb, np.asarray(want), **TOL)
    if name == "cornell":  # the rounded albedo shows (the terrain's light
        # paths never bounce, so stress24 shows none)
        _, _, fused, _ = _builds(name, False, **kw)
        own, _ = TS.render_streaming(TB._from_leaves(fused, "cpu"), tparams)
        assert not np.allclose(own, rgb, **TOL)


def test_auto_picks_hbm_past_the_ceiling(monkeypatch):
    """66,248 triangles + 1 disc: "auto" resolves to "pallas-hbm" in the
    port and in the JAX package (its accelerator rule; on the CPU backend
    it would pick its jnp BVH), and the renders agree."""
    scene = make_stress_scene(183)
    assert len(scene.meshes[0].triangles) == 66248
    with monkeypatch.context() as mp:
        mp.setattr(jax, "default_backend", lambda: "tpu")
        arrays, jparams, _ = jax_build_scene(jax_stress(183), image_width=8,
                                             image_height=8,
                                             samples_per_pixel=1)
    ts, params = TB.build_scene(scene, device="cpu", image_width=8,
                                image_height=8, samples_per_pixel=1)
    assert params.intersector == jparams.intersector == "pallas-hbm"
    assert arrays.blocked.p is None  # the JAX build is past its ceiling
    rgb, done = TS.render_streaming(ts, params)
    want, want_done = JS.render_streaming(arrays, jparams, spp=1)
    assert done == want_done == 64
    np.testing.assert_allclose(rgb, np.asarray(want), **TOL)


@pytest.mark.parametrize("grid", [24, 183])
def test_stress_scene_matches_jax(grid):
    """The port's copy of ``make_stress_scene`` is the JAX package's scene,
    bit for bit (geometry, the disc light, materials, camera)."""
    j, t = jax_stress(grid), make_stress_scene(grid)
    assert len(j.meshes) == len(t.meshes) == 1
    for f in ("triangles", "vertices", "normals"):
        assert _bits(getattr(j.meshes[0], f)) == _bits(getattr(t.meshes[0], f)), f
    assert _bits(j.spheres) == _bits(t.spheres)
    assert _bits(j.discs) == _bits(t.discs)
    assert list(j.mat_ids) == list(t.mat_ids)
    assert len(j.materials) == len(t.materials) == 2
    for a, b in zip(j.materials, t.materials):
        assert _bits(a.albedo) == _bits(b.albedo)
        assert _bits(a.emission) == _bits(b.emission)
        assert (int(a.type), a.ior) == (int(b.type), b.ior)
    assert j.camera.horizontal_fov == t.camera.horizontal_fov
    assert j.camera.matrix is None and t.camera.matrix is None
    assert len(t.meshes[0].triangles) == 2 * (grid - 1) ** 2


def test_build_accepts_the_grid512_rung():
    leaves, params = TB.compile_scene(make_stress_scene(512), image_width=8,
                                      image_height=8, window=None,
                                      samples_per_pixel=1)
    assert params.intersector == "pallas-hbm"
    assert int((leaves["tri_geom"] >= 0).sum()) == 522242
    assert leaves["baabb"].shape == (4088, 8)
    assert leaves["saabb"].shape == (511, 8)
    assert leaves["sgaabb"].shape == (64, 8)
    # 523,264 padded rows, below HBM_SPLIT_MIN_TRIS: the payload stays f32
    assert leaves["p"].shape[0] < HBM_SPLIT_MIN_TRIS
    assert not (leaves["nrm"] == bf16_round(leaves["nrm"])).all()
    assert TB.resolve_intersector("auto", 65536) == "pallas"
    assert TB.resolve_intersector("auto", 65537) == "pallas-hbm"


@pytest.mark.parametrize("name", ["dense", "bvh", "vmem"])
def test_unported_intersectors_are_refused(name):
    """Once refused (hence the name), "dense" and "bvh" now build their
    tables (the threaded BVH, the geometry, the dense rows) beside the
    HBM-mode blocked tables; an unknown name is refused."""
    if name == "vmem":
        with pytest.raises(ValueError, match="unknown"):
            TB.build_scene(make_stress_scene(8), device="cpu", image_width=8,
                           image_height=8, intersector=name)
    else:
        ts, params = TB.build_scene(make_stress_scene(8), device="cpu",
                                    image_width=8, image_height=8,
                                    intersector=name)
        assert params.intersector == name and ts.pbox is None
        assert ts.bvh_nodes.shape == (params.num_bvh_nodes, 8)
        assert ts.dense_rows.shape == (512, 16)
        assert int((ts.dense_geom[:98] == 0).sum()) == 98
    with pytest.raises(ValueError, match="HBM-mode"):
        TB.build_scene(make_stress_scene(8), device="cpu", image_width=8,
                       image_height=8, intersector="pallas",
                       payload_split=True)


def test_hbm_walk_counts_each_level():
    """The plain walk's counts at each level (what chip_smoke.py bounds
    K3 with): every segment tests every group; a block is refined only
    inside an admitted super, and walked only where it passed."""
    ts, params = TB.build_scene(make_stress_scene(64), device="cpu",
                                image_width=16, image_height=16,
                                samples_per_pixel=1, max_path_length=3,
                                intersector="pallas-hbm")
    R, J = TS.slot_pool(256, 1 << 17)
    rows, cols = pixel_stream(params).coords(torch.device("cpu"), R * J)
    kw = dict(params=params, slots=R, j_per_slot=J, spp=1,
              max_iters=J * params.max_path_length + 16)
    stats = {}
    flat, done = mk.megakernel_path_trace_ref(ts, rows, cols, 1442, 256,
                                              stats=stats, **kw)
    ng, ns = ts.sgaabb.shape[0], ts.saabb.shape[0]
    assert stats["group_tests"] == stats["segments"] * ng
    assert 0 < stats["super_tests"] <= stats["segments"] * ns
    assert 0 < stats["block_tests"] <= stats["member_tests"]
    assert stats["member_tests"] % 8 == 0
    vmem = {}
    flat_v, _ = mk.megakernel_path_trace_ref(
        ts, rows, cols, 1442, 256, stats=vmem,
        **{**kw, "params": dataclasses.replace(params, intersector="pallas")})
    assert vmem["segments"] == stats["segments"]
    assert stats["block_tests"] <= vmem["block_tests"]  # the refinement
    assert torch.equal(flat, flat_v)  # flat-shaded terrain: same image
    assert int(done) == 256


def test_slot0_replays_a_pools_middle_slots():
    """A pool's slots [s0, s0+n) replayed as a pool of n slots with
    ``slot0=s0`` (their pids) give those slots' pixels bit for bit."""
    ts, params = TB.build_scene(make_cornell_box_scene(None, box_only=False),
                                device="cpu", image_width=32, image_height=32,
                                samples_per_pixel=2, max_path_length=3,
                                intersector="pallas-hbm")
    rows, cols = pixel_stream(params).coords(torch.device("cpu"), 1024)
    kw = dict(params=params, spp=2, j_per_slot=1,
              max_iters=2 * params.max_path_length + 16)
    full, _ = mk.megakernel_path_trace_ref(ts, rows, cols, 9, 1024,
                                           slots=1024, **kw)
    s0, n = 600, 64
    part, done = mk.megakernel_path_trace_ref(
        ts, rows[s0:s0 + n], cols[s0:s0 + n], 9, n, slots=n, slot0=s0, **kw)
    assert int(done) == 2 * n
    assert torch.equal(part, full[s0:s0 + n])
    assert full[s0:s0 + n].any()
    shifted, _ = mk.megakernel_path_trace_ref(
        ts, rows[s0:s0 + n], cols[s0:s0 + n], 9, n, slots=n, **kw)
    assert not torch.equal(shifted, part)


@pytest.fixture(scope="module")
def urban():
    return load_nif_env(URBAN, device="cpu")


def test_hbm_env_holds_jax_split_tolerance(urban):
    """stress24 in HBM mode lit by urban_4k, 48x32 spp 2 (record mode, the
    env MLP and the bank on the HBM walk). Measured: 59% of the elements
    within rtol 1e-5, 99.2% within rtol 1e-2, the largest relative
    difference 1.9e-2, the image mean 1.7e-5 relative off."""
    env_fn, env_params = jax_load_nif_env(URBAN)
    arrays, jparams, _ = jax_build_scene(jax_stress(24), image_width=48,
                                         image_height=32, samples_per_pixel=2,
                                         intersector="pallas-hbm")
    want, want_done = JS.render_streaming(arrays, jparams, spp=2,
                                          env_fn=env_fn,
                                          env_params=env_params)
    ts, params = TB.build_scene(make_stress_scene(24), device="cpu",
                                image_width=48, image_height=32,
                                samples_per_pixel=2, intersector="pallas-hbm")
    rgb, done = TS.render_streaming(ts, params, env=urban)
    assert done == want_done == 48 * 32 * 2
    hold_high_frequency(split(rgb, np.asarray(want)))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_hbm_route_matches_plain(cuda_device):
    ts, params = TB.build_scene(make_stress_scene(64), device=cuda_device,
                                image_width=32, image_height=32,
                                samples_per_pixel=2, intersector="pallas-hbm")
    R, J = TS.slot_pool(32 * 32, 1 << 17)
    rows, cols = pixel_stream(params).coords(cuda_device, R * J)
    kw = dict(params=params, slots=R, j_per_slot=J, spp=2,
              max_iters=J * 2 * params.max_path_length + 16)
    mk.reset_launches()
    flat, done = mk.megakernel_path_trace(ts, rows, cols, 1442, 1024, **kw)
    torch.cuda.synchronize()
    assert (mk.hbm_launches, mk.launches) == (1, 0)
    ref, dref = mk.megakernel_path_trace_ref(ts, rows, cols, 1442, 1024, **kw)
    assert int(done) == int(dref) == 2048
    assert torch.equal(flat, ref)


@pytest.mark.cuda
def test_cuda_hbm_walks_agree_and_count(cuda_device):
    """K3's warp walk and the plain walk give the same accumulator bit for
    bit, with and without counting and on a pool that is not whole warps,
    and a counting launch counts the plain version's walk exactly:
    segments, slab tests at each level, blocks walked."""
    from ipu_ray_lib_tpu_torch.ops.cuda.build import COUNTERS

    ts, params = TB.build_scene(make_stress_scene(64), device=cuda_device,
                                image_width=32, image_height=32,
                                samples_per_pixel=2, intersector="pallas-hbm")
    R, J = TS.slot_pool(32 * 32, 1 << 17)
    rows, cols = pixel_stream(params).coords(cuda_device, R * J)
    kw = dict(params=params, slots=R, j_per_slot=J, spp=2,
              max_iters=J * 2 * params.max_path_length + 16)
    walk = {}
    ref, dref = mk._trace(mk._accumulate_plain, ts, rows, cols, 1442, 1024,
                          stats=walk, **kw)
    counters = torch.zeros(len(COUNTERS), dtype=torch.int64,
                           device=cuda_device)
    for c in (None, counters):
        acc, done = mk._trace(mk._accumulate_cuda, ts, rows, cols, 1442,
                              1024, counters=c, **kw)
        assert torch.equal(acc, ref)
        assert torch.equal(done.long(), dref.long())
    got = dict(zip(COUNTERS, counters.tolist()))
    for k in ("segments", "group_tests", "super_tests", "member_tests"):
        assert got[k] == walk[k], k
    assert got["lane_blocks"] == walk["block_tests"]
    assert 0 < got["union_blocks"] <= got["lane_blocks"]
    assert got["warp_lanes"] == got["segments"]
    # A pool that is not whole warps: the lanes past it join the walk.
    kw1000 = dict(kw, slots=1000)
    acc, done = mk._trace(mk._accumulate_cuda, ts, rows[:1000], cols[:1000],
                          1442, 1000, **kw1000)
    ref, dref = mk._trace(mk._accumulate_plain, ts, rows[:1000],
                          cols[:1000], 1442, 1000, **kw1000)
    assert torch.equal(acc, ref)
    assert torch.equal(done.long(), dref.long())
