"""The ``"bvh"`` and ``"dense"`` intersectors on every route of the port
that takes ``intersector=``, against the JAX package with the same
intersector on the CPU (K7's and K8's plain versions):

* ``render(mode="shadow-trace")`` at 48x32 (the glue route: closest hit
  with ``hit_normal``, the shadow ray, the any hit): every AOV bit for
  bit;
* ``render_streaming``, the XLA-loop integrator (with no env, as the JAX
  package routes these intersectors), on the golden Cornell box 48x32
  spp 2, and on the Cornell box with its spheres and disc (and with the
  monkey): the image within path B's tolerance (rtol = atol = 1e-5,
  tests/test_torch_glue.py), ``done`` exact; and the
  port's own ``"dense"`` loop against its megakernel route, as
  tests/test_render_e2e.py holds the JAX package's pair;
* the per-sample wavefront, ``render(streaming=False)`` at 24x24 spp 2:
  bit for bit, as tests/test_torch_path_render.py holds the pallas route;
* a NIF on the XLA loop (spheres + urban_4k 16x16 spp 2 through
  ``"dense"``): the env term is the env MLP with the XLA env function's
  angles (``env_term``), held to the split tolerance of
  tests/test_torch_env.py;
* ``trace_torch.py --intersector bvh|dense`` in shadow-trace and
  path-trace mode: the EXR byte for byte ``trace.py``'s with the same
  flags, and a ``--scene-cache`` round trip under ``"bvh"``;
* ``render_shadow_sharded`` on 2 CPU shards equal to one call, and
  ``render_path_sharded`` on 2 shards equal to one ``path_chunk`` per
  shard.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import os

import numpy as np
import pytest
import torch

from ipu_ray_lib_tpu.nif.model import load_nif_env as jax_load_nif_env
from ipu_ray_lib_tpu.render.renderer import render as jax_render
from ipu_ray_lib_tpu.render.streaming import render_streaming as jax_streaming
from ipu_ray_lib_tpu.scene import builtin as JB
from ipu_ray_lib_tpu.scene.build import build_scene as jax_build_scene
import ipu_ray_lib_tpu_torch.render.streaming as TS
import ipu_ray_lib_tpu_torch.scene.build as TB
from ipu_ray_lib_tpu_torch.nif.model import load_nif_env
from ipu_ray_lib_tpu_torch.ops import bvh as TBVH
from ipu_ray_lib_tpu_torch.ops import dense as TD
from ipu_ray_lib_tpu_torch.ops import env as envk
from ipu_ray_lib_tpu_torch.ops import intersect_kernel as ik
from ipu_ray_lib_tpu_torch.ops.camera import generate_camera_rays
from ipu_ray_lib_tpu_torch.parallel import (make_ray_mesh,
                                            render_path_sharded,
                                            render_shadow_sharded)
from ipu_ray_lib_tpu_torch.render.renderer import path_chunk, render
from ipu_ray_lib_tpu_torch.render.shadow import shadow_trace
from ipu_ray_lib_tpu_torch.scene import builtin as PB
from ipu_ray_lib_tpu_torch.utils import threefry
from test_torch_env import hold_high_frequency, split
from torch_cli_pairs import PORT_CLI, run_pair, same_bytes

ROOT = os.path.join(os.path.dirname(__file__), "..")
URBAN = os.path.join(ROOT, "assets", "nif", "synthetic_urban_4k")
MONKEY = os.path.join(ROOT, "assets", "monkey_bust.glb")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "box48x32_spp2.npy")
FIELDS = ("rgb", "t", "geom_id", "prim_id", "normal", "hit_p")
METHODS = ("bvh", "dense")
TOL = dict(rtol=1e-5, atol=1e-5)


def _builds(method, size, box_only=False, spheres=False, **kw):
    """The Cornell box (or with ``spheres`` the NIF flagship's scene) built
    by both packages with ``method``."""
    w, h = size
    if spheres:
        jscene, pscene = JB.make_primitive_scene(), PB.make_primitive_scene()
    else:
        jscene = JB.make_cornell_box_scene(None, box_only=box_only)
        pscene = PB.make_cornell_box_scene(None, box_only=box_only)
    arrays, jparams, _ = jax_build_scene(jscene, image_width=w,
                                         image_height=h, intersector=method,
                                         **kw)
    ts, params = TB.build_scene(pscene, device="cpu", image_width=w,
                                image_height=h, intersector=method, **kw)
    assert params.intersector == method
    return arrays, jparams, ts, params


def _counts():
    return (TBVH.launches, TD.launches, ik.launches)


@pytest.mark.parametrize("method", METHODS)
def test_shadow_trace_matches_jax(method):
    arrays, jparams, ts, params = _builds(method, (48, 32))
    want = jax_render(arrays, jparams, mode="shadow-trace", chunk_size=512)
    before = _counts()
    got = render(ts, params, mode="shadow-trace", chunk_size=512)
    assert _counts() == before  # the plain versions on a CPU scene
    for f in FIELDS:
        a, b = getattr(got, f), np.asarray(getattr(want, f))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    assert got.hit_count == 729
    assert params.num_geoms - 1 in set(got.geom_id.ravel().tolist())


@pytest.mark.parametrize("method", METHODS)
def test_xla_loop_matches_jax(method):
    arrays, jparams, ts, params = _builds(method, (48, 32), box_only=True,
                                          samples_per_pixel=2)
    want, want_done = jax_streaming(arrays, jparams)
    stats = {}
    got, done = TS.render_streaming(ts, params, stats=stats)
    assert done == int(want_done) == 48 * 32 * 2
    np.testing.assert_allclose(got, want, **TOL)
    assert stats["iters"] > 2
    # Not the megakernel's image: another integrator, other random numbers.
    assert not np.allclose(got, np.load(GOLDEN), **TOL)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("mesh", [None, MONKEY], ids=["cornell", "monkey"])
def test_xla_loop_with_spheres_and_disc_matches_jax(method, mesh):
    """The XLA loop on the Cornell box with its spheres and disc, and with
    the monkey, whose scene makes the disc a light (its material follows
    the geometry id): the route whose mean sits above the megakernel's
    (tests/test_torch_coplanar_disc.py) equals the JAX package's."""
    w, h = (48, 32) if mesh is None else (32, 32)
    jscene = JB.make_cornell_box_scene(mesh, box_only=False)
    arrays, jparams, _ = jax_build_scene(jscene, image_width=w,
                                         image_height=h, intersector=method,
                                         samples_per_pixel=2)
    ts, params = TB.build_scene(PB.make_cornell_box_scene(mesh,
                                                          box_only=False),
                                device="cpu", image_width=w, image_height=h,
                                intersector=method, samples_per_pixel=2)
    want, want_done = jax_streaming(arrays, jparams)
    got, done = TS.render_streaming(ts, params)
    assert done == int(want_done) == w * h * 2
    np.testing.assert_allclose(got, want, **TOL)
    assert got.mean() > 0.01


def test_routes_follow_the_intersector():
    sky = lambda d: torch.ones_like(d)  # noqa: E731
    for method in ("pallas", "pallas-hbm"):
        assert TS.megakernel_route(method, None)
        assert not TS.megakernel_route(method, sky)
        assert TS.uses_megakernel(256, None, method)
    for method in METHODS:
        assert not TS.megakernel_route(method, None)
        assert not TS.uses_megakernel(256, None, method)


def test_dense_xla_loop_matches_own_megakernel():
    """The port's pair of tests/test_render_e2e.py: the megakernel and the
    XLA loop over the dense intersector trace the same estimator with the
    same seeds; the images agree closely, not only in distribution."""
    imgs = {}
    for method in ("pallas", "dense"):
        ts, params = TB.build_scene(PB.make_cornell_box_scene(None),
                                    device="cpu", image_width=48,
                                    image_height=32, samples_per_pixel=8,
                                    intersector=method)
        imgs[method], done = TS.render_streaming(ts, params, spp=8)
        assert done == 48 * 32 * 8
    a, b = imgs["pallas"], imgs["dense"]
    assert abs(a.mean() - b.mean()) / max(b.mean(), 1e-9) < 0.02
    d = np.abs(a - b).max(axis=-1)
    assert float(np.quantile(d, 0.99)) < 2e-2, float(np.quantile(d, 0.99))


@pytest.mark.parametrize("method", METHODS)
def test_per_sample_path_matches_jax(method):
    arrays, jparams, ts, params = _builds(method, (24, 24), box_only=True,
                                          samples_per_pixel=2)
    want = jax_render(arrays, jparams, mode="path-trace", chunk_size=256,
                      streaming=False)
    stats = {}
    got = render(ts, params, mode="path-trace", chunk_size=256,
                 streaming=False, stats=stats)
    assert np.array_equal(got.rgb, want.rgb)
    assert stats["errors"] == 0 and got.rgb.mean() > 0.01


def test_nif_on_the_xla_loop_holds_split_tolerance():
    arrays, jparams, ts, params = _builds("dense", (16, 16), spheres=True,
                                          samples_per_pixel=2)
    env_fn, env_params = jax_load_nif_env(URBAN)
    want, want_done = jax_streaming(arrays, jparams, env_fn=env_fn,
                                    env_params=env_params)
    env = load_nif_env(URBAN, device="cpu")
    calls = []
    saved = TS.env_mlp

    def recording(dirs, env_, exact_uv=False):
        calls.append(exact_uv)
        return saved(dirs, env_, exact_uv)

    TS.env_mlp = recording
    try:
        envk.reset_launches()
        got, done = TS.render_streaming(ts, params, env=env)
    finally:
        TS.env_mlp = saved
    assert done == int(want_done) == 16 * 16 * 2
    assert calls and all(calls)  # the XLA env function's angles
    assert envk.launches == 0
    assert got.mean() > 0.1 and np.isfinite(got).all()
    hold_high_frequency(split(got, want))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("mode", ["shadow-trace", "path-trace"])
def test_cli_exr_equals_trace_py(tmp_path, method, mode):
    if mode == "shadow-trace":
        argv, vis = ["--scene", "box-simple", "-w", "16", "-H", "16",
                     "--render-mode", "shadow-trace", "--visualise",
                     "normal", "--chunk-size", "256"], "normal"
    else:  # one device: the JAX side sees the conftest's 8
        argv, vis = ["--scene", "box", "-w", "8", "-H", "8", "--samples",
                     "2", "--tpu-only", "--devices", "1"], "rgb"
    pairs = run_pair(tmp_path, argv, vis, intersector=method)
    assert pairs
    for kind in pairs:
        assert same_bytes(*pairs[kind]), kind


def test_cli_scene_cache_round_trip_under_bvh(tmp_path):
    cache = str(tmp_path / "cache")
    argv = ["--scene", "box-simple", "-w", "16", "-H", "16", "--render-mode",
            "shadow-trace", "--visualise", "normal", "--intersector", "bvh",
            "--chunk-size", "256", "--gpu-only", "--device", "cpu",
            "--scene-cache", cache,
            "--log-level", "warn"]
    a = PORT_CLI.run(argv + ["-o", str(tmp_path / "a")])
    b = PORT_CLI.run(argv + ["-o", str(tmp_path / "b")])
    assert not a["cache_hit"] and b["cache_hit"]
    assert b["params"].intersector == "bvh"
    assert same_bytes(a["outputs"]["gpu"], b["outputs"]["gpu"])


def test_compiled_scene_bundle_carries_bvh_leaves(tmp_path):
    from ipu_ray_lib_tpu_torch.scene.cache import (load_compiled_scene,
                                                   save_compiled_scene)

    ts, params = TB.build_scene(PB.make_cornell_box_scene(None), device="cpu",
                                image_width=16, image_height=16,
                                intersector="bvh")
    path = str(tmp_path / "scene.bin")
    save_compiled_scene(path, ts, params)
    got, got_params = load_compiled_scene(path, "cpu")
    assert got_params == params
    for k in TB.BVH_DENSE_LEAVES:
        assert torch.equal(getattr(got, k), getattr(ts, k)), k


def _camera(params, n):
    rows = torch.arange(n, dtype=torch.float32) // params.image_width
    cols = torch.arange(n, dtype=torch.float32) % params.image_width
    return rows, cols


@pytest.mark.parametrize("method", METHODS)
def test_shadow_sharded_equals_one_call(method):
    ts, params = TB.build_scene(PB.make_cornell_box_scene(None), device="cpu",
                                image_width=32, image_height=16,
                                intersector=method)
    rows, cols = _camera(params, 512)
    got = render_shadow_sharded(ts, params, rows.numpy(), cols.numpy(),
                                make_ray_mesh(["cpu"] * 2))
    _, d = generate_camera_rays(rows, cols, params.image_width,
                                params.image_height, params.fov_radians)
    want = shadow_trace(ts.to("cpu"), None, d, intersector=method)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(want.escaped.sum()) < 512


def test_path_sharded_equals_its_chunks():
    ts, params = TB.build_scene(PB.make_cornell_box_scene(None), device="cpu",
                                image_width=16, image_height=16,
                                samples_per_pixel=2, intersector="bvh")
    rows, cols = _camera(params, 256)
    key = threefry.PRNGKey(7)
    got = render_path_sharded(ts, params, rows.numpy(), cols.numpy(), key,
                              make_ray_mesh(["cpu"] * 2))
    want = torch.cat([path_chunk(ts, params, rows[i * 128:(i + 1) * 128],
                                 cols[i * 128:(i + 1) * 128],
                                 threefry.fold_in(key, i))[0]
                      for i in range(2)])
    assert torch.equal(got, want)
    assert float(got.mean()) > 0.0
