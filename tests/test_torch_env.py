"""The port's NIF-lit path (spheres scene + environment MLP) on the CPU.

* ``make_primitive_scene`` gives the JAX package's tables bit for bit.
* Record -> bank with the env term left out equals K1's direct banking
  bit for bit on the golden box scene: the bank adds a slot's paths in
  the reference's order (tests/test_torch_env_bank.py).
* ``render_streaming(env=...)`` against the JAX package: ``done`` exact;
  the image within a split tolerance, whose reason follows.

Why a split tolerance. The env's features scale the equirect coordinate
by up to 2^(E-1) (2,048 for the E = 12 urban_4k NIF), so one ulp in an
escape direction or in un/vn becomes about 1e-4 in the features and in
the env radiance. The JAX golden is the jitted megakernel, and XLA's
jitted code rounds otherwise than the same jnp ops run one by one, which
the port follows. test_golden_gap_is_the_jitted_rounding takes the gap
apart on the golden's own render: 56% of the port's escape directions
differ from the JAX kernel's by a few ulps (the shading math); the UV map
differs as jitted (tests/test_torch_nif.py); the MLP sums in XLA's
order. Given the port's own escape directions, with the UV rounded as
jitted, the port's env term meets the 1e-5 split (at least 99% within
rtol 1e-5, all within 5e-2) against the jitted JAX env branch. So,
measured on the golden (spheres + urban_4k, 48x32 spp 2): 2,000 of 4,608
elements outside rtol 1e-5, 98.6% within rtol 1e-2, the largest relative
difference 2.37e-2, the image mean 4.3e-7 relative off. With a
low-frequency NIF (E = 2, built here from a numpy seed) the same render
stays within rtol 1e-5 in all but 3 of 2,304 elements (largest 9.8e-4):
the wiring (escape flag, throughput, env term, BGR order, rotation,
skip-concat) is the reference's.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

import ipu_ray_lib_tpu.render.streaming as JS
from ipu_ray_lib_tpu.nif.model import (NifConfig as JNifConfig, NifModel,
                                       load_nif_env as jax_load_nif_env)
from ipu_ray_lib_tpu.ops.pallas import megakernel as JM
from ipu_ray_lib_tpu.ops.pallas.megakernel import _analytic_tables
from ipu_ray_lib_tpu.scene.build import build_scene as jax_build_scene
from ipu_ray_lib_tpu.scene.builtin import make_primitive_scene as jax_prim
import ipu_ray_lib_tpu_torch.render.streaming as TS
from ipu_ray_lib_tpu_torch.render.pixels import pixel_stream
from ipu_ray_lib_tpu_torch.nif.model import (atan2_poly, from_jax_params,
                                             load_nif_env)
from ipu_ray_lib_tpu_torch.ops import env as envk
from ipu_ray_lib_tpu_torch.ops import megakernel as mk
from ipu_ray_lib_tpu_torch.scene.build import build_scene, compile_scene
from ipu_ray_lib_tpu_torch.scene.builtin import (make_cornell_box_scene,
                                                 make_primitive_scene)

ROOT = os.path.join(os.path.dirname(__file__), "..")
URBAN = os.path.join(ROOT, "assets", "nif", "synthetic_urban_4k")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "spheres_nif48x32_spp2.npy")


def split(got, want) -> dict:
    """The share of elements within rtol 1e-5 (atol 1e-5) and 1e-2, the
    largest relative difference and the relative difference of the
    image means."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    return dict(within_1e5=float(np.isclose(got, want, rtol=1e-5,
                                            atol=1e-5).mean()),
                within_1e2=float((rel <= 1e-2).mean()),
                max_rel=float(rel.max()),
                mean_rel=abs(float(got.mean()) / float(want.mean()) - 1.0))


def hold_high_frequency(s: dict):
    """urban_4k (E = 12) against the JAX package (see the module note)."""
    assert s["within_1e2"] >= 0.98, s
    assert s["max_rel"] <= 5e-2, s
    assert s["mean_rel"] <= 5e-4, s


@pytest.fixture(scope="module")
def urban():
    return load_nif_env(URBAN, device="cpu")


def test_primitive_scene_tables_match_jax():
    arrays, jparams, _ = jax_build_scene(jax_prim(), image_width=24,
                                         image_height=16, samples_per_pixel=2,
                                         intersector="pallas")
    ts, tparams = build_scene(make_primitive_scene(), device="cpu",
                              image_width=24, image_height=16,
                              samples_per_pixel=2)
    for name in ("p", "nrm", "baabb"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(arrays.blocked, name)))
    ap, apay, n_ap = _analytic_tables(arrays)
    assert ts.n_ap == n_ap == 8
    np.testing.assert_array_equal(ts.ap.numpy(), np.asarray(ap))
    np.testing.assert_array_equal(ts.apay.numpy(), np.asarray(apay))
    j, t = dataclasses.asdict(jparams), dataclasses.asdict(tparams)
    assert j == t
    leaves, _ = compile_scene(make_primitive_scene(), image_width=24,
                              image_height=16, window=None,
                              samples_per_pixel=2)
    assert int((leaves["tri_geom"] >= 0).sum()) == 0  # no triangles


def _stream(params):
    n_pix = params.window_w * params.window_h
    R, J = TS.slot_pool(n_pix, 1 << 17)
    rows, cols = pixel_stream(params).coords(torch.device("cpu"), R * J)
    kw = dict(params=params, slots=R, j_per_slot=J,
              spp=params.samples_per_pixel,
              max_iters=J * params.samples_per_pixel * params.max_path_length
              + 16)
    return rows, cols, n_pix, kw


def test_render_holds_spheres_nif_golden(urban):
    ts, params = build_scene(make_primitive_scene(), device="cpu",
                             image_width=48, image_height=32,
                             samples_per_pixel=2)
    mk.reset_launches()
    envk.reset_launches()
    rgb, done = TS.render_streaming(ts, params, env=urban)
    assert (mk.launches, mk.bank_launches, envk.launches) == (0, 0, 0)
    assert done == 48 * 32 * 2
    assert rgb.shape == (32, 48, 3) and np.isfinite(rgb).all()
    hold_high_frequency(split(rgb, np.load(GOLDEN)))


def test_spheres_without_env_are_black():
    ts, params = build_scene(make_primitive_scene(), device="cpu",
                             image_width=16, image_height=16,
                             samples_per_pixel=2)
    rgb, done = TS.render_streaming(ts, params)
    assert done == 16 * 16 * 2 and not rgb.any()


@pytest.fixture(scope="module")
def urban_jax_pool512():
    """The JAX render of spheres + urban_4k at 48x32 spp 2 with a slot
    pool of 512 (J = 3): another pool, stream split and seed layout than
    the golden's."""
    env_fn, env_params = jax_load_nif_env(URBAN)
    arrays, params, _ = jax_build_scene(jax_prim(), image_width=48,
                                        image_height=32, samples_per_pixel=2,
                                        intersector="pallas")
    rgb, done = JS.render_streaming(arrays, params, chunk_slots=512, spp=2,
                                    env_fn=env_fn, env_params=env_params)
    return np.asarray(rgb), done


def test_render_matches_jax_urban_small_pool(urban, urban_jax_pool512):
    """Measured: 2,017 of 4,608 elements outside rtol 1e-5, 98.7% within
    rtol 1e-2, the largest relative difference 2.7e-2, the image mean
    1.9e-5 relative off."""
    want, want_done = urban_jax_pool512
    ts, params = build_scene(make_primitive_scene(), device="cpu",
                             image_width=48, image_height=32,
                             samples_per_pixel=2)
    rgb, done = TS.render_streaming(ts, params, chunk_slots=512, env=urban)
    assert done == want_done == 48 * 32 * 2
    hold_high_frequency(split(rgb, want))


@pytest.fixture(scope="module")
def urban_jax_golden_spied():
    """The JAX render of the golden (spheres + urban_4k, 48x32 spp 2) with
    a spy on the kernel's ``_atan2`` that records its inputs and outputs
    [1, 512] as the jitted kernel computes them: (image, [(y, x, atan2)]).
    The JAX package is patched in memory only, and its compiled renders
    are dropped afterwards."""
    captured = []
    atan2 = JM._atan2

    def spy(y, x):
        a = atan2(y, x)
        jax.debug.callback(lambda *v: captured.append(
            tuple(np.asarray(t, np.float32).ravel() for t in v)), y, x, a)
        return a

    env_fn, env_params = jax_load_nif_env(URBAN)
    arrays, params, _ = jax_build_scene(jax_prim(), image_width=48,
                                        image_height=32, samples_per_pixel=2,
                                        intersector="pallas")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JM, "_atan2", spy)
        rgb, _ = JS.render_streaming(arrays, params, spp=2, env_fn=env_fn,
                                     env_params=env_params)
        rgb = np.asarray(rgb)
    jax.clear_caches()
    return rgb, captured


def _jax_env_branch(env_fn, env_params):
    """The JAX kernel's env branch (megakernel.py:2314-2360) on directions
    [3, N], jitted as the render runs it: (uvn -> ([1, N], [1, N]),
    env -> RGB [N, 3])."""
    (P, E, layers, log_tm), (wstack, ebias, econst) = JM.pack_env_mlp(
        env_fn.nif_config, env_params)
    two_pi = np.float32(2.0 * np.pi)

    def uvn(d):
        theta = JM._acos(jnp.clip(d[1:2], -1.0, 1.0))
        phi = JM._atan2(d[2:3], d[0:1]) + econst[0:1, 0:1]
        phi = jnp.where(phi < 0.0, phi + two_pi, phi)
        phi = jnp.where(phi > two_pi, phi - two_pi, phi)
        return (2.0 * (theta * np.float32(1.0 / np.pi) - 1.0),
                2.0 * (phi * np.float32(0.5 / np.pi) - 1.0))

    def env(d):
        un, vn = uvn(d)
        coeff = jnp.round(jnp.exp(np.float32(np.log(2.0)) * lax.broadcasted_iota(
            jnp.int32, (E, 1), 0).astype(jnp.float32)))
        pu, pv = un * coeff, vn * coeff
        feats = jnp.concatenate([jnp.sin(pu), jnp.sin(pv), jnp.cos(pu),
                                 jnp.cos(pv)])
        n = d.shape[1]
        x = jnp.concatenate([feats, jnp.zeros((P - 4 * E, n), jnp.float32)])
        for l, (cin, cout, relu, concat) in enumerate(layers):
            if concat:
                x = jnp.concatenate([x[0:cin - 4 * E], feats,
                                     jnp.zeros((P - cin, n), jnp.float32)])
            y = lax.dot_general(wstack[l * P:(l + 1) * P],
                                x.astype(jnp.bfloat16),
                                (((1,), (0,)), ((), ())),
                                preferred_element_type=jnp.float32)
            y = y + ebias[:, l:l + 1]
            if relu:
                y = jnp.maximum(y, 0.0)
            x = (jnp.concatenate([y[0:cout],
                                  jnp.zeros((P - cout, n), jnp.float32)])
                 if l + 1 < len(layers) else y)
        bgr = [x[c:c + 1] * econst[0:1, 1:2] + econst[0:1, 2 + c:3 + c]
               for c in range(3)]
        if log_tm:
            bgr = [jnp.exp(b) for b in bgr]
        return jnp.concatenate([bgr[2], bgr[1], bgr[0]]).T

    return jax.jit(uvn), jax.jit(env)


def _bits_pairs(y, x) -> list:
    return list(zip(y.view(np.uint32).tolist(), x.view(np.uint32).tolist()))


def test_golden_gap_is_the_jitted_rounding(urban, urban_jax_golden_spied,
                                           monkeypatch):
    """Where the port's render and the JAX golden part (48x32 spp 2).
    Measured:

    * the spy leaves the golden as it is, bit for bit;
    * the kernel's atan2 is the jitted jnp twin's bit for bit on its own
      inputs; the port's equals the twin run op by op, and differs from
      the kernel's in 3.8% of the 14,336 values;
    * 44.2% of the port's 3,064 escape directions (dz, dx) are among the
      kernel's atan2 inputs bit for bit; the rest differ by a few ulps
      (the shading math rounds otherwise when jitted);
    * on the port's own escape directions, the port's env term against
      the jitted JAX env branch: 66.8% of the elements within rtol 1e-5
      with the port's UV map, 99.44% (largest 7.3e-3) with the UV map
      rounded as jitted; the rest is the MLP's sum order. The jitted JAX
      env on the port's directions against the golden: 83.0%."""
    rgb_j, captured = urban_jax_golden_spied
    golden = np.load(GOLDEN)
    np.testing.assert_array_equal(rgb_j, golden)

    y, x, a = (np.concatenate([c[i] for c in captured]) for i in range(3))
    np.testing.assert_array_equal(np.asarray(jax.jit(JM._atan2)(y, x)), a)
    port = atan2_poly(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(
        port, np.asarray(JM._atan2(jnp.asarray(y), jnp.asarray(x))))
    assert 0.01 < (port != a).mean() < 0.1

    ts, params = build_scene(make_primitive_scene(), device="cpu",
                             image_width=48, image_height=32,
                             samples_per_pixel=2)
    rows, cols, n_pix, kw = _stream(params)
    rec, done = mk.trace_records(ts, rows, cols, params.rng_seed, n_pix, **kw)
    dirs = rec[7:10][:, mk.escaped_records(rec, done)].t().numpy()
    kernel_pairs = set(_bits_pairs(y, x))
    found = np.mean([p in kernel_pairs
                     for p in _bits_pairs(dirs[:, 2], dirs[:, 0])])
    assert 0.3 < found < 0.6

    env_fn, env_params = jax_load_nif_env(URBAN)
    jax_uvn, jax_env = _jax_env_branch(env_fn, env_params)
    monkeypatch.setattr(mk, "env_mlp", lambda d, env: torch.from_numpy(
        np.array(jax_env(d.numpy().T))))
    want, _ = TS.render_streaming(ts, params, env=urban)
    monkeypatch.undo()
    own, _ = TS.render_streaming(ts, params, env=urban)

    def jitted_uvn(d, rotation):
        un, vn = jax_uvn(d.numpy().T)
        return (torch.from_numpy(np.array(un[0])),
                torch.from_numpy(np.array(vn[0])))

    monkeypatch.setattr(envk, "equirect_uvn", jitted_uvn)
    got, _ = TS.render_streaming(ts, params, env=urban)
    s = split(got, want)
    assert s["within_1e5"] >= 0.99 and s["max_rel"] <= 5e-2, s
    assert split(own, want)["within_1e5"] < 0.8
    assert split(want, golden)["within_1e5"] < 0.9


def _low_frequency_nif():
    """A small NIF made from a numpy seed: E = 2, 8 -> 16 -> (16+8) -> 16
    -> 3, a skip-concat before layer 1, log tone-mapped, rotated 30 deg."""
    rng = np.random.default_rng(5)
    cfg = JNifConfig(embedding_dimension=2, activations=("relu", "relu",
                                                         "none"),
                     concat_before=(False, True, False), log_tone_map=True)
    params = dict(
        kernels=[rng.normal(size=(8, 16)).astype(np.float32) * 0.5,
                 rng.normal(size=(24, 16)).astype(np.float32) * 0.3,
                 rng.normal(size=(16, 3)).astype(np.float32) * 0.3],
        biases=[rng.normal(size=16).astype(np.float32) * 0.1,
                rng.normal(size=16).astype(np.float32) * 0.1,
                rng.normal(size=3).astype(np.float32) * 0.1],
        max=np.float32(1.5), mean=np.array([-0.2, -0.1, 0.0], np.float32),
        rotation=np.float32(np.deg2rad(30.0)))
    return cfg, params


@pytest.fixture(scope="module")
def low_frequency_jax():
    cfg, p = _low_frequency_nif()
    jp = dict(kernels=tuple(jnp.asarray(k) for k in p["kernels"]),
              biases=tuple(jnp.asarray(b) for b in p["biases"]),
              max=jnp.float32(p["max"]), mean=jnp.asarray(p["mean"]),
              rotation=jnp.float32(p["rotation"]))

    def env_fn(env_params, dirs):
        return NifModel.env_radiance(cfg, env_params, dirs)

    env_fn.nif_config = cfg
    arrays, params, _ = jax_build_scene(jax_prim(), image_width=32,
                                        image_height=24, samples_per_pixel=4,
                                        intersector="pallas")
    rgb, done = JS.render_streaming(arrays, params, spp=4, env_fn=env_fn,
                                    env_params=jp)
    return np.asarray(rgb), done


def test_render_matches_jax_low_frequency_nif(low_frequency_jax):
    """Measured: 3 of 2,304 elements outside rtol 1e-5, the largest
    relative difference 9.8e-4."""
    want, want_done = low_frequency_jax
    cfg, p = _low_frequency_nif()
    ts, params = build_scene(make_primitive_scene(), device="cpu",
                             image_width=32, image_height=24,
                             samples_per_pixel=4)
    rgb, done = TS.render_streaming(ts, params, env=from_jax_params(cfg, p))
    assert done == want_done == 32 * 24 * 4
    s = split(rgb, want)
    assert s["within_1e5"] >= 0.99, s
    assert s["max_rel"] <= 5e-2, s
    assert rgb.mean() > 0.05  # lit by the env


def test_env_on_another_device_is_refused(urban):
    ts, params = build_scene(make_primitive_scene(), device="cpu",
                             image_width=8, image_height=8,
                             samples_per_pixel=1)
    with pytest.raises(ValueError, match="env on"):
        TS.render_streaming(ts, params, env=urban.to("meta"))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_cuda_env_route_matches_plain(urban, cuda_device):
    """The kernel route against the plain route: launches, ``done`` and
    every path record (trajectories, colours, throughputs, escape flags,
    directions) exactly; the image within the high-frequency tolerance,
    since the tensor-core env MLP sums in its own order; and every pixel
    none of whose paths escaped (where the scene has one) bit for bit."""
    ts, params = build_scene(make_primitive_scene(), device=cuda_device,
                             image_width=32, image_height=32,
                             samples_per_pixel=2)
    env = urban.to(cuda_device)
    rows, cols, n_pix, kw = _stream(params)
    rows, cols = rows.to(cuda_device), cols.to(cuda_device)
    mk.reset_launches()
    envk.reset_launches()
    flat, done = mk.megakernel_path_trace(ts, rows, cols, 1442, n_pix,
                                          env=env, **kw)
    torch.cuda.synchronize()
    assert (mk.launches, mk.bank_launches, envk.launches) == (1, 1, 1)
    ref, dref = mk.megakernel_path_trace_ref(ts, rows, cols, 1442, n_pix,
                                             env=env, **kw)
    assert int(done) == int(dref) == n_pix * 2
    rec, d1 = mk.trace_records(ts, rows, cols, 1442, n_pix, **kw)
    rec_p, d0 = mk._trace(mk._accumulate_plain, ts, rows, cols, 1442, n_pix,
                          record=True, **kw)
    real = mk.real_records(rec_p, d0)
    assert torch.equal(d1.long(), d0.long())
    assert torch.equal(rec[:, real], rec_p[:, real])
    hold_high_frequency(split(flat.cpu(), ref.cpu()))
    dry = ~mk.escaped_pixels(rec_p, d0, 2)
    assert torch.equal(flat[dry], ref[dry])
