"""The port's glue route (path A: the shadow trace through the closest-hit
kernels) and its XLA-loop integrator (path B: the path trace under an
environment light that is not a NIF) against the JAX package on the CPU.

Path A is held bit for bit (``==`` on every AOV element):

* ``render(mode="shadow-trace", fused=False)`` on the Cornell box 48x32
  reproduces the golden ``tests/golden/shadow_box48x32.npz``;
* in HBM mode (Cornell box, stress24) it equals the JAX ``render`` of the
  same scene, which takes the glue route there too;
* at 128x128 each route equals the JAX package's own route. The two
  routes differ from each other in both packages, and only on sphere hits:
  the glue's ``dense_spheres`` reduces its dots in order, the fused
  kernel's twin contracts them elementwise (ops/dense.py).

Path B (its tests are in tests/test_torch_glue_xla_loop.py, with the sky
below), ``render_streaming`` with a sky gradient written in jnp and in
torch, on a ``pallas`` and on a ``pallas-hbm`` scene, holds the port's
path-trace tolerance (rtol = atol = 1e-5, as tests/test_torch_render.py),
with ``done`` and the iteration count exact. Why not bit for bit:
measured on the Cornell box 16x16 spp 2, 18 of 768 elements differ, the
largest by 6.0e-8 (5.5e-8 relative); at 32x32 in HBM mode 55 of 3,072
by 6.0e-8 (the test runs HBM mode at 16x16). The integrator's transcendentals are torch's (``log`` in the
gaussian jitter, ``cos``/``sin`` in the diffuse sample), which differ from
XLA's CPU approximations in the last place for 5-14% of arguments, and
XLA contracts the multiply-adds of [R, 3] rows per column (a product
feeding the x and y components' sums is fused, the z component's is not),
which ops/bxdf_loop.py writes as one fused form. The paths stay the same
(``done`` and the iterations agree); only the last bits of their weights
move.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ipu_ray_lib_tpu.render.renderer import render as jax_render
from ipu_ray_lib_tpu.scene.build import build_scene as jax_build_scene
from ipu_ray_lib_tpu.scene.builtin import make_cornell_box_scene as jax_cornell
from ipu_ray_lib_tpu.scene.builtin import make_stress_scene as jax_stress
import ipu_ray_lib_tpu_torch.render.streaming as TS
import ipu_ray_lib_tpu_torch.scene.build as TB
from ipu_ray_lib_tpu_torch.nif import model as nif_model
from ipu_ray_lib_tpu_torch.ops import intersect_kernel as ik
from ipu_ray_lib_tpu_torch.ops import shadow as sh
from ipu_ray_lib_tpu_torch.ops.vec3 import fma
from ipu_ray_lib_tpu_torch.render.renderer import render
from ipu_ray_lib_tpu_torch.runtime.device import cuda_device
from ipu_ray_lib_tpu_torch.scene.builtin import (make_cornell_box_scene,
                                                 make_stress_scene)

ROOT = os.path.join(os.path.dirname(__file__), "..")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "shadow_box48x32.npz")
URBAN = os.path.join(ROOT, "assets", "nif", "synthetic_urban_4k")
FIELDS = ("rgb", "t", "geom_id", "prim_id", "normal", "hit_p")
TOL = dict(rtol=1e-5, atol=1e-5)
SPHERES = (6, 7)  # the Cornell box's sphere geometry ids


def _equal(a, b) -> int:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype
    return int((a != b).sum())


def _cornell(size, intersector, **kw):
    w, h = size
    arrays, jparams, _ = jax_build_scene(jax_cornell(None, box_only=False),
                                         image_width=w, image_height=h,
                                         intersector=intersector, **kw)
    ts, params = TB.build_scene(make_cornell_box_scene(None, box_only=False),
                                device="cpu", image_width=w, image_height=h,
                                intersector=intersector, **kw)
    return arrays, jparams, ts, params


# ---- path A: the shadow trace's glue route ----

def test_glue_render_holds_shadow_golden():
    _, _, ts, params = _cornell((48, 32), "pallas")
    sh.reset_launches()
    ik.reset_launches()
    out = render(ts, params, chunk_size=512, fused=False)
    assert sh.launches == ik.launches == 0  # CPU tensors: plain versions
    golden = np.load(GOLDEN)
    assert out.hit_count == 729
    for f in FIELDS:
        assert _equal(getattr(out, f), golden[f]) == 0, f


@pytest.mark.parametrize("name", ["cornell", "stress24"])
def test_glue_render_matches_jax_in_hbm_mode(name):
    if name == "cornell":
        arrays, jparams, ts, params = _cornell((48, 32), "pallas-hbm")
    else:
        arrays, jparams, _ = jax_build_scene(jax_stress(24), image_width=32,
                                             image_height=32,
                                             intersector="pallas-hbm")
        ts, params = TB.build_scene(make_stress_scene(24), device="cpu",
                                    image_width=32, image_height=32,
                                    intersector="pallas-hbm")
    want = jax_render(arrays, jparams, chunk_size=512)
    got = render(ts, params, chunk_size=512)
    assert got.hit_count == want.hit_count > 100
    for f in FIELDS:
        assert _equal(getattr(got, f), getattr(want, f)) == 0, f


@pytest.fixture(scope="module")
def routes_128():
    arrays, jparams, ts, params = _cornell((128, 128), "pallas")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for fused in (True, False):
            mp.setenv("RAY_SHADOW_FUSED", "1" if fused else "0")
            out[fused] = (jax_render(arrays, jparams, chunk_size=4096),
                          render(ts, params, chunk_size=4096, fused=fused))
    return out


@pytest.mark.parametrize("fused", [True, False])
def test_each_route_matches_jaxs(routes_128, fused):
    want, got = routes_128[fused]
    for f in FIELDS:
        assert _equal(getattr(got, f), getattr(want, f)) == 0, f


def test_routes_differ_only_on_sphere_hits(routes_128):
    """Where the glue and the fused route differ, in either package, the
    pixel shows a sphere; the ids agree everywhere."""
    for pkg in (0, 1):
        a, b = routes_128[True][pkg], routes_128[False][pkg]
        assert _equal(a.geom_id, b.geom_id) == 0
        assert _equal(a.prim_id, b.prim_id) == 0
        differ = np.zeros(a.t.shape, bool)
        for f in ("rgb", "t", "normal", "hit_p"):
            x, y = getattr(a, f), getattr(b, f)
            differ |= (x != y).reshape(a.t.shape + (-1,)).any(-1)
        assert differ.any()
        assert np.isin(a.geom_id[differ], SPHERES).all()
        for f in ("rgb", "t", "normal", "hit_p"):
            np.testing.assert_allclose(getattr(a, f), getattr(b, f), **TOL)


# ---- path B: the XLA-loop integrator under an opaque env ----

def jax_sky(params, d):
    t = 0.5 * (d[:, 1] + 1.0)
    return jnp.stack([1.0 - 0.5 * t, 1.0 - 0.3 * t, jnp.ones_like(t)],
                     -1) * params


def sky(d):
    """``jax_sky`` at params 0.7, as XLA compiles it in the loop: each
    ``1 - c * t`` is one fused multiply-add."""
    t = 0.5 * (d[:, 1] + 1.0)
    return torch.stack([fma(-0.5, t, 1.0), fma(-0.3, t, 1.0),
                        torch.ones_like(t)], -1) * 0.7


def test_render_routes_env_kinds(monkeypatch):
    """An env callable takes the XLA-loop integrator, no env (or a NIF)
    the megakernel; ``render(mode="path-trace")`` passes it through."""
    ts, params = TB.build_scene(make_cornell_box_scene(None, box_only=True),
                                device="cpu", image_width=16, image_height=16,
                                samples_per_pixel=1)
    calls = []
    real = TS.streaming_path_trace
    monkeypatch.setattr(TS, "streaming_path_trace",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    out = render(ts, params, mode="path-trace", env=sky)
    rgb, done = TS.render_streaming(ts, params, env=sky)
    assert len(calls) == 2 and done == 256
    assert _equal(out.rgb, rgb) == 0
    TS.render_streaming(ts, params)
    assert len(calls) == 2


# ---- the entry points' default device ----

def test_entry_points_default_to_the_card(monkeypatch):
    """``build_scene`` and ``load_nif_env`` take the CUDA card when no
    device is given, through ``cuda_device``, which raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    scene = make_cornell_box_scene(None, box_only=True)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TB.build_scene(scene, image_width=8, image_height=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        nif_model.load_nif_env(URBAN)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert cuda_device() == torch.device("cuda", 0)
    asked = []
    for mod in (TB, nif_model):
        monkeypatch.setattr(mod, "cuda_device",
                            lambda: asked.append(1) or torch.device("cpu"))
    ts, _ = TB.build_scene(scene, image_width=8, image_height=8)
    env = nif_model.load_nif_env(URBAN)
    assert asked == [1, 1]
    assert ts.device.type == env.device.type == "cpu"
