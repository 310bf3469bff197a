"""Path B, the XLA-loop integrator under an environment light that is not
a NIF, against the JAX package on the CPU: ``render_streaming`` with a sky
gradient written in jnp and in torch, on a ``pallas`` and on a
``pallas-hbm`` scene, and one batch through ``streaming_path_trace``. They
hold the port's path-trace tolerance (rtol = atol = 1e-5) with ``done``
and the iteration count exact; tests/test_torch_glue.py, whose helpers
this file shares, says why not bit for bit. A file of its own so that
the test workers run it beside the glue route's tests."""

import torch_threads  # noqa: F401  (first: one torch thread)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ipu_ray_lib_tpu.render.streaming as JS
from ipu_ray_lib_tpu.scene.build import build_scene as jax_build_scene
from ipu_ray_lib_tpu.scene.builtin import make_cornell_box_scene as jax_cornell
import ipu_ray_lib_tpu_torch.render.streaming as TS
from ipu_ray_lib_tpu_torch.render.pixels import pixel_stream
import ipu_ray_lib_tpu_torch.scene.build as TB
from ipu_ray_lib_tpu_torch.ops import intersect_hbm as ih
from ipu_ray_lib_tpu_torch.ops import intersect_kernel as ik
from ipu_ray_lib_tpu_torch.scene.builtin import make_cornell_box_scene
from test_torch_glue import TOL, _cornell, jax_sky, sky


def _split(got, want):
    return int((got != want).sum()), float(np.abs(got - want).max())


@pytest.mark.parametrize("intersector,size", [("pallas", 16),
                                              ("pallas-hbm", 16)])
def test_xla_loop_render_matches_jax(intersector, size):
    arrays, jparams = jax_build_scene(
        jax_cornell(None, box_only=True), image_width=size,
        image_height=size, samples_per_pixel=2, intersector=intersector)[:2]
    ts, params = TB.build_scene(make_cornell_box_scene(None, box_only=True),
                                device="cpu", image_width=size,
                                image_height=size, samples_per_pixel=2,
                                intersector=intersector)
    want, jdone = JS.render_streaming(arrays, jparams, env_fn=jax_sky,
                                      env_params=jnp.float32(0.7))
    ik.reset_launches()
    ih.reset_launches()
    stats = {}
    got, done = TS.render_streaming(ts, params, env=sky, stats=stats)
    assert ik.launches == ih.launches == 0
    assert done == jdone == size * size * 2
    assert 2 < stats["iters"] <= 2 * params.max_path_length + 16
    np.testing.assert_allclose(got, want, **TOL)
    n_diff, _ = _split(got, want)
    assert n_diff < 0.1 * got.size
    assert got.mean() > 0.1  # the sky lights the box through its open side


def test_xla_loop_integrator_matches_jax_iterations():
    """One batch through ``streaming_path_trace`` in both packages: the
    accumulator within the tolerance, ``done`` and the iteration count
    exact (a slot pool of 96 slots, 3 pixels each: a padded stream)."""
    arrays, jparams, ts, params = _cornell((16, 16), "pallas",
                                           samples_per_pixel=2)
    R, J = 96, 3
    rows, cols = pixel_stream(params).coords(torch.device("cpu"), R * J)
    kw = dict(slots=R, j_per_slot=J, spp=2,
              max_iters=J * 2 * params.max_path_length + 16)
    jacc, jdone, jit_ = JS.streaming_path_trace(
        arrays, jnp.asarray(rows.numpy()), jnp.asarray(cols.numpy()),
        jnp.uint32(1442), jnp.float32(0.7), jnp.int32(256), params=jparams,
        has_env=True, env_fn=jax_sky, **kw)
    acc, done, iters = TS.streaming_path_trace(
        ts, rows, cols, 1442, 256, params=params, env=sky, **kw)
    assert int(done) == int(jdone) == 512
    assert iters == int(jit_)
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), **TOL)
    assert not acc[2, :, 256 - 2 * R:].any()  # padding pixels get no path
