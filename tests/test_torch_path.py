"""The per-sample wavefront path tracer (render/path.py,
``path_trace_sample``) against the JAX package on the CPU (K5's and K6's plain versions; the JAX side in interpret
mode, its scenes built with ``intersector="pallas"`` or ``"pallas-hbm"``).

``path_trace_sample`` on the Cornell box and Cornell + monkey (VMEM) and
on stress24 (HBM mode), with ``sort_rays`` 0, 1, 2 and -1, from the same
jittered camera rays: ``escaped`` and ``error`` exact; ``rgb``,
``esc_throughput`` and ``esc_dir`` within rtol = atol = 1e-5, the count
of elements that differ at all asserted. Why not bit for bit: the
diffuse sample's ``cos``/``sin`` are torch's, which round otherwise than
XLA's CPU approximations in the last place for a few arguments (as in
path B, tests/test_torch_glue.py). Measured at 24x24: ``rgb`` and
``esc_throughput`` equal bit for bit in all 12 cases; ``esc_dir``
differs in 113-196 of 1,728 elements (the most on stress24), by at most
5.6e-6 (Cornell + monkey sorted every second bounce; 6.0e-7 unsorted): a
direction sampled from the surface's diffuse lobe is the escape
direction itself.

``render(streaming=False)`` is held in tests/test_torch_path_render.py.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ipu_ray_lib_tpu.ops.camera import generate_camera_rays as jax_camera
from ipu_ray_lib_tpu.ops.camera import pixel_grid as jax_grid
from ipu_ray_lib_tpu.render.path import path_trace_sample as jax_pts
from ipu_ray_lib_tpu.scene.build import build_scene as jax_build_scene
from ipu_ray_lib_tpu.scene import builtin as JB
import ipu_ray_lib_tpu_torch.scene.build as TB
from ipu_ray_lib_tpu_torch.ops import intersect_hbm as ih
from ipu_ray_lib_tpu_torch.ops import intersect_kernel as ik
from ipu_ray_lib_tpu_torch.render.path import path_trace_sample
from ipu_ray_lib_tpu_torch.scene import builtin as PB
from ipu_ray_lib_tpu_torch.utils import threefry as tf

MONKEY = "assets/monkey_bust.glb"
TOL = dict(rtol=1e-5, atol=1e-5)
SIZE = 24
SCENES = {  # name: (JAX scene, port scene, intersector)
    "cornell": (lambda: JB.make_cornell_box_scene(None, box_only=False),
                lambda: PB.make_cornell_box_scene(None, box_only=False),
                "pallas"),
    "monkey": (lambda: JB.make_cornell_box_scene(MONKEY, box_only=False),
               lambda: PB.make_cornell_box_scene(MONKEY, box_only=False),
               "pallas"),
    "stress24": (lambda: JB.make_stress_scene(24),
                 lambda: PB.make_stress_scene(24), "pallas-hbm"),
}


def _n_diff(got: torch.Tensor, want) -> int:
    return int((got.numpy() != np.asarray(want)).sum())


def _builds(name, size=SIZE, **kw):
    jmake, pmake, inter = SCENES[name]
    arrays, jparams, _ = jax_build_scene(jmake(), image_width=size,
                                         image_height=size,
                                         intersector=inter, **kw)
    ts, params = TB.build_scene(pmake(), device="cpu", image_width=size,
                                image_height=size, intersector=inter, **kw)
    return arrays, jparams, ts, params


@functools.lru_cache(maxsize=None)
def _scene(name):
    """(JAX arrays, JAX params, port scene, port params, jittered camera
    directions of the JAX package's jitted camera)."""
    arrays, jparams, ts, params = _builds(name)
    assert params.intersector == SCENES[name][2]
    rows, cols = jax_grid(SIZE, SIZE, 0, 0)
    key = jax.random.PRNGKey(5)
    _, d = jax.jit(lambda r, c, k: jax_camera(
        r, c, SIZE, SIZE, jparams.fov_radians, 0.25, k))(
        rows, cols, jax.random.fold_in(key, 0xC0FFEE))
    return arrays, jparams, ts, params, np.array(d)


@pytest.mark.parametrize("sort_rays", [0, 1, 2, -1])
@pytest.mark.parametrize("name", list(SCENES))
def test_path_trace_sample_matches_jax(name, sort_rays):
    arrays, jparams, ts, params, d = _scene(name)
    o = np.zeros_like(d)
    want = jax_pts(arrays, jnp.asarray(o), jnp.asarray(d),
                   jax.random.PRNGKey(5), jparams.max_path_length,
                   jparams.roulette_start_depth,
                   intersector=jparams.intersector, sort_rays=sort_rays)
    ik.reset_launches()
    ih.reset_launches()
    stats = {}
    got = path_trace_sample(ts, torch.from_numpy(o), torch.from_numpy(d),
                            tf.PRNGKey(5), params.max_path_length,
                            params.roulette_start_depth,
                            intersector=params.intersector,
                            sort_rays=sort_rays, stats=stats)
    assert ik.launches == ih.launches == 0  # CPU tensors: plain versions
    assert 2 <= stats["bounces"] <= params.max_path_length
    assert stats["syncs"] in (stats["bounces"], stats["bounces"] + 1)
    assert torch.equal(got.escaped, torch.from_numpy(np.asarray(want.escaped)))
    assert torch.equal(got.error, torch.from_numpy(np.asarray(want.error)))
    assert got.escaped.any() and not got.error.any()
    n = got.rgb.numel()
    for f, limit in (("rgb", 0.02), ("esc_throughput", 0.02),
                     ("esc_dir", 0.12)):
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert g.dtype == torch.float32 and g.shape == w.shape, f
        np.testing.assert_allclose(g.numpy(), w, **TOL, err_msg=f)
        assert _n_diff(g, w) <= limit * n, (f, _n_diff(g, w))
    assert float(got.rgb.max()) > 0


def test_sort_needs_the_root_box():
    _, _, ts, params = _builds("cornell", size=8)
    assert ts.root_box.shape == (2, 3)
    ts.root_box = None
    d = torch.tensor([[0.0, 0.0, -1.0]] * 4)
    with pytest.raises(ValueError, match="root box"):
        path_trace_sample(ts, torch.zeros_like(d), d, tf.PRNGKey(1), 3, 1,
                          sort_rays=1)
