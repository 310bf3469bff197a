"""``build_scene``'s render settings against the JAX package's.

``anti_alias_scale``, ``roulette_start_depth`` and ``rng_seed`` at
values other than the defaults: the port's ``SceneParams`` equal the JAX
package's field by field, its tables equal the JAX package's, and
``render_streaming`` of the Cornell box at 16x16 spp 2 (the megakernel
route) equals the JAX package's image bit for bit, and differs from the
defaults' image.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import dataclasses

import numpy as np
import pytest

from ipu_ray_lib_tpu.render.streaming import render_streaming as jax_render
from ipu_ray_lib_tpu.scene.build import build_scene as jax_build_scene
from ipu_ray_lib_tpu.scene.builtin import make_cornell_box_scene as jax_cornell
from ipu_ray_lib_tpu.scene.builtin import make_primitive_scene as jax_prim
from ipu_ray_lib_tpu_torch.render.streaming import render_streaming
from ipu_ray_lib_tpu_torch.scene.build import build_scene
from ipu_ray_lib_tpu_torch.scene.builtin import (make_cornell_box_scene,
                                                 make_primitive_scene)

SETTINGS = dict(anti_alias_scale=0.5, roulette_start_depth=2, rng_seed=7)
SCENES = {
    "cornell": (lambda: make_cornell_box_scene(None),
                lambda: jax_cornell(None)),
    "box-only": (lambda: make_cornell_box_scene(None, box_only=True),
                 lambda: jax_cornell(None, box_only=True)),
    "spheres": (make_primitive_scene, jax_prim),
}


def _both(name, **kw):
    port, jax = SCENES[name]
    size = dict(image_width=16, image_height=16, samples_per_pixel=2)
    arrays, jparams, _ = jax_build_scene(jax(), intersector="pallas",
                                         **size, **kw)
    ts, tparams = build_scene(port(), device="cpu", **size, **kw)
    return ts, tparams, arrays, jparams


@pytest.mark.parametrize("name", list(SCENES))
def test_params_match_jax(name):
    _, tparams, _, jparams = _both(name, **SETTINGS)
    assert dataclasses.asdict(tparams) == dataclasses.asdict(jparams)
    assert tparams.rng_seed == 7 and tparams.anti_alias_scale == 0.5
    assert tparams.roulette_start_depth == 2


def test_tables_match_jax_at_settings():
    ts, tparams, arrays, _ = _both("box-only", **SETTINGS)
    for name in ("p", "nrm", "baabb", "tri_geom", "tri_prim"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(arrays.blocked, name)))
    _, tparams1, _, _ = _both("box-only")
    assert tparams.num_bvh_nodes == tparams1.num_bvh_nodes


def test_render_matches_jax_at_settings():
    ts, tparams, arrays, jparams = _both("cornell", **SETTINGS)
    rgb, done = render_streaming(ts, tparams)
    jrgb, jdone = jax_render(arrays, jparams)
    assert done == jdone == 16 * 16 * 2
    assert rgb.dtype == np.float32
    np.testing.assert_array_equal(rgb, np.asarray(jrgb))
    default, _ = render_streaming(*build_scene(
        make_cornell_box_scene(None), device="cpu", image_width=16,
        image_height=16, samples_per_pixel=2))
    assert not np.array_equal(rgb, default)
