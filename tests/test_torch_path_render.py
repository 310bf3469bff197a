"""``render(mode="path-trace", streaming=False)``, the per-sample
wavefront over a window (render/renderer.py), against the JAX package's
``render`` on the CPU (K5's plain version; the JAX side in interpret
mode, its scenes built with ``intersector="pallas"``).

At 24x24 spp 2 in chunks of 256 (three chunks, the last one partial; a
window that is not made of whole 32-pixel tiles) the Cornell box equals
the JAX render bit for bit, and so does a 32x32 window (one whole tile).
Lit by the urban_4k NIF (spheres scene) it holds
tests/test_torch_env.py's split tolerance: the env term takes the
equirect angles of the JAX package's XLA env function
(``env_mlp(exact_uv=True)``); measured at 24x24: 511 of 1,728 elements
outside rtol 1e-5, 99.88% within rtol 1e-2, the largest relative
difference 2.6e-2 (with the megakernel's polynomial angles 92.4% within
1e-2: the features scale the angles by up to 2^11). Material errors are
counted and logged as in the JAX package.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import logging
import os

import numpy as np
import pytest
import torch

from ipu_ray_lib_tpu.nif.model import load_nif_env as jax_load_nif_env
from ipu_ray_lib_tpu.render.renderer import render as jax_render
from ipu_ray_lib_tpu.scene.build import build_scene as jax_build_scene
from ipu_ray_lib_tpu.scene import builtin as JB
import ipu_ray_lib_tpu_torch.scene.build as TB
from ipu_ray_lib_tpu_torch.nif.model import load_nif_env
from ipu_ray_lib_tpu_torch.ops import env as envk
from ipu_ray_lib_tpu_torch.render.renderer import render
from ipu_ray_lib_tpu_torch.scene import builtin as PB
from test_torch_env import hold_high_frequency, split
from test_torch_path import SIZE, _builds

URBAN = os.path.join(os.path.dirname(__file__), "..", "assets", "nif",
                     "synthetic_urban_4k")


@pytest.mark.parametrize("size", [24, 32])
def test_render_per_sample_matches_jax(size):
    """24x24: uploaded coordinates; 32x32: made on the device."""
    arrays, jparams, ts, params = _builds("cornell", size=size,
                                          samples_per_pixel=2)
    want = jax_render(arrays, jparams, mode="path-trace", chunk_size=256,
                      streaming=False)
    chunks, stats = [], {}
    got = render(ts, params, mode="path-trace", chunk_size=256,
                 streaming=False, stats=stats,
                 progress_callback=lambda ci, rgb: chunks.append((ci, rgb)))
    assert got.rgb.dtype == np.float32 and np.array_equal(got.rgb, want.rgb)
    for f in ("t", "geom_id", "prim_id", "normal", "hit_p"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    n_chunks = -(-size * size // 256)
    assert [ci for ci, _ in chunks] == list(range(n_chunks))
    assert all(rgb.shape == (256, 3) for _, rgb in chunks)
    assert stats["errors"] == 0 and stats["syncs"] >= 2 * n_chunks
    assert got.rgb.mean() > 0.01


def test_render_per_sample_counts_material_errors(caplog):
    """A material of an unknown type is flagged per ray and logged, as the
    JAX package does (its paths go on through the dielectric branch)."""
    _, _, ts, params = _builds("cornell", size=8, samples_per_pixel=1)
    ts.mat_type = torch.full_like(ts.mat_type, 7)
    stats = {}
    with caplog.at_level(logging.WARNING, logger="ipu_ray_lib_tpu_torch"):
        out = render(ts, params, mode="path-trace", chunk_size=64,
                     streaming=False, stats=stats)
    assert stats["errors"] > 0 and np.isfinite(out.rgb).all()
    assert "material errors" in caplog.text


def test_render_per_sample_nif_holds_split_tolerance():
    arrays, jparams, _ = jax_build_scene(JB.make_primitive_scene(),
                                         image_width=SIZE, image_height=SIZE,
                                         samples_per_pixel=2,
                                         intersector="pallas")
    ts, params = TB.build_scene(PB.make_primitive_scene(), device="cpu",
                                image_width=SIZE, image_height=SIZE,
                                samples_per_pixel=2)
    env_fn, env_params = jax_load_nif_env(URBAN)
    want = jax_render(arrays, jparams, mode="path-trace", chunk_size=256,
                      streaming=False, env_fn=env_fn,
                      env_params=env_params).rgb
    env = load_nif_env(URBAN, device="cpu")
    envk.reset_launches()
    got = render(ts, params, mode="path-trace", chunk_size=256,
                 streaming=False, env=env).rgb
    assert envk.launches == 0
    assert got.mean() > 0.1 and np.isfinite(got).all()
    hold_high_frequency(split(got, want))
    # The megakernel's polynomial angles do not hold it here:
    poly = render(ts, params, mode="path-trace", chunk_size=256,
                  streaming=False, env=lambda d: env(d)).rgb
    assert split(poly, want)["within_1e2"] < 0.98
