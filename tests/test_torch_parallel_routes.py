"""The port's multi-device rendering on the CPU, the routes besides the
VMEM-mode megakernel (tests/test_torch_parallel.py), each against the JAX
package's ``parallel/mesh.py`` on a mesh of the conftest's virtual CPU
devices:

* the batched branch (spp 3 in batches of 2 + 1, seeds strided
  0x85EBCA6B per batch) with its progress callback: every frame and the
  image bit for bit;
* the XLA-loop route (the Cornell box at 16x16 spp 2 on 2 shards,
  ``chunk_slots=64``: R = 64 does not tile into 256), no env: rtol = atol
  = 1e-5 with ``done`` exact (the port's path-B tolerance,
  tests/test_torch_glue_xla_loop.py);
* the NIF route (spheres + urban_4k at 48x32 spp 2 on 2 shards): ``done``
  exact, the image within the unsharded render's split tolerance
  (tests/test_torch_env.py);
* HBM mode (the Cornell box as a ``pallas-hbm`` scene, 48x48 spp 2 on 2
  shards): bit for bit;
* ``render_shadow_sharded`` at 32x32 on 8 shards (fused K4's plain
  version): every field bit for bit.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import os

import numpy as np
import pytest

import jax

from ipu_ray_lib_tpu.nif.model import load_nif_env as jax_load_nif_env
from ipu_ray_lib_tpu.ops.camera import pixel_grid
from ipu_ray_lib_tpu.parallel.mesh import make_ray_mesh as jax_mesh
from ipu_ray_lib_tpu.parallel.mesh import (
    render_shadow_sharded as jax_shadow_sharded,
    render_streaming_sharded as jax_sharded)
from ipu_ray_lib_tpu.scene.build import build_scene as jax_build_scene
from ipu_ray_lib_tpu.scene.builtin import make_cornell_box_scene as jax_cornell
from ipu_ray_lib_tpu.scene.builtin import make_primitive_scene as jax_prim
from ipu_ray_lib_tpu_torch.nif.model import load_nif_env
from ipu_ray_lib_tpu_torch.parallel import (make_ray_mesh,
                                            render_shadow_sharded,
                                            render_streaming_sharded,
                                            shard_plan)
from ipu_ray_lib_tpu_torch.render.streaming import uses_megakernel
from ipu_ray_lib_tpu_torch.scene.build import build_scene
from ipu_ray_lib_tpu_torch.scene.builtin import (make_cornell_box_scene,
                                                 make_primitive_scene)

from test_torch_env import hold_high_frequency, split

URBAN = os.path.join(os.path.dirname(__file__), "..", "assets", "nif",
                     "synthetic_urban_4k")


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


def _box(size, spp, intersector="pallas", box_only=True):
    arrays, jp, _ = jax_build_scene(jax_cornell(None, box_only=box_only),
                                    image_width=size, image_height=size,
                                    samples_per_pixel=spp,
                                    intersector=intersector)
    ts, tp = build_scene(make_cornell_box_scene(None, box_only=box_only),
                         device="cpu", image_width=size, image_height=size,
                         samples_per_pixel=spp, intersector=intersector)
    return arrays, jp, ts, tp


@pytest.fixture(scope="module")
def batched():
    """spp 3 with spp_batch 2 on 2 shards: (JAX frames, image, done; port
    frames, image, done)."""
    arrays, jp, ts, tp = _box(48, 3)
    jf, pf = [], []
    want, wd = jax_sharded(arrays, jp, jax_mesh(jax.devices()[:2]),
                           chunk_slots=256, spp_batch=2,
                           progress_callback=lambda bi, im: jf.append(
                               (bi, np.array(im))))
    got, gd = render_streaming_sharded(
        ts, tp, make_ray_mesh(["cpu"] * 2), chunk_slots=256, spp_batch=2,
        progress_callback=lambda bi, im: pf.append((bi, im)))
    return jf, np.asarray(want), wd, pf, got, gd


def test_batched_frames_match_jax(batched):
    jf, _, _, pf, _, _ = batched
    assert [bi for bi, _ in pf] == [bi for bi, _ in jf] == [0, 1]
    for (_, a), (_, b) in zip(pf, jf):
        assert _same(a, b)


def test_batched_image_matches_jax(batched):
    _, want, wd, pf, got, gd = batched
    assert gd == wd == 48 * 48 * 3
    assert _same(got, want)
    # the last running average is the image (weights sum to spp / spp)
    assert _same(pf[-1][1], got)


def test_xla_loop_route_matches_jax():
    arrays, jp, ts, tp = _box(16, 2)
    assert not uses_megakernel(shard_plan(tp, 2, 64).slots, None)
    want, wd = jax_sharded(arrays, jp, jax_mesh(jax.devices()[:2]),
                           chunk_slots=64)
    got, gd = render_streaming_sharded(ts, tp, make_ray_mesh(["cpu"] * 2),
                                       chunk_slots=64)
    assert gd == wd == 16 * 16 * 2
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


def test_nif_route_holds_jax():
    env_fn, env_params = jax_load_nif_env(URBAN)
    arrays, jp, _ = jax_build_scene(jax_prim(), image_width=48,
                                    image_height=32, samples_per_pixel=2,
                                    intersector="pallas")
    ts, tp = build_scene(make_primitive_scene(), device="cpu", image_width=48,
                         image_height=32, samples_per_pixel=2)
    env = load_nif_env(URBAN, device="cpu")
    assert uses_megakernel(shard_plan(tp, 2).slots, env)
    want, wd = jax_sharded(arrays, jp, jax_mesh(jax.devices()[:2]),
                           env_fn=env_fn, env_params=env_params)
    got, gd = render_streaming_sharded(ts, tp, make_ray_mesh(["cpu"] * 2),
                                       env=env)
    assert gd == wd == 48 * 32 * 2
    hold_high_frequency(split(got, np.asarray(want)))


def test_hbm_mode_matches_jax():
    arrays, jp, ts, tp = _box(48, 2, "pallas-hbm")
    want, wd = jax_sharded(arrays, jp, jax_mesh(jax.devices()[:2]),
                           chunk_slots=256)
    got, gd = render_streaming_sharded(ts, tp, make_ray_mesh(["cpu"] * 2),
                                       chunk_slots=256)
    assert gd == wd == 48 * 48 * 2
    assert _same(got, np.asarray(want))


@pytest.fixture(scope="module")
def shadow():
    arrays, jp, ts, tp = _box(32, 1, box_only=False)
    rows, cols = pixel_grid(32, 32, 0, 0)
    want = jax_shadow_sharded(arrays, jp, rows, cols,
                              jax_mesh(jax.devices()[:8]))
    got = render_shadow_sharded(ts, tp, np.asarray(rows), np.asarray(cols),
                                make_ray_mesh(["cpu"] * 8))
    return want, got, ts, tp


@pytest.mark.parametrize("field", ["rgb", "t", "geom_id", "prim_id",
                                   "normal", "hit_p", "escaped"])
def test_shadow_sharded_matches_jax(shadow, field):
    want, got, _, _ = shadow
    assert int((got.geom_id >= 0).sum()) > 0
    assert _same(getattr(got, field).numpy(),
                 np.asarray(getattr(want, field)))


def test_shadow_sharded_needs_equal_shards(shadow):
    _, _, ts, tp = shadow
    rows = np.zeros(1001, np.float32)
    with pytest.raises(ValueError, match="shard_rays"):
        render_shadow_sharded(ts, tp, rows, rows, make_ray_mesh(["cpu"] * 8))
