"""Why the XLA loop through "bvh" or "dense" renders Cornell + monkey
brighter than the megakernel, in both packages.

In the Cornell + monkey scene the disc is a light (its material follows
its geometry id, 10 there; without the monkey it is glass). It lies
0.0002 in front of the right wall, about 6 f32 ulps of x there. The
megakernel's route (its row and disc tests, as K4's) resolves that tie
to the wall at every pixel centre aimed at the disc; the threaded-BVH
walk and the dense test (the JAX package's ops/intersect.py tests) see
the disc. So the XLA loop through "bvh" sees more of the light, and its
mean sits about 10% above the megakernel's. This holds the JAX
package's pair to that split and the port's pair to the JAX package's,
so the chip check's 15% limit on path B's mean (chip_smoke.py phase 15
(d)) rests on a measured cause.
Run with ``-s`` to print the means.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import os

import numpy as np

from ipu_ray_lib_tpu.render.renderer import render as jax_render
from ipu_ray_lib_tpu.render.streaming import render_streaming as jax_streaming
from ipu_ray_lib_tpu.scene import builtin as JB
from ipu_ray_lib_tpu.scene.build import build_scene as jax_build_scene
import ipu_ray_lib_tpu_torch.render.streaming as TS
import ipu_ray_lib_tpu_torch.scene.build as TB
from ipu_ray_lib_tpu_torch.render.renderer import render
from ipu_ray_lib_tpu_torch.scene import builtin as PB

MONKEY = os.path.join(os.path.dirname(__file__), "..", "assets",
                      "monkey_bust.glb")
SIZE, SPP = 32, 8
DISC, RIGHT_WALL = 10, 3


def _route(method):
    """(JAX mean, port mean, JAX first-hit ids, port first-hit ids) of
    Cornell + monkey through ``method``."""
    kw = dict(image_width=SIZE, image_height=SIZE, samples_per_pixel=SPP,
              intersector=method)
    arrays, jparams, _ = jax_build_scene(
        JB.make_cornell_box_scene(MONKEY, box_only=False), **kw)
    ts, params = TB.build_scene(
        PB.make_cornell_box_scene(MONKEY, box_only=False), device="cpu", **kw)
    want, _ = jax_streaming(arrays, jparams, spp=SPP)
    got, done = TS.render_streaming(ts, params, spp=SPP)
    assert done == SIZE * SIZE * SPP
    jids = np.asarray(jax_render(arrays, jparams, mode="shadow-trace",
                                 chunk_size=1024).geom_id).ravel()
    ids = render(ts, params, mode="shadow-trace",
                 chunk_size=1024).geom_id.ravel()
    return float(np.asarray(want).mean()), float(got.mean()), jids, ids


def test_megakernel_and_bvh_split_on_the_coplanar_disc():
    mega, walk = _route("pallas"), _route("bvh")
    jax_gap = walk[0] / mega[0] - 1.0
    port_gap = walk[1] / mega[1] - 1.0
    print(f"means at {SIZE}x{SIZE} spp {SPP}: JAX megakernel {mega[0]:.6f}, "
          f"XLA loop through bvh {walk[0]:.6f} (+{jax_gap:.4f}); port "
          f"{mega[1]:.6f}, {walk[1]:.6f} (+{port_gap:.4f})")
    # The XLA loop is the JAX package's image; the megakernels agree in
    # mean (their images differ where a path's decision flips):
    assert walk[1] == walk[0]
    assert abs(mega[1] / mega[0] - 1.0) < 5e-3
    # Both packages split the same way, by far more than the megakernel
    # and the XLA loop differ on the box without a light on the wall
    # (tests/test_torch_intersector_routes.py, 2%):
    assert jax_gap > 0.05 and abs(port_gap - jax_gap) < 0.01
    # The tie: where the walk's first hit is the disc, the megakernel
    # route's is the wall, in both packages.
    for j, p in ((mega[2], mega[3]), (walk[2], walk[3])):
        assert np.array_equal(j, p)
    on_disc = walk[3] == DISC
    assert on_disc.sum() >= 2
    assert (mega[3][on_disc] == RIGHT_WALL).all()
    assert ((mega[3] != walk[3]) <= on_disc).all()
