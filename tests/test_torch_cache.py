"""The port's compiled-scene cache (``scene/cache.py``).

* A save/load round trip equals a fresh ``build_scene`` bit for bit, every
  tensor of the ``TorchScene`` (and ``pbox``'s absence in HBM mode, and
  ``payload_split``) and the ``SceneParams``: a triangle-only scene (the
  Cornell box), a mixed scene below the VMEM ceiling (Cornell + monkey,
  spheres, disc), a scene in HBM mode with the bf16 payload (stress grid
  24, ``payload_split=True``), and a mixed scene above the ceiling
  (stress grid 183: 66,248 triangles and a disc).
* The JAX package's own round trip on that last scene changes its tables
  (``pn8`` and ``tri_prim``): its load rebuilds them without the scene
  BVH's triangle order (``ipu_ray_lib_tpu/scene/cache.py:74-83``). A
  fault of the reference, recorded in ROADMAP queue 3.
* Bundles are not interchangeable: the port refuses the JAX package's, and
  the JAX package's loader fails on the port's.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import dataclasses
import os

import numpy as np
import pytest
import torch

from ipu_ray_lib_tpu.scene.build import build_scene as jax_build_scene
from ipu_ray_lib_tpu.scene.builtin import make_stress_scene as jax_stress
from ipu_ray_lib_tpu.scene.cache import load_compiled_scene as jax_load
from ipu_ray_lib_tpu.scene.cache import save_compiled_scene as jax_save
from ipu_ray_lib_tpu_torch.scene.build import TorchScene, build_scene
from ipu_ray_lib_tpu_torch.scene.builtin import (make_cornell_box_scene,
                                                 make_stress_scene)
from ipu_ray_lib_tpu_torch.scene.cache import (FORMAT, load_compiled_scene,
                                               save_compiled_scene)

MONKEY = os.path.join(os.path.dirname(__file__), "..", "assets",
                      "monkey_bust.glb")

SCENES = {
    "triangles": (lambda: make_cornell_box_scene(None, box_only=True), {}),
    "mixed": (lambda: make_cornell_box_scene(MONKEY, box_only=False), {}),
    "hbm-bf16": (lambda: make_stress_scene(24),
                 dict(intersector="pallas-hbm", payload_split=True)),
    "mixed-above-ceiling": (lambda: make_stress_scene(183), {}),
}


def assert_same_scene(a: TorchScene, b: TorchScene):
    for f in dataclasses.fields(TorchScene):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, torch.Tensor):
            assert isinstance(y, torch.Tensor), f.name
            assert x.dtype == y.dtype and x.shape == y.shape, f.name
            assert x.device == y.device, f.name
            assert torch.equal(x.view(torch.int32) if x.is_floating_point()
                               else x, y.view(torch.int32)
                               if y.is_floating_point() else y), f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("name", list(SCENES))
def test_round_trip_equals_fresh_build(tmp_path, name):
    make, kw = SCENES[name]
    fresh, params = build_scene(make(), device="cpu", image_width=24,
                                image_height=16, samples_per_pixel=2,
                                rng_seed=9, anti_alias_scale=0.5, **kw)
    path = str(tmp_path / "scene.tprs")
    save_compiled_scene(path, fresh, params)
    loaded, params2 = load_compiled_scene(path, "cpu")
    assert params2 == params
    assert_same_scene(loaded, fresh)
    if name.startswith("hbm"):
        assert loaded.pbox is None and loaded.payload_split
    if name == "mixed-above-ceiling":
        assert params.intersector == "pallas-hbm"


def test_jax_round_trip_changes_mixed_tables_above_ceiling(tmp_path):
    """The reference's fault (ROADMAP queue 3): after its own round trip
    the blocked tables of a mixed scene above the VMEM ceiling are not the
    fresh build's; the block boxes stay, the rows within them move."""
    arrays, params, bvh = jax_build_scene(
        jax_stress(183), image_width=16, image_height=16,
        samples_per_pixel=1, intersector="pallas-hbm")
    path = str(tmp_path / "jax.tprs")
    jax_save(path, arrays, params, bvh)
    arrays2, _, _ = jax_load(path)
    a, b = arrays.blocked, arrays2.blocked
    np.testing.assert_array_equal(np.asarray(a.baabb), np.asarray(b.baabb))
    assert not np.array_equal(np.asarray(a.tri_prim), np.asarray(b.tri_prim))
    assert not np.array_equal(np.asarray(a.pn8), np.asarray(b.pn8))


def test_jax_bundle_is_refused(tmp_path):
    arrays, params, bvh = jax_build_scene(
        make_cornell_box_scene(None, box_only=True), image_width=16,
        image_height=16, samples_per_pixel=1, intersector="pallas")
    path = str(tmp_path / "jax.tprs")
    jax_save(path, arrays, params, bvh)
    with pytest.raises(ValueError, match="not a compiled-scene bundle"):
        load_compiled_scene(path, "cpu")


def test_port_bundle_fails_in_the_jax_loader(tmp_path):
    scene, params = build_scene(make_cornell_box_scene(None, box_only=True),
                                device="cpu", image_width=16,
                                image_height=16, samples_per_pixel=1)
    path = str(tmp_path / "port.tprs")
    save_compiled_scene(path, scene, params)
    with pytest.raises(KeyError):
        jax_load(path)
    from ipu_ray_lib_tpu_torch.scene.serial import Deserialiser

    with open(path, "rb") as f:
        assert Deserialiser(f.read()).meta["format"] == FORMAT
