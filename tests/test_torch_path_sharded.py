"""``render_path_sharded`` (parallel/mesh.py), the per-sample path trace
sharded over a mesh, against the JAX package's on the CPU.

* The Cornell box at 20x20 spp 2, its 400 pixels padded to the mesh, on
  meshes of 2 and 8 CPU shards, equals the JAX package's
  ``render_path_sharded`` on meshes of 2 and 8 of the conftest's virtual
  CPU devices bit for bit: shard i keyed ``fold_in(key, i)``.
* Lit by the urban_4k NIF (spheres scene, 2 shards) it holds
  tests/test_torch_env.py's split tolerance.
* Two gloo processes of one shard each (tests/torch_multihost_worker.py
  ``--per-sample``) give the image of one process on 2 shards, bit for
  bit.
* Rays that do not divide over the mesh are refused.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import functools
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ipu_ray_lib_tpu.nif.model import load_nif_env as jax_load_nif_env
from ipu_ray_lib_tpu.ops.camera import pixel_grid as jax_grid
from ipu_ray_lib_tpu.parallel.mesh import make_ray_mesh as jax_mesh
from ipu_ray_lib_tpu.parallel.mesh import render_path_sharded as jax_rps
from ipu_ray_lib_tpu.parallel.mesh import shard_rays as jax_shard_rays
from ipu_ray_lib_tpu.scene.build import build_scene as jax_build_scene
from ipu_ray_lib_tpu.scene import builtin as JB
from ipu_ray_lib_tpu_torch.nif.model import load_nif_env
from ipu_ray_lib_tpu_torch.ops import intersect_kernel as ik
from ipu_ray_lib_tpu_torch.parallel import (make_ray_mesh,
                                            render_path_sharded)
from ipu_ray_lib_tpu_torch.scene.build import build_scene
from ipu_ray_lib_tpu_torch.scene import builtin as PB
from ipu_ray_lib_tpu_torch.utils import threefry as tf
from test_torch_env import hold_high_frequency, split
from test_torch_parallel_multihost import run_workers

URBAN = os.path.join(os.path.dirname(__file__), "..", "assets", "nif",
                     "synthetic_urban_4k")
SIZE = 20


@functools.lru_cache(maxsize=None)
def _builds(scene: str):
    jmake = {"cornell": lambda: JB.make_cornell_box_scene(None),
             "spheres": JB.make_primitive_scene}[scene]
    pmake = {"cornell": lambda: PB.make_cornell_box_scene(None),
             "spheres": PB.make_primitive_scene}[scene]
    kw = dict(image_width=SIZE, image_height=SIZE, samples_per_pixel=2)
    arrays, jparams, _ = jax_build_scene(jmake(), intersector="pallas", **kw)
    ts, params = build_scene(pmake(), device="cpu", **kw)
    return arrays, jparams, ts, params


def _grid(mesh):
    rows, cols = jax_grid(SIZE, SIZE, 0, 0)
    n = jax_shard_rays(SIZE * SIZE, mesh)
    return (jnp.pad(rows, (0, n - SIZE * SIZE)),
            jnp.pad(cols, (0, n - SIZE * SIZE)))


@pytest.mark.parametrize("n", [2, 8])
def test_matches_jax_mesh(n):
    arrays, jparams, ts, params = _builds("cornell")
    jm = jax_mesh(jax.devices()[:n])
    rows, cols = _grid(jm)
    want = np.asarray(jax_rps(arrays, jparams, rows, cols,
                              jax.random.PRNGKey(jparams.rng_seed), jm))
    ik.reset_launches()
    stats = {}
    got = render_path_sharded(ts, params, np.asarray(rows), np.asarray(cols),
                              tf.PRNGKey(params.rng_seed),
                              make_ray_mesh(["cpu"] * n), stats=stats)
    assert ik.launches == 0
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.array_equal(got.numpy(), want)
    assert stats["bounces"] >= 2 * n and float(got.mean()) > 0.01


def test_nif_holds_split_tolerance():
    arrays, jparams, ts, params = _builds("spheres")
    jm = jax_mesh(jax.devices()[:2])
    rows, cols = _grid(jm)
    env_fn, env_params = jax_load_nif_env(URBAN)
    want = np.asarray(jax_rps(arrays, jparams, rows, cols,
                              jax.random.PRNGKey(jparams.rng_seed), jm,
                              env_fn=env_fn, env_params=env_params))
    got = render_path_sharded(ts, params, np.asarray(rows), np.asarray(cols),
                              tf.PRNGKey(params.rng_seed),
                              make_ray_mesh(["cpu"] * 2),
                              env=load_nif_env(URBAN, device="cpu"))
    assert float(got.mean()) > 0.1
    hold_high_frequency(split(got.numpy(), want))


def test_two_processes_equal_one_process(tmp_path):
    _, _, ts, params = _builds("cornell")
    rows, cols = _grid(jax_mesh(jax.devices()[:2]))
    one = render_path_sharded(ts, params, np.asarray(rows), np.asarray(cols),
                              tf.PRNGKey(params.rng_seed),
                              make_ray_mesh(["cpu"] * 2)).numpy()
    ranks = run_workers(tmp_path, world=2, shards=1, extra=[
        "--per-sample", "--size", str(SIZE), "--spp", "2"])
    assert [local for _, _, local in ranks] == [[0], [1]]
    for rgb, _, _ in ranks:
        assert rgb.dtype == np.float32 and np.array_equal(rgb, one)


def test_rays_must_divide_over_the_mesh():
    _, _, ts, params = _builds("cornell")
    rows = np.zeros(7, np.float32)
    with pytest.raises(ValueError, match="shard_rays"):
        render_path_sharded(ts, params, rows, rows, tf.PRNGKey(1),
                            make_ray_mesh(["cpu"] * 2))
