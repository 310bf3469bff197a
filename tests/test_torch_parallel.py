"""The port's multi-device rendering on the CPU: the mesh, the shard plan,
the seeds, and the megakernel route against the JAX package's device mesh.

* ``Xoroshiro128`` and ``derive_replica_seeds`` give the JAX package's u64
  streams.
* ``render_streaming_sharded`` on the Cornell box (box only) at 48x48
  spp 2, ``chunk_slots=256`` (R = 256 per shard, so the megakernel route),
  on meshes of 2 and 8 CPU shards, equals the JAX package's
  ``render_streaming_sharded`` on meshes of 2 and 8 of the conftest's
  virtual CPU devices bit for bit, image and ``done``. The 8-shard mesh
  has empty trailing shards (n_valid 256, 0, 0, 0).
* With ``readback_f16`` it equals the JAX render under
  ``RAY_READBACK_F16=1`` bit for bit.

The other routes are in tests/test_torch_parallel_routes.py, the
multi-process mesh in tests/test_torch_parallel_multihost.py.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import numpy as np
import pytest
import torch

import jax

from ipu_ray_lib_tpu.parallel.mesh import make_ray_mesh as jax_mesh
from ipu_ray_lib_tpu.parallel.mesh import (
    render_streaming_sharded as jax_sharded)
from ipu_ray_lib_tpu.scene.build import build_scene as jax_build_scene
from ipu_ray_lib_tpu.scene.builtin import make_cornell_box_scene as jax_cornell
from ipu_ray_lib_tpu.utils import xoshiro as jx
from ipu_ray_lib_tpu_torch.parallel import (make_ray_mesh,
                                            render_streaming_sharded,
                                            shard_plan, shard_rays,
                                            shard_seeds)
from ipu_ray_lib_tpu_torch.render.streaming import uses_megakernel
from ipu_ray_lib_tpu_torch.scene.build import build_scene
from ipu_ray_lib_tpu_torch.scene.builtin import make_cornell_box_scene
from ipu_ray_lib_tpu_torch.utils import xoshiro as tx

SIZE, SPP, SLOTS = 48, 2, 256


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("seed", [0, 7, 1442, (1 << 64) - 1])
def test_xoroshiro_matches_jax(seed):
    a, b = tx.Xoroshiro128(seed), jx.Xoroshiro128(seed)
    for _ in range(2):
        assert [a.next_u64() for _ in range(16)] == [b.next_u64()
                                                    for _ in range(16)]
        a.jump()
        b.jump()
    assert _same(tx.derive_replica_seeds(seed, 8),
                 jx.derive_replica_seeds(seed, 8))


def test_shard_seeds_fold_and_stride():
    rep = jx.derive_replica_seeds(1442, 3)
    for bi in (0, 1, 5):
        want = [((int(s) ^ (int(s) >> 32)) + 0x85EBCA6B * bi) & 0xFFFFFFFF
                for s in rep]
        got = shard_seeds(1442, 3, bi)
        assert got.dtype == np.uint32 and got.tolist() == want


def test_shard_plan_cuts_the_stream():
    _, params = build_scene(make_cornell_box_scene(None, box_only=True),
                            device="cpu", image_width=SIZE,
                            image_height=SIZE)
    plan = shard_plan(params, 8, SLOTS)
    assert (plan.slots, plan.j_per_slot) == (256, 2)
    assert plan.n_valid == (512, 512, 512, 512, 256, 0, 0, 0)
    shards = [plan.coords(i, torch.device("cpu")) for i in range(8)]
    assert all(r.shape == c.shape == (512,) for r, c in shards)
    assert uses_megakernel(plan.slots, None)
    flat = np.arange(8 * 512 * 3, dtype=np.float32).reshape(8, 512, 3)
    img = plan.assemble(list(flat))
    assert img.shape == (SIZE, SIZE, 3)
    # pixel (r, c) came from the stream position whose coordinates it has
    pos = img[..., 0].astype(np.int64) // 3
    rows = torch.cat([r for r, _ in shards]).numpy()[pos]
    cols = torch.cat([c for _, c in shards]).numpy()[pos]
    rr, cc = np.meshgrid(np.arange(SIZE), np.arange(SIZE), indexing="ij")
    assert _same(rows, rr.astype(np.float32))
    assert _same(cols, cc.astype(np.float32))
    # a pool that does not tile into 256 takes the XLA-loop route
    plan = shard_plan(params, 8, 128)
    assert (plan.slots, plan.j_per_slot) == (128, 3)
    assert not uses_megakernel(plan.slots, None)


def test_mesh_of_repeated_devices():
    mesh = make_ray_mesh(["cpu", "cpu", "cpu"])
    assert len(mesh) == 3 and mesh.local == [0, 1, 2]
    assert all(d == torch.device("cpu") for d in mesh)
    assert shard_rays(1000, mesh) == 1002 and shard_rays(999, mesh) == 999


def test_default_mesh_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_ray_mesh()


def test_distributed_mesh_one_card_and_one_gloo_group(monkeypatch):
    """Under torch.distributed with another backend than gloo, every mesh
    gathers over one gloo group, made at the first mesh; by default a
    process takes its current card only."""
    import types

    import torch.distributed as dist

    from ipu_ray_lib_tpu_torch.parallel import mesh as mesh_mod

    made = []
    world = object()
    monkeypatch.setattr(mesh_mod, "_HOST_GROUP", (None, None))
    monkeypatch.setattr(mesh_mod, "_distributed", lambda: True)
    monkeypatch.setattr(dist, "get_backend", lambda: "nccl")
    monkeypatch.setattr(dist, "get_world_size", lambda: 1)
    monkeypatch.setattr(dist, "get_rank", lambda: 0)
    monkeypatch.setattr(dist, "group", types.SimpleNamespace(WORLD=world))
    monkeypatch.setattr(dist, "new_group",
                        lambda backend: made.append(backend) or len(made))

    def gather(out, obj, group):
        assert group == 1
        out[0] = obj

    monkeypatch.setattr(dist, "all_gather_object", gather)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 1)
    first = make_ray_mesh()
    second = make_ray_mesh(["cpu", "cpu"])
    assert made == ["gloo"] and first.group == second.group == 1
    assert first.devices == (torch.device("cuda", 1),)
    assert second.devices == (torch.device("cpu"),) * 2


@pytest.fixture(scope="module")
def scenes():
    arrays, jp, _ = jax_build_scene(jax_cornell(None, box_only=True),
                                    image_width=SIZE, image_height=SIZE,
                                    samples_per_pixel=SPP,
                                    intersector="pallas")
    ts, tp = build_scene(make_cornell_box_scene(None, box_only=True),
                         device="cpu", image_width=SIZE, image_height=SIZE,
                         samples_per_pixel=SPP)
    return arrays, jp, ts, tp


@pytest.fixture(scope="module")
def jax_refs(scenes):
    """The JAX package's sharded renders: {2, 8} shards, and 2 shards under
    RAY_READBACK_F16=1."""
    arrays, jp, _, _ = scenes
    out = {n: jax_sharded(arrays, jp, jax_mesh(jax.devices()[:n]),
                          chunk_slots=SLOTS) for n in (2, 8)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RAY_READBACK_F16", "1")
        out["f16"] = jax_sharded(arrays, jp, jax_mesh(jax.devices()[:2]),
                                 chunk_slots=SLOTS)
    return out


@pytest.mark.parametrize("n", [2, 8])
def test_megakernel_route_matches_jax(scenes, jax_refs, n):
    _, _, ts, tp = scenes
    want, want_done = jax_refs[n]
    got, done = render_streaming_sharded(ts, tp, make_ray_mesh(["cpu"] * n),
                                         chunk_slots=SLOTS)
    assert done == want_done == SIZE * SIZE * SPP
    assert _same(got, np.asarray(want))


def test_f16_readback_matches_jax(scenes, jax_refs):
    _, _, ts, tp = scenes
    want, want_done = jax_refs["f16"]
    got, done = render_streaming_sharded(ts, tp, make_ray_mesh(["cpu"] * 2),
                                         chunk_slots=SLOTS, readback_f16=True)
    assert done == want_done
    assert _same(got, np.asarray(want))
    f32, _ = jax_refs[2]
    assert _same(got, np.asarray(f32).astype(np.float16).astype(np.float32))

