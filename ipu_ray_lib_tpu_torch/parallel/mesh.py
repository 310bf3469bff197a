"""Data-parallel rendering over several devices (port of
``ipu_ray_lib_tpu/parallel/mesh.py``).

The reference scales by replicating the whole scene on every replica and
giving each its own batch of rays and its own RNG seed, with no
collectives while it renders (ref: trace.cpp:296-307,
src/IpuScene.cpp:648-684). Here:

* a mesh is an ordered list of shards, each a ``torch.device``; a device
  may appear more than once (its shards then run in turn on its stream);
* the scene (and a NIF environment light) is copied once to each distinct
  device of the mesh;
* the tile-ordered pixel stream is cut into one contiguous slice per shard
  (``shard_plan``), each rendered by the single-device integrators with
  its own seed: a jump-separated xoroshiro128** stream per shard
  (``utils/xoshiro.py``), folded to the kernels' u32 seed;
* the per-sample path trace (``render_path_sharded``) cuts a ray batch
  into equal slices instead, shard i keyed ``fold_in(key, i)`` from the
  jax-free threefry (``utils/threefry.py``), as the JAX package keys its
  shards by ``axis_index``;
* the host reads the slices back and assembles the image.

Under ``torch.distributed`` the mesh spans every process: each process
contributes its own shards, in rank order, and renders only those. The
slices are gathered to every process on the host over a gloo group (NCCL
cannot put two processes on one card), so every process returns the same
image.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..nif.model import NifEnv
from ..ops.camera import generate_camera_rays
from ..render.pixels import PixelStream, pixel_stream
from ..render.renderer import path_chunk
from ..render.shadow import TraceResultSoA, shadow_trace
from ..render.streaming import MAX_K_PER_DISPATCH, trace_batch
from ..runtime.device import cuda_device
from ..utils import threefry
from ..utils.profiling import span
from ..utils.xoshiro import derive_replica_seeds

_U32 = 0xFFFFFFFF
BATCH_SEED_STRIDE = 0x85EBCA6B  # per spp batch, added to every shard's seed


@dataclass(frozen=True)
class RayMesh:
    """The shards of a mesh, in order: ``devices[i]`` renders shard i in
    process ``ranks[i]``; this process is ``rank`` of ``world``, and
    ``group`` is the gloo group the host gathers over (None: the default
    group, or one process)."""

    devices: tuple
    ranks: tuple
    rank: int = 0
    world: int = 1
    group: object = None

    def __len__(self) -> int:
        return len(self.devices)

    def __iter__(self):
        return iter(self.devices)

    def __getitem__(self, i: int) -> torch.device:
        return self.devices[i]

    @property
    def local(self) -> list[int]:
        """The shards this process renders."""
        return [i for i, r in enumerate(self.ranks) if r == self.rank]


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    return d


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


# (the default group, the gloo group made for it): made once, as every
# process makes its meshes in the same order.
_HOST_GROUP: tuple = (None, None)


def _host_group():
    """The group the host gathers over: the default group when it is gloo,
    else one gloo group per default group (NCCL cannot gather host values
    of two processes on one card)."""
    global _HOST_GROUP
    if dist.get_backend() == "gloo":
        return None
    if _HOST_GROUP[0] is not dist.group.WORLD:
        _HOST_GROUP = (dist.group.WORLD, dist.new_group(backend="gloo"))
    return _HOST_GROUP[1]


def make_ray_mesh(devices=None) -> RayMesh:
    """A mesh of this process's ``devices``. The default is every CUDA card,
    or under ``torch.distributed`` the process's current card (one card per
    process: set it with ``torch.cuda.set_device``); it raises when no card
    is present. With ``torch.distributed`` initialised the mesh spans every
    process's shards, in rank order (one gather of the device names,
    here)."""
    if devices is None:
        if _distributed():
            local = [cuda_device(torch.cuda.current_device()
                                 if torch.cuda.is_available() else 0)]
        else:
            local = [cuda_device(i)
                     for i in range(max(torch.cuda.device_count(), 1))]
    else:
        local = [_device(d) for d in devices]
    if not local:
        raise ValueError("a mesh needs at least one device")
    if not _distributed():
        return RayMesh(tuple(local), (0,) * len(local))
    world, rank = dist.get_world_size(), dist.get_rank()
    group = _host_group()
    names = [None] * world
    dist.all_gather_object(names, [str(d) for d in local], group=group)
    devs = [torch.device(d) for part in names for d in part]
    ranks = [r for r, part in enumerate(names) for _ in part]
    return RayMesh(tuple(devs), tuple(ranks), rank, world, group)


def shard_rays(n: int, mesh: RayMesh) -> int:
    """Round n up so it divides evenly across the mesh (the analogue of the
    reference's equal-batches-per-replica padding, IpuScene.cpp:93-95)."""
    d = len(mesh)
    return -(-n // d) * d


def _gather(mesh: RayMesh, local: dict) -> list:
    """Every shard's host value, in shard order: this process's ``local``
    ({shard: value}) and, under torch.distributed, the other processes'."""
    parts = [local]
    if mesh.world > 1:
        parts = [None] * mesh.world
        dist.all_gather_object(parts, local, group=mesh.group)
    merged = {}
    for p in parts:
        merged.update(p)
    return [merged[i] for i in range(len(mesh))]


def _replicas(obj, mesh: RayMesh) -> dict:
    """``obj`` (a TorchScene or a NifEnv) on each distinct device of this
    process's shards, copied once per device (the caller's stays put)."""
    out = {}
    for i in mesh.local:
        d = mesh[i]
        if d not in out:
            if obj.device == d:
                out[d] = obj
            elif isinstance(obj, torch.nn.Module):
                out[d] = copy.deepcopy(obj).to(d)
            else:
                out[d] = obj.to(d)
    return out


@dataclass(frozen=True)
class ShardPlan:
    """How a frame's pixel stream is cut over ``n`` shards (the JAX
    package's per-device slicing, mesh.py:130-168): shard i renders the
    padded-stream pixels [i*R*J, (i+1)*R*J) of ``stream`` with a pool of
    R = ``slots`` slots of J = ``j_per_slot`` pixels each, of which the
    first ``n_valid[i]`` are real."""

    stream: PixelStream
    slots: int
    j_per_slot: int
    n_valid: tuple
    width: int
    height: int

    def coords(self, i: int, dev) -> tuple:
        """Shard i's (rows, cols) [R*J] f32 on ``dev``: its slice of the
        stream padded to every shard's."""
        size = self.slots * self.j_per_slot
        return tuple(a[i * size:(i + 1) * size] for a in
                     self.stream.coords(dev, len(self.n_valid) * size))

    def assemble(self, flats) -> np.ndarray:
        """The window image [H, W, 3] f32 from every shard's [R*J, 3]."""
        return self.stream.scatter(
            np.concatenate([np.asarray(f) for f in flats]).reshape(-1, 3))


def shard_plan(params, n: int, chunk_slots: int = 1 << 17) -> ShardPlan:
    """The stream of ``params``'s window cut over ``n`` shards:
    ``per_dev = ceil(n_pix / n)``, R = min(chunk_slots, per_dev) (not
    rounded to 256), J = ceil(per_dev / R)."""
    n_pix = params.window_w * params.window_h
    per_dev = -(-n_pix // n)
    R = min(chunk_slots, per_dev)
    J = -(-per_dev // R)
    n_valid = tuple(int(np.clip(n_pix - i * R * J, 0, R * J))
                    for i in range(n))
    return ShardPlan(pixel_stream(params), R, J, n_valid, params.window_w,
                     params.window_h)


def shard_seeds(rng_seed: int, n: int, batch: int) -> np.ndarray:
    """Each shard's u32 seed for spp batch ``batch`` (the JAX package's
    mesh.py:276-294): the shard's jump-separated u64 seed folded to 32
    bits, plus the batch stride, with wraparound."""
    rep64 = derive_replica_seeds(rng_seed, n)
    rep32 = ((rep64 ^ (rep64 >> np.uint64(32)))
             & np.uint64(_U32)).astype(np.uint32)
    return rep32 + np.uint32((BATCH_SEED_STRIDE * batch) & _U32)


def render_streaming_sharded(scene, params, mesh: RayMesh,
                             spp: int | None = None,
                             chunk_slots: int = 1 << 17, env=None,
                             progress_callback=None, spp_batch: int = 64,
                             readback_f16: bool = False):
    """The streaming path trace of ``params``'s window with its pixel
    stream sharded over ``mesh`` (port of ``render_streaming_sharded``,
    mesh.py:107-311). Returns (rgb [H, W, 3] f32 numpy, done), the same in
    every process.

    spp renders in batches of at most ``spp_batch`` samples (and
    ``MAX_K_PER_DISPATCH`` paths per slot), batch b weighted b/spp on the
    device and accumulated in batch order; ``progress_callback(bi, rgb)``
    gets the running average after each. ``env`` lights escaped paths as
    :func:`~ipu_ray_lib_tpu_torch.render.streaming.render_streaming` takes
    it. ``readback_f16``: the accumulated slices are rounded to f16 on the
    device before they are read back."""
    spp = params.samples_per_pixel if spp is None else int(spp)
    n = len(mesh)
    with span("mesh.setup"):
        plan = shard_plan(params, n, chunk_slots)
        scenes = _replicas(scene, mesh)
        envs = _replicas(env, mesh) if isinstance(env, NifEnv) else {}
        streams = {i: plan.coords(i, mesh[i]) for i in mesh.local}

    def host(acc):
        with span("mesh.gather"):
            return _gather(mesh, {i: a.cpu().numpy() for i, a in acc.items()})

    b_cap = max(1, MAX_K_PER_DISPATCH // plan.j_per_slot)
    acc, done = {}, {}
    s = bi = 0
    while s < spp:
        b = min(spp_batch, b_cap, spp - s)
        seeds = shard_seeds(params.rng_seed, n, bi)
        wgt = float(np.float32(b / spp))
        # Every local shard's batch is enqueued before any is read back.
        with span("mesh.dispatch"):
            for i in mesh.local:
                d = mesh[i]
                flat_b, done_b = trace_batch(
                    scenes[d], *streams[i], int(seeds[i]), plan.n_valid[i],
                    params=params, slots=plan.slots,
                    j_per_slot=plan.j_per_slot, spp=b,
                    env=envs.get(d, env))
                if i in acc:
                    acc[i] = acc[i] + flat_b * wgt
                    done[i] = done[i] + done_b
                else:
                    acc[i], done[i] = flat_b * wgt, done_b
        s += b
        if progress_callback is not None:
            progress_callback(bi, plan.assemble(host(acc))
                              * np.float32(spp / s))
        bi += 1

    if readback_f16:
        acc = {i: a.to(torch.float16) for i, a in acc.items()}
    parts = host(acc)
    with span("mesh.assemble"):
        img = plan.assemble(parts)
        n_done = sum(_gather(mesh, {i: int(d) for i, d in done.items()}))
    return img, n_done


def render_shadow_sharded(scene, params, rows, cols,
                          mesh: RayMesh) -> TraceResultSoA:
    """Shadow-trace camera rays through pixels (rows, cols) [n] sharded over
    ``mesh`` (port of mesh.py:314-337): shard i traces the i-th of n/len(mesh)
    equal contiguous slices with ``params.intersector`` (the fused kernel K4
    on a ``pallas`` scene, the glue route on ``pallas-hbm``). Returns one
    TraceResultSoA of CPU tensors in shard order."""
    rows, cols, per = _equal_slices(rows, cols, mesh)
    scenes = _replicas(scene, mesh)
    out = {}
    for i in mesh.local:
        d = mesh[i]
        _, dirs = generate_camera_rays(
            rows[i * per:(i + 1) * per].to(d),
            cols[i * per:(i + 1) * per].to(d), params.image_width,
            params.image_height, params.fov_radians)
        out[i] = shadow_trace(scenes[d], None, dirs,
                              intersector=params.intersector)
    parts = _gather(mesh, {i: TraceResultSoA(*(t.cpu() for t in r))
                           for i, r in out.items()})
    return TraceResultSoA(*(torch.cat(f) for f in zip(*parts)))


def _equal_slices(rows, cols, mesh: RayMesh):
    """(rows, cols) as CPU f32 tensors and the length of each shard's
    slice; raises unless they divide evenly over the mesh."""
    rows = torch.from_numpy(np.array(rows, np.float32))
    cols = torch.from_numpy(np.array(cols, np.float32))
    n = rows.shape[0]
    if n % len(mesh):
        raise ValueError(f"{n} rays do not divide over {len(mesh)} shards "
                         "(pad them with shard_rays)")
    return rows, cols, n // len(mesh)


def render_path_sharded(scene, params, rows, cols, key: torch.Tensor,
                        mesh: RayMesh, env=None, spp: int | None = None,
                        stats: dict | None = None) -> torch.Tensor:
    """Per-sample path trace of camera rays through pixels (rows, cols)
    [n] sharded over ``mesh`` (port of ``render_path_sharded``,
    mesh.py:51-104): shard i traces the i-th of n/len(mesh) equal
    contiguous slices, ``spp`` samples (default
    ``params.samples_per_pixel``) under ``fold_in(key, i)`` (``key`` a
    threefry key, utils/threefry.py), lit by ``env`` as
    ``render(streaming=False)`` lights them. Returns the spp-averaged rgb
    [n, 3], a CPU f32 tensor in shard order, the same in every process.
    ``stats`` gains this process's ``bounces`` and ``syncs``."""
    rows, cols, per = _equal_slices(rows, cols, mesh)
    scenes = _replicas(scene, mesh)
    envs = _replicas(env, mesh) if isinstance(env, NifEnv) else {}
    key = torch.as_tensor(key, dtype=torch.int64).cpu()
    out = {}
    for i in mesh.local:
        d = mesh[i]
        rgb, _ = path_chunk(
            scenes[d], params, rows[i * per:(i + 1) * per].to(d),
            cols[i * per:(i + 1) * per].to(d),
            threefry.fold_in(key, i), env=envs.get(d, env), spp=spp,
            stats=stats)
        out[i] = rgb
    parts = _gather(mesh, {i: r.cpu() for i, r in out.items()})
    return torch.cat(parts)
