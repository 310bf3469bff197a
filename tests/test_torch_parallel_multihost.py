"""The port's mesh across processes, and its multi-device dry run, on the
CPU.

Two ``torch.distributed`` processes (gloo) offer 4 CPU shards each to one
8-shard mesh (tests/torch_multihost_worker.py). Each renders only its own
shards, and both return the image that one process gives on 8 shards and
that the JAX package gives on the conftest's 8 virtual devices, bit for
bit (the Cornell box at 48x48 spp 2, ``chunk_slots=256``: the megakernel
route, with empty trailing shards). The workers run under a timeout of
their own, so a hang fails this test rather than the suite.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import jax

from ipu_ray_lib_tpu.parallel.mesh import make_ray_mesh as jax_mesh
from ipu_ray_lib_tpu.parallel.mesh import (
    render_streaming_sharded as jax_sharded)
from ipu_ray_lib_tpu.scene.build import build_scene as jax_build_scene
from ipu_ray_lib_tpu.scene.builtin import make_cornell_box_scene as jax_cornell
from ipu_ray_lib_tpu_torch.parallel import (make_ray_mesh,
                                            render_streaming_sharded)
from ipu_ray_lib_tpu_torch.scene.build import build_scene
from ipu_ray_lib_tpu_torch.scene.builtin import make_cornell_box_scene

HERE = os.path.dirname(os.path.abspath(__file__))
WORKER_TIMEOUT = 300


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(tmp_path, world=2, shards=4, extra=()):
    """The workers' (rgb, done, local shards), by rank; ``extra``: more
    worker arguments."""
    port = _free_port()
    outs = [str(tmp_path / f"rank{r}.npz") for r in range(world)]
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "torch_multihost_worker.py"),
         str(port), str(r), str(world), outs[r], "--shards", str(shards),
         *extra],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    try:
        logs = [p.communicate(timeout=WORKER_TIMEOUT)[0].decode()
                for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    res = [np.load(o) for o in outs]
    return [(r["rgb"], int(r["done"]), r["local"].tolist()) for r in res]


def test_two_processes_equal_one_process_and_jax(tmp_path):
    arrays, jp, _ = jax_build_scene(jax_cornell(None, box_only=True),
                                    image_width=48, image_height=48,
                                    samples_per_pixel=2,
                                    intersector="pallas")
    want, want_done = jax_sharded(arrays, jp, jax_mesh(jax.devices()[:8]),
                                  chunk_slots=256)
    ts, tp = build_scene(make_cornell_box_scene(None, box_only=True),
                         device="cpu", image_width=48, image_height=48,
                         samples_per_pixel=2)
    one, one_done = render_streaming_sharded(
        ts, tp, make_ray_mesh(["cpu"] * 8), chunk_slots=256)
    assert one_done == want_done == 48 * 48 * 2
    assert np.array_equal(one, np.asarray(want))
    ranks = run_workers(tmp_path)
    assert [local for _, _, local in ranks] == [[0, 1, 2, 3], [4, 5, 6, 7]]
    for rgb, done, _ in ranks:
        assert done == one_done
        assert rgb.dtype == np.float32 and np.array_equal(rgb, one)


def test_dryrun_multichip_torch():
    sys.path.insert(0, os.path.join(HERE, ".."))
    try:
        from dryrun_multichip_torch import dryrun_multichip
    finally:
        sys.path.pop(0)
    dryrun_multichip(2, timeout=WORKER_TIMEOUT)
