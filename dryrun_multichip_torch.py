"""Multi-device dry run of the PyTorch port (the counterpart of
``__graft_entry__.dryrun_multichip``).

Renders the port's sharded paths once on a mesh of n CPU shards, in a
subprocess of its own, and checks shapes, ``done`` and finiteness:

* ``render_shadow_sharded`` over the 16x16 Cornell frame;
* ``render_streaming_sharded`` on the XLA-loop route (``chunk_slots=32``);
* the megakernel route (48x48, ``chunk_slots=256``);
* the batched-spp branch (spp 3 in batches of 2 + 1) with a progress
  callback.

    python3 dryrun_multichip_torch.py [n]      # default 8
"""

from __future__ import annotations

import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def dryrun_multichip(n_devices: int, timeout: float = 600.0) -> None:
    """Run :func:`_dryrun_body` for ``n_devices`` CPU shards in a fresh
    process; raises if it fails or outlasts ``timeout`` seconds."""
    code = (f"import sys; sys.path.insert(0, {HERE!r}); "
            f"from dryrun_multichip_torch import _dryrun_body; "
            f"_dryrun_body({int(n_devices)})")
    proc = subprocess.run([sys.executable, "-c", code], timeout=timeout)
    if proc.returncode != 0:
        raise RuntimeError(
            f"multichip dryrun subprocess failed (rc={proc.returncode})")


def _dryrun_body(n_devices: int) -> None:
    """The sharded renders on n CPU shards."""
    import numpy as np
    import torch

    from ipu_ray_lib_tpu_torch.parallel import (make_ray_mesh,
                                                render_shadow_sharded,
                                                render_streaming_sharded,
                                                shard_plan, shard_rays)
    from ipu_ray_lib_tpu_torch.render.streaming import uses_megakernel
    from ipu_ray_lib_tpu_torch.scene.build import build_scene
    from ipu_ray_lib_tpu_torch.scene.builtin import make_cornell_box_scene

    torch.set_num_threads(1)
    mesh = make_ray_mesh(["cpu"] * n_devices)
    assert len(mesh) == n_devices

    def small(size, spp):
        return build_scene(make_cornell_box_scene(None, box_only=False),
                           device="cpu", image_width=size, image_height=size,
                           samples_per_pixel=spp)

    scene, params = small(16, 2)
    rr, cc = np.meshgrid(np.arange(16), np.arange(16), indexing="ij")
    n = shard_rays(rr.size, mesh)
    rows = np.pad(rr.ravel().astype(np.float32), (0, n - rr.size))
    cols = np.pad(cc.ravel().astype(np.float32), (0, n - cc.size))
    res = render_shadow_sharded(scene, params, rows, cols, mesh)
    assert res.rgb.shape == (n, 3)
    assert bool(torch.isfinite(res.rgb).all())

    # The XLA-loop route: a pool of at most 32 slots per shard.
    assert not uses_megakernel(shard_plan(params, n_devices, 32).slots, None)
    img, done = render_streaming_sharded(scene, params, mesh, spp=2,
                                         chunk_slots=32)
    assert img.shape == (16, 16, 3)
    assert done == 16 * 16 * 2
    assert bool(np.isfinite(img).all())

    # The megakernel route: pools that tile into 256.
    scene48, params48 = small(48, 1)
    assert uses_megakernel(shard_plan(params48, n_devices, 256).slots,
                           None)
    img, done = render_streaming_sharded(scene48, params48, mesh, spp=1,
                                         chunk_slots=256)
    assert img.shape == (48, 48, 3)
    assert done == 48 * 48
    assert bool(np.isfinite(img).all())

    # The batched-spp branch (batches of 2 and 1) with its callback.
    seen = []
    img, done = render_streaming_sharded(
        scene48, params48, mesh, spp=3, chunk_slots=256, spp_batch=2,
        progress_callback=lambda bi, im: seen.append((bi, float(im.mean()))))
    assert img.shape == (48, 48, 3)
    assert done == 48 * 48 * 3
    assert [bi for bi, _ in seen] == [0, 1]
    assert all(np.isfinite(m) for _, m in seen)
    print(f"dryrun_multichip_torch: {n_devices} shards OK")


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8)
