"""One process of a multi-process mesh of the port (torch.distributed, gloo).

Each process joins the group at ``tcp://127.0.0.1:<port>``, offers
``--shards`` shards of ``--device`` to the mesh (``make_ray_mesh``: the
global mesh is every rank's shards in rank order) and renders the
Cornell box with ``render_streaming_sharded`` (``--per-sample``: the
per-sample wavefront, ``render_path_sharded`` over the window's pixels in
scanline order, keyed ``PRNGKey(rng_seed)``, ``done`` 0); it renders
only its own shards, and every rank gets the whole image. Each rank
writes its image and ``done`` to ``<out>`` (a .npz) for the caller to
compare.

    python tests/torch_multihost_worker.py <port> <rank> <world> <out> \
        [--device cpu] [--shards 4] [--size 48] [--spp 2] \
        [--chunk-slots 256] [--monkey] [--per-sample]

It imports torch and the port only, so it runs on a card's machine too
(``--device cuda:0``; the host gathers over gloo either way).
"""

import argparse
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

from ipu_ray_lib_tpu_torch.ops.camera import pixel_grid  # noqa: E402
from ipu_ray_lib_tpu_torch.parallel import (make_ray_mesh,  # noqa: E402
                                            render_path_sharded,
                                            render_streaming_sharded,
                                            shard_rays)
from ipu_ray_lib_tpu_torch.scene.build import build_scene  # noqa: E402
from ipu_ray_lib_tpu_torch.scene.builtin import (  # noqa: E402
    make_cornell_box_scene)
from ipu_ray_lib_tpu_torch.utils.threefry import PRNGKey  # noqa: E402


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("port", type=int)
    ap.add_argument("rank", type=int)
    ap.add_argument("world", type=int)
    ap.add_argument("out")
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--shards", type=int, default=4)
    ap.add_argument("--size", type=int, default=48)
    ap.add_argument("--spp", type=int, default=2)
    ap.add_argument("--chunk-slots", type=int, default=256)
    ap.add_argument("--monkey", action="store_true",
                    help="Cornell + monkey (default: the box only)")
    ap.add_argument("--per-sample", action="store_true",
                    help="render_path_sharded (default: the streaming "
                         "render)")
    a = ap.parse_args()
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{a.port}",
                            world_size=a.world, rank=a.rank)
    try:
        mesh_file = (os.path.join(ROOT, "assets", "monkey_bust.glb")
                     if a.monkey else None)
        scene, params = build_scene(
            make_cornell_box_scene(mesh_file, box_only=not a.monkey),
            device=a.device, image_width=a.size, image_height=a.size,
            samples_per_pixel=a.spp)
        mesh = make_ray_mesh([a.device] * a.shards)
        assert len(mesh) == a.world * a.shards, mesh
        if a.per_sample:
            rows, cols = pixel_grid(a.size, a.size, 0, 0, "cpu")
            pad = shard_rays(a.size * a.size, mesh) - a.size * a.size
            rgb = render_path_sharded(
                scene, params, torch.nn.functional.pad(rows, (0, pad)),
                torch.nn.functional.pad(cols, (0, pad)),
                PRNGKey(params.rng_seed), mesh).numpy()
            done = 0
        else:
            rgb, done = render_streaming_sharded(scene, params, mesh,
                                                 chunk_slots=a.chunk_slots)
        np.savez(a.out, rgb=rgb, done=done, shards=len(mesh),
                 local=np.asarray(mesh.local))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
