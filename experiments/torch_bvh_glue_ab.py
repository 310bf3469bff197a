"""The 1440^2 shadow frame of Cornell + monkey built for the compact BVH
(the ``cornell-monkey-bvh`` configuration), on a CUDA card, in one source
tree: its AOVs through the torch chain and through the kernel route at 12
zooms, and the frame's wall time eager and replayed.

    python3 experiments/torch_bvh_glue_ab.py <tree> [frames]

To compare two versions in one call, unpack the older one into a
directory git ignores and run, in turns (older, newer, newer, older).

It renders one warm-up frame (the graph route captures its chunk loop
there, where the tree has one), then:
- the 12 zooms 0.985 + 0.0025 i (i = 0..11), every AOV read back, each
  through the torch chain (tests/test_torch_bvh_glue.py ``chain_frame``:
  each chunk's ``scaled_ray_dir``, ``render/shadow.py:glue_shadow_trace``
  around K7's two walks, the stores, the readback; ``render`` in a tree
  without it), through ``render`` with no progress callback (the graph's
  replay) and with one (the eager kernel route): each AOV's md5 (equal
  md5s: equal outputs);
- ``frames`` frames (default 60) of each way cycling through the zooms,
  each one's wall time from the call to its arrays on the host, as the
  benchmark's shadow cells take it, in turns: replay, eager, chain;
- the launches of one frame each way (K7's and the glue kernels').
Prints one JSON line: the tree, the md5s and whether they agree, the
frame times' median, p90 and min each way, and the launches.
"""

import dataclasses
import hashlib
import json
import os
import statistics
import sys
import time

tree = os.path.abspath(sys.argv[1])
n_frames = int(sys.argv[2]) if len(sys.argv) > 2 else 60
sys.path[:0] = [tree, os.path.join(tree, "tests")]

import torch  # noqa: E402

from ipu_ray_lib_tpu_torch.ops import bvh as kb  # noqa: E402
from ipu_ray_lib_tpu_torch.ops import shadow as sh  # noqa: E402
from ipu_ray_lib_tpu_torch.render import renderer as R  # noqa: E402
from ipu_ray_lib_tpu_torch.scene.build import build_scene  # noqa: E402
from ipu_ray_lib_tpu_torch.scene.builtin import (  # noqa: E402
    make_cornell_box_scene)

assert R.__file__.startswith(tree), R.__file__
dev = torch.device("cuda", 0)
FULL, CHUNK = 1440, 65536
ZOOMS = [0.985 + 0.0025 * i for i in range(12)]
try:
    from test_torch_bvh_glue import chain_frame  # noqa: E402
except ImportError:  # a tree whose BVH frame is the torch chain
    chain_frame = None

scene, params = build_scene(
    make_cornell_box_scene(os.path.join(tree, "assets", "monkey_bust.glb")),
    device=dev, image_width=FULL, image_height=FULL, intersector="bvh")


def zoomed(zoom):
    return dataclasses.replace(params, fov_radians=params.fov_radians * zoom)


def chain(zoom):
    """The frame through the glue route's torch chain."""
    p = zoomed(zoom)
    if chain_frame is None:
        return R.render(scene, p, chunk_size=CHUNK,
                        progress_callback=lambda i, rgb: None)
    return chain_frame(scene, p, CHUNK, list(R._AOVS))


def replay(zoom):
    return R.render(scene, zoomed(zoom), chunk_size=CHUNK)


def eager(zoom):
    return R.render(scene, zoomed(zoom), chunk_size=CHUNK,
                    progress_callback=lambda i, rgb: None)


def md5(out):
    return [hashlib.md5(getattr(out, k).tobytes()).hexdigest()
            for k in out._fields]


ways = {"replay": replay, "eager": eager, "chain": chain}
t0 = time.perf_counter()
replay(1.0)
warm_s = time.perf_counter() - t0
sums = {w: [md5(f(z)) for z in ZOOMS] for w, f in ways.items()}
launches = {}
for w, f in ways.items():
    sh.reset_launches()
    kb.reset_launches()
    f(ZOOMS[0])
    launches[w] = {"k7": kb.launches, "glue": sh.glue_launches}
times = {w: [] for w in ways}
for i in range(n_frames):
    for w, f in ways.items():
        out = None
        t0 = time.perf_counter()
        out = f(ZOOMS[i % len(ZOOMS)])
        times[w].append((time.perf_counter() - t0) * 1e3)
del out


def summary(ts):
    q = statistics.quantiles(ts, n=10)
    return {"median": round(statistics.median(ts), 3),
            "p90": round(q[8], 3), "min": round(min(ts), 3)}


print(json.dumps({
    "tree": tree, "card": torch.cuda.get_device_name(dev),
    "warm_s": round(warm_s, 3), "frames": n_frames,
    "md5_equal": all(sums[w] == sums["chain"] for w in ways),
    "md5_chain": sums["chain"],
    "ms": {w: summary(ts) for w, ts in times.items()},
    "launches": launches,
    "graph_replays": R.graph_replays}), flush=True)
