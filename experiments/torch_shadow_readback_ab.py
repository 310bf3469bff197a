"""The port's 1440^2 shadow frame in one source tree, on a CUDA card: its
AOVs' md5 at 12 zooms and its wall time, for comparing two versions of
the frame driver (render/renderer.py) on the same card.

To compare two versions in one call, unpack the older one into a
directory git ignores and run, in turns (older, newer, newer, older):

    python3 experiments/torch_shadow_readback_ab.py <tree> [frames]

It builds Cornell + monkey at 1440x1440 (VMEM mode, fused K4), renders
one warm-up frame (the graph route captures its chunk loop there), then:
- the 12 zooms 0.985 + 0.0025 i (i = 0..11), every AOV read back: each
  AOV's md5 (equal md5s: equal outputs);
- `frames` frames (default 120) cycling through those zooms, each one's
  wall time from the call to its arrays on the host, as the benchmark's
  shadow cell takes it (the previous frame's arrays dropped first);
- the first zoom's frame held while the second renders: its md5 after.
Prints one JSON line: the tree, the md5s, the frame times' median, p90
and min, the tree's pinned readbacks (null where it has no such
counter) and whether the held frame kept its md5.
"""

import hashlib
import json
import os
import statistics
import sys
import time

tree = os.path.abspath(sys.argv[1])
n_frames = int(sys.argv[2]) if len(sys.argv) > 2 else 120
sys.path.insert(0, tree)

import dataclasses  # noqa: E402

import torch  # noqa: E402

from ipu_ray_lib_tpu_torch.ops import shadow as sh  # noqa: E402
from ipu_ray_lib_tpu_torch.render import renderer as R  # noqa: E402
from ipu_ray_lib_tpu_torch.scene.build import build_scene  # noqa: E402
from ipu_ray_lib_tpu_torch.scene.builtin import make_cornell_box_scene  # noqa: E402

assert R.__file__.startswith(tree), R.__file__
dev = torch.device("cuda", 0)
FULL = 1440
ZOOMS = [0.985 + 0.0025 * i for i in range(12)]

scene, params = build_scene(
    make_cornell_box_scene(os.path.join(tree, "assets", "monkey_bust.glb"),
                           box_only=False),
    device=dev, image_width=FULL, image_height=FULL, intersector="pallas")


def frame(zoom):
    return R.render(scene, dataclasses.replace(
        params, fov_radians=params.fov_radians * zoom))


def md5(out):
    return [hashlib.md5(getattr(out, k).tobytes()).hexdigest()
            for k in out._fields]


t0 = time.perf_counter()
frame(1.0)
warm_s = time.perf_counter() - t0
sh.reset_launches()
sums = [md5(frame(z)) for z in ZOOMS]
times = []
out = None
for i in range(n_frames):
    out = None
    t0 = time.perf_counter()
    out = frame(ZOOMS[i % len(ZOOMS)])
    times.append((time.perf_counter() - t0) * 1e3)
first = frame(ZOOMS[0])
second = frame(ZOOMS[1])
held = md5(first) == sums[0] and md5(second) == sums[1]
q = statistics.quantiles(times, n=10)
print(json.dumps({
    "tree": tree, "md5": sums, "warm_s": round(warm_s, 3),
    "frames": n_frames, "ms_median": round(statistics.median(times), 3),
    "ms_p90": round(q[8], 3), "ms_min": round(min(times), 3),
    "graph_replays": sh.graph_replays,
    "pinned_readbacks": getattr(sh, "pinned_readbacks", None),
    "held_frame_kept": held}), flush=True)
