"""Times the port's K3 (and K1) alone in one source tree, on a CUDA card.

To compare two versions in one call, unpack the older one into a
directory git ignores and run, in turns (older, newer, newer, older):

    python3 experiments/torch_k3_ab.py <tree>

It builds the tree's kernels, then times `megakernel_path_trace` three
times with CUDA events on: the stress grids 512 and 1024 at 256^2 spp 8,
max_path_length 5 (K3); grid 512 at 1440^2 spp 64 (K3); Cornell + monkey
at 1440^2 spp 64 (K1). It prints one JSON line: per case the times (the
first includes the first launch's warm-up), an md5 of the image (equal
md5s: equal images) and `done`.
"""

import hashlib
import json
import os
import sys

tree = os.path.abspath(sys.argv[1])
sys.path.insert(0, tree)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from ipu_ray_lib_tpu_torch.ops import megakernel as mk  # noqa: E402
from ipu_ray_lib_tpu_torch.render.streaming import slot_pool  # noqa: E402
from ipu_ray_lib_tpu_torch.scene.build import build_scene  # noqa: E402
from ipu_ray_lib_tpu_torch.scene.builtin import (  # noqa: E402
    make_cornell_box_scene, make_stress_scene)

assert mk.__file__.startswith(tree), mk.__file__
dev = torch.device("cuda", 0)


def stream(params, chunk=1 << 17):
    n_pix = params.window_w * params.window_h
    R, J = slot_pool(n_pix, chunk)
    try:
        from ipu_ray_lib_tpu_torch.render.pixels import pixel_stream
    except ImportError:  # a tree from before render/pixels.py
        from ipu_ray_lib_tpu_torch.render.streaming import _pixel_stream
        rows_np, cols_np, _ = _pixel_stream(params)
        pad = (0, R * J - n_pix)
        return (torch.from_numpy(np.pad(rows_np, pad)).to(dev),
                torch.from_numpy(np.pad(cols_np, pad)).to(dev), R, J, n_pix)
    return (*pixel_stream(params).coords(dev, R * J), R, J, n_pix)


out = {}
monkey = os.path.join(tree, "assets", "monkey_bust.glb")
cases = [("k3_512_256", lambda: make_stress_scene(512), 256, 8, 5),
         ("k3_1024_256", lambda: make_stress_scene(1024), 256, 8, 5),
         ("k3_512_1440", lambda: make_stress_scene(512), 1440, 64, None),
         ("k1_monkey_1440",
          lambda: make_cornell_box_scene(monkey, box_only=False), 1440, 64,
          None)]
for name, desc, W, spp, mpl in cases:
    kw = dict(device=dev, image_width=W, image_height=W, samples_per_pixel=spp)
    if mpl:
        kw["max_path_length"] = mpl
    s, p = build_scene(desc(), **kw)
    rows, cols, R, J, n = stream(p)
    kwt = dict(params=p, slots=R, j_per_slot=J, spp=spp,
               max_iters=J * spp * p.max_path_length + 16, k_total=J * spp)
    ms = []
    for _ in range(3):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        img, done = mk.megakernel_path_trace(s, rows, cols, p.rng_seed, n,
                                             **kwt)
        e1.record()
        torch.cuda.synchronize()
        ms.append(e0.elapsed_time(e1))
    out[name] = dict(ms=ms, md5=hashlib.md5(img.cpu().numpy().tobytes())
                     .hexdigest(), done=int(done), intersector=p.intersector)
    del s
print(json.dumps(out), flush=True)
