"""Shadow-traced frames of a scene built with ``intersector="bvh"``
(upstream's compact BVH, walked by the system's K7), read back and
sampled as the ``shadow`` mode does, and judged by the plain reference of
the BVH route (``reference/shadow_bvh.py``): its triangle, sphere and
disc tests round differently from the fused route's row test, so the
``shadow`` mode's reference does not hold this route. The same number,
``aov_mismatch_pct``, with the same tolerances (rtol 1e-5, atol 1e-6;
ids equal; inf equals inf)."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import program, traffic
from benchmark.modes.shadow import AOVS, Program, compare, mismatched  # noqa: F401
from benchmark.reference import scene as RS
from benchmark.reference import shadow_bvh as RB


def reference(cell, seed, n_frames, device, control=False):
    cfg = cell.config
    dt = program.control_dtype(cell) if control else torch.float32
    sc = RS.load(cfg["scene"], cell.root)
    pr = RB.prims(sc, device, dt)
    w, h = cfg["image_width"], cfg["image_height"]
    out = []
    for i in range(n_frames):
        pix = traffic.check_pixels(cell.traffic, seed, i, w * h)
        rows = torch.from_numpy((pix // w).astype(np.float32)).to(device, dt)
        cols = torch.from_numpy((pix % w).astype(np.float32)).to(device, dt)
        a = RB.aovs(pr, rows, cols, w=w, h=h,
                    fov=sc.fov * traffic.zoom(cell.traffic, seed, i),
                    light=cfg["light"], ambient=cfg["ambient"])
        out.append({k: (a[k].float() if a[k].is_floating_point() else a[k])
                    .cpu().numpy().reshape(len(pix), -1) for k in AOVS})
    return out


def check(cell, seed, frames, device) -> dict:
    return compare([f.sample for f in frames],
                   reference(cell, seed, len(frames), device))
