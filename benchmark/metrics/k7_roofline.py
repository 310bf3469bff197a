"""k7_roofline (%): the threaded-BVH walk's (K7, ``bvh_kernel``) least
time over its device time in the traced frames. The least time is the
bytes the frame's two walks must move for its real pixels (W x H) at
3.35 TB/s, the H100 SXM's HBM peak (NVIDIA's data sheet, 700 W): the
closest-hit walk reads a camera ray (direction, t_min, t_max; its origin
is 0) and writes t, geometry and primitive, 32 B; the any-hit walk reads
a shadow ray (origin, direction, t_min, t_max) and writes its flag, 36 B.
The count depends on neither the BVH nor the walk's implementation.

Beside it, as a log line only: the bound of the walk's operations (node
visits x 18 + leaf tests x 58 f32 instructions at 33.5 T/s), from the
visits the system's plain walk (``ops/bvh.py``) makes on the first traced
frame's sampled pixels, scaled to the frame."""

import numpy as np
import torch

from benchmark import program, traffic
from benchmark.metrics_lib import card_info, kernel_ms_per_frame

PEAK_BYTES = 3.35e12
CAMERA_RAY_BYTES = 12 + 4 + 4 + 4 + 4 + 4
SHADOW_RAY_BYTES = 12 + 12 + 4 + 4 + 4
PEAK_INSTR = 33.5e12
NODE_INSTR, LEAF_INSTR = 18, 58


def least_bytes(w: int, h: int) -> int:
    """The bytes a frame's two walks must move for its W x H pixels."""
    return w * h * (CAMERA_RAY_BYTES + SHADOW_RAY_BYTES)


def node_work(run) -> dict:
    """The plain walk's node visits and leaf tests over the first traced
    frame's sampled pixels: their camera rays and their shadow rays."""
    from ipu_ray_lib_tpu_torch.ops import bvh
    from ipu_ray_lib_tpu_torch.ops.bxdf_loop import offset_ray_origin
    from ipu_ray_lib_tpu_torch.ops.camera import (plane_scale, scaled_ray_dir,
                                                  tan_half_fov)
    from ipu_ray_lib_tpu_torch.ops.shadow import light_ray
    from ipu_ray_lib_tpu_torch.ops.traversal import Hit, hit_normal

    cfg, tr = run.cell.config, run.cell.traffic
    w, h = cfg["image_width"], cfg["image_height"]
    scene, params, _ = program.build(run.cell, torch.device("cpu"), {})
    pix = traffic.check_pixels(tr, run.seed, 0, w * h)
    rows = torch.from_numpy((pix // w).astype(np.float32))
    cols = torch.from_numpy((pix % w).astype(np.float32))
    fov = params.fov_radians * traffic.zoom(tr, run.seed, 0)
    d = scaled_ray_dir(cols, rows, w, h, *plane_scale(w, h, tan_half_fov(fov)))
    zero = torch.zeros(len(pix))
    stats = {"rays": len(pix)}
    t, g, p = bvh.bvh_walk_ref(scene, torch.zeros_like(d), d, zero,
                               torch.full_like(zero, float("inf")), False,
                               zero_origin=True, stats=stats)
    hit = Hit(t=t, geom_id=g, prim_id=p)
    hit_p, sdir, dist = light_ray(None, d, hit.found, t, cfg["light"])
    so = offset_ray_origin(hit_p, sdir, hit_normal(scene, None, d, hit))
    bvh.bvh_walk_ref(scene, so, sdir, zero, dist, True, stats=stats)
    return stats


def read(run):
    ms = kernel_ms_per_frame(run, lambda n: "bvh_kernel" in n)
    if not ms:
        return None
    cfg = run.cell.config
    w, h = cfg["image_width"], cfg["image_height"]
    least_ms = 1e3 * least_bytes(w, h) / PEAK_BYTES
    work = node_work(run)
    scale = w * h / work["rays"]
    ops_ms = 1e3 * scale * (work["node_visits"] * NODE_INSTR
                            + work["leaf_tests"] * LEAF_INSTR) / PEAK_INSTR
    run.log(f"k7_roofline: least {least_ms:.5f} ms ({least_bytes(w, h)} B), "
            f"K7 {ms:.4f} ms per frame; the operations' bound {ops_ms:.4f} ms "
            f"(per sampled ray {work['node_visits'] / work['rays']:.1f} node "
            f"visits, {work['leaf_tests'] / work['rays']:.2f} leaf tests over "
            f"both walks; not the share's); card {card_info()}")
    return 100.0 * least_ms / ms
