"""k6_roofline (%): the HBM-mode closest-hit walk's (K6: ``chunk_kernel``
and ``fold_kernel``, twice a chunk) least time over its device time in
the traced frames. The least time is the bytes the frame's camera and
shadow queries must move for its real pixels (W x H) at 3.35 TB/s:
``k7_roofline.least_bytes``, the count that holds every shadow route, as
it depends on neither the tables nor the walk.

Beside it, as a log line only: the bound of the walk's operations (the
(lane, block) pairs the hits need x 128 rows x 33 instructions at 33.5
T/s, the row test as ``ops/cuda/rows.cuh`` contracts it), from the
system's plain walk (``ops/intersect_hbm.py:super_walk_ref``) over the
first traced frame's sampled pixels, scaled to the frame, on the run's
card (the plain walk is plain torch; on the CPU one bundle's walk past
most of the 4,088 blocks takes minutes); and the (lane, block) pairs
that walk tested, whose one bundle of scattered pixels walks far more
than the frame's bundles of neighbours do."""

import re

import numpy as np
import torch

from benchmark import program, traffic
from benchmark.metrics.k7_roofline import PEAK_BYTES, PEAK_INSTR, least_bytes
from benchmark.metrics_lib import card_info, kernel_ms_per_frame

K6_KERNEL = re.compile(r"::(chunk|fold)_kernel\b")
ROWS, ROW_INSTR = 128, 33


def is_k6(name: str) -> bool:
    """Whether a device event is one of K6's launches (never K5's
    ``bundle_kernel``)."""
    return K6_KERNEL.search(name) is not None


def _walk(scene, o, d, t_min, t_max):
    """The plain walk of the rays (o None: from the camera) as the HBM
    query runs it: (t [R], tri [R], unit normal [R, 3], (lane, block)
    pairs tested, pairs needed)."""
    from ipu_ray_lib_tpu_torch.ops.cull import BR, super_cull_lists_bundle
    from ipu_ray_lib_tpu_torch.ops.intersect_hbm import super_walk_ref
    from ipu_ray_lib_tpu_torch.ops.intersect_kernel import (
        intersect_epilogue, intersect_inputs, needed_pairs)
    from ipu_ray_lib_tpu_torch.ops.tables import SB

    o = torch.zeros_like(d) if o is None else o
    o_pad, d_pad, tmin_pad, tmax_pad, rays = intersect_inputs(o, d, t_min,
                                                              t_max)
    lists = super_cull_lists_bundle(scene, o_pad, d_pad, tmin_pad, tmax_pad,
                                    rays.shape[1] // BR)
    out = super_walk_ref(scene, *lists, rays)
    live = (tmax_pad >= 0.0).reshape(-1, BR).sum(1)
    tested = int((out[4].long() * live).sum())
    need = needed_pairs(scene, lists[1], rays, out[0], out[4], members=SB)
    t, tri, normal, _ = intersect_epilogue(out, t_max, d.shape[0])
    return t, tri, normal, tested, need


def lane_work(run) -> dict:
    """The (lane, block) pairs of the first traced frame's sampled pixels:
    their camera rays and their shadow rays (spheres and discs left out:
    they add no block), on the run's reference device."""
    from ipu_ray_lib_tpu_torch.ops.bxdf_loop import offset_ray_origin
    from ipu_ray_lib_tpu_torch.ops.camera import (plane_scale, scaled_ray_dir,
                                                  tan_half_fov)
    from ipu_ray_lib_tpu_torch.ops.shadow import light_ray

    cfg, tr = run.cell.config, run.cell.traffic
    w, h = cfg["image_width"], cfg["image_height"]
    dev = run.ref_device or torch.device("cpu")
    scene, params, _ = program.build(run.cell, dev, {})
    pix = traffic.check_pixels(tr, run.seed, 0, w * h)
    rows = torch.from_numpy((pix // w).astype(np.float32)).to(dev)
    cols = torch.from_numpy((pix % w).astype(np.float32)).to(dev)
    fov = params.fov_radians * traffic.zoom(tr, run.seed, 0)
    d = scaled_ray_dir(cols, rows, w, h, *plane_scale(w, h, tan_half_fov(fov)))
    zero = torch.zeros(len(pix), device=dev)
    t, tri, normal, tested, need = _walk(scene, None, d, zero,
                                         torch.full_like(zero, float("inf")))
    hit_p, sdir, dist = light_ray(None, d, tri >= 0, t, cfg["light"])
    so = offset_ray_origin(hit_p, sdir, normal)
    *_, s_tested, s_need = _walk(scene, so, sdir, zero, dist)
    return {"rays": len(pix), "tested": tested + s_tested,
            "needed": need + s_need}


def read(run):
    ms = kernel_ms_per_frame(run, is_k6)
    if not ms:
        return None
    cfg = run.cell.config
    w, h = cfg["image_width"], cfg["image_height"]
    least_ms = 1e3 * least_bytes(w, h) / PEAK_BYTES
    work = lane_work(run)
    scale = w * h / work["rays"]
    ops_ms = 1e3 * scale * work["needed"] * ROWS * ROW_INSTR / PEAK_INSTR
    run.log(f"k6_roofline: least {least_ms:.5f} ms ({least_bytes(w, h)} B), "
            f"K6 {ms:.4f} ms per frame; the operations' bound {ops_ms:.4f} ms "
            f"(per sampled pixel {work['needed'] / work['rays']:.1f} (lane, "
            f"block) pairs needed, {work['tested'] / work['rays']:.1f} "
            f"tested by the plain walk, over both queries; not the share's); "
            f"card {card_info()}")
    return 100.0 * least_ms / ms
