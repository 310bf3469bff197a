"""Follows every sampled pixel where a path cell's frames differ from the
benchmark's plain reference, path by path and bounce by bounce.

    python3 experiments/torch_check_replay.py --workload <path cell> --seed <n> --frames <k>

From the root of a checkout, on a CUDA card (or the CPU, where the port
runs its plain versions). It renders frames 0..k-1 of the seed as a run
does, works out their sampled pixels with the reference, and for each
pixel that differs:
- replays the pixel's slot alone (``slot0``: the same path ids) through
  the megakernel in record mode and through its plain version, and
  prints whether the two agree on every path of the pixel;
- traces the pixel's paths with the reference and, for each path whose
  colour differs from the kernel's, prints every bounce: the reference's
  t and row (scene order), the plain walk's t and primitive on the same
  ray, and the reference's rows whose planes that ray meets at exactly
  that t (two of them that both accept the ray are a tie).
"""

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import harness, program, traffic  # noqa: E402
from benchmark.reference import geometry as G  # noqa: E402
from benchmark.reference import path as RP  # noqa: E402
from benchmark.reference.rng import normal2  # noqa: E402
import ipu_ray_lib_tpu_torch.ops.megakernel as MK  # noqa: E402
from ipu_ray_lib_tpu_torch.ops.intersect import slab_inv  # noqa: E402
from ipu_ray_lib_tpu_torch.render.streaming import slot_pool  # noqa: E402


def reference_bounces(tb, o, d, pid, seed, cfg):
    """The reference's (o, d, t, row) at each bounce of one path."""
    log, orig = [], G.closest_rows

    def logged(tb_, o_, d_, t_min, best_t, fused, chunk=1 << 22):
        t, row = orig(tb_, o_, d_, t_min, best_t, fused, chunk)
        log.append((tuple(c.clone() for c in o_), tuple(c.clone() for c in d_),
                    t.clone(), row.clone()))
        return t, row
    G.closest_rows = logged
    try:
        RP.trace(tb, o, d, pid, seed, cfg["max_path_length"],
                 cfg["roulette_start_depth"])
    finally:
        G.closest_rows = orig
    return log


def plain_walk(scene, hbm, o, d):
    """The port's plain walk of one ray: (t, primitive or -1)."""
    dev = o[0].device
    om = torch.maximum(torch.maximum(o[0].abs(), o[1].abs()), o[2].abs())
    walk = MK._walk_hbm if hbm else MK._walk_vmem
    t, row = walk(scene, o, d, slab_inv(d), torch.ones(1, dtype=torch.bool,
                                                        device=dev), om,
                  torch.full((1,), float("inf"), device=dev),
                  torch.full((1,), -1, dtype=torch.int64, device=dev), None)
    r = int(row[0])
    return t[0].item(), int(scene.tri_prim[r]) if r >= 0 else -1


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--frames", type=int, required=True)
    args = ap.parse_args(argv)
    dev = (torch.device("cuda", 0) if torch.cuda.is_available()
           else torch.device("cpu"))
    cell = harness.Cell(args.workload)
    cfg = cell.config
    w, h, spp = cfg["image_width"], cfg["image_height"], cfg["samples_per_pixel"]
    n_pix = w * h
    R, J = slot_pool(n_pix, int(cell.traffic["chunk"]))
    prog = cell.mode.Program(cell, args.seed, [dev], {})
    frames = [prog.frame(i) for i in range(args.frames)]
    want = cell.mode.reference(cell, args.seed, args.frames, dev)
    sc, tb = program.reference_tables(cell, dev)
    scene, params = prog.scene, prog.params
    order = RP.stream_order(w, h)
    for i, fr in enumerate(frames):
        pix = traffic.check_pixels(cell.traffic, args.seed, i, n_pix)
        fs = traffic.frame_seed(args.seed, i)
        for b in np.flatnonzero((fr.sample != want[i]).any(axis=1)):
            p = int(pix[b])
            print(f"frame {i} pixel {p} (row {p // w}, col {p % w}): "
                  f"system {fr.sample[b].tolist()} reference "
                  f"{want[i][b].tolist()}")
            q = int(RP.stream_position(w, h)[p])
            slot, j = q % R, q // R
            pos = slot + np.arange(J) * R
            ras = order[np.minimum(pos, n_pix - 1)]
            coord = lambda a: torch.tensor(np.where(pos < n_pix, a, 0),
                                           dtype=torch.float32, device=dev)
            kw = dict(params=params, slots=1, j_per_slot=J, spp=spp,
                      max_iters=J * spp * params.max_path_length + 16,
                      slot0=slot)
            n_valid = int((pos < n_pix).sum())
            rows, cols = coord(ras // w), coord(ras % w)
            rec_k, _ = MK.trace_records(scene, rows, cols, fs, n_valid, **kw)
            rec_p, _ = MK._trace(MK._accumulate_plain, scene, rows, cols, fs,
                                 n_valid, record=True, **kw)
            ck = rec_k[0:3, j * spp:(j + 1) * spp, 0].t().cpu()
            cp = rec_p[0:3, j * spp:(j + 1) * spp, 0].t().cpu()
            print(f"  kernel equals plain on all {spp} paths: "
                  f"{bool(torch.equal(ck, cp))}")
            (bb, seeds, pids), = RP.path_ids(fs, np.array([p]), w, h, spp,
                                             int(cell.traffic["chunk"]),
                                             None)[0]
            pid = torch.from_numpy(pids.reshape(-1)).to(dev)
            seed = torch.from_numpy(np.repeat(seeds, bb)).to(dev)
            g1, g2 = normal2(pid, seed, 0xCA3)
            o, d = RP.camera(torch.full((bb,), float(p // w), device=dev),
                             torch.full((bb,), float(p % w), device=dev),
                             g1, g2, w, h, sc.fov, cfg["anti_alias_scale"],
                             torch.float32)
            cref = RP.trace(tb, o, d, pid, seed, cfg["max_path_length"],
                            cfg["roulette_start_depth"])[0].cpu()
            for k in torch.nonzero((ck != cref).any(1)).flatten().tolist():
                print(f"  path {k}: kernel {ck[k].tolist()} reference "
                      f"{cref[k].tolist()}")
                one = lambda v: tuple(c[k:k + 1] for c in v)
                for n, (bo, bd, t, row) in enumerate(reference_bounces(
                        tb, one(o), one(d), pid[k:k + 1], seed[k:k + 1],
                        cfg)):
                    pt, prim = plain_walk(
                        scene, params.intersector == "pallas-hbm", bo, bd)
                    at_t = []
                    if int(row[0]) >= 0:
                        ts = G.row_chain(tb.rows, bo, bd, False)[0][:, 0]
                        at_t = torch.nonzero(ts == t[0]).flatten().tolist()
                    print(f"    bounce {n}: reference t {t[0].item()!r} row "
                          f"{int(row[0])}; plain walk t {pt!r} primitive "
                          f"{prim}; reference planes at that t: {at_t[:8]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
