"""Names every sampled pixel where a ``shadow`` cell's frames differ from
the benchmark's plain shadow reference (``benchmark/reference/shadow.py``).

    python3 experiments/torch_shadow_check_replay.py --workload <shadow cell> --seed <n> --frames <k> [--grid G --size W]

From the root of a checkout, on a CUDA card (or the CPU, where the port
runs its plain versions; ``--grid`` and ``--size`` cut a heightfield
cell's mesh and window for a CPU rehearsal). It renders frames 0..k-1 of
the seed as a run does, works out their sampled pixels with the
reference and, for each pixel that differs, prints:
- every AOV on both sides, and which ones differ;
- the pixel replayed alone on the CPU through the port's plain route
  (``render/shadow.py:shadow_trace``), and whether it equals the card's;
- the camera query: the reference's t and row (scene order), the row
  the port's primitive is, and the reference's own t of that row (equal
  t on two accepted rows is a tie, which the reference breaks by the
  lower row);
- the occlusion query: the reference's shadow ray, its nearest row and
  t against the light's distance, and the port's plain query of the
  same ray.
"""

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import harness, program, traffic  # noqa: E402
from benchmark.modes.shadow import AOVS, mismatched  # noqa: E402
from benchmark.reference import geometry as G  # noqa: E402
from benchmark.reference import shadow as RSH  # noqa: E402


def reference_queries(cell, tb, fov, row, col):
    """The reference's AOVs of one pixel and its two row queries, each
    (o, d, t_min, t_max, t, row)."""
    cfg = cell.config
    log, orig = [], G.closest_rows

    def logged(tb_, o, d, t_min, best_t, fused, chunk=1 << 22):
        t, r = orig(tb_, o, d, t_min, best_t, fused, chunk)
        log.append((o, d, t_min, best_t.clone(), t, r))
        return t, r
    G.closest_rows = logged
    try:
        sc = RSH.aovs(tb, row, col, w=cfg["image_width"],
                      h=cfg["image_height"], fov=fov,
                      light=cfg["light"], ambient=cfg["ambient"])
    finally:
        G.closest_rows = orig
    return sc, log


def row_t(tb, r: int, o, d, t_min):
    """The reference's accepted t of its row r on the ray (inf: none)."""
    one = dataclasses.replace(tb, rows=tb.rows[r:r + 1])
    t, hit = G.closest_rows(one, o, d, t_min,
                            torch.full_like(t_min, G.INF), fused=True)
    return float(t[0]) if int(hit[0]) >= 0 else float("inf")


def port_query(scene, intersector, o, d, t_min, t_max):
    """The port's plain closest hit of one ray: (t, geom, prim)."""
    from ipu_ray_lib_tpu_torch.ops.traversal import scene_intersect

    st = lambda v: torch.stack([c.float().cpu() for c in v], 1)
    hit = scene_intersect(scene, st(o), st(d), t_min.float().cpu(),
                          t_max.float().cpu(), intersector)
    return float(hit.t[0]), int(hit.geom_id[0]), int(hit.prim_id[0])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--frames", type=int, required=True)
    ap.add_argument("--grid", type=int)
    ap.add_argument("--size", type=int)
    args = ap.parse_args(argv)
    over = {"config": {}, "traffic": {}}
    if args.grid:
        base = harness.Cell(args.workload).config
        scene = json.loads(json.dumps(base["scene"]))
        scene["meshes"][0]["grid"] = args.grid
        over["config"].update(scene=scene, program=dict(base["program"],
                                                        args=[args.grid]),
                              intersector="pallas-hbm")
    if args.size:
        over["config"].update(image_width=args.size, image_height=args.size)
        over["traffic"]["check_pixels"] = min(
            args.size ** 2, harness.Cell(args.workload).traffic["check_pixels"])
    cell = harness.Cell(args.workload, overrides=over)
    if cell.traffic["mode"] != "shadow":
        raise SystemExit("a cell of the shadow mode only")
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    if dev.type == "cuda":
        program.load_kernels([dev], {})
    prog = cell.mode.Program(cell, args.seed, [dev], {})
    intersector = prog.params.intersector
    frames = [prog.frame(i) for i in range(args.frames)]
    prog.release()
    want = cell.mode.reference(cell, args.seed, args.frames, dev)
    cfg, tr = cell.config, cell.traffic
    w, h = cfg["image_width"], cfg["image_height"]
    sc, tb = program.reference_tables(cell, dev)
    cpu_scene = None
    n_bad = 0
    for i, (fr, wt) in enumerate(zip(frames, want)):
        bad = np.flatnonzero(mismatched(fr.sample, wt))
        n_bad += len(bad)
        pix = traffic.check_pixels(tr, args.seed, i, w * h)
        zoom = traffic.zoom(tr, args.seed, i)
        for j in bad:
            p = int(pix[j])
            print(f"frame {i} pixel {p} (row {p // w}, col {p % w}), zoom "
                  f"{zoom!r}, intersector {intersector}")
            ref = {a: wt[a][j:j + 1] for a in AOVS}
            for k in AOVS:
                one = dict(ref, **{k: fr.sample[k][j:j + 1]})
                mark = "  <- differs" if mismatched(one, ref).any() else ""
                print(f"  {k:8s} port {fr.sample[k][j].tolist()} reference "
                      f"{wt[k][j].tolist()}{mark}")
            if cpu_scene is None:
                cpu_scene, params, _ = program.build(
                    cell, torch.device("cpu"), {})
            from ipu_ray_lib_tpu_torch.ops.camera import (plane_scale,
                                                          scaled_ray_dir,
                                                          tan_half_fov)
            from ipu_ray_lib_tpu_torch.render.shadow import shadow_trace

            rr = torch.tensor([float(p // w)])
            cc = torch.tensor([float(p % w)])
            d = scaled_ray_dir(cc, rr, w, h, *plane_scale(
                w, h, tan_half_fov(params.fov_radians * zoom)))
            res = shadow_trace(cpu_scene, None, d, cfg["light"],
                               cfg["ambient"], intersector=intersector)
            rep = {k: getattr(res, k).numpy().reshape(1, -1) for k in AOVS}
            rep["geom_id"] = np.where(res.escaped.numpy()[:, None], -1,
                                      rep["geom_id"])
            same = all(np.array_equal(rep[k], fr.sample[k][j:j + 1])
                       for k in AOVS)
            print(f"  the CPU replay of the port's route equals the card's "
                  f"pixel: {same}")
            r_dev = torch.tensor([float(p // w)], device=dev)
            c_dev = torch.tensor([float(p % w)], device=dev)
            _, log = reference_queries(cell, tb, sc.fov * zoom, r_dev, c_dev)
            o, dd, t_min, t_max, t_ref, row_ref = log[0]
            g, pr = int(fr.sample["geom_id"][j][0]), int(
                fr.sample["prim_id"][j][0])
            line = (f"  camera query: reference t {float(t_ref[0])!r} row "
                    f"{int(row_ref[0])}")
            if 0 <= g < tb.n_meshes and pr >= 0:
                rows = torch.nonzero((tb.tri_geom == g) & (tb.tri_prim == pr))
                rp = int(rows[0, 0])
                line += (f"; the port's primitive is row {rp}, whose "
                         f"reference t is {row_t(tb, rp, o, dd, t_min)!r}")
            print(line)
            so, sd, s_min, dist, s_t, s_row = log[1]
            pt, pg, pp = port_query(cpu_scene, intersector, so, sd, s_min,
                                    dist)
            print(f"  occlusion query: light at {float(dist[0])!r}; "
                  f"reference nearest row {int(s_row[0])} at "
                  f"{float(s_t[0])!r}; the port's plain query of the same "
                  f"ray: t {pt!r}, geom {pg}, prim {pp}")
    print(f"{n_bad} of {sum(len(x['t']) for x in want)} sampled pixels "
          f"differ over {args.frames} frames of seed {args.seed}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
