#!/usr/bin/env python3
"""The control's readings, from which the limits of ``correct`` are set:
the plain reference one precision step below the configuration's (bf16
for its f32 arithmetic, fp8 for its bf16 NIF operands), put in the
system's place and compared with the reference as a run compares the
system, over the sampled pixels of ``--frames`` frames of each seed.

    python3 benchmark/control.py --workload <cell> --seeds 1,2,3 --frames 46

On a card (the reference's device); no run of the benchmark calls it.
Prints one JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--frames", type=int, required=True)
    args = ap.parse_args(argv)
    import torch

    cell = harness.Cell(args.workload)
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        want = cell.mode.reference(cell, seed, args.frames, dev)
        got = cell.mode.reference(cell, seed, args.frames, dev, control=True)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "frames": args.frames,
                          "control": cell.mode.compare(got, want),
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
