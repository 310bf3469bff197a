#!/usr/bin/env python3
"""The benchmark of ipu_ray_lib_tpu_torch, the renderer's PyTorch and CUDA
port: one run of one cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. It needs as many CUDA cards as the cell asks
for (it exits with 3 and prints no result otherwise); it sets up (kernel
library, scene, one warm-up frame), renders frames back to back for
``--seconds`` (with ``--trace 1``: the traffic's ``trace_frames`` under
the profiler), compares each frame's sampled answers with the plain
reference, and prints the numbers compared beside their limits as its
last lines on standard error, then one JSON line on standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] != ROOT:
    sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402
from benchmark.metrics_lib import card_info  # noqa: E402


def main(argv=None) -> int:
    t0 = harness.process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = harness.Cell(args.workload)

    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"{n} available", file=sys.stderr)
        return 3
    devices = [torch.device("cuda", i) for i in range(cell.chips)]
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         devices, t0)
    bad = harness.forbidden_modules()
    if bad:
        print("jax or the JAX package was loaded: " + ", ".join(bad),
              file=sys.stderr)
        return 4
    print(f"card: {card_info()}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
