"""One run of one cell: set-up, a closed-loop window of frames, the
comparison with the plain reference, and the metrics.

Everything that belongs to one configuration, traffic mix, mode or metric
is found by name under ``benchmark/``: ``configs/`` (through
``BENCHMARK.json``), ``traffic/<traffic>.json``, ``modes/<mode>.py``,
``limits/<cell>.json`` and ``metrics/<metric>.py``. A mode module has a
``Program(cell, seed, devices, spans)`` (built in set-up; ``warm()``
renders one frame of the cell's shape, ``frame(i)`` renders frame i and
returns a :class:`Frame`, ``release()`` frees it) and ``check(cell, seed,
frames, device)``, which runs the reference and returns the compared
numbers by name; ``reference`` and ``compare`` serve ``control.py``. A metric module has ``read(run)``, which returns
a number or None when it finds nothing to read.
"""

from __future__ import annotations

import bisect
import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field

from . import stats, traffic

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
FORBIDDEN = ("jax", "jaxlib", "flax", "ipu_ray_lib_tpu")
TRACE_TOP = 10


def forbidden_modules(names=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of :data:`FORBIDDEN`, compared whole."""
    names = sys.modules if names is None else names
    return sorted({n for n in names if n.split(".", 1)[0] in FORBIDDEN})


def process_start() -> float:
    """This process's start on the ``time.time()`` clock (Linux /proc;
    elsewhere the moment of the call)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - up + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.time()


def _load(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


class Cell:
    """A workload of ``BENCHMARK.json`` with its configuration, traffic,
    limits and metrics. ``overrides`` ({"config": {...}, "traffic":
    {...}}) replace top-level keys (tests run cells at small sizes)."""

    def __init__(self, workload: str, root: str = ROOT,
                 manifest: dict | None = None,
                 overrides: dict | None = None):
        if manifest is None:
            with open(os.path.join(root, "BENCHMARK.json")) as f:
                manifest = json.load(f)
        w = [x for x in manifest["workloads"] if x["name"] == workload]
        if not w:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.name, self.root, w = workload, root, w[0]
        self.chips = int(w["chips"])
        c = next(x for x in manifest["configs"] if x["name"] == w["config"])
        with open(os.path.join(root, c["file"])) as f:
            self.config = json.load(f)
        with open(os.path.join(BENCH, "traffic", w["traffic"] + ".json")) as f:
            self.traffic = json.load(f)
        with open(os.path.join(BENCH, "limits", workload + ".json")) as f:
            self.limits = json.load(f)
        overrides = overrides or {}
        self.config.update(overrides.get("config", {}))
        self.traffic.update(overrides.get("traffic", {}))
        self.end_to_end = [m for m in manifest["end_to_end"]
                           if _applies(m, workload)]
        self.per_layer = [m for m in manifest["per_layer"]
                          if _applies(m, workload)]
        self.mode = importlib.import_module(
            "benchmark.modes." + self.traffic["mode"])

    def path(self, rel: str) -> str:
        return os.path.join(self.root, rel)


@dataclass
class Frame:
    """One frame: its work (paths or rays), whether it completed whole,
    and what the check compares (the mode's own)."""
    work: int
    ok: bool
    sample: object = None


@dataclass
class DeviceEvent:
    """A kernel, copy or memset on a card (times in ns, the profiler's
    clock)."""
    name: str
    device: int
    start: float
    end: float


@dataclass
class Run:
    """What a metric reader reads."""
    cell: Cell
    seed: int
    setup_s: float
    window_s: float
    frame_s: list
    work: list
    spans: dict
    devices: list
    events: list | None = None        # device events (a traced run)
    window_ns: tuple | None = None
    frame_seeds: list = field(default_factory=list)   # each frame's u32
    ref_device: object = None

    @property
    def frames(self) -> int:
        return len(self.frame_s)

    def device_events(self, device=None):
        return [e for e in self.events or ()
                if device is None or e.device == device]

    def busy_s(self, device) -> float:
        lo, hi = self.window_ns
        return stats.union([(e.start, e.end) for e in
                            self.device_events(device)], lo, hi) * 1e-9

    def log(self, msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)


def sync(devices) -> None:
    import torch

    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _events(prof):
    """(device events, host events [(start, end, name)] sorted, the
    window annotation's (start, end)) of a profile."""
    from torch.autograd import DeviceType

    dev, host, window = [], [], None
    for ev in prof.profiler.kineto_results.events():
        s, e = float(ev.start_ns()), float(ev.end_ns())
        if ev.device_type() == DeviceType.CUDA:
            if ev.name() == "benchmark.window":
                continue
            dev.append(DeviceEvent(ev.name(), int(ev.device_index()), s, e))
        else:
            name = ev.name()
            if name == "benchmark.window":
                window = (s, e)
            elif e > s:
                host.append((s, e, name))
    host.sort()
    return dev, host, window


def _host_at(host, starts, t: float) -> str:
    """The innermost host event running at time t."""
    i = bisect.bisect_right(starts, t) - 1
    for k in range(i, max(-1, i - 400), -1):
        s, e, name = host[k]
        if e >= t:
            return name
    return "host: python (no traced op)"


def breakdown(run: Run, host) -> dict:
    """The device operations that took most time, and the idle gaps of
    the window summed by what the host was doing."""
    ops = {}
    for e in run.events:
        ops[e.name] = ops.get(e.name, 0.0) + (e.end - e.start) * 1e-9
    lo, hi = run.window_ns
    starts = [h[0] for h in host]
    idle = {}
    for d in run.devices:
        for s, e in stats.gaps([(x.start, x.end) for x in
                                run.device_events(d)], lo, hi):
            label = _host_at(host, starts, 0.5 * (s + e))
            idle[label] = idle.get(label, 0.0) + (e - s) * 1e-9
    top = lambda m: [[k, v] for k, v in
                     sorted(m.items(), key=lambda kv: -kv[1])[:TRACE_TOP]]
    return {"device_ops": top(ops), "idle_gaps": top(idle)}


def run(cell: Cell, seed: int, seconds: float, trace: bool, devices,
        t0: float) -> dict:
    """One run (see the module docstring); returns the result object."""
    import torch

    spans = {}
    prog = cell.mode.Program(cell, seed, devices, spans)
    prog.warm()
    sync(devices)
    t_first = time.time()
    setup_s = t_first - t0
    frames, frame_s, seeds = [], [], []
    n_trace = int(cell.traffic["trace_frames"])
    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if devices[0].type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        ann = record_function("benchmark.window")
        ann.__enter__()
    w0 = time.perf_counter()
    i = 0
    while True:
        a = time.perf_counter()
        fr = prog.frame(i)
        b = time.perf_counter()
        frames.append(fr)
        frame_s.append(b - a)
        i += 1
        if (i >= n_trace) if trace else (b - w0 >= seconds):
            break
    window_s = time.perf_counter() - w0
    if trace:
        ann.__exit__(None, None, None)
        prof.__exit__(None, None, None)
    peak = max((torch.cuda.max_memory_allocated(d) for d in devices
                if d.type == "cuda"), default=0)
    record = Run(cell, seed, setup_s, window_s, frame_s,
                 [f.work for f in frames], spans,
                 [d.index or 0 for d in devices])
    record.frame_seeds = [traffic.frame_seed(seed, i)
                          for i in range(len(frames))]
    record.ref_device = devices[0]
    host = []
    if prof is not None:
        record.events, host, record.window_ns = _events(prof)
        del prof
    prog.release()
    del prog
    gc.collect()
    if devices[0].type == "cuda":
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    compared = cell.mode.check(cell, seed, frames, devices[0])
    print(f"the reference's check of {len(frames)} frames: "
          f"{time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    checks = {k: {"value": float(v), "limit": float(cell.limits[k])}
              for k, v in compared.items()}
    failed = sum(not f.ok for f in frames)
    correct = failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        mod = _load(os.path.join(BENCH, "metrics", m["name"] + ".py"),
                    "benchmark_metric_" + m["name"].replace(".", "_"))
        v = mod.read(record)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev0 = devices[0]
    device = {"platform": "gpu" if dev0.type == "cuda" else dev0.type,
              "kind": (torch.cuda.get_device_name(dev0)
                       if dev0.type == "cuda" else dev0.type),
              "count": len(devices), "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": len(frames),
           "failed": int(failed), "metrics": metrics, "device": device}
    if trace and record.window_ns is not None:
        lo, hi = record.window_ns
        busy = [record.busy_s(d) for d in record.devices]
        device["busy_s"] = sum(busy) / len(busy)
        device["window_s"] = (hi - lo) * 1e-9
        out["breakdown"] = breakdown(record, host)
    out["checks"] = checks
    return out
