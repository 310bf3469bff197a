"""Profiling and throughput observability (the port's counterpart of
``ipu_ray_lib_tpu/utils/profiling.py``).

Role of the reference's PVTI tracepoints, cycle counters, and rate logs
(ref: ipu_utils.hpp:533-571 trace channels, NifModel.cpp:341-348
cycleCount, trace.cpp:105-110/259-265/324-333 rays-and-paths-per-second
logs), on PyTorch:

* :func:`trace` — a ``torch.profiler`` capture around a code region,
  written as a Chrome trace (open it in chrome://tracing or Perfetto);
  :func:`kernel_summary` reads one back: its CUDA kernel events, their
  busy time and the span they cover (the device's idle share);
* :class:`RateMeter` — wall-clock throughput, optionally synchronising a
  CUDA device at both ends;
* :func:`block_on` — a timing barrier (``torch.cuda.synchronize``);
* :func:`device_memory_stats` — ``torch.cuda.memory_stats``.
"""

from __future__ import annotations

import contextlib
import json
import time

import numpy as np
import torch

from .log import logger


@contextlib.contextmanager
def trace(path: str, cuda: bool | None = None):
    """Capture a ``torch.profiler`` profile of the region (PVTI analogue)
    and write it to ``path`` as a Chrome trace. ``cuda`` (default: when a
    card is present) adds the CUDA activity: the kernels and copies on
    the card's timeline. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(path)
    logger().info("Profile trace written to %s", path)


def kernel_summary(path: str, top: int = 5) -> dict:
    """The CUDA kernel events of a Chrome trace written by :func:`trace`:
    their number, the device time they take (their union, µs), the span
    from the first kernel's start to the last one's end (µs), the idle
    share of that span, and the ``top`` kernels by summed time."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    ks = [e for e in events
          if e.get("cat") == "kernel" and e.get("ph") == "X"]
    out = {"kernel_events": len(ks), "busy_us": 0.0, "span_us": 0.0,
           "idle_share": None, "by_name": {}}
    if not ks:
        return out
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]))
                   for e in ks)
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    span = spans[-1][1] - spans[0][0]
    by_name: dict[str, list] = {}
    for e in ks:
        c = by_name.setdefault(e["name"], [0, 0.0])
        c[0] += 1
        c[1] += float(e["dur"])
    out.update(busy_us=busy, span_us=span,
               idle_share=1.0 - busy / span if span > 0 else 0.0,
               by_name={n: {"count": c, "us": us} for n, (c, us) in sorted(
                   by_name.items(), key=lambda kv: -kv[1][1])[:top]})
    return out


class RateMeter:
    """Times a region and reports units/second. With a CUDA ``device``
    the device is synchronised as the region starts and ends, so the time
    covers the work queued inside it."""

    def __init__(self, unit: str = "rays", device=None):
        self.unit = unit
        self.device = None if device is None else torch.device(device)
        self.elapsed = 0.0
        self.count = 0

    def _sync(self):
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def __enter__(self):
        self._sync()
        self._t0 = time.time()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.elapsed += time.time() - self._t0
        return False

    def add(self, n: int) -> None:
        self.count += n

    @property
    def rate(self) -> float:
        return self.count / self.elapsed if self.elapsed > 0 else 0.0

    def log(self, label: str = "") -> None:
        logger().info(
            "%s%.4g %s/sec (%d in %.2fs)",
            f"{label}: " if label else "", self.rate, self.unit,
            self.count, self.elapsed,
        )


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def block_on(tree):
    """Wait until the work behind every CUDA tensor in a nest of lists,
    tuples and dicts is done (a timing barrier); returns ``tree``."""
    for dev in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(dev)
    return tree


def device_memory_stats(device=None) -> dict:
    """``torch.cuda.memory_stats`` of ``device`` (default: the current
    card); empty without a card."""
    if not torch.cuda.is_available():
        return {}
    return dict(torch.cuda.memory_stats(device))


def analyse_model(params: dict, name: str = "nif", sample_count: int = 1) -> dict:
    """FLOPs/parameter report for an MLP params dict of numpy arrays or
    tensors (role of ref NifModel::analyseModel, NifModel.cpp:123-145)."""

    def nbytes(a):
        if isinstance(a, torch.Tensor):
            return a.numel() * a.element_size()
        return a.size * a.dtype.itemsize

    flops = 0
    param_bytes = 0
    for k, b in zip(params.get("kernels", ()), params.get("biases", ())):
        flops += 2 * int(np.prod(tuple(k.shape))) + int(b.shape[0])
        param_bytes += nbytes(k) + nbytes(b)
    report = {
        "layers": len(params.get("kernels", ())),
        "flops_per_sample": flops,
        "flops": flops * sample_count,
        "parameter_kib": param_bytes / 1024.0,
    }
    log = logger()
    log.info("%s layers: %d", name, report["layers"])
    log.info("%s model FLOPS: %d", name, report["flops"])
    log.info("%s parameter size: %.1f KiB", name, report["parameter_kib"])
    return report
