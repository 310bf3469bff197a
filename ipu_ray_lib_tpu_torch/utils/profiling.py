"""Profiling and throughput observability (the port's counterpart of
``ipu_ray_lib_tpu/utils/profiling.py``).

Role of the reference's PVTI tracepoints and cycle counters (ref:
ipu_utils.hpp:533-571 trace channels, NifModel.cpp:341-348 cycleCount),
on PyTorch:

* :func:`span` — a named host range ``<layer>.<phase>`` inside the
  frame drivers (``streaming.*`` in ``render/streaming.py`` and
  ``ops/megakernel.py``, ``renderer.*`` in the shadow trace of
  ``render/renderer.py``, ``render/shadow.py`` and ``ops/shadow.py``,
  ``mesh.*`` in ``parallel/mesh.py``, ``hbm.cull`` in
  ``ops/intersect_hbm.py``). It records only while a
  ``torch.profiler`` profile runs: into the profile, as a host op, and into
  :func:`recorded_spans` on the clock of the profile's events;
  otherwise it reads one flag and calls nothing in torch;
* :func:`trace` — a ``torch.profiler`` capture around a code region,
  written as a Chrome trace (open it in chrome://tracing or Perfetto):
  the spans on the host's row, the kernels and copies on the card's;
* :func:`analyse_model` — the NIF's FLOPs and parameter size.
"""

from __future__ import annotations

import collections
import contextlib
import time

import numpy as np
import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import profiler as _autograd_profiler

from .log import logger

_NO_SPAN = contextlib.nullcontext()
# (start_ns, end_ns, name) of the spans closed under a profiler, oldest
# first; bounded, so a long profile keeps its last 2**18
_RECORDED = collections.deque(maxlen=1 << 18)


class _Span:
    """A host range in the profile and in :data:`_RECORDED`.

    The range is a ``FUNCTION``-scope record function: a profile shows it
    on the host's row as ``record_function`` would, but kineto makes no
    copy of it on the card's timeline (it copies ``USER_SCOPE`` ranges,
    ``gpu_user_annotation``), which device-trace readings would count as
    the card's work. Its times are ``time.time_ns()``: kineto's host and
    device events are in epoch ns too."""

    __slots__ = ("name", "_rf", "_t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._rf = _RecordFunctionFast(self.name)
        self._rf.__enter__()
        self._t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        _RECORDED.append((self._t0, time.time_ns(), self.name))
        self._rf.__exit__(*exc)
        return False


def span(name: str):
    """A context that records the host range ``name`` while a
    ``torch.profiler`` profile runs; with none running, one shared no-op
    context that calls nothing in torch. It never synchronises a
    device."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return _Span(name)


def recorded_spans() -> list:
    """[(start_ns, end_ns, name)] of the spans closed under a profiler,
    in the order they closed, on the clock of the profile's events."""
    return list(_RECORDED)


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
