"""Runtime configuration and device management (the port's
counterpart of ``ipu_ray_lib_tpu/runtime/config.py``).

The roles of the reference's runtime framework (ref:
include/ipu_utils.hpp — RuntimeConfig:174-183, DeferredDevice:79-172,
executable caching:51-76, CallbackFilter:476-518), on CUDA:

* device acquisition: the CUDA cards, raising when none is present
  unless the caller asks for the CPU (the plain versions of the kernels);
* executable caching: the hand-written kernels are built once by nvcc
  into ``ipu_ray_lib_tpu_torch/_build/``, keyed on a hash of their
  sources and flags (``ops/cuda/build.py``), the role of the JAX
  package's persistent compilation cache;
* compile progress: a heartbeat while a build runs (:class:`CompileProgress`)
  and one log line per finished nvcc build with its seconds
  (:func:`log_compile`), at info level from ``INFO_THRESHOLD_SECS``;
* compile-only mode: build the kernels without rendering
  (:func:`compile_only`).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass

import torch

from ..utils.log import logger

# Builds at least this long log at info, shorter ones at debug (the
# JAX package's compile-event filter, its config.py:131-158).
INFO_THRESHOLD_SECS = 5.0


@dataclass
class RuntimeConfig:
    """Run-level knobs (role of ref RuntimeConfig, ipu_utils.hpp:174-183)."""

    num_devices: int = 0          # 0 = all available (ref: numIpus)
    use_cpu: bool = False         # the plain versions on the CPU


def acquire_devices(config: RuntimeConfig) -> list[torch.device]:
    """The devices to render on (role of ref DeferredDevice).

    CUDA cards by default: every card, or the first ``num_devices``;
    raises when no card is present, never falling back to the CPU. With
    ``use_cpu`` the CPU, once per requested shard (a mesh may list a
    device more than once: ``parallel/mesh.py``)."""
    log = logger()
    if config.use_cpu:
        devices = [torch.device("cpu")] * max(config.num_devices, 1)
        log.info("Using the CPU (the kernels' plain versions), %d shard(s)",
                 len(devices))
        return devices
    from .device import cuda_device

    t0 = time.time()
    devices = [cuda_device(i) for i in range(max(torch.cuda.device_count(),
                                                 1))]
    log.info("Acquired %d CUDA device(s) (%s) in %.1fs", len(devices),
             torch.cuda.get_device_name(0), time.time() - t0)
    if config.num_devices > 0:
        if len(devices) < config.num_devices:
            log.warning("Requested %d devices, only %d available",
                        config.num_devices, len(devices))
        devices = devices[: config.num_devices]
    return devices


class CompileProgress:
    """Compile-progress observability (role of the reference's
    CallbackFilter, ipu_utils.hpp:476-518): a heartbeat thread that logs
    the elapsed time at a throttled cadence while a (possibly long) build
    runs, so a long build shows liveness instead of silence, and a line
    with its seconds when it ends."""

    def __init__(self, name: str, interval: float = 15.0):
        self.name = name
        self.interval = interval
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.t0 = 0.0

    def __enter__(self):
        self.t0 = time.time()
        self._thread = threading.Thread(target=self._beat, daemon=True)
        self._thread.start()
        return self

    def _beat(self):
        while not self._stop.wait(self.interval):
            logger().info(
                "Compiling %s ... %.0fs elapsed", self.name, time.time() - self.t0
            )

    def __exit__(self, exc_type, exc, tb):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
        if exc_type is None:
            logger().info(
                "Compiled %s in %.1fs", self.name, time.time() - self.t0
            )
        return False


def log_compile(what: str, seconds: float) -> None:
    """Log one finished build with its seconds: at info level from
    ``INFO_THRESHOLD_SECS``, else at debug (the filter half of the
    reference's CallbackFilter; ``ops/cuda/build.py`` calls it for each
    nvcc)."""
    log = logger()
    (log.info if seconds >= INFO_THRESHOLD_SECS else log.debug)(
        "Built %s: %.1fs", what, seconds)


def compile_only() -> dict:
    """Build the CUDA kernel library without running anything (ref
    compileOnly, ipu_utils.hpp:581-584) under a :class:`CompileProgress`
    heartbeat; a later run loads it from ``_build/``. Returns the build's
    record (``ops/cuda/build.py:build_info``: seconds, cache hit, each
    source's nvcc seconds). Needs nvcc (it raises without it)."""
    from ..ops.cuda import build as cuda_build

    with CompileProgress("the CUDA kernels"):
        cuda_build.load()
    return dict(cuda_build.build_info)
