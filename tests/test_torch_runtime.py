"""The port's runtime and profiling helpers, and its import boundary.

* ``CompileProgress`` behaves as the JAX package's: throttled heartbeats
  while a build runs, one summary line when it ends, none on an error.
* ``log_compile`` logs a build at info from 5 s, at debug below; the
  kernel build (``ops/cuda/build.py:_compile``) logs one line per nvcc
  with its seconds (run here with a stand-in nvcc script).
* ``analyse_model`` gives the JAX package's report, for numpy arrays and
  for tensors.
* ``acquire_devices``: CPU shards when asked, an error without a card.
* ``utils/profiling.trace`` writes a Chrome trace on the CPU, with no
  kernel event there (its spans: ``tests/test_torch_spans.py``).
* No module of the port, nor ``trace_torch.py``, ``chip_smoke.py`` or
  ``examples/verify_all_torch.py``, imports ``jax`` or the JAX package
  (``ipu_ray_lib_tpu.``): an AST walk of every import, and every module
  imported in a process where ``jax`` cannot be imported.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import ast
import json
import logging
import os
import stat
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from ipu_ray_lib_tpu.runtime import config as jconfig
from ipu_ray_lib_tpu.utils import profiling as jprof
from ipu_ray_lib_tpu_torch.ops.cuda import build as cuda_build
from ipu_ray_lib_tpu_torch.runtime import config as tconfig
from ipu_ray_lib_tpu_torch.utils import profiling as tprof

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
PORT = "ipu_ray_lib_tpu_torch"


def test_compile_progress_heartbeat_and_summary(caplog):
    with caplog.at_level(logging.INFO, logger=PORT):
        with tconfig.CompileProgress("unit-test", interval=0.02):
            time.sleep(0.12)
    msgs = [r.getMessage() for r in caplog.records if r.name == PORT]
    assert len([m for m in msgs if "elapsed" in m]) >= 2
    assert len([m for m in msgs if m.startswith("Compiled unit-test")]) == 1


def test_compile_progress_no_summary_on_error(caplog):
    with caplog.at_level(logging.INFO, logger=PORT):
        with pytest.raises(ValueError):
            with tconfig.CompileProgress("boom", interval=60.0):
                raise ValueError("compile failed")
    assert not [r for r in caplog.records if "Compiled boom" in r.getMessage()]


def test_log_compile_levels(caplog):
    with caplog.at_level(logging.DEBUG, logger=PORT):
        tconfig.log_compile("slow", 7.5)
        tconfig.log_compile("fast", 0.5)
    levels = {r.getMessage(): r.levelno for r in caplog.records}
    assert levels == {"Built slow: 7.5s": logging.INFO,
                      "Built fast: 0.5s": logging.DEBUG}


def test_kernel_build_logs_each_nvcc(tmp_path, monkeypatch, caplog):
    """A stand-in nvcc writes its -o file; the build logs each source's
    seconds and records them in build_info."""
    fake = tmp_path / "nvcc"
    fake.write_text('#!/bin/sh\nwhile [ "$#" -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then touch "$2"; fi; shift\n'
                    'done\n')
    fake.chmod(fake.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setenv("NVCC", str(fake))
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(cuda_build, "build_info", {})
    with caplog.at_level(logging.DEBUG, logger=PORT):
        so = cuda_build._compile()
    assert os.path.exists(so)
    msgs = [r.getMessage() for r in caplog.records]
    for src in cuda_build._SOURCES:
        assert [m for m in msgs if m.startswith(f"Built nvcc {src}: ")], src
    assert sorted(cuda_build.build_info["sources"]) == sorted(
        cuda_build._SOURCES)
    assert not cuda_build.build_info["cached"]


def test_analyse_model_matches_jax():
    rng = np.random.default_rng(3)
    params = {"kernels": [rng.normal(size=(8, 16)).astype(np.float32),
                          rng.normal(size=(16, 3)).astype(np.float32)],
              "biases": [np.zeros(16, np.float32), np.zeros(3, np.float32)]}
    want = jprof.analyse_model(params, sample_count=5)
    assert tprof.analyse_model(params, sample_count=5) == want
    as_tensors = {k: [torch.from_numpy(a) for a in v]
                  for k, v in params.items()}
    assert tprof.analyse_model(as_tensors, sample_count=5) == want


def test_acquire_devices(monkeypatch):
    devs = tconfig.acquire_devices(tconfig.RuntimeConfig(num_devices=3,
                                                         use_cpu=True))
    assert devs == [torch.device("cpu")] * 3
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tconfig.acquire_devices(tconfig.RuntimeConfig())
    # the JAX package's config has the same knobs:
    assert set(tconfig.RuntimeConfig.__dataclass_fields__) <= set(
        jconfig.RuntimeConfig.__dataclass_fields__)


def test_profiler_trace_on_the_cpu(tmp_path):
    path = str(tmp_path / "trace.json")
    with tprof.trace(path, cuda=False) as prof:
        x = torch.ones(64, 64)
        for _ in range(3):
            x = x @ x / 64.0
    assert prof is not None and os.path.getsize(path) > 0
    with open(path) as f:
        doc = json.load(f)
    assert any("mm" in e.get("name", "") for e in doc["traceEvents"])
    assert not any(e.get("cat") == "kernel" for e in doc["traceEvents"])


def _port_files():
    out = [os.path.join(ROOT, f) for f in
           ("trace_torch.py", "chip_smoke.py", "dryrun_multichip_torch.py",
            os.path.join("examples", "verify_all_torch.py"))]
    for d, _, fs in os.walk(os.path.join(ROOT, PORT)):
        out += [os.path.join(d, f) for f in fs if f.endswith(".py")]
    return sorted(out)


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in _imports(path)
           if m == "jax" or m.startswith("jax.") or m == "ipu_ray_lib_tpu"
           or m.startswith("ipu_ray_lib_tpu.")]
    assert not bad, bad


def test_every_port_module_imports_without_jax():
    mods = sorted(
        os.path.relpath(p, ROOT)[:-3].replace(os.sep, ".").removesuffix(
            ".__init__")
        for p in _port_files() if os.path.relpath(p, ROOT).startswith(PORT))
    code = ("import sys; sys.modules['jax'] = None\n"
            "import importlib\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "sys.path.insert(0, 'examples')\n"
            "import trace_torch, verify_all_torch\n"
            "assert not [m for m in sys.modules if m == 'ipu_ray_lib_tpu'"
            " or m.startswith('ipu_ray_lib_tpu.')]\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=300)
