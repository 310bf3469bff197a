"""What the benchmark may load: the no-JAX check compares top-level
module names whole; the plain reference imports nothing of the system;
no file of the benchmark imports jax or the JAX package; a run without a
card fails and prints no result."""

import ast
import json
import os
import shutil
import subprocess
import sys

from benchmark.harness import forbidden_modules

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "benchmark")


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0], 0
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0], node.level


def _py(sub=""):
    base = os.path.join(BENCH, sub)
    for d, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_check_compares_whole_top_level_names():
    assert forbidden_modules(["ipu_ray_lib_tpu_torch",
                              "ipu_ray_lib_tpu_torch.ops.megakernel",
                              "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["ipu_ray_lib_tpu.ops"]) == ["ipu_ray_lib_tpu.ops"]
    assert forbidden_modules(["jax", "jaxlib.xla_client", "flax.linen"]) == [
        "flax.linen", "jax", "jaxlib.xla_client"]


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in _py():
        for top, _ in _imports(path):
            assert top not in ("jax", "jaxlib", "flax", "ipu_ray_lib_tpu"), path


def test_reference_imports_nothing_of_the_system():
    allowed = {"", "numpy", "torch", "json", "os", "struct", "math",
               "dataclasses", "typing", "__future__", "functools",
               "importlib"}
    for path in list(_py("reference")) + list(_py("configs")):
        for top, level in _imports(path):
            assert level > 0 or top in allowed, (path, top)


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "cornell-monkey.path-1440-spp64", "--seed",
                        "2147483659", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_a_run_with_only_the_benchmark_fails(tmp_path):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        paths = json.load(f)["paths"]
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    for p in paths:
        shutil.copytree(os.path.join(ROOT, p), tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "cornell-monkey.path-1440-spp64", "--seed", "3",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
