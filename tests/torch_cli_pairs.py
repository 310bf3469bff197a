"""Helpers of the CLI parity tests (tests/test_torch_cli*.py): run
``trace.py`` (the JAX package, interpret mode on the CPU) and
``trace_torch.py`` (the port, ``--device cpu``) with the same flags and
pair their EXR files."""

import importlib.util
import os

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")


def load_cli(name: str):
    """The root script ``name``.py as a module (by path: the standard
    library has a module named ``trace``)."""
    spec = importlib.util.spec_from_file_location(
        f"_{name}_cli", os.path.join(ROOT, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JAX_CLI = load_cli("trace")
PORT_CLI = load_cli("trace_torch")


def run_pair(tmp_path, argv, vis="rgb", intersector=None):
    """Both CLIs on ``argv``; returns {kind: (port file, JAX file)} for
    every image both wrote (gpu/tpu, cpu, oracle). ``intersector`` None:
    ``pallas`` for trace.py (its accelerator's choice off the TPU) and
    ``auto`` for the port; else that one for both."""
    jout, tout = str(tmp_path / "jax"), str(tmp_path / "port")
    own = [] if intersector is None else ["--intersector", intersector]
    assert JAX_CLI.main(list(argv) + ["--intersector", intersector or "pallas",
                                      "-o", jout, "--log-level", "warn"]) == 0
    rec = PORT_CLI.run(list(argv) + own + ["--device", "cpu", "-o", tout,
                                           "--log-level", "warn"])
    pairs = {}
    for kind, path in rec["outputs"].items():
        jkind = "tpu" if kind == "gpu" else kind
        jpath = f"{jout}_{vis}_{jkind}.exr"
        assert path == f"{tout}_{vis}_{kind}.exr"
        assert os.path.exists(jpath), jpath
        pairs[kind] = (path, jpath)
    return pairs


def same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()
