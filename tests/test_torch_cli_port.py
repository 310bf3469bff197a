"""``trace_torch.py`` on its own (the CPU): its arguments, device choice,
compile-only mode and compiled-scene cache.

* Bad arguments exit with an error (argparse's, exit code 2): a bad
  ``--crop``, a path trace with ``--visualise normal``; ``--intersector
  dense`` and ``bvh`` are accepted (the threaded-BVH walk and the dense
  closest hit; tests/test_torch_intersector_routes.py holds their
  images).
* ``--devices 2 --nif-hdri`` shards the per-sample path trace
  (``render_path_sharded``), as trace.py does: its EXR holds
  tests/test_torch_env.py's split tolerance against trace.py's (measured
  at 16x16 spp 2: 99.74% of the elements within rtol 1e-2, the largest
  relative difference 1.3e-2); ``--nif-hdri`` with ``--devices`` left at
  0 (every card) on a host with two cards shards over both, as
  ``--devices 2`` does.
* ``--device cuda`` (the default) without a card raises; it never falls
  back to the CPU.
* ``--compile-only --device cpu`` builds the tables (and saves them with
  ``--scene-cache``), builds no kernel, writes no image, and returns 0.
* The cache: a second run loads the bundle and writes the same bytes;
  the oracle still runs on a hit (it reads the scene description); a
  mesh edit misses the cache; the JAX package's bundle for the same flags
  is another file.
* ``--gpu-only`` and its alias ``--tpu-only`` are one flag;
  ``--progressive`` reports each batch.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import logging
import os

import numpy as np
import pytest
import torch

from ipu_ray_lib_tpu_torch.ops.cuda import build as cuda_build
from ipu_ray_lib_tpu_torch.utils.exr import read_exr
from test_torch_env import hold_high_frequency, split
from torch_cli_pairs import JAX_CLI, PORT_CLI, run_pair, same_bytes

SHADOW = ["--scene", "box-simple", "-w", "16", "-H", "16", "--render-mode",
          "shadow-trace", "--visualise", "normal"]
PATH = ["--scene", "box", "-w", "8", "-H", "8", "--samples", "2"]


def port(tmp_path, *argv, out="o"):
    return PORT_CLI.run(list(argv) + ["--device", "cpu", "-o",
                                      str(tmp_path / out), "--log-level",
                                      "warn"])


@pytest.mark.parametrize("argv, message", [
    (["--crop", "8by8"], "Badly formatted --crop"),
    (["--visualise", "normal"], "visualise=rgb"),
    (["--intersector", "dense"], None),
    (["--intersector", "bvh"], None),
])
def test_bad_arguments_exit_with_an_error(capsys, argv, message):
    """Bad arguments exit with argparse's error; ``--intersector dense``
    and ``bvh`` (once refused, hence the name) are accepted: the CLI
    builds the scene's tables for them and returns 0."""
    if message is None:
        rec = PORT_CLI.run(argv + ["--device", "cpu", "--compile-only", "-w",
                                   "8", "-H", "8", "--log-level", "warn"])
        assert rec["params"].intersector == argv[1]
        assert "error" not in capsys.readouterr().err
        return
    with pytest.raises(SystemExit) as e:
        PORT_CLI.main(argv + ["--device", "cpu"])
    assert e.value.code == 2
    assert message in capsys.readouterr().err


def test_sharded_nif_is_not_ported(tmp_path):
    """``--devices 2 --nif-hdri`` (once refused, hence the name) shards
    the per-sample path trace: its EXR against trace.py's."""
    pairs = run_pair(tmp_path, [
        "--scene", "spheres", "--nif-hdri", "assets/nif/synthetic_urban_4k",
        "-w", "16", "-H", "16", "--samples", "2", "--tpu-only",
        "--devices", "2"])
    got, want = (read_exr(p) for p in pairs["gpu"])
    assert got.shape == want.shape == (16, 16, 3)
    assert got.mean() > 0.05
    hold_high_frequency(split(got, want))


def test_nif_on_every_card_renders_on_one(tmp_path, monkeypatch):
    """Every card is now two shards, as ``--devices 2``."""
    from ipu_ray_lib_tpu_torch.runtime import device as rdev

    # Two stand-in cards, each the CPU, through acquire_devices' own path:
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "stand-in")
    monkeypatch.setattr(rdev, "cuda_device", lambda i=0: torch.device("cpu"))
    argv = ["--scene", "spheres", "--nif-hdri",
            "assets/nif/synthetic_urban_4k", "-w", "8", "-H", "8",
            "--samples", "2", "--gpu-only", "--log-level", "warn"]
    rec = PORT_CLI.run(argv + ["-o", str(tmp_path / "all")])
    two = port(tmp_path, *argv[:-2], "--devices", "2", out="two")
    one = port(tmp_path, *argv[:-2], "--devices", "1", out="one")
    assert rec["shards"] == two["shards"] == 2 and one["shards"] == 1
    assert same_bytes(rec["outputs"]["gpu"], two["outputs"]["gpu"])
    assert not same_bytes(rec["outputs"]["gpu"], one["outputs"]["gpu"])


def test_cuda_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PORT_CLI.main(PATH + ["--gpu-only", "-o", str(tmp_path / "o")])
    assert not os.listdir(tmp_path)


def test_compile_only_on_the_cpu_builds_tables_only(tmp_path, monkeypatch):
    def no_build():
        raise AssertionError("the kernels were built")

    monkeypatch.setattr(cuda_build, "load", no_build)
    cache = str(tmp_path / "cache")
    rec = port(tmp_path, *PATH, "--compile-only", "--scene-cache", cache)
    assert rec["outputs"] == {} and "compile" not in rec["seconds"]
    assert rec["seconds"]["build"] > 0
    assert len(os.listdir(cache)) == 1
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".exr")]
    assert PORT_CLI.main(PATH + ["--compile-only", "--device", "cpu",
                                 "--log-level", "warn"]) == 0


def test_cache_hit_renders_the_same_bytes_and_runs_the_oracle(tmp_path):
    cache = str(tmp_path / "cache")
    a = port(tmp_path, *SHADOW, "--scene-cache", cache, out="a")
    b = port(tmp_path, *SHADOW, "--scene-cache", cache, out="b")
    assert not a["cache_hit"] and b["cache_hit"]
    assert "cache_load" in b["seconds"] and "build" not in b["seconds"]
    assert len(os.listdir(cache)) == 1
    assert sorted(b["outputs"]) == ["cpu", "gpu", "oracle"]
    for kind in a["outputs"]:
        assert same_bytes(a["outputs"][kind], b["outputs"][kind]), kind
    assert b["mse"]["oracle"] < 1e-3


def test_cache_misses_on_a_mesh_edit(tmp_path):
    obj = tmp_path / "tri.obj"
    obj.write_text("v 0 0 -5\nv 1 0 -5\nv 1 1 -5\nf 1 2 3\n")
    cache = str(tmp_path / "cache")
    argv = ["--mesh-file", str(obj), "-w", "8", "-H", "8", "--render-mode",
            "shadow-trace", "--visualise", "id", "--chunk-size", "64",
            "--gpu-only", "--scene-cache", cache]
    assert not port(tmp_path, *argv, out="o1")["cache_hit"]
    assert len(os.listdir(cache)) == 1
    obj.write_text("v 0 0 -5\nv 2 0 -5\nv 2 2 -5\nv 0 2 -5\n"
                   "f 1 2 3\nf 1 3 4\n")
    rec = port(tmp_path, *argv, out="o2")
    assert not rec["cache_hit"]
    assert len(os.listdir(cache)) == 2
    assert read_exr(rec["outputs"]["gpu"]).max() > 0


def test_jax_and_port_bundles_are_separate_files(tmp_path):
    cache = str(tmp_path / "cache")
    argv = SHADOW[:3] + ["8", "-H", "8"] + SHADOW[6:] + [
        "--tpu-only", "--scene-cache", cache]
    assert JAX_CLI.main(argv + ["--intersector", "pallas", "-o",
                                str(tmp_path / "j"), "--log-level",
                                "warn"]) == 0
    assert len(os.listdir(cache)) == 1
    assert not port(tmp_path, *argv, out="t1")["cache_hit"]
    assert len(os.listdir(cache)) == 2
    assert port(tmp_path, *argv, out="t2")["cache_hit"]


def test_gpu_only_and_tpu_only_are_one_flag(tmp_path):
    a = port(tmp_path, *SHADOW, "--gpu-only", out="a")
    b = port(tmp_path, *SHADOW, "--tpu-only", out="b")
    assert list(a["outputs"]) == list(b["outputs"]) == ["gpu"]
    assert same_bytes(a["outputs"]["gpu"], b["outputs"]["gpu"])


def test_progressive_reports_each_batch(tmp_path, caplog):
    with caplog.at_level(logging.INFO, logger="ipu_ray_lib_tpu_torch"):
        rec = PORT_CLI.run(PATH[:-1] + ["20", "--progressive", "--gpu-only",
                                        "--device", "cpu", "-o",
                                        str(tmp_path / "p")])
    done = [r for r in caplog.records if "done (mean" in r.getMessage()]
    assert len(done) == 2  # batches of 16 and 4 samples
    img = read_exr(rec["outputs"]["gpu"])
    assert img.shape == (8, 8, 3) and np.isfinite(img).all()
