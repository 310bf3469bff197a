"""The port's ``render_streaming`` end to end on the CPU.

* It reproduces the golden image ``tests/golden/box48x32_spp2.npy`` (the
  JAX megakernel's Cornell render) at rtol = atol = 1e-5, done == 3072.
* It matches the JAX ``render_streaming`` with a slot pool of 512 (J = 3
  pixels per slot) and with ``SPP_BATCH`` = 1 in both modules — the spp
  batch seed schedule is part of the RNG contract.
* The port never imports jax, h5py or the JAX package: every module
  imports, and the NIF weights load, in a process where jax and h5py are
  blocked.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import os
import pathlib
import pkgutil
import re
import subprocess
import sys

import numpy as np
import pytest

import ipu_ray_lib_tpu.render.streaming as JS
import ipu_ray_lib_tpu_torch
import ipu_ray_lib_tpu_torch.render.streaming as TS
from ipu_ray_lib_tpu.scene.build import build_scene as jax_build_scene
from ipu_ray_lib_tpu.scene.builtin import make_cornell_box_scene as jax_cornell
from ipu_ray_lib_tpu_torch.scene.build import build_scene
from ipu_ray_lib_tpu_torch.scene.builtin import make_cornell_box_scene

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "box48x32_spp2.npy")
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def port_scene():
    return build_scene(make_cornell_box_scene(None, box_only=False),
                       device="cpu", image_width=48, image_height=32,
                       samples_per_pixel=2)


@pytest.fixture(scope="module")
def jax_scene():
    arrays, params, _ = jax_build_scene(
        jax_cornell(None, box_only=False), image_width=48, image_height=32,
        samples_per_pixel=2, intersector="pallas")
    return arrays, params


def test_render_reproduces_golden(port_scene):
    ts, params = port_scene
    rgb, done = TS.render_streaming(ts, params)
    assert done == 48 * 32 * 2
    assert rgb.shape == (32, 48, 3) and rgb.dtype == np.float32
    np.testing.assert_allclose(rgb, np.load(GOLDEN), **TOL)


def test_render_matches_jax_small_slot_pool(port_scene, jax_scene):
    ts, params = port_scene
    assert TS.slot_pool(48 * 32, 512) == (512, 3)
    rgb, done = TS.render_streaming(ts, params, chunk_slots=512)
    want, want_done = JS.render_streaming(*jax_scene, chunk_slots=512, spp=2)
    assert done == want_done == 48 * 32 * 2
    np.testing.assert_allclose(rgb, np.asarray(want), **TOL)


def test_render_matches_jax_spp_batches(port_scene, jax_scene, monkeypatch):
    monkeypatch.setattr(JS, "SPP_BATCH", 1)
    monkeypatch.setattr(TS, "SPP_BATCH", 1)
    ts, params = port_scene
    rgb, done = TS.render_streaming(ts, params)
    want, want_done = JS.render_streaming(*jax_scene, spp=2)
    assert done == want_done == 48 * 32 * 2
    np.testing.assert_allclose(rgb, np.asarray(want), **TOL)
    # two batches of one sample are a different estimate than one of two:
    assert not np.allclose(rgb, np.load(GOLDEN), **TOL)


def test_dispatch_cap_uses_global_j(port_scene, monkeypatch):
    """b_cap = MAX_K_PER_DISPATCH // J with the frame's J: capping the
    dispatch at 2 paths per slot with J = 3 forces batches of one
    sample, the same schedule as SPP_BATCH = 1."""
    ts, params = port_scene
    monkeypatch.setattr(TS, "MAX_K_PER_DISPATCH", 2)
    capped, d1 = TS.render_streaming(ts, params, chunk_slots=512)
    monkeypatch.setattr(TS, "MAX_K_PER_DISPATCH", 2048)
    monkeypatch.setattr(TS, "SPP_BATCH", 1)
    batched, d2 = TS.render_streaming(ts, params, chunk_slots=512)
    assert d1 == d2 == 48 * 32 * 2
    np.testing.assert_array_equal(capped, batched)


def test_crop_window_renders_window_only():
    from ipu_ray_lib_tpu_torch.scene.types import CropWindow

    ts, params = build_scene(make_cornell_box_scene(None, box_only=False),
                             device="cpu", image_width=48, image_height=32,
                             window=CropWindow(16, 8, 20, 12),
                             samples_per_pixel=2)
    rgb, done = TS.render_streaming(ts, params)
    assert rgb.shape == (8, 16, 3) and done == 16 * 8 * 2
    assert np.isfinite(rgb).all() and rgb.sum() > 0


def _port_modules():
    pkg = pathlib.Path(ipu_ray_lib_tpu_torch.__file__).parent
    return ["ipu_ray_lib_tpu_torch"] + [
        m.name for m in pkgutil.walk_packages([str(pkg)],
                                              "ipu_ray_lib_tpu_torch.")]


def test_every_module_imports_without_jax():
    """Every module imports, and the NIF path loads its weights, in a
    process where jax and h5py are blocked (the card's machine has
    neither)."""
    mods = _port_modules()
    for m in ("ops.megakernel", "ops.env", "nif.hdf5", "nif.metadata",
              "nif.model", "scene.builtin", "render.streaming",
              "parallel.mesh", "utils.xoshiro"):
        assert f"ipu_ray_lib_tpu_torch.{m}" in mods, m
    code = (
        "import importlib, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['h5py'] = None\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "from ipu_ray_lib_tpu_torch.nif.model import load_nif_env\n"
        "env = load_nif_env('assets/nif/synthetic_urban_4k', device='cpu')\n"
        "assert env.num_layers == 6\n"
        "bad = [m for m, v in sys.modules.items() if v is not None and "
        "m.split('.')[0] in ('jax', 'jaxlib', 'h5py', 'ipu_ray_lib_tpu')]\n"
        "assert not bad, bad\n")
    root = pathlib.Path(ipu_ray_lib_tpu_torch.__file__).parent.parent
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


def test_no_jax_import_statements():
    pkg = pathlib.Path(ipu_ray_lib_tpu_torch.__file__).parent
    pat = re.compile(r"^\s*(import|from) (jax|h5py|ipu_ray_lib_tpu)\b", re.M)
    files = list(pkg.rglob("*.py")) + [
        pkg.parent / f for f in ("chip_smoke.py", "dryrun_multichip_torch.py",
                                 "tests/torch_multihost_worker.py")]
    hits = [str(p) for p in files if pat.search(p.read_text())]
    assert not hits, hits
