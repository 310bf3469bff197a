"""The grid512 cell (a 522,242-triangle heightfield through the HBM-mode
walk, K3 on a card) at sizes a CPU run holds: the cell loads with its
metrics, a sound run is correct, the control fails at the cell's own
size, a walk that skips its last super-group comes out not correct, and
``k3.ms_per_frame`` reads K3's launches and nothing else.

On the CPU the system runs its plain versions (the plain HBM walk holds
K3 on the card); the card's own comparison is the run's."""

import importlib.util
import json
import os
import types

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.harness import DeviceEvent, Run

ROOT = harness.ROOT
CELL = "grid512.path-1440-spp64"
CPU = torch.device("cpu")
MS = 1e6


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cell(grid=None, w=8, spp=2, intersector=None):
    """The cell at a w x w frame, every pixel checked; ``grid`` cuts the
    heightfield (with ``intersector`` to keep it in HBM mode)."""
    cfg = {"image_width": w, "image_height": w, "samples_per_pixel": spp}
    if grid is not None:
        base = harness.Cell(CELL).config
        scene = json.loads(json.dumps(base["scene"]))
        scene["meshes"][0]["grid"] = grid
        cfg.update(scene=scene, program=dict(base["program"], args=[grid]))
    if intersector is not None:
        cfg["intersector"] = intersector
    return harness.Cell(CELL, overrides={
        "config": cfg,
        "traffic": {"check_pixels": w * w, "trace_frames": 1, "chunk": 256}})


def _run(cell, seed=2147483659):
    return harness.run(cell, seed, 0.01, False, [CPU], 0.0)


def test_the_cell_loads():
    cell = harness.Cell(CELL)
    assert cell.chips == 1 and cell.traffic["mode"] == "path"
    assert cell.config["intersector"] == "auto"
    assert set(cell.limits) == {"pixel_rel_l1"}
    assert [m["name"] for m in cell.end_to_end] == ["paths_per_s", "setup_s"]
    pl = [m["name"] for m in cell.per_layer]
    assert "k3.ms_per_frame" in pl and "k1.ms_per_frame" not in pl
    assert {"streaming.launches_per_frame", "streaming.idle_ms_per_frame",
            "device.idle_pct.path"} <= set(pl)


def test_a_sound_run_is_correct():
    r = _run(_cell())
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert r["checks"]["pixel_rel_l1"]["value"] == 0.0
    assert set(r["metrics"]) == {"paths_per_s", "setup_s"}


def test_the_control_fails_at_the_cells_own_size():
    """The control against the reference on a few pixels of two frames
    of the cell's own configuration (the card reads it over a run's
    worth of frames: PERF.md)."""
    cell = harness.Cell(CELL, overrides={"traffic": {"check_pixels": 4}})
    want = cell.mode.reference(cell, 11, 2, CPU)
    assert (np.concatenate(want).max(axis=1) > 0).any()
    control = cell.mode.compare(
        cell.mode.reference(cell, 11, 2, CPU, control=True), want)
    assert all(v > cell.limits[k] for k, v in control.items()), control


def test_a_walk_that_skips_its_last_super_group_is_not_correct(monkeypatch):
    """Grid 128 in HBM mode (four super-groups): the plain walk with its
    last super-group's box never admitting a lane."""
    import ipu_ray_lib_tpu_torch.ops.megakernel as mk

    orig = mk._walk_hbm

    def fault(scene, *a, **k):
        sg = scene.sgaabb.clone()
        sg[-1, :3] = float("inf")
        return orig(types.SimpleNamespace(p=scene.p, baabb=scene.baabb,
                                          saabb=scene.saabb, sgaabb=sg),
                    *a, **k)
    cell = _cell(grid=128, w=16, spp=8, intersector="pallas-hbm")
    assert _run(cell)["correct"]
    monkeypatch.setattr(mk, "_walk_hbm", fault)
    r = _run(cell)
    assert r["failed"] == 0, "the fault hides from the frame's own count"
    assert not r["correct"], r["checks"]


def _read_k3():
    spec = importlib.util.spec_from_file_location(
        "m_k3_ms_per_frame",
        os.path.join(ROOT, "benchmark", "metrics", "k3.ms_per_frame.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _traced(events, frames=2):
    cell = types.SimpleNamespace(config={}, traffic={})
    r = Run(cell, 1, 1.0, 2.0, [1.0] * frames, [10] * frames, {}, [0])
    r.events = events
    r.window_ns = (0.0, 100 * MS)
    return r


K1 = ("void (anonymous namespace)::megakernel<false, false>"
      "((anonymous namespace)::Params)")
K3 = ("void (anonymous namespace)::megakernel<true, false>"
      "((anonymous namespace)::Params)")


def test_k3_reads_only_the_hbm_instantiation():
    read = _read_k3()
    ev = [DeviceEvent(K1, 0, 0.0, 30 * MS), DeviceEvent(K3, 0, 30 * MS, 40 * MS),
          DeviceEvent(K3, 0, 50 * MS, 56 * MS),
          DeviceEvent("Memcpy DtoH (Device -> Pageable)", 0, 60 * MS, 90 * MS)]
    assert read(_traced(ev)) == pytest.approx(8.0)
    assert read(_traced(ev[:1] + ev[3:])) is None
    assert read(_traced(ev, frames=1)) == pytest.approx(16.0)
    untraced = _traced(ev)
    untraced.events = None
    assert read(untraced) is None
