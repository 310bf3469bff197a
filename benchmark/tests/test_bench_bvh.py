"""The compact-BVH shadow cell (``cornell-monkey-bvh.shadow-1440-bvh``:
the Cornell box and monkey bust through K7 and the glue route) at sizes a
CPU run holds: the cell loads with its metrics, a sound run reads below
its limit, the control reads above it at the cell's own size, and runs
with their timed path broken underneath read above it, once for each
fault: the any-hit walk skipped, the walk stopping at the end of the
root's first child, and the fused route's frame (``intersector="pallas"``)
judged by this reference, so the check tells the two routes apart. The
readers: ``k7.ms_per_frame`` and ``k7_roofline`` read K7's launches and
nothing else; ``renderer.glue_idle_ms_per_frame`` reads the glue route's
three spans (which record under a profiler only:
``tests/test_torch_bvh_shadow_ref.py``) and nothing at a program without
them.

On the CPU the system runs its plain versions (the plain walk holds K7
on the card); the card's own comparison is the run's."""

import importlib.util
import os
import sys
import types

import numpy as np
import pytest
import torch

from benchmark import harness, spans
from benchmark.harness import DeviceEvent, Run

ROOT = harness.ROOT
CELL = "cornell-monkey-bvh.shadow-1440-bvh"
CPU = torch.device("cpu")
MS = 1e6
GLUE = ("renderer.hit", "renderer.occlusion", "renderer.shade")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cell(w=32, **config):
    """The cell at a w x w frame, every pixel checked, chunks of 256."""
    return harness.Cell(CELL, overrides={
        "config": dict(image_width=w, image_height=w, **config),
        "traffic": {"check_pixels": w * w, "trace_frames": 1, "chunk": 256}})


def _run(cell, seed=2147483659):
    return harness.run(cell, seed, 0.01, False, [CPU], 0.0)


def _metric(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"),
        os.path.join(ROOT, "benchmark", "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_cell_loads():
    cell = harness.Cell(CELL)
    assert cell.chips == 1 and cell.traffic["mode"] == "shadow_bvh"
    assert cell.config["intersector"] == "bvh"
    assert cell.config["image_width"] == cell.config["image_height"] == 1440
    base = harness.Cell("cornell-monkey.shadow-1440")
    assert cell.config["scene"] == base.config["scene"]
    assert {k: v for k, v in cell.traffic.items() if k not in ("mode", "why")} \
        == {k: v for k, v in base.traffic.items() if k not in ("mode", "why")}
    assert set(cell.limits) == {"aov_mismatch_pct"}
    assert [m["name"] for m in cell.end_to_end] == [
        "shadow_frame_ms", "frame_ms_p90", "setup_s"]
    pl = {m["name"] for m in cell.per_layer}
    assert {"k7.ms_per_frame", "k7_roofline",
            "renderer.glue_idle_ms_per_frame", "renderer.launches_per_frame",
            "renderer.idle_ms_per_frame", "device.idle_pct.shadow"} <= pl
    assert not pl & {"k4.ms_per_frame", "renderer.replays_per_frame",
                     "renderer.cull_idle_ms_per_frame",
                     "renderer.epilogue_idle_ms_per_frame"}


def test_a_sound_run_is_correct():
    r = _run(_cell())
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert r["checks"]["aov_mismatch_pct"]["value"] == 0.0
    assert set(r["metrics"]) == {"shadow_frame_ms", "frame_ms_p90", "setup_s"}


def test_the_control_fails_at_the_cells_own_size():
    """The control against the reference on 16 pixels of two frames of
    the cell's own configuration (the card reads it over a run's worth
    of frames: PERF.md)."""
    cell = harness.Cell(CELL, overrides={"traffic": {"check_pixels": 16}})
    want = cell.mode.reference(cell, 11, 2, CPU)
    assert (np.concatenate([w["geom_id"] for w in want]) >= 0).mean() > 0.5
    control = cell.mode.compare(
        cell.mode.reference(cell, 11, 2, CPU, control=True), want)
    assert all(v > 10 * cell.limits[k] for k, v in control.items()), control


def _skip_any_hit(monkeypatch):
    import ipu_ray_lib_tpu_torch.render.shadow as sh

    monkeypatch.setattr(sh, "scene_occluded",
                        lambda scene, o, d, *a: torch.zeros(
                            d.shape[0], dtype=torch.bool, device=d.device))


def _first_child_only(monkeypatch):
    """Every miss link that leads to the root's second child ends the
    walk instead: the walk stops at the end of the first child's subtree."""
    from ipu_ray_lib_tpu_torch.ops import bvh

    orig = bvh.unpack_nodes

    def unpack(nodes):
        lo, hi, meta, geom, miss = orig(nodes)
        return lo, hi, meta, geom, torch.where(miss == miss[1], len(miss),
                                               miss)
    monkeypatch.setattr(bvh, "unpack_nodes", unpack)


@pytest.mark.parametrize("fault", ["skip_any_hit", "first_child_only",
                                   "fused_route"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    config = {}
    if fault == "skip_any_hit":
        _skip_any_hit(monkeypatch)
    elif fault == "first_child_only":
        _first_child_only(monkeypatch)
    else:
        config = {"intersector": "pallas"}
    r = _run(_cell(48, **config))
    assert r["failed"] == 0, "the fault hides from the frame's own count"
    assert not r["correct"], r["checks"]


def _traced(events, frames=2, cell=None):
    cell = cell or types.SimpleNamespace(config={}, traffic={})
    r = Run(cell, 1, 1.0, 2.0, [1.0] * frames, [10] * frames, {}, [0])
    r.events = events
    r.window_ns = (0.0, 100 * MS)
    return r


K7 = ("void (anonymous namespace)::bvh_kernel<false>"
      "((anonymous namespace)::Params)")
K7_ANY = ("void (anonymous namespace)::bvh_kernel<true>"
          "((anonymous namespace)::Params)")
K4 = "void (anonymous namespace)::shadow_kernel<4>(Params)"


def test_k7_reads_both_walks_and_nothing_else():
    read = _metric("k7.ms_per_frame").read
    ev = [DeviceEvent(K4, 0, 0.0, 30 * MS),
          DeviceEvent(K7, 0, 30 * MS, 34 * MS),
          DeviceEvent(K7_ANY, 0, 50 * MS, 52 * MS),
          DeviceEvent("Memcpy DtoH (Device -> Pinned)", 0, 60 * MS, 90 * MS)]
    assert read(_traced(ev)) == pytest.approx(3.0)
    assert read(_traced(ev[:1] + ev[3:])) is None
    untraced = _traced(ev)
    untraced.events = None
    assert read(untraced) is None


def test_k7_roofline_is_the_least_bytes_over_k7s_time():
    mod = _metric("k7_roofline")
    # a 1440^2 frame moves 68 B a pixel: 141,004,800 B, 0.04209 ms
    assert mod.least_bytes(1440, 1440) == 141_004_800
    cell = harness.Cell(CELL)
    ev = [DeviceEvent(K7, 0, 0.0, 1.0 * MS),
          DeviceEvent(K7_ANY, 0, 2 * MS, 2.5 * MS)]
    least_ms = 1e3 * 141_004_800 / 3.35e12
    r = _traced(ev, frames=1, cell=cell)
    r.seed = 2147483659
    assert mod.read(r) == pytest.approx(100 * least_ms / 1.5)
    assert mod.read(_traced([DeviceEvent(K4, 0, 0.0, MS)], cell=cell)) is None


def test_node_work_counts_both_walks():
    mod = _metric("k7_roofline")
    cell = harness.Cell(CELL, overrides={"traffic": {"check_pixels": 32}})
    r = _traced([], frames=1, cell=cell)
    r.seed = 7
    work = mod.node_work(r)
    assert work["rays"] == 32
    # each walk visits the root at least, and the leaves it tests
    assert work["node_visits"] >= 2 * 32 + work["leaf_tests"] > 0


def test_glue_idle_reads_its_three_spans(monkeypatch):
    read = _metric("renderer.glue_idle_ms_per_frame").read
    ev = [DeviceEvent(K7, 0, 10 * MS, 20 * MS),
          DeviceEvent(K7_ANY, 0, 40 * MS, 45 * MS)]
    host = [(0, 10 * MS, "renderer.rays"), (10 * MS, 30 * MS, "renderer.hit"),
            (30 * MS, 50 * MS, "renderer.occlusion"),
            (50 * MS, 60 * MS, "renderer.shade"),
            (60 * MS, 100 * MS, "renderer.readback")]
    mod = types.SimpleNamespace(recorded_spans=lambda: list(host))
    monkeypatch.setitem(sys.modules, spans.PROFILING, mod)
    # idle under [10, 60]: 10 + 15 + 10 = 35 ms over 2 frames
    assert read(_traced(ev)) == pytest.approx(17.5)
    # the parent's glue route records none of them
    mod.recorded_spans = lambda: [h for h in host if h[2] not in GLUE]
    assert read(_traced(ev)) is None
