"""``renderer.replays_per_frame`` on plain interval lists: the program's
``renderer.replay`` spans inside the traced window over its frames, and
no reading where the program recorded none."""

import importlib.util
import os
import sys
import types

import pytest

from benchmark import spans
from benchmark.harness import Run

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MS = 1e6


def _read():
    spec = importlib.util.spec_from_file_location(
        "m_renderer_replays_per_frame",
        os.path.join(BENCH, "metrics", "renderer.replays_per_frame.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _run(frames, window=(0.0, 100 * MS)):
    cell = types.SimpleNamespace(config={}, traffic={})
    r = Run(cell, 1, 1.0, 2.0, [1.0] * frames, [10] * frames, {}, [0])
    r.events = []
    r.window_ns = window
    return r


def _program(monkeypatch, host):
    mod = types.SimpleNamespace(recorded_spans=lambda: list(host))
    monkeypatch.setitem(sys.modules, spans.PROFILING, mod)


def test_one_replay_a_frame_reads_one(monkeypatch):
    host = [(i * 25 * MS, i * 25 * MS + 5 * MS, "renderer.replay")
            for i in range(4)]
    host += [(i * 25 * MS + 5 * MS, i * 25 * MS + 20 * MS,
              "renderer.readback") for i in range(4)]
    # the first frame's capture, before the window, is not a replay
    host.append((-50 * MS, -10 * MS, "renderer.capture"))
    _program(monkeypatch, host)
    assert _read()(_run(4)) == pytest.approx(1.0)
    # a replay outside the window does not count
    _program(monkeypatch, host + [(150 * MS, 155 * MS, "renderer.replay")])
    assert _read()(_run(4)) == pytest.approx(1.0)


def test_no_replay_reads_nothing(monkeypatch):
    # the eager loop's spans only
    _program(monkeypatch, [(0, 5 * MS, "renderer.rays"),
                           (5 * MS, 9 * MS, "renderer.cull")])
    assert _read()(_run(2)) is None
    # a program without the recorder, none loaded, an untraced run
    monkeypatch.setitem(sys.modules, spans.PROFILING,
                        types.SimpleNamespace(span=None))
    assert _read()(_run(2)) is None
    monkeypatch.delitem(sys.modules, spans.PROFILING, raising=False)
    assert _read()(_run(2)) is None
    _program(monkeypatch, [(0, 5 * MS, "renderer.replay")])
    assert _read()(_run(2, window=None)) is None
