"""The card's idle time under the program's spans on made-up inputs
(``benchmark/spans.py``), the readers at a program that records no
spans, and the profile's events as ``harness._events`` splits them: the
program's spans are host operations with no card-side copy, so the
device-trace readers read what they read without them."""

import importlib.util
import os
import sys
import types

import pytest
from torch.autograd import DeviceType

from benchmark import harness, metrics_lib, spans
from benchmark.harness import DeviceEvent, Run

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MS = 1e6


def _metric(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"),
        os.path.join(BENCH, "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# --- spans.py's arithmetic ---------------------------------------------

def test_spans_match_by_prefix_and_are_clipped_to_the_window():
    cards = [[]]                           # a card that runs nothing
    host = [(0, 5, "streaming.upload"), (5, 20, "aten::mul"),
            (8, 30, "streaming.batch"), (40, 50, "renderer.cull"),
            (60, 70, "streaming.scatter")]
    # [2, 5] and [8, 30] of the window [2, 55]
    assert spans.idle_under(cards, host, 2, 55, ("streaming.",)) == 25
    assert spans.idle_under(cards, host, 0, 100,
                            ("renderer.rays", "renderer.cull")) == 10
    assert spans.idle_under(cards, host, 0, 100, ("mesh.",)) is None


def test_nested_and_overlapping_spans_count_once():
    # a card busy [10, 20] in a window [0, 100]: idle [0, 10] + [20, 100]
    cards = [[(10, 20)]]
    host = [(0, 40, "streaming.batch"), (5, 30, "streaming.env"),
            (35, 60, "streaming.readback")]
    # under the spans' union [0, 60]: 10 + 40 = 50, not the sum of spans
    assert spans.idle_under(cards, host, 0, 100, ("streaming.",)) == 50


def test_a_gap_partly_covered():
    cards = [[(0, 10), (30, 40)]]          # idle [10, 30] and [40, 50]
    host = [(20, 45, "renderer.epilogue")]
    # [20, 30] and [40, 45] of the idle lie under the span
    assert spans.idle_under(cards, host, 0, 50,
                            ("renderer.epilogue",)) == 15
    # the card's busy time under a span is not idle
    assert spans.idle_under([[(0, 50)]], host, 0, 50, ("renderer.",)) == 0


def test_two_cards_averaged():
    host = [(0, 100, "mesh.gather")]
    cards = [[(0, 100)], [(0, 40)]]        # idle 0 and 60
    assert spans.idle_under(cards, host, 0, 100, ("mesh.",)) == 30
    # two cards' idle stretches under two spans with a hole between
    host = [(0, 10, "mesh.gather"), (20, 30, "mesh.assemble")]
    cards = [[(5, 25)], []]                # idle under: 5 + 5, and 20
    assert spans.idle_under(cards, host, 0, 100, ("mesh.",)) == 15


def test_none_without_a_matching_span():
    cards = [[(10, 20)]]
    assert spans.idle_under(cards, [], 0, 100, ("streaming.",)) is None
    assert spans.idle_under(cards, [(0, 5, "aten::mul")], 0, 100,
                            ("streaming.",)) is None
    # a span wholly outside the window matches nothing
    assert spans.idle_under(cards, [(200, 300, "streaming.batch")], 0, 100,
                            ("streaming.",)) is None


def _run(events, frames=2, devices=(0,)):
    cell = types.SimpleNamespace(config={}, traffic={})
    r = Run(cell, 1, 1.0, 2.0, [1.0] * frames, [10] * frames, {},
            list(devices))
    r.events = events
    r.window_ns = (0.0, 100 * MS)
    return r


def _program(monkeypatch, host):
    """A loaded program whose profiling module recorded ``host``."""
    mod = types.SimpleNamespace(recorded_spans=lambda: list(host))
    monkeypatch.setitem(sys.modules, spans.PROFILING, mod)


def test_the_five_readers_on_a_made_up_trace(monkeypatch):
    ev = [DeviceEvent("k", 0, 10 * MS, 50 * MS),
          DeviceEvent("k", 1, 0, 30 * MS)]
    host = [(0, 100 * MS, "streaming.batch"),
            (0, 20 * MS, "renderer.rays"), (20 * MS, 30 * MS, "renderer.cull"),
            (60 * MS, 100 * MS, "renderer.epilogue"),
            (50 * MS, 100 * MS, "mesh.gather")]
    _program(monkeypatch, host)
    r = _run(ev, frames=2, devices=(0, 1))
    # card 0 idle [0, 10] + [50, 100], card 1 [30, 100]: 60 and 70 ms
    assert _metric("streaming.idle_ms_per_frame")(r) == pytest.approx(32.5)
    # under [0, 30]: 10 and 0 ms; under [60, 100]: 40 and 40 ms
    assert _metric("renderer.cull_idle_ms_per_frame")(r) == pytest.approx(2.5)
    assert _metric("renderer.epilogue_idle_ms_per_frame")(r) == \
        pytest.approx(20.0)
    assert _metric("renderer.idle_ms_per_frame")(r) == pytest.approx(22.5)
    assert _metric("mesh.idle_ms_per_frame")(r) == pytest.approx(25.0)


@pytest.mark.parametrize("name", [
    "streaming.idle_ms_per_frame", "renderer.idle_ms_per_frame",
    "renderer.cull_idle_ms_per_frame", "renderer.epilogue_idle_ms_per_frame",
    "mesh.idle_ms_per_frame"])
def test_the_readers_find_nothing_at_a_program_without_spans(
        name, monkeypatch):
    ev = [DeviceEvent("k", 0, 10 * MS, 50 * MS)]
    # the parent: its profiling module has no recorded_spans
    monkeypatch.setitem(sys.modules, spans.PROFILING,
                        types.SimpleNamespace(span=None))
    assert spans.program_spans() == []
    assert _metric(name)(_run(ev)) is None
    # no program loaded at all
    monkeypatch.delitem(sys.modules, spans.PROFILING, raising=False)
    assert _metric(name)(_run(ev)) is None
    # spans of other layers only, and an untraced run
    _program(monkeypatch, [(0, 5 * MS, "other.phase")])
    assert _metric(name)(_run(ev)) is None
    _program(monkeypatch, [(0, 100 * MS, name.split(".")[0] + ".x")])
    assert _metric(name)(_run(None)) is None


# --- harness._events ---------------------------------------------------

class _Ev:
    """A made-up kineto event with the methods ``_events`` reads."""

    def __init__(self, name, cuda, start, end, kind, device=0):
        self._name, self._cuda, self._kind = name, cuda, kind
        self._s, self._e, self._dev = start, end, device

    def name(self):
        return self._name

    def device_type(self):
        return DeviceType.CUDA if self._cuda else DeviceType.CPU

    def device_index(self):
        return self._dev if self._cuda else -1

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._e

    def activity_type(self):
        return self._kind

    def is_user_annotation(self):
        return self._kind in ("user_annotation", "gpu_user_annotation")


def _prof(events):
    results = types.SimpleNamespace(events=lambda: list(events))
    return types.SimpleNamespace(
        profiler=types.SimpleNamespace(kineto_results=results))


# A frame of the parent: the window on the host and its copy on the card,
# host operations, two kernels and a copy.
PARENT = [
    _Ev("benchmark.window", False, 0, 100 * MS, "user_annotation"),
    _Ev("benchmark.window", True, 2 * MS, 95 * MS, "gpu_user_annotation"),
    _Ev("aten::mul", False, 1 * MS, 3 * MS, "cpu_op"),
    _Ev("cudaLaunchKernel", False, 3 * MS, 4 * MS, "cuda_runtime"),
    _Ev("aten::copy_", False, 60 * MS, 90 * MS, "cpu_op"),
    _Ev("void megakernel", True, 4 * MS, 50 * MS, "kernel"),
    _Ev("elementwise", True, 50 * MS, 52 * MS, "kernel"),
    _Ev("Memcpy DtoH", True, 60 * MS, 70 * MS, "gpu_memcpy"),
]
DEVICE = [DeviceEvent("void megakernel", 0, 4 * MS, 50 * MS),
          DeviceEvent("elementwise", 0, 50 * MS, 52 * MS),
          DeviceEvent("Memcpy DtoH", 0, 60 * MS, 70 * MS)]
HOST = [(1 * MS, 3 * MS, "aten::mul"),
        (3 * MS, 4 * MS, "cudaLaunchKernel"),
        (60 * MS, 90 * MS, "aten::copy_")]
# The same frame with the program's spans, as kineto reports them: host
# operations (FUNCTION scope), with no copy on the card's timeline.
SPANS = [
    _Ev("streaming.batch", False, 1 * MS, 52 * MS, "cpu_op"),
    _Ev("streaming.readback", False, 55 * MS, 92 * MS, "cpu_op"),
]


def _readings(events):
    dev, host, window = harness._events(_prof(events))
    r = _run(dev, frames=1)
    r.window_ns = window
    return dev, host, window, (metrics_lib.launches_per_frame(r),
                               metrics_lib.idle_pct(r))


def test_events_of_the_parent_are_as_before():
    dev, host, window, (launches, idle) = _readings(PARENT)
    assert dev == DEVICE and host == HOST and window == (0, 100 * MS)
    # three events; busy 48 + 10 of the window's 100 ms
    assert launches == 3 and idle == pytest.approx(42.0)


def test_the_program_spans_change_no_device_reading():
    dev, host, window, readings = _readings(PARENT + SPANS)
    assert dev == DEVICE and window == (0, 100 * MS)
    assert readings == _readings(PARENT)[3]
    # each span is a host event, sorted among the others (the breakdown's
    # idle labels name the phase)
    assert host == sorted(HOST + [(1 * MS, 52 * MS, "streaming.batch"),
                                  (55 * MS, 92 * MS, "streaming.readback")])
