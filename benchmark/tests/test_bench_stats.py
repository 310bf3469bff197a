"""The benchmark's arithmetic on made-up inputs: a rate over the whole
window, a tail over every frame, busy and idle time over the whole
window, and the metric readers over a made-up trace."""

import types

import pytest

from benchmark import stats
from benchmark.harness import DeviceEvent, Run
from benchmark import metrics_lib


def test_rate_counts_all_work_over_all_time():
    # three frames of 10 paths in a 4 s window: 7.5/s, not the mean of
    # per-frame rates
    assert stats.rate(30, 4.0) == 7.5
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


def test_percentile_takes_every_frame():
    vals = list(range(1, 101))            # 1..100
    assert stats.percentile(vals, 90) == pytest.approx(90.1)
    assert stats.percentile([5.0], 90) == 5.0
    # one stall among 99 fast frames moves p99, not p50
    v = [1.0] * 99 + [50.0]
    assert stats.percentile(v, 50) == 1.0
    assert stats.percentile(v, 99.5) > 1.0


def test_union_gaps_and_idle_over_the_whole_window():
    ev = [(1, 3), (2, 4), (6, 7), (9, 12)]
    # window [0, 10]: busy 3 + 1 + 1 = 5 (the last event clipped)
    assert stats.union(ev, 0, 10) == 5
    assert stats.gaps(ev, 0, 10) == [(0, 1), (4, 6), (7, 9)]
    assert stats.idle_pct(ev, 0, 10) == pytest.approx(50.0)
    # the gaps before the first and after the last event count
    assert stats.idle_pct([(4, 6)], 0, 10) == pytest.approx(80.0)


def test_rel_l1():
    assert stats.rel_l1([1.0, 2.0], [1.0, 2.0]) == 0.0
    assert stats.rel_l1([1.5, 2.0], [1.0, 2.0]) == pytest.approx(0.5 / 3)


def _run(events, frames=2, devices=(0,)):
    cell = types.SimpleNamespace(config={}, traffic={})
    r = Run(cell, 1, 1.0, 2.0, [1.0] * frames, [10] * frames, {},
            list(devices))
    r.events = events
    r.window_ns = (0.0, 100e6)
    return r


def test_readers_on_a_made_up_trace():
    ev = [DeviceEvent("void megakernel(Params)", 0, 10e6, 50e6),
          DeviceEvent("Memcpy DtoH", 0, 50e6, 60e6),
          DeviceEvent("void megakernel(Params)", 1, 0e6, 30e6)]
    r = _run(ev, frames=2, devices=(0, 1))
    assert metrics_lib.launches_per_frame(r) == 1.5
    # card 0 busy 50 of 100 ms, card 1 30: idle 50% and 70%, mean 60%
    assert metrics_lib.idle_pct(r) == pytest.approx(60.0)
    # the busiest card's K1 time per frame: 40 ms over 2 frames
    assert metrics_lib.kernel_ms_per_frame(
        r, lambda n: "megakernel" in n) == pytest.approx(20.0)
    assert metrics_lib.kernel_ms_per_frame(r, lambda n: "nope" in n) is None


def test_readers_find_nothing_without_a_trace():
    r = _run(None)
    assert metrics_lib.idle_pct(r) is None
    assert metrics_lib.launches_per_frame(r) is None
