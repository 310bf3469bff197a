"""The card's idle time under the program's own host spans (``span()`` in
``ipu_ray_lib_tpu_torch/utils/profiling.py``: ``streaming.*``,
``renderer.*``, ``mesh.*``), on plain interval lists, so that the tests
and ``chip_smoke.py`` can call it.

The program keeps the spans it closed under the run's profiler
(``profiling.recorded_spans()``, epoch ns, the clock on which kineto puts
the device events), so a stretch in which a card runs nothing and which
a span of the host covers is time the card waited on that phase of the
host's work. Nested and overlapping spans count once. A program that
records no spans gives no reading.
"""

from __future__ import annotations

import sys

from . import stats

PROFILING = "ipu_ray_lib_tpu_torch.utils.profiling"


def program_spans() -> list:
    """The spans [(start, end, name)] the loaded program recorded; [] where
    it records none (it is not loaded, or has no ``recorded_spans``)."""
    read = getattr(sys.modules.get(PROFILING), "recorded_spans", None)
    return list(read()) if callable(read) else []


def idle_under(cards, host, lo: float, hi: float, prefixes):
    """The time of [lo, hi] in which a card runs nothing and a host span
    [(start, end, name)] whose name starts with one of ``prefixes`` runs,
    the mean over the cards (``cards``: each card's device (start, end)
    intervals); None when no such span lies in the window."""
    under = [(s, e) for s, e, name in host if name.startswith(tuple(prefixes))]
    if not cards or stats.union(under, lo, hi) <= 0:
        return None
    # what is neither busy nor outside the spans is idle under them
    outside = stats.gaps(under, lo, hi)
    return sum(hi - lo - stats.union(list(ev) + outside, lo, hi)
               for ev in cards) / len(cards)


def idle_ms_per_frame(run, prefixes):
    """:func:`idle_under` of a traced run's window in ms per frame (the
    profiler's clock is in ns), under the program's spans; None without
    a trace or a matching span."""
    if run.events is None or run.window_ns is None:
        return None
    host = program_spans()
    lo, hi = run.window_ns
    cards = [[(e.start, e.end) for e in run.device_events(d)]
             for d in run.devices]
    ns = idle_under(cards, host, lo, hi, prefixes)
    return None if ns is None else ns * 1e-6 / run.frames
