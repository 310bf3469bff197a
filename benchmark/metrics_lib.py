"""Readings shared by the metric readers (``benchmark/metrics/``)."""

from __future__ import annotations

import subprocess

from benchmark import stats


def launches_per_frame(run):
    """Device events (kernels, copies, memsets) per frame, every card."""
    if run.events is None:
        return None
    lo, hi = run.window_ns
    n = sum(1 for e in run.events if lo <= e.start and e.end <= hi)
    return n / run.frames


def idle_pct(run):
    """The idle share of the traced window, the mean over the cards."""
    if run.events is None:
        return None
    lo, hi = run.window_ns
    vals = [stats.idle_pct([(e.start, e.end) for e in run.device_events(d)],
                           lo, hi) for d in run.devices]
    return sum(vals) / len(vals)


def kernel_ms_per_frame(run, match):
    """Device ms per frame of the events whose name ``match`` accepts; on
    several cards the busiest card's. None where there are none."""
    if run.events is None:
        return None
    per = [sum(e.end - e.start for e in run.device_events(d)
               if match(e.name)) for d in run.devices]
    return max(per) * 1e-6 / run.frames if max(per) > 0 else None


def card_info() -> str:
    """The first card's name and power limit from nvidia-smi."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not available"
