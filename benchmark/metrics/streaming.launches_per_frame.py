"""streaming.launches_per_frame: kernels, copies and memsets on the cards
per frame of the streaming driver, counted from the profiler over the
traced window (summed over the cards)."""

from benchmark.metrics_lib import launches_per_frame as read  # noqa: F401
