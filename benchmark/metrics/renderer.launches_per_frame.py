"""renderer.launches_per_frame: kernels, copies and memsets on the card per
shadow frame, counted from the profiler over the traced window."""

from benchmark.metrics_lib import launches_per_frame as read  # noqa: F401
