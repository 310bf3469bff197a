"""mesh.launches_per_frame: kernels, copies (peer copies included) and
memsets per sharded frame, summed over the cards."""

from benchmark.metrics_lib import launches_per_frame as read  # noqa: F401
