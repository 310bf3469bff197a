"""k1.ms_per_frame.x4: K1's device time per sharded frame on the busiest
card, which sets the frame's time."""

from benchmark.metrics_lib import kernel_ms_per_frame


def read(run):
    return kernel_ms_per_frame(run, lambda n: "megakernel" in n)
