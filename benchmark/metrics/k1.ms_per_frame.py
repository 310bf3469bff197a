"""k1.ms_per_frame: the device time of the path megakernel's launches
(``megakernel``, direct mode) per frame; on several cards, the busiest
card's."""

from benchmark.metrics_lib import kernel_ms_per_frame


def read(run):
    return kernel_ms_per_frame(run, lambda n: "megakernel" in n)
