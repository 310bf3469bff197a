"""k3.ms_per_frame: the device time of the path megakernel's HBM-mode
launches (``megakernel<true, ...>``, kernel K3) per frame; on several
cards, the busiest card's. A run that launched no K3 (its direct mode,
``megakernel<false, ...>``, is K1) gives no reading."""

from benchmark.metrics_lib import kernel_ms_per_frame


def read(run):
    return kernel_ms_per_frame(run, lambda n: "megakernel<true," in n)
