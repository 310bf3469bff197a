"""k4.ms_per_frame: the device time of the fused shadow kernel's launches
(``shadow_kernel``) per frame."""

from benchmark.metrics_lib import kernel_ms_per_frame


def read(run):
    return kernel_ms_per_frame(run, lambda n: "shadow_kernel" in n)
