"""k7.ms_per_frame: the device time of the threaded-BVH walk's launches
(``bvh_kernel``, kernel K7: a chunk's closest-hit walk and its any-hit
walk) per frame. A run that launched no K7 gives no reading."""

from benchmark.metrics_lib import kernel_ms_per_frame


def read(run):
    return kernel_ms_per_frame(run, lambda n: "bvh_kernel" in n)
