"""k6.ms_per_frame: the device time of the HBM-mode closest-hit kernel's
launches (kernel K6: ``chunk_kernel``, a wave of its bundles' super
lists, and ``fold_kernel``, which folds the wave in walk order; the
camera query and the occlusion query of every chunk) per frame. K5's
``bundle_kernel`` is not K6. A run that launched no K6 gives no reading."""

from benchmark.metrics.k6_roofline import is_k6
from benchmark.metrics_lib import kernel_ms_per_frame


def read(run):
    return kernel_ms_per_frame(run, is_k6)
