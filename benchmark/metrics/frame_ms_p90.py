"""frame_ms_p90: the 90th percentile of every frame's wall time in the
window, from its call to its result on the host (host clock)."""

from benchmark import stats


def read(run):
    return 1e3 * stats.percentile(run.frame_s, 90)
