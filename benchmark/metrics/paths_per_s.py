"""paths_per_s (Mpaths/s): every path sample of every frame completed in
the window over the window's wall time (host clock; a frame ends with its
image on the host)."""

from benchmark import stats


def read(run):
    return stats.rate(sum(run.work), run.window_s) * 1e-6
