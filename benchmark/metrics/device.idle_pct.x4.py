"""device.idle_pct.x4 (%): device.idle_pct.path's share in the sharded
cell, the mean over its cards."""

from benchmark.metrics_lib import idle_pct as read  # noqa: F401
