"""device.idle_pct.shadow (%): device.idle_pct.path's share in the
shadow cells."""

from benchmark.metrics_lib import idle_pct as read  # noqa: F401
