"""device.idle_pct.path (%): the share of the traced window, from the
first frame's call to the last frame's result, in which no kernel, copy
or memset runs on a card; the mean over the cards."""

from benchmark.metrics_lib import idle_pct as read  # noqa: F401
