"""hbm.cull_idle_ms_per_frame (ms): the card's idle time per shadow frame
under the HBM query's host-side cull (``hbm.cull`` in
``ops/intersect_hbm.py``: the rays' padding and the bundle cull against
the super AABBs, before each K6 call). A program that records no such
span gives no reading."""

from benchmark.spans import idle_ms_per_frame


def read(run):
    return idle_ms_per_frame(run, ("hbm.cull",))
