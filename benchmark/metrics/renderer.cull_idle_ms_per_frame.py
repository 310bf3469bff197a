"""renderer.cull_idle_ms_per_frame (ms): the card's idle time per shadow
frame under the camera rays and the cull (``renderer.rays``,
``renderer.cull``)."""

from benchmark.spans import idle_ms_per_frame


def read(run):
    return idle_ms_per_frame(run, ("renderer.rays", "renderer.cull"))
