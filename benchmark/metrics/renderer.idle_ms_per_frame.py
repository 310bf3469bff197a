"""renderer.idle_ms_per_frame (ms): the card's idle time per shadow frame
under the shadow driver's spans (``renderer.*``: each chunk's rays, cull,
kernel, epilogue and AOV stores, and the frame's readback)."""

from benchmark.spans import idle_ms_per_frame


def read(run):
    return idle_ms_per_frame(run, ("renderer.",))
