"""streaming.idle_ms_per_frame (ms): the card's idle time per frame
under the streaming driver's spans (``streaming.*``: the upload, each
batch and its env glue, the readback, the NumPy scatter)."""

from benchmark.spans import idle_ms_per_frame


def read(run):
    return idle_ms_per_frame(run, ("streaming.",))
