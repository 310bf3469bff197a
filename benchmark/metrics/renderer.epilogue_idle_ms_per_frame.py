"""renderer.epilogue_idle_ms_per_frame (ms): the card's idle time per
shadow frame under the shading after K4 (``renderer.epilogue``)."""

from benchmark.spans import idle_ms_per_frame


def read(run):
    return idle_ms_per_frame(run, ("renderer.epilogue",))
