"""renderer.glue_idle_ms_per_frame (ms): the card's idle time per shadow
frame under the glue route's spans (``renderer.hit``: the closest hit and
its normal; ``renderer.occlusion``: the light ray, its offset origin and
the any-hit query; ``renderer.shade``: the shading). A program whose glue
route records no such span gives no reading."""

from benchmark.spans import idle_ms_per_frame


def read(run):
    return idle_ms_per_frame(run, ("renderer.hit", "renderer.occlusion",
                                   "renderer.shade"))
