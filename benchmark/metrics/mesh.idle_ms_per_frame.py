"""mesh.idle_ms_per_frame (ms): each card's idle time per sharded frame
under the mesh's spans (``mesh.*``: the shard plan and replicas, the
dispatch over the cards, the gather, the assembly), the mean over the
cards."""

from benchmark.spans import idle_ms_per_frame


def read(run):
    return idle_ms_per_frame(run, ("mesh.",))
