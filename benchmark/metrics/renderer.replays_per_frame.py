"""renderer.replays_per_frame: the shadow frame's CUDA graph replays per
traced frame, counted from the program's ``renderer.replay`` spans inside
the traced window (1.0 where every frame replays its captured chunk
loop); nothing where no span of that name lies there (the eager loop, or
a program without the graph route)."""

from benchmark.spans import program_spans


def read(run):
    if run.window_ns is None:
        return None
    lo, hi = run.window_ns
    n = sum(1 for s, e, name in program_spans()
            if name == "renderer.replay" and lo <= s and e <= hi)
    return n / run.frames if n else None
