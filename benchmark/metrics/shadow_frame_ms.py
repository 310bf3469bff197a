"""shadow_frame_ms: the window's wall time over the shadow frames it
completed, every AOV on the host (host clock)."""


def read(run):
    return 1e3 * run.window_s / run.frames
