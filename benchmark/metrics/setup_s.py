"""setup_s: from the process's start to the first timed frame (imports,
the card's context, the kernel library, the scene build, the warm-up
frame), host clock."""


def read(run):
    return run.setup_s
