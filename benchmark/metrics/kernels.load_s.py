"""kernels.load_s: the benchmark's host span around the kernel library's
first load (a hit in the checkout's build cache after the first run)."""


def read(run):
    return run.spans.get("kernels.load_s")
