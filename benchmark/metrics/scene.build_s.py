"""scene.build_s: the benchmark's host span around the scene build
(scene description, tables, BVH; the NIF load where the cell has one)."""


def read(run):
    return run.spans.get("scene.build_s")
