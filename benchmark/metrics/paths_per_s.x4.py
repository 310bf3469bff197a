"""paths_per_s.x4 (Mpaths/s): paths_per_s of a frame sharded over four
cards; a metric of its own, as the mesh's runs spread wider than one
card's."""

from benchmark.metrics.paths_per_s import read  # noqa: F401
