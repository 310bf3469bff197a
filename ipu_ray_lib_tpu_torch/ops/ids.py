"""Names and ids that the scene build and the intersectors share.

Kept below both: scene/build.py builds the tables of ``ops/`` and the
walks of ``ops/`` read these, so neither package imports the other for
them.
"""

# The intersectors a scene can be built for (the JAX package's
# ``intersector=``; "auto" resolves to one of them):
INTERSECTORS = ("pallas", "pallas-hbm", "bvh", "dense")
# A geometry's type (the JAX package's scene/build.py GEOM_*):
GEOM_MESH, GEOM_SPHERE, GEOM_DISC = 0, 1, 2
