"""OFF (Object File Format) mesh import.

Copy of ``ipu_ray_lib_tpu/scene/off.py`` for the port (no jax).

Part of the assimp-breadth parity set (ref: src/scene_utils.cpp:152-317
— assimp ships an OFF loader). Plain and binary-free: counts line, then
vertices, then polygonal faces (fan-triangulated). No materials or
camera in the format: default diffuse material and origin camera, like
the STL/PLY importers.
"""

from __future__ import annotations

import numpy as np

from ..utils.log import logger
from .types import Camera, HostMesh, Material, SceneDescription


def import_off_scene(filename: str, load_normals: bool = False
                     ) -> SceneDescription:
    log = logger()
    # Line-based parse: OFF vertex and face records are one per line,
    # and both may carry trailing colour/normal values (COFF/NOFF
    # variants, per-face colours) that a flat token stream cannot
    # delimit — per-line parsing takes the leading fields and ignores
    # the rest of each record:
    with open(filename) as fh:
        lines = []
        for raw in fh:
            body = raw.split("#")[0].strip()
            if body:
                lines.append(body)
    if not lines or lines[0].split()[0] not in ("OFF", "COFF", "NOFF",
                                                "CNOFF"):
        raise ValueError(f"'{filename}' is not an OFF file")
    head = lines[0].split()
    li = 1
    if len(head) > 1:       # counts on the keyword line
        counts = head[1:4]
    else:
        counts = lines[li].split()[:3]
        li += 1
    nv, nf = int(counts[0]), int(counts[1])
    verts = np.empty((nv, 3), np.float64)
    for i in range(nv):
        f = lines[li + i].split()
        verts[i] = [float(f[0]), float(f[1]), float(f[2])]
    li += nv
    tris = []
    for i in range(nf):
        f = lines[li + i].split()
        k = int(f[0])
        face = [int(t) for t in f[1:1 + k]]   # trailing colours ignored
        for j in range(1, k - 1):
            tris.append((face[0], face[j], face[j + 1]))
    scene = SceneDescription()
    scene.materials = [Material(np.array([0.75, 0.75, 0.75], np.float32))]
    scene.meshes.append(HostMesh(
        triangles=np.asarray(tris, np.uint32).reshape(-1, 3),
        vertices=verts.astype(np.float32)))
    scene.mat_ids.append(0)
    log.warning("OFF has no camera; assuming origin looking down -z (fov 45)")
    scene.camera = Camera(horizontal_fov=float(np.pi / 4))
    scene.validate()
    log.info("Imported %d tris, %d verts from '%s'", len(tris), nv, filename)
    return scene
