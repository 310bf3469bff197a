"""STL mesh import (binary and ASCII).

Copy of ``ipu_ray_lib_tpu/scene/stl.py`` for the port (no jax).

Part of narrowing the format gap with the reference's assimp importer
(ref: src/scene_utils.cpp:152-317 — assimp ships an STL loader). STL is
triangle soup: vertices are welded by exact coordinate match so shared
edges exist for the BVH/bounds pipeline. Facet normals are face-constant,
which the renderer reproduces from geometry, so stored normals are
ignored (STL normals are famously unreliable anyway).

STL carries no materials or camera: default diffuse material, default
camera at the origin looking down -z (with a warning).
"""

from __future__ import annotations

import struct

import numpy as np

from ..utils.log import logger
from .types import Camera, HostMesh, Material, SceneDescription


def _read_binary(path: str) -> np.ndarray:
    with open(path, "rb") as fh:
        fh.seek(80)
        (n,) = struct.unpack("<I", fh.read(4))
        raw = np.frombuffer(fh.read(n * 50), dtype=np.uint8, count=n * 50)
    rec = raw.reshape(n, 50)
    f = rec[:, 0:48].copy().view("<f4").reshape(n, 12)
    return f[:, 3:12].reshape(n, 3, 3)        # drop facet normal


def _read_ascii(path: str) -> np.ndarray:
    tris = []
    cur: list = []
    with open(path) as fh:
        for line in fh:
            tok = line.split()
            if not tok:
                continue
            if tok[0] == "vertex":
                cur.append([float(x) for x in tok[1:4]])
            elif tok[0] == "endfacet":
                for k in range(1, len(cur) - 1):
                    tris.append([cur[0], cur[k], cur[k + 1]])
                cur = []
    if not tris:
        raise ValueError(f"ASCII STL '{path}' contains no facets")
    return np.asarray(tris, np.float32)


def import_stl_scene(filename: str, load_normals: bool = False) -> SceneDescription:
    log = logger()
    with open(filename, "rb") as fh:
        head = fh.read(512)
    # 'solid' prefix is necessary but not sufficient for ASCII (some
    # binary exporters write it); require a 'facet' token too:
    is_ascii = head[:5] == b"solid" and b"facet" in head
    corners = _read_ascii(filename) if is_ascii else _read_binary(filename)
    n = len(corners)
    if n == 0:
        raise ValueError(f"STL '{filename}' contains no facets")

    # Weld identical vertices so the mesh shares edges:
    flat = corners.reshape(-1, 3).astype(np.float32)
    uniq, inv = np.unique(flat, axis=0, return_inverse=True)
    tris = inv.reshape(n, 3).astype(np.uint32)

    scene = SceneDescription()
    scene.materials = [Material(np.array([0.75, 0.75, 0.75], np.float32))]
    scene.meshes.append(HostMesh(triangles=tris, vertices=uniq))
    scene.mat_ids.append(0)
    log.warning("STL has no camera; assuming origin looking down -z (fov 45)")
    scene.camera = Camera(horizontal_fov=float(np.pi / 4))
    scene.validate()
    log.info("Imported %d tris (%d welded verts) from '%s' (%s)",
             n, len(uniq), filename, "ascii" if is_ascii else "binary")
    return scene
