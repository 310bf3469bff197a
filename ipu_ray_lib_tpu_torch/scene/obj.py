"""Wavefront OBJ/MTL scene import.

Copy of ``ipu_ray_lib_tpu/scene/obj.py`` for the port (no jax).

Narrows the format gap with the reference's assimp importer
(ref: src/scene_utils.cpp:152-317) — OBJ is the most common interchange
format after glTF/Collada. Parsing follows the spec subset assimp's OBJ
loader covers: v/vn records, polygonal f records (fan-triangulated),
negative (relative) indices, o/g/usemtl grouping, and .mtl materials
mapped through the same interpretation heuristics as every other format
(scene/io.py interpret_material):

* Kd -> albedo, Ke -> emission, Ns -> emission factor for emissive
  materials, d < 1 (or Tr > 0) -> Refractive, "glass" in the name ->
  Refractive, mirror illumination models (illum 3/5) or Ks near white
  with high Ns -> Specular, Ni -> index of refraction.

OBJ files carry no camera; unlike glTF/Collada import (which error,
matching the reference), a default camera at the origin looking down -z
with a 45-degree FOV is assumed, with a warning — OBJ scenes are
conventionally authored in camera/world space.
"""

from __future__ import annotations

import os

import numpy as np

from ..utils.log import logger
from .types import Camera, HostMesh, Material, SceneDescription


def _parse_mtl(path: str) -> dict[str, Material]:
    from .io import interpret_material

    mats: dict[str, Material] = {}
    cur = None
    fields: dict = {}

    def flush():
        if cur is None:
            return
        ks = fields.get("Ks")
        ns = fields.get("Ns")
        illum = fields.get("illum")
        reflective = 0.0
        if illum in (3, 5):
            reflective = 1.0
        elif ks is not None and ns is not None and min(ks) > 0.8 and ns > 500:
            reflective = 1.0
        transparency = fields.get("Tr", 0.0)
        if fields.get("d") is not None:
            transparency = max(transparency, 1.0 - fields["d"])
        mats[cur] = interpret_material(
            cur,
            diffuse=fields.get("Kd"),
            emissive=fields.get("Ke"),
            shininess=fields.get("Ns") if fields.get("Ke") is not None else None,
            transparency=transparency or None,
            reflectivity=reflective or None,
            ior=fields.get("Ni"),
        )

    with open(path) as fh:
        for line in fh:
            tok = line.split("#", 1)[0].split()
            if not tok:
                continue
            key = tok[0]
            if key == "newmtl":
                flush()
                cur = tok[1] if len(tok) > 1 else ""
                fields = {}
            elif key in ("Kd", "Ke", "Ks"):
                fields[key] = [float(x) for x in tok[1:4]]
            elif key in ("Ns", "Ni", "d", "Tr"):
                fields[key] = float(tok[1])
            elif key == "illum":
                fields[key] = int(tok[1])
    flush()
    return mats


def import_obj_scene(filename: str, load_normals: bool = False) -> SceneDescription:
    log = logger()
    verts: list[list[float]] = []
    norms: list[list[float]] = []
    # faces[mat_name] -> (vertex-index triples, normal-index triples)
    faces: dict[str, list] = {}
    nfaces: dict[str, list] = {}
    mtl: dict[str, Material] = {}
    cur_mat = ""

    def resolve(idx: str, n: int) -> int:
        i = int(idx)
        return i - 1 if i > 0 else n + i

    with open(filename) as fh:
        for line in fh:
            tok = line.split("#", 1)[0].split()
            if not tok:
                continue
            key = tok[0]
            if key == "v":
                verts.append([float(x) for x in tok[1:4]])
            elif key == "vn":
                norms.append([float(x) for x in tok[1:4]])
            elif key == "mtllib":
                mpath = os.path.join(os.path.dirname(filename), " ".join(tok[1:]))
                if os.path.exists(mpath):
                    mtl.update(_parse_mtl(mpath))
                else:
                    log.warning("mtllib '%s' not found", mpath)
            elif key == "usemtl":
                cur_mat = tok[1] if len(tok) > 1 else ""
            elif key == "f":
                vi, ni = [], []
                for ref in tok[1:]:
                    parts = ref.split("/")
                    vi.append(resolve(parts[0], len(verts)))
                    ni.append(
                        resolve(parts[2], len(norms))
                        if len(parts) > 2 and parts[2] else -1
                    )
                fl = faces.setdefault(cur_mat, [])
                nl = nfaces.setdefault(cur_mat, [])
                for k in range(1, len(vi) - 1):      # fan triangulation
                    fl.append((vi[0], vi[k], vi[k + 1]))
                    nl.append((ni[0], ni[k], ni[k + 1]))

    if not verts or not faces:
        raise ValueError(f"OBJ '{filename}' contains no triangles")
    v_all = np.asarray(verts, np.float32)
    n_all = np.asarray(norms, np.float32) if norms else np.zeros((0, 3), np.float32)

    scene = SceneDescription()
    mat_names = list(faces.keys())
    default = Material(np.array([0.75, 0.75, 0.75], np.float32))
    scene.materials = [mtl.get(name, default) for name in mat_names]

    for mi, name in enumerate(mat_names):
        tri = np.asarray(faces[name], np.int64)
        ntri = np.asarray(nfaces[name], np.int64)
        uniq, inv = np.unique(tri.ravel(), return_inverse=True)
        mesh_tris = inv.reshape(-1, 3).astype(np.uint32)
        mesh_verts = v_all[uniq]
        normals = np.zeros((0, 3), np.float32)
        if load_normals and len(n_all) and (ntri >= 0).all():
            # Per-vertex normal via the first face reference of each vertex:
            nidx = np.zeros(len(uniq), np.int64)
            nidx[inv] = ntri.ravel()
            normals = n_all[np.clip(nidx, 0, len(n_all) - 1)]
            normals /= np.maximum(
                np.linalg.norm(normals, axis=1, keepdims=True), 1e-20)
        scene.meshes.append(
            HostMesh(triangles=mesh_tris, vertices=mesh_verts, normals=normals))
        scene.mat_ids.append(mi)

    log.warning("OBJ has no camera; assuming origin looking down -z (fov 45)")
    scene.camera = Camera(horizontal_fov=float(np.pi / 4))
    scene.validate()
    log.info("Imported %d meshes, %d materials from '%s'",
             len(scene.meshes), len(scene.materials), filename)
    return scene
