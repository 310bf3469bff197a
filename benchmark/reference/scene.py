"""A scene as the plain reference sees it: the configuration file's
description (quads, spheres, discs, materials, a GLB mesh and its
placement, a mesh made by a file of code beside the configuration
(``"module"``: its ``mesh(entry)`` returns (triangles, vertices)), the
camera transform), turned into flat numpy arrays.

Geometry ids follow the upstream registration order: meshes first, then
spheres, then discs; ``mat_ids`` maps a geometry id to its material.
Every array is built in float32 in the order the published scene code
builds it, so the reference and the system start from the same vertices.
"""

from __future__ import annotations

import importlib.util
import json
import os
import struct
from dataclasses import dataclass

import numpy as np

MAT_TYPES = {"diffuse": 0, "specular": 1, "refractive": 2}

_GLB_DTYPES = {5120: np.int8, 5121: np.uint8, 5122: np.int16,
               5123: np.uint16, 5125: np.uint32, 5126: np.float32}
_GLB_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


@dataclass
class PlainScene:
    tri_v: np.ndarray       # [T, 3, 3] f32 corner positions
    tri_n: np.ndarray       # [T, 3, 3] f32 corner normals (zeros: none)
    tri_has_n: np.ndarray   # [T] bool
    tri_geom: np.ndarray    # [T] i64 geometry id (its mesh)
    tri_prim: np.ndarray    # [T] i64 index within its mesh
    spheres: np.ndarray     # [S, 4] f32 centre, radius
    discs: np.ndarray       # [D, 7] f32 normal, centre, radius
    mat_albedo: np.ndarray  # [M, 3] f32
    mat_emission: np.ndarray
    mat_type: np.ndarray    # [M] i64
    mat_ior: np.ndarray     # [M] f32
    mat_ids: np.ndarray     # [G] i64 geometry id -> material
    fov: float              # horizontal field of view, radians
    num_meshes: int


def _glb_meshes(path: str) -> list[tuple[np.ndarray, np.ndarray]]:
    """Every triangle primitive of a GLB as (triangles [n, 3] u32,
    vertices [m, 3] f32), its node transforms applied (glTF 2.0)."""
    with open(path, "rb") as f:
        data = f.read()
    magic, _, _ = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:
        raise ValueError(f"not a GLB file: {path}")
    off, doc, binary = 12, None, b""
    while off < len(data):
        clen, ctype = struct.unpack_from("<II", data, off)
        chunk = data[off + 8:off + 8 + clen]
        off += 8 + clen
        if ctype == 0x4E4F534A:
            doc = json.loads(chunk)
        elif ctype == 0x004E4942:
            binary = chunk
    if doc is None:
        raise ValueError(f"GLB without a JSON chunk: {path}")

    def accessor(i):
        acc = doc["accessors"][i]
        view = doc["bufferViews"][acc["bufferView"]]
        dt = np.dtype(_GLB_DTYPES[acc["componentType"]])
        nc = _GLB_COUNTS[acc["type"]]
        start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = view.get("byteStride") or dt.itemsize * nc
        rows = [np.frombuffer(binary, dt, nc, start + k * stride)
                for k in range(acc["count"])] if stride != dt.itemsize * nc \
            else [np.frombuffer(binary, dt, acc["count"] * nc, start)]
        return np.concatenate(rows).reshape(acc["count"], nc)

    def node_matrix(node):
        if "matrix" in node:
            return np.array(node["matrix"], np.float32).reshape(4, 4).T
        m = np.eye(4, dtype=np.float32)
        if "scale" in node:
            m = m @ np.diag(np.array(list(node["scale"]) + [1.0], np.float32))
        if "rotation" in node:
            x, y, z, w = node["rotation"]
            r = np.array([
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                 2 * (x * z + y * w), 0],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                 2 * (y * z - x * w), 0],
                [2 * (x * z - y * w), 2 * (y * z + x * w),
                 1 - 2 * (x * x + y * y), 0],
                [0, 0, 0, 1]], np.float32)
            m = r @ m
        if "translation" in node:
            t = np.eye(4, dtype=np.float32)
            t[:3, 3] = node["translation"]
            m = t @ m
        return m

    out = []

    def visit(i, parent):
        node = doc["nodes"][i]
        world = parent @ node_matrix(node)
        for prim in (doc["meshes"][node["mesh"]]["primitives"]
                     if "mesh" in node else []):
            if prim.get("mode", 4) != 4:
                continue
            pos = accessor(prim["attributes"]["POSITION"]).astype(np.float32)
            pos_h = np.concatenate([pos, np.ones((len(pos), 1), np.float32)],
                                   axis=1)
            pos = (pos_h @ world.T)[:, :3]
            idx = (accessor(prim["indices"]).astype(np.uint32).reshape(-1, 3)
                   if "indices" in prim
                   else np.arange(len(pos), dtype=np.uint32).reshape(-1, 3))
            out.append((idx, pos.astype(np.float32)))
        for c in node.get("children", []):
            visit(c, world)

    for r in doc["scenes"][doc.get("scene", 0)]["nodes"]:
        visit(r, np.eye(4, dtype=np.float32))
    return out


def _quads(quads) -> tuple[np.ndarray, np.ndarray]:
    """Quads as two triangles each, (0, 1, 2) and (2, 3, 0)."""
    verts = np.asarray(quads, np.float32).reshape(-1, 3)
    tris = np.concatenate([np.array([[0, 1, 2], [2, 3, 0]], np.uint32) + 4 * q
                           for q in range(len(quads))])
    return tris, verts


def load(desc: dict, root: str) -> PlainScene:
    """The plain scene of a configuration's ``scene`` entry; file paths
    in it are relative to ``root``."""
    meshes = []
    for m in desc["meshes"]:
        if "quads" in m:
            meshes.append(_quads(m["quads"]))
            continue
        if "module" in m:   # a mesh made by code: a file beside the config
            spec = importlib.util.spec_from_file_location(
                "benchmark_mesh", os.path.join(root, m["module"]))
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            meshes.append(mod.mesh(m))
            continue
        place = m["placement"]
        flip = np.array(place["flip"], np.float32)
        shift = np.array(place["translate"], np.float32)
        for tris, verts in _glb_meshes(os.path.join(root, m["glb"])):
            diag = verts.max(axis=0) - verts.min(axis=0)
            scale = np.float32(place["diagonal"]
                               / np.sqrt(np.dot(diag, diag)))
            meshes.append((tris, (verts * flip) * scale + shift))
    spheres = np.asarray(desc.get("spheres", []), np.float32).reshape(-1, 4)
    discs = np.asarray(desc.get("discs", []), np.float32).reshape(-1, 7)
    cam = desc.get("camera_transform")
    if cam is not None:
        pos = np.array(cam["position"], np.float32)
        flip = np.array(cam["flip"], np.float32)
        meshes = [(t, (v - pos) * flip) for t, v in meshes]
        spheres[:, :3] = (spheres[:, :3] - pos) * flip
        discs[:, 3:6] = (discs[:, 3:6] - pos) * flip
        discs[:, 0:3] = discs[:, 0:3] * flip

    tri_v, tri_geom, tri_prim = [], [], []
    for g, (tris, verts) in enumerate(meshes):
        tri_v.append(np.asarray(verts, np.float32)[tris.astype(np.int64)])
        tri_geom.append(np.full(len(tris), g, np.int64))
        tri_prim.append(np.arange(len(tris), dtype=np.int64))
    T = sum(len(t) for t in tri_geom)
    mats = desc["materials"]
    return PlainScene(
        tri_v=(np.concatenate(tri_v) if T else np.zeros((0, 3, 3), np.float32)),
        tri_n=np.zeros((T, 3, 3), np.float32),
        tri_has_n=np.zeros(T, bool),
        tri_geom=(np.concatenate(tri_geom) if T else np.zeros(0, np.int64)),
        tri_prim=(np.concatenate(tri_prim) if T else np.zeros(0, np.int64)),
        spheres=spheres, discs=discs,
        mat_albedo=np.array([m["albedo"] for m in mats], np.float32),
        mat_emission=np.array([m["emission"] for m in mats], np.float32),
        mat_type=np.array([MAT_TYPES[m["type"]] for m in mats], np.int64),
        mat_ior=np.array([m.get("ior", 1.52) for m in mats], np.float32),
        mat_ids=np.asarray(desc["mat_ids"], np.int64),
        fov=float(desc["horizontal_fov"]),
        num_meshes=len(meshes))
