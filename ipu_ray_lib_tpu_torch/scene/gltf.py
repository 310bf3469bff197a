"""Minimal glTF-binary (.glb) mesh loader.

Replaces the reference's assimp import path for GLB assets
(ref: src/scene_utils.cpp:106-151 ``importMesh``): reads meshes with
pre-transformed vertices (node hierarchy flattened, like assimp's
``aiProcess_PreTransformVertices``). Pure numpy, no external deps.
"""

from __future__ import annotations

import json
import struct

import numpy as np

from .types import HostMesh

_COMPONENT_DTYPES = {
    5120: np.int8,
    5121: np.uint8,
    5122: np.int16,
    5123: np.uint16,
    5125: np.uint32,
    5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4, "MAT4": 16}


def _parse_glb(path: str):
    with open(path, "rb") as f:
        data = f.read()
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:
        raise ValueError(f"Not a GLB file: {path}")
    offset = 12
    gltf = None
    binary = b""
    while offset < len(data):
        clen, ctype = struct.unpack_from("<II", data, offset)
        offset += 8
        chunk = data[offset : offset + clen]
        offset += clen
        if ctype == 0x4E4F534A:  # 'JSON'
            gltf = json.loads(chunk)
        elif ctype == 0x004E4942:  # 'BIN'
            binary = chunk
    if gltf is None:
        raise ValueError("GLB missing JSON chunk")
    return gltf, binary


def _read_accessor(gltf, binary: bytes, idx: int) -> np.ndarray:
    acc = gltf["accessors"][idx]
    view = gltf["bufferViews"][acc["bufferView"]]
    dtype = _COMPONENT_DTYPES[acc["componentType"]]
    ncomp = _TYPE_COUNTS[acc["type"]]
    count = acc["count"]
    start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
    stride = view.get("byteStride")
    itemsize = np.dtype(dtype).itemsize * ncomp
    if stride is None or stride == itemsize:
        arr = np.frombuffer(binary, dtype=dtype, count=count * ncomp, offset=start)
        return arr.reshape(count, ncomp)
    # Strided: gather row by row.
    out = np.empty((count, ncomp), dtype=dtype)
    for i in range(count):
        out[i] = np.frombuffer(binary, dtype=dtype, count=ncomp, offset=start + i * stride)
    return out


def _node_matrix(node) -> np.ndarray:
    if "matrix" in node:
        return np.array(node["matrix"], np.float32).reshape(4, 4).T  # column-major in file
    m = np.eye(4, dtype=np.float32)
    if "scale" in node:
        m = m @ np.diag(np.array(list(node["scale"]) + [1.0], np.float32))
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.array(
            [
                [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w), 0],
                [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w), 0],
                [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y), 0],
                [0, 0, 0, 1],
            ],
            np.float32,
        )
        m = r @ m
    if "translation" in node:
        t = np.eye(4, dtype=np.float32)
        t[:3, 3] = node["translation"]
        m = t @ m
    return m


def load_glb_meshes(path: str, load_normals: bool = False) -> list[HostMesh]:
    """Load all mesh instances, vertices pre-transformed into scene space."""
    gltf, binary = _parse_glb(path)
    meshes: list[HostMesh] = []

    def visit(node_idx: int, parent: np.ndarray):
        node = gltf["nodes"][node_idx]
        world = parent @ _node_matrix(node)
        if "mesh" in node:
            gmesh = gltf["meshes"][node["mesh"]]
            for prim in gmesh["primitives"]:
                if prim.get("mode", 4) != 4:  # triangles only
                    continue
                pos = _read_accessor(gltf, binary, prim["attributes"]["POSITION"]).astype(np.float32)
                pos_h = np.concatenate([pos, np.ones((len(pos), 1), np.float32)], axis=1)
                pos = (pos_h @ world.T)[:, :3]
                if "indices" in prim:
                    idx = _read_accessor(gltf, binary, prim["indices"]).astype(np.uint32).reshape(-1, 3)
                else:
                    idx = np.arange(len(pos), dtype=np.uint32).reshape(-1, 3)
                normals = np.zeros((0, 3), np.float32)
                if load_normals and "NORMAL" in prim["attributes"]:
                    nrm = _read_accessor(gltf, binary, prim["attributes"]["NORMAL"]).astype(np.float32)
                    # Inverse-transpose rotation for normals:
                    it = np.linalg.inv(world[:3, :3]).T
                    nrm = nrm @ it.T
                    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-20)
                    normals = nrm
                meshes.append(HostMesh(triangles=idx, vertices=pos, normals=normals))
        for child in node.get("children", []):
            visit(child, world)

    scene_idx = gltf.get("scene", 0)
    roots = gltf["scenes"][scene_idx]["nodes"]
    for r in roots:
        visit(r, np.eye(4, dtype=np.float32))
    return meshes
