"""Stanford PLY mesh import (ASCII and binary little/big-endian).

Copy of ``ipu_ray_lib_tpu/scene/ply.py`` for the port (no jax).

Part of narrowing the format gap with the reference's assimp importer
(ref: src/scene_utils.cpp:152-317 — assimp ships a PLY loader). Covers
the subset real PLY files use: a ``vertex`` element with x/y/z (and
optional nx/ny/nz) properties and a ``face`` element with a
``vertex_indices``/``vertex_index`` list property (fan-triangulated).
Other properties (colours, uvs) are parsed and skipped.

PLY carries no materials or camera: geometry gets the default diffuse
material and the OBJ convention of a default camera at the origin
looking down -z (with a warning).
"""

from __future__ import annotations

import numpy as np

from ..utils.log import logger
from .types import Camera, HostMesh, Material, SceneDescription

_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


def _parse_header(fh):
    """Returns (fmt, elements) where elements is a list of
    (name, count, [(prop_name, dtype, list_count_dtype|None)])."""
    magic = fh.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file (missing 'ply' magic)")
    fmt = None
    elements = []
    cur = None
    while True:
        line = fh.readline()
        if not line:
            raise ValueError("unterminated PLY header")
        tok = line.decode("ascii", "replace").split()
        if not tok or tok[0] == "comment":
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            cur = (tok[1], int(tok[2]), [])
            elements.append(cur)
        elif tok[0] == "property":
            if cur is None:
                raise ValueError("property before element in PLY header")
            if tok[1] == "list":
                cur[2].append((tok[4], _TYPES[tok[3]], _TYPES[tok[2]]))
            else:
                cur[2].append((tok[2], _TYPES[tok[1]], None))
        elif tok[0] == "end_header":
            break
    if fmt not in ("ascii", "binary_little_endian", "binary_big_endian"):
        raise ValueError(f"unsupported PLY format '{fmt}'")
    return fmt, elements


def _read_ascii(fh, elements):
    data = {}
    for name, count, props in elements:
        rows = []
        for _ in range(count):
            tok = fh.readline().split()
            vals = {}
            ti = 0
            for pname, dt, list_dt in props:
                if list_dt is None:
                    vals[pname] = float(tok[ti])
                    ti += 1
                else:
                    n = int(tok[ti])
                    ti += 1
                    vals[pname] = [float(x) for x in tok[ti : ti + n]]
                    ti += n
            rows.append(vals)
        data[name] = rows
    return data


def _read_binary(fh, elements, endian):
    data = {}
    for name, count, props in elements:
        fixed = all(ld is None for _, _, ld in props)
        if fixed:
            dt = np.dtype([(p, endian + t) for p, t, _ in props])
            arr = np.frombuffer(fh.read(dt.itemsize * count), dtype=dt,
                                count=count)
            data[name] = arr
        else:
            rows = []
            for _ in range(count):
                vals = {}
                for pname, t, list_dt in props:
                    if list_dt is None:
                        vals[pname] = np.frombuffer(
                            fh.read(np.dtype(t).itemsize),
                            dtype=endian + t)[0]
                    else:
                        n = int(np.frombuffer(
                            fh.read(np.dtype(list_dt).itemsize),
                            dtype=endian + list_dt)[0])
                        vals[pname] = np.frombuffer(
                            fh.read(np.dtype(t).itemsize * n),
                            dtype=endian + t, count=n)
                rows.append(vals)
            data[name] = rows
    return data


def import_ply_scene(filename: str, load_normals: bool = False) -> SceneDescription:
    log = logger()
    with open(filename, "rb") as fh:
        fmt, elements = _parse_header(fh)
        if fmt == "ascii":
            data = _read_ascii(fh, elements)
        else:
            endian = "<" if fmt == "binary_little_endian" else ">"
            data = _read_binary(fh, elements, endian)

    vrows = data.get("vertex")
    frows = data.get("face")
    if vrows is None or frows is None or not len(vrows):
        raise ValueError(f"PLY '{filename}' has no vertex/face elements")

    if isinstance(vrows, np.ndarray):
        verts = np.stack([vrows["x"], vrows["y"], vrows["z"]],
                         axis=-1).astype(np.float32)
        has_n = all(k in vrows.dtype.names for k in ("nx", "ny", "nz"))
        normals = (np.stack([vrows["nx"], vrows["ny"], vrows["nz"]],
                            axis=-1).astype(np.float32)
                   if has_n else np.zeros((0, 3), np.float32))
    else:
        verts = np.asarray([[r["x"], r["y"], r["z"]] for r in vrows],
                           np.float32)
        has_n = vrows and all(k in vrows[0] for k in ("nx", "ny", "nz"))
        normals = (np.asarray([[r["nx"], r["ny"], r["nz"]] for r in vrows],
                              np.float32)
                   if has_n else np.zeros((0, 3), np.float32))

    key = None
    probe = frows[0]
    names = probe.dtype.names if isinstance(frows, np.ndarray) else probe.keys()
    for cand in ("vertex_indices", "vertex_index"):
        if cand in names:
            key = cand
            break
    if key is None:
        raise ValueError(f"PLY '{filename}' face element lacks vertex_indices")
    tris = []
    for r in frows:
        idx = [int(i) for i in r[key]]
        for k in range(1, len(idx) - 1):      # fan triangulation
            tris.append((idx[0], idx[k], idx[k + 1]))
    if not tris:
        raise ValueError(f"PLY '{filename}' contains no triangles")

    scene = SceneDescription()
    scene.materials = [Material(np.array([0.75, 0.75, 0.75], np.float32))]
    scene.meshes.append(HostMesh(
        triangles=np.asarray(tris, np.uint32),
        vertices=verts,
        normals=normals if load_normals else np.zeros((0, 3), np.float32),
    ))
    scene.mat_ids.append(0)
    log.warning("PLY has no camera; assuming origin looking down -z (fov 45)")
    scene.camera = Camera(horizontal_fov=float(np.pi / 4))
    scene.validate()
    log.info("Imported %d tris, %d verts from '%s' (%s)",
             len(tris), len(verts), filename, fmt)
    return scene
