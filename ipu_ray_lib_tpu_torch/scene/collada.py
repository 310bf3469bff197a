"""Minimal Collada (.dae) scene importer (Blender-export subset).

Copy of ``ipu_ray_lib_tpu/scene/collada.py`` for the port (no jax).

Replaces the assimp import path of the reference for its .dae test scenes
(ref: src/scene_utils.cpp:152-317): reads cameras (xfov + node matrix),
effects/materials (lambert/phong: emission, diffuse, shininess,
transparency, reflectivity, index of refraction), triangle geometry with
per-node transforms, and applies the same material-interpretation
heuristics via :func:`ipu_ray_lib_tpu_torch.scene.io.interpret_material`.
Scenes come out in camera space (camera at origin looking down -z).
"""

from __future__ import annotations

import re
import xml.etree.ElementTree as ET

import numpy as np

from ..utils.log import logger
from .types import Camera, HostMesh, SceneDescription


def _ns_of(root) -> str:
    m = re.match(r"\{(.*)\}", root.tag)
    return m.group(1) if m else ""


def _parse_floats(text: str) -> np.ndarray:
    return np.array(text.split(), dtype=np.float32)


def _color_of(el, ns, name):
    node = el.find(f".//{{{ns}}}{name}/{{{ns}}}color")
    if node is not None:
        return _parse_floats(node.text)[:3]
    return None


def _float_of(el, ns, name):
    node = el.find(f".//{{{ns}}}{name}/{{{ns}}}float")
    if node is not None:
        return float(node.text)
    return None


def import_collada_scene(filename: str, load_normals: bool = False) -> SceneDescription:
    from .io import interpret_material, _to_camera_space

    log = logger()
    tree = ET.parse(filename)
    root = tree.getroot()
    ns = _ns_of(root)

    def q(tag):
        return f"{{{ns}}}{tag}"

    # ---- Effects / materials --------------------------------------------
    effects = {}
    for eff in root.iter(q("effect")):
        effects[eff.get("id")] = {
            "diffuse": _color_of(eff, ns, "diffuse"),
            "emission": _color_of(eff, ns, "emission"),
            "shininess": _float_of(eff, ns, "shininess"),
            "transparency": _float_of(eff, ns, "transparency"),
            "reflectivity": _float_of(eff, ns, "reflectivity"),
            "ior": _float_of(eff, ns, "index_of_refraction"),
        }

    materials = []  # list of Material
    mat_index = {}  # material id -> index
    for mat in root.iter(q("material")):
        inst = mat.find(q("instance_effect"))
        eff_id = inst.get("url").lstrip("#") if inst is not None else None
        fields = effects.get(eff_id, {})
        name = mat.get("name") or mat.get("id") or ""
        m = interpret_material(
            name,
            diffuse=fields.get("diffuse"),
            emissive=fields.get("emission"),
            shininess=fields.get("shininess"),
            transparency=fields.get("transparency"),
            reflectivity=fields.get("reflectivity"),
            ior=fields.get("ior"),
        )
        mat_index[mat.get("id")] = len(materials)
        materials.append(m)
    if not materials:
        from .types import Material

        materials = [Material(np.array([0.75, 0.75, 0.75], np.float32))]

    # ---- Cameras ---------------------------------------------------------
    cam_fovs = {}
    for cam in root.iter(q("camera")):
        xfov = cam.find(f".//{q('xfov')}")
        if xfov is not None:
            cam_fovs[cam.get("id")] = float(np.deg2rad(float(xfov.text)))

    # ---- Geometry library ------------------------------------------------
    geoms = {}
    for geom in root.iter(q("geometry")):
        mesh = geom.find(q("mesh"))
        if mesh is None:
            continue
        sources = {}
        for src in mesh.findall(q("source")):
            arr = src.find(q("float_array"))
            if arr is not None:
                sources[src.get("id")] = _parse_floats(arr.text).reshape(-1, 3) \
                    if int(arr.get("count")) % 3 == 0 else _parse_floats(arr.text)
        vert_src = {}
        for verts in mesh.findall(q("vertices")):
            pos_input = verts.find(q("input"))
            vert_src[verts.get("id")] = pos_input.get("source").lstrip("#")

        prims = []
        for tris in list(mesh.findall(q("triangles"))) + list(mesh.findall(q("polylist"))):
            inputs = tris.findall(q("input"))
            stride = max(int(i.get("offset")) for i in inputs) + 1
            v_off = n_off = None
            pos_id = nrm_id = None
            for i in inputs:
                sem = i.get("semantic")
                if sem == "VERTEX":
                    v_off = int(i.get("offset"))
                    pos_id = vert_src[i.get("source").lstrip("#")]
                elif sem == "NORMAL":
                    n_off = int(i.get("offset"))
                    nrm_id = i.get("source").lstrip("#")
            p = tris.find(q("p"))
            if p is None:
                continue
            idx = np.array(p.text.split(), dtype=np.int64).reshape(-1, stride)
            vcount_el = tris.find(q("vcount"))
            if vcount_el is not None:
                vcount = np.array(vcount_el.text.split(), dtype=np.int64)
                if np.any(vcount != 3):
                    raise ValueError("Only triangulated polylists supported.")
            prims.append((pos_id, nrm_id, idx[:, v_off],
                          idx[:, n_off] if n_off is not None else None))
        geoms[geom.get("id")] = (sources, prims)

    # ---- Visual scene: nodes with transforms -----------------------------
    scene = SceneDescription()
    cam_world = None
    cam_fov = float(np.pi / 4)

    def node_world(node):
        m = node.find(q("matrix"))
        world = np.eye(4, dtype=np.float32)
        if m is not None:
            world = _parse_floats(m.text).reshape(4, 4)  # row-major per spec
        return world

    def visit(node, parent):
        nonlocal cam_world, cam_fov
        world = parent @ node_world(node)
        for ic in node.findall(q("instance_camera")):
            if cam_world is None:
                cam_world = world
                cam_fov = cam_fovs.get(ic.get("url").lstrip("#"), cam_fov)
        for ig in node.findall(q("instance_geometry")):
            gid = ig.get("url").lstrip("#")
            if gid not in geoms:
                continue
            sources, prims = geoms[gid]
            # Material binding: first instance_material target
            mat_idx = 0
            im = ig.find(f".//{q('instance_material')}")
            if im is not None:
                mat_idx = mat_index.get(im.get("target").lstrip("#"), 0)
            for pos_id, nrm_id, vidx, nidx in prims:
                pos = sources[pos_id]
                tris_flat = vidx.reshape(-1, 3)
                pos_h = np.concatenate([pos, np.ones((len(pos), 1), np.float32)], axis=1)
                pos_w = (pos_h @ world.T)[:, :3].astype(np.float32)
                normals = np.zeros((0, 3), np.float32)
                if load_normals and nrm_id is not None and nidx is not None:
                    # Per-corner normals: expand to unshared vertices so
                    # the (vertex, normal) pairing is consistent:
                    corner_pos = pos_w[tris_flat.reshape(-1)]
                    nrm = sources[nrm_id][nidx.reshape(-1)]
                    it = np.linalg.inv(world[:3, :3]).T
                    nrm = (nrm @ it.T).astype(np.float32)
                    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-20)
                    mesh = HostMesh(
                        triangles=np.arange(len(corner_pos), dtype=np.uint32).reshape(-1, 3),
                        vertices=corner_pos,
                        normals=nrm,
                    )
                else:
                    mesh = HostMesh(triangles=tris_flat.astype(np.uint32), vertices=pos_w)
                scene.meshes.append(mesh)
                scene.mat_ids.append(mat_idx)
        for child in node.findall(q("node")):
            visit(child, world)

    for vs in root.iter(q("visual_scene")):
        for node in vs.findall(q("node")):
            visit(node, np.eye(4, dtype=np.float32))

    scene.materials = materials
    if cam_world is None:
        log.error("Scene must contain at least one camera")
        raise RuntimeError("No camera found in scene file.")
    _to_camera_space(scene, cam_world)
    scene.camera = Camera(horizontal_fov=cam_fov)
    scene.validate()
    log.info(
        "Imported %d meshes, %d materials from '%s'",
        len(scene.meshes), len(scene.materials), filename,
    )
    return scene
