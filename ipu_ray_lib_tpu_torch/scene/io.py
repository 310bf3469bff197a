"""Scene-file import with material interpretation heuristics.

Copy of ``ipu_ray_lib_tpu/scene/io.py`` for the port (no jax).

Role of ref src/scene_utils.cpp:152-317 ``importScene`` (assimp): load a
full scene (meshes + camera + materials) and interpret materials with the
same heuristics:

* diffuse colour -> albedo; emissive colour -> emission;
* for emissive materials, shininess acts as an emission factor;
* transparency (or a material name containing "glass") -> Refractive;
* reflectivity > 0 -> Specular;
* index of refraction read when present.

Scenes are transformed into camera space (camera at origin looking down
-z) at import, exactly as the reference does, so all renderers can use
the fixed pinhole camera.

Formats: .glb/.gltf natively; .dae (Collada) via
:mod:`ipu_ray_lib_tpu_torch.scene.collada`; .obj/.mtl via
:mod:`ipu_ray_lib_tpu_torch.scene.obj`.
"""

from __future__ import annotations

import numpy as np

from ..utils.log import logger
from .types import Camera, HostMesh, Material, MaterialType, SceneDescription


def import_scene(filename: str, load_normals: bool = False) -> SceneDescription:
    fn = filename.lower()
    if fn.endswith(".glb") or fn.endswith(".gltf"):
        return _import_gltf_scene(filename, load_normals)
    if fn.endswith(".dae"):
        from .collada import import_collada_scene

        return import_collada_scene(filename, load_normals)
    if fn.endswith(".obj"):
        from .obj import import_obj_scene

        return import_obj_scene(filename, load_normals)
    if fn.endswith(".ply"):
        from .ply import import_ply_scene

        return import_ply_scene(filename, load_normals)
    if fn.endswith(".stl"):
        from .stl import import_stl_scene

        return import_stl_scene(filename, load_normals)
    if fn.endswith(".fbx"):
        from .fbx import import_fbx_scene

        return import_fbx_scene(filename, load_normals)
    if fn.endswith(".off"):
        from .off import import_off_scene

        return import_off_scene(filename, load_normals)
    raise ValueError(
        f"Unsupported scene format: '{filename}' "
        f"(.glb/.gltf/.dae/.obj/.ply/.stl/.fbx/.off supported)"
    )


def _to_camera_space(scene: SceneDescription, cam_world: np.ndarray) -> None:
    """Transform all geometry by inverse(camera world matrix): camera ends up
    at the origin looking down -z (glTF/Blender camera convention)."""
    world_to_cam = np.linalg.inv(cam_world).astype(np.float32)
    rot = world_to_cam[:3, :3]
    # Normal transform: inverse-transpose of the rotation part.
    nrot = np.linalg.inv(rot).T

    def tfv(v):
        return v @ rot.T + world_to_cam[:3, 3]

    def tfn(n):
        n = n @ nrot.T
        return n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-20)

    for m in scene.meshes:
        m.transform(tfv, tfn)


def interpret_material(
    name: str,
    diffuse=None,
    emissive=None,
    shininess=None,
    transparency=None,
    reflectivity=None,
    ior=None,
) -> Material:
    """Apply the reference's material interpretation rules to raw fields."""
    log = logger()
    mat = Material()
    if diffuse is not None:
        mat.albedo = np.asarray(diffuse[:3], np.float32)
    if emissive is not None:
        mat.emission = np.asarray(emissive[:3], np.float32)
    if ior is not None and ior > 0:
        mat.ior = float(ior)
    if mat.emissive and shininess is not None:
        mat.emission = mat.emission * np.float32(shininess)
        log.warning("Material '%s': shininess (%s) used as emission factor", name, shininess)
    if transparency is not None and transparency > 0.0:
        mat.type = MaterialType.REFRACTIVE
        log.debug("Material '%s' interpreted as DIELECTRIC", name)
    if "glass" in name.lower():
        mat.type = MaterialType.REFRACTIVE
        log.debug("Material '%s' interpreted as DIELECTRIC (name)", name)
    if reflectivity is not None and reflectivity > 0.0:
        mat.type = MaterialType.SPECULAR
        log.debug("Material '%s' interpreted as SPECULAR", name)
    return mat


def _import_gltf_scene(filename: str, load_normals: bool) -> SceneDescription:
    """Full glTF scene import: meshes + materials + first camera."""
    from .gltf import _node_matrix, _parse_glb, _read_accessor

    log = logger()
    gltf, binary = _parse_glb(filename)
    scene = SceneDescription()

    # Materials (PBR metallic-roughness mapped through the heuristics):
    materials = []
    for gm in gltf.get("materials", []):
        pbr = gm.get("pbrMetallicRoughness", {})
        base = pbr.get("baseColorFactor", [1, 1, 1, 1])
        emissive = gm.get("emissiveFactor", [0, 0, 0])
        strength = (
            gm.get("extensions", {})
            .get("KHR_materials_emissive_strength", {})
            .get("emissiveStrength")
        )
        transmission = (
            gm.get("extensions", {})
            .get("KHR_materials_transmission", {})
            .get("transmissionFactor")
        )
        ior = gm.get("extensions", {}).get("KHR_materials_ior", {}).get("ior")
        metallic = pbr.get("metallicFactor", 1.0)
        roughness = pbr.get("roughnessFactor", 1.0)
        reflectivity = metallic if (metallic > 0 and roughness < 0.25) else 0.0
        materials.append(
            interpret_material(
                gm.get("name", ""),
                diffuse=base,
                emissive=emissive,
                shininess=strength,
                transparency=transmission,
                reflectivity=reflectivity,
                ior=ior,
            )
        )
    if not materials:
        materials = [Material(np.array([0.75, 0.75, 0.75], np.float32))]

    cam_world = None
    cam_fov = float(np.pi / 4)

    def visit(node_idx: int, parent: np.ndarray):
        nonlocal cam_world, cam_fov
        node = gltf["nodes"][node_idx]
        world = parent @ _node_matrix(node)
        if "camera" in node and cam_world is None:
            cam = gltf["cameras"][node["camera"]]
            if cam.get("type") == "perspective":
                cam_world = world
                cam_fov = float(cam["perspective"].get("yfov", cam_fov))
        if "mesh" in node:
            gmesh = gltf["meshes"][node["mesh"]]
            for prim in gmesh["primitives"]:
                if prim.get("mode", 4) != 4:
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
                    it = np.linalg.inv(world[:3, :3]).T
                    nrm = nrm @ it.T
                    nrm /= np.maximum(np.linalg.norm(nrm, axis=1, keepdims=True), 1e-20)
                    normals = nrm
                scene.meshes.append(HostMesh(triangles=idx, vertices=pos, normals=normals))
                scene.mat_ids.append(int(prim.get("material", 0)))

    roots = gltf["scenes"][gltf.get("scene", 0)]["nodes"]
    for r in roots:
        visit(r, np.eye(4, dtype=np.float32))

    scene.materials = materials
    if cam_world is None:
        log.error("Scene must contain at least one camera")
        raise RuntimeError("No camera found in scene file.")
    _to_camera_space(scene, cam_world)
    scene.camera = Camera(horizontal_fov=cam_fov)
    scene.validate()
    log.info("Imported %d meshes, %d materials from '%s'",
             len(scene.meshes), len(scene.materials), filename)
    return scene
