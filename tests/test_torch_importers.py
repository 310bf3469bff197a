"""The port's scene importers against the JAX package's, on the same files.

Every format's ``SceneDescription`` equals the JAX package's bit for bit:
each mesh's triangles, vertices and normals (values and dtypes), the
materials (albedo, emission, type, ior), ``mat_ids``, spheres, discs and
the camera. Files: the in-repo assets (``assets/test_scene.dae``,
``assets/hdri_test.dae``, and ``assets/monkey_bust.glb`` through the
mesh loader), and the synthetic files ``tests/test_utils.py`` writes
(``tests/torch_scene_files.py``): OBJ with its MTL, PLY ASCII and
binary, STL ASCII and binary, OFF, FBX binary 7400/7500 with and without
a camera, FBX ASCII with and without a camera, and the FBX 6.x value
list with and without a camera.

The FBX camera: where the camera's pose depends on a parent Model, a
PreRotation or a RotationOrder (which the JAX importer ignores), the port
raises ``ValueError`` naming it.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import os

import numpy as np
import pytest

import torch_scene_files as files
from ipu_ray_lib_tpu.scene import io as jio
from ipu_ray_lib_tpu.scene.gltf import load_glb_meshes as jax_glb
from ipu_ray_lib_tpu_torch.scene import io as tio
from ipu_ray_lib_tpu_torch.scene.gltf import load_glb_meshes

ROOT = os.path.join(os.path.dirname(__file__), "..")


def assert_same_array(a, b, what):
    assert a.dtype == b.dtype, (what, a.dtype, b.dtype)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a, b, err_msg=what)


def assert_same_scene(t, j):
    assert len(t.meshes) == len(j.meshes)
    for i, (tm, jm) in enumerate(zip(t.meshes, j.meshes)):
        for f in ("triangles", "vertices", "normals"):
            assert_same_array(getattr(tm, f), getattr(jm, f), f"mesh {i} {f}")
    assert len(t.materials) == len(j.materials)
    for i, (tm, jm) in enumerate(zip(t.materials, j.materials)):
        assert_same_array(tm.albedo, jm.albedo, f"material {i} albedo")
        assert_same_array(tm.emission, jm.emission, f"material {i} emission")
        assert int(tm.type) == int(jm.type) and tm.ior == jm.ior, i
    assert list(t.mat_ids) == list(j.mat_ids)
    assert_same_array(t.spheres, j.spheres, "spheres")
    assert_same_array(t.discs, j.discs, "discs")
    assert t.camera.horizontal_fov == j.camera.horizontal_fov
    assert (t.camera.matrix is None) == (j.camera.matrix is None)
    assert t.path_trace == j.path_trace


FILES = {
    "test_scene.dae": lambda d: os.path.join(ROOT, "assets", "test_scene.dae"),
    "hdri_test.dae": lambda d: os.path.join(ROOT, "assets", "hdri_test.dae"),
    "obj+mtl": files.obj_with_mtl,
    "ply-ascii": files.ply_ascii,
    "ply-binary": files.ply_binary,
    "stl-binary": files.stl_binary,
    "stl-ascii": files.stl_ascii,
    "off": files.off,
    "fbx-7400": lambda d: files.fbx_binary(d, 7400),
    "fbx-7500": lambda d: files.fbx_binary(d, 7500),
    "fbx-7400-camera": lambda d: files.fbx_binary(d, 7400, camera=True),
    "fbx-7500-camera": lambda d: files.fbx_binary(d, 7500, camera=True),
    "fbx-ascii": files.fbx_ascii,
    "fbx-ascii-camera": files.fbx_ascii_camera,
    "fbx-v6": files.fbx_v6,
    "fbx-v6-camera": lambda d: files.fbx_v6(d, camera=True),
    # a camera parented to the scene root (id 0) is resolved:
    "fbx-7400-camera-root": lambda d: files.fbx_binary(d, 7400, camera=True,
                                                       cam_parent=0),
}


@pytest.mark.parametrize("load_normals", [False, True])
@pytest.mark.parametrize("name", list(FILES))
def test_import_matches_jax(tmp_path, name, load_normals):
    path = str(FILES[name](tmp_path))
    assert_same_scene(tio.import_scene(path, load_normals=load_normals),
                      jio.import_scene(path, load_normals=load_normals))


@pytest.mark.parametrize("load_normals", [False, True])
def test_glb_mesh_loader_matches_jax(load_normals):
    path = os.path.join(ROOT, "assets", "monkey_bust.glb")
    t, j = load_glb_meshes(path, load_normals), jax_glb(path, load_normals)
    assert len(t) == len(j) > 0
    for tm, jm in zip(t, j):
        for f in ("triangles", "vertices", "normals"):
            assert_same_array(getattr(tm, f), getattr(jm, f), f)


def test_glb_without_camera_raises():
    """A glTF scene import needs a camera; monkey_bust.glb has none."""
    path = os.path.join(ROOT, "assets", "monkey_bust.glb")
    with pytest.raises(RuntimeError, match="No camera"):
        tio.import_scene(path)
    with pytest.raises(RuntimeError, match="No camera"):
        jio.import_scene(path)


def test_unknown_format_raises(tmp_path):
    p = tmp_path / "scene.xyz"
    p.write_text("")
    with pytest.raises(ValueError, match="Unsupported scene format"):
        tio.import_scene(str(p))


CAMERA_FAULTS = {
    "parent": (dict(cam_parent=200), "parent chain"),
    "pre-rotation": (dict(cam_props=[("PreRotation", "Vector3D",
                                      (0.0, 0.0, 90.0))]), "PreRotation"),
    "post-rotation": (dict(cam_props=[("PostRotation", "Vector3D",
                                       (10.0, 0.0, 0.0))]), "PostRotation"),
    "rotation-order": (dict(cam_props=[("RotationOrder", "enum", (2,))]),
                       "RotationOrder"),
}


@pytest.mark.parametrize("version", [7400, 7500])
@pytest.mark.parametrize("fault", list(CAMERA_FAULTS))
def test_fbx_camera_pose_it_cannot_resolve_raises(tmp_path, fault, version):
    """The JAX importer imports these cameras with a wrong pose (it
    ignores the parent chain, PreRotation and RotationOrder:
    ipu_ray_lib_tpu/scene/fbx.py:399-421); the port refuses them."""
    kw, what = CAMERA_FAULTS[fault]
    path = str(files.fbx_binary(tmp_path, version, camera=True, **kw))
    jio.import_scene(path)  # the reference imports it, with a wrong pose
    with pytest.raises(ValueError, match=what):
        tio.import_scene(path)


def test_fbx_zero_pre_rotation_and_xyz_order_are_resolved(tmp_path):
    """A zero PreRotation and RotationOrder 0 (XYZ) change nothing: the
    import equals the JAX package's."""
    path = str(files.fbx_binary(tmp_path, 7400, camera=True, cam_props=[
        ("PreRotation", "Vector3D", (0.0, 0.0, 0.0)),
        ("RotationOrder", "enum", (0,))]))
    assert_same_scene(tio.import_scene(path), jio.import_scene(path))


@pytest.mark.parametrize("form", ["ascii", "v6"])
def test_fbx_text_camera_with_parent_raises(tmp_path, form):
    if form == "ascii":
        path = files.fbx_ascii_camera(tmp_path,
                                      parent_conn='\tC: "OO",400,200\n')
        what = "parent chain"
    else:
        path = files.fbx_v6(tmp_path, camera=True, parent="Model::Quad")
        what = "Model::Quad"
    with pytest.raises(ValueError, match=what):
        tio.import_scene(str(path))


def test_fbx_ascii_rotation_order_raises(tmp_path):
    path = files.fbx_ascii_camera(
        tmp_path, cam_extra='\t\t\tP: "RotationOrder", "enum", "", "",4\n')
    with pytest.raises(ValueError, match="RotationOrder 4"):
        tio.import_scene(str(path))
