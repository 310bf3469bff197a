"""The benchmark's grid512 configuration (a 522,242-triangle heightfield
in HBM mode) on the port's normal path, against the benchmark's plain
reference, on the CPU.

* The reference's copy of the scene (``benchmark/configs/grid512_mesh.py``
  and the configuration's ``scene``) equals what the port receives
  (``benchmark/scenes/grid512.py``): vertices and triangles bit for bit,
  the disc, the materials, ``mat_ids`` and the field of view. Both are
  the port's ``make_stress_scene`` with each triangle's last two corners
  exchanged, so every face points up, to the light.
* ``"auto"`` sends the configuration to HBM mode (K3 on a card).
* ``render_streaming`` through the plain HBM walk (K3's plain version)
  gives the reference's pixels: the heightfield at grid 24 forced into
  HBM mode on every pixel of a 16 x 16 spp 8 frame, and the whole
  grid-512 field on an 8 x 8 spp 2 frame. The rows lie in the scene
  BVH's leaf order in the port and in scene order in the reference, so a
  tie in t between two rows could resolve differently; none occurs in
  these frames, and they agree exactly.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import scene as RS
from benchmark.scenes import grid512 as system_scene
from ipu_ray_lib_tpu_torch.scene.build import resolve_intersector
from ipu_ray_lib_tpu_torch.scene.builtin import make_stress_scene

ROOT = harness.ROOT
CELL = "grid512.path-1440-spp64"
CPU = torch.device("cpu")
with open(os.path.join(ROOT, "benchmark", "configs", "grid512.json")) as f:
    CFG = json.load(f)


def _reference_mesh():
    spec = importlib.util.spec_from_file_location(
        "grid512_mesh", os.path.join(ROOT, CFG["scene"]["meshes"][0]["module"]))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("grid", [24, 64, 512])
def test_reference_mesh_is_the_systems(grid):
    tris, verts = _reference_mesh().heightfield(grid)
    mesh = system_scene.make(grid).meshes[0]
    gen = make_stress_scene(grid).meshes[0]
    assert tris.dtype == mesh.triangles.dtype == np.uint32
    assert verts.dtype == mesh.vertices.dtype == np.float32
    assert tris.tobytes() == mesh.triangles.tobytes()
    assert verts.tobytes() == mesh.vertices.tobytes() == gen.vertices.tobytes()
    assert np.array_equal(tris, gen.triangles[:, [0, 2, 1]])
    assert len(tris) == 2 * (grid - 1) ** 2
    v = verts[tris.astype(np.int64)]
    up = np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0])[:, 1]
    assert (up > 0).all()


def test_reference_scene_is_the_systems():
    desc = system_scene.make(CFG["program"]["args"][0])
    sc = RS.load(CFG["scene"], ROOT)
    m = desc.meshes[0]
    assert sc.tri_v.tobytes() == m.vertices[m.triangles.astype(np.int64)].tobytes()
    assert len(sc.tri_v) == 522_242 and not m.has_normals
    assert np.array_equal(sc.discs, desc.discs) and len(sc.spheres) == 0
    assert list(sc.mat_ids) == list(desc.mat_ids) == [0, 1]
    assert sc.fov == desc.camera.horizontal_fov
    for k, mat in enumerate(desc.materials):
        assert np.array_equal(sc.mat_albedo[k], mat.albedo)
        assert np.array_equal(sc.mat_emission[k], mat.emission)
        assert sc.mat_type[k] == int(mat.type)
        assert sc.mat_ior[k] == np.float32(mat.ior)


def test_auto_picks_hbm_mode():
    desc = system_scene.make(CFG["program"]["args"][0])
    n = sum(len(m.triangles) for m in desc.meshes)
    n += len(desc.spheres) + len(desc.discs)
    assert CFG["intersector"] == "auto"
    assert resolve_intersector("auto", n) == "pallas-hbm"


def _cell(grid, w, spp, intersector):
    scene = json.loads(json.dumps(CFG["scene"]))
    scene["meshes"][0]["grid"] = grid
    prog = dict(CFG["program"], args=[grid])
    return harness.Cell(CELL, overrides={
        "config": {"image_width": w, "image_height": w,
                   "samples_per_pixel": spp, "intersector": intersector,
                   "program": prog, "scene": scene},
        "traffic": {"check_pixels": w * w, "chunk": 256}})


@pytest.mark.parametrize("grid,w,spp,intersector", [
    (24, 16, 8, "pallas-hbm"), (512, 8, 2, "auto")])
def test_hbm_route_equals_reference(grid, w, spp, intersector):
    cell = _cell(grid, w, spp, intersector)
    prog = cell.mode.Program(cell, 11, [CPU], {})
    assert prog.params.intersector == "pallas-hbm"
    frames = [prog.frame(0)]
    assert all(f.ok for f in frames)
    want = cell.mode.reference(cell, 11, 1, CPU)
    assert cell.mode.compare([f.sample for f in frames], want) == {
        "pixel_rel_l1": 0.0}
    lit = np.concatenate(want).max(axis=1) > 0
    assert lit.mean() > 0.15
