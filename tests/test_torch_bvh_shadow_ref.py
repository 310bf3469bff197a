"""The shadow trace of a scene built with ``intersector="bvh"`` (the glue
route: K7's plain walk on the CPU, ``hit_normal``, the light ray and the
shading) against the benchmark's plain reference of that route
(``benchmark/reference/shadow_bvh.py``), which finds each hit by brute
force over every primitive and imports nothing of the port.

* Seeded random scenes (meshes of loose triangles and of quads that share
  edges, one with vertex normals, spheres and discs, in front of the
  camera) at 32x32 to 64x64, and the ``cornell-monkey-bvh`` configuration
  at 64x64: every pixel's six AOVs within the ``shadow_bvh`` mode's
  tolerances (rtol 1e-5, atol 1e-6), ids equal. The reference breaks an
  exact tie in t by the lower scene index, the walk by its visit order;
  no tie occurs in these frames.
* Pixels of the configuration's 1440^2 frame where the ray grazes an
  edge: a hit the watertight test accepts just past a triangle's edge,
  outside its box, counts in neither (the walk tests a leaf only inside
  its box, the reference each primitive likewise); and an exact tie in
  t, the one departure, where only the primitive id differs.
* The route's structure: two walks a chunk (the closest hit and the
  any-hit test), and on the card two K7 launches a chunk
  (``ops/bvh.py:launches``), also in a frame replayed as a CUDA graph.
* Under a profiler the glue route of a CPU scene records
  ``renderer.hit``, ``renderer.occlusion`` and ``renderer.shade`` once a
  chunk, between the chunk's rays and its stores; without one it records
  nothing. (On the card the route is kernels: tests/test_torch_bvh_glue.py.)

This file imports no JAX; its card test runs without the conftest::

    python -m pytest --noconftest -p no:cacheprovider -m cuda -s \\
        tests/test_torch_bvh_shadow_ref.py
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import os

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness
from benchmark.modes.shadow_bvh import AOVS, mismatched
from benchmark.reference import scene as RS
from benchmark.reference import shadow_bvh as RB
from ipu_ray_lib_tpu_torch.ops import bvh as TBVH
from ipu_ray_lib_tpu_torch.ops import traversal as TT
from ipu_ray_lib_tpu_torch.render.renderer import render
from ipu_ray_lib_tpu_torch.render.shadow import (DEFAULT_AMBIENT,
                                                 DEFAULT_LIGHT_POS)
from ipu_ray_lib_tpu_torch.scene.build import build_scene
from ipu_ray_lib_tpu_torch.scene.types import (Camera, HostMesh, Material,
                                               SceneDescription)
from ipu_ray_lib_tpu_torch.utils import profiling

CELL = "cornell-monkey-bvh.shadow-1440-bvh"
CPU = torch.device("cpu")
CHUNK = 512
GLUE = ["renderer.hit", "renderer.occlusion", "renderer.shade"]


def random_scene(seed: int):
    """(the port's description, the reference's PlainScene) of one seeded
    scene in camera space: two meshes of 12 loose triangles, a skewed
    3 x 3 grid of quads with shared edges (with vertex normals on odd seeds), two
    spheres and two discs, 30-60 units in front of the camera."""
    rng = np.random.default_rng(seed)
    f32 = np.float32

    def spot(n):
        z = rng.uniform(-60.0, -30.0, n)
        return np.stack([rng.uniform(-0.4, 0.4, n) * -z,
                         rng.uniform(-0.4, 0.4, n) * -z, z], 1).astype(f32)

    meshes = []
    for _ in range(2):
        c = spot(12)
        v = (c[:, None] + rng.normal(0, 4.0, (12, 3, 3))).astype(f32)
        meshes.append(HostMesh(triangles=np.arange(36).reshape(12, 3),
                               vertices=v.reshape(-1, 3)))
    g = np.stack(np.meshgrid(np.arange(4), np.arange(4), indexing="ij"),
                 -1).reshape(-1, 2).astype(f32)
    gv = np.concatenate([g @ rng.uniform(4.0, 7.0, (2, 2)),
                         rng.uniform(-2, 2, (16, 1))], 1)
    gv = (gv + [-10.0, -10.0, -45.0]).astype(f32)
    idx = np.arange(16).reshape(4, 4)
    a, b, c, d = (idx[:-1, :-1].ravel(), idx[1:, :-1].ravel(),
                  idx[:-1, 1:].ravel(), idx[1:, 1:].ravel())
    tris = np.concatenate([np.stack([a, b, c], 1), np.stack([b, d, c], 1)])
    normals = np.zeros((0, 3), f32)
    if seed % 2:
        nrm = rng.normal(0, 0.3, (16, 3)) + [0.0, 0.0, 1.0]
        normals = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)).astype(f32)
    meshes.append(HostMesh(triangles=tris, vertices=gv, normals=normals))
    spheres = np.concatenate([spot(2), rng.uniform(2, 5, (2, 1))], 1)
    nd = rng.normal(0, 1, (2, 3))
    nd = nd / np.linalg.norm(nd, axis=1, keepdims=True)
    discs = np.concatenate([nd, spot(2), rng.uniform(3, 6, (2, 1))], 1)
    desc = SceneDescription()
    desc.meshes = meshes
    desc.spheres = spheres.astype(f32)
    desc.discs = discs.astype(f32)
    desc.materials = [Material(rng.uniform(0.1, 0.9, 3).astype(f32),
                               np.zeros(3, f32)) for _ in range(4)]
    desc.mat_ids = [int(m) for m in rng.integers(0, 4, desc.num_geoms)]
    desc.camera = Camera(horizontal_fov=float(np.pi / 3))
    desc.validate()

    tri_v = np.concatenate([m.vertices[m.triangles.astype(np.int64)]
                            for m in meshes])
    tri_n = np.concatenate([
        m.normals[m.triangles.astype(np.int64)] if m.has_normals
        else np.zeros((len(m.triangles), 3, 3), f32) for m in meshes])
    plain = RS.PlainScene(
        tri_v=tri_v, tri_n=tri_n,
        tri_has_n=np.concatenate([np.full(len(m.triangles), bool(m.has_normals))
                                  for m in meshes]),
        tri_geom=np.concatenate([np.full(len(m.triangles), k, np.int64)
                                 for k, m in enumerate(meshes)]),
        tri_prim=np.concatenate([np.arange(len(m.triangles), dtype=np.int64)
                                 for m in meshes]),
        spheres=desc.spheres, discs=desc.discs,
        mat_albedo=np.stack([m.albedo for m in desc.materials]),
        mat_emission=np.stack([m.emission for m in desc.materials]),
        mat_type=np.zeros(len(desc.materials), np.int64),
        mat_ior=np.full(len(desc.materials), 1.52, f32),
        mat_ids=np.asarray(desc.mat_ids, np.int64),
        fov=desc.camera.horizontal_fov, num_meshes=len(meshes))
    return desc, plain


def reference_frame(plain, w, h, device=CPU):
    """The reference's AOVs of every raster pixel, as [w*h, k] numpy."""
    pix = np.arange(w * h)
    rows = torch.from_numpy((pix // w).astype(np.float32)).to(device)
    cols = torch.from_numpy((pix % w).astype(np.float32)).to(device)
    a = RB.aovs(RB.prims(plain, device), rows, cols, w=w, h=h,
                fov=plain.fov, light=DEFAULT_LIGHT_POS,
                ambient=DEFAULT_AMBIENT)
    return {k: a[k].cpu().numpy().reshape(w * h, -1) for k in AOVS}


def mismatches(out, want) -> int:
    n = len(want["t"])
    got = {k: getattr(out, k).reshape(n, -1) for k in AOVS}
    return int(mismatched(got, want).sum())


@pytest.mark.parametrize("seed,size", [(3, 32), (8, 48), (11, 64), (20, 40)])
def test_random_scenes_equal_the_reference(seed, size):
    desc, plain = random_scene(seed)
    scene, params = build_scene(desc, device="cpu", image_width=size,
                                image_height=size, intersector="bvh")
    out = render(scene, params, mode="shadow-trace", chunk_size=CHUNK)
    want = reference_frame(plain, size, size)
    geom = want["geom_id"][:, 0]
    hit = geom >= 0
    # triangles and spheres or discs seen, and some hits in shadow, where
    # the rgb is the ambient term alone
    assert hit.mean() > 0.1 and len(set(geom[hit] >= len(desc.meshes))) == 2
    albedo = plain.mat_albedo[plain.mat_ids[geom[hit]]]
    shadowed = (want["rgb"][hit] == albedo * np.float32(DEFAULT_AMBIENT))
    assert shadowed.all(axis=1).sum() > 0
    assert mismatches(out, want) == 0


def _cornell_monkey(size):
    cell = harness.Cell(CELL)
    cfg = cell.config
    from ipu_ray_lib_tpu_torch.scene import builtin

    fn = cfg["program"]["scene"].split(":")[1]
    desc = getattr(builtin, fn)(*[cell.path(a) for a in cfg["program"]["args"]])
    scene, params = build_scene(desc, device="cpu", image_width=size,
                                image_height=size,
                                intersector=cfg["intersector"])
    return cell, scene, params


def test_the_configuration_equals_the_reference_at_64():
    cell, scene, params = _cornell_monkey(64)
    assert params.intersector == "bvh" and scene.bvh_nodes is not None
    zoomed = dataclasses.replace(params, fov_radians=params.fov_radians
                                 * 1.017)
    out = render(scene, zoomed, mode="shadow-trace", chunk_size=1024)
    plain = RS.load(cell.config["scene"], cell.root)
    plain.fov = plain.fov * 1.017
    want = reference_frame(plain, 64, 64)
    assert out.hit_count > 2000
    assert mismatches(out, want) == 0


# Pixels of the 1440^2 frame (seed, frame index): (row, col, zoom) where
# the ray grazes an edge. At the first two the watertight test accepts a
# nearer hit just past a triangle's edge, outside its box, which the walk
# never tests (the tall block's corner; the light 0.0002 below the
# ceiling). At the third the two triangles of the red wall's quad give
# the same t, and the walk keeps the one it visits first.
GRAZING = {"tall_block_corner": (690, 472, 0.9734945246780745),
           "light_edge": (266, 827, 1.018886920716111)}
TIE = (390, 356, 0.9946203693424548)


def _frame_pixel(row, col, zoom):
    """The port's AOVs and the reference's of one pixel of the
    configuration's 1440^2 frame at ``zoom``."""
    from ipu_ray_lib_tpu_torch.ops.camera import (plane_scale, scaled_ray_dir,
                                                  tan_half_fov)
    from ipu_ray_lib_tpu_torch.render.shadow import shadow_trace

    cell, scene, params = _cornell_monkey(1440)
    r, c = torch.tensor([float(row)]), torch.tensor([float(col)])
    d = scaled_ray_dir(c, r, 1440, 1440, *plane_scale(
        1440, 1440, tan_half_fov(params.fov_radians * zoom)))
    res = shadow_trace(scene, None, d, intersector="bvh", fused=False)
    got = {k: getattr(res, k).numpy().reshape(1, -1) for k in AOVS}
    got["geom_id"] = np.where(res.escaped.numpy()[:, None], -1,
                              got["geom_id"])
    plain = RS.load(cell.config["scene"], cell.root)
    a = RB.aovs(RB.prims(plain, CPU), r, c, w=1440, h=1440,
                fov=plain.fov * zoom, light=DEFAULT_LIGHT_POS,
                ambient=DEFAULT_AMBIENT)
    return got, {k: a[k].numpy().reshape(1, -1) for k in AOVS}


@pytest.mark.parametrize("case", sorted(GRAZING))
def test_a_hit_outside_its_box_counts_for_neither(case):
    got, want = _frame_pixel(*GRAZING[case])
    assert not mismatched(got, want).any()


def test_an_exact_tie_in_t_is_the_one_departure():
    got, want = _frame_pixel(*TIE)
    assert got["t"][0, 0] == want["t"][0, 0]
    assert got["geom_id"][0, 0] == want["geom_id"][0, 0] == 2
    assert (got["prim_id"][0, 0], want["prim_id"][0, 0]) == (1, 0)


def test_two_walks_a_chunk(monkeypatch):
    desc, _ = random_scene(3)
    scene, params = build_scene(desc, device="cpu", image_width=32,
                                image_height=24, intersector="bvh")
    calls = []
    orig = TT.bvh_walk

    def counted(*a, **k):
        calls.append(a[5] if len(a) > 5 else k["any_hit"])
        return orig(*a, **k)
    monkeypatch.setattr(TT, "bvh_walk", counted)
    render(scene, params, mode="shadow-trace", chunk_size=256)
    assert calls == [False, True] * 3


def test_glue_spans_once_a_chunk_and_none_without_a_profiler():
    desc, _ = random_scene(8)
    scene, params = build_scene(desc, device="cpu", image_width=32,
                                image_height=32, intersector="bvh")
    n0 = len(profiling.recorded_spans())
    plain = render(scene, params, mode="shadow-trace", chunk_size=256)
    assert len(profiling.recorded_spans()) == n0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = render(scene, params, mode="shadow-trace", chunk_size=256)
    names = [n for _, _, n in sorted(
        (e.start_ns(), e.end_ns(), e.name())
        for e in prof.profiler.kineto_results.events()
        if e.name().startswith("renderer."))]
    chunk = ["renderer.rays"] + GLUE + ["renderer.store"]
    assert names == chunk * 4 + ["renderer.readback"]
    recorded = [n for _, _, n in profiling.recorded_spans()[n0:]]
    assert recorded == names
    for a, b in zip(plain, traced):
        assert a.tobytes() == b.tobytes()


@pytest.mark.cuda
def test_two_k7_launches_a_chunk_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ipu_ray_lib_tpu_torch.ops.cuda import build

    build.load()
    desc, plain = random_scene(11)
    scene, params = build_scene(desc, device="cuda", image_width=300,
                                image_height=200, intersector="bvh")
    want = reference_frame(plain, 300, 200, torch.device("cuda"))
    # the first frame of its shape runs eagerly (then is captured), the
    # others replay the graph, which adds the K7 launches it holds
    for _ in range(3):
        TBVH.reset_launches()
        out = render(scene, params, mode="shadow-trace", chunk_size=4096)
        assert TBVH.launches == 2 * -(-300 * 200 // 4096)
        assert mismatches(out, want) == 0
