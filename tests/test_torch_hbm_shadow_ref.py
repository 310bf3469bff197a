"""The shadow trace of a scene in HBM mode (``intersector="pallas-hbm"``,
the route ``"auto"`` takes above 65,536 primitives: the glue route with
K6's plain walk on the CPU, twice a chunk) against the benchmark's plain
shadow reference (``benchmark/reference/shadow.py``), which tests every
row of the scene for each ray and imports nothing of the port.

* The ``grid512-aov`` configuration cut to a 48- or 64-vertex grid and
  a 64x64 window, through the benchmark's own cell and through
  ``render(mode="shadow-trace")``, and seeded random meshes of quads that
  share edges, above one super (8 blocks of 128 rows): every pixel's six
  AOVs within the ``shadow`` mode's tolerances (rtol 1e-5, atol 1e-6),
  ids equal. The reference breaks an exact tie in t by the lower scene
  row, the walk by its rows' order; no tie occurs in these frames.
* At full size, without building: the configuration's light and ambient
  are the renderer's, and ``"auto"`` resolves to ``"pallas-hbm"`` at its
  522,242 triangles.
* The route's structure: two K6 queries a chunk (the closest hit and the
  occlusion query, also a closest hit), and the span ``hbm.cull`` once
  in each, under a profiler only.
* The readers: ``k6.ms_per_frame`` reads ``chunk_kernel`` and
  ``fold_kernel`` (K6) and nothing else, K5's ``bundle_kernel``
  included; ``k6_roofline`` is ``k7_roofline.least_bytes`` at 3.35 TB/s
  over that time; ``hbm.cull_idle_ms_per_frame`` reads its span.
* Faults planted in the timed path (a perturbed t, a swapped primitive,
  a skipped occlusion query) come out not correct.

This file imports no JAX; its card test runs without the conftest::

    python -m pytest --noconftest -p no:cacheprovider -m cuda -s \\
        tests/test_torch_hbm_shadow_ref.py
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import importlib.util
import json
import os
import sys
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import harness, spans
from benchmark.harness import DeviceEvent, Run
from benchmark.modes.shadow import AOVS, mismatched
from benchmark.reference import scene as RS
from benchmark.reference import shadow as RSH
from benchmark.reference.geometry import tables
from ipu_ray_lib_tpu_torch.ops import intersect_hbm as IH
from ipu_ray_lib_tpu_torch.ops.tables import SB
from ipu_ray_lib_tpu_torch.render.renderer import render
from ipu_ray_lib_tpu_torch.render.shadow import (DEFAULT_AMBIENT,
                                                 DEFAULT_LIGHT_POS)
from ipu_ray_lib_tpu_torch.scene.build import build_scene, resolve_intersector
from ipu_ray_lib_tpu_torch.scene.types import (Camera, HostMesh, Material,
                                               SceneDescription)
from ipu_ray_lib_tpu_torch.utils import profiling

CELL = "grid512-aov.shadow-1440"
CPU = torch.device("cpu")
MS = 1e6
SEED = 2147483659


def _metric(name):
    spec = importlib.util.spec_from_file_location(
        "m_" + name.replace(".", "_"),
        os.path.join(harness.ROOT, "benchmark", "metrics", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cell(grid=48, w=64, chunk=1024, **config):
    """The cell with its heightfield cut to ``grid`` vertices a side, in
    HBM mode whatever its size, at a w x w window, every pixel checked."""
    base = harness.Cell(CELL).config
    scene = json.loads(json.dumps(base["scene"]))
    scene["meshes"][0]["grid"] = grid
    cfg = dict(image_width=w, image_height=w, scene=scene,
               program=dict(base["program"], args=[grid]),
               intersector="pallas-hbm")
    cfg.update(config)
    return harness.Cell(CELL, overrides={
        "config": cfg,
        "traffic": {"check_pixels": w * w, "trace_frames": 1,
                    "chunk": chunk}})


def _run(cell, seed=SEED):
    return harness.run(cell, seed, 0.01, False, [CPU], 0.0)


def _build(cell, device="cpu"):
    from benchmark import program

    return program.build(cell, torch.device(device), {})[:2]


def reference_frame(plain, w, h, device=CPU):
    """The reference's AOVs of every raster pixel, as [w*h, k] numpy."""
    pix = np.arange(w * h)
    rows = torch.from_numpy((pix // w).astype(np.float32)).to(device)
    cols = torch.from_numpy((pix % w).astype(np.float32)).to(device)
    a = RSH.aovs(tables(plain, device), rows, cols, w=w, h=h, fov=plain.fov,
                 light=DEFAULT_LIGHT_POS, ambient=DEFAULT_AMBIENT)
    return {k: a[k].cpu().numpy().reshape(w * h, -1) for k in AOVS}


def mismatches(out, want) -> int:
    n = len(want["t"])
    got = {k: getattr(out, k).reshape(n, -1) for k in AOVS}
    return int(mismatched(got, want).sum())


def _lit_and_shadowed(plain, want):
    """(hit share, pixels lit, pixels in shadow) of a reference frame: a
    shadowed hit's rgb is the ambient term alone."""
    geom = want["geom_id"][:, 0]
    hit = geom >= 0
    albedo = plain.mat_albedo[plain.mat_ids[geom[hit]]]
    shadowed = (want["rgb"][hit] == albedo * np.float32(DEFAULT_AMBIENT)
                ).all(axis=1)
    return hit.mean(), int((~shadowed).sum()), int(shadowed.sum())


@pytest.mark.parametrize("grid,zoom", [(48, 1.0), (64, 1.023)])
def test_the_configuration_equals_the_reference(grid, zoom):
    cell = _cell(grid)
    scene, params = _build(cell)
    assert params.intersector == "pallas-hbm"
    assert scene.num_blocks > SB
    zoomed = dataclasses.replace(params,
                                 fov_radians=params.fov_radians * zoom)
    out = render(scene, zoomed, mode="shadow-trace", chunk_size=1024)
    plain = RS.load(cell.config["scene"], cell.root)
    plain.fov = plain.fov * zoom
    want = reference_frame(plain, 64, 64)
    share, lit, shadowed = _lit_and_shadowed(plain, want)
    assert share > 0.3 and lit > 100 and shadowed > 10
    assert mismatches(out, want) == 0


def test_the_cell_is_correct_through_the_harness():
    r = _run(_cell(48))
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert r["checks"]["aov_mismatch_pct"]["value"] == 0.0
    assert set(r["metrics"]) == {"shadow_frame_ms", "frame_ms_p90", "setup_s"}


def random_mesh(seed: int, n: int = 26):
    """(the port's description, the reference's PlainScene) of a seeded
    random terrain below the camera: an n x n grid of vertices, skewed,
    with random heights, two triangles a cell wound up to the light, so
    2 (n-1)^2 triangles sharing edges (1,250 at n = 26, above one super
    of 1,024 rows); vertex normals on odd seeds."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    u, v = np.meshgrid(np.linspace(-1, 1, n), np.linspace(0, 1, n),
                       indexing="ij")
    x = 9.0 * u + rng.uniform(-1.5, 1.5) * v + rng.normal(0, 0.08, u.shape)
    z = -3.0 - 13.0 * v + rng.normal(0, 0.08, u.shape)
    y = -2.5 + rng.normal(0, 0.35, u.shape) + 0.5 * np.sin(
        rng.uniform(1, 4) * u) * np.cos(rng.uniform(1, 4) * v)
    verts = np.stack([x, y, z], -1).reshape(-1, 3).astype(f32)
    idx = np.arange(n * n).reshape(n, n)
    a, b = idx[:-1, :-1].ravel(), idx[1:, :-1].ravel()
    c, d = idx[:-1, 1:].ravel(), idx[1:, 1:].ravel()
    tris = np.concatenate([np.stack([a, c, b], 1), np.stack([b, c, d], 1)])
    normals = np.zeros((0, 3), f32)
    if seed % 2:
        nrm = rng.normal(0, 0.3, (n * n, 3)) + [0.0, 1.0, 0.0]
        normals = (nrm / np.linalg.norm(nrm, axis=1, keepdims=True)
                   ).astype(f32)
    mesh = HostMesh(triangles=tris.astype(np.uint32), vertices=verts,
                    normals=normals)
    desc = SceneDescription()
    desc.meshes = [mesh]
    desc.spheres = np.zeros((0, 4), f32)
    desc.discs = np.zeros((0, 7), f32)
    desc.materials = [Material(rng.uniform(0.1, 0.9, 3).astype(f32),
                               np.zeros(3, f32))]
    desc.mat_ids = [0]
    desc.camera = Camera(horizontal_fov=float(np.pi / 3))
    desc.validate()
    tri = tris.astype(np.int64)
    plain = RS.PlainScene(
        tri_v=verts[tri],
        tri_n=normals[tri] if seed % 2 else np.zeros((len(tri), 3, 3), f32),
        tri_has_n=np.full(len(tri), bool(seed % 2)),
        tri_geom=np.zeros(len(tri), np.int64),
        tri_prim=np.arange(len(tri), dtype=np.int64),
        spheres=desc.spheres, discs=desc.discs,
        mat_albedo=np.stack([m.albedo for m in desc.materials]),
        mat_emission=np.zeros((1, 3), f32),
        mat_type=np.zeros(1, np.int64), mat_ior=np.full(1, 1.52, f32),
        mat_ids=np.zeros(1, np.int64), fov=desc.camera.horizontal_fov,
        num_meshes=1)
    return desc, plain


@pytest.mark.parametrize("seed", [4, 7, 12])
def test_random_meshes_equal_the_reference(seed):
    desc, plain = random_mesh(seed)
    scene, params = build_scene(desc, device="cpu", image_width=48,
                                image_height=48, intersector="pallas-hbm")
    assert scene.num_blocks > SB
    out = render(scene, params, mode="shadow-trace", chunk_size=512)
    want = reference_frame(plain, 48, 48)
    share, lit, shadowed = _lit_and_shadowed(plain, want)
    assert share > 0.3 and lit > 50 and shadowed > 0
    assert mismatches(out, want) == 0


def test_at_full_size_the_renderers_light_and_the_hbm_route():
    """The configuration as the cell runs it, without a build."""
    from benchmark.scenes.grid512 import make

    cfg = harness.Cell(CELL).config
    assert tuple(cfg["light"]) == DEFAULT_LIGHT_POS
    assert cfg["ambient"] == DEFAULT_AMBIENT
    assert cfg["intersector"] == "auto"
    assert (cfg["image_width"], cfg["image_height"]) == (1440, 1440)
    desc = make(*cfg["program"]["args"])
    n_tris = sum(len(m.triangles) for m in desc.meshes)
    assert n_tris == 522_242 and len(desc.discs) == 1
    n_prims = n_tris + len(desc.spheres) + len(desc.discs)
    assert resolve_intersector(cfg["intersector"], n_prims) == "pallas-hbm"
    # the reference holds the same mesh and light
    plain = RS.load(cfg["scene"], harness.ROOT)
    assert len(plain.tri_v) == n_tris
    np.testing.assert_array_equal(
        plain.tri_v[:4], desc.meshes[0].vertices[
            desc.meshes[0].triangles[:4].astype(np.int64)])


def test_two_k6_queries_a_chunk(monkeypatch):
    cell = _cell(48, w=40)
    scene, params = _build(cell)
    calls = []
    orig = IH.super_walk_ref

    def counted(sc, counts, order, dists, rays, **k):
        calls.append(rays.shape[1])
        return orig(sc, counts, order, dists, rays, **k)
    monkeypatch.setattr(IH, "super_walk_ref", counted)
    render(scene, params, mode="shadow-trace", chunk_size=512)
    # 1,600 pixels in chunks of 512: 4 chunks, each padded to a bundle
    assert calls == [1024] * 8


def _span_names(prof):
    return [n for _, _, n in sorted(
        (e.start_ns(), e.end_ns(), e.name())
        for e in prof.profiler.kineto_results.events()
        if e.name().startswith(("renderer.", "hbm."))
        and e.device_type() != torch.autograd.DeviceType.CUDA)]


def test_hbm_cull_twice_a_chunk_under_a_profiler_only():
    cell = _cell(48, w=32)
    scene, params = _build(cell)
    n0 = len(profiling.recorded_spans())
    plain = render(scene, params, mode="shadow-trace", chunk_size=256)
    assert len(profiling.recorded_spans()) == n0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = render(scene, params, mode="shadow-trace", chunk_size=256)
    names = _span_names(prof)
    chunk = ["renderer.rays", "renderer.hit", "hbm.cull",
             "renderer.occlusion", "hbm.cull", "renderer.shade",
             "renderer.store"]
    assert names == chunk * 4 + ["renderer.readback"]
    recorded = profiling.recorded_spans()[n0:]
    assert sorted(n for *_, n in recorded) == sorted(names)
    # each cull lies inside its query's span
    by = lambda name: [(s, e) for s, e, n in recorded if n == name]
    outer = sorted(by("renderer.hit") + by("renderer.occlusion"))
    for (s, e), (os_, oe) in zip(sorted(by("hbm.cull")), outer):
        assert os_ <= s <= e <= oe
    for a, b in zip(plain, traced):
        assert a.tobytes() == b.tobytes()


def _traced(events, frames=2, cell=None):
    cell = cell or types.SimpleNamespace(config={}, traffic={})
    r = Run(cell, SEED, 1.0, 2.0, [1.0] * frames, [10] * frames, {}, [0])
    r.events = events
    r.window_ns = (0.0, 100 * MS)
    return r


K6_CHUNK = ("(anonymous namespace)::chunk_kernel("
            "(anonymous namespace)::Params)")
K6_FOLD = "(anonymous namespace)::fold_kernel((anonymous namespace)::Params)"
K5 = ("void (anonymous namespace)::bundle_kernel<false>("
      "(anonymous namespace)::Params)")
OTHERS = [K5, "void (anonymous namespace)::shadow_kernel<4>(Params)",
          "void (anonymous namespace)::bvh_kernel<false>("
          "(anonymous namespace)::Params)",
          "void (anonymous namespace)::megakernel<true, false>("
          "(anonymous namespace)::Params)",
          "(anonymous namespace)::rays_cull_kernel("
          "(anonymous namespace)::RaysParams)",
          "Memcpy DtoH (Device -> Pinned)"]


def test_k6_reads_chunk_and_fold_and_nothing_else():
    read = _metric("k6.ms_per_frame").read
    ev = [DeviceEvent(K6_CHUNK, 0, 0.0, 30 * MS),
          DeviceEvent(K6_FOLD, 0, 30 * MS, 32 * MS)]
    ev += [DeviceEvent(n, 0, 40 * MS + k * MS, 40.5 * MS + k * MS)
           for k, n in enumerate(OTHERS)]
    assert read(_traced(ev)) == pytest.approx(16.0)
    assert read(_traced(ev[2:])) is None
    untraced = _traced(ev)
    untraced.events = None
    assert read(untraced) is None
    is_k6 = _metric("k6_roofline").is_k6
    assert [is_k6(n) for n in OTHERS] == [False] * len(OTHERS)
    assert is_k6(K6_CHUNK) and is_k6(K6_FOLD)


def test_k6_roofline_is_the_least_bytes_over_k6s_time(monkeypatch):
    mod = _metric("k6_roofline")
    k7 = _metric("k7_roofline")
    assert mod.least_bytes(1440, 1440) == k7.least_bytes(1440, 1440) \
        == 141_004_800
    assert mod.PEAK_BYTES == 3.35e12
    # the reader's log line walks the sampled pixels; here at a small size
    cell = _cell(48, w=64)
    cell.traffic["check_pixels"] = 64
    logged = []
    monkeypatch.setattr(Run, "log", lambda self, m: logged.append(m))
    ev = [DeviceEvent(K6_CHUNK, 0, 0.0, 1.0 * MS),
          DeviceEvent(K6_FOLD, 0, 2 * MS, 2.5 * MS),
          DeviceEvent(K5, 0, 3 * MS, 9 * MS)]
    least_ms = 1e3 * k7.least_bytes(64, 64) / 3.35e12
    assert mod.read(_traced(ev, frames=1, cell=cell)) == pytest.approx(
        100 * least_ms / 1.5)
    assert len(logged) == 1 and "operations' bound" in logged[0]
    assert mod.read(_traced([DeviceEvent(K5, 0, 0.0, MS)], cell=cell)) is None


def test_lane_work_counts_both_queries():
    mod = _metric("k6_roofline")
    cell = _cell(48, w=64)
    cell.traffic["check_pixels"] = 64
    work = mod.lane_work(_traced([], frames=1, cell=cell))
    assert work["rays"] == 64
    # the walk tests what the hits need, and more
    assert work["tested"] >= work["needed"] > 64


def test_cull_idle_reads_its_span(monkeypatch):
    read = _metric("hbm.cull_idle_ms_per_frame").read
    ev = [DeviceEvent(K6_CHUNK, 0, 20 * MS, 30 * MS),
          DeviceEvent(K6_CHUNK, 0, 60 * MS, 70 * MS)]
    host = [(10 * MS, 40 * MS, "renderer.hit"),
            (10 * MS, 25 * MS, "hbm.cull"),
            (40 * MS, 80 * MS, "renderer.occlusion"),
            (45 * MS, 65 * MS, "hbm.cull")]
    prog = types.SimpleNamespace(recorded_spans=lambda: list(host))
    monkeypatch.setitem(sys.modules, spans.PROFILING, prog)
    # idle under the culls: 10 + 15 = 25 ms over 2 frames
    assert read(_traced(ev)) == pytest.approx(12.5)
    # the parent's program records no such span
    prog.recorded_spans = lambda: [h for h in host if h[2] != "hbm.cull"]
    assert read(_traced(ev)) is None


def _perturb_t(monkeypatch):
    orig = IH.super_walk_ref

    def walk(*a, **k):
        t, *rest = orig(*a, **k)
        return (t * (1.0 + 1e-4), *rest)
    monkeypatch.setattr(IH, "super_walk_ref", walk)


def _swap_prim(monkeypatch):
    """Each hit's row exchanged with its neighbour in the tables (the other
    triangle of the winner's cell, or the next cell's): the primitive
    changes, the t and normal of the true hit stay."""
    orig = IH.super_walk_ref

    def walk(*a, **k):
        t, row, *rest = orig(*a, **k)
        return (t, torch.where(row >= 0, row ^ 1, row), *rest)
    monkeypatch.setattr(IH, "super_walk_ref", walk)


def _skip_occlusion(monkeypatch):
    import ipu_ray_lib_tpu_torch.render.shadow as sh

    monkeypatch.setattr(sh, "scene_occluded",
                        lambda scene, o, d, *a: torch.zeros(
                            d.shape[0], dtype=torch.bool, device=d.device))


@pytest.mark.parametrize("fault", ["perturbed_t", "swapped_prim",
                                   "skipped_occlusion"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    {"perturbed_t": _perturb_t, "swapped_prim": _swap_prim,
     "skipped_occlusion": _skip_occlusion}[fault](monkeypatch)
    r = _run(_cell(48, w=48))
    assert r["failed"] == 0, "the fault hides from the frame's own count"
    assert not r["correct"], r["checks"]


@pytest.mark.cuda
def test_two_k6_launches_a_chunk_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from ipu_ray_lib_tpu_torch.ops.cuda import build

    build.load()
    cell = _cell(96, w=200)
    scene, params = _build(cell, "cuda")
    plain = RS.load(cell.config["scene"], cell.root)
    want = reference_frame(plain, 200, 200, torch.device("cuda"))
    for _ in range(2):
        IH.reset_launches()
        out = render(scene, params, mode="shadow-trace", chunk_size=4096)
        assert IH.launches == 2 * -(-200 * 200 // 4096)
        assert mismatches(out, want) == 0
    desc, plain = random_mesh(7)
    scene, params = build_scene(desc, device="cuda", image_width=160,
                                image_height=120, intersector="pallas-hbm")
    out = render(scene, params, mode="shadow-trace", chunk_size=4096)
    assert mismatches(out, reference_frame(plain, 160, 120,
                                           torch.device("cuda"))) == 0
