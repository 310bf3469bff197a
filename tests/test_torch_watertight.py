"""Watertight acceptance of the port's triangle test: crack tests.

The port counterpart of tests/test_watertight.py. Rays aimed exactly at
the shared edges, edge points and vertices of a skewed, tilted, irregular
tessellation must hit at least one incident triangle through the port's
per-lane block cull (``slab_admit``) and widened dense row test
(``dense_rows``) — the plain version of the kernel's walk — and through
the HBM-mode walk (``_walk_hbm``: super-group, super and refined
member-block culls). A pixel-aligned vertex grid rendered through the
port's megakernel, in either mode, must leave no dark pixel inside the
grid. The same holds for the ``"bvh"`` and ``"dense"`` intersectors
(ops/traversal.py ``scene_intersect``: the threaded-BVH walk's watertight
test, K7's plain version, and the dense test, K8's), on the edge rays
and on the vertex grid rendered through the XLA-loop integrator.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses

import numpy as np
import pytest
import torch

from ipu_ray_lib_tpu_torch.ops import megakernel as mk
from ipu_ray_lib_tpu_torch.ops.intersect import (INF, dense_rows, slab_admit,
                                                 slab_inv)
from ipu_ray_lib_tpu_torch.ops.tables import TB
from ipu_ray_lib_tpu_torch.ops.traversal import scene_intersect
from ipu_ray_lib_tpu_torch.render.streaming import render_streaming
from ipu_ray_lib_tpu_torch.scene.build import build_scene
from ipu_ray_lib_tpu_torch.scene.types import (Camera, HostMesh, Material,
                                               MaterialType, SceneDescription)


def _skewed_grid_scene(n=12, seed=3):
    """A solid tessellated quad (2*(n-1)^2 tris, shared edges everywhere),
    skewed and tilted so no edge is axis-aligned (the reference test's
    scene, built with the port's scene types)."""
    rng = np.random.default_rng(seed)
    u = np.linspace(-2.0, 2.0, n)
    uu, vv = np.meshgrid(u, u, indexing="ij")
    uu[1:-1, 1:-1] += rng.uniform(-0.12, 0.12, (n - 2, n - 2))
    vv[1:-1, 1:-1] += rng.uniform(-0.12, 0.12, (n - 2, n - 2))
    verts = np.stack(
        [uu, vv, -4.0 + 0.23 * uu - 0.11 * vv], axis=-1
    ).reshape(-1, 3).astype(np.float32)
    idx = np.arange(n * n).reshape(n, n)
    a, b = idx[:-1, :-1].ravel(), idx[1:, :-1].ravel()
    c, d = idx[:-1, 1:].ravel(), idx[1:, 1:].ravel()
    tris = np.concatenate(
        [np.stack([a, b, c], -1), np.stack([b, d, c], -1)]).astype(np.uint32)
    scene = SceneDescription()
    scene.meshes = [HostMesh(triangles=tris, vertices=verts)]
    scene.materials = [Material(np.array([0.75, 0.75, 0.75], np.float32),
                                np.array([5.0, 5.0, 5.0], np.float32),
                                MaterialType.DIFFUSE)]
    scene.mat_ids = [0]
    scene.camera = Camera(horizontal_fov=float(np.pi / 3))
    scene.validate()
    return scene, verts, tris


def _edge_targets(verts, tris, per_edge=3, seed=0):
    """Points exactly on shared edges, edge midpoints, and every vertex."""
    rng = np.random.default_rng(seed)
    edges = set()
    for t in tris:
        for e in ((t[0], t[1]), (t[1], t[2]), (t[2], t[0])):
            edges.add((min(e), max(e)))
    pts = [verts]
    for (i, j) in sorted(edges):
        w = rng.uniform(0.05, 0.95, per_edge).astype(np.float32)[:, None]
        pts.append(verts[i] * (1 - w) + verts[j] * w)
        pts.append(((verts[i] + verts[j]) * np.float32(0.5))[None, :])
    return np.concatenate(pts).astype(np.float32)


def _walk(scene, o, d):
    """The plain walk of the kernel: (found, t) of each ray over every
    block its slab admits."""
    R = o[0].shape[0]
    active = torch.ones(R, dtype=torch.bool)
    inv = slab_inv(d)
    o_mag = torch.maximum(torch.maximum(o[0].abs(), o[1].abs()), o[2].abs())
    best = torch.full((R,), INF)
    for blk in range(scene.num_blocks):
        adm = slab_admit(o, inv, active, scene.baabb[blk])
        t, ok = dense_rows(scene.p[blk * TB:(blk + 1) * TB], o, d, o_mag)
        best = torch.minimum(best, torch.amin(
            torch.where(ok & adm, t, INF), dim=0))
    return best < INF, best


@pytest.mark.parametrize("n,seed", [(12, 3), (9, 5), (16, 11)])
def test_no_cracks_on_shared_edges(n, seed):
    scene, verts, tris = _skewed_grid_scene(n, seed)
    ts, _ = build_scene(scene, device="cpu", image_width=8, image_height=8,
                        samples_per_pixel=1)
    targets = _edge_targets(verts, tris, seed=seed)
    d = targets / np.linalg.norm(targets, axis=-1, keepdims=True)
    d = torch.from_numpy(d.astype(np.float32))
    zero = torch.zeros(d.shape[0])
    found, t = _walk(ts, (zero, zero, zero), (d[:, 0], d[:, 1], d[:, 2]))
    assert bool(found.all()), (
        f"{int((~found).sum())}/{len(found)} edge rays leaked")
    t = t[found]
    assert bool(torch.isfinite(t).all() & (t > 1.0).all() & (t < 10.0).all())


def _pixel_vertex_scene(size=32):
    """A tessellation whose vertices sit on every pixel-centre camera ray
    (anti-aliasing off): each primary ray passes through a mesh vertex."""
    fov = np.pi / 3
    tan_t = np.tan(fov / 2)
    r, c = np.meshgrid(np.arange(size), np.arange(size), indexing="ij")
    xn, yn, zs = c / size - 0.5, r / size - 0.5, 3.7
    verts = np.stack([(2 * tan_t * xn) * zs, (-2 * tan_t * yn) * zs,
                      np.full_like(xn, -zs)], axis=-1
                     ).reshape(-1, 3).astype(np.float32)
    idx = np.arange(size * size).reshape(size, size)
    a, b = idx[:-1, :-1].ravel(), idx[1:, :-1].ravel()
    c_, d = idx[:-1, 1:].ravel(), idx[1:, 1:].ravel()
    tris = np.concatenate(
        [np.stack([a, b, c_], -1), np.stack([b, d, c_], -1)]).astype(np.uint32)
    scene = SceneDescription()
    scene.meshes = [HostMesh(triangles=tris, vertices=verts)]
    scene.materials = [Material(np.array([0.7, 0.7, 0.7], np.float32),
                                np.array([3.0, 3.0, 3.0], np.float32),
                                MaterialType.DIFFUSE)]
    scene.mat_ids = [0]
    scene.camera = Camera(horizontal_fov=float(fov))
    scene.validate()
    return scene


def _vertex_grid_dark_pixels(intersector):
    """Dark interior pixels of the pixel-aligned vertex grid rendered
    through the port's megakernel (plain version) in one mode."""
    size = 32
    ts, params = build_scene(_pixel_vertex_scene(size), device="cpu",
                             image_width=size, image_height=size,
                             samples_per_pixel=1, intersector=intersector)
    params = dataclasses.replace(params, anti_alias_scale=0.0,
                                 max_path_length=2)
    mk.reset_launches()
    img, done = render_streaming(ts, params)
    assert done == size * size and mk.launches == mk.hbm_launches == 0
    assert params.intersector == intersector
    return int((img[1:-1, 1:-1].sum(axis=-1) <= 0).sum())


def test_megakernel_no_cracks_at_vertices():
    """Every interior pixel ray of the render passes through a shared
    vertex; a dark interior pixel would be a crack in the port's walk."""
    dark = _vertex_grid_dark_pixels("pallas")
    assert dark == 0, f"{dark} cracked pixels at mesh vertices"


def test_megakernel_no_cracks_at_vertices_hbm():
    """The same grid through the HBM-mode walk (super-group, super and
    refined member-block culls; tests/test_watertight.py's hbm case)."""
    dark = _vertex_grid_dark_pixels("pallas-hbm")
    assert dark == 0, f"{dark} cracked pixels at mesh vertices (HBM walk)"


@pytest.mark.parametrize("n,seed", [(12, 3), (9, 5), (16, 11)])
def test_no_cracks_on_shared_edges_hbm(n, seed):
    """Edge rays through the HBM-mode walk (``_walk_hbm``): the group,
    super and member culls drop no hit the dense test accepts."""
    scene, verts, tris = _skewed_grid_scene(n, seed)
    ts, _ = build_scene(scene, device="cpu", image_width=8, image_height=8,
                        samples_per_pixel=1, intersector="pallas-hbm")
    targets = _edge_targets(verts, tris, seed=seed)
    d = targets / np.linalg.norm(targets, axis=-1, keepdims=True)
    d = torch.from_numpy(d.astype(np.float32))
    R = d.shape[0]
    zero = torch.zeros(R)
    o, d = (zero, zero, zero), (d[:, 0], d[:, 1], d[:, 2])
    best_t, best_row = mk._walk_hbm(
        ts, o, d, slab_inv(d), torch.ones(R, dtype=torch.bool), zero,
        torch.full((R,), INF), torch.full((R,), -1, dtype=torch.int64), None)
    _, want_t = _walk(ts, o, d)
    assert bool((best_row >= 0).all()), (
        f"{int((best_row < 0).sum())}/{R} edge rays leaked")
    assert torch.equal(best_t, want_t)


@pytest.mark.parametrize("method", ["bvh", "dense"])
@pytest.mark.parametrize("n,seed", [(12, 3), (9, 5), (16, 11)])
def test_no_cracks_on_shared_edges_traversal(method, n, seed):
    """Edge rays from (0, 0, 0) through ``scene_intersect`` with the
    method: no ray aimed at a shared edge or vertex misses every incident
    triangle."""
    scene, verts, tris = _skewed_grid_scene(n, seed)
    ts, _ = build_scene(scene, device="cpu", image_width=8, image_height=8,
                        samples_per_pixel=1, intersector=method)
    targets = _edge_targets(verts, tris, seed=seed)
    d = targets / np.linalg.norm(targets, axis=-1, keepdims=True)
    d = torch.from_numpy(d.astype(np.float32))
    R = d.shape[0]
    hit = scene_intersect(ts, None, d, torch.zeros(R), torch.full((R,), INF),
                          method)
    assert bool(hit.found.all()), (
        f"{int((~hit.found).sum())}/{R} edge rays leaked ({method})")
    t = hit.t
    assert bool((t > 1.0).all() & (t < 10.0).all())


@pytest.mark.parametrize("method", ["bvh", "dense"])
def test_xla_loop_no_cracks_at_vertices(method):
    """The vertex grid through the XLA-loop integrator with the method."""
    dark = _vertex_grid_dark_pixels(method)
    assert dark == 0, f"{dark} cracked pixels at mesh vertices ({method})"
