"""The HBM route's glue kernels on the card (ops/cuda/glue.cu
``rays_cull_kernel`` against the super AABBs, ``hbm_light_kernel``,
``hbm_shade_kernel``), around K6's two queries: a ``"pallas-hbm"``
scene's shadow trace of a batch of rays, and the renderer's chunk, three
glue launches and two K6 queries, replayed as a CUDA graph.

Every comparison by the bytes, against the torch chain the kernels
replace (ops/intersect_kernel.py ``intersect_inputs``; ops/cull.py
``super_cull_lists_bundle``; ops/traversal.py ``pallas_scene_intersect``
and ``scene_occluded``; ops/shadow.py ``light_ray``; ops/bxdf_loop.py
``offset_ray_origin``; ops/shadow.py ``shade``; render/shadow.py
``glue_shadow_trace``, which runs the same K6 launches):

* each kernel alone, on heightfields cut from the ``grid512-aov``
  configuration (48 and 96 vertices a side) and on seeded random scenes
  with spheres and discs: camera rays, a ragged chunk (its last bundle
  part full) and rays from spread origins, a third aimed at the spheres
  and discs; the shading into subsets of the AOVs, written into the rows
  of larger buffers;
* ``shadow_trace`` with ``intersector="pallas-hbm"``, both origin forms;
* whole frames, replayed and eager (a progress callback), against the
  frame as the torch chain renders it: the configuration's 1440^2 frame of
  grid512 uncut at three zooms, and a 300x200 window of the 96-vertex
  field with a ragged last chunk; with the launches each frame makes (two
  K6 queries and three glue launches a chunk).

The CPU tests of the route's plumbing are tests/test_torch_shadow_glue.py's.
This file imports no JAX; on the card::

    python -m pytest --noconftest -p no:cacheprovider -m cuda -s \\
        tests/test_torch_hbm_glue.py
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import hashlib
import itertools

import numpy as np
import pytest
import torch

import ipu_ray_lib_tpu_torch.render.renderer as R
from benchmark import harness
from ipu_ray_lib_tpu_torch.ops import intersect_hbm as IH
from ipu_ray_lib_tpu_torch.ops import shadow as sh
from ipu_ray_lib_tpu_torch.ops.bxdf_loop import offset_ray_origin
from ipu_ray_lib_tpu_torch.ops.camera import (plane_scale, scaled_ray_dir,
                                              tan_half_fov)
from ipu_ray_lib_tpu_torch.ops.cuda import build
from ipu_ray_lib_tpu_torch.ops.cull import BR, super_cull_lists_bundle
from ipu_ray_lib_tpu_torch.ops.intersect_kernel import intersect_inputs
from ipu_ray_lib_tpu_torch.ops.traversal import (pallas_scene_intersect,
                                                 scene_occluded)
from ipu_ray_lib_tpu_torch.render.pixels import pixel_stream
from ipu_ray_lib_tpu_torch.render.shadow import (DEFAULT_AMBIENT,
                                                 DEFAULT_LIGHT_POS,
                                                 glue_shadow_trace,
                                                 shadow_trace)
from ipu_ray_lib_tpu_torch.scene.build import build_scene
from test_torch_bvh_shadow_ref import random_scene
from test_torch_hbm_shadow_ref import CELL, _build, _cell

FIELDS = R.RenderOutput._fields
SHADE_FIELDS = ("rgb", "t", "geom_id", "prim_id", "normal", "hit_p",
                "escaped")
LIGHT, AMBIENT = DEFAULT_LIGHT_POS, DEFAULT_AMBIENT
LIGHT32 = tuple(float(np.float32(v)) for v in LIGHT)
ZOOMS = [0.985 + 0.0025 * i for i in range(12)]
SEEDS = (3, 8)


def _bytes(t) -> bytes:
    return (t.cpu().numpy() if torch.is_tensor(t) else t).tobytes()


def _scale(params):
    return plane_scale(params.image_width, params.image_height,
                       tan_half_fov(params.fov_radians))


def _zoomed(params, zoom):
    return dataclasses.replace(params, fov_radians=params.fov_radians * zoom)


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    build.load()
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def scenes(cuda_device):
    """name -> (scene, params), all in HBM mode on the card: the
    configuration's heightfield cut to 48 and 96 vertices at 300x200, the
    random scenes (spheres and discs) at 300x200, and grid512 uncut at
    1440^2."""
    out = {}
    for grid in (48, 96):
        out[f"grid{grid}"] = _build(_cell(grid, w=300, image_height=200),
                                    "cuda")
    for seed in SEEDS:
        desc, _ = random_scene(seed)
        out[f"random{seed}"] = build_scene(
            desc, device=cuda_device, image_width=300, image_height=200,
            intersector="pallas-hbm")
    out["grid512"] = _build(harness.Cell(CELL), "cuda")
    for scene, params in out.values():
        assert params.intersector == "pallas-hbm"
    return out


def _rays(scene, params, case, n=65536, seed=5):
    """(origins or None, dirs, rows, cols) of ``case``: the camera rays of
    a chunk in the middle of the stream ("camera"; the whole window where
    it is smaller), the same but the last 35 ("ragged"), or n rays from
    origins spread over the camera's view, a third aimed at the spheres
    and discs ("origins"; rows, cols None)."""
    w, h = params.image_width, params.image_height
    padded = -(-w * h // n) * n
    rows, cols = pixel_stream(params).coords(scene.device, padded)
    g0 = min(w * h // 2, max(w * h - n, 0))
    k = min(n, w * h) - (35 if case == "ragged" else 0)
    rows, cols = rows[g0:g0 + k], cols[g0:g0 + k]
    d = scaled_ray_dir(cols, rows, w, h, *_scale(params))
    if case != "origins":
        return None, d, rows, cols
    rng = np.random.default_rng(seed)
    o = (d.cpu().numpy() * rng.uniform(2.0, 40.0, (k, 1))).astype(np.float32)
    dirs = rng.normal(size=(k, 3)).astype(np.float32)
    ap = scene.ap.cpu().numpy()
    targets = ap[:scene.n_spheres + scene.n_discs, 1:4]
    m = k // 3
    dirs[:m] = targets[rng.integers(0, len(targets), m)] - o[:m]
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return (torch.from_numpy(o).to(scene.device),
            torch.from_numpy(dirs).to(scene.device), None, None)


def _prologue(scene, o, d, rows=None, cols=None, params=None):
    """The prologue over the rays against the super AABBs: the camera form
    where rows and cols are given, else the caller's directions."""
    R_ = d.shape[0]
    if rows is not None:
        inv = [float(np.float32(1.0) / np.float32(s))
               for s in (params.image_width, params.image_height)]
        return sh._inputs_cuda(scene, R_, aabb=scene.saabb,
                               camera=(rows, cols, *inv, *_scale(params)))
    return sh._inputs_cuda(scene, R_, aabb=scene.saabb, origins=o, dirs=d)


def _chain_lists(scene, o, d, t_min, t_max):
    """intersect_inputs and the super cull: (counts, order, dists, rays)."""
    oo = torch.zeros_like(d) if o is None else o
    o_pad, d_pad, tn, tx, rays = intersect_inputs(oo, d, t_min, t_max)
    lists = super_cull_lists_bundle(scene, o_pad, d_pad, tn, tx,
                                    rays.shape[1] // BR)
    return (*lists, rays)


def _light(scene, o, d, rays, k6):
    """The light kernel after K6's closest hit ``k6`` of the prologue's
    ``rays``: (srays, counts, order, dists, hit_f, hit_i)."""
    dev, Rp = rays.device, rays.shape[1]
    nrb, ns = Rp // BR, scene.saabb.shape[0]
    out = (torch.empty((8, Rp), device=dev),
           torch.empty(nrb, dtype=torch.int32, device=dev),
           torch.empty((nrb, ns), dtype=torch.int32, device=dev),
           torch.empty((nrb, ns), device=dev),
           torch.empty((4, Rp), device=dev),
           torch.empty((3, Rp), dtype=torch.int32, device=dev))
    build.launch_hbm_light(scene, rays, *k6[:3], *out, R=d.shape[0],
                           light=LIGHT32, zero_origin=o is None)
    return out


def _chain_light(scene, o, d):
    """The torch chain's closest hit with normals, and its shadow ray:
    (hit, normal, t_min, sorig, sdir, dist, hit_p)."""
    n = d.shape[0]
    t_min = torch.zeros(n, device=d.device)
    t_max = torch.full((n,), float("inf"), device=d.device)
    hit, normal = pallas_scene_intersect(scene, o, d, t_min, t_max,
                                         with_normal=True, hbm=True)
    hit_p, sdir, dist = sh.light_ray(o, d, hit.found, hit.t, LIGHT)
    return (hit, normal, t_min, offset_ray_origin(hit_p, sdir, normal),
            sdir, dist, hit_p)


CASES = [(s, c) for s in ["grid48", "grid96", *(f"random{k}" for k in SEEDS)]
         for c in ("camera", "ragged", "origins")]


@pytest.mark.cuda
@pytest.mark.parametrize("name, case", CASES + [("grid512", "camera"),
                                                ("grid512", "ragged")])
def test_prologue_equals_the_super_cull(scenes, name, case):
    scene, params = scenes[name]
    o, d, rows, cols = _rays(scene, params, case)
    n = d.shape[0]
    want = _chain_lists(scene, o, d, torch.zeros(n, device=d.device),
                        torch.full((n,), float("inf"), device=d.device))
    forms = [(o, d, None, None)] + ([(o, d, rows, cols)] if rows is not None
                                    else [])
    for form in forms:
        got = _prologue(scene, *form, params)
        for k, a, b in zip(("counts", "order", "dists", "rays"), got, want):
            assert a.dtype == b.dtype and a.shape == b.shape, k
            assert _bytes(a) == _bytes(b), (name, case, k)
    # some bundles keep supers, and the sky's none
    assert int(want[0].max()) >= 1


@pytest.mark.cuda
@pytest.mark.parametrize("name, case", CASES)
def test_light_kernel_equals_the_chain(scenes, name, case):
    scene, params = scenes[name]
    o, d, _, _ = _rays(scene, params, case)
    rays = _prologue(scene, o, d)
    k6 = IH.super_walk_cuda(scene, *rays)
    srays, *lists, hit_f, hit_i = _light(scene, o, d, rays[3], k6)
    hit, normal, t_min, sorig, sdir, dist, _ = _chain_light(scene, o, d)
    want = _chain_lists(scene, sorig, sdir, t_min, dist)
    for k, a, b in zip(("counts", "order", "dists", "srays"),
                       (*lists, srays), want):
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert _bytes(a) == _bytes(b), (name, case, k)
    n = d.shape[0]
    assert _bytes(hit_f[:3, :n]) == _bytes(k6[2][:3, :n])
    assert _bytes(hit_f[3, :n]) == _bytes(hit.t)
    assert _bytes(hit_i[0, :n]) == _bytes(k6[1][:n])
    found = hit.found
    assert found.sum() > n // 20
    if case == "origins" and name.startswith("random"):
        # spheres and discs won where K6's row did not
        assert bool(((hit_i[1, :n] >= 0) | (hit_i[2, :n] >= 0)).any())


@pytest.mark.cuda
@pytest.mark.parametrize("name, case", CASES)
def test_shade_kernel_equals_the_chain(scenes, name, case):
    scene, params = scenes[name]
    o, d, _, _ = _rays(scene, params, case)
    rays = _prologue(scene, o, d)
    srays, *lists, hit_f, hit_i = _light(scene, o, d, rays[3],
                                         IH.super_walk_cuda(scene, *rays))
    s_t, s_i = IH.super_walk_cuda(scene, *lists, srays)[:2]
    hit, normal, t_min, sorig, sdir, dist, hit_p = _chain_light(scene, o, d)
    occ = scene_occluded(scene, sorig, sdir, t_min, dist, "pallas-hbm")
    want = dict(zip(SHADE_FIELDS, sh.shade(
        scene, hit.geom_id, hit.prim_id, hit.found, normal, hit.t, hit_p,
        sdir, occ, AMBIENT)))
    n = d.shape[0]
    assert occ.any() and (hit.found & ~occ).any()
    # subsets of the AOVs, written into the rows of larger buffers
    subsets = [c for size in (1, 2, 6, 7)
               for c in itertools.combinations(SHADE_FIELDS, size)]
    for subset in subsets:
        bufs = {k: torch.full((n + 64,) + want[k].shape[1:], 7,
                              dtype=want[k].dtype, device=d.device)
                for k in subset}
        before = {k: b.clone() for k, b in bufs.items()}
        build.launch_hbm_shade(
            scene, rays[3], hit_f, hit_i, srays, s_t, s_i,
            {k: b[32:32 + n] for k, b in bufs.items()}, R=n, light=LIGHT32,
            ambient=float(np.float32(AMBIENT)), zero_origin=o is None)
        for k, b in bufs.items():
            assert _bytes(b[32:32 + n]) == _bytes(want[k]), (subset, k)
            assert torch.equal(b[:32], before[k][:32]), k
            assert torch.equal(b[32 + n:], before[k][32 + n:]), k


@pytest.mark.cuda
@pytest.mark.parametrize("name, case", CASES)
def test_shadow_trace_equals_the_glue_chain(scenes, name, case):
    scene, params = scenes[name]
    o, d, _, _ = _rays(scene, params, case)
    want = glue_shadow_trace(scene, o, d, LIGHT, AMBIENT, "pallas-hbm")
    sh.reset_launches()
    IH.reset_launches()
    got = shadow_trace(scene, o, d, intersector="pallas-hbm")
    assert (sh.glue_launches, IH.launches, sh.launches) == (3, 2, 0)
    for k in SHADE_FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert _bytes(a) == _bytes(b), (name, case, k)


def chain_frame(scene, params, chunk, fields, f16=False):
    """The frame as the torch chain renders it: each chunk's
    ``scaled_ray_dir``, ``glue_shadow_trace`` (K6 twice) and the stores
    into the stream-order buffers, then the readback."""
    dev = scene.device
    n = params.window_w * params.window_h
    padded = -(-n // chunk) * chunk
    bufs = R._aov_bufs(fields, padded, dev)
    rows, cols = pixel_stream(params).coords(dev, padded)
    for g0 in range(0, padded, chunk):
        d = scaled_ray_dir(cols[g0:g0 + chunk], rows[g0:g0 + chunk],
                           params.image_width, params.image_height,
                           *_scale(params))
        res = glue_shadow_trace(scene, None, d, LIGHT, AMBIENT, "pallas-hbm")
        for k, b in bufs.items():
            b[g0:g0 + chunk] = getattr(res, k)
    return R._read_back(bufs, params, dev, f16)


def _md5(out):
    return [hashlib.md5(getattr(out, k).tobytes()).hexdigest()
            for k in FIELDS]


def _frames_against_chain(scene, params, zooms, chunk=65536, aovs=None,
                          f16=False):
    """Each zoom's frame replayed and eager (a progress callback) against
    the torch chain's, with the launches of each; the key's first frame
    (eager, then captured) against the chain and against a replay of its
    zoom. Returns the chunks a frame."""
    fields = [k for k in R._AOVS if k == "geom_id" or aovs is None
              or k in aovs]
    n_chunks = -(-params.window_w * params.window_h // chunk)
    kw = dict(chunk_size=chunk, aovs=aovs, readback_f16=f16)
    p0 = _zoomed(params, zooms[0])
    first = _md5(R.render(scene, p0, **kw))
    assert first == _md5(chain_frame(scene, p0, chunk, fields, f16))
    assert first == _md5(R.render(scene, p0, **kw))
    for z in zooms:
        p = _zoomed(params, z)
        want = _md5(chain_frame(scene, p, chunk, fields, f16))
        counts = []
        for cb in (None, lambda i, rgb: None):
            sh.reset_launches()
            IH.reset_launches()
            got = R.render(scene, p, progress_callback=cb, **kw)
            counts.append((sh.launches, IH.launches, sh.glue_launches))
            assert _md5(got) == want, (z, "eager" if cb else "replay")
        assert counts == [(0, 2 * n_chunks, 3 * n_chunks)] * 2, counts
    return n_chunks


@pytest.mark.cuda
def test_frames_equal_the_chain_at_3_zooms(scenes):
    scene, params = scenes["grid512"]
    R.reset_counters()
    n_chunks = _frames_against_chain(scene, params, ZOOMS[::5])
    assert n_chunks == 32
    assert R.graph_captures == 1 and R.graph_replays == len(ZOOMS[::5]) + 1
    fg = next(fg for k, fg in scene._frame_graphs.items()
              if k[-1] == "pallas-hbm")
    assert (fg.k4_launches, fg.k6_launches, fg.k7_launches,
            fg.glue_launches) == (0, 64, 0, 96)
    print(f"capture {fg.capture_ms:.1f} ms, {fg.k6_launches} K6 queries and "
          f"{fg.glue_launches} glue launches a frame")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["normal", "rgb-t", "f16", "grid96-300x200"])
def test_frames_equal_the_chain(scenes, case):
    if case == "grid96-300x200":
        scene, params = scenes["grid96"]
        _frames_against_chain(scene, params, ZOOMS[:3], chunk=8192)
        return
    scene, params = scenes["grid48"]
    aovs = {"normal": ("normal",), "rgb-t": ("rgb", "t")}.get(case)
    _frames_against_chain(scene, params, ZOOMS[::5], chunk=4096, aovs=aovs,
                          f16=case == "f16")
