"""The BVH route's glue kernels on the card (ops/cuda/glue.cu
``bvh_rays_kernel``, ``bvh_light_kernel``, ``bvh_shade_kernel``), around
K7's two walks: five launches for a "bvh" scene's shadow trace of a
batch of rays; the renderer's frame, the glue kernels once and K7 twice a
chunk, replayed as a CUDA graph.

Every comparison by the bytes, against the torch chain the kernels
replace (``scaled_ray_dir``; ops/traversal.py ``hit_normal``;
ops/shadow.py ``light_ray``; ops/bxdf_loop.py ``offset_ray_origin``;
ops/shadow.py ``shade``; render/shadow.py ``glue_shadow_trace``, which
runs the same K7 launches):

* each kernel alone, on seeded random scenes (meshes with and without
  vertex normals, spheres, discs) and on Cornell + monkey: camera rays, a
  ragged chunk (its last block of threads part full) and rays from
  spread origins; the shading into every
  subset of the AOVs, written into the rows of larger buffers;
* ``shadow_trace`` with ``intersector="bvh"``, both origin forms;
* whole frames, replayed and eager (a progress callback), against the
  frame as the torch chain renders it: the 1440^2 Cornell + monkey frame
  at the 12 zooms of ``experiments/torch_bvh_glue_ab.py`` (its first,
  eager frame and a replay of the same zoom too), a subset of the AOVs,
  ``readback_f16`` and a random scene's 300x200 window with a ragged last
  chunk; with the launches each frame makes.

The CPU tests of the route's plumbing are tests/test_torch_shadow_glue.py's.
This file imports no JAX; on the card::

    python -m pytest --noconftest -p no:cacheprovider -m cuda -s \\
        tests/test_torch_bvh_glue.py
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import hashlib
import itertools
import os

import numpy as np
import pytest
import torch

import ipu_ray_lib_tpu_torch.render.renderer as R
from ipu_ray_lib_tpu_torch.ops import bvh as kb
from ipu_ray_lib_tpu_torch.ops import shadow as sh
from ipu_ray_lib_tpu_torch.ops.bxdf_loop import offset_ray_origin
from ipu_ray_lib_tpu_torch.ops.camera import (plane_scale, scaled_ray_dir,
                                              tan_half_fov)
from ipu_ray_lib_tpu_torch.ops.cuda import build
from ipu_ray_lib_tpu_torch.ops.traversal import Hit, hit_normal
from ipu_ray_lib_tpu_torch.render.pixels import pixel_stream
from ipu_ray_lib_tpu_torch.render.shadow import (DEFAULT_AMBIENT,
                                                 DEFAULT_LIGHT_POS,
                                                 glue_shadow_trace,
                                                 shadow_trace)
from ipu_ray_lib_tpu_torch.scene.build import build_scene
from ipu_ray_lib_tpu_torch.scene.builtin import make_cornell_box_scene
from test_torch_bvh_shadow_ref import random_scene

ROOT = os.path.join(os.path.dirname(__file__), "..")
MONKEY = os.path.join(ROOT, "assets", "monkey_bust.glb")
FIELDS = R.RenderOutput._fields
SHADE_FIELDS = ("rgb", "t", "geom_id", "prim_id", "normal", "hit_p",
                "escaped")
LIGHT, AMBIENT = DEFAULT_LIGHT_POS, DEFAULT_AMBIENT
LIGHT32 = tuple(float(np.float32(v)) for v in LIGHT)
ZOOMS = [0.985 + 0.0025 * i for i in range(12)]  # the A/B script's
SEEDS = (3, 8, 11, 20)  # odd seeds: a mesh with vertex normals


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
    """name -> (scene, params): the random scenes at 300x200 and Cornell +
    monkey at 1440^2, built for "bvh" on the card."""
    out = {}
    for seed in SEEDS:
        desc, _ = random_scene(seed)
        out[f"random{seed}"] = build_scene(
            desc, device=cuda_device, image_width=300, image_height=200,
            intersector="bvh")
    out["cornell-monkey"] = build_scene(
        make_cornell_box_scene(MONKEY, box_only=False), device=cuda_device,
        image_width=1440, image_height=1440, intersector="bvh")
    return out


def _rays(scene, params, case, n=65536, seed=5):
    """(origins or None, dirs, rows, cols) of ``case``: the camera rays of
    a chunk in the middle of the stream ("camera"; the whole window where
    it is smaller), the same but the last 35 ("ragged": no whole block of
    threads at the end), or n rays from origins spread over the scene's
    box, a third aimed at its spheres and discs ("origins"; rows, cols
    None)."""
    w, h = params.image_width, params.image_height
    padded = -(-w * h // n) * n
    rows, cols = pixel_stream(params).coords(scene.device, padded)
    g0 = min(w * h // 2, max(w * h - n, 0))
    k = min(n, w * h) - (35 if case == "ragged" else 0)
    rows, cols = rows[g0:g0 + k], cols[g0:g0 + k]
    if case != "origins":
        return None, scaled_ray_dir(cols, rows, w, h, *_scale(params)), \
            rows, cols
    rng = np.random.default_rng(seed)
    v = scene.verts.cpu().numpy()
    lo, hi = v.min(0), v.max(0)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    tg = np.concatenate([scene.spheres.cpu().numpy()[:, :3],
                         scene.discs.cpu().numpy()[:, 3:6]])
    m = n // 3
    d[:m] = tg[rng.integers(0, len(tg), m)] - o[:m]
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.from_numpy(o).to(scene.device),
            torch.from_numpy(d).to(scene.device), None, None)


def _closest(scene, o, d):
    """K7's closest hit of the rays, and its t_min, t_max."""
    n = d.shape[0]
    t_min = torch.zeros(n, device=d.device)
    t_max = torch.full((n,), float("inf"), device=d.device)
    oo = torch.zeros_like(d) if o is None else o
    return kb.bvh_walk_raw(scene, oo, d, t_min, t_max, False, o is None), \
        t_min


def _chain_light(scene, o, d, hit):
    """The torch chain after the closest hit: (sorig, sdir, dist, normal,
    hit_p, found)."""
    h = Hit(*hit)
    normal = hit_normal(scene, o, d, h)
    hit_p, sdir, dist = sh.light_ray(o, d, h.found, h.t, LIGHT)
    return (offset_ray_origin(hit_p, sdir, normal), sdir, dist, normal,
            hit_p, h.found)


CASES = [(s, c) for s in [f"random{k}" for k in SEEDS] + ["cornell-monkey"]
         for c in ("camera", "ragged", "origins")]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["camera", "ragged", "dirs", "origins"])
def test_rays_kernel_equals_the_chain(scenes, case):
    scene, params = scenes["cornell-monkey"]
    p = _zoomed(params, 1.0125)
    o, d, rows, cols = _rays(scene, p, "ragged" if case == "ragged"
                             else "camera")
    n = d.shape[0]
    dev = scene.device
    t_min, t_max = torch.full((n,), 7.0, device=dev), torch.empty(n,
                                                                  device=dev)
    zeros = torch.full((n, 3), 7.0, device=dev)
    dirs = torch.full((n, 3), 7.0, device=dev)
    inv = [float(np.float32(1.0) / np.float32(s)) for s in (1440, 1440)]
    sc = _scale(p)
    if case in ("camera", "ragged"):
        build.launch_bvh_rays(t_min, t_max, zeros=zeros, dirs=dirs,
                              camera=(rows, cols, *inv, *sc))
        assert _bytes(dirs) == _bytes(d)
        # the factors as 0-d tensors on the card, as a replay reads them
        dirs2 = torch.empty_like(dirs)
        build.launch_bvh_rays(t_min, t_max, dirs=dirs2, camera=(
            rows, cols, *inv, *(torch.full((), v, device=dev) for v in sc)))
        assert _bytes(dirs2) == _bytes(d)
    else:
        build.launch_bvh_rays(t_min, t_max,
                              zeros=zeros if case == "dirs" else None)
        assert bool((dirs == 7.0).all())  # not written
    torch.cuda.synchronize()
    assert _bytes(t_min) == _bytes(torch.zeros(n))
    assert _bytes(t_max) == _bytes(torch.full((n,), float("inf")))
    want_zeros = torch.zeros((n, 3)) if case != "origins" else \
        torch.full((n, 3), 7.0)
    assert _bytes(zeros) == _bytes(want_zeros)


@pytest.mark.cuda
@pytest.mark.parametrize("name, case", CASES)
def test_light_kernel_equals_the_chain(scenes, name, case):
    scene, params = scenes[name]
    o, d, _, _ = _rays(scene, params, case)
    hit, _ = _closest(scene, o, d)
    want = _chain_light(scene, o, d, hit)
    found = want[-1]
    n = d.shape[0]
    got = [torch.empty((n, 3), device=d.device) for _ in range(2)] + [
        torch.empty(n, device=d.device), torch.empty((n, 3), device=d.device)]
    sh.reset_launches()
    build.launch_bvh_light(scene, d, *hit, *got, origins=o, light=LIGHT32)
    torch.cuda.synchronize()
    for k, a, b in zip(("sorig", "sdir", "dist", "normal"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert _bytes(a) == _bytes(b), (name, case, k)
    assert found.sum() > n // 20
    if case == "origins":  # a mesh and a sphere or disc, each its branch
        kinds = set(scene.geom_type[hit[1][found].long()].tolist())
        assert len(kinds) >= 2, kinds


@pytest.mark.cuda
@pytest.mark.parametrize("name, case", CASES)
def test_shade_kernel_equals_the_chain(scenes, name, case):
    scene, params = scenes[name]
    o, d, _, _ = _rays(scene, params, case)
    hit, t_min = _closest(scene, o, d)
    sorig, sdir, dist, normal, hit_p, found = _chain_light(scene, o, d, hit)
    occ = kb.bvh_walk_raw(scene, sorig, sdir, t_min, dist, True, False)[1]
    want = dict(zip(SHADE_FIELDS, sh.shade(
        scene, hit[1], hit[2], found, normal, hit[0], hit_p, sdir, occ != 0,
        AMBIENT)))
    n = d.shape[0]
    assert found.any()
    # every subset of the AOVs, written into the rows of larger buffers
    for size in range(1, len(SHADE_FIELDS) + 1):
        for subset in itertools.combinations(SHADE_FIELDS, size):
            bufs = {k: torch.full((n + 64,) + want[k].shape[1:], 7,
                                  dtype=want[k].dtype, device=d.device)
                    for k in subset}
            before = {k: b.clone() for k, b in bufs.items()}
            build.launch_bvh_shade(
                scene, d, *hit, normal, occ,
                {k: b[32:32 + n] for k, b in bufs.items()}, origins=o,
                light=LIGHT32, ambient=float(np.float32(AMBIENT)))
            for k, b in bufs.items():
                assert _bytes(b[32:32 + n]) == _bytes(want[k]), (subset, k)
                assert torch.equal(b[:32], before[k][:32]), k
                assert torch.equal(b[32 + n:], before[k][32 + n:]), k


@pytest.mark.cuda
@pytest.mark.parametrize("name, case", CASES)
def test_shadow_trace_equals_the_glue_chain(scenes, name, case):
    scene, params = scenes[name]
    o, d, _, _ = _rays(scene, params, case)
    want = glue_shadow_trace(scene, o, d, LIGHT, AMBIENT, "bvh")
    sh.reset_launches()
    kb.reset_launches()
    got = shadow_trace(scene, o, d, intersector="bvh")
    assert (sh.glue_launches, kb.launches, sh.launches) == (3, 2, 0)
    for k in SHADE_FIELDS:
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert _bytes(a) == _bytes(b), (name, case, k)


def chain_frame(scene, params, chunk, fields, f16=False):
    """The frame as the torch chain renders it: each chunk's
    ``scaled_ray_dir``, ``glue_shadow_trace`` (K7 twice) and the stores
    into the stream-order buffers, then the readback
    (experiments/torch_bvh_glue_ab.py's chain too)."""
    dev = scene.device
    n = params.window_w * params.window_h
    padded = -(-n // chunk) * chunk
    bufs = R._aov_bufs(fields, padded, dev)
    rows, cols = pixel_stream(params).coords(dev, padded)
    for g0 in range(0, padded, chunk):
        d = scaled_ray_dir(cols[g0:g0 + chunk], rows[g0:g0 + chunk],
                           params.image_width, params.image_height,
                           *_scale(params))
        res = glue_shadow_trace(scene, None, d, LIGHT, AMBIENT, "bvh")
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
            kb.reset_launches()
            got = R.render(scene, p, progress_callback=cb, **kw)
            counts.append((sh.launches, kb.launches, sh.glue_launches))
            assert _md5(got) == want, (z, "eager" if cb else "replay")
        assert counts == [(0, 2 * n_chunks, 3)] * 2, counts
    return n_chunks


@pytest.mark.cuda
def test_frames_equal_the_chain_at_12_zooms(scenes):
    scene, params = scenes["cornell-monkey"]
    R.reset_counters()
    n_chunks = _frames_against_chain(scene, params, ZOOMS)
    assert n_chunks == 32
    assert R.graph_captures == 1 and R.graph_replays == len(ZOOMS) + 1
    fg = next(fg for k, fg in scene._frame_graphs.items() if k[-1] == "bvh")
    assert (fg.k4_launches, fg.k7_launches, fg.glue_launches) == (0, 64, 3)
    print(f"capture {fg.capture_ms:.1f} ms, {fg.k7_launches} K7 and "
          f"{fg.glue_launches} glue launches a frame")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["normal", "rgb-t", "f16", "random-300x200"])
def test_frames_equal_the_chain(scenes, case):
    if case == "random-300x200":
        scene, params = scenes["random11"]
        _frames_against_chain(scene, params, ZOOMS[:3], chunk=8192)
        return
    scene, params = scenes["cornell-monkey"]
    aovs = {"normal": ("normal",), "rgb-t": ("rgb", "t")}.get(case)
    _frames_against_chain(scene, params, ZOOMS[::5], aovs=aovs,
                          f16=case == "f16")
