"""The shadow frame's glue kernels (ops/cuda/glue.cu): the prologue (camera
rays, padding and bundle cull) and the epilogue (shading and the AOV
stores) around K4, on the fused route of a CUDA scene; and the rays,
light and shade kernels around K7 on a "bvh" scene's.

On the CPU (tier-1): which calls take the kernel route; a CPU scene
renders through the plain torch functions, the same bytes as the golden
(a "bvh" scene: as the glue route's torch chain); the renderer's
plumbing of the kernel route (its AOV views, a progress callback's rgb,
the launch counts a replayed frame adds, K7's too) with the chunk
function (a "bvh" scene: the frame function) stood in for by the plain
chain; a "bvh" scene's tables checked once a scene; the wrappers raise on a wrong
device, dtype, shape or contiguity before anything is launched; the
counters' reset. The BVH kernels' card tests are
tests/test_torch_bvh_glue.py's.

On the card (marked ``cuda``), every comparison by the bytes: the
prologue against ``shadow_inputs`` (camera rays of a 65,536-ray chunk of
the 1440² stream, a ragged chunk, the caller's directions, rays from
spread origins), the epilogue against ``shadow_epilogue`` and the stores
(every AOV subset, both origin forms), and whole frames, replayed and
eager, against the plain chain (``scaled_ray_dir``, ``shadow_inputs``,
K4, ``shadow_epilogue``, the stores: the frame as the port made it
before these kernels) at the 12 zooms of
``experiments/torch_shadow_readback_ab.py``, a 240x136 window and with
``readback_f16``, with the launches each frame makes. This file imports
no JAX, so the card's tests run without the conftest::

    python -m pytest --noconftest -p no:cacheprovider -m cuda -s \\
        tests/test_torch_shadow_glue.py
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import hashlib
import itertools
import os
import types

import numpy as np
import pytest
import torch

import ipu_ray_lib_tpu_torch.render.renderer as R
from ipu_ray_lib_tpu_torch.ops import bvh as kb
from ipu_ray_lib_tpu_torch.ops import intersect_hbm as IH
from ipu_ray_lib_tpu_torch.ops import shadow as sh
from ipu_ray_lib_tpu_torch.ops.camera import (plane_scale, scaled_ray_dir,
                                              tan_half_fov)
from ipu_ray_lib_tpu_torch.ops.cuda import build
from ipu_ray_lib_tpu_torch.render.pixels import pixel_stream
from ipu_ray_lib_tpu_torch.render.shadow import (DEFAULT_AMBIENT,
                                                 DEFAULT_LIGHT_POS,
                                                 glue_shadow_trace,
                                                 shadow_trace)
from ipu_ray_lib_tpu_torch.scene.build import build_scene
from ipu_ray_lib_tpu_torch.scene.builtin import make_cornell_box_scene

ROOT = os.path.join(os.path.dirname(__file__), "..")
MONKEY = os.path.join(ROOT, "assets", "monkey_bust.glb")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden",
                      "shadow_box48x32.npz")
FIELDS = R.RenderOutput._fields
# shade's tuple, in order (ops/shadow.py shade; build.SHADE_OUTS)
SHADE_FIELDS = ("rgb", "t", "geom_id", "prim_id", "normal", "hit_p",
                "escaped")
LIGHT, AMBIENT = DEFAULT_LIGHT_POS, DEFAULT_AMBIENT
ZOOMS = [0.985 + 0.0025 * i for i in range(12)]  # the A/B script's


def _zoomed(params, zoom):
    return dataclasses.replace(params, fov_radians=params.fov_radians * zoom)


def _scale(params):
    return plane_scale(params.image_width, params.image_height,
                       tan_half_fov(params.fov_radians))


def _bytes(t) -> bytes:
    return (t.cpu().numpy() if torch.is_tensor(t) else t).tobytes()


def _same(a: R.RenderOutput, b: R.RenderOutput) -> bool:
    return all(_bytes(getattr(a, k)) == _bytes(getattr(b, k))
               for k in FIELDS)


def _box(dev="cpu", w=48, h=32, monkey=None, intersector="pallas"):
    return build_scene(make_cornell_box_scene(monkey, box_only=False),
                       device=dev, image_width=w, image_height=h,
                       intersector=intersector)


# ---- which calls take the kernels ----

@pytest.mark.parametrize("device, fused, intersector, kernels", [
    ("cuda", True, "pallas", True),
    ("cuda:0", True, "pallas", True),
    ("cpu", True, "pallas", False),
    ("cuda", False, "pallas", False),
    ("cuda", True, "pallas-hbm", True),
    ("cuda", False, "pallas-hbm", True),
    ("cpu", True, "pallas-hbm", False),
    ("cpu", False, "pallas-hbm", False),
    ("cuda", True, "bvh", True),
    ("cuda", False, "bvh", True),
    ("cpu", True, "bvh", False),
    ("cuda", True, "dense", False),
    ("cuda", False, "dense", False),
])
def test_kernel_route_choice(device, fused, intersector, kernels):
    assert R._kernel_route(torch.device(device), fused,
                           intersector) is kernels
    # the graph route is the kernel route without a progress callback
    assert R._graph_route(torch.device(device), fused, intersector,
                          None) is kernels
    assert not R._graph_route(torch.device(device), fused, intersector,
                              print)


def _no_kernels(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a CPU scene reached a CUDA kernel")

    for name in ("camera_chunk_cuda", "shadow_inputs_cuda",
                 "camera_inputs_cuda", "shade_cuda", "shadow_trace_cuda",
                 "bvh_camera_frame_cuda", "bvh_shadow_trace_cuda",
                 "hbm_camera_chunk_cuda", "hbm_shadow_trace_cuda"):
        monkeypatch.setattr(sh, name, refuse)
    for name in ("bvh_walk_cuda", "bvh_walk_raw"):
        monkeypatch.setattr(kb, name, refuse)
    monkeypatch.setattr(IH, "super_walk_cuda", refuse)
    monkeypatch.setattr(build, "load", refuse)


@pytest.mark.parametrize("callback", [False, True], ids=["plain", "callback"])
def test_cpu_scene_renders_through_the_plain_functions(monkeypatch, callback):
    _no_kernels(monkeypatch)
    scene, params = _box()
    sh.reset_launches()
    seen = []
    out = R.render(scene, params, chunk_size=512, progress_callback=(
        (lambda i, rgb: seen.append(i)) if callback else None))
    assert sh.launches == sh.glue_launches == 0
    assert seen == (list(range(3)) if callback else [])
    golden = np.load(GOLDEN)
    for k in FIELDS:
        assert getattr(out, k).tobytes() == golden[k].tobytes(), k
    # the shadow_trace API alike, both origin forms
    rows, cols = (t[:600] for t in pixel_stream(params).coords(
        scene.device, 48 * 32))
    d = scaled_ray_dir(cols, rows, 48, 32, *_scale(params))
    for o in (None, torch.full_like(d, 0.25)):
        res = sh.fused_shadow_trace(scene, o, d, LIGHT, AMBIENT)
        want = sh.shadow_epilogue(scene, o, d, *sh.fused_shadow_trace_arrays(
            scene, o, d, light=LIGHT), LIGHT, AMBIENT)
        assert all(_bytes(a) == _bytes(b) for a, b in zip(res, want))


@pytest.mark.parametrize("callback", [False, True], ids=["plain", "callback"])
def test_cpu_bvh_scene_renders_through_the_plain_functions(monkeypatch,
                                                           callback):
    _no_kernels(monkeypatch)
    scene, params = _box(intersector="bvh")
    sh.reset_launches()
    kb.reset_launches()
    seen = []
    out = R.render(scene, params, chunk_size=512, progress_callback=(
        (lambda i, rgb: seen.append(i)) if callback else None))
    assert sh.launches == sh.glue_launches == kb.launches == 0
    assert seen == (list(range(3)) if callback else [])
    assert out.hit_count == int((np.load(GOLDEN)["geom_id"] >= 0).sum())
    assert "_frame_graphs" not in scene.__dict__
    # the shadow_trace API takes the torch chain, both origin forms
    rows, cols = (t[:600] for t in pixel_stream(params).coords(
        scene.device, 48 * 32))
    d = scaled_ray_dir(cols, rows, 48, 32, *_scale(params))
    for o in (None, torch.full_like(d, 0.25)):
        res = shadow_trace(scene, o, d, intersector="bvh")
        want = glue_shadow_trace(scene, o, d, intersector="bvh")
        assert all(_bytes(a) == _bytes(b) for a, b in zip(res, want))


@pytest.mark.parametrize("callback", [False, True], ids=["plain", "callback"])
def test_cpu_hbm_scene_renders_through_the_plain_functions(monkeypatch,
                                                           callback):
    """A CPU scene in HBM mode keeps the glue route's torch chain
    (``glue_shadow_trace``, K6's plain walk), replays nothing and equals
    the golden."""
    _no_kernels(monkeypatch)
    scene, params = _box(intersector="pallas-hbm")
    sh.reset_launches()
    IH.reset_launches()
    seen = []
    out = R.render(scene, params, chunk_size=512, progress_callback=(
        (lambda i, rgb: seen.append(i)) if callback else None))
    assert sh.launches == sh.glue_launches == IH.launches == 0
    assert seen == (list(range(3)) if callback else [])
    golden = np.load(GOLDEN)
    for k in FIELDS:
        assert getattr(out, k).tobytes() == golden[k].tobytes(), k
    assert "_frame_graphs" not in scene.__dict__
    rows, cols = (t[:600] for t in pixel_stream(params).coords(
        scene.device, 48 * 32))
    d = scaled_ray_dir(cols, rows, 48, 32, *_scale(params))
    for o in (None, torch.full_like(d, 0.25)):
        res = shadow_trace(scene, o, d, intersector="pallas-hbm", fused=False)
        want = glue_shadow_trace(scene, o, d, intersector="pallas-hbm")
        assert all(_bytes(a) == _bytes(b) for a, b in zip(res, want))


# ---- the renderer's kernel route, its chunk function stood in for ----

@pytest.fixture
def kernel_route(monkeypatch):
    """The CPU taken for a card by the kernel route's rule, the chunk
    function stood in for by the plain chain (counting the launches the
    kernels would make), and a capture whose "graph" replays by running
    the body again. Yields the chunks the stand-in ran."""
    route, made = R._kernel_route, []

    def chunk(scene, rows, cols, image, scale, out, light, ambient):
        made.append(rows.shape[0])
        d = scaled_ray_dir(cols, rows, *image, *scale)
        res = dict(zip(SHADE_FIELDS, sh.fused_shadow_trace(
            scene, None, d, light, ambient)))
        for k, t in out.items():
            t.copy_(res[k])
        sh.glue_launches += 2

    def capture(body, dev):
        body()  # a capture runs the body, its launches recorded

        def replay():  # a replay launches nothing from Python
            n = sh.glue_launches
            body()
            sh.glue_launches = n

        return types.SimpleNamespace(replay=replay), 0.0

    monkeypatch.setattr(R, "_kernel_route", lambda device, *a: route(
        torch.device("cuda") if device.type == "cpu" else device, *a))
    monkeypatch.setattr(sh, "camera_chunk_cuda", chunk)
    monkeypatch.setattr(R, "_capture", capture)
    sh.reset_launches()
    R.reset_counters()
    return made


@pytest.mark.parametrize("aovs", [None, ("normal",), ("rgb", "t")],
                         ids=["all", "normal", "rgb-t"])
def test_kernel_route_equals_the_plain_route(kernel_route, aovs):
    scene, params = _box()
    p = _zoomed(params, 0.97)
    chunk = 512
    n_chunks = -(-48 * 32 // chunk)
    want_rgb, got_rgb = [], []
    with pytest.MonkeyPatch.context() as m:  # the plain route
        m.setattr(R, "_kernel_route", lambda *a: False)
        want = R.render(scene, p, chunk_size=chunk, aovs=aovs,
                        progress_callback=lambda i, rgb: want_rgb.append(rgb))
    assert not kernel_route
    # the eager loop: its progress callback gets each chunk's rgb, also
    # when rgb is not among the AOVs read back
    eager = R.render(scene, p, chunk_size=chunk, aovs=aovs,
                     progress_callback=lambda i, rgb: got_rgb.append(rgb))
    assert kernel_route == [chunk] * n_chunks
    assert [a.tobytes() for a in got_rgb] == [a.tobytes() for a in want_rgb]
    # the graph route: a capture, then replays, each adding the frame's
    # glue launches (two a chunk)
    frames = [R.render(scene, p, chunk_size=chunk, aovs=aovs)
              for _ in range(3)]
    assert (R.graph_captures, R.graph_replays) == (1, 2)
    fg = next(iter(scene._frame_graphs.values()))
    assert fg.glue_launches == 2 * n_chunks
    # the eager frame, the capture's eager frame, and two replays (the
    # capture itself adds nothing)
    assert sh.glue_launches == 4 * 2 * n_chunks
    for out in [eager] + frames:
        assert _same(out, want)


@pytest.fixture
def bvh_kernel_route(monkeypatch):
    """The kernel_route fixture for a "bvh" scene: its frame function
    stood in for by the plain chain, chunk by chunk (counting the three
    glue launches a frame and two K7 launches a chunk the kernels would
    make); yields the (rays, chunk) of each frame it ran."""
    route, made = R._kernel_route, []

    def frame(scene, rows, cols, image, scale, out, chunk, light, ambient):
        made.append((rows.shape[0], chunk))
        for s in range(0, rows.shape[0], chunk):
            w = slice(s, s + chunk)
            d = scaled_ray_dir(cols[w], rows[w], *image, *scale)
            res = glue_shadow_trace(scene, None, d, light, ambient, "bvh")
            for k, t in out.items():
                t[w].copy_(getattr(res, k))
            kb.launches += 2
        sh.glue_launches += 3

    def capture(body, dev):
        body()

        def replay():
            n = sh.glue_launches, kb.launches
            body()
            sh.glue_launches, kb.launches = n

        return types.SimpleNamespace(replay=replay), 0.0

    monkeypatch.setattr(R, "_kernel_route", lambda device, *a: route(
        torch.device("cuda") if device.type == "cpu" else device, *a))
    monkeypatch.setattr(sh, "bvh_camera_frame_cuda", frame)
    monkeypatch.setattr(sh, "camera_chunk_cuda", None)
    monkeypatch.setattr(R, "_capture", capture)
    sh.reset_launches()
    kb.reset_launches()
    R.reset_counters()
    return made


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("aovs", [None, ("normal",), ("rgb", "t")],
                         ids=["all", "normal", "rgb-t"])
def test_bvh_kernel_route_equals_the_plain_route(bvh_kernel_route, aovs,
                                                 fused):
    scene, params = _box(intersector="bvh")
    p = _zoomed(params, 1.02)
    chunk = 512
    n_chunks = -(-48 * 32 // chunk)
    want_rgb, got_rgb = [], []
    with pytest.MonkeyPatch.context() as m:  # the plain route
        m.setattr(R, "_kernel_route", lambda *a: False)
        want = R.render(scene, p, chunk_size=chunk, aovs=aovs,
                        progress_callback=lambda i, rgb: want_rgb.append(rgb))
    assert not bvh_kernel_route and kb.launches == 0
    eager = R.render(scene, p, chunk_size=chunk, aovs=aovs, fused=fused,
                     progress_callback=lambda i, rgb: got_rgb.append(rgb))
    assert bvh_kernel_route == [(chunk * n_chunks, chunk)]
    assert [a.tobytes() for a in got_rgb] == [a.tobytes() for a in want_rgb]
    # the graph route, fused or not: a capture, then replays, each adding
    # the frame's glue launches (three) and K7's (two a chunk)
    frames = [R.render(scene, p, chunk_size=chunk, aovs=aovs, fused=fused)
              for _ in range(3)]
    assert (R.graph_captures, R.graph_replays) == (1, 2)
    fg = next(iter(scene._frame_graphs.values()))
    assert (fg.k4_launches, fg.k7_launches, fg.glue_launches) == (
        0, 2 * n_chunks, 3)
    # the eager frame, the capture's eager frame and two replays
    assert sh.glue_launches == 4 * 3
    assert kb.launches == 4 * 2 * n_chunks and sh.launches == 0
    for out in [eager] + frames:
        assert _same(out, want)


@pytest.fixture
def hbm_kernel_route(monkeypatch):
    """The kernel_route fixture for a "pallas-hbm" scene: its chunk
    function stood in for by the glue route's torch chain (counting the
    three glue launches and two K6 queries a chunk the kernels would
    make); yields the chunks it ran."""
    route, made = R._kernel_route, []

    def chunk(scene, rows, cols, image, scale, out, light, ambient):
        made.append(rows.shape[0])
        d = scaled_ray_dir(cols, rows, *image, *scale)
        res = glue_shadow_trace(scene, None, d, light, ambient, "pallas-hbm")
        for k, t in out.items():
            t.copy_(getattr(res, k))
        sh.glue_launches += 3
        IH.launches += 2

    def capture(body, dev):
        body()

        def replay():
            n = sh.glue_launches, IH.launches
            body()
            sh.glue_launches, IH.launches = n

        return types.SimpleNamespace(replay=replay), 0.0

    monkeypatch.setattr(R, "_kernel_route", lambda device, *a: route(
        torch.device("cuda") if device.type == "cpu" else device, *a))
    monkeypatch.setattr(sh, "hbm_camera_chunk_cuda", chunk)
    monkeypatch.setattr(sh, "camera_chunk_cuda", None)
    monkeypatch.setattr(sh, "bvh_camera_frame_cuda", None)
    monkeypatch.setattr(R, "_capture", capture)
    sh.reset_launches()
    IH.reset_launches()
    R.reset_counters()
    return made


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "unfused"])
@pytest.mark.parametrize("aovs", [None, ("normal",), ("rgb", "t")],
                         ids=["all", "normal", "rgb-t"])
def test_hbm_kernel_route_equals_the_plain_route(hbm_kernel_route, aovs,
                                                 fused):
    scene, params = _box(intersector="pallas-hbm")
    p = _zoomed(params, 0.99)
    chunk = 512
    n_chunks = -(-48 * 32 // chunk)
    want_rgb, got_rgb = [], []
    with pytest.MonkeyPatch.context() as m:  # the plain route
        m.setattr(R, "_kernel_route", lambda *a: False)
        want = R.render(scene, p, chunk_size=chunk, aovs=aovs,
                        progress_callback=lambda i, rgb: want_rgb.append(rgb))
    assert not hbm_kernel_route
    IH.reset_launches()
    # the eager loop, fused or not: its progress callback gets each
    # chunk's rgb, also when rgb is not among the AOVs read back
    eager = R.render(scene, p, chunk_size=chunk, aovs=aovs, fused=fused,
                     progress_callback=lambda i, rgb: got_rgb.append(rgb))
    assert hbm_kernel_route == [chunk] * n_chunks
    assert [a.tobytes() for a in got_rgb] == [a.tobytes() for a in want_rgb]
    # the graph route: a capture, then replays, each adding the frame's
    # glue launches (three a chunk) and K6 queries (two a chunk)
    frames = [R.render(scene, p, chunk_size=chunk, aovs=aovs, fused=fused)
              for _ in range(3)]
    assert (R.graph_captures, R.graph_replays) == (1, 2)
    fg = next(iter(scene._frame_graphs.values()))
    assert (fg.k4_launches, fg.k6_launches, fg.k7_launches,
            fg.glue_launches) == (0, 2 * n_chunks, 0, 3 * n_chunks)
    # the eager frame, the capture's eager frame and two replays
    assert sh.glue_launches == 4 * 3 * n_chunks
    assert IH.launches == 4 * 2 * n_chunks and sh.launches == 0
    for out in [eager] + frames:
        assert _same(out, want)
    key = next(iter(scene._frame_graphs))
    assert key[-1] == "pallas-hbm"


def test_graph_key_holds_the_intersector(bvh_kernel_route):
    """A frame of one shape captured through the BVH is not replayed for
    the fused route's parameters (the key holds the intersector)."""
    scene, params = _box(intersector="bvh")
    R.render(scene, params, chunk_size=512)
    key = next(iter(scene._frame_graphs))
    assert key[-1] == "bvh" and key[:-1] == (
        scene.device, 48, 32, 0, 0, 48, 32, 512, tuple(R._AOVS))


# ---- the wrappers raise before anything is launched ----

def _prologue_args(R_=3000, nb=8):
    f32, i32 = torch.float32, torch.int32
    nrb = -(-R_ // 1024)
    return dict(baabb=torch.zeros((nb, 8)),
                rays=torch.zeros((8, nrb * 1024)),
                counts=torch.zeros(nrb, dtype=i32),
                order=torch.zeros((nrb, nb), dtype=i32),
                dists=torch.zeros((nrb, nb), dtype=f32),
                dirs=torch.ones((R_, 3)))


PROLOGUE_FAULTS = {
    "device": ({}, "must be a CUDA tensor"),
    "dtype": ({"rays": torch.zeros((8, 3072), dtype=torch.float64)},
              "rays must be torch.float32"),
    "shape": ({"order": torch.zeros((3, 9), dtype=torch.int32)},
              "order must have shape"),
    "contiguous": ({"dirs": torch.ones((3, 3000)).t()},
                   "dirs must be contiguous"),
    "idtype": ({"counts": torch.zeros(3)}, "counts must be torch.int32"),
}


@pytest.fixture
def no_launch(monkeypatch):
    def load():
        raise AssertionError("launched")

    monkeypatch.setattr(build, "load", load)


@pytest.mark.parametrize("fault", list(PROLOGUE_FAULTS))
def test_prologue_wrapper_raises_without_launching(no_launch, fault):
    change, match = PROLOGUE_FAULTS[fault]
    args = dict(_prologue_args(), **change)
    with pytest.raises(ValueError, match=match):
        build.launch_rays_cull(args["baabb"], args["rays"], args["counts"],
                               args["order"], args["dists"], R=3000,
                               dirs=args["dirs"])


def test_prologue_wrapper_takes_one_form_of_rays(no_launch):
    a = _prologue_args()
    cam = (torch.zeros(3000), torch.zeros(3000), 0.5, 0.5, 1.0, -1.0)
    lists = (a["baabb"], a["rays"], a["counts"], a["order"], a["dists"])
    with pytest.raises(ValueError, match="either"):
        build.launch_rays_cull(*lists, R=3000, camera=cam, dirs=a["dirs"])
    with pytest.raises(ValueError, match="either"):
        build.launch_rays_cull(*lists, R=3000)
    with pytest.raises(ValueError, match="origin"):
        build.launch_rays_cull(*lists, R=3000, camera=cam,
                               origins=a["dirs"])
    with pytest.raises(ValueError, match="sx must have shape"):
        build.launch_rays_cull(*lists, R=3000, camera=cam[:4] + (
            torch.ones(1), torch.ones(())))


def _shade_outs(R_):
    return {k: torch.empty((R_,) + s, dtype=dt)
            for k, (s, dt) in build.SHADE_OUTS.items()}


SHADE_FAULTS = {
    "device": ({}, {}, "must be a CUDA tensor"),
    "dtype": ({"out_i": torch.zeros((4, 1024))}, {},
              "out_i must be torch.int32"),
    "shape": ({}, {"rgb": torch.empty((600, 4))}, "rgb must have shape"),
    "contiguous": ({}, {"normal": torch.empty((3, 600)).t()},
                   "normal must be contiguous"),
    "escaped": ({}, {"escaped": torch.empty(600, dtype=torch.uint8)},
                "escaped must be torch.bool"),
    "name": ({}, {"albedo": torch.empty((600, 3))}, "no such AOV"),
    "rays": ({"R_": 1025}, {}, "do not fit"),
}


@pytest.mark.parametrize("fault", list(SHADE_FAULTS))
def test_epilogue_wrapper_raises_without_launching(no_launch, fault):
    scene, _ = _box()
    change, outs_change, match = SHADE_FAULTS[fault]
    args = dict(rays=torch.zeros((8, 1024)), out_f=torch.zeros((4, 1024)),
                out_i=torch.zeros((4, 1024), dtype=torch.int32), R_=600)
    args.update(change)
    outs = dict(_shade_outs(600), **outs_change)
    with pytest.raises(ValueError, match=match):
        build.launch_shade(scene, args["rays"], args["out_f"], args["out_i"],
                           outs, R=args["R_"], light=LIGHT, ambient=AMBIENT,
                           zero_origin=True)


def _bvh_args(R_=600):
    f32, i32 = torch.float32, torch.int32
    return dict(dirs=torch.ones((R_, 3)), hit_t=torch.zeros(R_),
                hit_geom=torch.zeros(R_, dtype=i32),
                hit_prim=torch.zeros(R_, dtype=i32),
                sorig=torch.zeros((R_, 3)), sdir=torch.zeros((R_, 3)),
                dist=torch.zeros(R_), normal=torch.zeros((R_, 3)),
                occ=torch.zeros(R_, dtype=i32), origins=None,
                t_min=torch.zeros(R_, dtype=f32), t_max=torch.zeros(R_))


def _bvh_rays(a):
    cam = (torch.zeros(600), torch.zeros(600), 0.5, 0.5, 1.0, -1.0)
    build.launch_bvh_rays(a["t_min"], a["t_max"], zeros=a["sorig"],
                          dirs=a["dirs"], camera=cam)


def _bvh_light(a, scene):
    build.launch_bvh_light(scene, a["dirs"], a["hit_t"], a["hit_geom"],
                           a["hit_prim"], a["sorig"], a["sdir"], a["dist"],
                           a["normal"], origins=a["origins"], light=LIGHT)


def _bvh_shade(a, scene, outs=None):
    build.launch_bvh_shade(scene, a["dirs"], a["hit_t"], a["hit_geom"],
                           a["hit_prim"], a["normal"], a["occ"],
                           _shade_outs(600) if outs is None else outs,
                           origins=a["origins"], light=LIGHT,
                           ambient=AMBIENT)


BVH_FAULTS = {
    "rays-device": (_bvh_rays, {}, "must be a CUDA tensor"),
    "rays-dtype": (_bvh_rays, {"t_max": torch.zeros(600, dtype=torch.float64)},
                   "t_max must be torch.float32"),
    "rays-shape": (_bvh_rays, {"dirs": torch.ones((600, 4))},
                   "dirs must have shape"),
    "rays-contiguous": (_bvh_rays, {"sorig": torch.zeros((3, 600)).t()},
                        "zeros must be contiguous"),
    "rays-empty": (_bvh_rays, {"t_min": torch.zeros(0)}, "no ray"),
    "light-device": (_bvh_light, {}, "must be a CUDA tensor"),
    "light-hit-dtype": (_bvh_light, {"hit_geom": torch.zeros(600)},
                        "hit_geom must be torch.int32"),
    "light-origins": (_bvh_light, {"origins": torch.zeros((599, 3))},
                      "origins must have shape"),
    "light-out": (_bvh_light, {"dist": torch.zeros((600, 1))},
                  "dist must have shape"),
    "shade-device": (_bvh_shade, {}, "must be a CUDA tensor"),
    "shade-occ": (_bvh_shade, {"occ": torch.zeros(600, dtype=torch.bool)},
                  "occ must be torch.int32"),
    "shade-normal": (_bvh_shade, {"normal": torch.zeros((3, 600)).t()},
                     "hit_normal must be contiguous"),
}


@pytest.mark.parametrize("fault", list(BVH_FAULTS))
def test_bvh_wrappers_raise_without_launching(no_launch, fault):
    scene, _ = _box(intersector="bvh")
    fn, change, match = BVH_FAULTS[fault]
    a = dict(_bvh_args(), **change)
    with pytest.raises(ValueError, match=match):
        fn(a) if fn is _bvh_rays else fn(a, scene)


def test_bvh_wrappers_refuse_scenes_and_aovs_without_launching(no_launch):
    a = _bvh_args()
    with pytest.raises(ValueError, match="threaded BVH"):
        _bvh_light(a, _box()[0])  # a VMEM-mode scene carries no BVH
    scene, _ = _box(intersector="bvh")
    with pytest.raises(ValueError, match="no such AOV"):
        _bvh_shade(a, scene, dict(_shade_outs(600),
                                  albedo=torch.empty((600, 3))))
    with pytest.raises(ValueError, match="escaped must be torch.bool"):
        _bvh_shade(a, scene, {"escaped": torch.empty(600, dtype=torch.uint8)})
    with pytest.raises(ValueError, match="dirs are written"):
        build.launch_bvh_rays(a["t_min"], a["t_max"], dirs=a["dirs"])


def _hbm_args(R_=600):
    f32, i32 = torch.float32, torch.int32
    Rp, ns = 1024, 1
    return dict(rays=torch.zeros((8, Rp)), k6_t=torch.zeros(Rp),
                k6_i=torch.zeros(Rp, dtype=i32), k6_n=torch.zeros((8, Rp)),
                srays=torch.zeros((8, Rp)), counts=torch.zeros(1, dtype=i32),
                order=torch.zeros((1, ns), dtype=i32),
                dists=torch.zeros((1, ns), dtype=f32),
                hit_f=torch.zeros((4, Rp)), hit_i=torch.zeros((3, Rp),
                                                             dtype=i32),
                R_=R_)


def _hbm_light(a, scene):
    build.launch_hbm_light(scene, a["rays"], a["k6_t"], a["k6_i"], a["k6_n"],
                           a["srays"], a["counts"], a["order"], a["dists"],
                           a["hit_f"], a["hit_i"], R=a["R_"], light=LIGHT,
                           zero_origin=True)


def _hbm_shade(a, scene, outs=None):
    build.launch_hbm_shade(scene, a["rays"], a["hit_f"], a["hit_i"],
                           a["srays"], a["k6_t"], a["k6_i"],
                           _shade_outs(a["R_"]) if outs is None else outs,
                           R=a["R_"], light=LIGHT, ambient=AMBIENT,
                           zero_origin=True)


HBM_FAULTS = {
    "light-device": (_hbm_light, {}, "must be a CUDA tensor"),
    "light-k6-dtype": (_hbm_light, {"k6_i": torch.zeros(1024)},
                       "k6_i must be torch.int32"),
    "light-lists": (_hbm_light, {"order": torch.zeros((1, 2),
                                                      dtype=torch.int32)},
                    "order must have shape"),
    "light-hit": (_hbm_light, {"hit_i": torch.zeros((4, 1024),
                                                    dtype=torch.int32)},
                  "hit_i must have shape"),
    "light-contiguous": (_hbm_light, {"srays": torch.zeros((1024, 8)).t()},
                         "srays must be contiguous"),
    "light-rays": (_hbm_light, {"R_": 1025}, "do not fill"),
    "light-padding": (_hbm_light, {"R_": 0}, "do not fill"),
    "shade-device": (_hbm_shade, {}, "must be a CUDA tensor"),
    "shade-k6-shape": (_hbm_shade, {"k6_t": torch.zeros(1023)},
                       "k6_t must have shape"),
    "shade-hit-dtype": (_hbm_shade, {"hit_f": torch.zeros((4, 1024),
                                                          dtype=torch.int32)},
                        "hit_f must be torch.float32"),
    "shade-rays": (_hbm_shade, {"R_": 1025}, "do not fill"),
}


@pytest.mark.parametrize("fault", list(HBM_FAULTS))
def test_hbm_wrappers_raise_without_launching(no_launch, fault):
    scene, _ = _box(intersector="pallas-hbm")
    fn, change, match = HBM_FAULTS[fault]
    a = dict(_hbm_args(), **change)
    with pytest.raises(ValueError, match=match):
        fn(a, scene)


def test_hbm_shade_wrapper_refuses_aovs_without_launching(no_launch):
    scene, _ = _box(intersector="pallas-hbm")
    a = _hbm_args()
    with pytest.raises(ValueError, match="no such AOV"):
        _hbm_shade(a, scene, dict(_shade_outs(600),
                                  albedo=torch.empty((600, 3))))
    with pytest.raises(ValueError, match="escaped must be torch.bool"):
        _hbm_shade(a, scene, {"escaped": torch.empty(600, dtype=torch.uint8)})
    with pytest.raises(ValueError, match="rgb must have shape"):
        _hbm_shade(a, scene, {"rgb": torch.empty((599, 3))})


def test_hbm_public_functions_on_cpu_tensors_launch_nothing(no_launch):
    scene, params = _box(intersector="pallas-hbm")
    sh.reset_launches()
    IH.reset_launches()
    d = torch.ones((600, 3))
    for o in (None, torch.zeros((600, 3))):
        with pytest.raises(ValueError, match="CUDA tensor"):
            sh.hbm_shadow_trace_cuda(scene, o, d, LIGHT, AMBIENT)
    with pytest.raises(ValueError, match="CUDA tensor"):
        sh.hbm_camera_chunk_cuda(scene, d[:, 0].contiguous(),
                                 d[:, 1].contiguous(), (48, 32),
                                 _scale(params), {}, LIGHT, AMBIENT)
    assert sh.glue_launches == sh.launches == IH.launches == 0
    # no ray: nothing to launch, empty AOVs
    got = sh.hbm_shadow_trace_cuda(scene, None, torch.ones((0, 3)), LIGHT,
                                   AMBIENT)
    assert [t.shape[0] for t in got] == [0] * len(SHADE_FIELDS)
    assert sh.glue_launches == IH.launches == 0


def test_bvh_scene_tables_are_checked_once_a_scene(monkeypatch):
    """The light and shade launchers check a scene's fixed tables at its
    first launch only, and again once a table is another tensor."""
    scene, _ = _box(intersector="bvh")
    seen = []
    monkeypatch.setattr(build, "_on_card", lambda **ts: seen.append(set(ts)))
    for spec in (build._BVH_GEOM, build._BVH_MAT):
        for _ in range(3):
            got = build._scene_tables(scene, spec)
            assert all(got[k] is getattr(scene, k) for k in spec)
        assert seen == [set(spec)]
        seen.clear()
    scene.mat_albedo = scene.mat_albedo.double()
    with pytest.raises(ValueError, match="mat_albedo must be"):
        build._scene_tables(scene, build._BVH_MAT)
    scene.mat_albedo = scene.mat_albedo.float()[:0]
    with pytest.raises(ValueError, match="mat_albedo is empty"):
        build._scene_tables(scene, build._BVH_MAT)


@pytest.mark.parametrize("intersector", ["pallas", "pallas-hbm"])
def test_shade_tables_are_checked_once_a_scene(monkeypatch, intersector):
    """The epilogue's and the HBM glue kernels' id and material tables are
    checked at a scene's first launch only; the counts they must agree on,
    at every launch."""
    scene, _ = _box(intersector=intersector)
    seen = []
    monkeypatch.setattr(build, "_on_card", lambda **ts: seen.append(set(ts)))
    for _ in range(3):
        got = build._shade_tables(scene)
        assert list(got) == list(build._SHADE_TABLES)
        assert all(got[k] is getattr(scene, k) for k in got)
    assert seen == [set(build._SHADE_TABLES)]
    ap = scene.ap
    scene.ap = ap[:scene.sphere_geom.shape[0] + scene.disc_geom.shape[0] - 1]
    with pytest.raises(ValueError, match="exceed its ap rows"):
        build._shade_tables(scene)
    scene.ap = ap
    scene.tri_prim = scene.tri_prim[1:]
    with pytest.raises(ValueError, match="differ in length"):
        build._shade_tables(scene)
    scene.tri_prim = scene.tri_prim.float()
    with pytest.raises(ValueError, match="tri_prim must be torch.int32"):
        build._shade_tables(scene)


def test_bvh_public_functions_on_cpu_tensors_launch_nothing(no_launch):
    scene, params = _box(intersector="bvh")
    sh.reset_launches()
    kb.reset_launches()
    d = torch.ones((600, 3))
    for o in (None, torch.zeros((600, 3))):
        with pytest.raises(ValueError, match="CUDA tensor"):
            sh.bvh_shadow_trace_cuda(scene, o, d, LIGHT, AMBIENT)
    with pytest.raises(ValueError, match="CUDA tensor"):
        sh.bvh_camera_frame_cuda(scene, d[:, 0].contiguous(),
                                 d[:, 1].contiguous(), (48, 32),
                                 _scale(params), {}, 512, LIGHT, AMBIENT)
    assert sh.glue_launches == sh.launches == kb.launches == 0
    # no ray: nothing to launch, empty AOVs
    got = sh.bvh_shadow_trace_cuda(scene, None, torch.ones((0, 3)), LIGHT,
                                   AMBIENT)
    assert [t.shape[0] for t in got] == [0] * len(SHADE_FIELDS)
    assert sh.glue_launches == kb.launches == 0


def test_public_functions_on_cpu_tensors_launch_nothing(no_launch):
    scene, params = _box()
    sh.reset_launches()
    d = torch.ones((600, 3))
    with pytest.raises(ValueError, match="CUDA tensor"):
        sh.shadow_inputs_cuda(scene, None, d)
    with pytest.raises(ValueError, match="CUDA tensor"):
        sh.camera_inputs_cuda(scene, d[:, 0].contiguous(),
                              d[:, 1].contiguous(), (48, 32), _scale(params))
    counts, order, dists, rays = sh.shadow_inputs(scene, None, d)
    with pytest.raises(ValueError, match="CUDA tensor"):
        sh.shade_cuda(scene, rays, torch.zeros((4, 1024)),
                      torch.zeros((4, 1024), dtype=torch.int32), 600, LIGHT,
                      AMBIENT, zero_origin=True)
    assert sh.glue_launches == sh.launches == 0


def test_reset_launches_resets_the_glue_counter():
    sh.launches, sh.glue_launches = 3, 64
    R.graph_replays = 2
    sh.reset_launches()
    R.reset_counters()
    assert sh.launches == sh.glue_launches == R.graph_replays == 0


def test_reset_launches_resets_the_bvh_routes_counters(bvh_kernel_route):
    scene, params = _box(intersector="bvh")
    R.render(scene, params, chunk_size=512)
    R.render(scene, params, chunk_size=512)
    assert (sh.glue_launches, kb.launches, R.graph_replays) == (
        2 * 3, 2 * 2 * 3, 1)
    sh.reset_launches()
    kb.reset_launches()
    R.reset_counters()
    assert sh.glue_launches == kb.launches == R.graph_replays == 0


# ---- on the card ----

@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def frame_scene(cuda_device):
    """Cornell + monkey at 1440^2 on the card (the shadow cell's scene)."""
    return _box(cuda_device, 1440, 1440, MONKEY)


# The stream position of the 1440^2 frame's middle tile (tile row 22,
# column 22 of 45): the chunks the card tests take start there.
MIDDLE = (22 * 45 + 22) * 1024


def _chunk_coords(scene, params, n):
    padded = -(-1440 * 1440 // 65536) * 65536
    rows, cols = pixel_stream(params).coords(scene.device, padded)
    return rows[MIDDLE:MIDDLE + n], cols[MIDDLE:MIDDLE + n]


def _spread_rays(scene, n, seed=5):
    """n random rays from origins spread over the box, a third aimed at
    the spheres and the disc."""
    rng = np.random.default_rng(seed)
    b = scene.baabb.cpu().numpy()
    lo, hi = b[:, 0:3].min(0), b[:, 3:6].max(0)
    o = rng.uniform(lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo),
                    (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    tg = scene.ap.cpu().numpy()[:, 1:4]
    k = n // 3
    d[:k] = (tg[rng.integers(0, len(tg), k)]
             + rng.normal(0, 20, (k, 3)).astype(np.float32) - o[:k])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return (torch.from_numpy(o).to(scene.device),
            torch.from_numpy(d).to(scene.device))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["chunk", "ragged", "dirs", "origins"])
def test_prologue_equals_shadow_inputs(frame_scene, case):
    scene, params = frame_scene
    p = _zoomed(params, 1.0125)
    scale = _scale(p)
    n = 3000 if case in ("ragged", "origins") else 65536
    rows, cols = _chunk_coords(scene, p, n)
    d = scaled_ray_dir(cols, rows, 1440, 1440, *scale)
    sh.reset_launches()
    if case in ("chunk", "ragged"):
        want = sh.shadow_inputs(scene, None, d)
        got = sh.camera_inputs_cuda(scene, rows, cols, (1440, 1440), scale)
        # the factors as 0-d tensors on the card, as a replay reads them
        sc = tuple(torch.full((), v, dtype=torch.float32,
                              device=scene.device) for v in scale)
        got2 = sh.camera_inputs_cuda(scene, rows, cols, (1440, 1440), sc)
        assert all(_bytes(a) == _bytes(b) for a, b in zip(got, got2))
    else:
        o = None
        if case == "origins":
            o, d = _spread_rays(scene, n)
        want = sh.shadow_inputs(scene, o, d)
        got = sh.shadow_inputs_cuda(scene, o, d)
    torch.cuda.synchronize()
    for name, a, b in zip(("counts", "order", "dists", "rays"), got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert _bytes(a) == _bytes(b), name
    assert int(got[0].sum()) > got[0].shape[0]  # several blocks a bundle
    assert sh.glue_launches == (2 if case in ("chunk", "ragged") else 1)


@pytest.mark.cuda
@pytest.mark.parametrize("origins", ["zero", "spread"])
def test_epilogue_equals_shadow_epilogue(frame_scene, origins):
    scene, params = frame_scene
    n = 65536 if origins == "zero" else 3000
    if origins == "zero":
        rows, cols = _chunk_coords(scene, params, n)
        o, d = None, scaled_ray_dir(cols, rows, 1440, 1440, *_scale(params))
    else:
        o, d = _spread_rays(scene, n, seed=11)
    args = sh.shadow_inputs(scene, o, d)
    out_f, out_i = sh.shadow_trace_cuda(scene, *args, light=LIGHT)
    want = sh.shadow_epilogue(scene, o, d, out_f[:, :n], out_i[:, :n],
                              LIGHT, AMBIENT)
    assert int((want[2] != R.INVALID_GEOM_ID).sum()) > n // 4
    sh.reset_launches()
    got = sh.shade_cuda(scene, args[3], out_f, out_i, n, LIGHT, AMBIENT,
                        zero_origin=o is None)
    for k, a, b in zip(SHADE_FIELDS, got, want):
        assert a.dtype == b.dtype and a.shape == b.shape, k
        assert _bytes(a) == _bytes(b), k
    # every subset of the AOVs, written into the rows of larger buffers
    want = dict(zip(SHADE_FIELDS, want))
    for size in range(1, len(SHADE_FIELDS) + 1):
        for subset in itertools.combinations(SHADE_FIELDS, size):
            bufs = {k: torch.full((n + 64,) + want[k].shape[1:], 7,
                                  dtype=want[k].dtype, device=scene.device)
                    for k in subset}
            before = {k: b.clone() for k, b in bufs.items()}
            sh.shade_cuda(scene, args[3], out_f, out_i, n, LIGHT, AMBIENT,
                          zero_origin=o is None,
                          out={k: b[32:32 + n] for k, b in bufs.items()})
            for k, b in bufs.items():
                assert _bytes(b[32:32 + n]) == _bytes(want[k]), (subset, k)
                # the rows around the chunk's are left as they were
                assert torch.equal(b[:32], before[k][:32]), k
                assert torch.equal(b[32 + n:], before[k][32 + n:]), k
    assert sh.glue_launches == 2 ** len(SHADE_FIELDS)


def _plain_frame(scene, params, chunk, fields, f16=False):
    """The frame as the port rendered it before the glue kernels: each
    chunk's ``scaled_ray_dir``, ``shadow_inputs``, K4, ``shadow_epilogue``
    and the stores into the stream-order buffers, then the readback."""
    dev = scene.device
    n = params.window_w * params.window_h
    padded = -(-n // chunk) * chunk
    bufs = R._aov_bufs(fields, padded, dev)
    rows, cols = pixel_stream(params).coords(dev, padded)
    for g0 in range(0, padded, chunk):
        d = scaled_ray_dir(cols[g0:g0 + chunk], rows[g0:g0 + chunk],
                           params.image_width, params.image_height,
                           *_scale(params))
        args = sh.shadow_inputs(scene, None, d)
        f, i = sh.shadow_trace_cuda(scene, *args, light=LIGHT)
        res = dict(zip(SHADE_FIELDS, sh.shadow_epilogue(
            scene, None, d, f[:, :chunk], i[:, :chunk], LIGHT, AMBIENT)))
        for k, b in bufs.items():
            b[g0:g0 + chunk] = res[k]
    return R._read_back(bufs, params, dev, f16)


def _md5(out):
    return [hashlib.md5(getattr(out, k).tobytes()).hexdigest()
            for k in FIELDS]


def _frames_against_plain(scene, params, zooms, chunk=65536, aovs=None,
                          f16=False):
    fields = [k for k in R._AOVS if k == "geom_id" or aovs is None
              or k in aovs]
    n_chunks = -(-params.window_w * params.window_h // chunk)
    R.render(scene, params, chunk_size=chunk, aovs=aovs, readback_f16=f16)
    for z in zooms:
        p = _zoomed(params, z)
        want = _md5(_plain_frame(scene, p, chunk, fields, f16))
        counts = []
        for cb in (None, lambda i, rgb: None):
            sh.reset_launches()
            got = R.render(scene, p, chunk_size=chunk, aovs=aovs,
                           readback_f16=f16, progress_callback=cb)
            counts.append((sh.launches, sh.glue_launches))
            assert _md5(got) == want, (z, "eager" if cb else "replay")
        assert counts == [(n_chunks, 2 * n_chunks)] * 2, counts
    return n_chunks


@pytest.mark.cuda
def test_frames_equal_the_plain_chain_at_12_zooms(frame_scene):
    scene, params = frame_scene
    R.reset_counters()
    n_chunks = _frames_against_plain(scene, params, ZOOMS)
    assert n_chunks == 32
    assert R.graph_captures == 1 and R.graph_replays == len(ZOOMS)
    fg = next(iter(scene._frame_graphs.values()))
    assert (fg.k4_launches, fg.glue_launches) == (32, 64)
    print(f"capture {fg.capture_ms:.1f} ms, {fg.k4_launches} K4 and "
          f"{fg.glue_launches} glue launches a frame")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["240x136", "f16", "normal"])
def test_frames_equal_the_plain_chain(cuda_device, frame_scene, case):
    if case == "240x136":
        scene, params = _box(cuda_device, 240, 136, MONKEY)
        _frames_against_plain(scene, params, ZOOMS[:3], chunk=8192)
    else:
        scene, params = frame_scene
        _frames_against_plain(scene, params, ZOOMS[::5],
                              aovs=("normal",) if case == "normal" else None,
                              f16=case == "f16")
