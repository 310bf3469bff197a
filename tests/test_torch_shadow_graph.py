"""The shadow frame's CUDA graph route (render/renderer.py): which
``render`` calls take it, the frame body it captures, run with the image
plane's factors as 0-d tensors, and the per-scene cache of captured
frames. On the CPU the capture is stubbed: the "graph" replays by running
the body again, so the route's plumbing, its keys and its bound run here
as on the card. On the card (marked ``cuda``) replayed frames, of a
window of whole tiles and of one that is not, are held to the eager
loop's, bit for bit (md5), with the same K4 launch counts.

Every comparison is of the bytes (``tobytes``): the graph changes how the
work is dispatched, not what is computed. This file imports no JAX, so
the card's test runs without the conftest::

    python -m pytest --noconftest -p no:cacheprovider -m cuda -s \\
        tests/test_torch_shadow_graph.py
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import gc
import hashlib
import os
import types
import weakref

import numpy as np
import pytest
import torch

import ipu_ray_lib_tpu_torch.render.renderer as R
from ipu_ray_lib_tpu_torch.bvh.builder import INVALID_GEOM_ID
from ipu_ray_lib_tpu_torch.ops import shadow as sh
from ipu_ray_lib_tpu_torch.ops.camera import plane_scale, tan_half_fov
from ipu_ray_lib_tpu_torch.render import pixels
from ipu_ray_lib_tpu_torch.render.pixels import pixel_stream
from ipu_ray_lib_tpu_torch.scene.build import build_scene
from ipu_ray_lib_tpu_torch.scene.builtin import make_cornell_box_scene

ROOT = os.path.join(os.path.dirname(__file__), "..")
MONKEY = os.path.join(ROOT, "assets", "monkey_bust.glb")
FIELDS = R.RenderOutput._fields
SIZE, CHUNK = 64, 1024
ZOOMS = (1.0, 0.97)


def _zoomed(params, zoom):
    return dataclasses.replace(params, fov_radians=params.fov_radians * zoom)


def _same(a: R.RenderOutput, b: R.RenderOutput) -> bool:
    return all(getattr(a, k).tobytes() == getattr(b, k).tobytes()
               for k in FIELDS)


@pytest.fixture(scope="module")
def box():
    return build_scene(make_cornell_box_scene(None, box_only=False),
                       device="cpu", image_width=SIZE, image_height=SIZE,
                       intersector="pallas")


@pytest.fixture(scope="module")
def eager(box):
    """The eager loop's frames at ZOOMS (a CPU scene takes no graph)."""
    scene, params = box
    outs = [R.render(scene, _zoomed(params, z), chunk_size=CHUNK)
            for z in ZOOMS]
    assert "_frame_graphs" not in scene.__dict__
    return outs


@pytest.fixture
def stubbed(monkeypatch):
    """The CPU taken for a card by the route rule, and a capture whose
    "graph" replays by running the body again; yields the devices of
    the captures made."""
    route, made = R._graph_route, []

    def capture(body, dev):
        made.append(dev)
        return types.SimpleNamespace(replay=body), 0.0

    monkeypatch.setattr(R, "_graph_route", lambda device, *a: route(
        torch.device("cuda") if device.type == "cpu" else device, *a))
    monkeypatch.setattr(R, "_capture", capture)
    sh.reset_launches()
    R.reset_counters()
    return made


def _fresh_box():
    return build_scene(make_cornell_box_scene(None, box_only=False),
                       device="cpu", image_width=SIZE, image_height=SIZE,
                       intersector="pallas")


# ---- the frame body with the plane's factors as 0-d tensors ----

@pytest.mark.parametrize("zi", range(len(ZOOMS)))
def test_frame_body_with_tensor_factors_equals_render(box, eager, zi):
    scene, params = box
    p = _zoomed(params, ZOOMS[zi])
    total = SIZE * SIZE
    padded = -(-total // CHUNK) * CHUNK
    bufs = R._aov_bufs(FIELDS, padded, scene.device)
    scale = tuple(torch.full((), v, dtype=torch.float32)
                  for v in plane_scale(p.image_width, p.image_height,
                                       tan_half_fov(p.fov_radians)))
    stream = pixel_stream(p)
    R._shadow_chunks(scene, p, CHUNK, bufs, scale,
                     stream.coords(scene.device, padded))
    order = stream.order
    want = eager[zi]
    for k in FIELDS:
        got = bufs[k][:total].numpy()
        if k == "geom_id":
            got = np.where(got == INVALID_GEOM_ID, -1, got).astype(np.int32)
        w = getattr(want, k).reshape((total,) + got.shape[1:])[order]
        assert got.tobytes() == w.tobytes(), k
    assert not _same(eager[0], eager[1])  # the zoom moves the frame


# ---- which calls take the graph route ----

# The window (w, h) is not part of the rule: windows of whole tiles and
# others take the graph alike.
@pytest.mark.parametrize("device, fused, intersector, callback, w, h, graph", [
    ("cuda", True, "pallas", None, 1440, 1440, True),
    ("cuda:0", True, "pallas", None, 64, 64, True),
    ("cuda", True, "pallas", None, 768, 416, True),
    ("cpu", True, "pallas", None, 1440, 1440, False),
    ("cuda", False, "pallas", None, 1440, 1440, False),
    ("cuda", True, "pallas-hbm", None, 1440, 1440, True),
    ("cuda", False, "pallas-hbm", None, 1440, 1440, True),
    ("cuda", True, "pallas-hbm", print, 1440, 1440, False),
    ("cpu", True, "pallas-hbm", None, 1440, 1440, False),
    ("cuda", True, "bvh", None, 1440, 1440, True),
    ("cuda", False, "bvh", None, 1440, 1440, True),
    ("cuda", True, "bvh", print, 1440, 1440, False),
    ("cuda", True, "dense", None, 1440, 1440, False),
    ("cuda", True, "pallas", print, 1440, 1440, False),
    ("cuda", True, "pallas", None, 768, 432, True),
    ("cuda", True, "pallas", None, 48, 64, True),
])
def test_route_choice(device, fused, intersector, callback, w, h, graph):
    assert R._graph_route(torch.device(device), fused, intersector,
                          callback) is graph


def test_calls_the_rule_keeps_eager_capture_nothing(stubbed):
    scene, params = _fresh_box()
    R.render(scene, params, chunk_size=CHUNK,
             progress_callback=lambda i, rgb: None)
    R.render(scene, params, chunk_size=CHUNK, fused=False)
    assert not stubbed and R.graph_captures == 0
    assert "_frame_graphs" not in scene.__dict__


# ---- the route end to end, with the capture stubbed ----

def test_replays_equal_the_eager_loop(box, eager, stubbed):
    scene, params = _fresh_box()
    outs = [R.render(scene, _zoomed(params, z), chunk_size=CHUNK)
            for z in ZOOMS + ZOOMS[::-1]]
    assert stubbed == [scene.device]
    assert (R.graph_captures, R.graph_replays) == (1, 3)
    for out, want in zip(outs, eager + eager[::-1]):
        assert _same(out, want)
    assert len(scene._frame_graphs) == 1  # the fov is not in the key


def test_non_tile_window_replays_after_the_stream_cache_clears(stubbed):
    """A window that is not made of whole tiles (48x32, its last chunk
    padded) takes the graph too; its replays equal the eager loop byte
    for byte, also when the stream cache dropped the coordinates the
    graph reads between the capture and the replay: the captured frame
    holds them."""
    scene, params = build_scene(make_cornell_box_scene(None, box_only=False),
                                device="cpu", image_width=48, image_height=32,
                                intersector="pallas")
    frames = [_zoomed(params, z) for z in ZOOMS]
    # a progress callback keeps the loop on the host: the eager route
    want = [R.render(scene, p, chunk_size=CHUNK,
                     progress_callback=lambda i, rgb: None) for p in frames]
    got = [R.render(scene, frames[0], chunk_size=CHUNK)]
    assert stubbed == [scene.device] and R.graph_captures == 1
    fg = next(iter(scene._frame_graphs.values()))
    padded = -(-48 * 32 // CHUNK) * CHUNK
    assert fg.coords is pixel_stream(params).coords(scene.device, padded)
    pixels._CACHE.clear()
    gc.collect()
    assert pixel_stream(params).coords(scene.device, padded) is not fg.coords
    got += [R.render(scene, p, chunk_size=CHUNK) for p in frames[::-1]]
    assert (R.graph_captures, R.graph_replays) == (1, 2)
    for out, w in zip(got, want[:1] + want[::-1]):
        assert _same(out, w)
    assert not _same(want[0], want[1])  # the zoom moves the frame


def test_keys_and_bound(box, eager, stubbed):
    scene, params = _fresh_box()
    cache = lambda: scene.__dict__["_frame_graphs"]
    R.render(scene, params, chunk_size=CHUNK)
    # readback_f16 rounds after the graph: the same key
    f16 = R.render(scene, params, chunk_size=CHUNK, readback_f16=True)
    assert (R.graph_captures, R.graph_replays) == (1, 1)
    assert f16.geom_id.tobytes() == eager[0].geom_id.tobytes()
    # another AOV set, another chunk size: a new key each
    normals = R.render(scene, params, chunk_size=CHUNK, aovs=("normal",))
    assert normals.normal.tobytes() == eager[0].normal.tobytes()
    assert not normals.rgb.any()
    R.render(scene, params, chunk_size=2 * CHUNK)
    assert R.graph_captures == 3 and len(cache()) == 3
    # GRAPH_KEYS at most, the least recently used dropped first
    first = next(iter(cache()))
    R.render(scene, params, chunk_size=CHUNK)          # a hit: now newest
    assert R.graph_replays == 2 and next(iter(cache())) != first
    for i in range(R.GRAPH_KEYS):
        R.render(scene, params, chunk_size=(3 + i) * CHUNK)
        assert len(cache()) <= R.GRAPH_KEYS
    assert len(cache()) == R.GRAPH_KEYS
    assert [k[7] for k in cache()] == [(3 + i) * CHUNK
                                       for i in range(R.GRAPH_KEYS)]
    assert R.graph_captures == 3 + R.GRAPH_KEYS


def test_cache_goes_with_the_scene(stubbed):
    scene, params = _fresh_box()
    R.render(scene, params, chunk_size=CHUNK)
    bufs = next(iter(scene._frame_graphs.values())).bufs
    refs = [weakref.ref(t) for t in bufs.values()]
    del bufs
    # a copy of the scene is a new scene, with no frames of its own
    assert "_frame_graphs" not in scene.to("cpu").__dict__
    del scene
    gc.collect()
    assert all(r() is None for r in refs)


# ---- on the card: replayed frames against the eager loop ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _md5(out: R.RenderOutput) -> list:
    return [hashlib.md5(getattr(out, k).tobytes()).hexdigest()
            for k in FIELDS]


@pytest.mark.cuda
@pytest.mark.parametrize("w, h", [(256, 256), (240, 136)],
                         ids=["tiles", "not-tiles"])
def test_replayed_frames_equal_eager_on_the_card(cuda_device, w, h):
    scene, params = build_scene(
        make_cornell_box_scene(MONKEY, box_only=False), device=cuda_device,
        image_width=w, image_height=h, intersector="pallas")
    chunk = 8192
    sh.reset_launches()
    R.reset_counters()
    n = {}
    for z in (1.0, 0.97, 1.03):
        p = _zoomed(params, z)
        sh.launches = 0
        # a progress callback keeps the loop on the host: the eager route
        want = R.render(scene, p, chunk_size=chunk,
                        progress_callback=lambda i, rgb: None)
        n["eager"] = sh.launches
        sh.launches = 0
        got = R.render(scene, p, chunk_size=chunk)
        n["graph"] = sh.launches
        assert _md5(got) == _md5(want), z
        assert n["eager"] == n["graph"] == -(-w * h // chunk), n
        assert got.hit_count > 0
    assert (R.graph_captures, R.graph_replays) == (1, 2)
    fg = next(iter(scene._frame_graphs.values()))
    print(f"capture {fg.capture_ms:.1f} ms, {fg.k4_launches} K4 launches")
