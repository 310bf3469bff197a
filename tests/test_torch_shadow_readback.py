"""The shadow frame's readback (render/renderer.py ``_read_back``): the
AOVs gathered to raster order on the scene's device with the pixel
stream's cached inverse (render/pixels.py), packed into one buffer, ``geom_id``'s
``INVALID_GEOM_ID`` made -1 there, and on a CUDA scene one copy into
pinned host memory; the returned arrays are views of the host buffer.

Every comparison is of the bytes (``tobytes``) against the host scatter
the readback replaced (``_host_scatter``: an int64 inverse rebuilt on the
host, one ``index_select`` and one ``.cpu()`` per AOV, the geom-id fix in
NumPy), applied to the very buffers ``render`` read back. This file
imports no JAX, so the card's test runs without the conftest::

    python -m pytest --noconftest -p no:cacheprovider -m cuda -s \\
        tests/test_torch_shadow_readback.py
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import hashlib
import os
import types

import numpy as np
import pytest
import torch

import ipu_ray_lib_tpu_torch.render.renderer as R
from ipu_ray_lib_tpu_torch.bvh.builder import INVALID_GEOM_ID
from ipu_ray_lib_tpu_torch.render.pixels import pixel_stream
from ipu_ray_lib_tpu_torch.scene.build import build_scene
from ipu_ray_lib_tpu_torch.scene.builtin import make_cornell_box_scene

ROOT = os.path.join(os.path.dirname(__file__), "..")
MONKEY = os.path.join(ROOT, "assets", "monkey_bust.glb")
FIELDS = R.RenderOutput._fields
CHUNK = 1024
# (width, height, window): whole 32-pixel tiles, and a crop window that
# is not (its last chunk padded)
WINDOWS = {"tiles": (64, 64, None), "crop": (48, 32, (17, 13, 5, 9))}
AOV_SETS = (None, ("normal",), ("rgb", "t", "hit_p"))


def _host_scatter(bufs: dict, params, f16: bool) -> dict:
    """The readback as it was: the inverse permutation rebuilt on the host
    as int64, each AOV gathered and copied to the host on its own, the
    geom-id fix in NumPy."""
    h, w = params.window_h, params.window_w
    total = w * h
    inverse = np.empty(total, np.int64)
    inverse[pixel_stream(params).order] = np.arange(total)
    inv = torch.from_numpy(inverse).to(next(iter(bufs.values())).device)
    out = {}
    for k, (shape, dt, _) in R._AOVS.items():
        if k in bufs:
            a = bufs[k][:total].index_select(0, inv)
            if a.is_floating_point():
                a = R._prep_f(a, f16)
            a = a.cpu().numpy().astype(R._NP[dt], copy=False)
        else:
            a = R._filled(k, total)
        out[k] = a.reshape((h, w) + shape)
    g = out["geom_id"]
    out["geom_id"] = np.where(g == INVALID_GEOM_ID, -1, g).astype(np.int32)
    return out


def _assert_equal(got: R.RenderOutput, want: dict) -> None:
    for k in FIELDS:
        a, b = getattr(got, k), want[k]
        assert (a.shape, a.dtype) == (b.shape, b.dtype), k
        assert a.flags.c_contiguous, k
        assert a.tobytes() == b.tobytes(), k


def _zoomed(params, zoom):
    return dataclasses.replace(params, fov_radians=params.fov_radians * zoom)


def _box(w, h, window=None, dev="cpu", monkey=None):
    scene, params = build_scene(make_cornell_box_scene(monkey, box_only=False),
                                device=dev, image_width=w, image_height=h,
                                intersector="pallas")
    if window is not None:
        ww, wh, wc, wr = window
        params = dataclasses.replace(params, window_w=ww, window_h=wh,
                                     window_c=wc, window_r=wr)
    return scene, params


@pytest.fixture(scope="module")
def boxes():
    return {name: _box(*v) for name, v in WINDOWS.items()}


@pytest.fixture
def spy(monkeypatch):
    """``render``'s readbacks, each beside the host scatter of the same
    buffers (taken first, from the buffers as the frame left them)."""
    seen, real = [], R._read_back

    def read_back(bufs, params, dev, f16):
        want = _host_scatter(bufs, params, f16)
        got = real(bufs, params, dev, f16)
        seen.append((got, want, bufs))
        return got

    monkeypatch.setattr(R, "_read_back", read_back)
    R.reset_counters()
    return seen


@pytest.fixture
def stubbed(monkeypatch):
    """The CPU taken for a card by the graph route's rule, with a capture
    whose "graph" replays by running the body again (as in
    tests/test_torch_shadow_graph.py): the route's AOV buffers then
    outlive the frame, as a captured graph's do."""
    route = R._graph_route

    def capture(body, dev):
        return types.SimpleNamespace(replay=body), 0.0

    monkeypatch.setattr(R, "_graph_route", lambda device, *a: route(
        torch.device("cuda") if device.type == "cpu" else device, *a))
    monkeypatch.setattr(R, "_capture", capture)
    R.reset_counters()


# ---- the readback equals the host scatter, bit for bit ----

@pytest.mark.parametrize("f16", [False, True], ids=["f32", "f16"])
@pytest.mark.parametrize("aovs", AOV_SETS, ids=["all", "normal", "rgb-t-hitp"])
@pytest.mark.parametrize("window", list(WINDOWS))
def test_render_equals_the_host_scatter(boxes, spy, window, aovs, f16):
    scene, params = boxes[window]
    out = R.render(scene, params, chunk_size=CHUNK, aovs=aovs,
                   readback_f16=f16)
    ((got, want, bufs),) = spy
    assert got is out
    _assert_equal(out, want)
    assert set(bufs) == {k for k in FIELDS if k == "geom_id" or aovs is None
                         or k in aovs}
    assert out.hit_count > 0
    assert R.pinned_readbacks == 0  # a CPU scene copies nothing


@pytest.mark.parametrize("f16", [False, True], ids=["f32", "f16"])
def test_extreme_values_equal_the_host_scatter(f16):
    """Buffers no frame makes: NaN, +-inf, finite values past the f16
    range, every id at INVALID_GEOM_ID or -1 on some pixels, garbage in
    the padding; read back with every set of AOVs (``geom_id`` always)."""
    # an odd pixel count: f16 segments of odd length before int32 ones
    params = types.SimpleNamespace(window_w=41, window_h=23, window_c=3,
                                   window_r=7)
    total, padded = 41 * 23, 1024
    g = torch.Generator().manual_seed(7)
    bufs = R._aov_bufs(FIELDS, padded, torch.device("cpu"))
    for k, b in bufs.items():
        if b.is_floating_point():
            b.copy_(torch.randn(b.shape, generator=g) * 3e4)
            flat = b.view(-1)
            flat[::7] = np.inf
            flat[1::11] = -np.inf
            flat[2::13] = np.nan
            flat[3::5] = 1e30
            flat[4::9] = -7e4
        else:
            b.copy_(torch.randint(-1, 70000, b.shape, generator=g,
                                  dtype=torch.int32))
            b[::3] = INVALID_GEOM_ID
            b[1::4] = -1
    got = R._read_back(bufs, params, torch.device("cpu"), f16)
    want = _host_scatter(bufs, params, f16)
    _assert_equal(got, want)
    assert (got.geom_id != INVALID_GEOM_ID).all()
    assert (got.prim_id == INVALID_GEOM_ID).any()  # only geom_id is fixed
    assert total < padded
    others = [k for k in FIELDS if k != "geom_id"]
    for mask in range(2 ** len(others)):
        sub = {k: bufs[k] for i, k in enumerate(others) if mask >> i & 1}
        sub["geom_id"] = bufs["geom_id"]
        sub = {k: sub[k] for k in FIELDS if k in sub}  # render's order
        _assert_equal(R._read_back(sub, params, torch.device("cpu"), f16),
                      _host_scatter(sub, params, f16))


def test_geom_id_is_minus_one_on_misses(boxes):
    scene, params = boxes["tiles"]
    out = R.render(scene, params, chunk_size=CHUNK)
    miss = np.isinf(out.t)
    assert miss.any() and (~miss).any()
    assert (out.geom_id[miss] == -1).all()
    assert (out.geom_id[~miss] >= 0).all()
    assert not (out.geom_id == INVALID_GEOM_ID).any()


# ---- the returned arrays: views of the host buffer, never reused ----

def _frames_a_b(scene, params):
    a = R.render(scene, params, chunk_size=CHUNK)
    before = {k: getattr(a, k).tobytes() for k in FIELDS}
    b = R.render(scene, _zoomed(params, 0.97), chunk_size=CHUNK)
    return a, before, b


@pytest.mark.parametrize("route", ["eager", "graph"])
def test_earlier_frames_are_not_overwritten(boxes, request, route):
    if route == "graph":
        request.getfixturevalue("stubbed")
        scene, params = _box(64, 64)  # a scene of its own, with graphs
    else:
        scene, params = boxes["tiles"]
    a, before, b = _frames_a_b(scene, params)
    if route == "graph":
        assert (R.graph_captures, R.graph_replays) == (1, 1)
    assert {k: getattr(a, k).tobytes() for k in FIELDS} == before
    assert not all(getattr(a, k).tobytes() == getattr(b, k).tobytes()
                   for k in FIELDS)  # the zoom moves the frame
    for k in FIELDS:
        assert not np.shares_memory(getattr(a, k), getattr(b, k)), k
    # nor any buffer of the frame's chunk loop, which a replay refills
    for fg in scene.__dict__.get("_frame_graphs", {}).values():
        for t in fg.bufs.values():
            for k in FIELDS:
                assert not np.shares_memory(getattr(b, k), t.numpy()), k


def test_arrays_are_views_of_one_host_buffer(boxes):
    scene, params = boxes["tiles"]
    out = R.render(scene, params, chunk_size=CHUNK)
    bases = [getattr(out, k).base for k in FIELDS]
    assert all(isinstance(t, torch.Tensor) for t in bases)
    assert len({t.untyped_storage().data_ptr() for t in bases}) == 1
    # f16: the float AOVs widened on the host; the ids stay views
    h = R.render(scene, params, chunk_size=CHUNK, readback_f16=True)
    assert isinstance(h.geom_id.base, torch.Tensor)
    assert h.rgb.dtype == np.float32 and h.rgb.base is None


# ---- on the card: the pinned route ----

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _md5(out) -> list:
    get = out.__getitem__ if isinstance(out, dict) else out.__getattribute__
    return [hashlib.md5(get(k).tobytes()).hexdigest() for k in FIELDS]


@pytest.mark.cuda
def test_pinned_readback_on_the_card(cuda_device, spy):
    scene, params = _box(256, 256, dev=cuda_device, monkey=MONKEY)
    chunk = 8192
    held = []
    for i, z in enumerate((1.0, 0.97, 1.03)):
        p = _zoomed(params, z)
        # a progress callback keeps the loop on the host: the eager route
        want = R.render(scene, p, chunk_size=chunk,
                        progress_callback=lambda i, rgb: None)
        n = R.pinned_readbacks
        got = R.render(scene, p, chunk_size=chunk)
        assert R.pinned_readbacks == n + 1 == 2 * (i + 1)
        assert _md5(got) == _md5(want), z
        for g, w, _ in spy[-2:]:
            assert _md5(g) == _md5(w), z  # each against the host scatter
        assert got.hit_count > 0
        for k in FIELDS:
            a = getattr(got, k)
            assert isinstance(a.base, torch.Tensor) and a.base.is_pinned(), k
        held.append((got, _md5(got)))
    f16 = R.render(scene, params, chunk_size=chunk, readback_f16=True)
    assert _md5(f16) == _md5(spy[-1][1])
    # frames held by the caller are never overwritten
    for out, md5 in held:
        assert _md5(out) == md5
    assert R.graph_replays >= 2
