"""The pixel stream (render/pixels.py), the one owner of the tile order:
its padded coordinates on a device against a tile-by-tile walk of the
window, its inverse, its host scatter, and the cache of one stream per
window with its bound; the shadow readback reuses the cached inverse.
This file imports no JAX.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import dataclasses
import types

import numpy as np
import pytest
import torch

import ipu_ray_lib_tpu_torch.render.renderer as R
from ipu_ray_lib_tpu_torch.render import pixels
from ipu_ray_lib_tpu_torch.render.pixels import TILE, pixel_stream
from ipu_ray_lib_tpu_torch.scene.build import build_scene
from ipu_ray_lib_tpu_torch.scene.builtin import make_cornell_box_scene

CPU = torch.device("cpu")
CHUNK = 1024
# (window_w, window_h, window_c, window_r): whole tiles at an offset, the
# spheres cell's 768x432 (432 is not a whole number of tiles), a 48x64 crop
WINDOWS = {"tiles": (64, 96, 32, 64), "768x432": (768, 432, 0, 0),
           "crop": (48, 64, 17, 5)}


def _window(w, h, c, r):
    return types.SimpleNamespace(window_w=w, window_h=h, window_c=c,
                                 window_r=r)


def _walk(w, h, c, r):
    """(rows, cols) of the window's pixels tile by tile, each tile's pixels
    in raster order: the stream's order, written out."""
    rows, cols = [], []
    for tr in range(0, h, TILE):
        for tc in range(0, w, TILE):
            rr, cc = np.meshgrid(np.arange(tr, min(tr + TILE, h)),
                                 np.arange(tc, min(tc + TILE, w)),
                                 indexing="ij")
            rows.append(rr.ravel() + r)
            cols.append(cc.ravel() + c)
    return np.concatenate(rows), np.concatenate(cols)


@pytest.mark.parametrize("name", list(WINDOWS))
def test_coords_equal_the_host_stream(name):
    w, h, c, r = WINDOWS[name]
    stream = pixel_stream(_window(w, h, c, r))
    n = w * h
    rows, cols = _walk(w, h, c, r)
    assert np.array_equal(stream.rows, rows.astype(np.float32))
    assert np.array_equal(stream.cols, cols.astype(np.float32))
    assert np.array_equal(stream.order, (rows - r) * w + (cols - c))
    padded = -(-n // CHUNK) * CHUNK + CHUNK
    got = stream.coords(CPU, padded)
    for t, host in zip(got, (stream.rows, stream.cols)):
        assert t.dtype == torch.float32 and t.device == CPU
        assert t.shape == (padded,)
        assert np.array_equal(t[:n].numpy(), host)
        assert not t[n:].any()  # zeros past the window
    # built once per (device, padded)
    assert stream.coords(CPU, padded) is got
    unpadded = stream.coords(CPU, n)
    assert unpadded is not got and unpadded[0].shape == (n,)


@pytest.mark.parametrize("name", list(WINDOWS))
def test_inverse_is_the_order_inverted(name):
    stream = pixel_stream(_window(*WINDOWS[name]))
    inv = stream.inverse(CPU)
    assert inv.dtype == torch.int32 and inv.device == CPU
    assert np.array_equal(inv.numpy()[stream.order],
                          np.arange(stream.order.size))
    assert stream.inverse(CPU) is inv


@pytest.mark.parametrize("name", list(WINDOWS))
def test_scatter_puts_each_position_at_its_pixel(name):
    w, h, c, r = WINDOWS[name]
    stream = pixel_stream(_window(w, h, c, r))
    padded = w * h + 100
    # stream position p carries (p, p, p); the padding carries -1
    flat = np.repeat(np.arange(padded, dtype=np.float32)[:, None], 3, 1)
    flat[w * h:] = -1
    img = stream.scatter(flat)
    assert img.shape == (h, w, 3) and img.dtype == np.float32
    pos = img[..., 0].astype(np.int64)
    rows, cols = stream.coords(CPU, padded)
    rr, cc = np.meshgrid(np.arange(r, r + h), np.arange(c, c + w),
                         indexing="ij")
    assert np.array_equal(rows.numpy()[pos], rr.astype(np.float32))
    assert np.array_equal(cols.numpy()[pos], cc.astype(np.float32))


def test_cache_holds_one_stream_per_window():
    pixels._CACHE.clear()
    a = pixel_stream(_window(*WINDOWS["crop"]))
    assert pixel_stream(_window(*WINDOWS["crop"])) is a
    # the window alone is the key
    other = types.SimpleNamespace(**vars(_window(*WINDOWS["crop"])),
                                  image_width=640, fov_radians=0.3)
    assert pixel_stream(other) is a
    w, h, c, r = WINDOWS["crop"]
    for moved in ((w, h, c + 1, r), (w, h, c, r + 1), (w + 1, h, c, r),
                  (w, h + 1, c, r)):
        assert pixel_stream(_window(*moved)) is not a
    assert len(pixels._CACHE) == 5


# ---- the shadow readback's inverse, cached per device and window ----

@pytest.fixture(scope="module")
def boxes():
    scene, params = build_scene(make_cornell_box_scene(None, box_only=False),
                                device="cpu", image_width=64, image_height=64,
                                intersector="pallas")
    crop, cparams = build_scene(make_cornell_box_scene(None, box_only=False),
                                device="cpu", image_width=48, image_height=32,
                                intersector="pallas")
    cparams = dataclasses.replace(cparams, window_w=17, window_h=13,
                                  window_c=5, window_r=9)
    return {"tiles": (scene, params), "crop": (crop, cparams)}


def test_inverse_cached_per_device_and_window(boxes):
    pixels._CACHE.clear()
    views = {}
    for name in ("tiles", "crop", "tiles", "crop"):
        scene, params = boxes[name]
        inv = pixel_stream(params).inverse(CPU)
        out = R.render(scene, params, chunk_size=CHUNK)
        assert out.hit_count > 0
        assert pixel_stream(params).inverse(CPU) is inv  # render's own
        views.setdefault(name, inv)
        assert views[name] is inv  # built once per (device, window)
        order = pixel_stream(params).order
        assert inv.dtype == torch.int32 and inv.device == CPU
        assert np.array_equal(inv.numpy()[order], np.arange(order.size))
    assert len(pixels._CACHE) == 2
    # a window of the same size elsewhere in the image is another key
    scene, params = boxes["crop"]
    moved = dataclasses.replace(params, window_c=params.window_c + 1)
    assert pixel_stream(moved).inverse(CPU) is not views["crop"]
    assert len(pixels._CACHE) == 3


def test_inverse_cache_is_bounded():
    pixels._CACHE.clear()
    for i in range(20):
        pixel_stream(_window(8 + i, 4, 0, 0)).inverse(CPU)
        assert len(pixels._CACHE) <= pixels.CACHE_WINDOWS + 1
