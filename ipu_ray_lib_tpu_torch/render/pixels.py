"""The pixel stream, the order in which the port renders a window: its
TILE x TILE tiles in raster order, each tile's pixels in raster order
(as in the JAX package, ipu_ray_lib_tpu/render/streaming.py).
Renderers take its coordinates padded with (0, 0) to whole chunks or slot
pools, and put results back in raster order with its inverse on a device
or its host scatter. One stream per window is cached, with its device
copies; a caller that must outlive the cache (a captured CUDA graph reads
its coordinates at every replay) holds the tensors it uses.
"""

from __future__ import annotations

import numpy as np
import torch

TILE = 32  # side of the square tiles that order the pixel stream
CACHE_WINDOWS = 8  # the cache is emptied when it holds more windows

_CACHE: dict = {}


class PixelStream:
    """One window's stream: ``rows`` and ``cols`` (f32 [W*H], stream order)
    and ``order`` (stream position -> raster pixel), with the device
    copies made from them."""

    def __init__(self, width: int, height: int, rows: np.ndarray,
                 cols: np.ndarray, order: np.ndarray):
        self.width, self.height = width, height
        self.rows, self.cols, self.order = rows, cols, order
        self._coords: dict = {}
        self._inverse: dict = {}

    def coords(self, dev, padded: int) -> tuple:
        """(rows, cols) f32 [padded] on ``dev``: the stream, then zeros;
        built once per (device, padded)."""
        hit = self._coords.get((dev, padded))
        if hit is None:
            pad = (0, padded - self.order.size)
            hit = tuple(torch.from_numpy(np.pad(a, pad)).to(dev)
                        for a in (self.rows, self.cols))
            self._coords[(dev, padded)] = hit
        return hit

    def inverse(self, dev) -> torch.Tensor:
        """int32 [W*H] on ``dev``: each raster pixel's stream position
        (``image[p] = stream[inverse[p]]``); built once per device."""
        inv = self._inverse.get(dev)
        if inv is None:
            n = self.order.size
            host = np.empty(n, np.int32)
            host[self.order] = np.arange(n, dtype=np.int32)
            inv = self._inverse[dev] = torch.from_numpy(host).to(dev)
        return inv

    def scatter(self, flat) -> np.ndarray:
        """[H, W, 3] f32 numpy from the stream-order ``flat`` [>= W*H, 3]
        on the host (its padding ignored)."""
        n = self.order.size
        img = np.empty((n, 3), np.float32)
        img[self.order] = flat[:n]
        return img.reshape(self.height, self.width, 3)


def pixel_stream(params) -> PixelStream:
    """The stream of ``params``'s window (``window_w``, ``window_h``,
    ``window_c``, ``window_r``), cached per window."""
    w, h = params.window_w, params.window_h
    key = (w, h, params.window_c, params.window_r)
    hit = _CACHE.get(key)
    if hit is not None:
        return hit
    rr, cc = np.meshgrid(
        np.arange(params.window_r, params.window_r + h),
        np.arange(params.window_c, params.window_c + w),
        indexing="ij",
    )
    rel_r, rel_c = rr - params.window_r, cc - params.window_c
    order = np.lexsort(
        (rel_c.ravel() % TILE, rel_r.ravel() % TILE,
         rel_c.ravel() // TILE, rel_r.ravel() // TILE)
    )
    rows_np = rr.ravel()[order].astype(np.float32)
    cols_np = cc.ravel()[order].astype(np.float32)
    if len(_CACHE) > CACHE_WINDOWS:
        _CACHE.clear()
    _CACHE[key] = hit = PixelStream(w, h, rows_np, cols_np, order)
    return hit
