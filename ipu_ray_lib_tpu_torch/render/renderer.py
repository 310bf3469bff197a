"""Render orchestration: the chunked shadow trace with its AOVs, and the
path trace, one-shot or progressive.

Port of ``render`` (ipu_ray_lib_tpu/render/renderer.py:152). In
shadow-trace mode (the default) the window's pixels are streamed in tile
order (32x32 tiles, ``render/streaming.py:_pixel_stream``), in chunks of
``chunk_size`` rays padded to a whole chunk: a chunk's camera rays, the
fused shadow kernel (K4) and its epilogue run on the scene's device and
write into per-AOV buffers there (or, on the glue route, the closest-hit
kernels K5/K6 twice with the shading between; render/shadow.py). For a window whose sides are multiples
of the tile, each chunk's pixel coordinates are computed on the device
(``_tile_coords``); otherwise they are uploaded. The chunk size decides
where the bundles of 1,024 rays fall when it is not a multiple of 1,024,
so it is kept as in the JAX package. At the end the requested AOVs are
put back in raster order on the device and copied to the host as
[H, W, ...] numpy; the others come back filled (zeros, t = inf, prim
-1). ``geom_id`` is always read back.

In path-trace mode ``render`` runs :func:`render_streaming` once; with a
progress callback it renders decorrelated batches of at most 16 samples
(batch ``bi`` seeded ``rng_seed + 0x9E3779B9*bi``) and passes the running
average to the callback after each (the JAX package's progressive mode,
renderer.py:181-210). With ``streaming=False`` it runs the per-sample
wavefront instead (renderer.py:216-340, ``_path_chunk`` :95-146): the
tile-ordered stream in chunks as the shadow trace takes it, chunk ci
keyed ``fold_in(PRNGKey(rng_seed), ci)``, sample s ``fold_in(key, s)``
and its camera jitter ``fold_in(skey, 0xC0FFEE)`` (utils/threefry.py),
each sample one :func:`~.path.path_trace_sample` plus the env term on its
escapes, the chunk's samples summed and scaled by 1/spp. Rays flagged
with an unknown material are counted (padding lanes included, as in the
JAX package) and logged.

``readback_f16`` (the JAX package's ``RAY_READBACK_F16``) rounds the float
AOVs to f16 on the device before they are read back: finite values are
clamped to +-65504 first, true infinities (t of a miss) pass; the ids stay
exact. The path trace's image is rounded likewise (no clamp).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..bvh.builder import INVALID_GEOM_ID
from ..ops.camera import generate_camera_rays
from ..utils import threefry
from ..utils.log import logger
from ..utils.profiling import span
from .path import path_trace_sample
from .shadow import shadow_trace
from .streaming import _pixel_stream, env_term, render_streaming

DEFAULT_CHUNK = 1 << 16
TILE = 32  # pixel tile edge of the ray order (render/streaming.py)

# Each AOV's trailing shape, dtype and fill where it is not read back:
_AOVS = {
    "rgb": ((3,), torch.float32, 0.0),
    "t": ((), torch.float32, np.inf),
    "geom_id": ((), torch.int32, -1),
    "prim_id": ((), torch.int32, -1),
    "normal": ((3,), torch.float32, 0.0),
    "hit_p": ((3,), torch.float32, 0.0),
}
_NP = {torch.float32: np.float32, torch.int32: np.int32}


def _prep_f(x: torch.Tensor, f16: bool) -> torch.Tensor:
    """A float AOV as it is read back: itself, or with ``f16`` rounded to
    f16 after clamping finite values to the f16 range (port of ``_prep_f``,
    renderer.py:33-43)."""
    if not f16:
        return x
    fmax = float(np.finfo(np.float16).max)
    return torch.where(torch.isfinite(x), x.clamp(-fmax, fmax),
                       x).to(torch.float16)


def _filled(k: str, n: int) -> np.ndarray:
    shape, dt, fill = _AOVS[k]
    return np.full((n,) + shape, fill, _NP[dt])


class RenderOutput(NamedTuple):
    """Per-pixel AOVs, [H, W, ...] numpy arrays (window-sized)."""

    rgb: np.ndarray
    t: np.ndarray
    geom_id: np.ndarray
    prim_id: np.ndarray
    normal: np.ndarray
    hit_p: np.ndarray

    @property
    def hit_count(self) -> int:
        return int(np.sum(self.geom_id >= 0))


def _tile_coords(g0: int, n: int, w: int, window_c: int, window_r: int,
                 total: int, device):
    """Rows and columns (f32) of padded-stream positions [g0, g0 + n) of a
    window whose sides are multiples of TILE, from integer arithmetic on
    the device: the host stream's values; padding positions get (0, 0)."""
    g = g0 + torch.arange(n, dtype=torch.int64, device=device)
    tile_id, within = g // (TILE * TILE), g % (TILE * TILE)
    tr, tc = tile_id // (w // TILE), tile_id % (w // TILE)
    valid = g < total
    rows = torch.where(valid, window_r + tr * TILE + within // TILE, 0)
    cols = torch.where(valid, window_c + tc * TILE + within % TILE, 0)
    return rows.to(torch.float32), cols.to(torch.float32)


def path_chunk(scene, params, rows: torch.Tensor, cols: torch.Tensor,
               key: torch.Tensor, env=None, spp: int | None = None,
               stats: dict | None = None):
    """``spp`` samples (default ``params.samples_per_pixel``) of the pixels
    (rows, cols) [R] under the threefry ``key`` (port of ``_path_chunk``
    and of ``render_path_sharded``'s per-shard body): (rgb [R, 3], the
    spp average, error [R] bool). ``env`` lights the escaped rays
    (:func:`env_term`). ``stats`` gains the samples' ``bounces`` and
    ``syncs``."""
    spp = params.samples_per_pixel if spp is None else int(spp)
    acc = err = None
    for s in range(spp):
        skey = threefry.fold_in(key, s)
        o, d = generate_camera_rays(
            rows, cols, params.image_width, params.image_height,
            params.fov_radians, params.anti_alias_scale,
            threefry.fold_in(skey, 0xC0FFEE))
        res = path_trace_sample(scene, o, d, skey, params.max_path_length,
                                params.roulette_start_depth,
                                intersector=params.intersector, stats=stats)
        rgb = res.rgb
        if env is not None:
            rgb = rgb + torch.where(res.escaped[:, None],
                                    res.esc_throughput
                                    * env_term(env, res.esc_dir), 0.0)
        acc = rgb if acc is None else acc + rgb
        err = res.error if err is None else err | res.error
    return acc * float(np.float32(1.0 / spp)), err


def _render_path(scene, params, chunk_size, progress_callback, env,
                 readback_f16, stats) -> np.ndarray:
    """The per-sample wavefront over the window: rgb [H, W, 3] f32."""
    h, w = params.window_h, params.window_w
    dev = scene.device
    total = w * h
    rows_np, cols_np, order = _pixel_stream(params)
    device_coords = w % TILE == 0 and h % TILE == 0
    n_chunks = -(-total // chunk_size)
    padded = n_chunks * chunk_size
    if not device_coords:
        rows_np = np.pad(rows_np, (0, padded - total))
        cols_np = np.pad(cols_np, (0, padded - total))
    rgb = torch.empty((padded, 3), dtype=torch.float32, device=dev)
    n_err = torch.zeros((), dtype=torch.int64, device=dev)
    base_key = threefry.PRNGKey(params.rng_seed)
    for ci in range(n_chunks):
        g0 = ci * chunk_size
        if device_coords:
            rows, cols = _tile_coords(g0, chunk_size, w, params.window_c,
                                      params.window_r, total, dev)
        else:
            rows = torch.from_numpy(rows_np[g0:g0 + chunk_size]).to(dev)
            cols = torch.from_numpy(cols_np[g0:g0 + chunk_size]).to(dev)
        c_rgb, err = path_chunk(scene, params, rows, cols,
                                threefry.fold_in(base_key, ci), env=env,
                                stats=stats)
        rgb[g0:g0 + chunk_size] = c_rgb
        n_err += err.sum()
        if progress_callback is not None:
            progress_callback(ci, _prep_f(c_rgb, readback_f16).cpu()
                              .numpy().astype(np.float32))
    n_errors = int(n_err)
    if stats is not None:
        stats["errors"] = stats.get("errors", 0) + n_errors
    if n_errors:
        # In-band error marker, like the reference's HitRecord::ERROR NaN
        # flagging (TraceCodelets.cpp:240-244):
        logger().warning("%d rays flagged material errors during path trace",
                         n_errors)
    inverse = np.empty(total, np.int64)
    inverse[order] = np.arange(total)
    a = _prep_f(rgb[:total].index_select(0, torch.from_numpy(inverse).to(dev)),
                readback_f16)
    return a.cpu().numpy().astype(np.float32).reshape(h, w, 3)


def render(scene, params, mode: str = "shadow-trace",
           chunk_size: int = DEFAULT_CHUNK,
           progress_callback: Optional[Callable[[int, np.ndarray], None]] = None,
           aovs: Optional[tuple] = None, env=None,
           fused: bool = True, readback_f16: bool = False,
           streaming: bool = True, stats: dict | None = None) -> RenderOutput:
    """Render the scene's crop window on the scene's device. ``mode`` is
    'shadow-trace' or 'path-trace' (``env``: an environment light for the
    path trace, as :func:`render_streaming` takes it; ``streaming=False``:
    the per-sample wavefront, see the module note, whose ``stats`` dict
    gains ``bounces``, ``syncs`` and ``errors``).

    ``fused`` (shadow trace): the fused shadow kernel on a VMEM-mode scene;
    False, or a ``pallas-hbm`` scene, takes the glue route through the
    closest-hit kernels (render/shadow.py).

    ``aovs`` limits which shadow-trace AOVs are read back (None: all); the
    others come back filled. ``progress_callback(index, rgb)`` fires as
    each shadow-trace chunk completes, with the chunk's rgb [n, 3] in
    stream order, or after each path-trace batch, with the running average
    [H, W, 3] (the per-sample wavefront: after each chunk, with its rgb in
    stream order). ``readback_f16``: see the module note."""
    h, w = params.window_h, params.window_w
    if mode == "path-trace" and not streaming:
        rgb = _render_path(scene, params, chunk_size, progress_callback, env,
                           readback_f16, stats)
        return RenderOutput(rgb=rgb, **{
            k: _filled(k, h * w).reshape((h, w) + _AOVS[k][0])
            for k in _AOVS if k != "rgb"})
    if mode == "path-trace":
        kw = dict(chunk_slots=chunk_size, env=env, readback_f16=readback_f16)
        if progress_callback is None:
            rgb, _ = render_streaming(scene, params, **kw)
        else:
            spp = params.samples_per_pixel
            batch = max(1, min(16, spp))
            acc = np.zeros((h, w, 3), np.float32)
            s = bi = 0
            while s < spp:
                b = min(batch, spp - s)
                img, _ = render_streaming(
                    scene, params, spp=b,
                    seed=(params.rng_seed + 0x9E3779B9 * bi) & 0xFFFFFFFF,
                    **kw)
                acc += img * b
                s += b
                progress_callback(bi, acc / s)
                bi += 1
            rgb = acc / spp
        return RenderOutput(rgb=rgb, **{
            k: _filled(k, h * w).reshape((h, w) + _AOVS[k][0])
            for k in _AOVS if k != "rgb"})
    if mode != "shadow-trace":
        raise ValueError(f"Unknown render mode '{mode}'")

    dev = scene.device
    total = w * h
    rows_np, cols_np, order = _pixel_stream(params)
    device_coords = w % TILE == 0 and h % TILE == 0
    n_chunks = -(-total // chunk_size)
    padded = n_chunks * chunk_size
    if not device_coords:
        rows_np = np.pad(rows_np, (0, padded - total))
        cols_np = np.pad(cols_np, (0, padded - total))
    fields = [k for k in _AOVS if k == "geom_id" or aovs is None or k in aovs]
    bufs = {k: torch.empty((padded,) + _AOVS[k][0], dtype=_AOVS[k][1],
                           device=dev) for k in fields}

    for ci in range(n_chunks):
        g0 = ci * chunk_size
        with span("renderer.rays"):
            if device_coords:
                rows, cols = _tile_coords(g0, chunk_size, w, params.window_c,
                                          params.window_r, total, dev)
            else:
                rows = torch.from_numpy(rows_np[g0:g0 + chunk_size]).to(dev)
                cols = torch.from_numpy(cols_np[g0:g0 + chunk_size]).to(dev)
            _, d = generate_camera_rays(rows, cols, params.image_width,
                                        params.image_height,
                                        params.fov_radians)
        res = shadow_trace(scene, None, d, intersector=params.intersector,
                           fused=fused)
        with span("renderer.store"):
            for k in fields:
                bufs[k][g0:g0 + chunk_size] = getattr(res, k)
        if progress_callback is not None:
            progress_callback(ci, _prep_f(res.rgb, readback_f16).cpu()
                              .numpy().astype(np.float32))

    with span("renderer.readback"):
        # Raster order: image[order[g]] = stream[g].
        inverse = np.empty(total, np.int64)
        inverse[order] = np.arange(total)
        inv = torch.from_numpy(inverse).to(dev)
        out = {}
        for k, (shape, _, _) in _AOVS.items():
            if k in bufs:
                a = bufs[k][:total].index_select(0, inv)
                if a.is_floating_point():
                    a = _prep_f(a, readback_f16)
                a = a.cpu().numpy().astype(_NP[_AOVS[k][1]], copy=False)
            else:
                a = _filled(k, total)
            out[k] = a.reshape((h, w) + shape)
        g = out["geom_id"]
        out["geom_id"] = np.where(g == INVALID_GEOM_ID, -1,
                                  g).astype(np.int32)
    return RenderOutput(**out)
