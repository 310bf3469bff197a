"""Render orchestration: the chunked shadow trace with its AOVs, and the
path trace, one-shot or progressive.

Port of ``render`` (ipu_ray_lib_tpu/render/renderer.py:152). In
shadow-trace mode (the default) the window's pixels are streamed in tile
order (render/pixels.py), in chunks of ``chunk_size`` rays padded to a
whole chunk: a chunk's pixel coordinates are a slice of the padded
stream on the scene's device, and its camera rays, the fused shadow
kernel (K4) and its epilogue run there and write into per-AOV buffers
(or, on the glue route, the closest-hit kernels K5/K6 twice with the
shading between; render/shadow.py). The chunk size decides where the
bundles of 1,024 rays fall when it is not a multiple of 1,024, so it is
kept as in the JAX package. The requested AOVs come back as [H, W, ...]
numpy; the others come back filled (zeros, t = inf, prim -1).
``geom_id`` is always read back.

The readback (``_read_back``) puts the AOVs in raster order on the
scene's device with the stream's int32 inverse (``PixelStream.inverse``).
Each AOV is gathered into its own segment of one packed buffer, allocated
per call, and ``geom_id``'s ``INVALID_GEOM_ID`` becomes -1 there. On a
CUDA scene the packed buffer then reaches the host in one copy into
pinned memory (counted in ``pinned_readbacks``) and one synchronisation
of the stream; on a CPU scene it is already on the host. The returned
arrays are views of that host buffer: each array's ``base`` holds it, so a
frame's arrays are never overwritten by a later frame, and the buffer is
freed, or goes back to torch's pinned cache, when the caller drops all
of them. So a caller that keeps N frames of a CUDA scene holds N pinned
blocks (the packed size rounded up to a power of two: 128 MB for the six
AOVs of a 1440² frame), keeping one AOV of a frame keeps the whole
block, and a frame that finds no free block in the cache allocates one
(for 128 MB about 30 ms on an H100's host, ten times the copy).

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
AOVs to f16 on the device before they are read back (2-byte segments of
the packed buffer, widened to f32 on the host): finite values are
clamped to +-65504 first, true infinities (t of a miss) pass; the ids stay
exact. The path trace's image is rounded likewise (no clamp).

On a CUDA scene the shadow frame's chunk loop is one CUDA graph when
nothing in it returns to the host: the fused K4 route and no progress
callback (so ~13,000 small launches a 1440² frame become one replay).
The first frame of a shape (a key: the window, the image size, the chunk
size, the AOV set and the device) runs the loop eagerly, then captures
it; each later frame of that shape sets the image plane's two factors,
which the fov alone changes, in 0-d tensors on the card and replays it
into the same AOV buffers, which the readback gathers into its own packed
buffer before the next replay. A captured frame holds the stream
coordinates its graph reads. Each scene keeps its ``GRAPH_KEYS`` most
recently used frames, and drops them with itself.
Every other call runs the loop eagerly; both give the same bits.
"""

from __future__ import annotations

import collections
import math
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..bvh.builder import INVALID_GEOM_ID
from ..ops import shadow as shadow_ops
from ..ops.camera import (generate_camera_rays, plane_scale, scaled_ray_dir,
                          tan_half_fov)
from ..utils import threefry
from ..utils.log import logger
from ..utils.profiling import span
from .path import path_trace_sample
from .pixels import pixel_stream
from .shadow import shadow_trace
from .streaming import env_term, render_streaming

DEFAULT_CHUNK = 1 << 16
GRAPH_KEYS = 4  # captured shadow frames a scene keeps
# Bytes: each AOV's segment of the readback starts at a multiple, so an
# f16 segment of odd length leaves the next one's 4-byte view legal.
SEGMENT_ALIGN = 64

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

# The shadow frames ``render`` captured as a CUDA graph and replayed (each
# replay adds its graph's K4 launches to ``ops/shadow.py:launches``), and
# those whose AOVs it read back in one copy to pinned memory:
graph_captures = 0
graph_replays = 0
pinned_readbacks = 0


def reset_counters() -> None:
    global graph_captures, graph_replays, pinned_readbacks
    graph_captures = graph_replays = pinned_readbacks = 0


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
    stream = pixel_stream(params)
    n_chunks = -(-total // chunk_size)
    padded = n_chunks * chunk_size
    rows, cols = stream.coords(dev, padded)
    rgb = torch.empty((padded, 3), dtype=torch.float32, device=dev)
    n_err = torch.zeros((), dtype=torch.int64, device=dev)
    base_key = threefry.PRNGKey(params.rng_seed)
    for ci in range(n_chunks):
        g0 = ci * chunk_size
        c_rgb, err = path_chunk(scene, params, rows[g0:g0 + chunk_size],
                                cols[g0:g0 + chunk_size],
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
    a = _prep_f(rgb[:total].index_select(0, stream.inverse(dev)),
                readback_f16)
    return a.cpu().numpy().astype(np.float32).reshape(h, w, 3)


def _aov_bufs(fields, padded: int, dev) -> dict:
    """Empty stream-order buffers [padded, ...] of the AOVs ``fields``."""
    return {k: torch.empty((padded,) + _AOVS[k][0], dtype=_AOVS[k][1],
                           device=dev) for k in fields}


def _read_back(bufs: dict, params, dev: torch.device,
               f16: bool) -> RenderOutput:
    """The AOVs of ``bufs`` (stream order, padded) as [H, W, ...] numpy in
    raster order, the others filled (module note): gathered on ``dev`` into
    the segments of one packed buffer, one copy to pinned host memory on a
    CUDA scene, the arrays views of the host buffer."""
    global pinned_readbacks
    h, w = params.window_h, params.window_w
    total = w * h
    segs, nbytes = {}, 0
    for k in bufs:
        shape, dt, _ = _AOVS[k]
        if f16 and dt.is_floating_point:
            dt = torch.float16
        size = total * math.prod(shape) * dt.itemsize
        segs[k] = (nbytes, size, dt, shape)
        nbytes += -(-size // SEGMENT_ALIGN) * SEGMENT_ALIGN

    def seg(buf: torch.Tensor, k: str) -> torch.Tensor:
        off, size, dt, shape = segs[k]
        return buf[off:off + size].view(dt).view((total,) + shape)

    inv = pixel_stream(params).inverse(dev)
    packed = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    for k, src in bufs.items():
        src = src[:total]
        if src.is_floating_point():
            src = _prep_f(src, f16)
        torch.index_select(src, 0, inv, out=seg(packed, k))
    g = seg(packed, "geom_id")
    g.masked_fill_(g == INVALID_GEOM_ID, -1)
    if dev.type == "cuda":
        host = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        host.copy_(packed, non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()
        pinned_readbacks += 1
    else:
        host = packed
    out = {}
    for k, (shape, _, _) in _AOVS.items():
        if k in segs:
            a = seg(host, k).view((h, w) + shape).numpy()
            if a.dtype == np.float16:
                a = a.astype(np.float32)
        else:
            a = _filled(k, total).reshape((h, w) + shape)
        out[k] = a
    return RenderOutput(**out)


def _shadow_chunks(scene, params, chunk_size: int, bufs: dict, scale,
                   coords: tuple, fused: bool = True, progress_callback=None,
                   readback_f16: bool = False) -> None:
    """The shadow frame's chunk loop: each chunk's camera rays, shadow
    trace and AOV stores into ``bufs`` (stream order). ``scale``: the image
    plane's factors (sx, sy) as :func:`~..ops.camera.scaled_ray_dir` takes
    them; ``coords``: the padded stream's (rows, cols) on the scene's
    device (``PixelStream.coords``)."""
    rows, cols = coords
    for ci in range(-(-params.window_w * params.window_h // chunk_size)):
        g0 = ci * chunk_size
        with span("renderer.rays"):
            d = scaled_ray_dir(cols[g0:g0 + chunk_size],
                               rows[g0:g0 + chunk_size], params.image_width,
                               params.image_height, *scale)
        res = shadow_trace(scene, None, d, intersector=params.intersector,
                           fused=fused)
        with span("renderer.store"):
            for k, buf in bufs.items():
                buf[g0:g0 + chunk_size] = getattr(res, k)
        if progress_callback is not None:
            progress_callback(ci, _prep_f(res.rgb, readback_f16).cpu()
                              .numpy().astype(np.float32))


def _graph_route(device: torch.device, fused: bool, intersector: str,
                 progress_callback) -> bool:
    """Whether the shadow frame replays a captured CUDA graph (module
    note): a CUDA scene, the fused K4 route and no progress callback."""
    return (device.type == "cuda" and fused and intersector == "pallas"
            and progress_callback is None)


class _FrameGraph(NamedTuple):
    """A captured shadow frame: the image plane's factors (0-d f32 on the
    card) and the stream's padded coordinates (its inputs: held here, as
    the stream cache may drop them), the AOV buffers (its outputs), the
    graph, the K4 launches it replays and the capture's ms."""

    scale: tuple
    coords: tuple
    bufs: dict
    graph: object
    k4_launches: int
    capture_ms: float


def _capture(body, dev: torch.device):
    """(``body()`` captured as one CUDA graph with a private memory pool,
    the capture's wall ms from an idle card)."""
    with torch.cuda.device(dev):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            body()
        return graph, (time.perf_counter() - t0) * 1e3


def _replayed_frame(scene, params, chunk_size: int, fields, scale) -> dict:
    """The frame's AOV buffers, filled by a replay of its captured chunk
    loop; the first call of a key runs the loop eagerly (which also loads
    what loads lazily: the kernel library, K4's shared-memory opt-in) and
    then captures it (module note)."""
    global graph_captures, graph_replays
    key = (scene.device, params.window_w, params.window_h, params.window_c,
           params.window_r, params.image_width, params.image_height,
           chunk_size, tuple(fields))
    cache = scene.__dict__.setdefault("_frame_graphs",
                                      collections.OrderedDict())
    fg = cache.get(key)
    if fg is not None:
        cache.move_to_end(key)
        with span("renderer.replay"):
            for t, v in zip(fg.scale, scale):
                t.fill_(v)
            fg.graph.replay()
        shadow_ops.launches += fg.k4_launches
        graph_replays += 1
        return fg.bufs
    dev = scene.device
    padded = -(-params.window_w * params.window_h // chunk_size) * chunk_size
    coords = pixel_stream(params).coords(dev, padded)
    bufs = _aov_bufs(fields, padded, dev)
    sc = tuple(torch.full((), v, dtype=torch.float32, device=dev)
               for v in scale)
    body = lambda: _shadow_chunks(scene, params, chunk_size, bufs, sc, coords)
    body()
    n0 = shadow_ops.launches
    with span("renderer.capture"):
        graph, ms = _capture(body, dev)
    fg = _FrameGraph(sc, coords, bufs, graph, shadow_ops.launches - n0, ms)
    shadow_ops.launches = n0  # a capture launches nothing
    graph_captures += 1
    logger().info("Shadow frame %dx%d captured as a CUDA graph: %d K4 "
                  "launches, %.1f ms", params.window_w, params.window_h,
                  fg.k4_launches, ms)
    cache[key] = fg
    while len(cache) > GRAPH_KEYS:
        cache.popitem(last=False)
    return bufs


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
    fields = [k for k in _AOVS if k == "geom_id" or aovs is None or k in aovs]
    scale = plane_scale(params.image_width, params.image_height,
                        tan_half_fov(params.fov_radians))
    if _graph_route(dev, fused, params.intersector, progress_callback):
        bufs = _replayed_frame(scene, params, chunk_size, fields, scale)
    else:
        padded = -(-w * h // chunk_size) * chunk_size
        bufs = _aov_bufs(fields, padded, dev)
        _shadow_chunks(scene, params, chunk_size, bufs, scale,
                       pixel_stream(params).coords(dev, padded), fused,
                       progress_callback, readback_f16)

    with span("renderer.readback"):
        return _read_back(bufs, params, dev, readback_f16)
