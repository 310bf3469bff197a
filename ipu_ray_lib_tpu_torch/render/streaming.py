"""Streaming path tracer with path regeneration: the full-frame loop around
the megakernel (port of ``render_streaming``, ipu_ray_lib_tpu/render/
streaming.py:584, megakernel path, optionally NIF-lit, at any scene
size).

A fixed pool of R ray slots serves a tile-ordered pixel stream: slot s
owns the padded-stream pixels {s, s+R, ...}, J of them; each slot runs
its J*spp paths back to back inside the kernel. High spp renders run in
decorrelated batches of at most ``SPP_BATCH`` samples (and
``MAX_K_PER_DISPATCH`` paths per slot) with seeds ``seed + 0x9E3779B9*bi``
— the batch schedule is part of the RNG contract — and accumulate on the
device, weighted ``b/spp`` per batch in batch order.

The reference splits the frame into pixel groups only to overlap TPU
readback with compute; the union of groups equals one dispatch bit for
bit, so this module runs one group, [(0, J)]. ``b_cap`` comes from the
global J (the reference computed it per group, a known fault that binds
only when J > 32).

The walk follows ``params.intersector`` (``"pallas"``: K1's VMEM-mode
walk; ``"pallas-hbm"``: K3's HBM-mode walk, ops/megakernel.py). The mode
changes nothing here: the reference's HBM mode alters only its TPU bundle
count (streaming.py:724-725); the pool, the pixel stream, the batches and
the seeds are the same.

A NIF environment light (``env``) is evaluated once per dispatch over
every escaped path (ops/megakernel.py), so the reference's env flush
cadence and count knobs (``RAY_ENV_EVERY``/``RAY_ENV_COUNT``, scheduling
only) have no counterpart here.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.megakernel import megakernel_path_trace

SPP_BATCH = 64
MAX_K_PER_DISPATCH = 2048
TILE = 32  # side of the square tiles that order the pixel stream

_STREAM_CACHE: dict = {}


def _pixel_stream(params):
    """Tile-ordered pixel stream (rows, cols as f32, and the permutation
    back to raster order), cached per window."""
    w, h = params.window_w, params.window_h
    key = (w, h, params.window_c, params.window_r)
    hit = _STREAM_CACHE.get(key)
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
    if len(_STREAM_CACHE) > 8:
        _STREAM_CACHE.clear()
    _STREAM_CACHE[key] = (rows_np, cols_np, order)
    return rows_np, cols_np, order


def slot_pool(n_pix: int, chunk_slots: int) -> tuple[int, int]:
    """(R, J): the slot pool, a multiple of 256 no larger than the frame
    needs, and the pixels per slot."""
    R = min(chunk_slots, n_pix)
    R = min(-(-R // 256) * 256, -(-n_pix // 256) * 256)
    return R, -(-n_pix // R)


def render_streaming(scene, params, chunk_slots: int = 1 << 17, env=None):
    """Full-window streaming render on the scene's device at
    ``params.samples_per_pixel``, seeded by ``params.rng_seed``, lit by the
    NIF ``env`` (a :class:`~ipu_ray_lib_tpu_torch.nif.model.NifEnv` on the
    scene's device) when given; returns (rgb [H, W, 3] float32 numpy,
    done: the number of finished paths)."""
    spp = params.samples_per_pixel
    seed = params.rng_seed
    w, h = params.window_w, params.window_h
    n_pix = w * h
    rows_np, cols_np, order = _pixel_stream(params)
    R, J = slot_pool(n_pix, chunk_slots)
    pad = R * J - n_pix
    dev = scene.device
    rows = torch.from_numpy(np.pad(rows_np, (0, pad))).to(dev)
    cols = torch.from_numpy(np.pad(cols_np, (0, pad))).to(dev)

    b_cap = max(1, MAX_K_PER_DISPATCH // J)
    flat_acc = None
    dones = []
    s = bi = 0
    while s < spp:
        b = min(SPP_BATCH, b_cap, spp - s)
        flat_b, done_b = megakernel_path_trace(
            scene, rows, cols, (seed + 0x9E3779B9 * bi) & 0xFFFFFFFF, n_pix,
            params=params, slots=R, j_per_slot=J, spp=b,
            max_iters=J * b * params.max_path_length + 16, j0=0,
            k_total=J * b, env=env)
        wgt = float(np.float32(b / spp))
        flat_acc = (flat_b * wgt if flat_acc is None
                    else flat_acc + flat_b * wgt)
        dones.append(done_b)
        s += b
        bi += 1
    img = np.empty((n_pix, 3), np.float32)
    img[order] = flat_acc[:n_pix].cpu().numpy()
    done = int(torch.stack(dones).sum())
    return img.reshape(h, w, 3), done
