"""Counter-based per-lane RNG (torch port of ``ipu_ray_lib_tpu/ops/rng.py``
and of the megakernel's in-kernel twin, megakernel.py:165-203).

Same constants, same stream layout, same bits: a path's random numbers
are keyed only by its integer streams, so the plain version here, the
CUDA kernel and the JAX package all draw identical uniforms.

Torch has no unsigned 32-bit arithmetic or logical right shift on int32,
so hashes run on int64 tensors holding values in [0, 2^32): shifts are
then logical, and products are formed from 16-bit halves so that no
intermediate leaves int64's range before the ``& 0xFFFFFFFF`` mask.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35
_M3 = 0x27D4EB2F
_GOLDEN = 0x9E3779B9
_FNV = 0x811C9DC5
_TWO_PI = np.float32(2.0 * math.pi)


def _mulmod(h: torch.Tensor, m: int) -> torch.Tensor:
    """(h * m) mod 2^32 for h in [0, 2^32), without int64 overflow."""
    lo = h * (m & 0xFFFF)
    hi = ((h * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _MASK


def _mix(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mulmod(h, _M1)
    h = h ^ (h >> 13)
    h = _mulmod(h, _M2)
    h = h ^ (h >> 16)
    return h


def _as_u32(s, like: torch.Tensor | None) -> torch.Tensor:
    if isinstance(s, torch.Tensor):
        return s.to(torch.int64) & _MASK
    dev = like.device if like is not None else None
    return torch.tensor(int(s) & _MASK, dtype=torch.int64, device=dev)


def hash_u32(*streams) -> torch.Tensor:
    """Combine integer streams (tensors or ints, broadcastable) into mixed
    uint32 values, returned as int64 in [0, 2^32)."""
    like = next((s for s in streams if isinstance(s, torch.Tensor)), None)
    h = None
    for s in streams:
        v = _mulmod(_as_u32(s, like), _M3)
        v = (v + _GOLDEN) & _MASK
        h = _mix((_FNV if h is None else h) ^ v)
    return _mix(h)


def uniform01(*streams) -> torch.Tensor:
    """Uniform float32 in [0, 1): the top 24 bits of the hash."""
    bits = hash_u32(*streams)
    return (bits >> 8).to(torch.float32) * np.float32(1.0 / (1 << 24))


def normal2(*streams):
    """A pair of standard gaussians per lane (Box-Muller over the two
    extra streams 0xA5 / 0x5A, ``u1`` clamped at 1e-12)."""
    u1 = torch.clamp_min(uniform01(*streams, 0xA5), np.float32(1e-12))
    u2 = uniform01(*streams, 0x5A)
    r = torch.sqrt(-2.0 * torch.log(u1))
    th = u2 * _TWO_PI
    return r * torch.cos(th), r * torch.sin(th)
