"""The renderer's random-number contract, in plain torch and numpy.

* The counter hash (upstream's per-lane stream hash): integer streams are
  mixed into a u32; ``uniform01`` is its top 24 bits over 2^24, and
  ``normal2`` a Box-Muller pair over the extra streams 0xA5 and 0x5A.
  A path draws its camera jitter from (pid, seed, 0xCA3) and its four
  shading numbers at a bounce from (pid, bounce + 7 + seed, c).
* The per-replica seeds of a sharded render: xoroshiro128** seeded by
  splitmix64, one ``jump()`` per replica, each u64 folded to 32 bits
  (Blackman and Vigna's public algorithm).

Torch has no unsigned 32-bit arithmetic, so hashes run on int64 tensors
holding values in [0, 2^32), and products are formed from 16-bit halves.
"""

from __future__ import annotations

import math

import numpy as np
import torch

MASK = 0xFFFFFFFF
_M1, _M2, _M3 = 0x85EBCA6B, 0xC2B2AE35, 0x27D4EB2F
GOLDEN = 0x9E3779B9
_FNV = 0x811C9DC5
_TWO_PI = float(np.float32(2.0 * math.pi))


def _mulmod(h, m: int):
    lo = h * (m & 0xFFFF)
    hi = ((h * (m >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def _mix(h):
    h = h ^ (h >> 16)
    h = _mulmod(h, _M1)
    h = h ^ (h >> 13)
    h = _mulmod(h, _M2)
    return h ^ (h >> 16)


def hash_u32(*streams):
    """Mixed u32 of broadcastable integer streams (int64 tensors or ints)."""
    like = next(s for s in streams if torch.is_tensor(s))
    h = None
    for s in streams:
        v = (s.to(torch.int64) if torch.is_tensor(s)
             else torch.tensor(int(s), dtype=torch.int64, device=like.device))
        v = (_mulmod(v & MASK, _M3) + GOLDEN) & MASK
        h = _mix((_FNV if h is None else h) ^ v)
    return _mix(h)


def uniform01(*streams):
    return (hash_u32(*streams) >> 8).to(torch.float32) * float(
        np.float32(1.0 / (1 << 24)))


def normal2(*streams):
    u1 = torch.clamp_min(uniform01(*streams, 0xA5), float(np.float32(1e-12)))
    u2 = uniform01(*streams, 0x5A)
    r = torch.sqrt(-2.0 * torch.log(u1))
    th = u2 * _TWO_PI
    return r * torch.cos(th), r * torch.sin(th)


_U64 = (1 << 64) - 1


def _rotl(x: int, k: int) -> int:
    return ((x << k) | (x >> (64 - k))) & _U64


def _splitmix(state: int):
    state = (state + 0x9E3779B97F4A7C15) & _U64
    z = state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _U64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _U64
    return state, z ^ (z >> 31)


def replica_seeds(seed: int, n: int, batch: int) -> list[int]:
    """Each of ``n`` replicas' u32 kernel seed for spp batch ``batch``:
    its jump-separated u64 folded to 32 bits, plus ``0x85EBCA6B * batch``
    (mod 2^32)."""
    sm, s0 = _splitmix(seed & _U64)
    _, s1 = _splitmix(sm)
    s = [s0, s1]

    def nxt():
        a, b = s
        out = (_rotl((a * 5) & _U64, 7) * 9) & _U64
        b ^= a
        s[0] = _rotl(a, 24) ^ b ^ ((b << 16) & _U64)
        s[1] = _rotl(b, 37)
        return out

    out = []
    for _ in range(n):
        v = nxt()
        out.append(((v ^ (v >> 32)) + 0x85EBCA6B * batch) & MASK)
        j0 = j1 = 0
        for j in (0xDF900294D8F554A5, 0x170865DF4B3201FC):
            for b in range(64):
                if j & (1 << b):
                    j0 ^= s[0]
                    j1 ^= s[1]
                nxt()
        s[0], s[1] = j0, j1
    return out
