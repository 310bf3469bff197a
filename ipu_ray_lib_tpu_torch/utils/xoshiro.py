"""Host-side xoroshiro128** RNG (numpy only).

A jax-free copy of ``ipu_ray_lib_tpu/utils/xoshiro.py``: the same u64
stream for the same seed. The reference derives independent per-replica
seeds with jump() (ref: include/xoshiro.hpp, src/IpuScene.cpp:648-654);
the sharded renderer (parallel/mesh.py) folds those seeds into the
kernels' u32 counter-RNG seeds. Implemented from the public
xoroshiro128** algorithm (Blackman & Vigna, public domain).
"""

import numpy as np

_MASK = (1 << 64) - 1


def _rotl(x: int, k: int) -> int:
    return ((x << k) | (x >> (64 - k))) & _MASK


def _splitmix64_next(state: int):
    state = (state + 0x9E3779B97F4A7C15) & _MASK
    z = state
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return state, z ^ (z >> 31)


class Xoroshiro128:
    """xoroshiro128** seeded via splitmix64, with jump() for parallel streams."""

    def __init__(self, seed: int):
        sm = seed & _MASK
        sm, s0 = _splitmix64_next(sm)
        sm, s1 = _splitmix64_next(sm)
        self._s = [s0, s1]

    def next_u64(self) -> int:
        s0, s1 = self._s
        result = (_rotl((s0 * 5) & _MASK, 7) * 9) & _MASK
        s1 ^= s0
        self._s[0] = _rotl(s0, 24) ^ s1 ^ ((s1 << 16) & _MASK)
        self._s[1] = _rotl(s1, 37)
        return result

    def jump(self) -> None:
        """Advance 2^64 steps: yields a non-overlapping parallel stream."""
        JUMP = (0xDF900294D8F554A5, 0x170865DF4B3201FC)
        s0 = 0
        s1 = 0
        for j in JUMP:
            for b in range(64):
                if j & (1 << b):
                    s0 ^= self._s[0]
                    s1 ^= self._s[1]
                self.next_u64()
        self._s = [s0, s1]


def derive_replica_seeds(seed: int, num_replicas: int) -> np.ndarray:
    """Independent u64 seeds, one per data-parallel replica (jump-separated)."""
    g = Xoroshiro128(seed)
    seeds = np.empty(num_replicas, dtype=np.uint64)
    for i in range(num_replicas):
        seeds[i] = np.uint64(g.next_u64())
        g.jump()
    return seeds
