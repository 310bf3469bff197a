"""The threefry2x32 PRNG of ``jax.random``, without jax.

A jax-free port of jax 0.9.0's default PRNG in its partitionable mode
(``jax_threefry_partitionable``, the default there): the same keys and
the same bits for the same calls, so a render or a training run seeded
here sees the JAX package's random numbers.

* a key is an int64 tensor [2] holding two u32 words; ``PRNGKey`` (jax
  ``threefry_seed``), ``split`` (the fold-like split), ``fold_in`` and
  ``random_bits`` (partitionable: the counter of element i is the u64 i
  as (hi, lo) words, the bits the XOR of the two output words). Keys live
  on the host by default: a host key's splits and folds are hashed in
  Python integers (one hash, not a hundred small tensor operations), and
  the draws are made on the ``device`` asked for, the key's words passed
  to the device as scalars. A key on a card is split and folded there;
* ``uniform`` (jax ``random._uniform``: 23 random mantissa bits under
  the exponent of 1.0, minus 1), ``randint`` (``random._randint``: two
  draws from a split key, combined modulo the span in u32 arithmetic)
  and ``normal`` (``random._normal_real``: ``sqrt(2) * erf_inv(u)``, u
  uniform on the open interval (-1, 1)).

Torch has no u32 arithmetic and no logical right shift on int32, so the
words live in int64 tensors and every sum is masked back to 32 bits (as
``ops/rng.py``).

``erf_inv`` is XLA's f32 expansion as its CPU backend compiles it:
Giles' single-precision polynomial after ``w = -log1p(-x*x)``, where
``log1p`` is XLA's (a Cephes rational for |x| < sqrt(2) - 1, else its own
polynomial ``log`` of 1 + x), and every product that feeds a single sum
fused into one multiply-add, as LLVM contracts them. ``ops/vec3.py:fma``
rounds twice, in float64 and to f32, which differs from one rounding in
about 2**-29 of the cases.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.vec3 import fma

_M = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
_i64 = torch.int64
_f32 = np.float32


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _M


def threefry2x32(k1, k2, c1, c2):
    """The Threefry-2x32 hash (20 rounds) of the counter words (c1, c2)
    under the key words (k1, k2): u32 values in int64 tensors or ints."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    x0, x1 = (c1 + ks[0]) & _M, (c2 + ks[1]) & _M
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M
    return x0, x1


def PRNGKey(seed: int, device=None) -> torch.Tensor:
    """The key of an integer seed (jax ``PRNGKey`` with 64-bit types off,
    jax's default): the seed's low 32 bits, after a zero high word."""
    return torch.tensor([0, int(seed) & _M], dtype=_i64, device=device)


def _counters(n: int, device):
    idx = torch.arange(n, dtype=_i64, device=device)
    return idx >> 32, idx & _M


def _words(key: torch.Tensor):
    """The key's two words: Python ints for a host key, else 0-d tensors."""
    if key.device.type == "cpu":
        return int(key[0]), int(key[1])
    return key[0], key[1]


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``num`` new keys [num, 2] (jax ``split``, the fold-like split), on
    the key's device."""
    k1, k2 = _words(key)
    if key.device.type == "cpu":
        return torch.tensor([threefry2x32(k1, k2, i >> 32, i & _M)
                             for i in range(num)], dtype=_i64)
    hi, lo = _counters(num, key.device)
    b1, b2 = threefry2x32(k1, k2, hi, lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """The key with the u32 ``data`` folded in (jax ``fold_in``), on the
    key's device."""
    k1, k2 = _words(key)
    d = int(data) & _M
    if key.device.type == "cpu":
        return torch.tensor(threefry2x32(k1, k2, 0, d), dtype=_i64)
    zero = torch.zeros(1, dtype=_i64, device=key.device)
    b1, b2 = threefry2x32(k1, k2, zero, zero + d)
    return torch.cat([b1, b2])


def random_bits(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """u32 random bits of ``shape`` (int64 tensor on ``device``, default
    the key's), partitionable mode."""
    shape = tuple(int(s) for s in shape)
    hi, lo = _counters(int(np.prod(shape)),
                       key.device if device is None else device)
    b1, b2 = threefry2x32(*_words(key), hi, lo)
    return (b1 ^ b2).reshape(shape)


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0, device=None) -> torch.Tensor:
    """f32 uniform on [minval, maxval) (jax ``uniform``) on ``device``
    (default the key's)."""
    bits = random_bits(key, shape, device)
    one = (bits >> 9) | 0x3F800000
    floats = one.to(torch.int32).view(torch.float32) - 1.0
    lo, hi = _f32(minval), _f32(maxval)
    out = fma(floats, float(_f32(hi - lo)), float(lo))
    return torch.clamp_min(out, float(lo))


def randint(key: torch.Tensor, shape, minval: int, maxval: int,
            device=None) -> torch.Tensor:
    """int32 uniform on [minval, maxval) (jax ``randint`` at int32, both
    bounds within int32) on ``device`` (default the key's)."""
    k1, k2 = split(key)
    higher = random_bits(k1, shape, device)
    lower = random_bits(k2, shape, device)
    span = 1 if maxval <= minval else (maxval - minval) & _M
    mult = (1 << 16) % span
    mult = ((mult * mult) & _M) % span
    off = (((higher % span) * mult) & _M) + (lower % span)
    off = (off & _M) % span
    return (minval + off).to(torch.int32)


# XLA's f32 erf_inv (Giles), w < 5 and w >= 5, highest power first:
_ERFINV_LT5 = tuple(float(_f32(c)) for c in (
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
    0.00021858087, -0.00125372503, -0.00417768164, 0.246640727,
    1.50140941))
_ERFINV_GE5 = tuple(float(_f32(c)) for c in (
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
    0.00573950773, -0.0076224613, 0.00943887047, 1.00167406,
    2.83297682))
# XLA's log1p for small arguments (Cephes), numerator and denominator,
# highest power first:
_L1P_NUM = tuple(float(_f32(c)) for c in (
    4.5270000862445199635215e-5, 4.9854102823193375972212e-1,
    6.5787325942061044846969, 2.9911919328553073277375e1,
    6.0949667980987787057556e1, 5.7112963590585538103336e1,
    2.0039553499201281259648e1))
_L1P_DEN = tuple(float(_f32(c)) for c in (
    1.0, 1.5062909083469192043167e1, 8.3047565967967209469434e1,
    2.2176239823732856465394e2, 3.0909872225312059774938e2,
    2.1642788614495947685003e2, 6.0118660497603843919306e1))
# XLA's CPU f32 log, as its compiled code takes it: exponent and mantissa
# in [sqrt(1/2), sqrt(2)) - 1, a degree-8 polynomial in three interleaved
# Horner chains, ln 2 in two parts.
_LOG_SQRTHF = float(_f32(0.707106781186547524))
_LOG_P = tuple(float(_f32(c)) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1,
    -1.2420140846e-1, 1.4249322787e-1, -1.6668057665e-1,
    2.0000714765e-1, -2.4999993993e-1, 3.3333331174e-1))
_LOG_Q1 = float(_f32(-2.12194440e-4))
_LOG_Q2 = float(_f32(0.693359375))
_FLT_MIN = float(np.finfo(np.float32).tiny)


def _xla_log(t: torch.Tensor) -> torch.Tensor:
    """XLA's CPU f32 ``log`` of t (its special cases: log(0) = -inf,
    log(inf) = inf, negative or NaN -> NaN)."""
    bits = torch.clamp_min(t, _FLT_MIN).view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    m = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)
    small = m < _LOG_SQRTHF
    e = e - torch.where(small, 1.0, 0.0)
    x = (m - 1.0) + torch.where(small, m, 0.0)
    z = x * x
    x3 = z * x
    p = _LOG_P
    a = fma(fma(x, p[0], p[1]), x, p[2])
    b = fma(fma(x, p[3], p[4]), x, p[5])
    c = fma(fma(x, p[6], p[7]), x, p[8])
    y = fma(fma(fma(a, x3, b), x3, c), x3, e * _LOG_Q1)
    r = fma(e, _LOG_Q2, fma(-z, 0.5, x) + y)
    r = torch.where(t <= 0.0, float("nan"), r)
    r = torch.where(t == 0.0, -float("inf"), r)
    return torch.where(t == float("inf"), float("inf"), r)


def _xla_log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 log1p: the Cephes rational for |x| < sqrt(2) - 1, else
    its log of 1 + x."""
    x2 = x * x
    zero_x = x * 0.0
    num = fma(zero_x + _L1P_NUM[0], x, _L1P_NUM[1])
    for c in _L1P_NUM[2:]:
        num = fma(num, x, c)
    den = fma(zero_x + _L1P_DEN[0], x, _L1P_DEN[1])
    for c in _L1P_DEN[2:]:
        den = fma(den, x, c)
    small = x + fma(x2, -0.5, (x * x2) * (num / den))
    return torch.where(torch.abs(x) < float(_f32(0.41421356237309504880)),
                       small, _xla_log(x + 1.0))


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv`` on the CPU (x in [-1, 1], f32)."""
    w = -_xla_log1p(x * -x)
    lt = w < 5.0
    ww = torch.where(lt, w - 2.5, torch.sqrt(w.to(torch.float64))
                     .to(torch.float32) - 3.0)
    sel = lambda i: torch.where(lt, _ERFINV_LT5[i], _ERFINV_GE5[i])
    p = fma(sel(0), ww, sel(1))
    for i in range(2, 9):
        p = fma(ww, p, sel(i))
    return torch.where(torch.abs(x) == 1.0, x * float("inf"), x * p)


_SQRT2 = float(_f32(np.sqrt(2.0)))
_OPEN_LO = float(np.nextafter(_f32(-1.0), _f32(0.0)))


def normal(key: torch.Tensor, shape, device=None) -> torch.Tensor:
    """f32 standard normal draws (jax ``normal``) on ``device`` (default
    the key's)."""
    return erf_inv(uniform(key, shape, _OPEN_LO, 1.0, device)) * _SQRT2
