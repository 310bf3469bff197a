"""The port's counter-hash RNG against the JAX package's.

``hash_u32``/``uniform01`` must match ``ipu_ray_lib_tpu.ops.rng`` and the
megakernel's in-kernel int32 twin (``_hash``/``_u01``) bit for bit: the
port's paths draw exactly the reference's random numbers. ``normal2``
goes through log/sqrt/cos/sin, whose last ulp differs between XLA's and
torch's CPU libraries, so it is held at rtol = atol = 1e-6.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ipu_ray_lib_tpu.ops import rng as jrng
from ipu_ray_lib_tpu.ops.pallas import megakernel as jmk
from ipu_ray_lib_tpu_torch.ops import rng as trng


def _streams(seed):
    r = np.random.default_rng(seed)
    pid = r.integers(0, 2**31 - 1, 4096, dtype=np.int64).astype(np.int32)
    b = r.integers(0, 2**31 - 1, 4096, dtype=np.int64).astype(np.int32)
    c = r.integers(0, 4, 4096).astype(np.int32)
    return pid, b, c


def _u32(x):
    return np.asarray(x).astype(np.uint32).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 1442])
def test_hash_u32_matches_ops_rng(seed):
    pid, b, c = _streams(seed)
    want = _u32(jax.jit(jrng.hash_u32)(pid.astype(np.uint32),
                                      b.astype(np.uint32), c.astype(np.uint32)))
    got = trng.hash_u32(torch.from_numpy(pid), torch.from_numpy(b),
                        torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, want)


def test_hash_u32_matches_kernel_twin():
    pid, b, c = _streams(7)
    want = _u32(np.asarray(jax.jit(jmk._hash)(
        jnp.asarray(pid), jnp.asarray(b), jnp.asarray(c))).view(np.uint32))
    got = trng.hash_u32(torch.from_numpy(pid), torch.from_numpy(b),
                        torch.from_numpy(c)).numpy()
    np.testing.assert_array_equal(got, want)


def test_hash_u32_python_int_streams_broadcast():
    pid, _, _ = _streams(3)
    seed = 0x9E3779B9 + 1442  # > 2^31: wraps like a uint32
    want = _u32(jax.jit(jrng.hash_u32)(pid.astype(np.uint32),
                                      np.uint32(seed & 0xFFFFFFFF),
                                      np.uint32(0xCA3)))
    got = trng.hash_u32(torch.from_numpy(pid), seed, 0xCA3).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("twin", ["ops_rng", "kernel"])
def test_uniform01_bit_exact(twin):
    pid, b, c = _streams(11)
    if twin == "ops_rng":
        want = np.asarray(jax.jit(jrng.uniform01)(
            pid.astype(np.uint32), b.astype(np.uint32), c.astype(np.uint32)))
    else:
        want = np.asarray(jax.jit(jmk._u01)(
            jnp.asarray(pid), jnp.asarray(b), jnp.asarray(c)))
    got = trng.uniform01(torch.from_numpy(pid), torch.from_numpy(b),
                         torch.from_numpy(c)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    assert got.min() >= 0.0 and got.max() < 1.0


@pytest.mark.parametrize("twin", ["ops_rng", "kernel"])
def test_normal2_close(twin):
    pid, _, _ = _streams(5)
    seed = np.int32(1442)
    if twin == "ops_rng":
        w1, w2 = jax.jit(jrng.normal2)(pid.astype(np.uint32), np.uint32(seed),
                                      np.uint32(0xCA3))
    else:
        p2 = jnp.asarray(pid).reshape(8, 512)
        w1, w2 = jax.jit(jmk._normal2)(p2, jnp.full_like(p2, seed),
                                      jnp.full_like(p2, 0xCA3))
    g1, g2 = trng.normal2(torch.from_numpy(pid), int(seed), 0xCA3)
    np.testing.assert_allclose(g1.numpy(), np.asarray(w1).ravel(),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(g2.numpy(), np.asarray(w2).ravel(),
                               rtol=1e-6, atol=1e-6)
