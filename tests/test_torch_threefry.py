"""The port's jax-free threefry2x32 (utils/threefry.py) against
``jax.random`` on the CPU, bit for bit: keys, splits, folds, random bits,
uniforms, randints and normals.

``normal`` goes through XLA's f32 ``erf_inv``, whose ``log1p`` and the
multiply-adds LLVM contracts the port copies from the compiled code; on
2^21 draws over four keys its bits equal jax's (the only possible residue
is the double rounding of ``ops/vec3.py:fma``, about 2**-29 of the
cases)."""

import torch_threads  # noqa: F401  (first: one torch thread)

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ipu_ray_lib_tpu_torch.ops.camera import generate_camera_rays
from ipu_ray_lib_tpu_torch.utils import threefry as tf

KEY = 7


def _bits(a) -> np.ndarray:
    a = np.asarray(a.numpy() if isinstance(a, torch.Tensor) else a)
    return a.view(np.int32) if a.dtype == np.float32 else a.astype(np.int64)


def _same(got, want) -> bool:
    g, w = _bits(got), _bits(want)
    return g.shape == w.shape and np.array_equal(g, w)


@pytest.mark.parametrize("seed", [0, 1, 2**31 - 1, 2**40 + 12345, -3])
def test_prng_key(seed):
    assert _same(tf.PRNGKey(seed), jax.random.PRNGKey(seed))


@pytest.mark.parametrize("n", [2, 3, 7])
def test_split(n):
    got = tf.split(tf.PRNGKey(KEY), n)
    assert got.shape == (n, 2)
    assert _same(got, jax.random.split(jax.random.PRNGKey(KEY), n))


@pytest.mark.parametrize("data", [0, 0xC0FFEE, 2**31 - 1, 2**32 - 1])
def test_fold_in(data):
    assert _same(tf.fold_in(tf.PRNGKey(KEY), data),
                 jax.random.fold_in(jax.random.PRNGKey(KEY), data))


def test_random_bits():
    assert _same(tf.random_bits(tf.PRNGKey(KEY), (3, 5)),
                 jax.random.bits(jax.random.PRNGKey(KEY), (3, 5)))


@pytest.mark.parametrize("r", [1, 7, 1024, 65537])
def test_uniform(r):
    got = tf.uniform(tf.PRNGKey(KEY), (4, r))
    assert got.dtype == torch.float32
    assert _same(got, jax.random.uniform(jax.random.PRNGKey(KEY), (4, r),
                                         dtype=jnp.float32))


@pytest.mark.parametrize("n", [1, 3, 1440, 4096, 2**31 - 1])
def test_randint(n):
    got = tf.randint(tf.PRNGKey(KEY), (5000,), 0, n)
    want = jax.random.randint(jax.random.PRNGKey(KEY), (5000,), 0, n)
    assert got.dtype == torch.int32 and _same(got, want)


@pytest.mark.parametrize("seed", [0, 1442])
def test_normal(seed):
    """2 x 2^19 draws per key, with keys folded as the path tracer folds
    its camera key."""
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 0xC0FFEE)
    tkey = tf.fold_in(tf.PRNGKey(seed), 0xC0FFEE)
    for s in range(2):
        want = jax.random.normal(jax.random.fold_in(jkey, s), (2, 1 << 19),
                                 dtype=jnp.float32)
        got = tf.normal(tf.fold_in(tkey, s), (2, 1 << 19))
        assert _same(got, want)


def test_erf_inv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0, -0.0, 0.5, -0.999999, 0.41421354,
                      np.nextafter(np.float32(0.41421357), np.float32(1))],
                     dtype=torch.float32)
    want = jax.lax.erf_inv(jnp.asarray(x.numpy()))
    assert _same(tf.erf_inv(x), want)


def test_camera_jitter_matches_jitted_jax():
    """The jittered camera rays equal the JAX package's under jit (the
    per-sample renderer's form): the jitter fused into the pixel sum."""
    from ipu_ray_lib_tpu.ops.camera import generate_camera_rays as jcam

    rows = np.repeat(np.arange(24, dtype=np.float32), 20)
    cols = np.tile(np.arange(20, dtype=np.float32), 24)
    fov = 0.7
    want = jax.jit(lambda r, c, k: jcam(r, c, 20, 24, fov, 0.25, k)[1])(
        jnp.asarray(rows), jnp.asarray(cols),
        jax.random.fold_in(jax.random.PRNGKey(3), 0xC0FFEE))
    o, got = generate_camera_rays(torch.from_numpy(rows),
                                  torch.from_numpy(cols), 20, 24, fov, 0.25,
                                  tf.fold_in(tf.PRNGKey(3), 0xC0FFEE))
    assert _same(got, want) and not o.any()
    _, plain = generate_camera_rays(torch.from_numpy(rows),
                                    torch.from_numpy(cols), 20, 24, fov)
    assert not torch.equal(plain, got)
