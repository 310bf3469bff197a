"""The port's NIF environment light against the JAX package's.

* The port's ``.h5`` reader (numpy + struct, no h5py) equals the JAX
  package's h5py loader on both in-repo weight files and on files h5py
  writes, and refuses what lies outside its subset.
* Metadata, structure detection and packing equal the JAX package's
  (``NifMetadata``, ``NifModel.from_weights``, ``pack_env_mlp``).
* The UV map equals the JAX kernel's jnp twins (``_atan2``, ``_acos``,
  megakernel.py:2314-2321) bit for bit, run op by op. The Fourier
  features are the correctly rounded f32 sin/cos (float64 rounded); the
  jnp ones are within one ulp of them and round to the same bf16 values.
* The plain env MLP against the JAX in-kernel MLP math (bf16 operands,
  ``dot_general`` with f32 accumulation, f32 bias) on 4,096 seeded
  directions: the sums run in another order, so a split tolerance holds
  instead of equality (at least 99% within rtol 1e-5, all within 5e-2).
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax

from ipu_ray_lib_tpu.nif.hdf5 import (DenseLayer as JDenseLayer,
                                      NifWeights as JNifWeights,
                                      load_keras_h5 as jax_load_h5,
                                      save_keras_h5)
from ipu_ray_lib_tpu.nif.metadata import NifMetadata as JNifMetadata
from ipu_ray_lib_tpu.nif.model import load_nif_env as jax_load_nif_env
from ipu_ray_lib_tpu.ops.pallas import megakernel as JM
from ipu_ray_lib_tpu_torch.nif import hdf5
from ipu_ray_lib_tpu_torch.nif.metadata import NifMetadata
from ipu_ray_lib_tpu_torch.nif.model import (NifConfig, NifEnv, decode_rgb,
                                             equirect_uvn, fourier_features,
                                             from_jax_params, load_nif_env)
from ipu_ray_lib_tpu_torch.ops import env as envk

ROOT = os.path.join(os.path.dirname(__file__), "..")
URBAN = os.path.join(ROOT, "assets", "nif", "synthetic_urban_4k")
SKY = os.path.join(ROOT, "assets", "nif", "synthetic_sky", "assets.extra")
ALLEY = os.path.join(ROOT, "assets", "nif", "urban_alley_01_4k_fp16_yuv",
                     "assets.extra")
H5_FILES = {"urban_4k": os.path.join(URBAN, "model.h5"),
            "sky": os.path.join(SKY, "model.h5")}


def _bits(a: np.ndarray) -> np.ndarray:
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


def _same_layers(port, ref):
    assert len(port.layers) == len(ref.layers) > 0
    for a, b in zip(port.layers, ref.layers):
        assert (a.name, a.activation, a.dtype) == (b.name, b.activation,
                                                   b.dtype)
        assert a.kernel.dtype == b.kernel.dtype
        assert a.kernel.shape == b.kernel.shape
        np.testing.assert_array_equal(_bits(a.kernel), _bits(b.kernel))
        assert (a.bias is None) == (b.bias is None)
        if a.bias is not None:
            np.testing.assert_array_equal(_bits(a.bias), _bits(b.bias))


@pytest.mark.parametrize("name", sorted(H5_FILES))
def test_h5_reader_matches_h5py(name):
    path = H5_FILES[name]
    _same_layers(hdf5.load_keras_h5(path), jax_load_h5(path))


@pytest.mark.parametrize("name", sorted(H5_FILES))
def test_h5_attributes_match_h5py(name):
    import h5py

    path = H5_FILES[name]
    with h5py.File(path, "r") as f:
        want = {k: f.attrs[k] for k in f.attrs}
    assert set(want) == {"model_config", "keras_version", "backend"}
    for k, v in want.items():
        assert hdf5._H5File(path).attribute("/", k) == (
            v.decode() if isinstance(v, bytes) else v)


@pytest.mark.parametrize("dtype", [np.float16, np.float32])
def test_h5_reader_reads_files_h5py_writes(tmp_path, dtype):
    rng = np.random.default_rng(4)
    layers = [
        JDenseLayer("dense_0", "relu", rng.normal(size=(8, 16)).astype(dtype),
                    rng.normal(size=16).astype(dtype), np.dtype(dtype).name),
        JDenseLayer("dense_1", "linear",
                    rng.normal(size=(24, 3)).astype(dtype), None,
                    np.dtype(dtype).name),
    ]
    path = str(tmp_path / "m.h5")
    save_keras_h5(path, JNifWeights(layers=layers), embedding_dimension=2)
    _same_layers(hdf5.load_keras_h5(path), jax_load_h5(path))


def test_h5_reader_refuses_outside_subset(tmp_path):
    import h5py

    path = str(tmp_path / "chunked.h5")
    with h5py.File(path, "w") as f:
        f.create_dataset("x", data=np.ones((64, 64), np.float32),
                         chunks=(8, 8), compression="gzip")
    f5 = hdf5._H5File(path)
    with pytest.raises(ValueError, match="filter pipeline|layout class"):
        f5.dataset("/x")
    with pytest.raises(ValueError, match="no object"):
        f5.dataset("/missing")
    bad = tmp_path / "not.h5"
    bad.write_bytes(b"not an hdf5 file at all" * 4)
    with pytest.raises(ValueError, match="signature"):
        hdf5.load_keras_h5(str(bad))


@pytest.mark.parametrize("assets", [URBAN, SKY, ALLEY])
def test_metadata_matches_jax(assets):
    path = os.path.join(assets, "nif_metadata.txt")
    a, b = NifMetadata.load(path), JNifMetadata.load(path)
    for f in ("embedding_dimension", "name", "image_shape", "eps",
              "log_tone_map", "max", "hidden_size"):
        assert getattr(a, f) == getattr(b, f), f
    np.testing.assert_array_equal(a.mean, b.mean)


@pytest.fixture(scope="module")
def urban():
    """(port NifEnv, JAX env_fn, JAX params) of the urban_4k NIF."""
    env_fn, params = jax_load_nif_env(URBAN)
    return load_nif_env(URBAN, device="cpu"), env_fn, params


def test_structure_matches_jax(urban):
    env, env_fn, params = urban
    j = env_fn.nif_config
    c = env.config
    assert (c.embedding_dimension, c.activations, c.concat_before,
            c.log_tone_map) == (j.embedding_dimension, j.activations,
                                j.concat_before, j.log_tone_map)
    assert c.concat_before == (False, False, False, True, False, False)
    assert float(env.max) == float(params["max"])
    np.testing.assert_array_equal(env.mean.numpy(), np.asarray(params["mean"]))
    assert float(env.rotation) == 0.0


def test_packed_layers_match_jax_pack(urban):
    """NifEnv's one packed layout is pack_env_mlp's bf16 wstack / f32
    ebias / econst with the padding removed."""
    env, env_fn, params = urban
    (P, E, layers, log_tm), (wstack, ebias, econst) = JM.pack_env_mlp(
        env_fn.nif_config, params)
    packed = env
    assert packed.layers == layers and env.config.embedding_dimension == E
    assert env.config.log_tone_map == log_tm
    w = np.asarray(wstack.astype(jnp.float32))
    be = np.asarray(ebias)
    for l, (cin, cout, _, _) in enumerate(layers):
        woff, boff = (int(x) for x in packed.table[l, 4:6])
        assert packed.table[l, :4].tolist() == [cin, cout, *layers[l][2:]]
        np.testing.assert_array_equal(
            packed.w[woff:woff + cin * cout].view(cin, cout)
            .to(torch.float32).numpy(), w[l * P:l * P + cout, 0:cin].T)
        np.testing.assert_array_equal(packed.b[boff:boff + cout].numpy(),
                                      be[0:cout, l])
    np.testing.assert_array_equal(packed.econst.numpy(),
                                  np.asarray(econst)[0, 0:5])
    assert packed.macs == 441280
    assert packed.table.dtype == torch.int32
    assert all(int(o) % 8 == 0 for o in packed.table[:, 4:].flatten())
    for l, (cin, cout, _, _) in enumerate(layers):  # layer() views it
        w_l, b_l = env.layer(l)
        assert w_l.shape == (cin, cout) and b_l.shape == (cout,)
        assert w_l.data_ptr() == env.w[int(packed.table[l, 4]):].data_ptr()


def _directions(n, seed):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    axes = np.array([[0, 1, 0], [0, -1, 0], [1, 0, 0], [-1, 0, 0],
                     [0, 0, 1], [0, 0, -1]], np.float32)
    return np.concatenate([axes, d])


def _jax_uvn(d: np.ndarray, rot: float):
    """megakernel.py:2314-2321 op by op, on [1, N] rows."""
    dj = jnp.asarray(d.T)
    dy = jnp.clip(dj[1:2], -1.0, 1.0)
    theta = JM._acos(dy)
    phi = JM._atan2(dj[2:3], dj[0:1]) + jnp.float32(rot)
    two_pi = np.float32(2.0 * np.pi)
    phi = jnp.where(phi < 0.0, phi + two_pi, phi)
    phi = jnp.where(phi > two_pi, phi - two_pi, phi)
    un = 2.0 * (theta * np.float32(1.0 / np.pi) - 1.0)
    vn = 2.0 * (phi * np.float32(0.5 / np.pi) - 1.0)
    return un, vn


@pytest.mark.parametrize("rot_deg", [0.0, 30.0, -200.0])
def test_uv_map_matches_kernel_twins(rot_deg):
    d = _directions(4096, 1)
    rot = np.float32(np.deg2rad(rot_deg))
    un_j, vn_j = _jax_uvn(d, rot)
    un, vn = equirect_uvn(torch.from_numpy(d), torch.tensor(rot))
    np.testing.assert_array_equal(un.numpy(), np.asarray(un_j)[0])
    np.testing.assert_array_equal(vn.numpy(), np.asarray(vn_j)[0])


def test_jitted_uv_map_differs_from_op_by_op():
    """The same jnp UV map under ``jax.jit``, as the JAX render runs it in
    its jitted kernel, rounds otherwise than op by op. Measured on the
    directions of test_uv_map_matches_kernel_twins: un differs in 41.6%
    and vn in 42.7% of them (66.3% either), by at most 2.4e-7 (two ulps
    of 1). The port follows the op-by-op form (the test above); the E =
    12 features scale that by up to 2,048. What it does to a render is
    in tests/test_torch_env.py."""
    d = _directions(4096, 1)
    un_o, vn_o = (np.asarray(a)[0] for a in _jax_uvn(d, 0.0))
    un_j, vn_j = (np.asarray(a)[0]
                  for a in jax.jit(lambda dd: _jax_uvn(dd, 0.0))(d))
    un_d, vn_d = un_o != un_j, vn_o != vn_j
    assert 0.3 < un_d.mean() < 0.55 and 0.3 < vn_d.mean() < 0.55
    assert 0.55 < (un_d | vn_d).mean() < 0.8
    assert np.abs(un_o - un_j).max() <= 2.4e-7
    assert np.abs(vn_o - vn_j).max() <= 2.4e-7


def test_features_are_correctly_rounded():
    """Measured (seed 1, 4,102 directions x 48 features): the jnp features
    differ from the correctly rounded ones by one ulp in 1.36%, and none
    of the bf16-rounded features differ."""
    d = _directions(4096, 1)
    un_j, vn_j = _jax_uvn(d, 0.0)
    E = 12
    un, vn = equirect_uvn(torch.from_numpy(d), torch.tensor(0.0))
    feats = fourier_features(un, vn, E).numpy()
    coeff = (2.0 ** np.arange(E)).astype(np.float32)
    pu = un.numpy()[:, None] * coeff
    pv = vn.numpy()[:, None] * coeff
    cr = np.concatenate([np.sin(pu.astype(np.float64)),
                         np.sin(pv.astype(np.float64)),
                         np.cos(pu.astype(np.float64)),
                         np.cos(pv.astype(np.float64))], 1).astype(np.float32)
    np.testing.assert_array_equal(feats, cr)
    cj = jnp.asarray(coeff)[:, None]
    fj = np.asarray(jnp.concatenate(
        [jnp.sin(un_j * cj), jnp.sin(vn_j * cj), jnp.cos(un_j * cj),
         jnp.cos(vn_j * cj)], axis=0)).T
    ulp = np.abs(fj.view(np.int32).astype(np.int64)
                 - feats.view(np.int32).astype(np.int64))
    assert ulp.max() <= 1
    assert (ulp > 0).mean() < 0.05
    bf = lambda a: torch.tensor(a).to(torch.bfloat16).to(torch.float32)
    assert int((bf(fj) != bf(feats)).sum()) <= 8


def _jax_mlp(d: np.ndarray, env_fn, params) -> np.ndarray:
    """The JAX kernel's MLP (megakernel.py:2332-2360) on [P, N] slabs, op
    by op: bf16 operands, dot_general with f32 accumulation, f32 bias."""
    (P, E, layers, log_tm), (wstack, ebias, econst) = JM.pack_env_mlp(
        env_fn.nif_config, params)
    N = d.shape[0]
    un, vn = _jax_uvn(d, float(params.get("rotation", 0.0)))
    coeff = jnp.asarray(2.0 ** np.arange(E), jnp.float32)[:, None]
    feats = jnp.concatenate([jnp.sin(un * coeff), jnp.sin(vn * coeff),
                             jnp.cos(un * coeff), jnp.cos(vn * coeff)], 0)
    x = jnp.concatenate([feats, jnp.zeros((P - 4 * E, N), jnp.float32)])
    for l, (cin, cout, relu, concat) in enumerate(layers):
        if concat:
            x = jnp.concatenate([x[0:cin - 4 * E], feats,
                                 jnp.zeros((P - cin, N), jnp.float32)])
        y = lax.dot_general(wstack[l * P:(l + 1) * P], x.astype(jnp.bfloat16),
                            (((1,), (0,)), ((), ())),
                            preferred_element_type=jnp.float32)
        y = y + ebias[:, l:l + 1]
        if relu:
            y = jnp.maximum(y, 0.0)
        x = (jnp.concatenate([y[0:cout], jnp.zeros((P - cout, N),
                                                   jnp.float32)])
             if l + 1 < len(layers) else y)
    bgr = [x[c:c + 1] * econst[0:1, 1:2] + econst[0:1, 2 + c:3 + c]
           for c in range(3)]
    if log_tm:
        bgr = [jnp.exp(b) for b in bgr]
    return np.asarray(jnp.concatenate([bgr[2], bgr[1], bgr[0]])).T


def test_env_mlp_ref_vs_jax_kernel_math(urban):
    """Measured (seed 2, 4,102 directions): 99.56% of the RGB values
    within rtol 1e-5 (85.2% bit for bit), the largest relative difference
    1.43e-2. The differences come from the sum order (one ascending f32
    accumulator here, XLA's blocked dot there): a hidden activation that
    rounds to the other bf16 neighbour, amplified by exp(x * 8.95)."""
    env, env_fn, params = urban
    d = _directions(4096, 2)
    want = _jax_mlp(d, env_fn, params)
    got = envk.env_mlp_ref(torch.from_numpy(d), env).numpy()
    assert got.shape == (d.shape[0], 3) and np.isfinite(got).all()
    rel = np.abs(got - want) / np.abs(want)
    assert (rel <= 1e-5).mean() >= 0.99
    assert rel.max() <= 5e-2


def test_env_mlp_on_cpu_runs_the_plain_version(urban):
    env = urban[0]
    d = torch.from_numpy(_directions(256, 3))
    envk.reset_launches()
    a = envk.env_mlp(d, env)
    b = env(d)
    assert envk.launches == 0
    assert torch.equal(a, envk.env_mlp_ref(d, env)) and torch.equal(a, b)
    assert (a > 0).all()


def test_from_jax_params_equals_loaded(urban):
    env, env_fn, params = urban
    carried = from_jax_params(
        env_fn.nif_config,
        {k: ([np.asarray(x) for x in v] if isinstance(v, tuple)
             else np.asarray(v)) for k, v in params.items()})
    for (ka, a), (kb, b) in zip(env.state_dict().items(),
                                carried.state_dict().items()):
        assert ka == kb and torch.equal(a, b), ka


def test_rotation_moves_the_env(urban):
    env = urban[0]
    rot = load_nif_env(URBAN, 90.0, device="cpu")
    assert float(rot.rotation) == float(np.float32(np.deg2rad(90.0)))
    d = torch.from_numpy(_directions(64, 5))
    assert not torch.equal(envk.env_mlp_ref(d, env),
                           envk.env_mlp_ref(d, rot))


def test_rejects_bad_inputs(urban):
    env = urban[0]
    with pytest.raises(ValueError, match="dirs"):
        envk.env_mlp(torch.zeros((4, 2)), env)
    with pytest.raises(ValueError, match="embedding_dimension"):
        NifEnv(NifConfig(21, ("none",), (False,), True),
               [np.zeros((84, 3), np.float32)], [None], 1.0,
               np.zeros(3, np.float32))
    with pytest.raises(FileNotFoundError):
        load_nif_env(os.path.join(ROOT, "assets", "nif",
                                  "urban_alley_01_4k_fp16_yuv",
                                  "assets.extra"), device="cpu")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _matmul_chain(d, env):
    """The env MLP as a chain of bf16 torch.matmul calls (the yardstick
    chip_smoke.py times; the port never calls it)."""
    un, vn = equirect_uvn(d, env.rotation)
    feats = fourier_features(un, vn, env.config.embedding_dimension)
    x = feats
    for l, (_, _, relu, concat) in enumerate(env.layers):
        w, b = env.layer(l)
        if concat:
            x = torch.cat([x, feats], dim=1)
        x = torch.matmul(x.to(torch.bfloat16), w).to(torch.float32) + b
        if relu:
            x = torch.clamp_min(x, 0.0)
    return decode_rgb(x, env.max, env.mean, env.config.log_tone_map)


@pytest.mark.cuda
def test_cuda_env_mlp_matches_plain(urban, cuda_device):
    """The tensor-core kernel sums in its own order, so it is held to the
    gate chip_smoke.py applies (ops/env.py ``within_yardstick``): no
    further from the plain version than the torch.matmul chain on the same
    card, plus the stated slack, and within the high-frequency tolerance;
    its launch count exactly."""
    env = urban[0].to(cuda_device)
    d = torch.from_numpy(_directions(4096, 6)).to(cuda_device)
    envk.reset_launches()
    got = envk.env_mlp(d, env)
    torch.cuda.synchronize()
    assert envk.launches == 1
    want = envk.env_mlp_ref(d, env).cpu()
    assert bool(torch.isfinite(got).all())
    kernel = envk.deviation(got.cpu(), want)
    chain = envk.deviation(_matmul_chain(d, env).cpu(), want)
    assert envk.within_yardstick(kernel, chain) == [], (kernel, chain)
