"""NIF training in the port (nif/train.py, nif/synth.py, the f32
``NifModel``, ``NifMetadata.save`` and the h5py-free ``.h5`` writer)
against the JAX package on the CPU.

Exact: ``synth_hdri``, ``encode_targets``, ``make_nif``'s initial weights
(threefry ``normal``), each step's batch of pixels and its uv for 20
steps (threefry ``split`` + ``randint``; uv as XLA compiles ``rows / h``,
a product with f32(1/h)), and the metadata file.

Measured here, and held with a margin:

* the f32 forward against ``NifModel.apply`` (``compute_dtype=
  "float32"``, jitted) on 2,000 uv: largest relative difference 5.8e-7 at
  3 x 16, E = 3, and 1.6e-6 at 6 x 320, E = 12 (held at 1e-5): the
  matmuls sum in another order and XLA's f32 ``sin``/``cos`` are not
  correctly rounded;
* one Adam step from the same weights and batch against optax's ``adam``
  (held at 1e-5 relative to the largest weight; the two order the update's
  arithmetic differently);
* the 50-step loss curve at 3 x 16, E = 3, batch 256: largest relative
  difference 1.1e-5 (held at 1e-4), the trained weights within 6e-7.

``save_nif_assets`` writes an ``.h5`` that h5py, the JAX package's loader
and the port's reader all read back to the written weights, and
``load_nif_env`` on that directory renders a finite image. Both
examples (``examples/train_nif_demo_torch.py``,
``examples/train_reference_nif_torch.py``) run end to end at tiny sizes,
and ``train_nif``/``make_nif`` raise without a card unless given a
device.
"""

import torch_threads  # noqa: F401  (first: one torch thread)

import json
import os
import sys

import h5py
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from ipu_ray_lib_tpu.nif import train as JT
from ipu_ray_lib_tpu.nif.hdf5 import load_keras_h5 as jax_load_keras_h5
from ipu_ray_lib_tpu.nif.metadata import NifMetadata as JMeta
from ipu_ray_lib_tpu.nif.model import NifConfig as JCfg
from ipu_ray_lib_tpu.nif.model import NifModel as JModel
from ipu_ray_lib_tpu.nif.synth import synth_hdri as jax_synth
from ipu_ray_lib_tpu_torch.nif import train as TT
from ipu_ray_lib_tpu_torch.nif.hdf5 import load_keras_h5
from ipu_ray_lib_tpu_torch.nif.metadata import NifMetadata
from ipu_ray_lib_tpu_torch.nif.model import load_nif_env
from ipu_ray_lib_tpu_torch.nif.synth import synth_hdri
from ipu_ray_lib_tpu_torch.render.streaming import render_streaming
from ipu_ray_lib_tpu_torch.scene.build import build_scene
from ipu_ray_lib_tpu_torch.scene.builtin import make_primitive_scene
from ipu_ray_lib_tpu_torch.utils import threefry as tf

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
SMALL = (3, 3, 16)  # E, layers, width
BATCH, STEPS = 256, 50


@pytest.fixture(scope="module")
def image():
    return jax_synth(32, 64, seed=5)


def test_synth_hdri_matches_jax():
    a, b = synth_hdri(48, 96, seed=3), jax_synth(48, 96, seed=3)
    assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


def test_encode_targets_match_jax(image):
    for log_tm in (True, False):
        got = TT.encode_targets(image, log_tone_map=log_tm)
        want = JT.encode_targets(image, log_tone_map=log_tm)
        assert all(np.array_equal(g, w) and np.asarray(g).dtype ==
                   np.asarray(w).dtype for g, w in zip(got, want))


@pytest.mark.parametrize("arch", [SMALL, (12, 6, 320)])
def test_make_nif_matches_jax(arch):
    want = JT.make_nif(jax.random.PRNGKey(4), *arch)
    got = TT.make_nif(tf.PRNGKey(4), *arch, device="cpu")
    assert got.config.concat_before == want.config.concat_before
    assert got.config.activations == want.config.activations
    for k, p in zip(want.params["kernels"], got.kernels):
        assert np.array_equal(np.asarray(k), p.detach().numpy())
    for b, p in zip(want.params["biases"], got.biases):
        assert not p.detach().any() and p.shape == b.shape


@pytest.mark.parametrize("arch", [SMALL, (12, 6, 320)])
def test_forward_matches_jax(arch):
    uv = np.random.default_rng(1).random((2000, 2)).astype(np.float32)
    jm = JT.make_nif(jax.random.PRNGKey(4), *arch)
    want = np.asarray(jax.jit(lambda p, u: JModel.apply(jm.config, p, u))(
        jm.params, jnp.asarray(uv)))
    model = TT.make_nif(tf.PRNGKey(4), *arch, device="cpu")
    got = model(torch.from_numpy(uv))
    rel = np.abs(got.detach().numpy() - want) / np.abs(want)
    assert rel.max() <= 1e-5, rel.max()


def _jax_training(image, steps, with_batches=False):
    """The JAX package's training loop (nif/train.py:91-150), replicated
    so that each step's loss and batch can be read: (losses, batches,
    trained kernels)."""
    h, w = image.shape[:2]
    targets = jnp.asarray(JT.encode_targets(image)[0].reshape(-1, 3))
    key = jax.random.PRNGKey(0)
    key, mkey = jax.random.split(key)
    model = JT.make_nif(mkey, *SMALL)
    c = model.config
    rcfg = JCfg(c.embedding_dimension, c.activations, c.concat_before, False,
                "float32")
    ones = {"max": jnp.float32(1.0), "mean": jnp.zeros(3, jnp.float32)}
    tr = {"kernels": model.params["kernels"],
          "biases": model.params["biases"]}
    opt = optax.adam(1e-3)
    st = opt.init(tr)

    @jax.jit
    def step(tr, st, key):
        kr, kc = jax.random.split(key)
        rows = jax.random.randint(kr, (BATCH,), 0, h)
        cols = jax.random.randint(kc, (BATCH,), 0, w)
        uv = jnp.stack([rows / h, cols / w], axis=-1).astype(jnp.float32)
        y = targets[rows * w + cols]
        loss, g = jax.value_and_grad(lambda t: jnp.mean(
            (JModel.apply(rcfg, {**t, **ones}, uv) - y) ** 2))(tr)
        up, st = opt.update(g, st)
        return optax.apply_updates(tr, up), st, loss, rows, cols, uv

    losses, batches = [], []
    for _ in range(steps):
        key, sk = jax.random.split(key)
        tr, st, loss, rows, cols, uv = step(tr, st, sk)
        losses.append(float(loss))
        if with_batches:
            batches.append(tuple(np.asarray(a) for a in (rows, cols, uv)))
    return np.array(losses), batches, [np.asarray(k) for k in tr["kernels"]]


def test_batches_match_jax(image):
    h, w = image.shape[:2]
    _, batches, _ = _jax_training(image, 20, with_batches=True)
    key = tf.PRNGKey(0)
    key, _ = tf.split(key)
    inv = lambda n: float(np.float32(1.0) / np.float32(n))
    for rows_w, cols_w, uv_w in batches:
        key, sk = tf.split(key)
        rows, cols = TT.batch_pixels(sk, BATCH, h, w)
        uv = torch.stack([rows.float() * inv(h), cols.float() * inv(w)], -1)
        assert np.array_equal(rows.numpy(), rows_w)
        assert np.array_equal(cols.numpy(), cols_w)
        assert np.array_equal(uv.numpy().view(np.int32), uv_w.view(np.int32))


def test_adam_step_matches_optax():
    E, L, S = SMALL
    jm = JT.make_nif(jax.random.PRNGKey(9), E, L, S)
    tm = TT.make_nif(tf.PRNGKey(9), E, L, S, device="cpu")
    rng = np.random.default_rng(2)
    uv = rng.random((BATCH, 2)).astype(np.float32)
    y = rng.standard_normal((BATCH, 3)).astype(np.float32) * 0.3
    c = jm.config
    rcfg = JCfg(c.embedding_dimension, c.activations, c.concat_before, False,
                "float32")
    tr = {"kernels": jm.params["kernels"], "biases": jm.params["biases"]}
    ones = {"max": jnp.float32(1.0), "mean": jnp.zeros(3, jnp.float32)}
    opt = optax.adam(1e-3)
    g = jax.grad(lambda t: jnp.mean((JModel.apply(rcfg, {**t, **ones},
                                                  jnp.asarray(uv)) - y) ** 2))(tr)
    up, _ = opt.update(g, opt.init(tr))
    want = optax.apply_updates(tr, up)
    topt = torch.optim.Adam(tm.parameters(), lr=1e-3, betas=(0.9, 0.999),
                            eps=1e-8)
    loss = torch.mean((tm.raw(torch.from_numpy(uv)) - torch.from_numpy(y)) ** 2)
    loss.backward()
    topt.step()
    for k0, k, p in zip(jm.params["kernels"], want["kernels"], tm.kernels):
        k0, k = np.asarray(k0), np.asarray(k)
        assert not np.array_equal(k, k0)  # the step moved the weights
        d = np.abs(p.detach().numpy() - k).max() / np.abs(k).max()
        assert d <= 1e-5, d


def test_loss_curve_matches_jax(image):
    want, _, kernels = _jax_training(image, STEPS)
    losses = []
    model, meta = TT.train_nif(image, *SMALL, steps=STEPS, batch_size=BATCH,
                               device="cpu", losses=losses)
    got = np.array(losses)
    assert got.shape == (STEPS,) and got[-1] < 0.5 * got[0]
    assert np.max(np.abs(got - want) / want) <= 1e-4
    for k, p in zip(kernels, model.kernels):
        assert np.abs(p.detach().numpy() - k).max() <= 1e-5
    jm, jmeta = JT.train_nif(image, *SMALL, steps=STEPS, batch_size=BATCH)
    for a, b in zip(jm.params["kernels"], kernels):  # the replica is the loop
        assert np.array_equal(np.asarray(a), b)
    assert meta.max == jmeta.max and np.array_equal(meta.mean, jmeta.mean)
    assert float(model.max) == float(jm.params["max"])
    assert np.array_equal(model.mean.numpy(), np.asarray(jm.params["mean"]))
    img = model.reconstruct_image(8, 16)
    jimg = jm.reconstruct_image(8, 16)
    assert img.shape == jimg.shape == (8, 16, 3)
    np.testing.assert_allclose(img, jimg, rtol=1e-3)


def test_metadata_save_matches_jax(tmp_path):
    kw = dict(embedding_dimension=3, name="trained", image_shape=[32, 64, 3],
              eps=1e-8, log_tone_map=True, max=np.float32(3.25),
              mean=np.array([-1.5, -1.25, -2.0], np.float32), hidden_size=16)
    NifMetadata(**kw).save(str(tmp_path / "t.txt"), train_command=["x"])
    JMeta(**kw).save(str(tmp_path / "j.txt"), train_command=["x"])
    assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()
    back = NifMetadata.load(str(tmp_path / "t.txt"))
    assert np.array_equal(back.mean, kw["mean"]) and back.hidden_size == 0


@pytest.mark.parametrize("fp16", [True, False])
def test_saved_assets_read_back(tmp_path, image, fp16):
    model, meta = TT.train_nif(image, *SMALL, steps=3, batch_size=64,
                               device="cpu")
    out = str(tmp_path / "nif")
    TT.save_nif_assets(model, meta, out, fp16=fp16)
    dt = np.float16 if fp16 else np.float32
    want = [(k.detach().numpy().astype(dt), b.detach().numpy().astype(dt))
            for k, b in zip(model.kernels, model.biases)]
    path = os.path.join(out, "model.h5")
    with h5py.File(path, "r") as f:
        cfg = json.loads(f.attrs["model_config"])
        assert f.attrs["backend"] == "jax"
        assert [l["class_name"] for l in cfg["config"]["layers"]] == \
            ["InputLayer"] + ["Dense"] * 3
        for i, (k, b) in enumerate(want):
            g = f[f"/model_weights/dense_{i}/dense_{i}"]
            assert np.array_equal(g["kernel:0"][()], k)
            assert np.array_equal(g["bias:0"][()], b)
    for loader in (load_keras_h5, jax_load_keras_h5):
        layers = loader(path).layers
        assert [l.activation for l in layers] == ["relu", "relu", "none"]
        for l, (k, b) in zip(layers, want):
            assert l.kernel.dtype == dt and np.array_equal(l.kernel, k)
            assert np.array_equal(l.bias, b)
    meta_back = NifMetadata.load(os.path.join(out, "nif_metadata.txt"))
    assert meta_back.hidden_size == 16 and meta_back.max == float(meta.max)

    env = load_nif_env(out, device="cpu")
    ts, params = build_scene(make_primitive_scene(), device="cpu",
                             image_width=16, image_height=16,
                             samples_per_pixel=1)
    rgb, done = render_streaming(ts, params, env=env)
    assert done == 256 and np.isfinite(rgb).all() and rgb.max() > 0


def test_writer_many_layers(tmp_path):
    """More members than one symbol-table node holds (two nodes)."""
    from ipu_ray_lib_tpu_torch.nif.hdf5 import (DenseLayer, NifWeights,
                                                save_keras_h5)

    rng = np.random.default_rng(0)
    layers = [DenseLayer(f"dense_{i}", "relu",
                         rng.standard_normal((4, 4)).astype(np.float32),
                         rng.standard_normal(4).astype(np.float32))
              for i in range(12)]
    path = str(tmp_path / "m.h5")
    save_keras_h5(path, NifWeights(layers), 1)
    with h5py.File(path, "r") as f:
        assert len(f["model_weights"]) == 12
    for l, w in zip(load_keras_h5(path).layers, layers):
        assert l.name == w.name and np.array_equal(l.kernel, w.kernel)


def test_demo_example_runs_on_the_cpu(tmp_path):
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    try:
        import train_nif_demo_torch as demo
    finally:
        sys.path.pop(0)
    rec = demo.main(["--device", "cpu", "--steps", "20", "--layer-size", "16",
                     "--layer-count", "3", "--embedding-dim", "2",
                     "--batch", "256", "--size", "8", "--spp", "2",
                     "--out", str(tmp_path)])
    assert len(rec["losses"]) == 20 and rec["losses"][-1] < rec["losses"][0]
    assert rec["image"].shape == (8, 8, 3) and np.isfinite(rec["image"]).all()
    assert os.path.exists(os.path.join(tmp_path, "spheres_nif.exr"))
    assert os.path.exists(os.path.join(rec["assets"], "model.h5"))


def test_reference_example_runs_on_the_cpu(tmp_path):
    """The 6 x 320, E = 12 reference network for two steps on a tiny sky;
    its assets load."""
    sys.path.insert(0, os.path.join(ROOT, "examples"))
    try:
        import train_reference_nif_torch as ref
    finally:
        sys.path.pop(0)
    rec = ref.main(["--device", "cpu", "--steps", "2", "--height", "16",
                    "--batch", "64", "--out", str(tmp_path)])
    assert len(rec["losses"]) == 2 and np.isfinite(rec["psnr"])
    env = load_nif_env(str(tmp_path), device="cpu")
    assert env.layers[0][:2] == (48, 320) and env.num_layers == 6


def test_no_card_raises(monkeypatch, image):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.train_nif(image, *SMALL, steps=1, batch_size=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.make_nif(tf.PRNGKey(0), *SMALL)
