"""NIF training: fit the Fourier-feature MLP to an HDRI.

Port of ``ipu_ray_lib_tpu/nif/train.py`` from optax to
``torch.optim.Adam`` with optax's ``adam`` defaults (betas 0.9, 0.999, eps
1e-8), on any device (the CUDA card by default). Its random numbers are
the JAX package's: ``make_nif`` draws each layer's kernel as
``normal(k, (d_in, d_out)) * sqrt(2/d_in)`` and every step its batch of
pixels as two ``randint`` draws from a split key, from the jax-free
threefry (utils/threefry.py), so the port sees the JAX package's
initial weights and batches. The batch's uv is ``rows * f32(1/h)``, as
XLA compiles ``rows / h``. The loss is the mean squared error of the
network's raw output (nif/model.py ``NifModel.raw``) against the
encoded targets.

The products are f32 (``torch.matmul``; TF32 stays off, its default),
so the loss curve differs from the JAX package's only by the order of
the sums of the forward and backward passes and of the optimiser's
arithmetic.

Encoding matches the reference decode contract (NifModel.cpp:222-246 /
NifMetaData.cpp:49-53): images are log-tone-mapped with eps, per-channel
mean-centred and scaled by the max absolute value, and stored in BGR
channel order.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from ..runtime.device import cuda_device
from ..utils import threefry
from .hdf5 import DenseLayer, NifWeights, save_keras_h5
from .metadata import NifMetadata
from .model import NifConfig, NifModel


def make_nif(key: torch.Tensor, embedding_dimension: int = 12,
             layer_count: int = 6, layer_size: int = 320,
             log_tone_map: bool = True, device=None) -> NifModel:
    """A fresh random NIF on ``device`` (None: the CUDA card, which must be
    present; ``"cpu"`` for the CPU) with the reference family's
    architecture: a dense stack with one skip-concat of the encoded input
    at the midpoint."""
    device = cuda_device() if device is None else torch.device(device)
    e4 = 4 * embedding_dimension
    concat_at = layer_count // 2
    dims, concat, acts = [], [], []
    cur = e4
    for i in range(layer_count):
        cat = i == concat_at and layer_count > 1
        d_out = 3 if i == layer_count - 1 else layer_size
        dims.append((cur + (e4 if cat else 0), d_out))
        concat.append(cat)
        acts.append("none" if i == layer_count - 1 else "relu")
        cur = d_out
    kernels, biases = [], []
    for d_in, d_out in dims:
        key, k1 = threefry.split(key)
        scale = float(np.sqrt(np.float32(2.0 / d_in)))
        kernels.append(threefry.normal(k1, (d_in, d_out), device) * scale)
        biases.append(torch.zeros(d_out))
    config = NifConfig(embedding_dimension=embedding_dimension,
                       activations=tuple(acts), concat_before=tuple(concat),
                       log_tone_map=log_tone_map)
    return NifModel(config, [k.cpu() for k in kernels], biases,
                    device=device)


def encode_targets(image_rgb: np.ndarray, eps: float = 1e-8,
                   log_tone_map: bool = True):
    """RGB HDR image -> (targets_bgr, max, mean): the training-space encode
    whose inverse is the model's decode."""
    bgr = np.asarray(image_rgb, np.float32)[..., ::-1]
    enc = np.log(bgr + eps) if log_tone_map else bgr
    mean = enc.reshape(-1, 3).mean(axis=0)
    centred = enc - mean
    mx = float(np.abs(centred).max()) or 1.0
    return ((centred / mx).astype(np.float32), np.float32(mx),
            mean.astype(np.float32))


def batch_pixels(key: torch.Tensor, batch_size: int, h: int, w: int,
                 device=None):
    """One step's pixels: (rows, cols) [batch_size] int64 on ``device``
    (default the key's) from the step's key, as the JAX step draws them
    (split, then randint each)."""
    kr, kc = threefry.split(key)
    rows = threefry.randint(kr, (batch_size,), 0, h, device).long()
    cols = threefry.randint(kc, (batch_size,), 0, w, device).long()
    return rows, cols


def train_nif(image_rgb: np.ndarray, embedding_dimension: int = 12,
              layer_count: int = 6, layer_size: int = 320, steps: int = 2000,
              batch_size: int = 4096, learning_rate: float = 1e-3,
              eps: float = 1e-8, log_tone_map: bool = True, seed: int = 0,
              device=None, losses: list | None = None
              ) -> tuple[NifModel, NifMetadata]:
    """Fit a NIF to ``image_rgb`` [H, W, 3] on ``device`` (None: the CUDA
    card, which must be present; ``"cpu"`` for the CPU). ``losses`` (a
    list) gains every step's loss as a float (read once, at the end)."""
    if device is None:
        device = cuda_device()
    device = torch.device(device)
    h, w = image_rgb.shape[:2]
    targets, mx, mean = encode_targets(image_rgb, eps, log_tone_map)
    targets = torch.from_numpy(targets.reshape(-1, 3)).to(device)

    key = threefry.PRNGKey(seed)  # on the host; the draws on the device
    key, mkey = threefry.split(key)
    model = make_nif(mkey, embedding_dimension, layer_count, layer_size,
                     log_tone_map, device)
    opt = torch.optim.Adam(model.parameters(), lr=learning_rate,
                           betas=(0.9, 0.999), eps=1e-8)
    inv_h = float(np.float32(1.0) / np.float32(h))
    inv_w = float(np.float32(1.0) / np.float32(w))
    step_losses = []
    for _ in range(steps):
        key, sk = threefry.split(key)
        rows, cols = batch_pixels(sk, batch_size, h, w, device)
        uv = torch.stack([rows.to(torch.float32) * inv_h,
                          cols.to(torch.float32) * inv_w], dim=-1)
        loss = torch.mean((model.raw(uv) - targets[rows * w + cols]) ** 2)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        step_losses.append(loss.detach())
    if losses is not None and step_losses:
        losses.extend(torch.stack(step_losses).cpu().tolist())

    mean = mean - (np.float32(eps) if log_tone_map else np.float32(0.0))
    with torch.no_grad():
        model.max.fill_(float(mx))
        model.mean.copy_(torch.from_numpy(mean))
    meta = NifMetadata(embedding_dimension=embedding_dimension,
                       name="trained", image_shape=[h, w, 3], eps=eps,
                       log_tone_map=log_tone_map, max=mx,
                       mean=np.asarray(mean), hidden_size=layer_size)
    return model, meta


def save_nif_assets(model: NifModel, meta: NifMetadata, out_dir: str,
                    fp16: bool = True) -> None:
    """Write an assets.extra-style directory (nif_metadata.txt + model.h5),
    which ``load_nif_env`` reads."""
    os.makedirs(out_dir, exist_ok=True)
    meta.save(os.path.join(out_dir, "nif_metadata.txt"), train_command=[
        "train_nif.py", "--layer-size", str(meta.hidden_size),
        "--embedding-dimension", str(meta.embedding_dimension)])
    dtype = np.float16 if fp16 else np.float32
    layers = [
        DenseLayer(name=f"dense_{i}",
                   activation=("relu" if model.config.activations[i] == "relu"
                               else "linear"),
                   kernel=k.detach().cpu().numpy().astype(dtype),
                   bias=b.detach().cpu().numpy().astype(dtype),
                   dtype=str(np.dtype(dtype)))
        for i, (k, b) in enumerate(zip(model.kernels, model.biases))]
    save_keras_h5(os.path.join(out_dir, "model.h5"), NifWeights(layers=layers),
                  meta.embedding_dimension)
