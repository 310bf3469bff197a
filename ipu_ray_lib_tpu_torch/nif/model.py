"""Neural Image Field (NIF) environment light for the port.

Port of ``ipu_ray_lib_tpu/nif/model.py`` (``NifConfig``, ``from_weights``,
``load_nif_env``) in the form the JAX megakernel evaluates it in-kernel
(``ops/pallas/megakernel.py`` ``_env``, :2304-2361), which is what the
renderer's env term is:

* direction -> equirect UV with the kernel's polynomial ``_atan2`` /
  ``_acos`` (:264-285), the clip, the rotation add and the two wraps, then
  ``un = 2*(theta/pi - 1)``, ``vn = 2*(phi/(2 pi) - 1)`` (:2314-2321);
* Fourier features ``[sin(u 2^e), sin(v 2^e), cos(u 2^e), cos(v 2^e)]``,
  e < E (:2324-2331);
* the Dense stack in bf16 with f32 accumulation and an f32 bias, ReLU,
  and the skip-concat of the features auto-detected from the kernels'
  input widths (``NifModel.from_weights``);
* decode ``x*max + mean``, ``exp`` when log tone-mapped, BGR -> RGB.

:class:`NifModel` is the network in f32 as an ``nn.Module`` (the JAX
``NifModel.apply`` with ``compute_dtype="float32"``, nif/model.py:120-146):
Fourier features of uv [N, 2] (sin and cos correctly rounded), the
Dense stack with f32 products, decode. NIF training (nif/train.py)
differentiates through it; ``nif/train.py:save_nif_assets`` writes it
for ``load_nif_env``.

Two definitions are the port's own, and the kernel (``ops/cuda/
env_mlp.cu``) and the plain version (``ops/env.py``) share them so that
they agree bit for bit: each dense output is one f32 sum over the inputs
in ascending order (XLA's dot sums in another order), and ``sqrt``,
``sin``, ``cos`` and ``exp`` are the correctly rounded f32 values, taken
from the float64 functions (XLA's f32 ``sin`` is off by one ulp in about
1% of the feature arguments, torch's f32 CPU ``sqrt`` in about 0.6%).
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..runtime.device import cuda_device
from ..utils.constants import PI, PI_BY_2, TWO_PI
from .hdf5 import load_keras_h5
from .metadata import NifMetadata

# The largest embedding the kernel takes: the JAX kernel rebuilds 2^e as
# round(exp(ln2 * e)), exact only to about 2^20 (pack_env_mlp's check):
MAX_EMBEDDING = 20

# f32 constants, held as the Python floats of their f32 values:
_ATAN_C0 = float(np.float32(-0.0117212))
_ATAN_C = tuple(float(np.float32(c)) for c in (
    0.05265332, -0.11643287, 0.19354346, -0.33262347, 0.99997726))
_INV_PI = float(np.float32(1.0 / np.pi))
_HALF_INV_PI = float(np.float32(0.5 / np.pi))
_PI, _PI_BY_2, _TWO_PI = float(PI), float(PI_BY_2), float(TWO_PI)


@dataclass(frozen=True)
class NifConfig:
    """Static model structure (the JAX package's fields)."""

    embedding_dimension: int
    activations: Tuple[str, ...]
    concat_before: Tuple[bool, ...]  # concat encoded input before layer i
    log_tone_map: bool


# ---- the in-kernel math, in plain torch ----
def _f32_of_f64(fn, x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded f32 value of ``fn`` (evaluated in float64)."""
    return fn(x.to(torch.float64)).to(torch.float32)


def atan2_poly(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The kernel's f32 atan2: a degree-11 odd minimax polynomial
    (megakernel.py:264-279), one rounding per operation."""
    ax, ay = torch.abs(x), torch.abs(y)
    mx = torch.maximum(ax, ay)
    mn = torch.minimum(ax, ay)
    z = mn / torch.clamp_min(mx, float(np.float32(1e-30)))
    z2 = z * z
    a = z2 * _ATAN_C0 + _ATAN_C[0]
    for c in _ATAN_C[1:]:
        a = a * z2 + c
    a = a * z
    a = torch.where(ay > ax, _PI_BY_2 - a, a)
    a = torch.where(x < 0.0, _PI - a, a)
    return torch.where(y < 0.0, -a, a)


def acos_poly(x: torch.Tensor) -> torch.Tensor:
    """arccos(x) = atan2(sqrt(1 - x^2), x), x in [-1, 1] (:282-285), with
    the correctly rounded square root (torch's f32 CPU sqrt is not)."""
    s = _f32_of_f64(torch.sqrt, torch.clamp_min(1.0 - x * x, 0.0))
    return atan2_poly(s, x)


def equirect_uvn(dirs: torch.Tensor, rotation,
                 exact_uv: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """(un, vn) [N] f32 of directions [N, 3] (:2314-2321): the normalised
    equirect coordinates 2*(uv - 1) that the features scale. ``exact_uv``:
    theta and phi are the correctly rounded f32 values of arccos and atan2
    (from float64), as the JAX package's XLA env function takes them
    (``direction_to_equirect_uv``, nif/model.py:36-42), instead of the
    megakernel's polynomials."""
    dy = torch.clamp(dirs[:, 1], -1.0, 1.0)
    if exact_uv:
        theta = _f32_of_f64(torch.arccos, dy)
        phi = torch.atan2(dirs[:, 2].to(torch.float64),
                          dirs[:, 0].to(torch.float64)).to(torch.float32)
    else:
        theta = acos_poly(dy)
        phi = atan2_poly(dirs[:, 2], dirs[:, 0])
    phi = phi + rotation
    phi = torch.where(phi < 0.0, phi + _TWO_PI, phi)
    phi = torch.where(phi > _TWO_PI, phi - _TWO_PI, phi)
    un = 2.0 * (theta * _INV_PI - 1.0)
    vn = 2.0 * (phi * _HALF_INV_PI - 1.0)
    return un, vn


def fourier_features(un: torch.Tensor, vn: torch.Tensor,
                     embedding_dimension: int) -> torch.Tensor:
    """[N, 4E] f32: sin(u 2^e), sin(v 2^e), cos(u 2^e), cos(v 2^e)."""
    coeff = (2 ** torch.arange(embedding_dimension, device=un.device)
             ).to(torch.float32)
    pu = un[:, None] * coeff
    pv = vn[:, None] * coeff
    return torch.cat([_f32_of_f64(torch.sin, pu), _f32_of_f64(torch.sin, pv),
                      _f32_of_f64(torch.cos, pu), _f32_of_f64(torch.cos, pv)],
                     dim=1)


def decode_rgb(x: torch.Tensor, max_, mean: torch.Tensor,
               log_tone_map: bool) -> torch.Tensor:
    """[N, 3] BGR network output -> RGB radiance (:2353-2360)."""
    bgr = x * max_ + mean
    if log_tone_map:
        bgr = _f32_of_f64(torch.exp, bgr)
    return bgr.flip(1)


# ---- the model ----
def detect_structure(kernel_shapes: Sequence[tuple[int, int]],
                     embedding_dimension: int) -> tuple[bool, ...]:
    """Where the encoded input is concatenated back in: before layer i
    when its input width is the previous output plus the 4E features
    (``NifModel.from_weights``, nif/model.py:70-104)."""
    e4 = 4 * embedding_dimension
    concat, cur = [], e4
    for i, (k_in, k_out) in enumerate(kernel_shapes):
        if k_in != cur:
            if k_in != cur + e4:
                raise ValueError(f"Layer {i} input {k_in} matches neither "
                                 f"{cur} nor {cur + e4}")
            concat.append(True)
        else:
            concat.append(False)
        cur = int(k_out)
    return tuple(concat)


class NifEnv(nn.Module):
    """A NIF environment light on one device, packed once in the layout
    the kernel reads (``pack_env_mlp``'s, without the 128 padding).

    Buffers: ``w`` bf16, layer l's kernel [cin, cout] row-major from
    ``woff`` (the f32 weights rounded to nearest bf16, as the JAX kernel's
    ``wstack``); ``b`` f32, its bias from ``boff``; ``table`` [L, 6] int32
    rows (cin, cout, relu, concat, woff, boff), offsets multiples of 8
    elements so every layer starts 16-byte aligned; ``econst`` [5] f32:
    rotation, max, mean (BGR). ``forward(dirs [N, 3])`` returns the RGB
    radiance [N, 3] through ``ops.env.env_mlp`` (the CUDA kernel for CUDA
    tensors)."""

    def __init__(self, config: NifConfig, kernels, biases, max_, mean,
                 rotation=0.0):
        super().__init__()
        E = config.embedding_dimension
        if E > MAX_EMBEDDING:
            raise ValueError(
                f"in-kernel env MLP supports embedding_dimension <= "
                f"{MAX_EMBEDDING}; got {E}")
        if len(kernels) != len(config.activations):
            raise ValueError("one activation per layer expected")
        self.config = config
        layers, rows, ws, bs = [], [], [], []
        woff = boff = 0
        for l, (k, b) in enumerate(zip(kernels, biases)):
            k = torch.from_numpy(np.array(k, np.float32))
            cin, cout = int(k.shape[0]), int(k.shape[1])
            b = (torch.zeros(cout) if b is None
                 else torch.from_numpy(np.array(b, np.float32)))
            relu = config.activations[l] == "relu"
            concat = bool(config.concat_before[l])
            layers.append((cin, cout, relu, concat))
            rows.append([cin, cout, int(relu), int(concat), woff, boff])
            wlen, blen = -(-cin * cout // 8) * 8, -(-cout // 8) * 8
            ws.append(nn.functional.pad(k.reshape(-1), (0, wlen - cin * cout)))
            bs.append(nn.functional.pad(b, (0, blen - cout)))
            woff += wlen
            boff += blen
        if layers[0][0] != 4 * E or layers[-1][1] != 3:
            raise ValueError(f"NIF MLP must map {4 * E} features to 3 outputs, "
                             f"got {layers[0][0]} -> {layers[-1][1]}")
        self.layers = tuple(layers)  # (cin, cout, relu, concat) per layer
        self.offsets = tuple((r[4], r[5]) for r in rows)  # (woff, boff)
        self.register_buffer("w", torch.cat(ws).to(torch.bfloat16))
        self.register_buffer("b", torch.cat(bs))
        self.register_buffer("table", torch.tensor(rows, dtype=torch.int32))
        self.register_buffer("econst", torch.from_numpy(np.array(
            [np.float32(rotation), np.float32(max_),
             *np.asarray(mean, np.float32).ravel()], np.float32)))

    @property
    def num_layers(self) -> int:
        return len(self.layers)

    def layer(self, l: int) -> tuple[torch.Tensor, torch.Tensor]:
        """Layer l's bf16 kernel [cin, cout] and f32 bias [cout] (views)."""
        (cin, cout, _, _), (woff, boff) = self.layers[l], self.offsets[l]
        return (self.w[woff:woff + cin * cout].view(cin, cout),
                self.b[boff:boff + cout])

    @property
    def rotation(self) -> torch.Tensor:
        return self.econst[0]

    @property
    def max(self) -> torch.Tensor:
        return self.econst[1]

    @property
    def mean(self) -> torch.Tensor:
        return self.econst[2:5]

    @property
    def width(self) -> int:
        """Activation row width: the widest layer input or output, even."""
        m = max(max(cin, cout) for cin, cout, _, _ in self.layers)
        return m + (m & 1)

    @property
    def macs(self) -> int:
        """Multiply-adds per direction."""
        return sum(cin * cout for cin, cout, _, _ in self.layers)

    @property
    def device(self) -> torch.device:
        return self.w.device

    def forward(self, dirs: torch.Tensor) -> torch.Tensor:
        from ..ops.env import env_mlp

        return env_mlp(dirs, self)


class NifModel(nn.Module):
    """The NIF network in f32 (port of the JAX ``NifModel`` at
    ``compute_dtype="float32"``): ``kernels`` [cin, cout] and ``biases``
    [cout] are parameters; ``max`` and ``mean`` (BGR) are the decode's
    buffers. ``raw(uv)`` is the network's output before the decode, which
    training fits; ``forward(uv)`` decodes it (BGR)."""

    def __init__(self, config: NifConfig, kernels, biases, max_=1.0,
                 mean=(0.0, 0.0, 0.0), device=None):
        super().__init__()
        self.config = config
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                        device=device)
        self.kernels = nn.ParameterList([nn.Parameter(f32(k))
                                         for k in kernels])
        self.biases = nn.ParameterList([nn.Parameter(f32(b)) for b in biases])
        self.register_buffer("max", f32(np.float32(max_)))
        self.register_buffer("mean", f32(np.asarray(mean, np.float32)))

    @property
    def device(self) -> torch.device:
        return self.kernels[0].device

    def features(self, uv: torch.Tensor) -> torch.Tensor:
        """Fourier features [N, 4E] of uv [N, 2] (``encode_input``):
        uvn = 2*(uv - 1), then sin and cos of uvn * 2^e."""
        uvn = 2.0 * (uv - 1.0)
        return fourier_features(uvn[:, 0], uvn[:, 1],
                                self.config.embedding_dimension)

    def raw(self, uv: torch.Tensor) -> torch.Tensor:
        """The Dense stack's output [N, 3] before the decode."""
        feats = self.features(uv)
        x = feats
        for i, (k, b) in enumerate(zip(self.kernels, self.biases)):
            if self.config.concat_before[i]:
                x = torch.cat([x, feats], dim=1)
            x = x @ k + b
            if self.config.activations[i] == "relu":
                x = torch.clamp_min(x, 0.0)
        return x

    def forward(self, uv: torch.Tensor) -> torch.Tensor:
        """Decoded BGR radiance [N, 3] of uv [N, 2]."""
        x = self.raw(uv) * self.max + self.mean
        return torch.exp(x) if self.config.log_tone_map else x

    @torch.no_grad()
    def reconstruct_image(self, height: int | None = None,
                          width: int | None = None, meta=None,
                          batch: int = 1 << 16) -> np.ndarray:
        """The decoded image grid [H, W, 3] (BGR) at uv = (row/H, col/W):
        the standalone inference mode of ref NifModel.cpp:339-352."""
        if meta is not None:
            height = height or meta.image_shape[0]
            width = width or meta.image_shape[1]
        rr, cc = np.meshgrid(np.arange(height), np.arange(width),
                             indexing="ij")
        uv = np.stack([rr / height, cc / width], axis=-1).reshape(-1, 2)
        uv = torch.from_numpy(uv.astype(np.float32)).to(self.device)
        out = torch.cat([self(uv[s:s + batch])
                         for s in range(0, uv.shape[0], batch)])
        return out.cpu().numpy().reshape(height, width, 3)


def from_jax_params(config, env_params: dict) -> NifEnv:
    """Carry a JAX NIF across (on the CPU): ``config`` is the JAX
    ``NifConfig`` (or the port's), ``env_params`` its params dict as numpy
    (``kernels``, ``biases``, ``max``, ``mean``, optional ``rotation``)."""
    cfg = NifConfig(
        embedding_dimension=int(config.embedding_dimension),
        activations=tuple(config.activations),
        concat_before=tuple(bool(c) for c in config.concat_before),
        log_tone_map=bool(config.log_tone_map))
    return NifEnv(cfg, env_params["kernels"], env_params["biases"],
                  env_params["max"], env_params["mean"],
                  env_params.get("rotation", 0.0))


def load_nif_env(assets_dir: str, rotation_degrees: float = 0.0, *,
                 device=None) -> NifEnv:
    """Load a NIF from an assets.extra-style directory (``nif_metadata.txt``
    and one ``.h5``) onto ``device`` (None: the CUDA card, which must be
    present; pass ``"cpu"`` for the plain versions)."""
    if device is None:
        device = cuda_device()
    meta = NifMetadata.load(os.path.join(assets_dir, "nif_metadata.txt"))
    h5 = [c for c in sorted(os.listdir(assets_dir)) if c.endswith(".h5")]
    if not h5:
        raise FileNotFoundError(f"No .h5 weights found in '{assets_dir}'")
    weights = load_keras_h5(os.path.join(assets_dir, h5[-1]))
    kernels = [np.asarray(l.kernel, np.float32) for l in weights.layers]
    config = NifConfig(
        embedding_dimension=meta.embedding_dimension,
        activations=tuple(l.activation for l in weights.layers),
        concat_before=detect_structure([k.shape for k in kernels],
                                       meta.embedding_dimension),
        log_tone_map=meta.log_tone_map)
    env = NifEnv(config, kernels, [l.bias for l in weights.layers], meta.max,
                 meta.mean, np.float32(np.deg2rad(rotation_degrees)))
    return env.to(device)
