"""The NIF environment MLP: escape directions -> RGB radiance.

Port of the env branch of the TPU megakernel (``_env``,
ipu_ray_lib_tpu/ops/pallas/megakernel.py:2304-2361). Its weights come
packed by :class:`~ipu_ray_lib_tpu_torch.nif.model.NifEnv` (the port's
``pack_env_mlp``, :2507-2558). Two implementations of one network:

* the CUDA kernel (``ops/cuda/env_mlp.cu``) for CUDA tensors, its dense
  layers on the tensor cores, with the weights packed by
  :func:`pack_mma`;
* :func:`env_mlp_ref`, plain torch, for CPU tensors and for checking the
  kernel on the card.

Both round the features and every layer's input to bf16, sum bf16
products in f32, then add the f32 bias. The plain version sums each
output in one f32 accumulator over the inputs in ascending index (it
loops over the input index; it is slow and meant for small batches and
checks); the tensor cores sum each 16-deep slice in their own order. So
the kernel holds the plain version to a measured tolerance, not to the
bit: :func:`deviation` gives the measures, :func:`within_yardstick` the
gate that ``chip_smoke.py`` applies (the kernel no further from the plain
version than a ``torch.matmul`` chain on the same tensor cores, plus a
stated slack, and within the port's tolerance against the JAX package).
"""

from __future__ import annotations

import numpy as np
import torch

from ..nif.model import decode_rgb, equirect_uvn, fourier_features

# CUDA kernel launches made by env_mlp since the last reset:
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def _check(dirs: torch.Tensor, env) -> None:
    if dirs.dim() != 2 or dirs.shape[1] != 3 or dirs.dtype != torch.float32:
        raise ValueError(f"dirs must be [N, 3] float32, got "
                         f"{tuple(dirs.shape)} {dirs.dtype}")
    if dirs.device != env.device:
        raise ValueError(f"dirs on {dirs.device}, env on {env.device}")


def env_mlp_ref(dirs: torch.Tensor, env,
                exact_uv: bool = False) -> torch.Tensor:
    """Plain-torch env radiance: dirs [N, 3] f32 -> RGB [N, 3] f32, in the
    kernel's order, on any device (``exact_uv``: see
    :func:`~ipu_ray_lib_tpu_torch.nif.model.equirect_uvn`)."""
    _check(dirs, env)
    cfg = env.config
    un, vn = (equirect_uvn(dirs, env.rotation, exact_uv=True) if exact_uv
              else equirect_uvn(dirs, env.rotation))
    feats = fourier_features(un, vn, cfg.embedding_dimension)
    x = feats
    for l, (_, _, relu, concat) in enumerate(env.layers):
        w, b = env.layer(l)
        if concat:
            x = torch.cat([x, feats], dim=1)
        # [cin, N]: input i's column for every direction, contiguous
        xt = x.to(torch.bfloat16).to(torch.float32).t().contiguous()
        wf = w.to(torch.float32)
        acc = torch.zeros((x.shape[0], wf.shape[1]), dtype=torch.float32,
                          device=x.device)
        for i in range(wf.shape[0]):  # ascending input index
            acc.addcmul_(xt[i, :, None], wf[i])  # exact product, one rounding
        x = acc + b
        if relu:
            x = torch.clamp_min(x, 0.0)
    return decode_rgb(x, env.max, env.mean, cfg.log_tone_map)


# The kernel's tiling (ops/cuda/env_mlp.cu NCH, KG): n-tiles of 8 outputs
# per pass, k-tiles of 16 inputs per weight stage. The kernel's launcher
# refuses a stage table that does not fit them.
MMA_NCH = 20
MMA_KG = 4


def pack_mma(env) -> dict:
    """The NIF's weights in the order and fragment layout the tensor-core
    kernel reads them, on ``env``'s device: ``wq`` int32 (each layer's
    bf16 kernel, its outputs padded with zeros to a multiple of 16, cut
    into passes of ``MMA_NCH`` n-tiles and stages of ``MMA_KG`` k-tiles;
    within a stage [k-tile][n-tile][lane][2] words, lane g*4 + t holding
    the pairs of rows (2t, 2t+1) and (2t+8, 2t+9) of column g, low half
    first: the B fragment of ``mma.m16n8k16``), ``stages`` [S, 8] int32
    (offset and length in 16-byte units, layer, first n-tile, first
    k-tile, k-tiles, n-tiles, flags: 1 the pass ends, 2 the layer ends)
    and its host copy ``stages_host`` (numpy, which the launcher checks
    against the kernel's ring), ``layers`` [L, 8] int32 (cin, cout, relu, at: inputs below ``at`` are
    the previous output and the rest the features, bias offset, last) and
    ``ldx`` (the activation row stride, in bf16). Raises where the kernel
    cannot take the network: an input width that is not a multiple of 16.
    """
    F = 4 * env.config.embedding_dimension
    L = env.num_layers
    words, stages, layers = [], [], []
    off16 = 0
    for l, (cin, cout, relu, concat) in enumerate(env.layers):
        if cin % 16:
            raise ValueError(f"env MLP layer {l} has {cin} inputs; the "
                             "tensor-core kernel takes multiples of 16")
        coutp = -(-cout // 16) * 16
        w, _ = env.layer(l)
        bits = np.zeros((cin, coutp), np.uint32)
        bits[:, :cout] = (w.detach().cpu().view(torch.int16).numpy()
                          .astype(np.uint16))
        kt, nt = cin // 16, coutp // 8
        wr = bits.reshape(kt, 2, 4, 2, nt, 8)  # kt, half, t, pair, nt, g
        pairs = wr[:, :, :, 0] | (wr[:, :, :, 1] << 16)  # kt, half, t, nt, g
        frag = pairs.transpose(0, 3, 4, 2, 1)  # kt, nt, g, t, half
        frag = np.ascontiguousarray(frag).reshape(kt, nt, 32, 2)
        at = 0 if l == 0 else (cin - F if concat else cin)
        for n0 in range(0, nt, MMA_NCH):
            nch = min(MMA_NCH, nt - n0)
            for k0 in range(0, kt, MMA_KG):
                nk = min(MMA_KG, kt - k0)
                chunk = frag[k0:k0 + nk, n0:n0 + nch].reshape(-1)
                words.append(chunk)
                pass_end = k0 + nk == kt
                flags = int(pass_end) | (int(pass_end and n0 + nch == nt) << 1)
                stages.append([off16, chunk.size // 4, l, n0, k0, nk, nch,
                               flags])
                off16 += chunk.size // 4
        layers.append([cin, cout, int(relu), at, env.offsets[l][1],
                       int(l == L - 1), 0, 0])
    hidden = max([cout for _, cout, _, _ in env.layers[:-1]], default=16)
    dev = env.device
    as_i32 = lambda a: torch.from_numpy(np.asarray(a).astype(np.uint32)
                                        .view(np.int32)).to(dev)
    stages = np.asarray(stages, np.int32)
    return dict(wq=as_i32(np.concatenate(words)), stages=as_i32(stages),
                stages_host=stages,
                layers=as_i32(layers), ldx=-(-hidden // 16) * 16 + 8)


def _packed(env) -> dict:
    """:func:`pack_mma` of ``env``, once per NIF and device."""
    cache = env.__dict__.setdefault("_mma_pack", {})
    key = (str(env.device), env.w.data_ptr())
    if key not in cache:
        cache.clear()
        cache[key] = pack_mma(env)
    return cache[key]


def deviation(got, want) -> dict:
    """How far ``got`` lies from ``want`` (the plain version's output): the
    share of elements within rtol = atol = 1e-5 and within rtol 1e-2, the
    largest relative difference and the relative difference of the means
    (the measures of tests/test_torch_env.py ``split``)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    return dict(within_1e5=float(np.isclose(got, want, rtol=1e-5,
                                            atol=1e-5).mean()),
                within_1e2=float((rel <= 1e-2).mean()),
                max_rel=float(rel.max()),
                mean_rel=abs(float(got.mean()) / float(want.mean()) - 1.0))


# What the port holds against the JAX package with the urban_4k NIF
# (tests/test_torch_env.py ``hold_high_frequency``):
HIGH_FREQUENCY = dict(within_1e2=0.98, max_rel=5e-2, mean_rel=5e-4)
# The slack over the yardstick's deviation. The yardstick (a chain of bf16
# torch.matmul calls) sums on the same tensor cores, but in cuBLAS's tiles
# and with its outputs rounded to bf16 before the bias, so the kernel
# should lie nearer the plain version on every measure. The slack covers
# what two sum orders may still exchange: a share of 1e-3 of the elements
# either side of a threshold, and a quarter more in the largest relative
# difference, a statistic of one element.
YARDSTICK_SHARE_SLACK = 1e-3
YARDSTICK_MAX_REL_SLACK = 1.25
YARDSTICK_MEAN_REL_SLACK = 1e-6


def within_yardstick(kernel: dict, library: dict) -> list[str]:
    """The gate of the kernel's :func:`deviation` against the library
    chain's on the same directions: each measure no worse than the
    chain's plus the stated slack, and within ``HIGH_FREQUENCY``. Returns
    the measures that fail (empty: the kernel passes)."""
    bad = []
    for k in ("within_1e5", "within_1e2"):
        if kernel[k] < library[k] - YARDSTICK_SHARE_SLACK:
            bad.append(f"{k} {kernel[k]:.6f} < chain {library[k]:.6f} - "
                       f"{YARDSTICK_SHARE_SLACK:g}")
    if kernel["max_rel"] > library["max_rel"] * YARDSTICK_MAX_REL_SLACK:
        bad.append(f"max_rel {kernel['max_rel']:.4g} > chain "
                   f"{library['max_rel']:.4g} x {YARDSTICK_MAX_REL_SLACK:g}")
    if kernel["mean_rel"] > library["mean_rel"] + YARDSTICK_MEAN_REL_SLACK:
        bad.append(f"mean_rel {kernel['mean_rel']:.3g} > chain "
                   f"{library['mean_rel']:.3g} + {YARDSTICK_MEAN_REL_SLACK:g}")
    return bad + within_high_frequency(kernel)


def within_high_frequency(dev: dict) -> list[str]:
    """The measures of a :func:`deviation` outside ``HIGH_FREQUENCY``."""
    bad = []
    if dev["within_1e2"] < HIGH_FREQUENCY["within_1e2"]:
        bad.append(f"within_1e2 {dev['within_1e2']:.6f} < "
                   f"{HIGH_FREQUENCY['within_1e2']}")
    for k in ("max_rel", "mean_rel"):
        if dev[k] > HIGH_FREQUENCY[k]:
            bad.append(f"{k} {dev[k]:.4g} > {HIGH_FREQUENCY[k]:g}")
    return bad


def env_mlp(dirs: torch.Tensor, env, exact_uv: bool = False) -> torch.Tensor:
    """Env radiance of escape directions: dirs [N, 3] f32 -> RGB [N, 3].

    CUDA tensors launch the kernel (built at first use; a failed build or
    launch raises); CPU tensors run :func:`env_mlp_ref`. ``exact_uv``: the
    equirect angles of the JAX package's XLA env function (the per-sample
    path tracer's env term) instead of the megakernel's polynomials."""
    global launches
    _check(dirs, env)
    if dirs.device.type == "cpu":
        return env_mlp_ref(dirs, env, exact_uv)
    if dirs.device.type != "cuda":
        raise ValueError(f"unsupported device {dirs.device}")
    from .cuda.build import launch_env_mlp

    out = torch.empty_like(dirs)
    if dirs.shape[0]:
        launch_env_mlp(dirs.contiguous(), out, env, _packed(env), exact_uv)
        launches += 1
    return out
