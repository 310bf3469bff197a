"""The NIF environment MLP: escape directions -> RGB radiance.

Port of the env branch of the TPU megakernel (``_env``,
ipu_ray_lib_tpu/ops/pallas/megakernel.py:2304-2361). Its weights come
packed by :class:`~ipu_ray_lib_tpu_torch.nif.model.NifEnv` (the port's
``pack_env_mlp``, :2507-2558). Two implementations with one contract:

* the CUDA kernel (``ops/cuda/env_mlp.cu``) for CUDA tensors;
* :func:`env_mlp_ref`, plain torch, for CPU tensors and for checking the
  kernel on the card.

Both evaluate the network in the port's own order (nif/model.py): the
features and every layer's input rounded to bf16, each output one f32
accumulator over the inputs in ascending index, then the f32 bias. The
plain version loops over the input index so that its sums are the
kernel's; it is slow and meant for small batches and checks.
"""

from __future__ import annotations

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


def env_mlp_ref(dirs: torch.Tensor, env) -> torch.Tensor:
    """Plain-torch env radiance: dirs [N, 3] f32 -> RGB [N, 3] f32, in the
    kernel's order, on any device."""
    _check(dirs, env)
    cfg = env.config
    un, vn = equirect_uvn(dirs, env.rotation)
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


def env_mlp(dirs: torch.Tensor, env) -> torch.Tensor:
    """Env radiance of escape directions: dirs [N, 3] f32 -> RGB [N, 3].

    CUDA tensors launch the kernel (built at first use; a failed build or
    launch raises); CPU tensors run :func:`env_mlp_ref`."""
    global launches
    _check(dirs, env)
    if dirs.device.type == "cpu":
        return env_mlp_ref(dirs, env)
    if dirs.device.type != "cuda":
        raise ValueError(f"unsupported device {dirs.device}")
    from .cuda.build import launch_env_mlp

    out = torch.empty_like(dirs)
    if dirs.shape[0]:
        launch_env_mlp(dirs.contiguous(), out, env)
        launches += 1
    return out
