"""How far a change of summation order moves the port's env MLP, on the CPU.

The port's plain env MLP (``ipu_ray_lib_tpu_torch.ops.env.env_mlp_ref``)
sums each output in one f32 accumulator over the inputs in ascending
order; the tensor-core kernel sums 16-deep slices in its own order. This
script stands a 16-deep chunked order (each chunk of exact bf16 products
summed in f64, rounded once to f32, added to the f32 accumulator) beside
the ascending one, on seeded directions, twice: with each layer's input
rounded to bf16 as the network does, and with f32 inputs. It prints,
as JSON, the measures of ``ops.env.deviation`` between the two orders,
the share of each layer's bf16 inputs the order flips, the largest
difference of the last layer's output, and the directions of the largest
relative differences.

    python experiments/torch_env_sum_order.py [--dirs 65536] [--seed 7]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from ipu_ray_lib_tpu_torch.nif.model import (decode_rgb, equirect_uvn,  # noqa: E402
                                             fourier_features, load_nif_env)
from ipu_ray_lib_tpu_torch.ops import env as envk  # noqa: E402

NIF = os.path.join(os.path.dirname(__file__), "..", "assets", "nif",
                   "synthetic_urban_4k")


def mlp(env, dirs, chunk: int, bf16_inputs: bool):
    """The env MLP with sums of ``chunk``-deep slices (1: ascending, one
    f32 rounding per product). Returns (RGB, last layer's output, each
    layer's input)."""
    un, vn = equirect_uvn(dirs, env.rotation)
    feats = fourier_features(un, vn, env.config.embedding_dimension)
    x, inputs = feats, []
    for l, (_, _, relu, concat) in enumerate(env.layers):
        w, b = env.layer(l)
        if concat:
            x = torch.cat([x, feats], dim=1)
        xi = (x.to(torch.bfloat16) if bf16_inputs else x).double()
        inputs.append(xi)
        wf = w.double()
        acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32)
        for k in range(0, xi.shape[1], chunk):
            acc = acc + (xi[:, k:k + chunk] @ wf[k:k + chunk]).float()
        x = acc + b
        if relu:
            x = torch.clamp_min(x, 0.0)
    return decode_rgb(x, env.max, env.mean, env.config.log_tone_map), x, inputs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dirs", type=int, default=65536)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args()
    env = load_nif_env(NIF, device="cpu")
    rng = np.random.default_rng(args.seed)
    d = rng.normal(size=(args.dirs, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dirs = torch.from_numpy(d)
    out = {"dirs": args.dirs, "decode_scale": float(env.max)}
    for bf16 in (True, False):
        a, la, ia = mlp(env, dirs, 1, bf16)
        c, lc, ic = mlp(env, dirs, 16, bf16)
        rel = ((c.double() - a.double()).abs()
               / a.double().abs().clamp_min(1e-30))
        res = dict(deviation=envk.deviation(c.numpy(), a.numpy()),
                   last_layer_max_abs=float((la - lc).abs().max()))
        if bf16:
            res["flipped_share_per_layer"] = [
                float((x != y).double().mean()) for x, y in zip(ia, ic)]
            over = (rel > 1e-2).any(dim=1)
            res["elevation_of_rows_over_1e-2"] = (
                [float(v) for v in torch.quantile(
                    dirs[over][:, 1].double(),
                    torch.tensor([0.0, 0.5, 1.0], dtype=torch.float64))]
                if bool(over.any()) else None)
            top = torch.topk(rel.flatten(), 5).indices
            res["worst"] = [dict(dir=[round(float(v), 4) for v in dirs[i // 3]],
                                 ch="RGB"[i % 3], ascending=float(a[i // 3, i % 3]),
                                 chunked=float(c[i // 3, i % 3]),
                                 rel=float(rel[i // 3, i % 3]))
                            for i in top.tolist()]
        out["bf16_inputs" if bf16 else "f32_inputs"] = res
    print(json.dumps(out))


if __name__ == "__main__":
    main()
