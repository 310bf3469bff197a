#!/usr/bin/env python
"""Train the reference-class NIF (6 x 320, embedding 12, fp16, log-tone
-mapped) on a 4k equirectangular HDRI with the PyTorch port, and write it
as an asset.

The port's counterpart of examples/train_reference_nif.py (same flags
and flow, plus ``--device``): the HDRI is the procedural
``nif/synth.py`` sky (sun disc ~1e3 radiance, HDR gradient, fBm clouds,
textured ground) at 2048 x 4096, the architecture, encoding and asset
format are the reference's. The assets are written to ``--out`` (a
directory under the temporary directory by default; the in-repo asset
``assets/nif/synthetic_urban_4k`` is the JAX package's and stays as it
is).

Usage:
  python examples/train_reference_nif_torch.py [--steps 12000] [--out DIR]
      [--device cuda|cpu]
Writes DIR/nif_metadata.txt + DIR/model.h5 (fp16), prints the train loss
and the reconstruction PSNR.
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=12000)
    ap.add_argument("--height", type=int, default=2048)
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--out", default=os.path.join(
        tempfile.gettempdir(), "synthetic_urban_4k_torch"))
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="train on the CUDA card (raises without one) or "
                         "on the CPU")
    args = ap.parse_args(argv)

    import torch

    from ipu_ray_lib_tpu_torch.nif.synth import synth_hdri
    from ipu_ray_lib_tpu_torch.nif.train import save_nif_assets, train_nif
    from ipu_ray_lib_tpu_torch.runtime.device import cuda_device

    device = cuda_device() if args.device == "cuda" else torch.device("cpu")
    img = synth_hdri(args.height, args.height * 2)
    print(f"HDRI {img.shape}, range [{img.min():.2g}, {img.max():.1f}]")

    t0 = time.time()
    losses = []
    model, meta = train_nif(
        img, embedding_dimension=12, layer_count=6, layer_size=320,
        steps=args.steps, batch_size=args.batch, learning_rate=1e-3,
        seed=4, device=device, losses=losses)
    print(f"trained {args.steps} steps in {time.time() - t0:.0f}s on "
          f"{device}, loss {losses[0]:.4g} -> {losses[-1]:.4g}")

    # Reconstruction PSNR in the log-encoded domain (the quantity the
    # net fits; linear-HDR PSNR is dominated by the sun disc):
    rh = min(256, args.height)
    rec = model.reconstruct_image(height=rh, width=2 * rh)
    ref = img[::args.height // rh, ::args.height * 2 // (2 * rh)]
    le_rec = np.log(np.clip(rec[..., ::-1], 1e-5, None))
    le_ref = np.log(np.clip(ref, 1e-5, None))
    mse = float(np.mean((le_rec - le_ref) ** 2))
    rng_ = float(le_ref.max() - le_ref.min())
    psnr = 10 * np.log10(rng_ * rng_ / mse)
    print(f"log-domain reconstruction PSNR: {psnr:.2f} dB (mse {mse:.4g})")

    meta.name = "synthetic_urban_4k"
    save_nif_assets(model, meta, args.out, fp16=True)
    print(f"assets written to {args.out}")
    return dict(losses=losses, psnr=psnr, out=args.out)


if __name__ == "__main__":
    main()
