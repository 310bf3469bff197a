#!/usr/bin/env python
"""Literate verification walk-through of the PyTorch + CUDA port (the
counterpart of ``examples/verify_all.py``; LITERATE_TEST.ipynb analogue).

Runs the reference's integration-test methodology end to end through
``ipu_ray_lib_tpu_torch`` and prints the statistics the notebook plots
(ref LITERATE_TEST.ipynb: AOV parity against the independent reference
renderer with abs-error stats, then path-traced colour-histogram
comparison between renderers whose RNG streams differ):

  1. build the Cornell scene (with the monkey plinth if available),
  2. shadow-trace AOV parity (normals / hitpoints / ids) vs the f64 oracle,
  3. path-trace two independent seeds and compare colour histograms,
  4. the same render through independent intersectors must agree per
     pixel: the VMEM-mode walk against the HBM-mode walk, and the
     megakernel (pallas) against the XLA-loop integrator over the dense
     intersector (K8),
  5. Collada scene load + render smoke.

Usage: python examples/verify_all_torch.py [--size 96] [--spp 16]
       [--device cuda|cpu]   (cuda, the default, raises without a card)
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=96)
    ap.add_argument("--spp", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)

    from ipu_ray_lib_tpu_torch.cpu.reference import (camera_rays,
                                                     oracle_shadow_trace)
    from ipu_ray_lib_tpu_torch.render.renderer import render
    from ipu_ray_lib_tpu_torch.render.streaming import render_streaming
    from ipu_ray_lib_tpu_torch.runtime.device import cuda_device
    from ipu_ray_lib_tpu_torch.scene.build import build_scene
    from ipu_ray_lib_tpu_torch.scene.builtin import make_cornell_box_scene
    from ipu_ray_lib_tpu_torch.utils.image import mse

    dev = cuda_device() if args.device == "cuda" else "cpu"
    size, spp = args.size, args.spp
    chunk = min(size * size, 1 << 16)
    mesh = "assets/monkey_bust.glb" if os.path.exists("assets/monkey_bust.glb") else None
    scene = make_cornell_box_scene(mesh, box_only=False)
    tscene, params = build_scene(scene, device=dev, image_width=size,
                                 image_height=size, samples_per_pixel=spp)
    print(f"# Scene: {params.num_geoms} geoms, {params.num_bvh_nodes} BVH nodes, "
          f"intersector={params.intersector}, device={tscene.device}")

    # ---- 1. Shadow-trace AOV parity vs oracle ---------------------------
    t0 = time.time()
    out = render(tscene, params, mode="shadow-trace", chunk_size=chunk)
    print(f"# Shadow trace: {size*size/(time.time()-t0):.3g} rays/s, hits {out.hit_count}")

    o, d = camera_rays(size, size, 0, 0, size, size, params.fov_radians)
    res = oracle_shadow_trace(scene, o, d)
    oracle_geom = res["geom"].reshape(size, size)
    oracle_norm = res["normal"].reshape(size, size, 3)
    oracle_hp = res["hit_p"].reshape(size, size, 3)
    oracle_rgb = res["rgb"].reshape(size, size, 3)

    both = (out.geom_id >= 0) & (oracle_geom >= 0)
    print(f"## Check Hit Masks: agreement {(100*((out.geom_id>=0)==(oracle_geom>=0)).mean()):.2f}%")

    ndots = np.abs(np.sum(out.normal * oracle_norm, axis=-1))[both]
    print(f"## Check Normals: |cos| median {np.median(ndots):.6f}, "
          f"p01 {np.quantile(ndots, 0.01):.6f}")

    hp_err = np.linalg.norm(out.hit_p - oracle_hp, axis=-1)[both]
    print(f"## Check Hit Points: abs err median {np.median(hp_err):.4g}, "
          f"p99 {np.quantile(hp_err, 0.99):.4g} (scene units)")

    print(f"## Check Shadow RGB: MSE {mse(out.rgb, oracle_rgb):.3g}")

    # ---- 2. Path trace: histogram parity across RNG seeds ----------------
    t0 = time.time()
    a = render(tscene, params, mode="path-trace", chunk_size=chunk)
    dt = time.time() - t0
    print(f"# Path trace: {size*size*spp/dt:.4g} path-samples/s")
    b = render(tscene, dataclasses.replace(params, rng_seed=7),
               mode="path-trace", chunk_size=chunk)

    for c, name in enumerate("rgb"):
        ha, _ = np.histogram(a.rgb[..., c], bins=32, range=(0, 2))
        hb, _ = np.histogram(b.rgb[..., c], bins=32, range=(0, 2))
        denom = np.maximum(ha + hb, 1)
        dist = np.abs(ha - hb).sum() / denom.sum()
        print(f"## Path histogram ({name}): L1 distance {dist:.4f} "
              f"(different seeds; small = distributions match)")

    # ---- 3. Cross-intersector radiometry --------------------------------
    # Same RNG streams + same estimator through two independent walks
    # (the VMEM-mode walk over the whole table and the HBM-mode walk over
    # super-groups, supers and blocks): images must agree per pixel, not
    # just in distribution (the check that caught the payload-leakage
    # radiometry bug, PROGRESS.md finding 30).
    # The megakernel against the XLA-loop integrator over the dense
    # intersector: the same RNG streams and estimator through another
    # integrator and another closest hit (the JAX example's step).
    imgs = {}
    for its in ("pallas", "pallas-hbm", "dense"):
        ti, pi = build_scene(scene, device=dev, image_width=size,
                             image_height=size, samples_per_pixel=spp,
                             intersector=its)
        imgs[its], _done = render_streaming(ti, pi, spp=spp)
    for other in ("pallas-hbm", "dense"):
        dmax = np.abs(imgs["pallas"] - imgs[other]).max(axis=-1)
        print(f"## Cross-intersector (pallas vs {other}): mean "
              f"{imgs['pallas'].mean():.5f} vs {imgs[other].mean():.5f}, "
              f"q99 pixel diff {np.quantile(dmax, 0.99):.2e}")

    # ---- 4. Collada import + render smoke --------------------------------
    if os.path.exists("assets/hdri_test.dae"):
        from ipu_ray_lib_tpu_torch.scene.collada import import_collada_scene

        dae = import_collada_scene("assets/hdri_test.dae")
        ts2, params2 = build_scene(dae, device=dev, image_width=48,
                                   image_height=48, samples_per_pixel=4)
        out2 = render(ts2, params2, mode="shadow-trace", chunk_size=48 * 48)
        print(f"# Collada scene: {sum(len(m.triangles) for m in dae.meshes)} tris, "
              f"hits {out2.hit_count}/{48*48}")

    print("# Done.")


if __name__ == "__main__":
    main()
