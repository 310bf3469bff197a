#!/usr/bin/env python3
"""GPU smoke test of the PyTorch + CUDA port (ipu_ray_lib_tpu_torch).

Drives the port's main path on one CUDA card — the Cornell box with the
monkey plinth, 1440x1440 at 64 spp, through ``build_scene`` ->
``render_streaming`` — after checking its kernel against the plain torch
version and the golden image. Run from the repository root:

    python3 chip_smoke.py            # the full check (one card)
    python3 chip_smoke.py --quick    # build + small-scene checks only

Phases (any failed check raises, so the exit code is non-zero):
  1. card identity (nvidia-smi name, power limit); nvcc build of the kernel;
  2. kernel vs plain version on the card, rtol = atol = 1e-5:
     golden scene 48x32 spp 2 (also vs tests/golden/box48x32_spp2.npy,
     done == 3072); Cornell + monkey 64x64 spp 4;
     Cornell + monkey at the main path's slot pool (1440^2 stream,
     R = 131072, J = 16) with spp 1 per slot — spp is the one cut there;
     the main path's own 64-spp pixels are checked in phase 3;
  3. main path at full size: one warm-up and three timed renders
     (torch.cuda.synchronize), done == 1440^2 * 64, finite image, image
     mean within 15% of the plain version's 64x64 mean; then the kernel
     alone at the same shapes, three times, with CUDA events; then the
     main path's image on the pixels of its first 256 slots (4,096
     pixels, all 64 samples each) against the kernel and the plain
     version replaying those slots, rtol = atol = 1e-5;
  4. plain vs kernel time at 256^2 spp 4, in turns (plain, kernel,
     kernel, plain).
Before the last two lines: a JSON object with the kernel's launches on
the main path, its largest deviation from the plain version, both times
at the main path's slot pool with spp 1 (``ms``, ``plain_ms``) and the
main path's own launch time (``main_ms``); then the card's nvidia-smi
line. The last line is the JSON status object.
Exits non-zero, printing no result, when no CUDA device is available.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.modules["jax"] = None  # the port must never import jax

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-5
FULL, SPP = 1440, 64


def log(*a):
    print(*a, flush=True)


def close_count(a: np.ndarray, b: np.ndarray) -> tuple[int, float]:
    """(elements outside rtol = atol = TOL, max abs difference)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    bad = ~np.isclose(a, b, rtol=TOL, atol=TOL)
    return int(bad.sum()), float(np.max(np.abs(a - b))) if a.size else 0.0


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    quick = "--quick" in sys.argv[1:]

    from ipu_ray_lib_tpu_torch.ops import megakernel as mk
    from ipu_ray_lib_tpu_torch.ops.cuda import build as cuda_build
    from ipu_ray_lib_tpu_torch.render.streaming import (
        MAX_K_PER_DISPATCH, SPP_BATCH, _pixel_stream,
        render_streaming, slot_pool)
    from ipu_ray_lib_tpu_torch.runtime.device import cuda_device, gpu_identity
    from ipu_ray_lib_tpu_torch.scene.build import build_scene
    from ipu_ray_lib_tpu_torch.scene.builtin import make_cornell_box_scene

    dev = cuda_device(0)
    identity = gpu_identity()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"gpu: {identity}")

    t0 = time.perf_counter()
    cuda_build.load()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {cuda_build.build_info.get('seconds', 0.0):.2f} s)")
    log(cuda_build.build_info.get("log", ""))

    mesh = os.path.join(ROOT, "assets", "monkey_bust.glb")
    max_err = 0.0

    def stream(params, chunk=1 << 17):
        rows_np, cols_np, _ = _pixel_stream(params)
        n_pix = params.window_w * params.window_h
        R, J = slot_pool(n_pix, chunk)
        pad = R * J - n_pix
        rows = torch.from_numpy(np.pad(rows_np, (0, pad))).to(dev)
        cols = torch.from_numpy(np.pad(cols_np, (0, pad))).to(dev)
        return rows, cols, R, J, n_pix

    def bad_pixels(a, b):
        return int((~np.isclose(a, b, rtol=TOL, atol=TOL)).any(axis=1).sum())

    def compare(name, scene, params, rows, cols, R, J, n_valid, spp,
                seed=1442):
        """Kernel and plain version on the same stream and seed (one
        dispatch of K = J*spp paths per slot)."""
        nonlocal max_err
        kw = dict(params=params, slots=R, j_per_slot=J, spp=spp,
                  max_iters=J * spp * params.max_path_length + 16)
        (fk, dk), t_k = timed(lambda: mk.megakernel_path_trace(
            scene, rows, cols, seed, n_valid, **kw))
        (fp, dp), t_p = timed(lambda: mk.megakernel_path_trace_ref(
            scene, rows, cols, seed, n_valid, **kw))
        fk, fp = fk.cpu().numpy(), fp.cpu().numpy()
        bad, err = close_count(fk, fp)
        max_err = max(max_err, err)
        log(f"[{name}] R={R} J={J} spp={spp}: kernel {t_k:.3f} s, plain "
            f"{t_p:.3f} s, done {int(dk)}/{int(dp)}, mismatched pixels "
            f"{bad_pixels(fk, fp)} of {R * J}, max |diff| {err:.3g}")
        if bad or int(dk) != int(dp):
            raise AssertionError(f"{name}: kernel disagrees with plain "
                                 f"({bad} elements, done {int(dk)} vs {int(dp)})")
        return fk, fp, t_k, t_p

    def kernel_vs_plain(name, scene, params, spp):
        rows, cols, R, J, n_pix = stream(params)
        return compare(name, scene, params, rows, cols, R, J, n_pix, spp)

    # ---- 2. kernel vs plain, and vs the golden ----
    gs, gp = build_scene(make_cornell_box_scene(None, box_only=False),
                         device=dev, image_width=48, image_height=32,
                         samples_per_pixel=2)
    kernel_vs_plain("golden 48x32", gs, gp, 2)
    golden = np.load(os.path.join(ROOT, "tests", "golden", "box48x32_spp2.npy"))
    rgb, done = render_streaming(gs, gp)
    bad, err = close_count(rgb, golden)
    log(f"[golden 48x32] render_streaming vs golden: {bad} elements "
        f"outside 1e-5, max |diff| {err:.3g}, done {done}")
    if bad or done != 48 * 32 * 2:
        raise AssertionError("golden image mismatch")

    ms, mp = build_scene(make_cornell_box_scene(mesh, box_only=False),
                         device=dev, image_width=64, image_height=64,
                         samples_per_pixel=4)
    _, f64, _, _ = kernel_vs_plain("monkey 64x64", ms, mp, 4)
    small_mean = float(f64[:64 * 64].mean())

    scene, params = build_scene(make_cornell_box_scene(mesh, box_only=False),
                                device=dev, image_width=FULL,
                                image_height=FULL, samples_per_pixel=SPP)
    log(f"bench scene: {scene.p.shape[0]} triangle rows in "
        f"{scene.num_blocks} blocks, {scene.n_ap} sphere/disc rows")
    if quick:
        log("quick mode: stopping before the full-size phases")
        return 0

    _, _, k_main, p_main = kernel_vs_plain("monkey 1440^2 pool", scene,
                                           params, 1)

    # ---- 3. main path at full size ----
    mk.reset_launches()
    (rgb, done), t_warm = timed(lambda: render_streaming(scene, params))
    times = []
    for _ in range(3):
        (rgb, done), t = timed(lambda: render_streaming(scene, params))
        times.append(t)
    launches = mk.launches
    paths = FULL * FULL * SPP
    best = min(times)
    finite = bool(np.isfinite(rgb).all())
    mean = float(rgb.mean())
    log(f"[main] {FULL}^2 spp {SPP}: warm-up {t_warm:.3f} s, runs "
        f"{', '.join(f'{t:.3f}' for t in times)} s; best {best:.3f} s = "
        f"{paths / best / 1e6:.2f} M paths/s; mean {mean:.6f} (64x64 plain "
        f"{small_mean:.6f}); done {done}; finite {finite}; launches {launches}")
    if done != paths:
        raise AssertionError(f"done {done} != {paths}")
    if rgb.shape != (FULL, FULL, 3) or not finite:
        raise AssertionError("full-size image has the wrong shape or non-finite values")
    if abs(mean - small_mean) > 0.15 * small_mean:
        raise AssertionError("full-size image mean far from the small render's")
    if launches < 1:
        raise AssertionError("main path launched no kernel")

    # Kernel alone at the main path's shapes (CUDA events; the one launch
    # render_streaming makes per frame), for the host/kernel split:
    rows, cols, R, J, n_pix = stream(params)
    kw = dict(params=params, slots=R, j_per_slot=J, spp=SPP,
              max_iters=J * SPP * params.max_path_length + 16, k_total=J * SPP)
    k_ms = []
    for _ in range(3):
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        mk.megakernel_path_trace(scene, rows, cols, params.rng_seed, n_pix, **kw)
        ev1.record()
        torch.cuda.synchronize()
        k_ms.append(ev0.elapsed_time(ev1))
    main_ms = sorted(k_ms)[1]
    pool_shape = f"main path's slot pool (R={R}, J={J}) at spp 1"
    log(f"[main] kernel alone (CUDA events): "
        f"{', '.join(f'{t:.2f}' for t in k_ms)} ms; median end to end "
        f"{sorted(times)[1] * 1e3:.2f} ms")

    # The main path's own pixels at spp 64, held against both versions.
    # A path's pid (slot*K_tot + k) and its pixels do not depend on the
    # pool size, so a pool of the main pool's first SUB slots, with the
    # same J, spp, k_total and seed (render_streaming runs one batch
    # here, seeded params.rng_seed, weight 1), replays those slots' paths.
    if J * SPP > MAX_K_PER_DISPATCH or SPP > SPP_BATCH:
        raise AssertionError("the main path no longer runs one spp batch")
    SUB = 256
    idx = (np.arange(J)[:, None] * R + np.arange(SUB)[None]).ravel()
    want = rgb.reshape(-1, 3)[_pixel_stream(params)[2][idx]]
    sub_k, sub_p, _, _ = compare(
        "monkey 1440^2 main path, first 256 slots", scene, params,
        rows[torch.from_numpy(idx).to(dev)],
        cols[torch.from_numpy(idx).to(dev)], SUB, J, SUB * J, SPP,
        seed=params.rng_seed)
    for what, got in (("kernel", sub_k), ("plain", sub_p)):
        bad, err = close_count(got, want)
        max_err = max(max_err, err)
        log(f"[main path pixels] {what} on {SUB} slots vs the main path's "
            f"image: {bad_pixels(got, want)} of {SUB * J} pixels differ, "
            f"max |diff| {err:.3g}")
        if bad:
            raise AssertionError(f"main-path pixels disagree with the {what} "
                                 f"version ({bad} elements)")

    # ---- 4. plain vs kernel time at 256^2 spp 4 (plain, kernel, kernel, plain) ----
    ss, sp = build_scene(make_cornell_box_scene(mesh, box_only=False),
                         device=dev, image_width=256, image_height=256,
                         samples_per_pixel=4)
    rows, cols, R, J, n_pix = stream(sp)
    kw = dict(params=sp, slots=R, j_per_slot=J, spp=4,
              max_iters=J * 4 * sp.max_path_length + 16)
    t_p, t_k = [], []
    for fn, acc in ((mk.megakernel_path_trace_ref, t_p),
                    (mk.megakernel_path_trace, t_k),
                    (mk.megakernel_path_trace, t_k),
                    (mk.megakernel_path_trace_ref, t_p)):
        _, t = timed(lambda: fn(ss, rows, cols, 1442, n_pix, **kw))
        acc.append(t)
    log(f"[256^2 spp 4] plain {', '.join(f'{t:.3f}' for t in t_p)} s; "
        f"kernel {', '.join(f'{t:.4f}' for t in t_k)} s")

    log(json.dumps({"kernels": [{
        "name": "megakernel_path_trace",
        "route": "cuda",
        "source": "ipu_ray_lib_tpu_torch/ops/cuda/megakernel.cu",
        "replaces": "ipu_ray_lib_tpu/ops/pallas/megakernel.py:329",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": k_main * 1e3,
        "plain_ms": p_main * 1e3,
        "ms_shape": pool_shape,
        "main_ms": main_ms,
        "main_shape": f"main path's launch, {FULL}^2 spp {SPP}, CUDA events",
    }]}))
    log(identity)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
