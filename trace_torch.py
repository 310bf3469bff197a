#!/usr/bin/env python
"""trace_torch.py — render a scene on a CUDA card with the PyTorch + CUDA
port, with CPU-twin and oracle verification.

The port's counterpart of ``trace.py`` (the application layer; ref:
trace.cpp:338-424 for the flag set, 426-544 for the run/verify flow):
the same flags, defaults and flow, through ``ipu_ray_lib_tpu_torch``
only. It renders the scene with:

  * the brute-force numpy f64 oracle (the "Embree role" reference image,
    shadow trace only),
  * the port's plain torch versions on the CPU (the CPU twin), and
  * the card (``--device cuda``, the default; it raises without a card,
    never falling back to the CPU) or the CPU (``--device cpu``),

then writes EXR AOVs ``{outprefix}_{visualise}_{gpu,cpu,oracle}.exr`` and
reports cross-renderer MSE. ``--gpu-only`` (alias ``--tpu-only``) skips
the oracle and the CPU twin. On ``--device cpu`` the ``gpu`` image is the
CPU's own render.

    python trace_torch.py --scene box -w 256 -H 256 --samples 64 --gpu-only
    python trace_torch.py --scene box-simple --render-mode shadow-trace \\
        --visualise normal --device cpu

``--devices N`` (N > 1) shards a path trace over min(N, cards) cards
(``parallel/mesh.py``); on ``--device cpu`` over N shards of the CPU.
With ``--nif-hdri`` a sharded path trace is the per-sample wavefront
(``render_path_sharded``, as trace.py takes it): the window's pixels in
scanline order, padded to a multiple of the shards, keyed by
``PRNGKey(--seed)``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np


def add_options(p: argparse.ArgumentParser) -> None:
    # Flag set mirrors trace.py:25-85 (which mirrors ref trace.cpp:338-378).
    p.add_argument("-o", "--outprefix", default="out", help="Output filename prefix.")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="Render on the CUDA card (the kernels; raises without "
                        "one) or on the CPU (the kernels' plain versions).")
    p.add_argument("--devices", type=int, default=0,
                   help="Number of devices to shard a path trace's rays over "
                        "(0 = all available cards; on --device cpu, shards "
                        "of the CPU).")
    p.add_argument("--chunk-size", type=int, default=1 << 16,
                   help="Rays per device chunk (the shadow trace's chunk, the "
                        "path trace's slot pool cap).")
    p.add_argument("-w", "--width", type=int, default=768, help="Image width.")
    p.add_argument("-H", "--height", type=int, default=432, help="Image height.")
    p.add_argument("--crop", default="",
                   help="Render window, format wxh+c+r (width x height + col + row offset).")
    p.add_argument("--anti-alias", type=float, default=0.25,
                   help="Std-dev of gaussian anti-aliasing jitter in pixels.")
    p.add_argument("--mesh-file", default="",
                   help="Scene file to render (.glb/.gltf/.dae/.obj/.ply/.stl/"
                        ".fbx/.off).")
    p.add_argument("--nif-hdri", default="",
                   help="Path to the assets.extra directory of a saved NIF model "
                        "(HDRI environment light for escaped rays).")
    p.add_argument("--hdri-rotation", type=float, default=0.0,
                   help="Azimuthal rotation for the HDRI environment (degrees).")
    p.add_argument("--load-normals", action="store_true",
                   help="Load & interpolate vertex normals from the mesh file.")
    p.add_argument("--scene", default="box", choices=["box-simple", "box", "spheres"],
                   help="Built-in scene (when no mesh-file given).")
    p.add_argument("--visualise", default="rgb",
                   choices=["rgb", "normal", "hitpoint", "tfar", "color", "id"],
                   help="AOV to write.")
    p.add_argument("--render-mode", default="path-trace",
                   choices=["shadow-trace", "path-trace"])
    p.add_argument("--max-path-length", type=int, default=10)
    p.add_argument("--roulette-start-depth", type=int, default=3)
    p.add_argument("--samples", type=int, default=256, help="Samples per pixel.")
    p.add_argument("--seed", type=int, default=1442)
    p.add_argument("--max-nif-batch-size", type=int, default=0,
                   help="Kept for interface parity; the NIF runs on every "
                        "escaped path of a launch at once.")
    p.add_argument("--gpu-only", "--tpu-only", dest="gpu_only",
                   action="store_true",
                   help="Skip the CPU/oracle reference renders.")
    p.add_argument("--progressive", action="store_true",
                   help="Report partial results batch by batch while rendering "
                        "(RayCallback analogue).")
    p.add_argument("--intersector", default="auto",
                   choices=["auto", "bvh", "dense", "pallas", "pallas-hbm"],
                   help="Closest-hit engine: 'pallas' (the VMEM-mode walk), "
                        "'pallas-hbm' (the HBM-mode walk, any scene size), "
                        "'auto' (one of those two, by scene size), 'bvh' (the "
                        "threaded-BVH walk, any scene size) or 'dense' (every "
                        "ray against every triangle); 'bvh' and 'dense' path "
                        "trace on the XLA-loop integrator.")
    p.add_argument("--compile-only", action="store_true",
                   help="Build the CUDA kernels (with a compile-progress "
                        "heartbeat) and the scene's tables (saved with "
                        "--scene-cache), then exit without rendering.")
    p.add_argument("--scene-cache", default="",
                   help="Directory for compiled-scene bundles: import, BVH "
                        "build and table packing persist across runs, keyed "
                        "by the scene-affecting flags (the reference's "
                        "saveExe/loadExe pathway, ipu_utils.hpp:51-76).")
    p.add_argument("--log-level", default="info",
                   choices=["trace", "debug", "info", "warn", "err", "critical", "off"])


def parse_crop(s: str):
    import re

    from ipu_ray_lib_tpu_torch.scene.types import CropWindow

    if not s:
        return None
    m = re.search(r"(\d+)x(\d+)\+(\d+)\+(\d+)", s)
    if not m:
        raise ValueError(f"Badly formatted --crop string: '{s}'")
    return CropWindow(int(m.group(1)), int(m.group(2)), int(m.group(3)), int(m.group(4)))


def build_scene_description(args):
    from ipu_ray_lib_tpu_torch.scene.builtin import (make_cornell_box_scene,
                                                     make_primitive_scene)
    from ipu_ray_lib_tpu_torch.scene.io import import_scene
    from ipu_ray_lib_tpu_torch.scene.types import PathTraceSettings

    if args.mesh_file:
        scene = import_scene(args.mesh_file, load_normals=args.load_normals)
    elif args.scene in ("box", "box-simple"):
        mesh_file = "assets/monkey_bust.glb"
        if not os.path.exists(mesh_file):
            mesh_file = None
        scene = make_cornell_box_scene(mesh_file, box_only=args.scene == "box-simple")
    elif args.scene == "spheres":
        scene = make_primitive_scene()
    else:
        raise ValueError(f"Invalid scene selection: {args.scene}")

    if args.render_mode == "path-trace":
        scene.path_trace = PathTraceSettings(
            samples_per_pixel=args.samples,
            max_path_length=args.max_path_length,
            roulette_start_depth=args.roulette_start_depth,
            rng_seed=args.seed,
        )
    return scene


def scene_cache_path(args) -> str | None:
    """The bundle of these flags in ``--scene-cache`` (None without one):
    keyed as trace.py keys it (trace.py:206-231: every flag that changes
    the built scene or params, mesh files by path, mtime and size) plus
    the port's bundle format, so the two packages never share a file."""
    if not args.scene_cache:
        return None
    import hashlib
    import json

    from ipu_ray_lib_tpu_torch.scene.cache import FORMAT

    mesh_key = ""
    if args.mesh_file:
        st = os.stat(args.mesh_file)
        mesh_key = (f"{os.path.abspath(args.mesh_file)}"
                    f":{st.st_mtime_ns}:{st.st_size}")
    keysrc = json.dumps(
        {"scene": args.scene, "mesh": mesh_key,
         "normals": args.load_normals,
         "w": args.width, "h": args.height, "crop": args.crop,
         "aa": args.anti_alias, "mpl": args.max_path_length,
         "rsd": args.roulette_start_depth, "spp": args.samples,
         "seed": args.seed, "intersector": args.intersector,
         "format": FORMAT},
        sort_keys=True)
    tag = hashlib.sha1(keysrc.encode()).hexdigest()[:16]
    os.makedirs(args.scene_cache, exist_ok=True)
    return os.path.join(args.scene_cache, f"scene-{tag}.tprs")


def run(argv=None) -> dict:
    """Parse ``argv`` and run; returns the run's record: ``outputs``
    (each written EXR by kind), ``seconds`` (import, build, cache_load,
    cache_save, nif_load, compile, oracle, cpu_twin, render, exr_write,
    where they ran), ``mse``, ``cache_hit``, ``shards``, ``hit_count``
    (shadow trace) and the params."""
    parser = argparse.ArgumentParser(description=__doc__)
    add_options(parser)
    args = parser.parse_args(argv)

    from ipu_ray_lib_tpu_torch.scene.build import resolve_intersector
    from ipu_ray_lib_tpu_torch.utils.log import logger, setup_logging

    try:
        window = parse_crop(args.crop)
        resolve_intersector(args.intersector, 0)
    except ValueError as e:
        parser.error(str(e))
    if args.render_mode == "path-trace" and args.visualise != "rgb":
        parser.error("Path tracing without visualise=rgb is not advised.")

    setup_logging(args.log_level)
    log = logger()

    import torch

    from ipu_ray_lib_tpu_torch.runtime.config import (RuntimeConfig,
                                                      acquire_devices)

    # The cards (--devices of them; 0: all), or CPU shards when asked:
    # never a fallback. The scene is built on the first.
    devices = acquire_devices(RuntimeConfig(num_devices=args.devices,
                                            use_cpu=args.device == "cpu"))
    dev, n_shards = devices[0], len(devices)
    sharded = n_shards > 1 and args.render_mode == "path-trace"

    from ipu_ray_lib_tpu_torch.cpu.reference import (camera_rays,
                                                     oracle_shadow_trace)
    from ipu_ray_lib_tpu_torch.render.aov import VisualiseMode, make_aov_image
    from ipu_ray_lib_tpu_torch.render.renderer import (RenderOutput, _AOVS,
                                                       _filled, render)
    from ipu_ray_lib_tpu_torch.scene.build import build_scene
    from ipu_ray_lib_tpu_torch.scene.cache import (load_compiled_scene,
                                                   save_compiled_scene)
    from ipu_ray_lib_tpu_torch.utils.image import mse, write_image

    build_kwargs = dict(
        image_width=args.width,
        image_height=args.height,
        window=window,
        anti_alias_scale=args.anti_alias,
        max_path_length=args.max_path_length,
        roulette_start_depth=args.roulette_start_depth,
        samples_per_pixel=args.samples,
        rng_seed=args.seed,
        intersector=args.intersector,
    )
    rec = {"outputs": {}, "seconds": {}, "mse": {}, "shards": n_shards}
    sec = rec["seconds"]

    def timed(key, fn):
        t0 = time.perf_counter()
        out = fn()
        sec[key] = time.perf_counter() - t0
        return out

    cache_path = scene_cache_path(args)
    scene = None  # the SceneDescription (imported only when needed)
    rec["cache_hit"] = cache_path is not None and os.path.exists(cache_path)
    if rec["cache_hit"]:
        tscene, params = timed("cache_load",
                               lambda: load_compiled_scene(cache_path, dev))
        log.info("Loaded compiled scene from cache: %s", cache_path)
    else:
        scene = timed("import", lambda: build_scene_description(args))
        tscene, params = timed(
            "build", lambda: build_scene(scene, device=dev, **build_kwargs))
        if cache_path is not None:
            timed("cache_save",
                  lambda: save_compiled_scene(cache_path, tscene, params))
            log.info("Saved compiled scene to cache: %s", cache_path)
    rec["params"] = params
    log.info(
        "Scene built: %d geoms, %d BVH nodes (max depth %d), window %dx%d+%d+%d, intersector=%s",
        params.num_geoms, params.num_bvh_nodes, params.bvh_max_depth,
        params.window_w, params.window_h, params.window_c, params.window_r,
        params.intersector,
    )

    env = None
    if args.nif_hdri:
        from ipu_ray_lib_tpu_torch.nif.model import load_nif_env

        env = timed("nif_load", lambda: load_nif_env(
            args.nif_hdri, rotation_degrees=args.hdri_rotation, device=dev))
        log.info("Loaded NIF environment light from %s", args.nif_hdri)

    if args.compile_only:
        # The kernels land in _build/ for later runs (ref
        # RuntimeConfig::compileOnly, ipu_utils.hpp:581-584); the scene's
        # tables are built above and saved with --scene-cache.
        if dev.type == "cuda":
            from ipu_ray_lib_tpu_torch.runtime.config import compile_only

            timed("compile", compile_only)
        log.info("Compile-only run complete; exiting without execution.")
        return rec

    vis = VisualiseMode(args.visualise)
    prefix = f"{args.outprefix}_{args.visualise}_"
    mat_id = tscene.mat_id.cpu().numpy()
    mat_albedo = tscene.mat_albedo.cpu().numpy()
    images = {}

    def write(kind, img):
        path = prefix + kind + ".exr"
        t0 = time.perf_counter()
        write_image(path, img)
        sec[f"exr_write_{kind}"] = time.perf_counter() - t0
        rec["outputs"][kind] = path
        images[kind] = img

    spp = args.samples if args.render_mode == "path-trace" else 1
    if not args.gpu_only:
        # Oracle reference (the Embree role):
        if args.render_mode == "shadow-trace":
            if scene is None:  # a cache hit: the oracle reads the scene
                scene = timed("import", lambda: build_scene_description(args))
            _, d = camera_rays(params.window_w, params.window_h,
                               params.window_c, params.window_r, args.width,
                               args.height, params.fov_radians)
            res = timed("oracle", lambda: oracle_shadow_trace(
                scene, np.zeros_like(d), d))
            log.info("Oracle ray rate: %.3g rays/sec", len(d) / sec["oracle"])
            hw = (params.window_h, params.window_w)
            oracle = RenderOutput(
                rgb=res["rgb"].reshape(hw + (3,)), t=res["t"].reshape(hw),
                geom_id=res["geom"].reshape(hw),
                prim_id=res["prim"].reshape(hw),
                normal=res["normal"].reshape(hw + (3,)),
                hit_p=res["hit_p"].reshape(hw + (3,)))
            write("oracle", make_aov_image(oracle, vis, mat_id, mat_albedo))
        else:
            log.info("Oracle path tracing skipped (matches reference: no Embree path trace).")

        # CPU twin: the same scene through the plain versions on the CPU.
        cpu = torch.device("cpu")
        out = timed("cpu_twin", lambda: render(
            tscene.to(cpu), params, mode=args.render_mode,
            chunk_size=args.chunk_size,
            env=None if env is None else env.to(cpu)))
        log.info(
            "CPU-twin rate: %.3g %s/sec",
            params.window_w * params.window_h * spp / sec["cpu_twin"],
            "path-samples" if spp > 1 else "rays",
        )
        write("cpu", make_aov_image(out, vis, mat_id, mat_albedo))

    # The render on --device:
    cb = None
    if args.progressive:
        def cb(ci, rgb_chunk):
            log.info("chunk %d done (mean %.4f)", ci, float(rgb_chunk.mean()))

    t0 = time.perf_counter()
    if sharded:
        # Data-parallel over a mesh (replicated scene, sharded rays), with
        # trace.py's arguments (its _render_sharded: chunk_slots default):
        from ipu_ray_lib_tpu_torch.ops.camera import pixel_grid
        from ipu_ray_lib_tpu_torch.parallel.mesh import (
            make_ray_mesh, render_path_sharded, render_streaming_sharded,
            shard_rays)
        from ipu_ray_lib_tpu_torch.utils.threefry import PRNGKey

        mesh = make_ray_mesh(devices)
        n = params.window_w * params.window_h
        if env is None:
            rgb, _done = render_streaming_sharded(tscene, params, mesh,
                                                  progress_callback=cb)
        else:
            # trace.py's _render_sharded under an env: the per-sample
            # wavefront over the scanline pixel grid.
            rows, cols = pixel_grid(params.window_w, params.window_h,
                                    params.window_c, params.window_r, "cpu")
            pad = shard_rays(n, mesh) - n
            rgb = render_path_sharded(
                tscene, params, torch.nn.functional.pad(rows, (0, pad)),
                torch.nn.functional.pad(cols, (0, pad)),
                PRNGKey(params.rng_seed), mesh, env=env)
            rgb = rgb[:n].numpy().reshape(params.window_h, params.window_w, 3)
        out = RenderOutput(rgb=rgb, **{
            k: _filled(k, n).reshape((params.window_h, params.window_w)
                                     + _AOVS[k][0])
            for k in _AOVS if k != "rgb"})
        log.info("Sharded render over %d devices", n_shards)
    else:
        # Read back only the AOV fields this visualise mode needs:
        needed = {
            "rgb": ("rgb",), "normal": ("normal",), "tfar": ("t",),
            "hitpoint": ("hit_p",), "id": ("prim_id",), "color": (),
        }[args.visualise]
        out = render(tscene, params, mode=args.render_mode,
                     chunk_size=args.chunk_size, env=env,
                     progress_callback=cb, aovs=needed)
    dt = sec["render"] = time.perf_counter() - t0
    log.info(
        "Render rate: %.4g %s/sec (%.2fs)",
        params.window_w * params.window_h * spp / dt,
        "path-samples" if spp > 1 else "rays", dt,
    )
    write("gpu", make_aov_image(out, vis, mat_id, mat_albedo))
    if args.render_mode == "shadow-trace":
        rec["hit_count"] = out.hit_count
        log.info("Hit count: %d", out.hit_count)

    if "cpu" in images:
        rec["mse"]["cpu"] = mse(images["gpu"], images["cpu"])
        log.info("MSE GPU vs CPU-twin: %.6g", rec["mse"]["cpu"])
    if "oracle" in images:
        rec["mse"]["oracle"] = mse(images["gpu"], images["oracle"])
        log.info("MSE GPU vs oracle: %.6g", rec["mse"]["oracle"])

    log.info("Done.")
    return rec


def main(argv=None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
