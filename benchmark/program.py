"""What the modes take from the system under test, the PyTorch and CUDA
package ``ipu_ray_lib_tpu_torch``: its kernel library, its scene build
and its NIF loader, each behind the benchmark's own host span; and the
reference side of a configuration (its plain scene and tables)."""

from __future__ import annotations

import importlib
import time

import torch

from .harness import sync
from .reference import geometry as RG
from .reference import scene as RS


def load_kernels(devices, spans: dict) -> None:
    """The kernel library's first load (built into the checkout's cache
    at first use): span ``kernels.load_s``."""
    t = time.perf_counter()
    if devices[0].type == "cuda":
        from ipu_ray_lib_tpu_torch.ops.cuda import build

        build.load()
    spans["kernels.load_s"] = time.perf_counter() - t


def build(cell, device, spans: dict):
    """The configuration's scene through the system's normal path:
    (scene, params, env or None); span ``scene.build_s``."""
    from ipu_ray_lib_tpu_torch.scene.build import build_scene

    cfg = cell.config
    prog = cfg["program"]
    t = time.perf_counter()
    mod, fn = prog["scene"].split(":")
    args = [cell.path(a) if isinstance(a, str) and a.startswith("assets/")
            else a for a in prog.get("args", [])]
    desc = getattr(importlib.import_module(mod), fn)(*args)
    scene, params = build_scene(
        desc, device=device, image_width=cfg["image_width"],
        image_height=cfg["image_height"],
        samples_per_pixel=cfg["samples_per_pixel"],
        intersector=cfg["intersector"],
        max_path_length=cfg["max_path_length"],
        anti_alias_scale=cfg["anti_alias_scale"],
        roulette_start_depth=cfg["roulette_start_depth"])
    env = None
    if cfg.get("nif"):
        from ipu_ray_lib_tpu_torch.nif.model import load_nif_env

        env = load_nif_env(cell.path(cfg["nif"]), device=device)
    sync([device])
    spans["scene.build_s"] = time.perf_counter() - t
    return scene, params, env


def reference_tables(cell, device, dt=torch.float32):
    """The plain reference's scene and tables of the configuration."""
    sc = RS.load(cell.config["scene"], cell.root)
    return sc, RG.tables(sc, device, dt)


def control_dtype(cell):
    """The float type one step below the configuration's stated one."""
    return {"float32": torch.bfloat16}[cell.config["precision"]["render"]]
