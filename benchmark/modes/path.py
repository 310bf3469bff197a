"""Path-traced frames through ``render_streaming`` on one card, back to
back, each seeded from the run's seed and its index. The check traces the
sampled pixels of every frame with the plain path tracer and compares
the RGB values: ``pixel_rel_l1``, sum |system - reference| over sum
|reference|."""

from __future__ import annotations

import numpy as np
import torch

from benchmark import program, stats, traffic
from benchmark.harness import Frame
from benchmark.reference import path as RP
from benchmark.reference.nif import PlainNif


class Program:
    shards = None

    def __init__(self, cell, seed, devices, spans):
        self.cell, self.seed, self.devices = cell, seed, devices
        cfg = cell.config
        program.load_kernels(devices, spans)
        self.scene, self.params, self.env = program.build(cell, devices[0],
                                                          spans)
        self.n_pix = cfg["image_width"] * cfg["image_height"]
        self.paths = self.n_pix * cfg["samples_per_pixel"]
        self.chunk = int(cell.traffic["chunk"])

    def render(self, frame_seed: int):
        from ipu_ray_lib_tpu_torch.render.streaming import render_streaming

        return render_streaming(self.scene, self.params,
                                chunk_slots=self.chunk, env=self.env,
                                seed=frame_seed)

    def warm(self) -> None:
        self.render(traffic.frame_seed(self.seed, -1))

    def frame(self, i: int) -> Frame:
        img, done = self.render(traffic.frame_seed(self.seed, i))
        pix = traffic.check_pixels(self.cell.traffic, self.seed, i,
                                   self.n_pix)
        return Frame(self.paths, done == self.paths,
                     img.reshape(-1, 3)[pix].copy())

    def release(self) -> None:
        self.scene = self.env = None


def reference(cell, seed, n_frames, device, control=False, shards=None):
    """The reference's RGB of every frame's sampled pixels ([P, 3] f32
    numpy per frame); ``control``: in the precision one step below the
    configuration's (render and env MLP)."""
    cfg = cell.config
    dt = program.control_dtype(cell) if control else torch.float32
    sc, tb = program.reference_tables(cell, device, dt)
    env = None
    if cfg.get("nif"):
        nif = PlainNif(cell.path(cfg["nif"]), device)
        op = cfg["precision"]["env_mlp_control" if control else "env_mlp"]
        env = lambda d: nif(d, op)
    n_pix = cfg["image_width"] * cfg["image_height"]
    frames = [(traffic.frame_seed(seed, i),
               traffic.check_pixels(cell.traffic, seed, i, n_pix))
              for i in range(n_frames)]
    rgb = RP.pixels(
        tb, frames, w=cfg["image_width"], h=cfg["image_height"],
        spp=cfg["samples_per_pixel"], chunk=int(cell.traffic["chunk"]),
        shards=shards, fov=sc.fov, aa=cfg["anti_alias_scale"],
        max_len=cfg["max_path_length"], rr_depth=cfg["roulette_start_depth"],
        env=env, device=device, dt=dt)
    return [x.cpu().numpy() for x in rgb]


def compare(got, want) -> dict:
    g = np.concatenate([np.asarray(x, np.float64).ravel() for x in got])
    w = np.concatenate([np.asarray(x, np.float64).ravel() for x in want])
    return {"pixel_rel_l1": stats.rel_l1(g, w) if np.isfinite(g).all()
            else float("inf")}


def check(cell, seed, frames, device, shards=None) -> dict:
    want = reference(cell, seed, len(frames), device, shards=shards)
    return compare([f.sample for f in frames], want)
