"""Shadow-traced frames through ``render(mode="shadow-trace")``, every
AOV read back, back to back. Frame i's field of view is the
configuration's times the traffic's zoom for (seed, i): the shadow trace
draws no random numbers, so the seed changes its rays through the camera.
The check works out every AOV of each frame's sampled pixels with the
plain shadow trace: ``aov_mismatch_pct`` is the share of them, in
percent, where the system disagrees with it (ids unequal, or a float
AOV further than rtol 1e-5 + atol 1e-6 from it; inf equals inf)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from benchmark import program, traffic
from benchmark.harness import Frame
from benchmark.reference import shadow as RSH

AOVS = ("rgb", "t", "geom_id", "prim_id", "normal", "hit_p")
RTOL, ATOL = 1e-5, 1e-6


class Program:
    def __init__(self, cell, seed, devices, spans):
        self.cell, self.seed, self.devices = cell, seed, devices
        cfg = cell.config
        program.load_kernels(devices, spans)
        self.scene, self.params, _ = program.build(cell, devices[0], spans)
        self.n_pix = cfg["image_width"] * cfg["image_height"]
        self.chunk = int(cell.traffic["chunk"])

    def render(self, zoom: float):
        from ipu_ray_lib_tpu_torch.render.renderer import render

        params = dataclasses.replace(
            self.params, fov_radians=self.params.fov_radians * zoom)
        return render(self.scene, params, mode="shadow-trace",
                      chunk_size=self.chunk)

    def warm(self) -> None:
        self.render(1.0)

    def frame(self, i: int) -> Frame:
        out = self.render(traffic.zoom(self.cell.traffic, self.seed, i))
        pix = traffic.check_pixels(self.cell.traffic, self.seed, i,
                                   self.n_pix)
        sample = {k: getattr(out, k).reshape(self.n_pix, -1)[pix].copy()
                  for k in AOVS}
        return Frame(self.n_pix, True, sample)

    def release(self) -> None:
        self.scene = None


def reference(cell, seed, n_frames, device, control=False):
    cfg = cell.config
    dt = program.control_dtype(cell) if control else torch.float32
    sc, tb = program.reference_tables(cell, device, dt)
    w, h = cfg["image_width"], cfg["image_height"]
    out = []
    for i in range(n_frames):
        pix = traffic.check_pixels(cell.traffic, seed, i, w * h)
        rows = torch.from_numpy((pix // w).astype(np.float32)).to(device, dt)
        cols = torch.from_numpy((pix % w).astype(np.float32)).to(device, dt)
        a = RSH.aovs(tb, rows, cols, w=w, h=h,
                     fov=sc.fov * traffic.zoom(cell.traffic, seed, i),
                     light=cfg["light"], ambient=cfg["ambient"])
        out.append({k: a[k].float().cpu().numpy().reshape(len(pix), -1)
                    if a[k].is_floating_point()
                    else a[k].cpu().numpy().reshape(len(pix), -1)
                    for k in AOVS})
    return out


def mismatched(got: dict, want: dict) -> np.ndarray:
    """[P] bool: pixels where any AOV disagrees."""
    bad = np.zeros(len(want["t"]), bool)
    for k in AOVS:
        g = np.asarray(got[k], np.float64)
        r = np.asarray(want[k], np.float64)
        if k in ("geom_id", "prim_id"):
            bad |= (g != r).any(axis=1)
            continue
        same_inf = np.isinf(g) & np.isinf(r) & (np.sign(g) == np.sign(r))
        with np.errstate(invalid="ignore"):
            close = np.abs(g - r) <= ATOL + RTOL * np.abs(r)
        bad |= ~(close | same_inf).all(axis=1)
    return bad


def compare(got, want) -> dict:
    bad = np.concatenate([mismatched(g, w) for g, w in zip(got, want)])
    return {"aov_mismatch_pct": 100.0 * float(bad.mean())}


def check(cell, seed, frames, device) -> dict:
    return compare([f.sample for f in frames],
                   reference(cell, seed, len(frames), device))
