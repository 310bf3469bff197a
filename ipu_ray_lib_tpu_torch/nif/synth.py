"""Procedural equirectangular HDRI synthesis (a jax-free copy of
``ipu_ray_lib_tpu/nif/synth.py``: the same image for the same seed).

Stands in for real captured HDRIs (urban_alley-class dynamic range: sun
disc ~1.5e3 radiance, HDR sky gradient, fBm clouds, textured ground) in
an environment with no network egress. Deterministic per seed, so tests
can regenerate the exact image a shipped NIF asset was trained on.
"""

from __future__ import annotations

import numpy as np


def _fbm(shape, octaves, rng, persistence=0.55):
    """Cheap fractal value noise via upsampled random grids."""
    h, w = shape
    out = np.zeros(shape, np.float32)
    amp = 1.0
    for o in range(octaves):
        gh, gw = max(2, h >> (octaves - 1 - o)), max(2, w >> (octaves - 1 - o))
        g = rng.standard_normal((gh, gw)).astype(np.float32)
        ys = np.linspace(0, gh - 1, h)
        xs = np.linspace(0, gw - 1, w)
        y0 = np.clip(ys.astype(int), 0, gh - 2)
        x0 = np.clip(xs.astype(int), 0, gw - 2)
        fy = (ys - y0)[:, None]
        fx = (xs - x0)[None, :]
        v = (g[y0][:, x0] * (1 - fy) * (1 - fx)
             + g[y0 + 1][:, x0] * fy * (1 - fx)
             + g[y0][:, x0 + 1] * (1 - fy) * fx
             + g[y0 + 1][:, x0 + 1] * fy * fx)
        out += amp * v
        amp *= persistence
    return out


def synth_hdri(h=2048, w=4096, seed=11):
    """Procedural equirect HDRI with urban_alley-class dynamic range."""
    rng = np.random.default_rng(seed)
    theta = (np.arange(h) + 0.5) / h * np.pi               # 0..pi from +Y
    phi = (np.arange(w) + 0.5) / w * 2 * np.pi
    tt, pp = np.meshgrid(theta, phi, indexing="ij")
    y = np.cos(tt)                                          # up component

    # Sky gradient: zenith blue -> horizon warm glow:
    zen = np.clip(y, 0, 1)[..., None]
    sky = (np.array([0.18, 0.32, 0.75]) * (0.4 + 0.6 * zen)
           + np.array([0.9, 0.55, 0.25]) * np.exp(-np.abs(y)[..., None] * 6.0))
    # Clouds:
    clouds = np.clip(_fbm((h, w), 7, rng) * 0.5 + 0.2, 0, 2.0)
    sky += (clouds * np.clip(y, 0, 1))[..., None] * np.array([0.8, 0.8, 0.85])

    # Sun disc + halo:
    sun_dir = np.array([np.sin(1.1) * np.cos(0.7), np.cos(1.1),
                        np.sin(1.1) * np.sin(0.7)])
    dirs = np.stack([np.sin(tt) * np.cos(pp), np.cos(tt),
                     np.sin(tt) * np.sin(pp)], axis=-1)
    cosang = np.clip(dirs @ sun_dir, -1, 1)
    sun = np.exp((cosang - 1.0) * 8000.0) * 1500.0
    halo = np.exp((cosang - 1.0) * 40.0) * 6.0
    sky += (sun + halo)[..., None] * np.array([1.0, 0.9, 0.75])

    # Ground: textured warm grey with low-frequency variation:
    ground_tex = 0.25 + 0.12 * _fbm((h, w), 6, rng)
    ground = np.clip(ground_tex, 0.02, 0.6)[..., None] * np.array(
        [0.45, 0.4, 0.36])
    img = np.where((y < 0)[..., None], ground, sky)
    return np.clip(img, 1e-5, 2000.0).astype(np.float32)


