"""The grid512 configuration's heightfield as the plain reference builds
it: a displaced grid of ``n x n`` vertices over x in [-8, 8], z in
[-16, -2], two triangles per cell, written out in float32 numpy in the
order of the renderer's large-scene generator (vertices row-major over
(x, z); the first triangle of every cell, then the second), each
triangle wound (a, c, b) and (b, c, d) so that its face points up, to
the light (``benchmark/scenes/grid512.py`` says why).

``mesh(entry)`` returns (triangles [2 (n-1)^2, 3] u32, vertices [n^2, 3]
f32) for the configuration's mesh entry, whose ``grid`` is n."""

from __future__ import annotations

import numpy as np


def heightfield(n: int) -> tuple[np.ndarray, np.ndarray]:
    xs = np.linspace(-8.0, 8.0, n, dtype=np.float32)
    zs = np.linspace(-16.0, -2.0, n, dtype=np.float32)
    x, z = np.meshgrid(xs, zs, indexing="ij")
    y = (-2.0 + 0.6 * np.sin(1.3 * x) * np.cos(0.9 * z)
         + 0.25 * np.sin(4.1 * x + 1.7) * np.sin(3.3 * z)).astype(np.float32)
    verts = np.stack([x, y, z], axis=-1).reshape(-1, 3)
    idx = np.arange(n * n, dtype=np.uint32).reshape(n, n)
    a, b = idx[:-1, :-1].ravel(), idx[1:, :-1].ravel()
    c, d = idx[:-1, 1:].ravel(), idx[1:, 1:].ravel()
    tris = np.concatenate([np.stack([a, c, b], axis=-1),
                           np.stack([b, c, d], axis=-1)])
    return tris, verts


def mesh(entry: dict) -> tuple[np.ndarray, np.ndarray]:
    return heightfield(int(entry["grid"]))
