"""AOV image assembly (visualise modes).

Copy of ``ipu_ray_lib_tpu/render/aov.py`` (which imports no JAX; the
port keeps its own copy): turn a rendered :class:`RenderOutput` into one
of six images, numpy float32 [H, W, 3] in RGB channel order.
"""

from __future__ import annotations

import enum

import numpy as np


class VisualiseMode(enum.Enum):
    RGB = "rgb"
    GEOM_AND_PRIM_ID = "id"
    NORMAL = "normal"
    RAY_TFAR = "tfar"
    MAT_COLOR = "color"
    HIT_POINT = "hitpoint"


def make_aov_image(output, mode: VisualiseMode, mat_id=None,
                   mat_albedo=None) -> np.ndarray:
    """Build the requested AOV image from a RenderOutput.

    ``mat_id``/``mat_albedo`` (numpy) are needed for the id/color modes.
    """
    h, w = output.rgb.shape[:2]
    geom = np.asarray(output.geom_id)
    found = geom >= 0

    if mode == VisualiseMode.RGB:
        return np.asarray(output.rgb, np.float32)
    if mode == VisualiseMode.NORMAL:
        return np.where(found[..., None], np.asarray(output.normal, np.float32), 0.0)
    if mode == VisualiseMode.RAY_TFAR:
        return np.repeat(np.asarray(output.t, np.float32)[..., None], 3, axis=-1)
    if mode == VisualiseMode.HIT_POINT:
        return np.where(found[..., None], np.asarray(output.hit_p, np.float32), 0.0)
    if mode == VisualiseMode.GEOM_AND_PRIM_ID:
        # Zero means no hit, so ids are incremented by one.
        img = np.zeros((h, w, 3), np.float32)
        gsafe = np.where(found, geom, 0)
        img[..., 0] = np.where(found, geom + 1, 0)
        img[..., 1] = np.where(found, np.asarray(output.prim_id) + 1, 0)
        img[..., 2] = np.where(found, np.asarray(mat_id)[gsafe] + 1, 0)
        return img
    if mode == VisualiseMode.MAT_COLOR:
        gsafe = np.where(found, geom, 0)
        col = np.asarray(mat_albedo)[np.asarray(mat_id)[gsafe]]
        return np.where(found[..., None], col.astype(np.float32), 0.0)
    raise ValueError(f"Unknown visualise mode {mode}")
