"""Image I/O: EXR/PNG output and MSE helpers.

Copy of ``ipu_ray_lib_tpu/utils/image.py``. ``cv2`` is optional: ``.exr``
never needs it (the built-in codec, :mod:`.exr`); other formats need it
to be written as images, and without it fall back to a ``.npy`` beside
the requested path.

Plays the role of the reference's OpenCV image plumbing
(ref: trace.cpp:505-540, src/app_utils.cpp:61-127). Images here are numpy
float32 arrays in RGB channel order, shape [H, W, 3]; conversion to BGR
happens only at the cv2 boundary.
"""

import os

import numpy as np

os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")

try:
    import cv2

    _HAVE_CV2 = True
except Exception:  # pragma: no cover
    _HAVE_CV2 = False


def write_image(path: str, rgb: np.ndarray) -> None:
    """Write an RGB float image. `.exr` keeps float32; else tonemap to 8-bit."""
    rgb = np.asarray(rgb, dtype=np.float32)
    if path.endswith(".exr"):
        # cv2 builds here lack an EXR writer; use the built-in codec.
        from .exr import write_exr

        write_exr(path, rgb)
        return
    if _HAVE_CV2:
        bgr = rgb[..., ::-1]
        cv2.imwrite(path, np.clip(bgr * 255.0, 0, 255).astype(np.uint8))
        return
    # Fallback: raw .npy next to the requested path.
    np.save(path + ".npy", rgb)


def read_image(path: str) -> np.ndarray:
    if path.endswith(".exr"):
        from .exr import read_exr

        return read_exr(path)
    if not _HAVE_CV2:
        raise RuntimeError("cv2 unavailable: cannot read images")
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED | cv2.IMREAD_ANYDEPTH)
    if img is None:
        raise FileNotFoundError(path)
    img = img.astype(np.float32)
    if img.ndim == 3 and img.shape[2] >= 3:
        img = img[..., :3][..., ::-1]  # BGR -> RGB
    return img


def mse(a: np.ndarray, b: np.ndarray) -> float:
    """Mean squared error, the reference's cross-renderer check (trace.cpp:528-540)."""
    d = np.asarray(a, np.float32) - np.asarray(b, np.float32)
    return float(np.mean(d * d))
