"""The one traffic generator. A traffic file (``benchmark/traffic/
<name>.json``) names the mode that serves it and the parameters this
module turns into each frame's inputs. Frames come back to back (a
closed loop: one viewer who asks for the next frame when the last one
is on the screen). Every frame of every seed costs the same work; the
seed changes only which paths and rays are drawn:

* every frame: its renderer seed, a u32 drawn from (seed, i);
* ``zoom``: frame i's field of view is the configuration's times
  1 + z, z uniform in [-zoom, zoom], drawn from (seed, i): a viewer
  zooming in and out;
* ``check_pixels``: the raster pixels of frame i whose answers the run
  compares with the reference, drawn from (seed, i).
"""

from __future__ import annotations

import numpy as np

_U64 = (1 << 64) - 1


def _rng(seed: int, i: int, stream: int) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64(
        np.random.SeedSequence([seed & _U64, i & _U64, stream])))


def frame_seed(seed: int, i: int) -> int:
    """Frame i's u32 renderer seed."""
    return int(_rng(seed, i, 1).integers(0, 1 << 32))


def zoom(traffic: dict, seed: int, i: int) -> float:
    """Frame i's factor on the field of view."""
    z = float(traffic.get("zoom", 0.0))
    return 1.0 + float(_rng(seed, i, 2).uniform(-z, z)) if z else 1.0


def check_pixels(traffic: dict, seed: int, i: int, n_pix: int) -> np.ndarray:
    """Frame i's sorted sample of distinct raster pixels to check."""
    k = min(int(traffic["check_pixels"]), n_pix)
    return np.sort(_rng(seed, i, 3).choice(n_pix, size=k, replace=False))
