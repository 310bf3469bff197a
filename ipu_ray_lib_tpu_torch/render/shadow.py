"""Shadow-trace integrator (the validation renderer).

Port of ``ipu_ray_lib_tpu/render/shadow.py``: primary closest hit, then
one occlusion ray to a fixed point light; lambertian + ambient shading;
the full AOV set. It runs the fused shadow kernel K4 (ops/shadow.py) on
the blocked tables of VMEM mode (``intersector="pallas"``). The JAX
package takes another route above its VMEM ceiling (two intersect
dispatches of K5/K6 glued by XLA), which is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.shadow import fused_shadow_trace

DEFAULT_LIGHT_POS = (18.0, 257.0, -1060.0)
DEFAULT_AMBIENT = 0.05


class TraceResultSoA(NamedTuple):
    """Per-ray results, structure of arrays."""

    rgb: torch.Tensor      # [R, 3]
    t: torch.Tensor        # [R] hit distance (inf if escaped)
    geom_id: torch.Tensor  # [R] i32 (INVALID_GEOM_ID if escaped)
    prim_id: torch.Tensor  # [R] i32 (-1 if escaped)
    normal: torch.Tensor   # [R, 3]
    hit_p: torch.Tensor    # [R, 3]
    escaped: torch.Tensor  # [R] bool


def require_vmem_mode(intersector: str) -> None:
    """The shadow trace runs K4 in VMEM mode only; raise otherwise."""
    if intersector == "pallas-hbm":
        raise NotImplementedError(
            "the shadow trace of a pallas-hbm scene takes the JAX package's "
            "glue route through the intersect kernels K5/K6, which is not "
            "ported yet (ROADMAP queue 1 item 10); build the scene with "
            "intersector='pallas'")
    if intersector != "pallas":
        raise ValueError(f"unknown intersector {intersector!r}")


def shadow_trace(scene, origins, dirs: torch.Tensor,
                 light_pos=DEFAULT_LIGHT_POS, ambient: float = DEFAULT_AMBIENT,
                 intersector: str = "pallas") -> TraceResultSoA:
    """Shadow-trace the rays (dirs [R, 3] f32 on the scene's device;
    origins the same, or None for camera rays from (0, 0, 0), as the JAX
    package's camera makes them and XLA then folds them): the kernel on a
    CUDA scene, its plain version on a CPU scene."""
    require_vmem_mode(intersector)
    return TraceResultSoA(*fused_shadow_trace(scene, origins, dirs,
                                              light_pos, ambient))
