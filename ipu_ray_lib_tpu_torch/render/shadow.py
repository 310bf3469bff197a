"""Shadow-trace integrator (the validation renderer).

Port of ``ipu_ray_lib_tpu/render/shadow.py``: primary closest hit, then
one occlusion ray to a fixed point light; lambertian + ambient shading;
the full AOV set. Two routes, chosen as the JAX package chooses them
(:60-64):

* the fused shadow kernel K4 (ops/shadow.py), when ``fused`` and the
  scene is in VMEM mode (``intersector="pallas"``);
* otherwise the glue route (:66-100): a closest hit with normals
  (ops/traversal.py, kernel K5 or K6; K7 for ``"bvh"``, K8 for
  ``"dense"``), the shadow ray pushed off the surface, an any-hit query
  through the same kernel (K7's any-hit walk for ``"bvh"``), and the
  shading. On a ``"bvh"`` scene on the card that is five launches, the
  glue as three kernels around K7's two walks (ops/shadow.py
  ``bvh_shadow_trace_cuda``); on a ``"pallas-hbm"`` scene on the card,
  three glue kernels around K6's two queries (``hbm_shadow_trace_cuda``);
  elsewhere :func:`glue_shadow_trace`, the torch chain, which also checks
  those kernels. It records, under a
  profiler, the spans ``renderer.hit`` (the closest hit and its normal),
  ``renderer.occlusion`` (the light ray, its offset origin and the
  any-hit query) and ``renderer.shade`` (utils/profiling.py).

Both end in the same shading (ops/shadow.py ``shade``). The JAX package
chooses the route with the ``RAY_SHADOW_FUSED`` environment variable; here
it is the ``fused`` argument.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.bxdf_loop import offset_ray_origin
from ..ops.shadow import (bvh_shadow_trace_cuda, fused_shadow_trace,
                          hbm_shadow_trace_cuda, light_ray, shade)
from ..ops.traversal import scene_intersect_with_normal, scene_occluded
from ..utils.profiling import span

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


def shadow_trace(scene, origins, dirs: torch.Tensor,
                 light_pos=DEFAULT_LIGHT_POS, ambient: float = DEFAULT_AMBIENT,
                 intersector: str = "pallas",
                 fused: bool = True) -> TraceResultSoA:
    """Shadow-trace the rays (dirs [R, 3] f32 on the scene's device;
    origins the same, or None for camera rays from (0, 0, 0), as the JAX
    package's camera makes them and XLA then folds them): the kernels on a
    CUDA scene, their plain versions on a CPU scene."""
    if fused and intersector == "pallas":
        return TraceResultSoA(*fused_shadow_trace(scene, origins, dirs,
                                                  light_pos, ambient))
    if intersector == "bvh" and scene.device.type == "cuda":
        return TraceResultSoA(*bvh_shadow_trace_cuda(scene, origins, dirs,
                                                     light_pos, ambient))
    if intersector == "pallas-hbm" and scene.device.type == "cuda":
        return TraceResultSoA(*hbm_shadow_trace_cuda(scene, origins, dirs,
                                                     light_pos, ambient))
    return glue_shadow_trace(scene, origins, dirs, light_pos, ambient,
                             intersector)


def glue_shadow_trace(scene, origins, dirs: torch.Tensor,
                      light_pos=DEFAULT_LIGHT_POS,
                      ambient: float = DEFAULT_AMBIENT,
                      intersector: str = "pallas") -> TraceResultSoA:
    """The glue route in torch around the closest-hit and any-hit kernels
    of ``intersector`` (their plain versions on a CPU scene), with its
    spans: :func:`shadow_trace`'s route for every scene but a ``"bvh"`` or
    ``"pallas-hbm"`` scene on the card, whose kernels it checks there."""
    R = dirs.shape[0]
    dev = dirs.device
    t_min = torch.zeros(R, dtype=torch.float32, device=dev)
    t_max = torch.full((R,), float("inf"), dtype=torch.float32, device=dev)
    with span("renderer.hit"):
        hit, normal = scene_intersect_with_normal(scene, origins, dirs, t_min,
                                                  t_max, intersector)
    found = hit.found
    with span("renderer.occlusion"):
        hit_p, sdir, dist = light_ray(origins, dirs, found, hit.t, light_pos)
        sorig = offset_ray_origin(hit_p, sdir, normal)
        occ = scene_occluded(scene, sorig, sdir, t_min, dist, intersector)
    with span("renderer.shade"):
        return TraceResultSoA(*shade(scene, hit.geom_id, hit.prim_id, found,
                                     normal, hit.t, hit_p, sdir, occ,
                                     ambient))
