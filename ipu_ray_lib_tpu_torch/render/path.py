"""The per-sample wavefront path tracer (one sample per ray).

Port of ``ipu_ray_lib_tpu/render/path.py`` (``path_trace_sample``, :70):
all rays advance together, one bounce per step of a host loop with
masked lanes. Per bounce: the self-intersection offset, the closest hit
through the scene's triangle kernel (K5 in VMEM mode, K6 in HBM mode; K7
for ``"bvh"``, K8 for ``"dense"``; ops/traversal.py
``scene_intersect_with_normal``) and the analytic spheres and discs, the emission, the BxDF sampling of every material
type with a masked select (ops/bxdf_loop.py), and Russian roulette
strictly after ``roulette_start_depth``. Escaped rays keep their
direction and throughput, so that an environment light is applied
afterwards in one batch (render/renderer.py).

Its random numbers are the JAX function's: ``uniform(fold_in(key, i),
(4, R))`` per bounce i from the jax-free threefry (utils/threefry.py).
The arithmetic is XLA's under ``jit`` on the CPU, as in the XLA-loop
integrator (render/streaming.py): the hit point ``o + d*t`` is one
multiply-add. ``cos``, ``sin`` (diffuse sampling) are torch's and differ
from XLA's in the last place for some arguments.

The loop ends after ``max_path_length`` bounces or when no lane is
active; reading ``any(active)`` is one host sync per bounce (counted in
``stats``).

``sort_rays`` re-bins the wavefront by a coherence key (direction
octant, then a 12-bit Morton cell of the origin within the scene's root
box; dead rays last) with a stable argsort, as ``jnp.argsort`` is: k > 0
on bounces with i % k == 0, -1 once after the first bounce. Results are
scattered back to the caller's lane order.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.bxdf_loop import (dielectric, evaluate_roulette, offset_ray_origin,
                             reflect, sample_diffuse)
from ..ops.traversal import scene_intersect_with_normal
from ..ops.vec3 import fma
from ..utils import threefry

MAT_DIFFUSE = 0
MAT_SPECULAR = 1
MAT_REFRACTIVE = 2
_DEAD_KEY = 0x7FFFFFFF


def _sort_key(scene, o: torch.Tensor, d: torch.Tensor,
              active: torch.Tensor) -> torch.Tensor:
    """Coherence key [R] int32: direction octant (3 bits), then the 12-bit
    Morton cell of the origin on a 16^3 grid over the root box; dead rays
    get the largest key."""
    if scene.root_box is None:
        raise ValueError("sort_rays needs the scene's root box (build the "
                         "scene with build_scene)")
    root_lo = scene.root_box[0]
    root_ext = torch.clamp_min(scene.root_box[1], 1e-6)
    q = torch.clamp((o - root_lo) / root_ext * 16.0, 0.0, 15.0).to(torch.int32)

    def spread4(v):
        v = (v | (v << 8)) & 0xF00F
        v = (v | (v << 4)) & 0xC3C3
        return (v | (v << 2)) & 0x9249

    morton = spread4(q[:, 0]) | (spread4(q[:, 1]) << 1) | (spread4(q[:, 2]) << 2)
    octant = ((d[:, 0] > 0).to(torch.int32) + 2 * (d[:, 1] > 0).to(torch.int32)
              + 4 * (d[:, 2] > 0).to(torch.int32))
    return torch.where(active, octant * 4096 + morton, _DEAD_KEY)


class SampleResult(NamedTuple):
    rgb: torch.Tensor             # [R, 3] radiance of this sample (no env term)
    esc_dir: torch.Tensor         # [R, 3] direction at escape (zeros if none)
    esc_throughput: torch.Tensor  # [R, 3] throughput at escape
    escaped: torch.Tensor         # [R] bool
    error: torch.Tensor           # [R] bool (unknown material type)


def path_trace_sample(scene, origins: torch.Tensor, dirs: torch.Tensor,
                      key: torch.Tensor, max_path_length: int,
                      roulette_start_depth: int, intersector: str = "pallas",
                      sort_rays: int = 0,
                      stats: dict | None = None) -> SampleResult:
    """One sample of every ray (origins, dirs [R, 3] f32 on the scene's
    device) under the threefry ``key``, through ``intersector``
    (one of ``scene/build.py:INTERSECTORS``). ``stats`` (a dict) gains
    ``bounces`` and ``syncs``: the bounces run and the host reads of
    ``any(active)``."""
    R = origins.shape[0]
    dev = origins.device
    f32 = torch.float32
    zero3 = torch.zeros((R, 3), dtype=f32, device=dev)
    up = zero3.clone()
    up[:, 2] = 1.0
    s = dict(
        o=origins, d=dirs, n=up,
        throughput=torch.ones((R, 3), dtype=f32, device=dev), color=zero3,
        active=torch.ones(R, dtype=torch.bool, device=dev), esc_dir=zero3,
        esc_tp=zero3, escaped=torch.zeros(R, dtype=torch.bool, device=dev),
        error=torch.zeros(R, dtype=torch.bool, device=dev),
        # The lane each ray came from (identity unless sorting):
        pix=torch.arange(R, dtype=torch.int64, device=dev))
    t_min = torch.zeros(R, dtype=f32, device=dev)
    n_mat = scene.mat_id.shape[0]
    bounces = syncs = 0

    for i in range(max_path_length):
        syncs += 1
        active = s["active"]
        if not bool(active.any()):
            break
        bounces += 1
        o = offset_ray_origin(s["o"], s["d"], s["n"])
        d = s["d"]
        # Dead lanes get t_max = -1, which no hit test can satisfy:
        t_max = torch.where(active, float("inf"), -1.0)
        hit, hit_n = scene_intersect_with_normal(scene, o, d, t_min, t_max,
                                                 intersector)
        found = hit.found

        newly = active & ~found
        esc_dir = torch.where(newly[:, None], d, s["esc_dir"])
        esc_tp = torch.where(newly[:, None], s["throughput"], s["esc_tp"])
        escaped = s["escaped"] | newly

        live = active & found
        n = torch.where(live[:, None], hit_n, s["n"])
        o = torch.where(live[:, None], fma(d, hit.t[:, None], o), o)

        mid = scene.mat_id[torch.clamp(hit.geom_id, 0, n_mat - 1).long()].long()
        albedo = scene.mat_albedo[mid]
        emissive = scene.mat_emissive[mid] != 0
        mtype = scene.mat_type[mid]
        color = s["color"] + torch.where((live & emissive)[:, None],
                                         s["throughput"]
                                         * scene.mat_emission[mid], 0.0)

        u = threefry.uniform(threefry.fold_in(key, i), (4, R), device=dev)
        d_diffuse = sample_diffuse(n, u[0], u[1])
        d_specular = reflect(d, n)
        d_dielec, refracted = dielectric(d, n, scene.mat_ior[mid], u[2])

        is_diff = mtype == MAT_DIFFUSE
        is_spec = mtype == MAT_SPECULAR
        is_refr = mtype == MAT_REFRACTIVE
        new_d = torch.where(is_diff[:, None], d_diffuse,
                            torch.where(is_spec[:, None], d_specular,
                                        d_dielec))
        scale_tp = is_diff | is_spec | (is_refr & refracted)
        tp = s["throughput"] * torch.where(scale_tp[:, None], albedo, 1.0)
        error = s["error"] | (live & ~(is_diff | is_spec | is_refr))

        d = torch.where(live[:, None], new_d, d)
        tp = torch.where(live[:, None], tp, s["throughput"])

        stop, tp_r = evaluate_roulette(u[3], tp)
        if i > roulette_start_depth:
            tp = torch.where(live[:, None], tp_r, tp)
            live = live & ~stop

        s = dict(o=o, d=d, n=n, throughput=tp, color=color, active=live,
                 esc_dir=esc_dir, esc_tp=esc_tp, escaped=escaped, error=error,
                 pix=s["pix"])
        if sort_rays and (i == 0 if sort_rays == -1 else i % sort_rays == 0):
            perm = torch.argsort(_sort_key(scene, o, d, live), stable=True)
            s = {k: v[perm] for k, v in s.items()}

    if stats is not None:
        stats["bounces"] = stats.get("bounces", 0) + bounces
        stats["syncs"] = stats.get("syncs", 0) + syncs
    out = dict(rgb=s["color"], esc_dir=s["esc_dir"],
               esc_throughput=s["esc_tp"], escaped=s["escaped"],
               error=s["error"])
    if sort_rays:
        pix = s["pix"]

        def unsort(v):
            w = torch.zeros_like(v)
            w[pix] = v
            return w

        out = {k: unsort(v) for k, v in out.items()}
    return SampleResult(**out)
