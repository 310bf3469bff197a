"""Closest-hit and any-hit dispatch of the glue route.

Port of the ``"pallas"`` and ``"pallas-hbm"`` methods of
``ipu_ray_lib_tpu/ops/traversal.py`` (:46, :259-427): the triangle kernel
(K5 in VMEM mode, ops/intersect_kernel.py; K6 in HBM mode,
ops/intersect_hbm.py), then every sphere and every disc
(ops/dense.py), each overriding the hit when strictly nearer; the ids,
and with them the kernel's shading normal or the analytic sphere and
disc normals. ``pallas_path_intersect`` also returns the material: from
the kernel's payload rows for triangles, from the material tables for
spheres and discs. The shadow trace (render/shadow.py) and the XLA-loop
path tracer (render/streaming.py) call these.

The threaded-BVH traversal (``"bvh"``) and the MXU dense triangle
intersector (``"dense"``) are not ported (ROADMAP queue 1 item 8): they
raise.

The arithmetic after the kernel is the JAX functions' as XLA compiles
them under ``jit`` on the CPU (ops/vec3.py ``fma``, ``sum3``, ``unit``).
``origin`` None means camera rays from (0, 0, 0), whose zero origin XLA
drops: a hit point feeding a difference then fuses into it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..bvh.builder import INVALID_GEOM_ID
from .dense import dense_discs, dense_spheres
from .intersect_hbm import pallas_intersect_hbm
from .intersect_kernel import pallas_intersect
from .vec3 import fma, unit

INVALID_PRIM_ID = -1
METHODS = ("pallas", "pallas-hbm")


class Hit(NamedTuple):
    t: torch.Tensor        # [R] f32 hit distance (t_max where nothing is hit)
    geom_id: torch.Tensor  # [R] i32 (INVALID_GEOM_ID where nothing is hit)
    prim_id: torch.Tensor  # [R] i32 (-1 where nothing is hit)

    @property
    def found(self) -> torch.Tensor:
        return self.geom_id != INVALID_GEOM_ID


def _check_method(method: str) -> bool:
    """True for the HBM-mode kernel; raises for the methods not ported."""
    if method in ("bvh", "dense"):
        raise NotImplementedError(
            f"intersector {method!r} is not ported (ROADMAP queue 1 item "
            "8); use 'pallas' or 'pallas-hbm'")
    if method not in METHODS:
        raise ValueError(f"unknown intersector {method!r}")
    return method == "pallas-hbm"


def _tri_intersect(scene, origin, direction, t_min, t_max, hbm: bool):
    o = torch.zeros_like(direction) if origin is None else origin
    kernel = pallas_intersect_hbm if hbm else pallas_intersect
    return kernel(scene, o, direction, t_min, t_max)


def from_hit(origin, direction, t, c, sign: float):
    """sign * (c - hit point at t) [R, 3], the hit point origin +
    direction * t (t [R]) as XLA fuses it into the difference."""
    t = t[:, None]
    if origin is None:
        return fma(-sign * direction, t, sign * c)
    return sign * (c - fma(direction, t, origin))


def resolve_hit(scene, origin, direction, hit_t, tri, si_b, di_b,
                knormal=None):
    """Ids (and with ``knormal``, the kernel's unit shading normals
    [R, 3], the normals) of the hits: ``tri`` the triangle row or -1,
    ``si_b``/``di_b`` the sphere/disc index where one won, else -1; hit_t
    the hit distance. Returns (geom [R] i32, prim [R] i32, found [R],
    normal [R, 3] or None); normal (0, 0, 1) where nothing is hit."""
    sb, db = si_b >= 0, di_b >= 0
    n_sph, n_dsc = scene.n_spheres, scene.n_discs
    tri_safe = torch.clamp(tri, 0, scene.tri_geom.shape[0] - 1).long()
    geom = torch.where(tri >= 0, scene.tri_geom[tri_safe], INVALID_GEOM_ID)
    prim = torch.where(tri >= 0, scene.tri_prim[tri_safe], INVALID_PRIM_ID)
    si_c = torch.clamp(torch.where(sb, si_b, 0), 0, n_sph - 1).long()
    geom = torch.where(sb, scene.sphere_geom[si_c], geom)
    prim = torch.where(sb, 0, prim)
    di_c = torch.clamp(torch.where(db, di_b, 0), 0, n_dsc - 1).long()
    geom = torch.where(db, scene.disc_geom[di_c], geom).to(torch.int32)
    prim = torch.where(db, 0, prim).to(torch.int32)
    found = geom != INVALID_GEOM_ID
    if knormal is None:
        return geom, prim, found, None
    sphere_n = unit(from_hit(origin, direction, hit_t, scene.ap[si_c, 1:4],
                             -1.0))
    disc_n = scene.ap[n_sph + di_c, 4:7]
    normal = torch.where(sb[:, None], sphere_n, knormal)
    normal = torch.where(db[:, None], disc_n, normal)
    default = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32,
                           device=direction.device)
    return geom, prim, found, torch.where(found[:, None], normal, default)


def pallas_scene_intersect(scene, origin, direction, t_min, t_max,
                           with_normal: bool = False, hbm: bool = False):
    """Closest hit: the triangle kernel, then the spheres and the discs.
    Returns a :class:`Hit`, with ``with_normal`` (Hit, normal [R, 3])."""
    best_t, tri, knormal, _ = _tri_intersect(scene, origin, direction,
                                             t_min, t_max, hbm)
    o = torch.zeros_like(direction) if origin is None else origin
    sb, st, si = dense_spheres(scene, o, direction, t_min, best_t)
    best_t = torch.where(sb, st, best_t)
    db, dt, di = dense_discs(scene, o, direction, t_min, best_t)
    best_t = torch.where(db, dt, best_t)
    hit_t = best_t  # t_max where nothing is hit
    geom, prim, found, normal = resolve_hit(
        scene, origin, direction, hit_t, tri, torch.where(sb, si, -1),
        torch.where(db, di, -1), knormal if with_normal else None)
    hit = Hit(t=torch.where(found, hit_t, t_max), geom_id=geom, prim_id=prim)
    return (hit, normal) if with_normal else hit


def pallas_path_intersect(scene, origin, direction, t_min, t_max,
                          hbm: bool = False) -> dict:
    """Closest hit, shading normal and material per ray, for the path
    tracer: t, found, normal [R, 3], albedo [R, 3], mat_id, mat_type,
    ior, emission [R, 3], emissive."""
    best_t, tri, knormal, payload = _tri_intersect(scene, origin, direction,
                                                   t_min, t_max, hbm)
    found = tri >= 0
    albedo = payload[0:3].t()
    # Rounded, as the JAX package rounds its one-hot selection's output:
    rnd = lambda x: torch.round(x).to(torch.int32)
    mid = rnd(payload[3]) * 256 + rnd(payload[4])
    tpacked = rnd(payload[5])
    mtype = tpacked & 3
    emissive = (tpacked >> 2) != 0
    ior = payload[6]
    emission = payload[7:10].t()
    normal = knormal

    best = torch.where(found, best_t, t_max)
    sb, st, si = dense_spheres(scene, origin, direction, t_min, best)
    db, dt, di = dense_discs(scene, origin, direction, t_min,
                             torch.where(sb, st, best))
    hit_t = torch.where(db, dt, torch.where(sb, st, best_t))
    found = found | sb | db

    si_s = torch.clamp(si, 0, scene.n_spheres - 1).long()
    di_s = torch.clamp(di, 0, scene.n_discs - 1).long()
    sn = unit(from_hit(origin, direction, hit_t, scene.ap[si_s, 1:4], -1.0))
    dn = scene.ap[scene.n_spheres + di_s, 4:7]
    normal = torch.where(sb[:, None], sn, normal)
    normal = torch.where(db[:, None], dn, normal)

    gid = torch.where(db, scene.disc_geom[di_s], scene.sphere_geom[si_s])
    mid_o = scene.mat_id[torch.clamp(gid, 0, scene.mat_id.shape[0] - 1)
                         .long()].long()
    use_o = sb | db
    mid = torch.where(use_o, mid_o.to(torch.int32), mid)
    albedo = torch.where(use_o[:, None], scene.mat_albedo[mid_o], albedo)
    mtype = torch.where(use_o, scene.mat_type[mid_o], mtype)
    ior = torch.where(use_o, scene.mat_ior[mid_o], ior)
    emission = torch.where(use_o[:, None], scene.mat_emission[mid_o], emission)
    emissive = torch.where(use_o, scene.mat_emissive[mid_o] != 0, emissive)

    default = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float32,
                           device=direction.device)
    normal = torch.where(found[:, None], normal, default)
    return dict(t=torch.where(found, hit_t, t_max), found=found,
                normal=normal, albedo=albedo, mat_id=mid, mat_type=mtype,
                ior=ior, emission=emission, emissive=emissive & found)


def scene_intersect_with_normal(scene, origin, direction, t_min, t_max,
                                method: str = "pallas"):
    """(Hit, normal [R, 3]) through ``method``."""
    return pallas_scene_intersect(scene, origin, direction, t_min, t_max,
                                  with_normal=True, hbm=_check_method(method))


def scene_intersect(scene, origin, direction, t_min, t_max,
                    method: str = "pallas") -> Hit:
    """Closest hit through ``method``."""
    return pallas_scene_intersect(scene, origin, direction, t_min, t_max,
                                  hbm=_check_method(method))


def scene_occluded(scene, origin, direction, t_min, t_max,
                   method: str = "pallas") -> torch.Tensor:
    """Any hit strictly before t_max, through ``method`` (a closest hit,
    as in the JAX package)."""
    hit = scene_intersect(scene, origin, direction, t_min, t_max, method)
    return hit.found & (hit.t < t_max)
