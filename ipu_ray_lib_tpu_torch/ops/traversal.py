"""Closest-hit and any-hit dispatch of the glue route, for every method.

Port of ``ipu_ray_lib_tpu/ops/traversal.py``:

* ``"pallas"`` and ``"pallas-hbm"`` (:46, :259-371): the triangle kernel
  (K5 in VMEM mode, ops/intersect_kernel.py; K6 in HBM mode,
  ops/intersect_hbm.py), then every sphere and every disc (ops/dense.py),
  each overriding the hit when strictly nearer; the ids, and with them
  the kernel's shading normal or the analytic sphere and disc normals.
  ``pallas_path_intersect`` also returns the material: from the kernel's
  payload rows for triangles, from the material tables for spheres and
  discs.
* ``"bvh"`` (:102-197): the threaded-BVH walk, K7 (ops/bvh.py); its
  any-hit walk stops a ray at its first hit.
* ``"dense"`` (:200-238): every triangle through K8 (ops/dense.py), then
  the spheres and discs as above; its any hit is its closest hit with
  ``t < t_max``.

For ``"bvh"`` and ``"dense"`` the shading normal is recomputed after the
fact (:func:`hit_normal`, :430-497). The shadow trace (render/shadow.py),
the XLA-loop path tracer (render/streaming.py) and the per-sample
wavefront (render/path.py) call these.

The arithmetic after the kernels is the JAX functions' as XLA compiles
them under ``jit`` on the CPU (ops/vec3.py ``fma``, ``sum3``, ``unit``).
``origin`` None means camera rays from (0, 0, 0), whose zero origin XLA
drops: a hit point feeding a difference then fuses into it, in
``hit_normal`` and in the BVH walk's disc test (XLA sinks the constant
into its loop), but not in the dense test, whose dots of the zeros XLA
computes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..bvh.builder import INVALID_GEOM_ID
from .bvh import bvh_walk
from .dense import dense_closest_tri, dense_discs, dense_spheres
from .ids import GEOM_MESH, GEOM_SPHERE, INTERSECTORS
from .intersect import intersect_triangle_watertight, make_ray_shear
from .intersect_hbm import pallas_intersect_hbm
from .intersect_kernel import pallas_intersect
from .vec3 import const3, fma, unit

INVALID_PRIM_ID = -1


class Hit(NamedTuple):
    t: torch.Tensor        # [R] f32 hit distance (t_max where nothing is hit)
    geom_id: torch.Tensor  # [R] i32 (INVALID_GEOM_ID where nothing is hit)
    prim_id: torch.Tensor  # [R] i32 (-1 where nothing is hit)

    @property
    def found(self) -> torch.Tensor:
        return self.geom_id != INVALID_GEOM_ID


def _check_method(method: str) -> None:
    if method not in INTERSECTORS:
        raise ValueError(f"unknown intersector {method!r}")


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
                knormal=None, ids=None):
    """Ids (and with ``knormal``, the kernel's unit shading normals
    [R, 3], the normals) of the hits: ``tri`` the triangle row or -1,
    ``si_b``/``di_b`` the sphere/disc index where one won, else -1; hit_t
    the hit distance; ``ids`` the geometry and primitive id of each
    triangle row (default the blocked tables'). Returns (geom [R] i32,
    prim [R] i32, found [R], normal [R, 3] or None); normal (0, 0, 1)
    where nothing is hit."""
    sb, db = si_b >= 0, di_b >= 0
    n_sph, n_dsc = scene.n_spheres, scene.n_discs
    tri_geom, tri_prim = ids or (scene.tri_geom, scene.tri_prim)
    tri_safe = torch.clamp(tri, 0, tri_geom.shape[0] - 1).long()
    geom = torch.where(tri >= 0, tri_geom[tri_safe], INVALID_GEOM_ID)
    prim = torch.where(tri >= 0, tri_prim[tri_safe], INVALID_PRIM_ID)
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
    default = const3(0.0, 0.0, 1.0, direction.device)
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

    default = const3(0.0, 0.0, 1.0, direction.device)
    normal = torch.where(found[:, None], normal, default)
    return dict(t=torch.where(found, hit_t, t_max), found=found,
                normal=normal, albedo=albedo, mat_id=mid, mat_type=mtype,
                ior=ior, emission=emission, emissive=emissive & found)


def bvh_intersect(scene, origin, direction, t_min, t_max) -> Hit:
    """Closest hit through the threaded BVH (K7)."""
    o = torch.zeros_like(direction) if origin is None else origin
    t, g, p = bvh_walk(scene, o, direction, t_min, t_max, False,
                       zero_origin=origin is None)
    return Hit(t=t, geom_id=g, prim_id=p)


def bvh_occluded(scene, origin, direction, t_min, t_max) -> torch.Tensor:
    """Any hit strictly inside (t_min, t_max) through the threaded BVH
    (K7's any-hit walk)."""
    o = torch.zeros_like(direction) if origin is None else origin
    return bvh_walk(scene, o, direction, t_min, t_max, True,
                    zero_origin=origin is None)[0]


def dense_intersect(scene, origin, direction, t_min, t_max) -> Hit:
    """Closest hit through the dense tables (K8), then every sphere and
    every disc."""
    o = torch.zeros_like(direction) if origin is None else origin
    best_t, tri = dense_closest_tri(scene, o, direction, t_min, t_max)
    sb, st, si = dense_spheres(scene, o, direction, t_min, best_t)
    best_t = torch.where(sb, st, best_t)
    db, dt, di = dense_discs(scene, o, direction, t_min, best_t)
    best_t = torch.where(db, dt, best_t)
    geom, prim, found, _ = resolve_hit(
        scene, origin, direction, best_t, tri, torch.where(sb, si, -1),
        torch.where(db, di, -1), ids=(scene.dense_geom, scene.dense_prim))
    return Hit(t=torch.where(found, best_t, t_max), geom_id=geom,
               prim_id=prim)


def _cross(a, b):
    """``jnp.cross`` of [R, 3] rows as XLA contracts it."""
    c = [(1, 2), (2, 0), (0, 1)]
    return torch.stack([fma(a[:, i], b[:, j], -(a[:, j] * b[:, i]))
                        for i, j in c], -1)


def hit_normal(scene, origin, direction, hit: Hit) -> torch.Tensor:
    """The shading normal [R, 3] at each hit, after the fact: a mesh's
    geometric normal, or its vertex normals weighted by the watertight
    test's barycentrics where it has them; a sphere's from its centre; a
    disc's own; (0, 0, 1) where nothing is hit."""
    g = torch.clamp(hit.geom_id, 0, scene.geom_type.shape[0] - 1).long()
    gtype = scene.geom_type[g]
    gindex = scene.geom_index[g].long()
    mi = torch.clamp(gindex, 0, scene.mesh_first_tri.shape[0] - 1)
    tri = torch.clamp(scene.mesh_first_tri[mi].long() + hit.prim_id, 0,
                      scene.tri_v.shape[0] - 1)
    v = scene.tri_v[tri].long()
    p0, p1, p2 = (scene.verts[v[:, k]] for k in range(3))
    geo_n = unit(_cross(p1 - p0, p2 - p0))
    o = torch.zeros_like(direction) if origin is None else origin
    th = intersect_triangle_watertight(make_ray_shear(o, direction), p0, p1,
                                       p2)
    nv = [scene.normals[v[:, k]] for k in range(3)]
    interp = unit(fma(nv[2], th.b2[:, None],
                      fma(nv[0], th.b0[:, None], nv[1] * th.b1[:, None])))
    has_n = scene.mesh_has_normals[mi][:, None] != 0
    mesh_n = torch.where(has_n, interp, geo_n)
    sp = scene.spheres[torch.clamp(gindex, 0, scene.spheres.shape[0] - 1)]
    sphere_n = unit(from_hit(origin, direction, hit.t, sp[:, :3], -1.0))
    disc_n = scene.discs[torch.clamp(gindex, 0, scene.discs.shape[0] - 1)][:, 0:3]
    n = torch.where((gtype == GEOM_MESH)[:, None], mesh_n,
                    torch.where((gtype == GEOM_SPHERE)[:, None], sphere_n,
                                disc_n))
    default = const3(0.0, 0.0, 1.0, direction.device)
    return torch.where(hit.found[:, None], n, default)


def scene_intersect_with_normal(scene, origin, direction, t_min, t_max,
                                method: str = "pallas"):
    """(Hit, normal [R, 3]) through ``method``: the kernel's normals for
    the pallas methods, :func:`hit_normal` for ``"bvh"`` and ``"dense"``."""
    _check_method(method)
    if method in ("bvh", "dense"):
        hit = scene_intersect(scene, origin, direction, t_min, t_max, method)
        return hit, hit_normal(scene, origin, direction, hit)
    return pallas_scene_intersect(scene, origin, direction, t_min, t_max,
                                  with_normal=True,
                                  hbm=method == "pallas-hbm")


def scene_intersect(scene, origin, direction, t_min, t_max,
                    method: str = "pallas") -> Hit:
    """Closest hit through ``method``."""
    _check_method(method)
    if method == "bvh":
        return bvh_intersect(scene, origin, direction, t_min, t_max)
    if method == "dense":
        return dense_intersect(scene, origin, direction, t_min, t_max)
    return pallas_scene_intersect(scene, origin, direction, t_min, t_max,
                                  hbm=method == "pallas-hbm")


def scene_occluded(scene, origin, direction, t_min, t_max,
                   method: str = "pallas") -> torch.Tensor:
    """Any hit strictly before t_max through ``method``: K7's any-hit walk
    for ``"bvh"``, a closest hit otherwise (as in the JAX package)."""
    if method == "bvh":
        return bvh_occluded(scene, origin, direction, t_min, t_max)
    hit = scene_intersect(scene, origin, direction, t_min, t_max, method)
    return hit.found & (hit.t < t_max)
