"""The threaded-BVH walk: closest hit and any hit (kernel K7).

Port of ``bvh_intersect``, ``bvh_occluded`` and ``_leaf_prim_t``
(ipu_ray_lib_tpu/ops/traversal.py:56-197). The flattened BVH is threaded
with miss links at build time, so each ray walks it without a stack:

    next = box_hit && inner ? cur + 1 : miss[cur]

until it runs off the end (``cur == N``). Per step: the slab test of the
node's box ``[lo, lo + ext]`` (the f16 extent widened to f32 and added
in f32) against ``[t_min, t1]``, t1 the ray's best t (closest hit) or
its t_max (any hit); at a leaf, the test of its one primitive (the
watertight triangle with ``t_far = inf``, the sphere with ``t_min``, or
the disc; ops/intersect.py), accepted when ``t_min < t < t1`` strictly,
in visit order. The any-hit walk stops a ray at its first accepted
primitive. Rays with ``t_max = -1`` (dead lanes) miss the root and
return t_max, geometry and primitive -1 (``INVALID_GEOM_ID``).

Two implementations with one contract:

* the CUDA kernel (``ops/cuda/bvh.cu``), one thread per ray, on CUDA
  tensors;
* :func:`bvh_walk_ref`, plain torch: the JAX ``while_loop`` with one node
  step per iteration over every ray still walking, on CPU tensors and to
  check the kernel on the card.

The nodes are the scene's ``bvh_nodes`` (scene/build.py
``pack_bvh_nodes``): [N, 8] int32 rows of lo.xyz (f32 bits), the f16
extents (x | y << 16, then z), meta (a leaf's primitive id), geom (a
leaf's geometry id, INVALID_GEOM_ID for an inner node) and the miss
link. ``zero_origin`` marks camera rays from (0, 0, 0), whose origin XLA
folds away: the disc test's hit point then fuses into its difference.
"""

from __future__ import annotations

import torch

from ..bvh.builder import INVALID_GEOM_ID
from .ids import GEOM_MESH, GEOM_SPHERE
from .intersect import (INF, intersect_box_slab, intersect_disc,
                        intersect_sphere, intersect_triangle_watertight,
                        make_ray_shear)

# CUDA kernel launches since the last reset.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def unpack_nodes(nodes: torch.Tensor):
    """(lo [N, 3] f32, hi [N, 3] f32, meta, geom, miss [N] int64) of the
    packed nodes; hi = lo + the f16 extent widened to f32."""
    lo = nodes[:, 0:3].contiguous().view(torch.float32)
    ext = nodes[:, 3:5].contiguous().view(torch.float16)[:, 0:3]
    return (lo, lo + ext.to(torch.float32), nodes[:, 5].long(),
            nodes[:, 6].long(), nodes[:, 7].long())


def leaf_t(scene, shear, origin, direction, t_min, gid, pid,
           zero_origin: bool = False):
    """t of each ray against the leaf primitive (gid, pid) [R] (0 on a
    miss): the test of its geometry type only."""
    n_g = scene.geom_type.shape[0]
    g = torch.clamp(gid, 0, n_g - 1)
    gtype = scene.geom_type[g]
    gindex = scene.geom_index[g].long()
    t = torch.zeros_like(t_min)
    m = gtype == GEOM_MESH
    if bool(m.any()):
        mi = torch.clamp(gindex[m], 0, scene.mesh_first_tri.shape[0] - 1)
        tri = torch.clamp(scene.mesh_first_tri[mi].long() + pid[m], 0,
                          scene.tri_v.shape[0] - 1)
        v = scene.tri_v[tri].long()
        sm = shear._make(f[m] for f in shear)
        t[m] = intersect_triangle_watertight(
            sm, scene.verts[v[:, 0]], scene.verts[v[:, 1]],
            scene.verts[v[:, 2]], INF).t
    s = gtype == GEOM_SPHERE
    if bool(s.any()):
        sp = scene.spheres[torch.clamp(gindex[s], 0,
                                       scene.spheres.shape[0] - 1)]
        t[s] = intersect_sphere(origin[s], direction[s], t_min[s], sp[:, :3],
                                sp[:, 3])
    d = ~(m | s)
    if bool(d.any()):
        dc = scene.discs[torch.clamp(gindex[d], 0, scene.discs.shape[0] - 1)]
        t[d] = intersect_disc(origin[d], direction[d], dc[:, 0:3],
                              dc[:, 3:6], dc[:, 6] * dc[:, 6], zero_origin)
    return t


def bvh_walk_ref(scene, origin, direction, t_min, t_max, any_hit: bool,
                 zero_origin: bool = False, stats: dict | None = None):
    """Plain version of K7: (t [R] f32, geom [R] i32, prim [R] i32), t =
    t_max where nothing is hit; with ``any_hit`` (occluded [R] bool, None,
    None). ``stats`` (a dict) gains ``node_visits`` and ``leaf_tests``:
    the steps the rays took and the primitive tests among them."""
    lo_all, hi_all, meta, geom, miss = unpack_nodes(scene.bvh_nodes)
    n = lo_all.shape[0]
    dev = direction.device
    inv_dir = 1.0 / direction
    shear = make_ray_shear(origin, direction)
    R = direction.shape[0]
    cur = torch.zeros(R, dtype=torch.int64, device=dev)
    best_t = t_max.clone()
    best_g = torch.full((R,), INVALID_GEOM_ID, dtype=torch.int64, device=dev)
    best_p = torch.full((R,), -1, dtype=torch.int64, device=dev)
    occ = torch.zeros(R, dtype=torch.bool, device=dev)
    lanes = torch.arange(R, device=dev)
    visits = leaf_tests = 0
    while lanes.numel():
        c = cur[lanes]
        o, d, tmin = origin[lanes], direction[lanes], t_min[lanes]
        t1 = t_max[lanes] if any_hit else best_t[lanes]
        box_hit, _, _ = intersect_box_slab(o, inv_dir[lanes], lo_all[c],
                                           hi_all[c], tmin, t1)
        gid = geom[c]
        is_leaf = gid != INVALID_GEOM_ID
        test = box_hit & is_leaf
        visits += lanes.numel()
        accept = torch.zeros_like(test)
        if bool(test.any()):
            tl = lanes[test]
            leaf_tests += tl.numel()
            tp = leaf_t(scene, shear._make(f[tl] for f in shear), o[test],
                        d[test], tmin[test], gid[test], meta[c][test],
                        zero_origin)
            ok = (tp > tmin[test]) & (tp < t1[test])
            accept[test] = ok
            if not any_hit:
                w = tl[ok]
                best_t[w] = tp[ok]
                best_g[w] = gid[test][ok]
                best_p[w] = meta[c][test][ok]
        nxt = torch.where(box_hit & ~is_leaf, c + 1, miss[c])
        if any_hit:
            occ[lanes[accept]] = True
            nxt = torch.where(accept, n, nxt)
        cur[lanes] = nxt
        lanes = lanes[nxt < n]
    if stats is not None:
        stats["node_visits"] = stats.get("node_visits", 0) + visits
        stats["leaf_tests"] = stats.get("leaf_tests", 0) + leaf_tests
    if any_hit:
        return occ, None, None
    return best_t, best_g.to(torch.int32), best_p.to(torch.int32)


def bvh_walk_raw(scene, origin, direction, t_min, t_max, any_hit: bool,
                 zero_origin: bool = False, out=None):
    """K7 on the card, its outputs as the kernel writes them: (t [R] f32,
    geom [R] i32, prim [R] i32), into ``out`` (those three tensors) or
    fresh ones; with ``any_hit`` geom is 1 where occluded, 0 elsewhere,
    and t and prim are unwritten. Counts its launches."""
    global launches
    from .cuda.build import launch_bvh

    R = direction.shape[0]
    dev = direction.device
    if out is None:
        out = (torch.empty(R, dtype=torch.float32, device=dev),
               torch.empty(R, dtype=torch.int32, device=dev),
               torch.empty(R, dtype=torch.int32, device=dev))
    out_t, out_g, out_p = out
    if R:
        launch_bvh(scene, origin.contiguous(), direction.contiguous(),
                   t_min.contiguous(), t_max.contiguous(), out_t, out_g,
                   out_p, any_hit=any_hit, zero_origin=zero_origin)
        launches += 1
    return out_t, out_g, out_p


def bvh_walk_cuda(scene, origin, direction, t_min, t_max, any_hit: bool,
                  zero_origin: bool = False):
    """K7 on the card; counts its launches. Same outputs as
    :func:`bvh_walk_ref`."""
    out_t, out_g, out_p = bvh_walk_raw(scene, origin, direction, t_min,
                                       t_max, any_hit, zero_origin)
    if any_hit:
        return out_g != 0, None, None
    return out_t, out_g, out_p


def bvh_walk(scene, origin, direction, t_min, t_max, any_hit: bool,
             zero_origin: bool = False):
    """K7 on a CUDA scene, the plain version on a CPU scene."""
    if scene.bvh_nodes is None:
        raise ValueError("this scene carries no threaded BVH (build it with "
                         "intersector='bvh' or 'dense')")
    dev = scene.device.type
    if dev == "cuda":
        return bvh_walk_cuda(scene, origin, direction, t_min, t_max,
                             any_hit, zero_origin)
    if dev == "cpu":
        return bvh_walk_ref(scene, origin, direction, t_min, t_max, any_hit,
                            zero_origin)
    raise ValueError(f"unsupported device {scene.device}")
