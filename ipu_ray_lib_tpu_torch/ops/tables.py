"""Blocked triangle tables for the path-trace megakernel (host, numpy).

Port of ``ipu_ray_lib_tpu/ops/pallas/tables.py`` ``build_blocked_tables``:
the same triangle order, the same f64 precompute rounded to f32 once, the
same layouts — so the tables equal the JAX package's bit for bit
(tests/test_torch_tables.py, tests/test_torch_hbm.py). The TPU-only
layouts (pn8/pay8/payt/baabb8/baabb16) are not built: ``p`` and ``nrm``
hold the same values at any scene size.

Triangles are ordered by the depth-first leaf order of a binned-SAH BVH
(Morton order as the fallback) and packed into blocks of ``TB`` rows with
per-block AABBs; the block count pads to a multiple of ``SB``.

Layouts (f32 unless noted):
  p      [nb*TB, 16]  per-tri row: [n.p0, g1.p0, g2.p0, nx,ny,nz,
                      g1x,g1y,g1z, g2x,g2y,g2z, WT*S, WT*G, |n.p0|, 0]
                      (plane, barycentric gradients, watertight eps terms)
  nrm    [8, nb*3*TB] block b columns = [N0^T | dN1^T | dN2^T]; spare rows
                      of segment 0: albedo (3..5), mat_id hi/lo (6, 7);
                      of segment 1: type+4*emissive (3), ior (4),
                      emission (5..7)
  baabb  [nb, 8]      block AABB lo.xyz, hi.xyz, pad 2 (padding blocks
                      hold inverted boxes lo=+inf, hi=-inf)
  baabb32 [nb*4, 8]   32-row sub-block AABBs
  saabb  [ns, 8]      super AABBs (ns = nb / SB supers of SB blocks)
  sgaabb [ceil(ns/SB), 8]  super-group AABBs (groups of SB supers; the
                      tail group pads with inverted boxes)
  tri_geom/tri_prim [nb*TB] i32, padding -> -1
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.constants import WATERTIGHT_EPS_SCALE

TB = 128   # triangles per block
SB = 8     # blocks per super, supers per super-group
SUBB = 32  # rows per sub-block AABB

# Above this many padded triangle rows the JAX package moves the payload
# into its bf16 ``pay8`` table, on every backend; here the payload values
# (the ``nrm`` table) are rounded to bf16 and kept in f32, the same values:
HBM_SPLIT_MIN_TRIS = 4_000_000


class BlockedTables(NamedTuple):
    p: np.ndarray         # [nb*TB, 16] f32
    nrm: np.ndarray       # [8, nb*3*TB] f32
    baabb: np.ndarray     # [nb, 8] f32
    baabb32: np.ndarray   # [nb*TB/SUBB, 8] f32
    saabb: np.ndarray     # [ns, 8] f32
    sgaabb: np.ndarray    # [ceil(ns/SB), 8] f32
    tri_geom: np.ndarray  # [nb*TB] i32
    tri_prim: np.ndarray  # [nb*TB] i32


def bf16_round(a: np.ndarray) -> np.ndarray:
    """f32 values rounded to the nearest bf16 (ties to even), as f32."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    return t.to(torch.bfloat16).to(torch.float32).numpy()


def _morton3(x: np.ndarray) -> np.ndarray:
    """Interleave 10-bit quantised coords into 30-bit Morton codes."""

    def spread(v):
        v = v.astype(np.uint64)
        v = (v | (v << 16)) & np.uint64(0x030000FF)
        v = (v | (v << 8)) & np.uint64(0x0300F00F)
        v = (v | (v << 4)) & np.uint64(0x030C30C3)
        v = (v | (v << 2)) & np.uint64(0x09249249)
        return v

    return spread(x[:, 0]) | (spread(x[:, 1]) << np.uint64(1)) | (
        spread(x[:, 2]) << np.uint64(2)
    )


def _triangle_order(tri_v, verts, T, tri_order):
    """Row order of the triangles: the caller's DFS leaf order when it is a
    valid permutation, else a triangle-only SAH build's leaf order, else
    Morton order by centroid."""
    if tri_order is not None and T > TB:
        cand = np.asarray(tri_order, np.int64).ravel()
        if (len(cand) == T and cand.min() >= 0 and cand.max() < T
                and np.bincount(cand, minlength=T).all()):
            return cand
    if T > TB:
        try:
            from ..bvh.builder import INVALID_GEOM_ID, build_bvh

            vf = np.asarray(verts)
            if vf.dtype == np.float32:
                a0, a1, a2 = vf[tri_v[:, 0]], vf[tri_v[:, 1]], vf[tri_v[:, 2]]
                tlo = np.minimum(np.minimum(a0, a1), a2)
                thi = np.maximum(np.maximum(a0, a1), a2)
            else:
                v64 = vf.astype(np.float64)
                a0, a1, a2 = v64[tri_v[:, 0]], v64[tri_v[:, 1]], v64[tri_v[:, 2]]
                tlo = np.minimum(np.minimum(a0, a1), a2).astype(np.float32)
                thi = np.maximum(np.maximum(a0, a1), a2).astype(np.float32)
            t_bvh = build_bvh(tlo, thi, np.zeros(T, np.int64),
                              np.arange(T, dtype=np.int64))
            order = t_bvh.meta[t_bvh.geom != INVALID_GEOM_ID].astype(np.int64)
            if len(order) == T:
                return order
        except ValueError:  # extents beyond fp16: Morton order instead
            pass
    v64 = np.asarray(verts, np.float64)
    cent = (v64[tri_v[:, 0]] + v64[tri_v[:, 1]] + v64[tri_v[:, 2]]) / 3.0
    lo = cent.min(axis=0)
    span = np.maximum(cent.max(axis=0) - lo, 1e-20)
    q = np.clip(((cent - lo) / span) * 1023.0, 0, 1023).astype(np.uint32)
    return np.argsort(_morton3(q), kind="stable")


def build_blocked_tables(tri_v: np.ndarray, verts: np.ndarray,
                         tri_geom: np.ndarray, tri_prim: np.ndarray,
                         vert_normals: np.ndarray | None = None,
                         tri_has_normals: np.ndarray | None = None,
                         tri_mat: np.ndarray | None = None,
                         mat_albedo: np.ndarray | None = None,
                         mat_ior: np.ndarray | None = None,
                         mat_type: np.ndarray | None = None,
                         mat_emission: np.ndarray | None = None,
                         mat_emissive: np.ndarray | None = None,
                         tri_order: np.ndarray | None = None,
                         payload_split: bool | None = None) -> BlockedTables:
    """The blocked tables of a triangle list (see the module docstring).

    ``payload_split``: round the ``nrm`` values to bf16 (kept in f32), as
    the JAX package's ``pay8`` table stores them; None turns it on above
    ``HBM_SPLIT_MIN_TRIS`` padded rows."""
    T = len(tri_v)
    if T == 0:
        tri_v = np.zeros((1, 3), np.int64)
        verts = np.zeros((1, 3), np.float32) if len(verts) == 0 else verts
        tri_geom = np.full(1, -1, np.int32)
        tri_prim = np.full(1, -1, np.int32)
        vert_normals = None
        T = 1
    if tri_has_normals is None or vert_normals is None:
        tri_has_normals = np.zeros(T, bool)
    else:
        tri_has_normals = np.asarray(tri_has_normals, bool)[:T]

    tri_geom = np.asarray(tri_geom, np.int32)
    tri_prim = np.asarray(tri_prim, np.int32)
    if tri_mat is None:
        tri_mat = np.zeros(T, np.int32)
        mat_albedo = np.zeros((1, 3), np.float32)
        mat_ior = np.full(1, 1.52, np.float32)
        mat_type = np.zeros(1, np.int32)
    if mat_emission is None:
        mat_emission = np.zeros((len(mat_albedo), 3), np.float32)
    if mat_emissive is None:
        mat_emissive = np.zeros(len(mat_albedo), np.int32)
    if len(mat_albedo) > 65536:
        raise ValueError(
            f"blocked tables support at most 65536 materials; got "
            f"{len(mat_albedo)}")
    tri_mat = np.asarray(tri_mat, np.int32)[:T]
    if len(tri_mat) < T:
        tri_mat = np.pad(tri_mat, (0, T - len(tri_mat)))

    order = _triangle_order(tri_v, verts, T, tri_order)
    tri_v_o = np.asarray(tri_v, np.int64)[order]
    tri_has_normals = tri_has_normals[order]
    tri_geom = tri_geom[order]
    tri_prim = tri_prim[order]
    tri_mat = tri_mat[order]

    nb = max(1, -(-T // TB))
    nb = -(-nb // SB) * SB
    Tp = nb * TB

    verts64 = np.asarray(verts, np.float64)
    p0, p1, p2 = (verts64[tri_v_o[:, i]] for i in range(3))
    if vert_normals is not None:
        vn64 = np.asarray(vert_normals, np.float64)
        vn0, vn1, vn2 = (vn64[tri_v_o[:, i]] for i in range(3))
    else:
        vn0 = vn1 = vn2 = np.zeros((T, 3), np.float64)

    # Plane + barycentric-gradient precompute in f64, rounded once:
    e1 = p1 - p0
    e2 = p2 - p0
    n = np.cross(e1, e2)
    nlen = np.linalg.norm(n, axis=-1, keepdims=True)
    degenerate = nlen[:, 0] < 1e-20
    n = np.where(degenerate[:, None], 0.0, n / np.maximum(nlen, 1e-30))
    d00 = np.sum(e1 * e1, axis=-1)
    d01 = np.sum(e1 * e2, axis=-1)
    d11 = np.sum(e2 * e2, axis=-1)
    denom = d00 * d11 - d01 * d01
    safe = np.where(np.abs(denom) < 1e-30, 1.0, denom)
    g1 = np.where(degenerate[:, None], 0.0,
                  (e1 * d11[:, None] - e2 * d01[:, None]) / safe[:, None])
    g2 = np.where(degenerate[:, None], 0.0,
                  (e2 * d00[:, None] - e1 * d01[:, None]) / safe[:, None])

    # Shading-normal basis: interpolated where vertex normals exist,
    # geometric (unit plane normal) otherwise:
    hasn = tri_has_normals[:, None]
    N0 = np.where(hasn, vn0, n)
    dN1 = np.where(hasn, vn1 - vn0, 0.0)
    dN2 = np.where(hasn, vn2 - vn0, 0.0)

    m_safe = np.clip(tri_mat, 0, len(mat_albedo) - 1)
    mat_alb = np.asarray(mat_albedo, np.float64)[m_safe]
    mat_tp = (np.asarray(mat_type, np.int64)[m_safe]
              + 4 * np.asarray(mat_emissive, np.int64)[m_safe])
    mat_iors = np.asarray(mat_ior, np.float64)[m_safe]
    mat_em = np.asarray(mat_emission, np.float64)[m_safe]

    def padT(a):
        out = np.zeros((Tp,) + a.shape[1:], np.float64)
        out[:T] = a
        return out

    def blocked(a):  # [Tp, c] -> [c, nb, TB]
        return np.moveaxis(padT(a).reshape(nb, TB, -1), 2, 0)

    nrm = np.zeros((8, nb, 3, TB), np.float32)
    nrm[0:3, :, 0] = blocked(N0)
    nrm[0:3, :, 1] = blocked(dN1)
    nrm[0:3, :, 2] = blocked(dN2)
    nrm[3:6, :, 0] = blocked(mat_alb)
    nrm[6, :, 0] = padT(m_safe // 256).reshape(nb, TB)
    nrm[7, :, 0] = padT(m_safe % 256).reshape(nb, TB)
    nrm[3, :, 1] = padT(mat_tp).reshape(nb, TB)
    nrm[4, :, 1] = padT(mat_iors).reshape(nb, TB)
    nrm[5:8, :, 1] = blocked(mat_em)
    nrm = nrm.reshape(8, nb * 3 * TB)
    if payload_split is None:
        payload_split = Tp > HBM_SPLIT_MIN_TRIS
    if payload_split:
        nrm = bf16_round(nrm)

    n_p, g1_p, g2_p, p0_p = padT(n), padT(g1), padT(g2), padT(p0)
    p = np.zeros((Tp, 16), np.float32)
    p[:, 0] = np.sum(n_p * p0_p, axis=-1)
    p[:, 1] = np.sum(g1_p * p0_p, axis=-1)
    p[:, 2] = np.sum(g2_p * p0_p, axis=-1)
    p[:, 3:6] = n_p
    p[:, 6:9] = g1_p
    p[:, 9:12] = g2_p
    # Watertight acceptance-widening terms (utils/constants.py), pre-scaled
    # so the kernel forms eps = p12 + p13 * (|o|_inf + E_t) in two ops.
    # Padding rows stay 0:
    wt = WATERTIGHT_EPS_SCALE
    p[:, 12] = wt * (np.abs(p[:, 1]) + np.abs(p[:, 2]))
    p[:, 13] = wt * (np.abs(g1_p).sum(axis=-1) + np.abs(g2_p).sum(axis=-1))
    p[:, 14] = np.abs(p[:, 0])

    tlo_p = np.full((Tp, 3), np.inf, np.float32)
    thi_p = np.full((Tp, 3), -np.inf, np.float32)
    tlo_p[:T] = np.minimum(np.minimum(p0, p1), p2).astype(np.float32)
    thi_p[:T] = np.maximum(np.maximum(p0, p1), p2).astype(np.float32)

    def group_aabb(lo, hi, g):
        k = lo.shape[0] // g
        out = np.zeros((k, 8), np.float32)
        out[:, 0:3] = lo.reshape(k, g, 3).min(axis=1)
        out[:, 3:6] = hi.reshape(k, g, 3).max(axis=1)
        return out

    saabb = group_aabb(tlo_p, thi_p, SB * TB)
    # Super-group AABBs; the tail group's missing supers are inverted
    # boxes, so its union covers its real supers only:
    sg_pad = (-saabb.shape[0]) % SB
    sg_lo = np.concatenate(
        [saabb[:, 0:3], np.full((sg_pad, 3), np.inf, np.float32)])
    sg_hi = np.concatenate(
        [saabb[:, 3:6], np.full((sg_pad, 3), -np.inf, np.float32)])

    return BlockedTables(
        p=p, nrm=nrm, baabb=group_aabb(tlo_p, thi_p, TB),
        baabb32=group_aabb(tlo_p, thi_p, SUBB), saabb=saabb,
        sgaabb=group_aabb(sg_lo, sg_hi, SB),
        tri_geom=np.pad(tri_geom, (0, Tp - T), constant_values=-1),
        tri_prim=np.pad(tri_prim, (0, Tp - T), constant_values=-1))
