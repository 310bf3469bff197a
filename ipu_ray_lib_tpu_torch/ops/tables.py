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
  pbox   [nb, 8]      (the port's own, from ``p`` and ``baabb``:
                      :func:`padded_boxes`) lo.xyz, hi.xyz of the region
                      a row of the block can accept a hit in, the lanes'
                      rounding coefficient kappa, and the block's kind:
                      0 bounded, 1 unbounded, -1 empty
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


# Rounding of the row test (rows.cuh row_chain / test_rows), f32 with
# unit roundoff U: a dot of 3 contracted as XLA does it is within GAMMA3
# of the exact dot (relative to the sum of |products|); t's product with
# dn is within EPS_T of c0 - on, because 1/bf16(dn) is off by at most
# 2^-8 (+U) and the Newton step squares that (1.54e-5) before 4 roundings.
_U = 2.0 ** -24
_GAMMA3 = 3 * _U / (1 - 3 * _U)
_EPS_T = 1.6e-5
_EPS_MAX = float(np.float32(1e-3))  # the clamp of an accepted row's eps
# Rows whose lane coefficient exceeds this are unbounded: a box padded by
# more than 1% of the ray's reach would admit nearly every lane anyway.
KAPPA_MAX = 1e-2
# Rows processed at a time (f64 temporaries of [n, 3, 3]).
_CHUNK = 1 << 20


def _outward(lo: torch.Tensor, hi: torch.Tensor):
    """f64 bounds rounded outward to f32."""
    lo32, hi32 = lo.float(), hi.float()
    ninf = torch.tensor(-np.inf, dtype=torch.float32, device=lo.device)
    lo32 = torch.where(lo32.double() > lo, torch.nextafter(lo32, ninf), lo32)
    hi32 = torch.where(hi32.double() < hi, torch.nextafter(hi32, -ninf), hi32)
    return lo32, hi32


def _row_regions(p: torch.Tensor):
    """Per row of ``p`` [n, 16] f32: (kind [n] i8: -1 never accepted, 0
    bounded, 1 unbounded; lo [n, 3], hi [n, 3] f64 of the region a bounded
    row accepts hits in, host rounding included; kappa [n] f64, the lane
    coefficient).

    A row accepts (t, b1, b2) only with b1, b2 >= -eps, b1 + b2 <= 1 + eps
    and eps <= 1e-3 (rows.cuh). Its rows n, g1, g2 (as f32 values, exact)
    form A; the point P = o + t d of a hit then satisfies
    A P = [c0 + pi, c1 + beta1, c2 + beta2] with the exact barycentrics
    beta within delta_k of the computed ones and the plane residual pi:
      delta_k <= GAMMA3 |g_k|_1 (T D + omag) + U (2.0042 + |c_k|),
      |pi|    <= |n|_1 ((GAMMA3 + EPS_T) omag + GAMMA3 T D) + EPS_T |c0|
    (T = max(|t_min|, |best t|) bounds |t|, D = |d|_inf, omag = |o|_inf;
    t's rounding enters pi only, the dots' enter both). So P lies in the
    triangle widened to E = eps + 2 max delta_k + 2.02 U in barycentric
    units, moved by pi w along w = A^-1 e0. With u1, u2 = A^-1 e1, A^-1
    e2 (the edges), a corner moves by at most 2 dE (|u1_a| + |u2_a|) on
    axis a when E grows by dE. The host box takes the constant parts,
    twice over; kappa takes the lane parts, twice over, plus the slab's
    own rounding (4 U T D), so that the lane's box padded by
    kappa (T D + omag) holds P with room for its f32 slab test. The f64
    arithmetic here is covered by a relative 1e-12."""
    f = p.double()
    c, n, g1, g2 = f[:, 0:3], f[:, 3:6], f[:, 6:9], f[:, 9:12]
    never = (p[:, 3:6] == 0.0).all(dim=1)  # dn = 0: t is NaN, never kept
    cross = lambda a, b: torch.linalg.cross(a, b, dim=1)
    det = (n * cross(g1, g2)).sum(dim=1, keepdim=True)
    w, u1, u2 = cross(g1, g2) / det, cross(g2, n) / det, cross(n, g1) / det
    q0 = c[:, 0:1] * w + c[:, 1:2] * u1 + c[:, 2:3] * u2
    dc = 1.001 * _U * (2.0042 + c[:, 1:3].abs()).amax(dim=1)
    E = (_EPS_MAX + 2.0 * (2.0 * dc + 2.02 * _U))[:, None]
    corners = torch.stack([q0 - E * (u1 + u2), q0 + (1 + 2 * E) * u1 - E * u2,
                           q0 - E * u1 + (1 + 2 * E) * u2])      # [3, n, 3]
    lo, hi = corners.amin(dim=0), corners.amax(dim=0)
    n1 = n.abs().sum(dim=1)
    gmax = torch.maximum(g1.abs().sum(dim=1), g2.abs().sum(dim=1))
    pad = (2.0 * w.abs() * _EPS_T * c[:, 0:1].abs()
           + 1e-12 * (lo.abs() + hi.abs() + 1.0))
    lo, hi = lo - pad, hi + pad
    kappa = (2.0 * (4.0 * _GAMMA3 * gmax[:, None] * (u1.abs() + u2.abs())
                    + w.abs() * n1[:, None]
                    * (3.0 * _GAMMA3 + _EPS_T + _GAMMA3 * _EPS_T)
                    + 4.0 * _U) + 1e-6).amax(dim=1)
    ok = (torch.isfinite(f[:, 0:12]).all(dim=1) & (det[:, 0] != 0.0)
          & torch.isfinite(lo).all(dim=1) & torch.isfinite(hi).all(dim=1)
          & torch.isfinite(kappa) & (kappa <= KAPPA_MAX) & (n1 >= 0.5))
    kind = torch.where(never, -1, torch.where(ok, 0, 1)).to(torch.int8)
    return kind, lo, hi, kappa


def padded_boxes(p: torch.Tensor, baabb: torch.Tensor) -> torch.Tensor:
    """The blocks' padded boxes [nb, 8] f32 (module docstring, ``pbox``),
    computed on the tables' device: the union of the block's AABB and its
    bounded rows' acceptance regions (:func:`_row_regions`), widened by
    2 U of its coordinates (the lane's f32 rounding of lo - m and hi + m)
    and rounded outward to f32; kappa, the largest of its bounded rows',
    rounded up; kind 1 when any row can accept a hit outside a bounded
    region (a singular or ill-conditioned [n; g1; g2], non-finite
    coefficients), -1 when no row can accept one and the box is empty,
    else 0. A lane that may hit a bounded block's row at t < best t finds
    the box in its slab padded by kappa (T D + omag) with an entry below
    best t (rows.cuh lane_admits)."""
    nb = baabb.shape[0]
    rows = p.reshape(nb, TB, 16)
    lo, hi = baabb[:, 0:3].double(), baabb[:, 3:6].double()
    kappa = torch.zeros(nb, dtype=torch.float64, device=p.device)
    unbounded = torch.zeros(nb, dtype=torch.bool, device=p.device)
    step = max(1, _CHUNK // TB)
    for b0 in range(0, nb, step):
        blk = rows[b0:b0 + step]
        m = blk.shape[0]
        kind, rlo, rhi, rk = _row_regions(blk.reshape(m * TB, 16))
        kind, bounded = kind.reshape(m, TB), (kind == 0).reshape(m, TB, 1)
        rlo = torch.where(bounded, rlo.reshape(m, TB, 3), np.inf).amin(dim=1)
        rhi = torch.where(bounded, rhi.reshape(m, TB, 3), -np.inf).amax(dim=1)
        lo[b0:b0 + m] = torch.minimum(lo[b0:b0 + m], rlo)
        hi[b0:b0 + m] = torch.maximum(hi[b0:b0 + m], rhi)
        kappa[b0:b0 + m] = torch.where(bounded[..., 0], rk.reshape(m, TB),
                                       0.0).amax(dim=1)
        unbounded[b0:b0 + m] = (kind == 1).any(dim=1)
    empty = ~(lo <= hi).all(dim=1)
    mag = torch.maximum(lo.abs(), hi.abs())
    mag = torch.where(torch.isfinite(mag), mag, 0.0)
    lo32, hi32 = _outward(lo - 2 * _U * mag, hi + 2 * _U * mag)
    k32 = kappa.float()
    k32 = torch.where(k32.double() < kappa,
                      torch.nextafter(k32, torch.full_like(k32, np.inf)), k32)
    kind = torch.where(unbounded, 1.0, torch.where(empty, -1.0, 0.0))
    return torch.cat([torch.where(empty[:, None], np.inf, lo32),
                      torch.where(empty[:, None], -np.inf, hi32),
                      k32[:, None], kind[:, None].float()], dim=1).contiguous()
