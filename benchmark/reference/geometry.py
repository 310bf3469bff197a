"""The plain reference's geometry: per-triangle rows, the watertight row
test, spheres and discs, on tensors of any float dtype.

The row of a triangle is the published hot-path form of the watertight
test (upstream ``src/Mesh.cpp``'s contract on f32): the unit plane
normal n, the barycentric gradients g1, g2 and their offsets against
corner 0, worked out in float64 and rounded once, and the acceptance
band ``eps = WT * (S + G * (|o|_inf + E_t))`` clamped at 1e-3. Two
operation orders of the same test exist: the path tracer's (every
product rounded; ``fused=False``) and the shadow trace's (a product that
feeds a sum fused into it, as the compiled JAX kernel contracts it;
``fused=True``). Every test here keeps the smallest t; ties go to the
lowest index.

``dt`` is the float type the reference computes in: float32 is the
configuration's precision, a lower one makes the control.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

INF = float("inf")
EPS_MACH = float(np.float32(np.finfo(np.float32).eps * 0.5))
RAY_EPS = float(np.float32(EPS_MACH * 1500.0))
WT_EPS = float(np.float32(32.0 * EPS_MACH))
EPS_CLAMP = float(np.float32(1e-3))
TINY = float(np.float32(1e-30))


@dataclass
class Tables:
    rows: torch.Tensor      # [T, 15]: n.p0, g1.p0, g2.p0, n, g1, g2, S*WT, G*WT, |n.p0|
    n0: torch.Tensor        # [T, 3] shading normal at corner 0 (or n)
    dn1: torch.Tensor       # [T, 3] corner 1 minus corner 0 (0: flat)
    dn2: torch.Tensor
    tri_mat: torch.Tensor   # [T] i64
    ap_s: torch.Tensor      # [S, 4] centre, r^2
    ap_d: torch.Tensor      # [D, 8] normal, centre, r^2, |c.n|
    mat_albedo: torch.Tensor
    mat_emission: torch.Tensor
    mat_type: torch.Tensor  # [M] i64
    mat_emissive: torch.Tensor  # [M] bool
    mat_ior: torch.Tensor
    mat_ids: torch.Tensor   # [G] i64
    tri_geom: torch.Tensor  # [T] i64
    tri_prim: torch.Tensor
    n_meshes: int


def tables(sc, device, dt=torch.float32) -> Tables:
    """The reference's own tables of a :class:`~scene.PlainScene`."""
    v = sc.tri_v.astype(np.float64)
    p0, p1, p2 = v[:, 0], v[:, 1], v[:, 2]
    e1, e2 = p1 - p0, p2 - p0
    n = np.cross(e1, e2)
    nlen = np.linalg.norm(n, axis=-1, keepdims=True)
    degen = nlen[:, 0] < 1e-20
    n = np.where(degen[:, None], 0.0, n / np.maximum(nlen, 1e-30))
    d00 = np.sum(e1 * e1, -1)
    d01 = np.sum(e1 * e2, -1)
    d11 = np.sum(e2 * e2, -1)
    den = d00 * d11 - d01 * d01
    den = np.where(np.abs(den) < 1e-30, 1.0, den)
    g1 = np.where(degen[:, None], 0.0,
                  (e1 * d11[:, None] - e2 * d01[:, None]) / den[:, None])
    g2 = np.where(degen[:, None], 0.0,
                  (e2 * d00[:, None] - e1 * d01[:, None]) / den[:, None])
    r = np.zeros((len(v), 15), np.float32)
    r[:, 0] = np.sum(n * p0, -1)
    r[:, 1] = np.sum(g1 * p0, -1)
    r[:, 2] = np.sum(g2 * p0, -1)
    r[:, 3:6], r[:, 6:9], r[:, 9:12] = n, g1, g2
    wt = np.float32(WT_EPS)
    r[:, 12] = wt * (np.abs(r[:, 1]) + np.abs(r[:, 2]))
    r[:, 13] = wt * (np.abs(g1).sum(-1) + np.abs(g2).sum(-1))
    r[:, 14] = np.abs(r[:, 0])
    vn = sc.tri_n.astype(np.float64)
    has = sc.tri_has_n[:, None]
    n0 = np.where(has, vn[:, 0], n).astype(np.float32)
    dn1 = np.where(has, vn[:, 1] - vn[:, 0], 0.0).astype(np.float32)
    dn2 = np.where(has, vn[:, 2] - vn[:, 0], 0.0).astype(np.float32)

    S, D = len(sc.spheres), len(sc.discs)
    ap_s = np.zeros((S, 4), np.float32)
    ap_s[:, :3] = sc.spheres[:, :3]
    ap_s[:, 3] = sc.spheres[:, 3] * sc.spheres[:, 3]
    ap_d = np.zeros((D, 8), np.float32)
    ap_d[:, 0:3] = sc.discs[:, 0:3]
    ap_d[:, 3:6] = sc.discs[:, 3:6]
    ap_d[:, 6] = sc.discs[:, 6] * sc.discs[:, 6]
    nc = sc.discs[:, 0:3] * sc.discs[:, 3:6]
    ap_d[:, 7] = np.abs((nc[:, 0] + nc[:, 1]) + nc[:, 2])

    f = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)
    i = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(device)
    emissive = np.any(sc.mat_emission != 0.0, axis=1)
    return Tables(
        rows=f(r), n0=f(n0), dn1=f(dn1), dn2=f(dn2),
        tri_mat=i(sc.mat_ids[sc.tri_geom]) if len(sc.tri_geom) else i([]),
        ap_s=f(ap_s), ap_d=f(ap_d), mat_albedo=f(sc.mat_albedo),
        mat_emission=f(sc.mat_emission), mat_type=i(sc.mat_type),
        mat_emissive=torch.from_numpy(emissive).to(device),
        mat_ior=f(sc.mat_ior), mat_ids=i(sc.mat_ids),
        tri_geom=i(sc.tri_geom), tri_prim=i(sc.tri_prim),
        n_meshes=sc.num_meshes)


def fma(a, b, c):
    """a * b + c rounded once: formed in float64 (where a product of two
    f32 is exact), then rounded to the operands' type."""
    like = next(x for x in (a, b, c) if torch.is_tensor(x))
    up = lambda x: x.to(torch.float64) if torch.is_tensor(x) else x
    return (up(a) * up(b) + up(c)).to(like.dtype)


def sqrt_cr(x):
    """The correctly rounded square root of the type (via float64)."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def dot_plain(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def dot_fused(a, b):
    """The dot as the compiled JAX kernel contracts it elementwise."""
    return fma(a[2], b[2], fma(a[0], b[0], a[1] * b[1]))


def dot_sum(a, b):
    """The dot as XLA reduces a sum over the last axis: in order, each
    product fused into the running sum."""
    return fma(a[2], b[2], fma(a[1], b[1], a[0] * b[0]))


def o_mag(o):
    return torch.maximum(torch.maximum(torch.abs(o[0]), torch.abs(o[1])),
                         torch.abs(o[2]))


def _cols(rows, c0):
    return tuple(rows[:, c:c + 1] for c in range(c0, c0 + 3))


def _recip(x, fused: bool):
    """1 / bf16(x) refined by one Newton step (the published kernels'
    approximate reciprocal)."""
    r = torch.reciprocal(x.to(torch.bfloat16).to(x.dtype))
    return r * (fma(-x, r, 2.0) if fused else (2.0 - x * r))


def row_chain(rows, o, d, fused: bool):
    """(t, b1, b2, on, r) of rows [T, 15] against lanes o, d (vec3 tuples
    of [L]); results [T, L]."""
    dot = dot_fused if fused else dot_plain
    o = tuple(c[None] for c in o)
    d = tuple(c[None] for c in d)
    on, dn = dot(_cols(rows, 3), o), dot(_cols(rows, 3), d)
    r = _recip(dn, fused)
    t = (rows[:, 0:1] - on) * r
    if fused:
        b1 = fma(t, dot(_cols(rows, 6), d), dot(_cols(rows, 6), o)) - rows[:, 1:2]
        b2 = fma(t, dot(_cols(rows, 9), d), dot(_cols(rows, 9), o)) - rows[:, 2:3]
    else:
        b1 = dot(_cols(rows, 6), o) + t * dot(_cols(rows, 6), d) - rows[:, 1:2]
        b2 = dot(_cols(rows, 9), o) + t * dot(_cols(rows, 9), d) - rows[:, 2:3]
    return t, b1, b2, on, r


def closest_rows(tb: Tables, o, d, t_min, best_t, fused: bool,
                 chunk: int = 1 << 22):
    """The nearest accepted row per lane, nearer than ``best_t`` (strictly)
    and beyond ``t_min``: (t [L], row [L] or -1). Rows are taken in
    blocks so the [rows, L] temporaries stay near ``chunk`` elements."""
    L = best_t.shape[0]
    row = torch.full((L,), -1, dtype=torch.int64, device=best_t.device)
    T = tb.rows.shape[0]
    if T == 0 or L == 0:
        return best_t, row
    om = o_mag(o)[None]
    step = max(1, chunk // max(L, 1))
    for r0 in range(0, T, step):
        rows = tb.rows[r0:r0 + step]
        t, b1, b2, on, r = row_chain(rows, o, d, fused)
        et = (rows[:, 14:15] + torch.abs(on)) * torch.abs(r)
        eps = (fma(rows[:, 13:14], om + et, rows[:, 12:13]) if fused
               else rows[:, 12:13] + rows[:, 13:14] * (om + et))
        eps = torch.clamp_max(eps, EPS_CLAMP)
        ok = ((torch.minimum(b1, b2) >= -eps) & (b1 + b2 <= 1.0 + eps)
              & (t > t_min[None]))
        tm = torch.where(ok, t, INF)
        bt = torch.amin(tm, dim=0)
        idx = torch.arange(rows.shape[0], device=rows.device)[:, None]
        bi = torch.amin(torch.where(tm <= bt[None], idx, rows.shape[0]), dim=0)
        better = (bt < best_t) & (bt < INF)
        best_t = torch.where(better, bt, best_t)
        row = torch.where(better, bi + r0, row)
    return best_t, row


def barycentrics(tb: Tables, row, o, d, fused: bool):
    rows = tb.rows[torch.clamp_min(row, 0)]
    _, b1, b2, _, _ = row_chain_lane(rows, o, d, fused)
    return b1, b2


def row_chain_lane(rows, o, d, fused: bool):
    """:func:`row_chain` of one row per lane (rows [L, 15])."""
    dot = dot_fused if fused else dot_plain
    col = lambda c0: tuple(rows[:, c] for c in range(c0, c0 + 3))
    on, dn = dot(col(3), o), dot(col(3), d)
    r = _recip(dn, fused)
    t = (rows[:, 0] - on) * r
    if fused:
        b1 = fma(t, dot(col(6), d), dot(col(6), o)) - rows[:, 1]
        b2 = fma(t, dot(col(9), d), dot(col(9), o)) - rows[:, 2]
    else:
        b1 = dot(col(6), o) + t * dot(col(6), d) - rows[:, 1]
        b2 = dot(col(9), o) + t * dot(col(9), d) - rows[:, 2]
    return t, b1, b2, on, r
