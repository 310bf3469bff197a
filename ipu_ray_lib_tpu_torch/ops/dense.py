"""The dense intersector: every ray against every triangle, sphere and
disc.

* The triangles (port of ``ipu_ray_lib_tpu/ops/dense.py:59-182``): the
  tables of :func:`build_dense_tables` (host, float64 then f32, padded to
  whole blocks of ``TRI_BLOCK`` rows whose padding never hits), packed one
  triangle per row of 16 f32 (:data:`DENSE_COLS`), and the closest hit
  over them: K8 (``ops/cuda/dense.cu``) on the card, :func:`dense_closest_tri_ref`
  on the CPU and to check the kernel. The JAX package's form is six MXU
  matmuls per block of 512 triangles; here each ray scans the rows in
  order and keeps the first index of the strict minimum, which is the
  JAX form's ``min``/``argmin`` per block and its strict ``better``
  across blocks.
* The spheres and discs (port of ``dense_spheres`` and ``dense_discs``,
  :185-249): every ray against every sphere (disc) of the scene's ``ap``
  rows, the nearest hit per ray, the first index on ties. They follow
  the triangle kernel in ``pallas_scene_intersect``,
  ``pallas_path_intersect`` and ``dense_intersect`` (ops/traversal.py).

The arithmetic is the JAX functions' as XLA compiles them under ``jit``
on the CPU: their dots (``einsum``/``dot`` at ``Precision.HIGHEST`` and
``sum`` over the last axis) reduce in order with each product fused into
the running sum (:func:`sum3`), and a difference or sum fed by a product
is one fused multiply-add. The fused shadow kernel's in-kernel twins
(ops/shadow.py) run the same passes with the dots contracted elementwise
(``dot=``), which rounds differently on some sphere hits: the JAX
package's own glue and fused routes differ there too (ROADMAP queue 3).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.constants import MACHINE_EPSILON, WATERTIGHT_EPS_SCALE
from .intersect import INF
from .vec3 import fma, sqrt, sum3

_MACH_EPS = float(MACHINE_EPSILON)
_EPS_SCALE = float(WATERTIGHT_EPS_SCALE)
_EPS_CLAMP = float(np.float32(1e-3))
TRI_BLOCK = 512
# The columns of a dense row: the unit normal, n . p0, the barycentric
# gradients g1 and g2 with g . p0, and the acceptance-bound terms tS and tG.
DENSE_COLS = dict(tn=slice(0, 3), tnp0=3, g1=slice(4, 7), g1p0=7,
                  g2=slice(8, 11), g2p0=11, tS=12, tG=13)
# Rays the plain version tests at once: its temporaries are [rays, 512],
# 8 MB in float64, which stay in a CPU's cache (4x faster than 8,192).
REF_RAYS = 2048

# CUDA kernel launches since the last reset.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


class DenseTables(NamedTuple):
    """Per-triangle tables of the dense intersector (numpy), padded to a
    multiple of TRI_BLOCK; padding rows have n == 0 and never hit."""

    tn: np.ndarray        # [T, 3] f32 unit normal
    tnp0: np.ndarray      # [T] n . p0
    g1: np.ndarray        # [T, 3] barycentric gradient of b1
    g1p0: np.ndarray      # [T] g1 . p0
    g2: np.ndarray        # [T, 3]
    g2p0: np.ndarray      # [T]
    tri_geom: np.ndarray  # [T] i32
    tri_prim: np.ndarray  # [T] i32
    tS: np.ndarray        # [T] |g1p0| + |g2p0|
    tG: np.ndarray        # [T] ||g1||_1 + ||g2||_1


def build_dense_tables(tri_v, verts, tri_geom, tri_prim) -> DenseTables:
    """The JAX package's host precompute, vectorised over all triangles
    (float64, then f32)."""
    tri_v = np.asarray(tri_v).reshape(-1, 3)
    verts = np.asarray(verts, np.float32).reshape(-1, 3)
    T = len(tri_v)
    p0 = verts[tri_v[:, 0]].astype(np.float64)
    p1 = verts[tri_v[:, 1]].astype(np.float64)
    p2 = verts[tri_v[:, 2]].astype(np.float64)
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
    g1 = (e1 * d11[:, None] - e2 * d01[:, None]) / safe[:, None]
    g2 = (e2 * d00[:, None] - e1 * d01[:, None]) / safe[:, None]
    g1 = np.where(degenerate[:, None], 0.0, g1)
    g2 = np.where(degenerate[:, None], 0.0, g2)
    pad = (-T) % TRI_BLOCK
    if pad == 0 and T == 0:
        pad = TRI_BLOCK

    def pad0(a):
        return np.pad(a.astype(np.float32),
                      ((0, pad),) + ((0, 0),) * (a.ndim - 1))

    def padi(a):
        return np.pad(np.asarray(a).astype(np.int32), (0, pad))

    g1p0 = np.sum(g1 * p0, axis=-1)
    g2p0 = np.sum(g2 * p0, axis=-1)
    return DenseTables(
        tn=pad0(n), tnp0=pad0(np.sum(n * p0, axis=-1)), g1=pad0(g1),
        g1p0=pad0(g1p0), g2=pad0(g2), g2p0=pad0(g2p0),
        tri_geom=padi(tri_geom), tri_prim=padi(tri_prim),
        tS=pad0(np.abs(g1p0) + np.abs(g2p0)),
        tG=pad0(np.abs(g1).sum(axis=-1) + np.abs(g2).sum(axis=-1)))


def dense_leaves(dt) -> dict:
    """The scene leaves of the tables ``dt`` (a DenseTables, or a dict of
    its fields): ``dense_rows`` [T, 16] f32 (:data:`DENSE_COLS`, two zero
    columns), ``dense_geom`` and ``dense_prim`` [T] i32."""
    if not isinstance(dt, dict):
        dt = dt._asdict()
    rows = np.zeros((len(dt["tnp0"]), 16), np.float32)
    for k, c in DENSE_COLS.items():
        rows[:, c] = dt[k]
    return dict(dense_rows=rows,
                dense_geom=np.asarray(dt["tri_geom"], np.int32),
                dense_prim=np.asarray(dt["tri_prim"], np.int32))


def _check_tables(scene) -> None:
    if scene.bvh_nodes is None:
        raise ValueError("this scene carries no dense tables (build it with "
                         "intersector='dense')")
    if scene.dense_rows is None:
        raise RuntimeError(
            "dense intersector tables were skipped at build time (scene "
            "exceeds scene.build.DENSE_TABLE_MAX_TRIS); rebuild with "
            "build_scene(..., intersector='dense') to use them")


def dense_closest_tri_ref(rows, origins, dirs, t_min, t_max):
    """Plain version of K8: the closest triangle of the dense ``rows``
    [T, 16] for each ray (origins, dirs [R, 3]; t_min, t_max [R]), block
    by block as ``_tri_block_best`` (ipu_ray_lib_tpu/ops/dense.py:109-166).
    Returns (t [R], tri [R] i32): t_max and -1 where nothing is hit before
    t_max. The origin's dots are computed even for the camera's zero
    origins, as XLA computes them (it does not fold a dot of zeros)."""
    t_out, i_out = [], []
    for r0 in range(0, dirs.shape[0], REF_RAYS):
        sl = slice(r0, r0 + REF_RAYS)
        t, i = _closest_rows(rows, origins[sl], dirs[sl], t_min[sl],
                             t_max[sl])
        t_out.append(t)
        i_out.append(i)
    if not t_out:
        return t_max.clone(), torch.full_like(t_max, -1, dtype=torch.int32)
    best_t, best_i = torch.cat(t_out), torch.cat(i_out)
    return best_t, torch.where(best_t < t_max, best_i, -1)


def _closest_rows(rows, o, d, t_min, t_max):
    """(best t, best row) of rays o, d [R, 3] over every row, block by
    block; the fused multiply-adds in float64, whose product of two f32
    is exact (one rounding to f32 after the sum, as ``fma``)."""
    f64 = torch.float64
    o64, d64 = o.to(f64), d.to(f64)

    def fma64(a, b, c):
        """f32 a*b + c rounded once (ops/vec3.py ``fma``), a and b float64
        holding f32 values, c f32: the product is exact in float64."""
        return torch.addcmul(c.to(f64), a, b).to(torch.float32)

    def dot(v, cols):
        """sum3(v, row) of every ray and row: fma(v2, c2, fma(v1, c1,
        v0*c0)) as XLA reduces a dot (v [R, 3] float64, cols [3, T]
        float64)."""
        p = (v[:, 0:1] * cols[0:1]).to(torch.float32)
        return fma64(v[:, 2:3], cols[2:3], fma64(v[:, 1:2], cols[1:2], p))

    best_t, best_i = t_max, torch.full_like(t_max, -1, dtype=torch.int32)
    o_mag = torch.amax(torch.abs(o), dim=1, keepdim=True)
    for b0 in range(0, rows.shape[0], TRI_BLOCK):
        blk = rows[b0:b0 + TRI_BLOCK].t()
        b64 = blk.to(f64)
        col = lambda c: blk[c:c + 1]  # noqa: E731
        dn, on = dot(d64, b64[0:3]), dot(o64, b64[0:3])
        t = (col(3) - on) / dn
        t64 = t.to(f64)
        b1 = fma64(t64, dot(d64, b64[4:7]).to(f64), dot(o64, b64[4:7])) \
            - col(7)
        b2 = fma64(t64, dot(d64, b64[8:11]).to(f64), dot(o64, b64[8:11])) \
            - col(11)
        et = (torch.abs(col(3)) + torch.abs(on)) / torch.abs(
            torch.where(dn == 0.0, 1.0, dn))
        eps = torch.clamp_max(
            _EPS_SCALE * fma(col(13), o_mag + et, col(12)), _EPS_CLAMP)
        ok = ((dn != 0.0) & (b1 >= -eps) & (b2 >= -eps)
              & (b1 + b2 <= 1.0 + eps) & (t > t_min[:, None])
              & (t < best_t[:, None]))
        t = torch.where(ok, t, INF)
        local_best, local_idx = torch.min(t, dim=1)
        better = local_best < best_t
        best_t = torch.where(better, local_best, best_t)
        best_i = torch.where(better, (local_idx + b0).to(torch.int32),
                             best_i)
    return best_t, best_i


def dense_closest_tri_cuda(rows, origins, dirs, t_min, t_max):
    """K8 on the card; counts its launches."""
    global launches
    from .cuda.build import launch_dense

    R = dirs.shape[0]
    out_t = torch.empty(R, dtype=torch.float32, device=dirs.device)
    out_i = torch.empty(R, dtype=torch.int32, device=dirs.device)
    if R:
        launch_dense(rows, origins.contiguous(), dirs.contiguous(),
                     t_min.contiguous(), t_max.contiguous(), out_t, out_i)
        launches += 1
    return out_t, out_i


def dense_closest_tri(scene, origins, dirs, t_min, t_max):
    """Closest triangle of every ray over the scene's dense tables: K8 on
    a CUDA scene, the plain version on a CPU scene. (t, tri) as
    :func:`dense_closest_tri_ref`."""
    _check_tables(scene)
    dev = scene.device.type
    if dev == "cuda":
        return dense_closest_tri_cuda(scene.dense_rows, origins, dirs,
                                      t_min, t_max)
    if dev == "cpu":
        return dense_closest_tri_ref(scene.dense_rows, origins, dirs, t_min,
                                     t_max)
    raise ValueError(f"unsupported device {scene.device}")


def sphere_pass(ap, n_sph: int, o, d, t_min, dot=sum3):
    """(t, index, centre) of the nearest sphere hit per lane, over ``ap``
    rows [0, n_sph) (o, d: vec3 tuples; t = inf where none). ``dot``: how
    the dots round (the fused shadow kernel passes its elementwise form)."""
    rd2 = 1.0 / dot(d, d)
    cur_t = torch.full_like(d[0], INF)
    cur_i = torch.zeros(d[0].shape, dtype=torch.int32, device=d[0].device)
    cur_c = [torch.zeros_like(d[0]) for _ in range(3)]
    for s in range(n_sph):
        c = (ap[s, 1], ap[s, 2], ap[s, 3])
        r2 = ap[s, 7]
        oc = tuple(c[a] - o[a] for a in range(3))
        tca = dot(oc, d) * rd2
        lv = tuple(fma(-d[a], tca, oc[a]) for a in range(3))
        l2 = dot(lv, lv)
        td = sqrt(torch.clamp_min(r2 - l2, 0.0)) * rd2
        t0, t1 = tca - td, tca + td
        t = torch.where(t0 < t_min, t1, t0)
        miss = (tca < 0.0) | (l2 > r2) | (t < t_min) | (r2 <= 0.0)
        t = torch.where(miss | (t <= t_min), INF, t)
        upd = t < cur_t
        cur_t = torch.where(upd, t, cur_t)
        cur_i = torch.where(upd, s, cur_i)
        cur_c = [torch.where(upd, ca, cc) for ca, cc in zip(c, cur_c)]
    return cur_t, cur_i, cur_c


def disc_pass(ap, n_sph: int, n_dsc: int, o, d, t_min, dot=sum3,
              stored_offset: bool = False):
    """(t, index, normal) of the nearest disc hit per lane, over ``ap``
    rows [n_sph, n_sph + n_dsc) (t = inf where none). The plane offset
    |c . n| is computed here, or with ``stored_offset`` read from ``ap``
    (summed left to right at build time, as the fused shadow kernel
    takes it)."""
    cur_t = torch.full_like(d[0], INF)
    cur_i = torch.zeros(d[0].shape, dtype=torch.int32, device=d[0].device)
    cur_n = [torch.zeros_like(d[0]) for _ in range(3)]
    for s in range(n_dsc):
        a = ap[n_sph + s]
        c, nv = (a[1], a[2], a[3]), (a[4], a[5], a[6])
        r2 = a[7]
        d_off = a[8] if stored_offset else torch.abs(dot(c, nv))
        angle = dot(d, nv)
        t = -(dot(o, nv) + d_off) / angle
        h = tuple(fma(d[k], t, o[k]) - c[k] for k in range(3))
        d2 = dot(h, h)
        ok = ((angle != 0.0) & (t > _MACH_EPS) & (d2 < r2) & (r2 > 0.0)
              & (t > t_min))
        t = torch.where(ok, t, INF)
        upd = t < cur_t
        cur_t = torch.where(upd, t, cur_t)
        cur_i = torch.where(upd, s, cur_i)
        cur_n = [torch.where(upd, na, cn) for na, cn in zip(nv, cur_n)]
    return cur_t, cur_i, cur_n


def _cols(x):
    return tuple(x[:, a] for a in range(3))


def dense_spheres(scene, origins, dirs, t_min, best_t):
    """All-spheres closest hit: (better, t, index) per ray (origins/dirs
    [R, 3], t_min/best_t [R]); better = t < best_t."""
    t, i, _ = sphere_pass(scene.ap, scene.n_spheres, _cols(origins),
                          _cols(dirs), t_min)
    return t < best_t, t, i


def dense_discs(scene, origins, dirs, t_min, best_t):
    """All-discs closest hit: (better, t, index) per ray."""
    t, i, _ = disc_pass(scene.ap, scene.n_spheres, scene.n_discs,
                        _cols(origins), _cols(dirs), t_min)
    return t < best_t, t, i
