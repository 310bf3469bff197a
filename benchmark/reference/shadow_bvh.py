"""The plain shadow trace of the BVH route: every AOV of single pixels of
a shadow-traced frame, from the scene description, with the semantics of
the glue route on a scene built with ``intersector="bvh"`` (upstream's
compact BVH2, walked by the system's kernel K7).

For a camera ray through the pixel centre (origin 0, the image plane
across the horizontal field of view, as :func:`shadow.camera_dirs`):

* the closest hit over every primitive, by brute force: the watertight
  triangle test with its ray shear (PBRT's, with f32 error bounds and
  ``t_far = inf``), the geometric sphere test with ``t_min``, and the
  disc test with the plane offset ``|c . n|``; each accepted when
  ``t_min < t < best`` strictly and the primitive's own box admits the
  ray (the slab test, its exits widened by ``1 + 2 gamma(3)``, of the
  box as the compact node stores it: the f32 lower corner and the
  extent rounded up to f16), as the walk tests a leaf only inside its
  box: so a hit that the watertight test accepts just past a
  triangle's edge, outside its box, counts for neither;
* the shading normal of the winner: a triangle's from the barycentrics of
  the same test (its vertex normals where it has them, else its geometric
  normal), a sphere's radial, a disc's own, (0, 0, 1) on a miss;
* the hit point, the unit direction to the point light and its distance,
  the origin pushed off the surface along the normal to the light's side
  by ``RAY_EPS * (1 + |p|_inf)``, and the any-hit test of that shadow ray
  over every primitive (``0 < t < distance``);
* ``rgb = albedo * ambient + lambert * albedo`` (lambert 0 when occluded),
  0 on a miss. AOVs: rgb, t (inf on a miss), geom_id (-1), prim_id (-1),
  normal, hit_p (0 on a miss).

The arithmetic is that of the upstream JAX glue route as XLA compiles it
on f32: a product feeding a sum or difference is fused (``G.fma``), a sum
over a vector's three components runs in order (``G.dot_sum``), a square
root is correctly rounded. It differs from the fused route's row test
(``shadow.py``) at the level of rounding, so each route has its own
reference.

Departures from the route: no BVH above the leaves. The route walks the
threaded BVH and keeps the first primitive it visits among those at one
t; here a tie in t goes to the lowest scene index (the meshes' triangles
in order, then the spheres, then the discs). The walk tests a leaf's box
against its best t so far, and reaches a leaf only through its
ancestors' boxes, which hold it; here each box is tested against
``[t_min, t_max]`` alone. The two differ only for a hit outside its own
box that the walk would still reach, at a grazing edge.

``dt`` is the float type the reference computes in: float32 is the
configuration's precision, a lower one makes the control.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import geometry as G
from .geometry import dot_sum, fma
from .shadow import AMBIENT, LIGHT, camera_dirs


def _gamma(n: int) -> float:
    ni = np.float32(np.finfo(np.float32).eps * 0.5) * n
    return float(np.float32(ni / (1.0 - ni)))


GAMMA2, GAMMA3, GAMMA5 = _gamma(2), _gamma(3), _gamma(5)
BOX_SLAB_SCALE = float(np.float32(1.0 + 2.0 * GAMMA3))
MISS_GEOM = -1


@dataclass
class Prims:
    p: tuple                # 3 corners, each a vec3 of [T] tensors
    corner_n: tuple         # 3 corner normals, each a vec3 of [T]
    has_n: torch.Tensor     # [T] bool: the triangle's mesh has normals
    tri_geom: torch.Tensor  # [T] i64
    tri_prim: torch.Tensor  # [T] i64
    spheres: torch.Tensor   # [S, 4] centre, radius
    discs: torch.Tensor     # [D, 7] normal, centre, radius
    box_lo: tuple           # vec3 of [T + S + D]: each primitive's box,
    box_hi: tuple           # triangles, then spheres, then discs
    albedo: torch.Tensor    # [G, 3] each geometry id's albedo
    n_meshes: int


def half_up(x: np.ndarray) -> np.ndarray:
    """Non-negative f32 values rounded to f16, never down."""
    h = np.asarray(x, np.float32).astype(np.float16)
    up = (h.view(np.uint16) + np.uint16(1)).view(np.float16)
    return np.where(h.astype(np.float32) < x, up, h)


def boxes(sc):
    """Each primitive's box as the compact node stores it, (lo, hi) [N, 3]
    f32: the corners' or the centre's bounds, hi = lo + the extent
    rounded up to f16, added in f32."""
    v = sc.tri_v
    lo = [np.minimum(np.minimum(v[:, 0], v[:, 1]), v[:, 2]),
          sc.spheres[:, :3] - sc.spheres[:, 3:4],
          sc.discs[:, 3:6] - sc.discs[:, 6:7]]
    hi = [np.maximum(np.maximum(v[:, 0], v[:, 1]), v[:, 2]),
          sc.spheres[:, :3] + sc.spheres[:, 3:4],
          sc.discs[:, 3:6] + sc.discs[:, 6:7]]
    lo = np.concatenate(lo).astype(np.float32)
    ext = np.maximum(np.concatenate(hi).astype(np.float32) - lo, 0.0)
    return lo, lo + half_up(ext).astype(np.float32)


def prims(sc, device, dt=torch.float32) -> Prims:
    """The reference's primitives of a :class:`~scene.PlainScene`."""
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)
    i = lambda a: torch.from_numpy(np.asarray(a, np.int64)).to(device)
    vec = lambda a: tuple(f(a[:, c]) for c in range(3))
    lo, hi = boxes(sc)
    return Prims(
        p=tuple(vec(sc.tri_v[:, k]) for k in range(3)),
        corner_n=tuple(vec(sc.tri_n[:, k]) for k in range(3)),
        has_n=torch.from_numpy(np.asarray(sc.tri_has_n, bool)).to(device),
        tri_geom=i(sc.tri_geom), tri_prim=i(sc.tri_prim),
        spheres=f(sc.spheres), discs=f(sc.discs),
        box_lo=vec(lo), box_hi=vec(hi),
        albedo=f(sc.mat_albedo[sc.mat_ids]), n_meshes=sc.num_meshes)


def _sel(v, idx):
    """Component ``idx`` (an int tensor of 0, 1, 2) of the vec3 v."""
    return torch.where(idx == 0, v[0], torch.where(idx == 1, v[1], v[2]))


def _amax3(a, b, c):
    return torch.maximum(torch.maximum(torch.abs(a), torch.abs(b)),
                         torch.abs(c))


def shear(d):
    """The ray shear: (perm (ix, iy, iz), (sx, sy, sz)); z is the axis of
    the largest |d| (the first on ties), x and y the next two in cyclic
    order."""
    ad = tuple(torch.abs(c) for c in d)
    iz = torch.where((ad[1] > ad[0]) & (ad[1] >= ad[2]), 1,
                     torch.where((ad[2] > ad[0]) & (ad[2] > ad[1]), 2, 0))
    ix = torch.where(iz == 2, 0, iz + 1)
    iy = torch.where(ix == 2, 0, ix + 1)
    inv_dz = 1.0 / _sel(d, iz)
    return (ix, iy, iz), (-_sel(d, ix) * inv_dz, -_sel(d, iy) * inv_dz,
                          inv_dz)


def triangle(p, o, sh):
    """The watertight test of the triangles ``p`` (3 corners, vec3s)
    against the rays (origins ``o``, shears ``sh``), broadcast: (t, 0 on a
    miss; b0, b1, b2)."""
    perm, (sx, sy, sz) = sh
    pt = []
    for corner in p:
        q = tuple(corner[a] - o[a] for a in range(3))
        pt.append(tuple(_sel(q, k) for k in perm))
    px = [fma(sx, q[2], q[0]) for q in pt]
    py = [fma(sy, q[2], q[1]) for q in pt]
    e0 = fma(px[1], py[2], -(py[1] * px[2]))
    e1 = fma(px[2], py[0], -(py[2] * px[0]))
    e2 = fma(px[0], py[1], -(py[0] * px[1]))
    max_xt, max_yt = _amax3(*px), _amax3(*py)
    max_zt0 = _amax3(*(q[2] for q in pt))
    dx0 = GAMMA5 * (max_xt + max_zt0)
    dy0 = GAMMA5 * (max_yt + max_zt0)
    de = 2.0 * fma(dx0, max_yt, fma(GAMMA2 * max_xt, max_yt, dy0 * max_xt))
    mixed = (((e0 < -de) | (e1 < -de) | (e2 < -de))
             & ((e0 > de) | (e1 > de) | (e2 > de)))
    det = e0 + e1 + e2
    pz = [q[2] * sz for q in pt]
    t_scaled = fma(e2, pz[2], fma(e0, pz[0], e1 * pz[1]))
    far = G.INF * det
    bad_neg = (det < 0) & ((t_scaled >= 0) | (t_scaled < far))
    bad_pos = (det > 0) & ((t_scaled <= 0) | (t_scaled > far))
    inv_det = 1.0 / det
    t = t_scaled * inv_det
    max_z = _amax3(*pz)
    delta_z = GAMMA3 * max_z
    delta_x = GAMMA5 * (max_xt + max_z)
    delta_y = GAMMA5 * (max_yt + max_z)
    delta_e = 2.0 * fma(delta_x, max_yt,
                        fma(GAMMA2 * max_xt, max_yt, delta_y * max_xt))
    max_e = _amax3(e0, e1, e2)
    delta_t = 3.0 * fma(delta_z, max_e,
                        fma(GAMMA3 * max_e, max_z, delta_e * max_z)) \
        * torch.abs(inv_det)
    miss = mixed | (det == 0) | bad_neg | bad_pos | (t <= delta_t)
    return (torch.where(miss, 0.0, t), e0 * inv_det, e1 * inv_det,
            e2 * inv_det)


def slab(lo, hi, o, inv, t0, t1):
    """The slab test of boxes (lo, hi) against rays (origins o, 1 / d),
    broadcast: whether [t0, t1] meets the box, its exits widened by
    ``BOX_SLAB_SCALE``."""
    for a in range(3):
        tn = (lo[a] - o[a]) * inv[a]
        tf = (hi[a] - o[a]) * inv[a]
        swap = tn > tf
        tn, tf = torch.where(swap, tf, tn), torch.where(swap, tn, tf)
        tf = tf * BOX_SLAB_SCALE
        t0 = torch.where(tn > t0, tn, t0)
        t1 = torch.where(tf < t1, tf, t1)
    return t0 <= t1


def sphere(o, d, t_min, c, r):
    """The geometric sphere test (centre c, radius r): t, 0 on a miss."""
    f = tuple(c[a] - o[a] for a in range(3))
    rd2 = 1.0 / dot_sum(d, d)
    tca = dot_sum(f, d) * rd2
    lv = tuple(fma(-d[a], tca, f[a]) for a in range(3))
    l2 = dot_sum(lv, lv)
    td = G.sqrt_cr(torch.clamp_min(fma(r, r, -l2), 0.0)) * rd2
    t0, t1 = tca - td, tca + td
    t = torch.where(t0 < t_min, t1, t0)
    miss = (tca < 0.0) | (l2 > r * r) | (t < t_min)
    return torch.where(miss, 0.0, t)


def disc(o, d, n, c, r, zero_origin: bool):
    """The disc test with the plane offset |c . n|: t, 0 on a miss.
    ``zero_origin``: camera rays from (0, 0, 0), whose origin the compiled
    route folds away, so the hit point fuses into its difference with
    the centre."""
    angle = dot_sum(n, d)
    d_off = torch.abs(dot_sum(c, n))
    if zero_origin:
        t = -d_off / angle
        dd = tuple(fma(d[a], t, -c[a]) for a in range(3))
    else:
        t = -(dot_sum(n, o) + d_off) / angle
        dd = tuple(fma(d[a], t, o[a]) - c[a] for a in range(3))
    ok = (angle != 0.0) & (t > G.EPS_MACH) & (dot_sum(dd, dd) < r * r)
    return torch.where(ok, t, 0.0)


def _vec(x, k0: int):
    """Columns k0, k0 + 1, k0 + 2 of x [..., K] as a vec3."""
    return tuple(x[..., k] for k in range(k0, k0 + 3))


def _candidates(pr: Prims, o, d, t_min, t_max, zero_origin: bool,
                chunk: int = 1 << 20):
    """Every primitive's t against every lane, in scene order and blocks:
    (kind, first index, t [n, L]); t is inf where the test misses, where
    t <= t_min, or where the primitive's box does not admit the lane
    within [t_min, t_max]."""
    L = d[0].shape[0]
    row = lambda v: tuple(c[None] for c in v)
    o_r, d_r, tmin_r, tmax_r = row(o), row(d), t_min[None], t_max[None]
    inv = row(tuple(1.0 / c for c in d))
    sh = shear(d)
    sh_r = (row(sh[0]), row(sh[1]))
    T, S = pr.tri_geom.shape[0], pr.spheres.shape[0]
    step = max(1, chunk // max(L, 1))
    blocks = [(0, r0, min(T, r0 + step)) for r0 in range(0, T, step)]
    if S:
        blocks.append((1, 0, S))
    if pr.discs.shape[0]:
        blocks.append((2, 0, pr.discs.shape[0]))
    for kind, i0, i1 in blocks:
        if kind == 0:
            p = tuple(tuple(c[i0:i1, None] for c in corner) for corner in pr.p)
            t = triangle(p, o_r, sh_r)[0]
            b0 = 0
        elif kind == 1:
            sp = pr.spheres[:, None]
            t = sphere(o_r, d_r, tmin_r, _vec(sp, 0), sp[..., 3])
            b0 = T
        else:
            dc = pr.discs[:, None]
            t = disc(o_r, d_r, _vec(dc, 0), _vec(dc, 3), dc[..., 6],
                     zero_origin)
            b0 = T + S
        box = slab(tuple(c[b0 + i0:b0 + i1, None] for c in pr.box_lo),
                   tuple(c[b0 + i0:b0 + i1, None] for c in pr.box_hi),
                   o_r, inv, tmin_r, tmax_r)
        yield kind, i0, torch.where((t > tmin_r) & box, t, G.INF)


def closest(pr: Prims, o, d, t_min, zero_origin: bool):
    """The closest hit over every primitive: (t [L], inf where none; kind
    [L]: 0 triangle, 1 sphere, 2 disc, -1 none; index [L] within its
    kind)."""
    L, dev = d[0].shape[0], d[0].device
    best = torch.full_like(d[0], G.INF)
    kind = torch.full((L,), -1, dtype=torch.int64, device=dev)
    idx = torch.zeros(L, dtype=torch.int64, device=dev)
    t_max = torch.full_like(d[0], G.INF)
    for k, i0, t in _candidates(pr, o, d, t_min, t_max, zero_origin):
        bt = torch.amin(t, dim=0)
        first = torch.arange(t.shape[0], device=dev)[:, None]
        bi = torch.amin(torch.where(t <= bt[None], first, t.shape[0]), dim=0)
        upd = bt < best
        best = torch.where(upd, bt, best)
        kind = torch.where(upd, k, kind)
        idx = torch.where(upd, bi + i0, idx)
    return best, kind, idx


def occluded(pr: Prims, o, d, t_min, t_max) -> torch.Tensor:
    """Whether any primitive is hit strictly inside (t_min, t_max)."""
    occ = torch.zeros(d[0].shape, dtype=torch.bool, device=d[0].device)
    for _, _, t in _candidates(pr, o, d, t_min, t_max, False):
        occ |= (t < t_max[None]).any(dim=0)
    return occ


def _unit(v):
    n = torch.clamp_min(G.sqrt_cr(dot_sum(v, v)), G.TINY)
    return tuple(c / n for c in v)


def _cross(a, b):
    return tuple(fma(a[i], b[j], -(a[j] * b[i]))
                 for i, j in ((1, 2), (2, 0), (0, 1)))


def _pick(v, i):
    return tuple(c[i] for c in v)


def aovs(pr: Prims, rows, cols, *, w: int, h: int, fov: float,
         light=LIGHT, ambient=AMBIENT) -> dict:
    """Every AOV of the pixels (rows, cols) [P] (tensors of the
    reference's float type): a dict of tensors, each [P] or [P, 3]."""
    d = camera_dirs(rows, cols, w, h, fov)
    zero = torch.zeros_like(d[0])
    o = (zero, zero, zero)
    t, kind, idx = closest(pr, o, d, zero, zero_origin=True)
    found = kind >= 0
    is_tri, is_sph, is_dsc = kind == 0, kind == 1, kind == 2

    # the shading normal after the fact
    T, S, D = (pr.tri_geom.shape[0], pr.spheres.shape[0],
               pr.discs.shape[0])
    default = (zero, zero, zero + 1.0)
    if T:
        ti = torch.clamp(torch.where(is_tri, idx, 0), 0, T - 1)
        p0, p1, p2 = (_pick(c, ti) for c in pr.p)
        _, b0, b1, b2 = triangle((p0, p1, p2), o, shear(d))
        geo_n = _unit(_cross(tuple(p1[a] - p0[a] for a in range(3)),
                             tuple(p2[a] - p0[a] for a in range(3))))
        nv = [_pick(c, ti) for c in pr.corner_n]
        interp = _unit(tuple(fma(nv[2][a], b2, fma(nv[0][a], b0,
                                                     nv[1][a] * b1))
                             for a in range(3)))
        has = pr.has_n[ti]
        tri_n = tuple(torch.where(has, interp[a], geo_n[a]) for a in range(3))
        geom = torch.where(is_tri, pr.tri_geom[ti], MISS_GEOM)
        prim = torch.where(is_tri, pr.tri_prim[ti], -1)
    else:
        tri_n = default
        geom = torch.full_like(kind, MISS_GEOM)
        prim = torch.full_like(kind, -1)
    hp_t = torch.where(found, t, 0.0)
    n = tri_n
    if S:
        si = torch.clamp(torch.where(is_sph, idx, 0), 0, S - 1)
        c = _vec(pr.spheres[si], 0)
        sph_n = _unit(tuple(fma(d[a], hp_t, -c[a]) for a in range(3)))
        n = tuple(torch.where(is_sph, sph_n[a], n[a]) for a in range(3))
        geom = torch.where(is_sph, pr.n_meshes + si, geom)
        prim = torch.where(is_sph, 0, prim)
    if D:
        di = torch.clamp(torch.where(is_dsc, idx, 0), 0, D - 1)
        dsc_n = _vec(pr.discs[di], 0)
        n = tuple(torch.where(is_dsc, dsc_n[a], n[a]) for a in range(3))
        geom = torch.where(is_dsc, pr.n_meshes + S + di, geom)
        prim = torch.where(is_dsc, 0, prim)
    normal = tuple(torch.where(found, n[a], default[a]) for a in range(3))

    # the light ray, pushed off the surface, and its any-hit test
    hit_p = tuple(d[a] * hp_t for a in range(3))
    lo = tuple(fma(-d[a], hp_t, float(np.float32(light[a])))
               for a in range(3))
    dist = G.sqrt_cr(dot_sum(lo, lo))
    sdir = tuple(c / torch.clamp_min(dist, G.TINY) for c in lo)
    mag = 1.0 + G.o_mag(hit_p)
    sgn = torch.sign(dot_sum(normal, sdir))
    sgn = torch.where(sgn == 0.0, 1.0, sgn)
    m_off = mag * G.RAY_EPS * sgn
    so = tuple(fma(normal[a], m_off, hit_p[a]) for a in range(3))
    occ = occluded(pr, so, sdir, zero, dist)

    # the shading
    albedo = pr.albedo[torch.clamp(geom, 0, pr.albedo.shape[0] - 1)]
    lam = torch.where(occ, 0.0, dot_sum(sdir, normal))
    rgb = fma(albedo, float(np.float32(ambient)), lam[:, None] * albedo)
    return dict(
        rgb=torch.where(found[:, None], rgb, 0.0),
        t=torch.where(found, t, G.INF),
        geom_id=torch.where(found, geom, MISS_GEOM),
        prim_id=torch.where(found, prim, -1),
        normal=torch.stack(normal, 1),
        hit_p=torch.where(found[:, None], torch.stack(hit_p, 1), 0.0))
