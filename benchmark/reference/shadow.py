"""The plain shadow trace: every AOV of single pixels of a shadow-traced
frame, from the scene description.

For a camera ray through the pixel centre (origin 0, the image plane
across the horizontal field of view): the nearest triangle by the
watertight row test, then a strictly nearer sphere, then a strictly
nearer disc; the shading normal (the triangle's, the sphere's radial,
the disc's), the hit point, one shadow ray to the point light pushed off
the surface along the normal towards the light, occlusion by anything
nearer than the light; ``rgb = albedo * ambient + lambert * albedo``
(lambert 0 when occluded), 0 on a miss. AOVs: rgb, t (inf on a miss),
geom_id (-1), prim_id (-1), normal ((0, 0, 1) on a miss), hit_p (0).

The arithmetic follows the upstream JAX shadow trace as XLA compiles it
on f32: a product feeding a sum or difference is fused (``G.fma``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import geometry as G
from .geometry import dot_fused, dot_sum, fma

LIGHT = (18.0, 257.0, -1060.0)
AMBIENT = 0.05


def camera_dirs(rows, cols, w: int, h: int, fov: float):
    """Unit directions [P, 3] through pixel (row, col), unjittered."""
    f32 = np.float32
    tan = float(f32(np.tan(np.float64(f32(fov) / f32(2.0)))))
    aspect = f32(w) / f32(h)
    sx = float(f32(f32(2.0) * aspect) * f32(tan))
    sy = float(f32(-2.0) * f32(tan))
    xn = fma(cols, float(f32(1.0) / f32(w)), -0.5)
    yn = fma(rows, float(f32(1.0) / f32(h)), -0.5)
    dx, dy = xn * sx, yn * sy
    n = G.sqrt_cr(fma(dy, dy, dx * dx) + 1.0)
    return (dx / n, dy / n, -1.0 / n)


def _spheres(tb, o, d, t_min):
    rd2 = 1.0 / dot_fused(d, d)
    cur_t = torch.full_like(d[0], G.INF)
    cur_i = torch.zeros(d[0].shape, dtype=torch.int64, device=d[0].device)
    for s in range(tb.ap_s.shape[0]):
        c, r2 = tuple(tb.ap_s[s, k] for k in range(3)), tb.ap_s[s, 3]
        oc = tuple(c[a] - o[a] for a in range(3))
        tca = dot_fused(oc, d) * rd2
        lv = tuple(fma(-d[a], tca, oc[a]) for a in range(3))
        l2 = dot_fused(lv, lv)
        td = G.sqrt_cr(torch.clamp_min(r2 - l2, 0.0)) * rd2
        t0, t1 = tca - td, tca + td
        t = torch.where(t0 < t_min, t1, t0)
        miss = (tca < 0.0) | (l2 > r2) | (t < t_min) | (r2 <= 0.0)
        t = torch.where(miss | (t <= t_min), G.INF, t)
        upd = t < cur_t
        cur_t = torch.where(upd, t, cur_t)
        cur_i = torch.where(upd, s, cur_i)
    return cur_t, cur_i


def _discs(tb, o, d, t_min):
    cur_t = torch.full_like(d[0], G.INF)
    cur_i = torch.zeros(d[0].shape, dtype=torch.int64, device=d[0].device)
    for s in range(tb.ap_d.shape[0]):
        a = tb.ap_d[s]
        nv, c, r2, doff = (a[0], a[1], a[2]), (a[3], a[4], a[5]), a[6], a[7]
        angle = dot_fused(d, nv)
        t = -(dot_fused(o, nv) + doff) / angle
        hp = tuple(fma(d[k], t, o[k]) - c[k] for k in range(3))
        ok = ((angle != 0.0) & (t > G.EPS_MACH) & (dot_fused(hp, hp) < r2)
              & (r2 > 0.0) & (t > t_min))
        t = torch.where(ok, t, G.INF)
        upd = t < cur_t
        cur_t = torch.where(upd, t, cur_t)
        cur_i = torch.where(upd, s, cur_i)
    return cur_t, cur_i


def _unit(v):
    n = torch.clamp_min(G.sqrt_cr(dot_sum(v, v)), G.TINY)
    return tuple(c / n for c in v)


def aovs(tb: G.Tables, rows, cols, *, w: int, h: int, fov: float,
         light=LIGHT, ambient=AMBIENT) -> dict:
    """Every AOV of the pixels (rows, cols) [P] (tensors of the
    reference's float type): a dict of tensors, each [P] or [P, 3]."""
    dt, dev = rows.dtype, rows.device
    d = camera_dirs(rows, cols, w, h, fov)
    zero = torch.zeros_like(d[0])
    o = (zero, zero, zero)
    t_min = zero
    best, tri = G.closest_rows(tb, o, d, t_min, torch.full_like(zero, G.INF),
                               fused=True)
    found_tri = tri >= 0
    r = torch.clamp_min(tri, 0)
    # the raw shading normal of the winning row (f32 barycentrics)
    if tb.rows.shape[0]:
        _, b1, b2, _, _ = G.row_chain_lane(tb.rows[r], o, d, fused=True)
        n_raw = tuple(torch.where(found_tri, tb.n0[r, c] + (
            tb.dn1[r, c] * b1 + tb.dn2[r, c] * b2), 0.0) for c in range(3))
    else:
        n_raw = (zero, zero, zero)
    st, si = _spheres(tb, o, d, t_min)
    sb = st < best
    best = torch.where(sb, st, best)
    dtt, di = _discs(tb, o, d, t_min)
    db = dtt < best
    best = torch.where(db, dtt, best)
    found = found_tri | sb | db
    hit_t = torch.where(found, best, G.INF)

    # the shadow ray, as the kernel forms it
    kinv = torch.clamp_min(G.sqrt_cr(dot_fused(n_raw, n_raw)), G.TINY)
    kn = tuple(c / kinv for c in n_raw)
    hp_t = torch.where(found, hit_t, 0.0)
    hit_p = tuple(fma(d[c], hp_t, o[c]) for c in range(3))
    n_sph = tb.ap_s.shape[0]
    if n_sph:
        sc = tb.ap_s[torch.clamp(si, 0, n_sph - 1), :3]
        spn = tuple(hit_p[c] - sc[:, c] for c in range(3))
        sinv = torch.clamp_min(G.sqrt_cr(dot_fused(spn, spn)), G.TINY)
        spn = tuple(c / sinv for c in spn)
    else:
        spn = kn
    if tb.ap_d.shape[0]:
        dnv = tb.ap_d[torch.clamp(di, 0, tb.ap_d.shape[0] - 1), :3]
        d_n = tuple(dnv[:, c] for c in range(3))
    else:
        d_n = kn
    default_n = (0.0, 0.0, 1.0)
    knormal = tuple(torch.where(found, torch.where(db, d_n[c], torch.where(
        sb, spn[c], kn[c])), default_n[c]) for c in range(3))
    loff = tuple(float(np.float32(light[c])) - hit_p[c] for c in range(3))
    dist = G.sqrt_cr(dot_fused(loff, loff))
    sdir = tuple(c / torch.clamp_min(dist, G.TINY) for c in loff)
    mag = 1.0 + G.o_mag(hit_p)
    sgn = torch.sign(dot_fused(knormal, sdir))
    sgn = torch.where(sgn == 0.0, 1.0, sgn)
    m_off = mag * G.RAY_EPS * sgn
    so = tuple(fma(knormal[c], m_off, hit_p[c]) for c in range(3))
    s_t, s_row = G.closest_rows(tb, so, sdir, t_min, dist.clone(), fused=True)
    s_best = torch.where(s_row >= 0, s_t, dist)
    sst, _ = _spheres(tb, so, sdir, t_min)
    ssb = sst < s_best
    s_best = torch.where(ssb, sst, s_best)
    sdt, _ = _discs(tb, so, sdir, t_min)
    sdb = sdt < s_best
    s_best = torch.where(sdb, sdt, s_best)
    s_found = (s_row >= 0) | ssb | sdb
    occ = s_found & (torch.where(s_found, s_best, dist) < dist)

    # the epilogue: ids, normals, hit point, light direction, shading
    geom = torch.where(found_tri, tb.tri_geom[r], -1)
    prim = torch.where(found_tri, tb.tri_prim[r], -1)
    geom = torch.where(sb, tb.n_meshes + si, geom)
    prim = torch.where(sb, 0, prim)
    geom = torch.where(db, tb.n_meshes + n_sph + di, geom)
    prim = torch.where(db, 0, prim)
    tri_n = _unit(n_raw)
    if n_sph:
        cen = tb.ap_s[torch.clamp(si, 0, n_sph - 1), :3]
        sph_n = _unit(tuple(fma(d[c], hit_t, -cen[:, c]) for c in range(3)))
    else:
        sph_n = tri_n
    normal = tuple(torch.where(db, d_n[c], torch.where(sb, sph_n[c], tri_n[c]))
                   for c in range(3))
    normal = tuple(torch.where(found, normal[c], default_n[c]) for c in range(3))
    hit_p = tuple(d[c] * hp_t for c in range(3))
    lo = tuple(fma(-d[c], hp_t, float(np.float32(light[c]))) for c in range(3))
    ldist = G.sqrt_cr(dot_sum(lo, lo))
    ldir = tuple(c / torch.clamp_min(ldist, G.TINY) for c in lo)
    mat = tb.mat_ids[torch.clamp(geom, 0, tb.mat_ids.shape[0] - 1)]
    albedo = tb.mat_albedo[mat]
    lam = torch.where(occ, 0.0, dot_sum(ldir, normal))
    rgb = fma(albedo, float(np.float32(ambient)), lam[:, None] * albedo)
    rgb = torch.where(found[:, None], rgb, 0.0)
    return dict(
        rgb=rgb, t=torch.where(found, hit_t, G.INF),
        geom_id=torch.where(found, geom, -1), prim_id=prim,
        normal=torch.stack(normal, 1),
        hit_p=torch.where(found[:, None], torch.stack(hit_p, 1), 0.0))
