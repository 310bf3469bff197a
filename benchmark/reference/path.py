"""The plain path tracer: single pixels of a streaming path-traced frame,
worked out from the scene description and the renderer's contract.

The contract (upstream's streaming renderer as the port keeps it):

* the window's pixels form a stream in 32 x 32 tiles, tile rows first;
* a pool of R slots serves the stream: slot s owns stream positions
  s + j*R, j < J; R is the chunk rounded up to a multiple of 256 and no
  larger than the frame needs, J = ceil(pixels / R). A sharded frame
  cuts the stream into one slice of ``ceil(pixels / n)`` per replica,
  each served by a pool of R = min(chunk, slice) slots, J = ceil(slice / R);
* spp renders in batches of at most 64 samples and 2,048 paths per slot;
  batch bi is seeded ``seed + 0x9E3779B9 * bi`` (a sharded frame: each
  replica's jump-separated seed plus ``0x85EBCA6B * bi``), and within a
  batch of b samples path i of the pixel at j has the id
  ``pid = slot * J * b + j * b + i``;
* a path starts at the camera, jittered by ``normal2(pid, seed, 0xCA3)``
  times the anti-alias scale, and at each bounce draws
  ``uniform01(pid, bounce + 7 + seed, c)``, c < 4: a cosine sample of
  the diffuse lobe (two numbers), the Fresnel choice, the roulette;
* the nearest surface wins: triangles by the watertight row test (its
  barycentrics rounded to bf16 for the shading normal), then a sphere or
  disc only when strictly nearer; emission is added on every hit, the
  throughput takes the albedo, and past ``roulette_start_depth`` bounces
  the roulette keeps a path with probability max(throughput);
* with an environment light, a path that escapes adds throughput x
  env(direction);
* a batch's pixel is the sum of its b path colours, in path order,
  times f32(1/b); batches add as ``flat * f32(b / spp)`` in batch order.

Each lane here is one path of one pixel, traced to its end; nothing is
shared with the system under test.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import geometry as G
from .rng import GOLDEN, MASK, normal2, replica_seeds, uniform01

TILE = 32
SPP_BATCH = 64
MAX_K = 2048
PI_BY_2 = float(np.float32(np.pi / 2.0))
PI_BY_4 = float(np.float32(np.pi / 4.0))


@functools.lru_cache(maxsize=4)
def stream_order(w: int, h: int) -> np.ndarray:
    """Raster index of each stream position (tile rows, tile columns,
    then rows and columns within the tile)."""
    rr, cc = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return np.lexsort((cc.ravel() % TILE, rr.ravel() % TILE,
                       cc.ravel() // TILE, rr.ravel() // TILE))


@functools.lru_cache(maxsize=4)
def stream_position(w: int, h: int) -> np.ndarray:
    """Stream position of each raster index."""
    inverse = np.empty(w * h, np.int64)
    inverse[stream_order(w, h)] = np.arange(w * h)
    return inverse


def _batches(spp: int, J: int):
    b_cap = max(1, MAX_K // J)
    out, s = [], 0
    while s < spp:
        b = min(SPP_BATCH, b_cap, spp - s)
        out.append(b)
        s += b
    return out


def path_ids(frame_seed: int, pixels: np.ndarray, w: int, h: int, spp: int,
             chunk: int, shards: int | None):
    """The ids of every path of the raster ``pixels``: a list over spp
    batches of (b, seeds [P] u32, pids [P, b] i64), and the pixels'
    (row, col)."""
    n_pix = w * h
    q = stream_position(w, h)[pixels]
    if shards is None:
        R = min(chunk, n_pix)
        R = min(-(-R // 256) * 256, -(-n_pix // 256) * 256)
        J = -(-n_pix // R)
        shard = np.zeros_like(q)
        ql = q
    else:
        per = -(-n_pix // shards)
        R = min(chunk, per)
        J = -(-per // R)
        shard, ql = q // (R * J), q % (R * J)
    slot, j = ql % R, ql // R
    out = []
    for bi, b in enumerate(_batches(spp, J)):
        if shards is None:
            seeds = np.full(len(q), (frame_seed + GOLDEN * bi) & MASK, np.int64)
        else:
            per_rep = replica_seeds(frame_seed, shards, bi)
            seeds = np.array([per_rep[s] for s in shard], np.int64)
        pids = (slot * (J * b) + j * b)[:, None] + np.arange(b)[None]
        out.append((b, seeds, pids))
    return out, pixels // w, pixels % w


def camera(rows, cols, g1, g2, w, h, fov, aa, dt):
    """Camera rays through pixel (row, col) jittered by (g1, g2) * aa:
    origin (0, 0, -RAY_EPS), the image plane at z = -1 across the
    horizontal field of view."""
    tan = float(np.tan(fov / 2.0))
    f = lambda x: float(np.float32(x))
    sx, sy = f(2.0 * (w / h) * tan), f(-2.0 * tan)
    pu = rows + g1 * f(aa)
    pv = cols + g2 * f(aa)
    xn = pv * f(1.0 / w) - 0.5
    yn = pu * f(1.0 / h) - 0.5
    d = normalize3((xn * sx, yn * sy, torch.full_like(xn, -1.0)))
    z = torch.zeros_like(xn)
    return (z, z, torch.full_like(xn, -G.RAY_EPS)), d


def inv_sqrt(x):
    return torch.reciprocal(torch.sqrt(torch.clamp_min(x, 1e-30)))


def normalize3(v):
    il = inv_sqrt(G.dot_plain(v, v))
    return (v[0] * il, v[1] * il, v[2] * il)


def where3(m, a, b):
    return tuple(torch.where(m, x, y) for x, y in zip(a, b))


def add3(a, b):
    return tuple(x + y for x, y in zip(a, b))


def scale3(v, s):
    return tuple(x * s for x in v)


def cross3(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def sample_diffuse(n, u1, u2):
    """Cosine-weighted direction about n by the concentric disc map."""
    use_x = torch.abs(n[0]) > torch.abs(n[1])
    ilx = inv_sqrt(n[0] * n[0] + n[2] * n[2])
    ily = inv_sqrt(n[1] * n[1] + n[2] * n[2])
    z0 = torch.zeros_like(n[0])
    v2 = where3(use_x, (-n[2] * ilx, z0, n[0] * ilx),
                (z0, n[2] * ily, -n[1] * ily))
    v3 = cross3(n, v2)
    ux, uy = 2.0 * u1 - 1.0, 2.0 * u2 - 1.0
    use_ux = torch.abs(ux) > torch.abs(uy)
    r = torch.where(use_ux, ux, uy)
    sx = torch.where(ux == 0.0, 1.0, ux)
    sy = torch.where(uy == 0.0, 1.0, uy)
    th = torch.where(use_ux, (uy / sx) * PI_BY_4, PI_BY_2 - (ux / sy) * PI_BY_4)
    zz = (ux == 0.0) & (uy == 0.0)
    x = torch.where(zz, 0.0, r * torch.cos(th))
    y = torch.where(zz, 0.0, r * torch.sin(th))
    z = torch.sqrt(torch.clamp_min(1.0 - x * x - y * y, 0.0))
    return add3(add3(scale3(v2, x), scale3(v3, y)), scale3(n, z))


def reflect(d, n):
    ct = G.dot_plain(d, n)
    return normalize3(add3(d, scale3(n, -2.0 * ct)))


def dielectric(d, n_in, ior, u):
    """Schlick-weighted choice between reflection and refraction."""
    entering = G.dot_plain(n_in, d) <= 0.0
    n = where3(entering, n_in, scale3(n_in, -1.0))
    ri = torch.where(entering, torch.reciprocal(ior), ior)
    c1 = -G.dot_plain(n, d)
    c2 = 1.0 - ri * ri * (1.0 - c1 * c1)
    r0 = (1.0 - ri) / (1.0 + ri)
    r0 = r0 * r0
    base = 1.0 - c1
    schlick = r0 + (1.0 - r0) * base * base * base * base * base
    refr = (c2 > 0.0) & (u > schlick)
    perp = scale3(add3(d, scale3(n, c1)), ri)
    par = torch.sqrt(torch.abs(1.0 - G.dot_plain(perp, perp)))
    return where3(refr, add3(perp, scale3(n, -par)), reflect(d, n)), refr


def offset_origin(p, n, d):
    mag = 1.0 + G.o_mag(p)
    sgn = torch.sign(G.dot_plain(n, d))
    sgn = torch.where(sgn == 0.0, 1.0, sgn)
    return add3(p, scale3(n, mag * G.RAY_EPS * sgn))


def analytic(tb: G.Tables, o, d, best_t):
    """Nearest sphere or disc strictly nearer than ``best_t``: (t, kind
    (1 sphere, 2 disc), index); t = inf where none (ties: spheres first,
    then the lower index)."""
    cand_t, cand_k, cand_i = [], [], []
    for i in range(tb.ap_s.shape[0]):
        c, r2 = tb.ap_s[i, :3], tb.ap_s[i, 3]
        oc = (c[0] - o[0], c[1] - o[1], c[2] - o[2])
        tca = G.dot_plain(oc, d)
        l2 = G.dot_plain(oc, oc) - tca * tca
        td = torch.sqrt(torch.clamp_min(r2 - l2, 0.0))
        t0 = tca - td
        t = torch.where(t0 < 0.0, tca + td, t0)
        ok = (r2 > 0.0) & (tca >= 0.0) & (l2 <= r2) & (t > 0.0)
        cand_t.append(torch.where(ok, t, G.INF))
        cand_k.append(1)
        cand_i.append(i)
    for i in range(tb.ap_d.shape[0]):
        a = tb.ap_d[i]
        nv, c, r2, doff = (a[0], a[1], a[2]), (a[3], a[4], a[5]), a[6], a[7]
        dn = G.dot_plain(nv, d)
        on = G.dot_plain(nv, o)
        t = -(on + doff) / torch.where(dn == 0.0, 1.0, dn)
        hp = tuple(o[k] + d[k] * t - c[k] for k in range(3))
        ok = (r2 > 0.0) & (dn != 0.0) & (t > 0.0) & (G.dot_plain(hp, hp) < r2)
        cand_t.append(torch.where(ok, t, G.INF))
        cand_k.append(2)
        cand_i.append(i)
    L = best_t.shape[0]
    bt = torch.full_like(best_t, G.INF)
    kind = torch.zeros(L, dtype=torch.int64, device=best_t.device)
    idx = torch.zeros_like(kind)
    for t, k, i in zip(cand_t, cand_k, cand_i):
        t = torch.where(t < best_t, t, G.INF)
        upd = t < bt
        bt = torch.where(upd, t, bt)
        kind = torch.where(upd, k, kind)
        idx = torch.where(upd, i, idx)
    return bt, kind, idx


def trace(tb: G.Tables, o, d, pid, seed, max_len: int, rr_depth: int,
          lane_chunk: int = 1 << 16):
    """Trace one path per lane to its end: (colour, throughput, escaped,
    direction) at its end, the records the environment term reads."""
    outs = []
    for l0 in range(0, pid.shape[0], lane_chunk):
        sl = slice(l0, l0 + lane_chunk)
        outs.append(_trace(tb, tuple(c[sl] for c in o),
                           tuple(c[sl] for c in d), pid[sl], seed[sl],
                           max_len, rr_depth))
    return tuple(torch.cat(x) for x in zip(*outs))


def _trace(tb, o, d, pid, seed, max_len, rr_depth):
    dt, dev = d[0].dtype, d[0].device
    L = pid.shape[0]
    one = torch.ones(L, dtype=dt, device=dev)
    tp = (one, one, one)
    color = (one * 0, one * 0, one * 0)
    active = torch.ones(L, dtype=torch.bool, device=dev)
    out_c, out_tp = [torch.zeros(L, dtype=dt, device=dev) for _ in range(3)], \
        [torch.zeros(L, dtype=dt, device=dev) for _ in range(3)]
    out_d = [torch.zeros(L, dtype=dt, device=dev) for _ in range(3)]
    out_esc = torch.zeros(L, dtype=torch.bool, device=dev)
    bounce = 0
    lanes = torch.arange(L, device=dev)
    while lanes.numel():
        best_t = torch.full((lanes.numel(),), G.INF, dtype=dt, device=dev)
        t_min = torch.zeros_like(best_t)
        best_t, row = G.closest_rows(tb, o, d, t_min, best_t, fused=False)
        has = row >= 0
        r = torch.clamp_min(row, 0)
        zero = torch.zeros_like(best_t)
        if tb.rows.shape[0]:
            b1, b2 = G.barycentrics(tb, row, o, d, fused=False)
            b1 = b1.to(torch.bfloat16).to(dt)
            b2 = b2.to(torch.bfloat16).to(dt)
            nx = tuple(tb.n0[r, c] + (tb.dn1[r, c] * b1 + tb.dn2[r, c] * b2)
                       for c in range(3))
            mat = tb.tri_mat[r]
            normal = normalize3(tuple(torch.where(has, v, 0.0) for v in nx))
            albedo = tuple(torch.where(has, tb.mat_albedo[mat, c], 0.0)
                           for c in range(3))
            mtype = torch.where(has, tb.mat_type[mat], 0)
            emis = has & tb.mat_emissive[mat]
            ior = torch.where(has, tb.mat_ior[mat], 0.0)
            em = tuple(torch.where(has, tb.mat_emission[mat, c], 0.0)
                       for c in range(3))
        else:
            normal = normalize3((zero, zero, zero))
            albedo = em = (zero, zero, zero)
            ior = zero
            mtype = torch.zeros_like(row)
            emis = torch.zeros_like(has)
        at, kind, ai = analytic(tb, o, d, best_t)
        apb = at < best_t
        best_t = torch.where(apb, at, best_t)
        n_sph = tb.ap_s.shape[0]
        geom = torch.where(kind == 1, tb.n_meshes + ai,
                           tb.n_meshes + n_sph + ai)
        amat = tb.mat_ids[torch.clamp(geom, 0, tb.mat_ids.shape[0] - 1)]
        albedo = where3(apb, tuple(tb.mat_albedo[amat, c] for c in range(3)),
                        albedo)
        ior = torch.where(apb, tb.mat_ior[amat], ior)
        mtype = torch.where(apb, tb.mat_type[amat], mtype)
        emis = torch.where(apb, tb.mat_emissive[amat], emis)
        em = where3(apb, tuple(tb.mat_emission[amat, c] for c in range(3)), em)
        hit = add3(o, scale3(d, best_t))
        if n_sph:
            cs = tb.ap_s[torch.clamp(ai, 0, n_sph - 1), :3]
            n_sph_v = normalize3(add3(hit, scale3(tuple(cs[:, c] for c in
                                                        range(3)), -1.0)))
        else:
            n_sph_v = normal
        if tb.ap_d.shape[0]:
            dn_v = tb.ap_d[torch.clamp(ai, 0, tb.ap_d.shape[0] - 1), :3]
            n_dsc_v = tuple(dn_v[:, c] for c in range(3))
        else:
            n_dsc_v = normal
        n_ap = where3(kind == 2, n_dsc_v, n_sph_v)
        normal = where3(apb, n_ap, normal)

        found = (best_t < 1e37) & (best_t > 0.0)
        live = found
        em_on = live & emis
        color = add3(color, where3(em_on, tuple(tp[c] * em[c] for c in
                                                range(3)), (zero,) * 3))
        rb = bounce + 7 + seed
        u0, u1, u2, u3 = (uniform01(pid, rb, c).to(dt) for c in range(4))
        dd = sample_diffuse(normal, u0, u1)
        ds = reflect(d, normal)
        dl, refr = dielectric(d, normal, ior, u2)
        is_d, is_s = mtype == 0, mtype == 1
        nd = where3(is_d, dd, where3(is_s, ds, dl))
        stp = live & (is_d | is_s | ((mtype == 2) & refr))
        tp = where3(stp, tuple(tp[c] * albedo[c] for c in range(3)), tp)
        o = where3(live, offset_origin(hit, normal, nd), o)
        d = where3(live, nd, d)
        p_r = torch.maximum(torch.maximum(tp[0], tp[1]), tp[2])
        stop = (p_r == 0.0) | (u3 > p_r)
        safe = torch.where(p_r == 0.0, 1.0, p_r)
        use_rr = bounce > rr_depth
        tp = where3(use_rr & live & ~stop, tuple(c / safe for c in tp), tp)
        killed = live & use_rr & stop
        escaped = ~found
        bounce += 1
        term = escaped | killed | (live & (bounce >= max_len))
        idx = lanes[term]
        for c in range(3):
            out_c[c][idx] = color[c][term]
            out_tp[c][idx] = tp[c][term]
            out_d[c][idx] = d[c][term]
        out_esc[idx] = escaped[term]
        keep = ~term
        lanes = lanes[keep]
        o, d, tp, color = (tuple(c[keep] for c in v) for v in (o, d, tp, color))
        pid, seed = pid[keep], seed[keep]
    return (torch.stack(out_c, 1), torch.stack(out_tp, 1), out_esc,
            torch.stack(out_d, 1))


def pixels(tb: G.Tables, frames, *, w: int, h: int, spp: int, chunk: int,
           shards: int | None, fov: float, aa: float, max_len: int,
           rr_depth: int, env=None, device="cpu", dt=torch.float32) -> list:
    """RGB [P, 3] (f32) of the raster pixels of each frame, as the
    contract above defines them; ``frames`` is a list of (frame seed,
    raster pixels [P]). ``env`` maps directions [N, 3] to radiance [N, 3]
    (None: escapes add nothing). Every frame's paths are traced together."""
    ids = [path_ids(fs, np.asarray(pix, np.int64), w, h, spp, chunk, shards)
           for fs, pix in frames]
    sizes = [len(pix) for _, pix in frames]
    P = sum(sizes)
    prow = np.concatenate([r for _, r, _ in ids])
    pcol = np.concatenate([c for _, _, c in ids])
    flat = None
    for bi, (b, _, _) in enumerate(ids[0][0]):
        seeds = np.concatenate([bt[bi][1] for bt, _, _ in ids])
        pids = np.concatenate([bt[bi][2] for bt, _, _ in ids])
        pid_t = torch.from_numpy(pids.reshape(-1)).to(device)
        seed_t = torch.from_numpy(np.repeat(seeds, b)).to(device)
        rows = torch.from_numpy(np.repeat(prow, b).astype(np.float32)).to(device, dt)
        cols = torch.from_numpy(np.repeat(pcol, b).astype(np.float32)).to(device, dt)
        g1, g2 = normal2(pid_t, seed_t, 0xCA3)
        o, d = camera(rows, cols, g1.to(dt), g2.to(dt), w, h, fov, aa, dt)
        col, tp, esc, dirs = trace(tb, o, d, pid_t, seed_t, max_len, rr_depth)
        if env is not None and bool(esc.any()):
            rad = torch.zeros_like(col)
            rad[esc] = env(dirs[esc]).to(dt)
            col = torch.where(esc[:, None], col + tp * rad, col)
        col = col.reshape(P, b, 3)
        acc = col[:, 0]
        for i in range(1, b):
            acc = acc + col[:, i]
        flat_b = acc * float(np.float32(1.0 / b))
        wgt = float(np.float32(b / spp))
        flat = flat_b * wgt if flat is None else flat + flat_b * wgt
    return list(torch.split(flat.to(torch.float32), sizes))


def escapes(tb: G.Tables, frame_seed: int, *, w: int, h: int, spp: int,
            chunk: int, fov: float, aa: float, max_len: int, rr_depth: int,
            device, block: int = 1 << 16) -> int:
    """The number of paths of a whole frame that escape the scene: the
    directions an environment light is evaluated on. It follows from the
    RNG contract alone, whatever implements the renderer."""
    n = 0
    allp = np.arange(w * h, dtype=np.int64)
    for p0 in range(0, w * h, block):
        pix = allp[p0:p0 + block]
        batches, prow, pcol = path_ids(frame_seed, pix, w, h, spp, chunk, None)
        for b, seeds, pids in batches:
            pid_t = torch.from_numpy(pids.reshape(-1)).to(device)
            seed_t = torch.from_numpy(np.repeat(seeds, b)).to(device)
            rows = torch.from_numpy(np.repeat(prow, b).astype(np.float32)).to(device)
            cols = torch.from_numpy(np.repeat(pcol, b).astype(np.float32)).to(device)
            g1, g2 = normal2(pid_t, seed_t, 0xCA3)
            o, d = camera(rows, cols, g1, g2, w, h, fov, aa, torch.float32)
            _, _, esc, _ = trace(tb, o, d, pid_t, seed_t, max_len, rr_depth,
                                 lane_chunk=1 << 21)
            n += int(esc.sum())
    return n
