"""K5's culled walk (ops/cuda/intersect.cu ``bundle_kernel`` with
ops/cuda/rows.cuh ``lane_admits``, ``walk_step`` and ``BundleSync``),
emulated in plain torch on the CPU, against the dense plain version that
defines its result (ops/intersect_kernel.py ``dense_walk_ref``) and
against the JAX package's K5 in interpret mode.

The kernel keeps every decision of a bundle: its list, walked in order,
and its stop check every ``CHECK_EVERY`` blocks on the max of best t over
all 1,024 lanes (one CTA, ``K5_CTAS``; K4's test reduces it as K4's
cluster of 4 CTAs does: each CTA's max, then their max in rank order).
Within a bundle a lane
tests a block only when ``lane_admits`` says a row of it may hold a hit
below its best t (the block's padded box, ops/tables.py
``padded_boxes``, in the lane's slab; or the block is unbounded). Per
block each CTA lists its admitting lanes and its warps share the work:
32 listed lanes against one of ``spread`` chunks of consecutive rows; a
thread keeps its lane's first strict minimum over the chunk by the order
key of t (+0 and -0 one key), the lane's slot keeps the least (key, row,
sign of t) by an atomic minimum, and the lane takes the t decoded from
it where it is strictly below its best. The
emulation spells those steps out and must give t, row, the payload n and
m, and ``pairs`` bit for bit as the dense walk does, on Cornell + monkey,
the Cornell box, ``_smooth_scene``, a grid of exact ties, and a UV sphere
with closed poles (whose pole slivers make a block unbounded), with
camera, bounce and random rays and with adversarial ones (grazing, along
box faces, through shared edges and vertices, at the pole slivers), at
every spread from 1 to 32. The (lane, block) pairs its lanes
test lie between ``needed_pairs`` and the dense walk's 1,024 per walked
block. The host tables are held too: every dense-walk winner's block is
unbounded, or the winner's lane admits it for a hit at the winner's t;
the padded boxes contain the AABBs.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import contextlib
import functools
import os

import numpy as np
import pytest
import torch

import ipu_ray_lib_tpu.scene.types as JT
from ipu_ray_lib_tpu.ops.pallas.intersect_kernel import (
    pallas_intersect as jax_intersect)
from ipu_ray_lib_tpu.scene.build import build_scene as jax_build_scene
from ipu_ray_lib_tpu.scene.builtin import make_cornell_box_scene as jax_cornell
import ipu_ray_lib_tpu_torch.scene.build as TB
import ipu_ray_lib_tpu_torch.scene.types as TT
from ipu_ray_lib_tpu_torch.ops import intersect_kernel as ik
from ipu_ray_lib_tpu_torch.ops.cull import BR, block_cull_lists_bundle
from ipu_ray_lib_tpu_torch.ops.intersect import INF
from ipu_ray_lib_tpu_torch.ops.intersect_kernel import (
    _EPS_CLAMP, CHECK_EVERY, count, lane_admits, o_mag, row_chain)
from ipu_ray_lib_tpu_torch.ops.tables import TB as ROWS
from ipu_ray_lib_tpu_torch.ops.tables import _row_regions
from ipu_ray_lib_tpu_torch.ops.vec3 import fma
from ipu_ray_lib_tpu_torch.scene.builtin import make_cornell_box_scene

from test_torch_hbm import _smooth_scene
from test_torch_intersect import _camera, _spread, _tie_rays, _tie_scene

MONKEY = os.path.join(os.path.dirname(__file__), "..", "assets",
                      "monkey_bust.glb")
NO_ROW = 1 << 40
NO_KEY = 0xFFFFFFFF
K5_CTAS = 1  # K5's bundle: one CTA of 1,024 threads (ops/cuda/intersect.cu)


def t_key(t):
    """rows.cuh t_key: the unsigned order key of f32 t (+0 and -0 one
    key), as int64."""
    u = torch.where(t == 0.0, 0.0, t).view(torch.int32).to(torch.int64)
    u = u & 0xFFFFFFFF
    return torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)


def culled_block(scene, blk, o, d, t_min, best_t, best_row, spread, cl,
                 tally, also=None):
    """One block per bundle (``blk`` [k]) as the kernel tests it for that
    bundle's lanes (vec3s of [k, 1, BR]; t_min, best_t, best_row [k, BR]),
    the bundle being ``cl`` CTAs of 1,024 / cl lanes; ``also`` [k, BR]
    narrows the admitting lanes further (K4's occlusion walk: lanes not
    yet occluded). Returns the new best t and row; ``tally`` gains the
    pairs and work tested."""
    k, nt = blk.shape[0], BR // cl
    o2, d2 = tuple(c[:, 0] for c in o), tuple(c[:, 0] for c in d)
    mine = lane_admits(scene.pbox[blk][:, None, :], o2, d2, t_min, best_t)
    if also is not None:
        mine = mine & also
    listed = mine.reshape(k, cl, nt).sum(dim=2)                  # [k, cl]
    tally["lane_pairs"] += int(listed.sum())
    tally["cta_blocks"] += int((listed > 0).sum())
    tally["work_items"] += int(((listed + 31) // 32).sum()) * spread
    pb = scene.p.view(-1, ROWS, 16)[blk]                         # [k, TB, 16]
    t, b1, b2, on, r = row_chain(lambda c: pb[..., c:c + 1], o, d)
    et = (pb[..., 14:15] + torch.abs(on)) * torch.abs(r)
    eps = torch.clamp_max(fma(pb[..., 13:14], o_mag(o) + et, pb[..., 12:13]),
                          _EPS_CLAMP)
    ok = ((torch.minimum(b1, b2) >= -eps) & (b1 + b2 <= 1.0 + eps)
          & (t > t_min[:, None]))                                # [k, TB, BR]
    # Chunk c holds rows [c*128 // spread, (c+1)*128 // spread); a thread
    # keeps its lane's first strict minimum over it by key, the lane's
    # slot the least (key, row) over the chunks, and the lane decodes t
    # from the key and t's sign.
    key = torch.where(ok, t_key(t), NO_KEY)
    rows = torch.arange(ROWS)[None, :, None]
    kmin = torch.full((k, BR), NO_KEY, dtype=torch.int64)
    rmin = torch.full((k, BR), NO_ROW, dtype=torch.int64)
    for c in range(spread):
        r0, r1 = c * ROWS // spread, (c + 1) * ROWS // spread
        if r0 == r1:
            continue
        kc = key[:, r0:r1]
        kb = kc.amin(dim=1)
        rb = torch.where(kc == kb[:, None], rows[:, r0:r1], NO_ROW).amin(dim=1)
        better = (kb < kmin) | ((kb == kmin) & (rb < rmin))
        kmin = torch.where(better, kb, kmin)
        rmin = torch.where(better, rb, rmin)
    sign = t.gather(1, torch.clamp(rmin, max=ROWS - 1)[:, None])[:, 0] < 0
    zero_neg = sign & (kmin == 0x80000000)
    u = torch.where(kmin >= 0x80000000, kmin & 0x7FFFFFFF, kmin ^ 0xFFFFFFFF)
    u = torch.where(zero_neg, 0x80000000, u)
    tw = u.to(torch.int32).view(torch.float32)  # the bits, wrapped to i32
    take = mine & (kmin != NO_KEY) & (tw < best_t)
    return (torch.where(take, tw, best_t),
            torch.where(take, blk[:, None] * ROWS + rmin, best_row))


def cluster_max(best_t, cl):
    """The bundles' max of best t [n, BR] as a cluster of ``cl`` CTAs
    reduces it (fmaxf: NaN ignored)."""
    parts = best_t.reshape(best_t.shape[0], cl, BR // cl)
    parts = torch.where(torch.isnan(parts), -INF, parts).amax(dim=2)
    m = parts[:, 0]
    for r in range(1, cl):
        m = torch.fmax(m, parts[:, r])
    return m


def make_culled_walk(scene, spread, cl, tally):
    """A stand-in for ops/intersect_kernel.py ``walk`` (the same
    arguments; one block per list entry) that walks as the kernel does."""

    def culled_walk(p, counts, order, dists, o, d, t_min, t_max, *,
                    members, check_every, stats=None, key="pairs"):
        assert members == 1
        n, n_list = counts.shape[0], order.shape[1]
        best_t = t_max.clone()
        best_row = torch.full((n, BR), -1, dtype=torch.int64)
        tested = torch.zeros(n, dtype=torch.int32)
        counts_l = counts.long()
        live = counts_l > 0
        j = 0
        while bool(live.any()):
            idx = torch.nonzero(live).squeeze(1)
            count(stats, key, idx.numel())
            tested += live.to(torch.int32)
            sel = lambda v: tuple(c[idx] for c in v)
            bt, br = culled_block(scene, order[idx, j].long(), sel(o), sel(d),
                                  t_min[idx], best_t[idx], best_row[idx],
                                  spread, cl, tally)
            best_t = best_t.index_put((idx,), bt)
            best_row = best_row.index_put((idx,), br)
            j += 1
            live = live & (j < counts_l)
            if j % check_every == 0 and j < n_list:
                live = live & ~(cluster_max(best_t, cl) < dists[:, j])
        return best_t, best_row, tested

    return culled_walk


@contextlib.contextmanager
def culled(module, scene, spread, cl, tally):
    """``module.walk`` (the plain versions' walk) replaced by the kernel's
    culled walk."""
    saved = module.walk
    module.walk = make_culled_walk(scene, spread, cl, tally)
    try:
        yield
    finally:
        module.walk = saved


def _tally():
    return {"lane_pairs": 0, "cta_blocks": 0, "work_items": 0}


# ---- the scenes and rays ----

def _uv_sphere(T, n_lat=8, n_lon=12):
    """A UV sphere with closed poles on a floor: the rings at the poles
    are vertices 1e-16 apart (sin(pi) in f64), whose triangles either
    vanish (north: the tables zero them) or are slivers with vanishing
    barycentric gradients (south), accepted anywhere on their planes."""
    th = np.linspace(0.0, np.pi, n_lat + 1)
    ph = np.linspace(0.0, 2 * np.pi, n_lon + 1)[:-1]
    tt, pp = np.meshgrid(th, ph, indexing="ij")
    nrm = np.stack([np.sin(tt) * np.cos(pp), np.cos(tt),
                    np.sin(tt) * np.sin(pp)], -1).reshape(-1, 3)
    idx = np.arange((n_lat + 1) * n_lon).reshape(n_lat + 1, n_lon)
    nx = np.roll(idx, -1, axis=1)
    a, b, c, dd = idx[:-1], idx[1:], nx[:-1], nx[1:]
    tris = np.concatenate([np.stack([a, b, c], -1).reshape(-1, 3),
                           np.stack([b, dd, c], -1).reshape(-1, 3)])
    scene = T.SceneDescription()
    quad = np.array([[0, 1, 2], [0, 2, 3]])
    scene.meshes = [
        T.HostMesh(triangles=tris, vertices=np.array([0.0, 0.0, -3.0]) + nrm),
        T.HostMesh(triangles=quad, vertices=np.array(
            [[-4, -1.2, 1], [4, -1.2, 1], [4, -1.2, -7], [-4, -1.2, -7]]))]
    zero = np.zeros(3, np.float32)
    scene.materials = [T.Material(np.array([0.7, 0.7, 0.7], np.float32),
                                  zero, T.MaterialType.DIFFUSE)]
    scene.mat_ids = [0, 0]
    scene.camera = T.Camera(horizontal_fov=float(np.pi / 3))
    scene.validate()
    return scene


def _unit(d):
    return (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)


def _adversarial(ts, n, seed):
    """Rays that graze the scene's block boxes, run along their faces, and
    pass through box corners and edges: origins on a box face (or just
    off it), directions in the face's plane or nearly so."""
    rng = np.random.default_rng(seed)
    b = ts.baabb.numpy()
    b = b[b[:, 0] < 1e30]
    pick = b[rng.integers(0, len(b), n)]
    lo, hi = pick[:, 0:3], pick[:, 3:6]
    o = rng.uniform(lo, hi).astype(np.float32)
    ax = rng.integers(0, 3, n)
    side = rng.integers(0, 2, n).astype(bool)
    o[np.arange(n), ax] = np.where(side[:, None], hi, lo)[np.arange(n), ax]
    d = rng.normal(size=(n, 3)).astype(np.float32)
    flat = rng.uniform(size=n) < 0.5
    d[np.arange(n), ax] = np.where(flat, 0.0,
                                   d[np.arange(n), ax] * np.float32(1e-6))
    corner = rng.uniform(size=n) < 0.2  # aimed at another box's corner
    tgt = np.where(rng.integers(0, 2, (n, 3)).astype(bool), lo, hi)
    d[corner] = (tgt[np.roll(np.arange(n), 1)] - o)[corner]
    d[np.linalg.norm(d, axis=1) == 0] = np.float32([0.0, 0.0, -1.0])
    # back the origins off along -d: the rays then cross the boxes
    back = rng.uniform(0, 3, (n, 1)).astype(np.float32) * (rng.uniform(
        size=(n, 1)) < 0.5)
    d = _unit(d)
    return (o - back * d).astype(np.float32), d


def _pole_rays(n, seed):
    """Rays from around the sphere of ``_uv_sphere`` aimed at its poles
    (the slivers' planes) and along them."""
    rng = np.random.default_rng(seed)
    c = np.array([0.0, 0.0, -3.0], np.float32)
    pole = c + np.where(rng.uniform(size=(n, 1)) < 0.5, 1.0, -1.0) * \
        np.array([0.0, 1.0, 0.0], np.float32)
    o = (c + rng.normal(0, 2.5, (n, 3))).astype(np.float32)
    tgt = pole + rng.normal(0, 0.05, (n, 3)).astype(np.float32)
    return o, _unit(tgt - o)


@functools.lru_cache(maxsize=None)
def _scene(name):
    """The port's scene (CPU, VMEM mode) and the JAX package's arrays."""
    desc = {"monkey": lambda T, c: c(MONKEY, box_only=False),
            "box": lambda T, c: c(None, box_only=False),
            "smooth": lambda T, c: _smooth_scene(T),
            "ties": lambda T, c: _tie_scene(T),
            "sphere": lambda T, c: _uv_sphere(T)}[name]
    ts, params = TB.build_scene(desc(TT, make_cornell_box_scene),
                                device="cpu", image_width=48, image_height=32,
                                intersector="pallas")
    arrays, _, _ = jax_build_scene(desc(JT, jax_cornell), image_width=48,
                                   image_height=32, intersector="pallas")
    return ts, params, arrays


def _bounce(ts, o, d, seed):
    """One diffuse bounce from the rays' hits (the plain K5), pushed off."""
    R = len(o)
    t, tri, n, _ = ik.pallas_intersect(
        ts, torch.from_numpy(o), torch.from_numpy(d), torch.zeros(R),
        torch.full((R,), INF))
    hit = (tri >= 0).numpy()
    p = o[hit] + d[hit] * t.numpy()[hit, None]
    n = n.numpy()[hit]
    rng = np.random.default_rng(seed)
    nd = _unit(rng.normal(size=p.shape))
    nd = np.where(np.sum(nd * n, 1, keepdims=True) < 0, -nd, nd)
    p = p + n * np.float32(1e-2) * (1.0 + np.abs(p).max(1, keepdims=True))
    return p.astype(np.float32), nd.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _rays(case):
    """(scene name, origins, directions, t_max) of one ray set."""
    scene, kind = case.split("-")
    ts, params, _ = _scene(scene)
    if kind == "camera":
        o, d = _camera(params)
    elif kind == "bounce":
        o, d = _bounce(ts, *_camera(params), 3)
    elif kind == "random":
        o, d = _spread(ts, 1500, 5)
    elif kind == "adversarial":
        o, d = _adversarial(ts, 1500, 6)
    elif kind == "ties":
        o, d = _tie_rays()
    elif kind == "poles":
        o, d = _pole_rays(1500, 8)
    t_max = np.full(len(o), np.inf, np.float32)
    t_max[::9] = 2.5  # finite bounds for some rays
    return scene, o, d, t_max


def inputs(case):
    """The culled, padded inputs of one K5 launch of a ray set."""
    scene, o, d, t_max = _rays(case)
    ts = _scene(scene)[0]
    R = len(o)
    args = ik.intersect_inputs(torch.from_numpy(o), torch.from_numpy(d),
                               torch.zeros(R), torch.from_numpy(t_max))
    lists = block_cull_lists_bundle(ts, *args[:4], args[4].shape[1] // BR)
    return ts, (*lists, args[4])


@functools.lru_cache(maxsize=None)
def _dense(case):
    ts, inp = inputs(case)
    return ik.dense_walk_ref(ts, *inp)


CASES = ["monkey-camera", "monkey-bounce", "monkey-random",
         "monkey-adversarial", "box-adversarial", "smooth-random",
         "ties-ties", "sphere-poles", "sphere-adversarial"]


def _culled(case, spread, cl):
    ts, inp = inputs(case)
    tally = _tally()
    with culled(ik, ts, spread, cl, tally):
        got = ik.dense_walk_ref(ts, *inp)
    return ts, inp, got, tally


def _hold(case, got, tally, ts, inp):
    want = _dense(case)
    for g, w, name in zip(got, want, ("t", "row", "n", "m", "pairs")):
        assert torch.equal(g, w), name
    need = ik.needed_pairs(ts, inp[1], inp[3], want[0], want[4], members=1)
    assert need <= tally["lane_pairs"] <= int(want[4].sum()) * BR
    return want


@pytest.mark.parametrize("case", CASES)
def test_culled_walk_equals_the_dense_walk(case):
    ts, inp, got, tally = _culled(case, 8, K5_CTAS)
    want = _hold(case, got, tally, ts, inp)
    assert int((want[1] >= 0).sum()) > 50
    if case not in ("ties-ties",):  # the cull skips work
        assert tally["lane_pairs"] < int(want[4].sum()) * BR


@pytest.mark.parametrize("spread", range(1, 33))
def test_every_spread(spread):
    """Adversarial rays and exact ties at each spread (1: one chunk of all
    128 rows; 32: 32 chunks of 4 rows)."""
    for case in ("monkey-adversarial", "ties-ties"):
        ts, inp, got, tally = _culled(case, spread, K5_CTAS)
        _hold(case, got, tally, ts, inp)
        assert tally["lane_pairs"] > 0
        assert tally["work_items"] >= tally["cta_blocks"] * spread


def test_closed_poles_make_a_block_unbounded():
    ts = _scene("sphere")[0]
    kind = _row_regions(ts.p)[0]
    assert int((kind == 1).sum()) >= 8 and int((kind == -1).sum()) >= 8
    assert int((ts.pbox[:, 7] == 1).sum()) >= 1
    # The sliver rays do hit the unbounded block's rows.
    want = _dense("sphere-poles")
    rows = want[1][want[1] >= 0].long()
    assert bool((ts.pbox[rows // ROWS, 7] == 1).any())


@pytest.mark.parametrize("case", CASES)
def test_winners_lie_in_their_padded_boxes(case):
    """Host tables: every dense-walk winner's block is unbounded, or the
    winner's lane admits it for a hit just above the winner's t (a hit at
    t < best t is admitted); the padded boxes contain the AABBs."""
    ts, inp = inputs(case)
    t, row = _dense(case)[:2]
    hit = row >= 0
    rays = inp[3]
    o = tuple(rays[a][hit] for a in range(3))
    d = tuple(rays[a][hit] for a in range(3, 6))
    box = ts.pbox[row[hit].long() // ROWS]
    above = torch.nextafter(t[hit], torch.tensor(INF))
    ok = (box[:, 7] == 1) | lane_admits(box, o, d, rays[6][hit], above)
    assert int(hit.sum()) > 50 and bool(ok.all())
    real = ts.baabb[:, 0] < 1e30
    assert bool((ts.pbox[real, 0:3] <= ts.baabb[real, 0:3]).all())
    assert bool((ts.pbox[real, 3:6] >= ts.baabb[real, 3:6]).all())
    assert bool((ts.pbox[real, 6] > 0).all())


@pytest.mark.parametrize("case", ["monkey-camera", "monkey-adversarial",
                                  "ties-ties", "sphere-poles"])
def test_culled_walk_equals_the_jax_kernel(case):
    """``pallas_intersect`` of the port with its walk culled as the kernel
    culls it: (t, triangle, normal, payload) equal the JAX package's K5
    in interpret mode."""
    scene, o, d, t_max = _rays(case)
    ts, _, arrays = _scene(scene)
    R = len(o)
    want = jax_intersect(arrays.blocked, o, d, np.zeros(R, np.float32), t_max,
                         interpret=True)
    with culled(ik, ts, 8, K5_CTAS, _tally()):
        got = ik.pallas_intersect(ts, torch.from_numpy(o), torch.from_numpy(d),
                                  torch.zeros(R), torch.from_numpy(t_max))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    assert int((got[1] >= 0).sum()) > 50


def test_only_vmem_mode_scenes_carry_padded_boxes():
    """K4 and K5 walk VMEM-mode scenes, the only ones built with padded
    boxes; an HBM-mode scene (K3, K6) has none, and the wrappers' check
    names the mode."""
    from ipu_ray_lib_tpu_torch.ops.cuda.build import _check_pbox

    desc = make_cornell_box_scene(None, box_only=False)
    hbm, _ = TB.build_scene(desc, device="cpu", image_width=8,
                            image_height=8, intersector="pallas-hbm")
    vmem = _scene("box")[0]
    assert hbm.pbox is None and hbm.to("cpu").pbox is None
    assert vmem.pbox.shape == (vmem.num_blocks, 8)
    assert torch.equal(hbm.baabb, vmem.baabb)
    with pytest.raises(ValueError, match="VMEM-mode"):
        _check_pbox(hbm, "K5")


def test_lane_admits_refuses_what_cannot_hit():
    """Dead lanes (t_min >= best t) and empty blocks test nothing;
    unbounded blocks and lanes with non-finite rays test everything."""
    box = torch.tensor([[0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 1e-4, 0.0]])
    o = tuple(torch.tensor([5.0, 5.0, 5.0, np.nan, 0.5])[None] for _ in range(3))
    d = tuple(torch.tensor([1.0, 1.0, 1.0, 1.0, 1.0])[None] for _ in range(3))
    t_min = torch.zeros(1, 5)
    best = torch.tensor([[INF, INF, -1.0, INF, 10.0]])
    got = lane_admits(box, o, d, t_min, best)[0].tolist()
    assert got == [False, False, False, True, True]
    unb = box.clone()
    unb[0, 7] = 1.0
    assert lane_admits(unb, o, d, t_min, best)[0].tolist() == \
        [True, True, False, True, True]
    emp = box.clone()
    emp[0, 7] = -1.0
    assert not bool(lane_admits(emp, o, d, t_min, best).any())


@pytest.mark.cuda
def test_cuda_k5_counts_its_pairs():
    """On the card: K5's outputs equal the plain version's, and the
    (lane, block) pairs it reports lie between needed and dense."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    ts = _scene("monkey")[0].to(dev)
    _, inp = inputs("monkey-random")
    inp = tuple(x.to(dev) for x in inp)
    kout = ik.walk_cuda(ts, *inp, hbm=False)
    want = ik.dense_walk_ref(ts, *inp)
    for k, w in zip(kout, want):
        assert torch.equal(k, w)
    need = ik.needed_pairs(ts, inp[1], inp[3], want[0], want[4], members=1)
    assert need <= int(kout[6].sum()) <= int(want[4].sum()) * BR
