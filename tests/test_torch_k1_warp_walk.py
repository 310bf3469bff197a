"""K1's warp walk (ops/cuda/megakernel.cu: warp_walk_vmem and warp_rows),
emulated in plain torch on the CPU, against the sequential per-lane walk
that defines its result (ops/megakernel.py ``_walk_vmem``).

The kernel walks the blocks in ascending order with the 32 lanes of a
warp together; each live lane tests every block its own slab admits. A
block that at most ``spread_max`` of the warp's lanes need is tested
spread: for one needing lane at a time, hardware lane w tests rows w,
w + 32, ... of the stage (128 rows through L1, or 64 staged in shared
memory) in ascending order with a strict `<` on the f32 bits of t, and the
warp takes the least t bits, then the least row among the lanes that hold
them; the needing lane takes the result where it is strictly nearer than
its best t. A block more lanes need is tested by each of them over its
rows in order. The emulation below spells those steps out, and must give
every lane's best t and row bit for bit as the sequential walk does: on
exact t ties (a duplicated grid of quads hit at its vertices and edges,
ties inside a block and across blocks) and on Cornell + monkey rays, at
every spread threshold and for both row routes.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import functools
import os

import numpy as np
import pytest
import torch

import ipu_ray_lib_tpu_torch.scene.build as TB
import ipu_ray_lib_tpu_torch.scene.types as TT
from ipu_ray_lib_tpu_torch.ops.intersect import (INF, dense_rows, slab_admit,
                                                 slab_inv)
from ipu_ray_lib_tpu_torch.ops.megakernel import _walk_vmem
from ipu_ray_lib_tpu_torch.ops.tables import TB as ROWS
from ipu_ray_lib_tpu_torch.scene.builtin import make_cornell_box_scene

from test_torch_intersect import _camera, _spread, _tie_rays, _tie_scene

MONKEY = os.path.join(os.path.dirname(__file__), "..", "assets",
                      "monkey_bust.glb")
WARP = 32
INF_BITS = 0x7F800000
NO_ROW = 1 << 40


def _bits(t, ok):
    """The f32 bits of accepted t (t > 0: the bits order as the floats
    do), the bits of inf elsewhere."""
    return torch.where(ok, t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF,
                       INF_BITS)


def _spread_stage(bits):
    """One needing lane's stage of k rows ([k, L] bits, the lane's own ray
    in each column) spread over the warp: hardware lane w keeps its first
    strict minimum over rows w, w + 32, ...; the warp reduces to the least
    bits, then the least row among the lanes holding them. Returns (bits
    [L], row in the stage [L])."""
    k, L = bits.shape
    per_lane = bits.reshape(k // WARP, WARP, L)             # row i*32 + w
    tb = per_lane.amin(dim=0)                               # [32, L]
    rows = (torch.arange(k // WARP)[:, None, None] * WARP
            + torch.arange(WARP)[None, :, None])
    rb = torch.where(per_lane == tb[None], rows, NO_ROW).amin(dim=0)
    tmin = tb.amin(dim=0)                                   # [L]
    rmin = torch.where(tb == tmin[None], rb, NO_ROW).amin(dim=0)
    return tmin, rmin


def warp_walk(scene, o, d, active, spread_max, k_rows):
    """K1's warp walk over lanes in warps of 32 (the last warp padded with
    lanes that are not live): returns (best t, best row) [L]."""
    L = o[0].shape[0]
    pad = -L % WARP
    live = torch.cat([active, torch.zeros(pad, dtype=torch.bool)])
    o = tuple(torch.cat([c, torch.zeros(pad)]) for c in o)
    d = tuple(torch.cat([c, torch.ones(pad)]) for c in d)
    inv = slab_inv(d)
    omag = torch.maximum(torch.maximum(o[0].abs(), o[1].abs()), o[2].abs())
    best_t = torch.full((L + pad,), INF)
    best_row = torch.full((L + pad,), -1, dtype=torch.int64)
    for b in range(scene.baabb.shape[0]):
        mine = slab_admit(o, inv, live, scene.baabb[b])
        needers = mine.reshape(-1, WARP).sum(dim=1)
        if not bool(needers.any()):
            continue
        spread = (needers <= spread_max).repeat_interleave(WARP)
        t, ok = dense_rows(scene.p[b * ROWS:(b + 1) * ROWS], o, d, omag)
        bits = _bits(t, ok)
        for h in range(0, ROWS, k_rows):
            tmin, rmin = _spread_stage(bits[h:h + k_rows])
            tf = tmin.to(torch.int32).view(torch.float32)
            take = mine & spread & (tf < best_t)
            best_t = torch.where(take, tf, best_t)
            best_row = torch.where(take, b * ROWS + h + rmin, best_row)
        for r in range(ROWS):  # each needing lane over the rows in order
            take = mine & ~spread & ok[r] & (t[r] < best_t)
            best_t = torch.where(take, t[r], best_t)
            best_row = torch.where(take, b * ROWS + r, best_row)
    return best_t[:L], best_row[:L]


def _rays(name):
    if name == "ties":
        scene, _ = TB.build_scene(_tie_scene(TT), device="cpu",
                                  image_width=16, image_height=16,
                                  intersector="pallas")
        o, d = _tie_rays()
    else:
        scene, params = TB.build_scene(
            make_cornell_box_scene(MONKEY, box_only=False), device="cpu",
            image_width=48, image_height=32, intersector="pallas")
        co, cd = _camera(params)
        so, sd = _spread(scene, 2000, 11)
        o, d = np.concatenate([co, so]), np.concatenate([cd, sd])
    active = torch.ones(len(o), dtype=torch.bool)
    active[5::7] = False  # lanes whose paths are done
    col = lambda a, c: torch.from_numpy(np.ascontiguousarray(a[:, c]))
    return (scene, tuple(col(o, c) for c in range(3)),
            tuple(col(d, c) for c in range(3)), active)


@functools.lru_cache(maxsize=None)
def _case(name):
    """(scene, o, d, active, the sequential walk's (best t, best row), its
    counts) of one ray set."""
    scene, o, d, active = _rays(name)
    omag = torch.maximum(torch.maximum(o[0].abs(), o[1].abs()), o[2].abs())
    start_t = torch.where(active, INF, -1.0)
    start_row = torch.full(active.shape, -1, dtype=torch.int64)
    stats = {}
    want = _walk_vmem(scene, o, d, slab_inv(d), active, omag, start_t,
                      start_row, stats)
    return scene, o, d, active, want, stats


@pytest.mark.parametrize("k_rows", [ROWS, 64], ids=["l1", "staged"])
@pytest.mark.parametrize("spread_max", [0, 14, 20, 32])
@pytest.mark.parametrize("name", ["ties", "monkey"])
def test_warp_walk_equals_the_sequential_walk(name, spread_max, k_rows):
    scene, o, d, active, (want_t, want_row), stats = _case(name)
    got_t, got_row = warp_walk(scene, o, d, active, spread_max, k_rows)
    assert torch.equal(got_t[active], want_t[active])
    assert torch.equal(got_row[active], want_row[active])
    assert int((want_row[active] >= 0).sum()) > 500
    assert stats["block_tests"] > int(active.sum())


def test_the_tie_rays_tie():
    """The tie rays hit exact t ties: at every winning t a second row (the
    quad's copy, a neighbour at a shared edge or vertex) passes too."""
    scene, o, d, active, (want_t, want_row), _ = _case("ties")
    omag = torch.maximum(torch.maximum(o[0].abs(), o[1].abs()), o[2].abs())
    t, ok = dense_rows(scene.p, o, d, omag)
    ties = ((ok & (t == want_t[None])).sum(dim=0) >= 2) & active
    assert int(ties.sum()) == int((want_row[active] >= 0).sum())
