"""K6's split over the card (ops/cuda/intersect.cu: chunk_kernel and
fold_kernel), emulated in plain torch on the CPU, against the sequential
walk that defines its result (ops/intersect_kernel.py ``walk``).

A chunk is the CHECK_EVERY = 2 supers (16 blocks) of a bundle's list
between two stop checks. The kernel works
in waves: a wave tests the next W chunks of every bundle that has not
stopped, all at once: each lane's own first strict minimum (t, row) over
a chunk's blocks in walk order, starting from its t_max. Then, per
bundle, it folds the wave's chunks in walk order: a chunk's hit
replaces the lane's best only when strictly nearer (an earlier chunk
keeps a tie), and after each chunk the bundle stops once its max of best
t is below the next entry's distance bound; a bundle that has not
stopped carries its best t and row and its entries walked into the next
wave. The emulation below spells those steps out and must give the
sequential walk's best t and row and the blocks it tested, bit for bit,
with the blocks tested past the stop (up to the end of its wave) counted
apart; the cases hold bundles whose stop fires after a chunk inside
their list, inside a wave and at a wave's end, and bundles that walk it
to the end, with the kernel's wave of 64 chunks and with waves of 1, 2
and 3 chunks.
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import functools
import os

import numpy as np
import pytest
import torch

import ipu_ray_lib_tpu_torch.scene.build as TB
from ipu_ray_lib_tpu_torch.ops import intersect_hbm as ih
from ipu_ray_lib_tpu_torch.ops import intersect_kernel as ik
from ipu_ray_lib_tpu_torch.ops.cull import BR, super_cull_lists_bundle
from ipu_ray_lib_tpu_torch.ops.tables import SB
from ipu_ray_lib_tpu_torch.scene.builtin import (make_cornell_box_scene,
                                                 make_stress_scene)

from test_torch_intersect import _camera, _spread

MONKEY = os.path.join(os.path.dirname(__file__), "..", "assets",
                      "monkey_bust.glb")


def split_walk(p, counts, order, dists, o, d, t_min, t_max, *, members,
               check_every, wave):
    """The kernel's split walk over bundles (lane views as ``ik.walk``),
    ``wave`` chunks of each list a wave: returns (best t, best row) [n,
    BR], the blocks each bundle's walk tested and the blocks tested past
    its stop, [n] each."""
    n, n_list = order.shape
    omag = ik.o_mag(o)
    best_t = t_max.clone()
    best_row = torch.full((n, BR), -1, dtype=torch.int64)
    tested = torch.zeros(n, dtype=torch.int32)
    spec = torch.zeros(n, dtype=torch.int32)
    n_waves = -(-(-(-n_list // check_every)) // wave)
    state = [0] * n  # entries walked, or -1 once stopped
    for w in range(n_waves):
        for i in range(n):
            count = int(counts[i])
            if state[i] < 0:
                continue
            lane = lambda v: tuple(c[i:i + 1] for c in v)
            c0 = w * wave
            c1 = min(c0 + wave, -(-count // check_every))
            partials = []  # the wave's chunks, each from t_max
            for c in range(c0, c1):
                bt, br = t_max[i:i + 1].clone(), best_row[i:i + 1] * 0 - 1
                e0 = c * check_every
                for e in range(e0, min(e0 + check_every, count)):
                    for m in range(members):
                        blk = order[i, e:e + 1].long() * members + m
                        bt, br = ik.test_block(p, blk, lane(o), lane(d),
                                               omag[i:i + 1], t_min[i:i + 1],
                                               bt, br)
                partials.append((bt[0], br[0]))
            j, stopped = state[i], False
            for pt, pr in partials:  # the fold, in walk order
                better = pt < best_t[i]
                best_t[i] = torch.where(better, pt, best_t[i])
                best_row[i] = torch.where(better, pr, best_row[i])
                j = min(j + check_every, count)
                if j < count and j < n_list and bool(best_t[i].max()
                                                       < dists[i, j]):
                    stopped = True
                    break
            if not stopped and j < count:
                state[i] = j
                continue
            state[i] = -1
            tested[i] = members * j
            spec[i] = members * (min(c1 * check_every, count) - j)
    return best_t, best_row, tested, spec


def _terrain_rays(scene, n, seed):
    """n bundles looking down at the stress heightfield from just above
    it, each from a small patch in a narrow cone: their lanes hit near,
    so most bundles stop after a chunk inside their list."""
    rng = np.random.default_rng(seed)
    b = scene.baabb.numpy()
    lo, hi = b[:, 0:3].min(0), b[:, 3:6].max(0)
    o, d = [], []
    for _ in range(n):
        c = rng.uniform(lo, hi)
        c[1] = hi[1] + 0.05 * (hi[1] - lo[1])
        o.append(c + rng.uniform(-0.01, 0.01, (BR, 3)) * (hi - lo))
        v = np.array([0.0, -1.0, 0.0]) + rng.normal(0, 0.1, (BR, 3))
        d.append(v / np.linalg.norm(v, axis=1, keepdims=True))
    return (np.concatenate(o).astype(np.float32),
            np.concatenate(d).astype(np.float32))


@functools.lru_cache(maxsize=None)
def _CASES(name):
    """(scene, the super cull's lists, padded rays) in HBM mode: bundles
    over the stress heightfield (``terrain``), or Cornell + monkey camera
    rays and 2,000 random rays from spread origins (``monkey``), whose
    bundles walk their whole lists."""
    mode = "pallas-hbm"
    if name == "terrain":
        scene, _ = TB.build_scene(make_stress_scene(96), device="cpu",
                                  image_width=16, image_height=16,
                                  intersector=mode)
        o, d = _terrain_rays(scene, 6, 5)
    else:
        scene, params = TB.build_scene(
            make_cornell_box_scene(MONKEY, box_only=False), device="cpu",
            image_width=48, image_height=32, intersector=mode)
        co, cd = _camera(params)
        so, sd = _spread(scene, 2000, 12)
        o, d = np.concatenate([co, so]), np.concatenate([cd, sd])
    R = len(o)
    args = ik.intersect_inputs(torch.from_numpy(o), torch.from_numpy(d),
                               torch.zeros(R), torch.full((R,), float("inf")))
    lists = super_cull_lists_bundle(scene, *args[:4], args[4].shape[1] // BR)
    return scene, lists, args[4]


@pytest.mark.parametrize("name,wave", [
    ("terrain", 64), ("terrain", 1), ("terrain", 2), ("terrain", 3),
    ("monkey", 64)])
def test_split_walk_equals_the_sequential_walk(name, wave):
    scene, (counts, order, dists), rays = _CASES(name)
    members, every = SB, ih.CHECK_EVERY
    n = counts.shape[0]
    o, d, t_min, t_max = ik.lanes(rays, n)
    want_t, want_row, want_tested = ik.walk(
        scene.p, counts, order, dists, o, d, t_min, t_max, members=members,
        check_every=every)
    got_t, got_row, tested, spec = split_walk(
        scene.p, counts, order, dists, o, d, t_min, t_max, members=members,
        check_every=every, wave=wave)
    assert torch.equal(got_t, want_t)
    assert torch.equal(got_row, want_row)
    assert torch.equal(tested, want_tested)
    # every chunk up to the end of the wave that stopped was tested
    every_m = members * every
    assert bool((spec >= 0).all())
    assert bool((tested + spec <= members * counts).all())
    assert bool(((tested + spec == members * counts)
                 | ((tested + spec) % (wave * every_m) == 0)).all())
    if wave >= -(-order.shape[1] // every):  # one wave: the whole lists
        assert torch.equal(spec, members * counts - want_tested)
    if wave == 1:  # every stop at the end of its wave: nothing wasted
        assert not bool(spec.any())
    elif name == "terrain":  # a stop inside a wave
        assert bool((spec > 0).any())
    assert int((want_row >= 0).sum()) > 2000
    stopped = want_tested < members * counts
    if name == "terrain":
        # stops after a chunk inside the list, past the first one, and a
        # bundle that walks its whole list
        assert bool((stopped & (tested > members * every)).any())
        assert bool((~stopped & (counts > 0)).any())
    else:
        assert not bool(stopped.any())
