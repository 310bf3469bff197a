"""K4's culled walks (ops/cuda/shadow.cu ``shadow_kernel`` with
ops/cuda/rows.cuh ``lane_admits``, ``walk_step`` and ``BundleSync``),
emulated in plain torch on the CPU, against the dense plain version that
defines its result (ops/shadow.py ``shadow_trace_ref``) and against the
JAX package's K4 in interpret mode.

The kernel's bundle is a cluster of 4 CTAs (``K4_CTAS``) and keeps every
decision of the dense kernel: the primary walk's list, its order and its
stop check on the max of best t over the bundle's 1,024 lanes (each CTA's
max, then the cluster's), and the occlusion walk's union (the blocks any
lane of the bundle flags, OR-ed over the cluster), walked in ascending
order. Within those a lane tests a block only when ``lane_admits`` says a
row of it may hold a hit below its best t (the shadow ray's: the light's
distance), and a lane already occluded tests nothing more; the rows are
shared by the CTA's threads as K5's are (tests/test_torch_k5_warp_walk.py
emulates that step: ``culled_block``). The emulation below runs the plain
version with its walks replaced by the culled ones and must give
``out_f`` and ``out_i`` bit for bit, on the scenes and rays of K5's test,
at each spread. The primary walk's (lane, block) pairs
lie between ``needed_pairs`` and the dense walk's; the occlusion walk
tests at most the dense walk's (a lane stops at its first hit, so it may
test fewer than the pairs the nearest occluder would need).
"""

import torch_threads  # noqa: F401  (first: one torch thread)
import contextlib
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ipu_ray_lib_tpu.ops.pallas.shadow_kernel import (
    fused_shadow_trace_arrays as jax_shadow_arrays)
from ipu_ray_lib_tpu_torch.ops import intersect_kernel as ik
from ipu_ray_lib_tpu_torch.ops import shadow as sh
from ipu_ray_lib_tpu_torch.ops.cull import BR
from ipu_ray_lib_tpu_torch.render.shadow import DEFAULT_LIGHT_POS

from test_torch_k5_warp_walk import (_rays, _scene, _tally, culled_block,
                                     make_culled_walk)

K4_CTAS = 4  # K4's bundle: a cluster of 4 CTAs (ops/cuda/shadow.cu)
LIGHTS = {"monkey": DEFAULT_LIGHT_POS, "box": DEFAULT_LIGHT_POS,
          "smooth": (0.5, 2.0, -2.5), "ties": (0.3, -0.2, -1.0),
          "sphere": (1.5, 2.5, -1.0)}


@contextlib.contextmanager
def culled_k4(scene, spread, cl, primary, occlusion):
    """ops/shadow.py's walks replaced by the kernel's culled walks: the
    primary walk (``walk``) and the occlusion walk's block test
    (``test_block``: lanes already occluded test nothing)."""
    saved = sh.walk, sh.test_block

    def occ_block(p, blk, o, d, omag, t_min, best_t, best_row):
        return culled_block(scene, blk.long(), o, d, t_min, best_t, best_row,
                            spread, cl, occlusion, also=best_row < 0)

    sh.walk = make_culled_walk(scene, spread, cl, primary)
    sh.test_block = occ_block
    try:
        yield
    finally:
        sh.walk, sh.test_block = saved


def _inputs(case):
    scene, o, d, _ = _rays(case)
    ts = _scene(scene)[0]
    return ts, sh.shadow_inputs(ts, torch.from_numpy(o), torch.from_numpy(d)), \
        LIGHTS[scene]


@functools.lru_cache(maxsize=None)
def _dense(case):
    ts, args, light = _inputs(case)
    stats = {}
    out = sh.shadow_trace_ref(ts, *args, light=light, stats=stats)
    return out, stats


CASES = ["monkey-camera", "monkey-random", "monkey-adversarial",
         "box-adversarial", "smooth-random", "ties-ties", "sphere-poles",
         "sphere-adversarial"]


def _hold(case, spread, cl):
    ts, args, light = _inputs(case)
    (want_f, want_i), stats = _dense(case)
    primary, occlusion = _tally(), _tally()
    with culled_k4(ts, spread, cl, primary, occlusion):
        got_f, got_i = sh.shadow_trace_ref(ts, *args, light=light)
    assert torch.equal(got_f, want_f)
    assert torch.equal(got_i, want_i)
    need = ik.needed_pairs(ts, args[1], args[3], want_f[3].contiguous(),
                           args[0], members=1)
    assert need <= primary["lane_pairs"] <= stats["primary_pairs"] * BR
    assert occlusion["lane_pairs"] <= stats.get("occlusion_pairs", 0) * BR
    return want_i, primary, occlusion, stats


@pytest.mark.parametrize("case", CASES)
def test_culled_walks_equal_the_dense_kernel(case):
    want_i, primary, occlusion, stats = _hold(case, 8, K4_CTAS)
    assert int((want_i[0] >= 0).sum()) > 50
    if case != "ties-ties":  # the grid's hits see the light
        assert 0 < int(want_i[3].sum()) < want_i.shape[1]  # some occluded
        assert (primary["lane_pairs"] + occlusion["lane_pairs"]
                < (stats["primary_pairs"] + stats["occlusion_pairs"]) * BR)


@pytest.mark.parametrize("spread", [1, 2, 3, 5, 8, 13, 32])
def test_spreads(spread):
    for case in ("monkey-adversarial", "sphere-poles"):
        _hold(case, spread, K4_CTAS)


@pytest.mark.parametrize("case", ["box-adversarial", "ties-ties",
                                  "sphere-poles"])
def test_culled_walks_equal_the_jax_kernel(case):
    """``fused_shadow_trace_arrays`` of the port with its walks culled as
    the kernel culls them: out_f and out_i equal the JAX package's K4 in
    interpret mode."""
    scene, o, d, _ = _rays(case)
    ts, _, arrays = _scene(scene)
    light = LIGHTS[scene]
    jf, ji = jax_shadow_arrays(arrays, jnp.asarray(o), jnp.asarray(d),
                               light=light, ambient=0.05, interpret=True)
    with culled_k4(ts, 8, K4_CTAS, _tally(), _tally()):
        tf, ti = sh.fused_shadow_trace_arrays(
            ts, torch.from_numpy(o), torch.from_numpy(d), light=light)
    assert np.array_equal(tf.numpy(), np.asarray(jf)[:4])
    assert np.array_equal(ti.numpy(), np.asarray(ji)[:4])
    assert int((ti[0] >= 0).sum()) > 50


@pytest.mark.cuda
def test_cuda_k4_counts_its_pairs():
    """On the card: K4's outputs equal the plain version's, and the
    primary walk's (lane, block) pairs lie between needed and dense."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda", 0)
    ts, args, light = _inputs("monkey-random")
    ts = ts.to(dev)
    args = tuple(a.to(dev) for a in args)
    pairs = torch.zeros((4, args[0].shape[0]), dtype=torch.int32, device=dev)
    kf, ki = sh.shadow_trace_cuda(ts, *args, light=light, pairs=pairs)
    stats = {}
    pf, pi = sh.shadow_trace_ref(ts, *args, light=light, stats=stats)
    assert torch.equal(kf, pf) and torch.equal(ki, pi)
    need = ik.needed_pairs(ts, args[1], args[3], pf[3].contiguous(), args[0],
                           members=1)
    assert need <= int(pairs[2].sum()) <= stats["primary_pairs"] * BR
    assert int(pairs[3].sum()) <= stats.get("occlusion_pairs", 0) * BR
