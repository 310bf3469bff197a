#!/usr/bin/env python3
"""GPU smoke test of the PyTorch + CUDA port (ipu_ray_lib_tpu_torch).

Drives the port's paths on one CUDA card through ``build_scene`` ->
``render_streaming``, after checking every kernel against its plain torch
version:

* the Cornell box with the monkey plinth, 1440x1440 at 64 spp (kernel
  K1, ``ops/cuda/megakernel.cu``);
* the spheres + NIF environment-light flagship: ``make_primitive_scene``
  lit by ``assets/nif/synthetic_urban_4k``, 512x512 at 64 spp (K1 in
  record mode, the env MLP ``ops/cuda/env_mlp.cu`` and the bank kernel);
* scenes of any size in HBM mode (K3, the same kernel's HBM walk): the
  stress heightfield ladder at grids 512, 1024 and 2048 (522,242,
  2,093,058 and 8,380,418 triangles; the bf16 payload engages at 2048)
  at 256x256 spp 8, and grid 512 at 1440x1440 spp 64;
* the shadow trace with its six AOVs: ``render(mode="shadow-trace")`` on
  the Cornell box with the monkey at 1440x1440 (the fused shadow kernel
  K4, ``ops/cuda/shadow.cu``);
* the shadow trace's glue route on a scene of any size (path A): the
  stress grid 512 in HBM mode at 1440x1440, through the closest-hit
  kernel K6 (``ops/cuda/intersect.cu``), twice per chunk;
* the path trace under an environment light that is not a NIF (path B):
  the XLA-loop integrator on the Cornell box with the monkey at 1440x1440
  spp 4 (the closest-hit kernel K5 once per iteration);
* multi-device rendering on a mesh of 3 shards of the card
  (``parallel/mesh.py``: ``render_streaming_sharded`` through K1,
  ``render_shadow_sharded`` through K4), the progressive path trace, the
  f16 readback, and two processes sharing the card.
* the application: ``trace_torch.py`` (the port's ``trace.py``) with the
  README's commands: the CLI's flow, the importers, the scene cache, the
  f64 oracle and the EXR output;
* the ``"bvh"`` and ``"dense"`` intersectors (the threaded-BVH walk K7,
  ``ops/cuda/bvh.cu``; the dense closest hit K8, ``ops/cuda/dense.cu``)
  through the shadow trace, the XLA-loop integrator, the per-sample
  wavefront and the CLI.

Run from the repository root:

    python3 chip_smoke.py              # the full check (one card)
    python3 chip_smoke.py --quick      # build + small-scene checks only

Phases (any failed check raises, so the exit code is non-zero):
  1. card identity (nvidia-smi name, power limit); nvcc build of every
     kernel source (one nvcc per source, in parallel);
  2. Cornell, kernel vs plain version on the card, rtol = atol = 1e-5:
     golden scene 48x32 spp 2 (also vs tests/golden/box48x32_spp2.npy,
     done == 3072); Cornell + monkey 64x64 spp 4, and a counting launch
     of K1 (the warp walk) there, its segments and blocks equal to the
     plain walk's and its image bit for bit K1's;
  3. spheres + NIF, kernel route vs plain route: ``done``, every path
     record and every pixel none of whose paths escaped bit for bit, the
     image at the env tolerance (the tensor-core env MLP sums in its own
     order; ``envk.within_high_frequency``): 48x32 spp 2 (also vs
     tests/golden/spheres_nif48x32_spp2.npy, held to the CPU test's
     tolerance) and 64x64 spp 4; the env MLP kernel vs its plain version
     on 65,536 seeded directions, beside a torch.matmul chain (the
     library yardstick, never called by the port): the kernel no further
     from the plain version than the chain, plus the stated slack
     (``envk.within_yardstick``), and where it lies furthest; a pack
     whose stages overfill the kernel's weight ring refused at launch;
  3b. HBM mode (K3, the warp walk), kernel route vs plain route, rtol =
     atol = 1e-5 and ``done`` exact: stress24 32x32 spp 2 max_path_length
     4 (also ``render_streaming`` vs
     tests/golden/stress24_hbm32x32_spp2.npy, done == 2048); Cornell +
     monkey 64x64 spp 4 with the f32 and with the bf16 payload; stress24
     with the bf16 payload; stress24 lit by the NIF, 48x32 spp 2 (record
     mode, env MLP, bank; held as in phase 3); a counting launch of K3
     on stress64 32x32 spp 2, its counters equal to the plain walk's
     counts and its image bit for bit; K3 on a pool of 1,000 slots (not
     whole warps) vs plain;
  3c. the shadow trace (K4), kernel vs plain version, every output bit
     for bit: the Cornell box 48x32, Cornell + monkey 64x64, a mesh with
     vertex normals 64x64, 3,000 random rays from spread origins; and
     ``render`` on the card against tests/golden/shadow_box48x32.npz
     (the JAX package's render), every AOV bit for bit;
  3d. the closest-hit kernels K5 and K6 (split over the card in waves)
     against their plain versions, every output bit for bit (the blocks
     each bundle's walk tested included):
     the Cornell box 48x32, Cornell + monkey 64x64 (camera rays and one
     bounce, both kernels), stress24 in HBM mode with the f32 and with
     the bf16 payload, 3,000 random rays from spread origins;
     ``render(fused=False)`` (the glue route, K5) against
     tests/golden/shadow_box48x32.npz; the glue route against the K4
     route on Cornell + monkey 64x64 (ids everywhere and every AOV off
     the spheres bit for bit; XLA rounds the two routes' sphere tests
     differently, tests/test_torch_glue.py, so sphere hits are held to
     limits that follow from their t difference, ``routes_agree``);
     path B, the kernel route against the plain route, bit for bit and
     ``done`` exact, on the Cornell box 48x32 spp 2 (K5) and stress24 in
     HBM mode 32x32 spp 2 (K6); --quick stops here;
  4. Cornell + monkey at the main path's slot pool (1440^2 stream,
     R = 131072, J = 16) with spp 1 per slot — spp is the one cut there —
     which also counts the walk's (segment, block) pairs for K1's bound,
     and K1's counting launch there, its counts equal to those;
  5. Cornell main path at full size: one warm-up and three timed renders
     (torch.cuda.synchronize), done == 1440^2 * 64, finite image, image
     mean within 15% of the plain version's 64x64 mean; then the kernel
     alone at the same shapes, three times, with CUDA events, and a
     counting launch of K1 at those shapes, its image bit for bit (the
     cycle split, the blocks each warp walks against its lanes' sum,
     the blocks tested spread); then the
     main path's image on the pixels of its first 128 slots' first 4
     stream rows (512 pixels, all 64 samples each) against the kernel
     and the plain version replaying those paths, rtol = atol = 1e-5;
  6. plain vs kernel time at 256^2 spp 4, in turns (plain, kernel,
     kernel, plain);
  6b. the shadow-trace main path: ``render`` of phase 4's scene at
     1440^2, one warm-up, three timed frames with all AOVs and three with
     normals only (hits, finite AOVs where hit, K4 launched); replayed
     frames against the eager loop (md5), the readback alone (its ms, one
     pinned copy a frame) and two frames held (the first one's md5 after
     the second); the frame's parts with CUDA events (camera + cull, K4 alone, epilogue,
     un-tiling) and its device-to-host copy; K4 against its plain version
     over the whole frame, bit for bit, which also counts the (bundle,
     block) pairs its walks test; the (lane, block) pairs its hits need
     (K4's bound: the primary walk's from each lane's hit t, the
     occlusion walk's counted by the plain version); the frame's own
     pixels on its first 16 bundles and on 16 around its median lit pixel
     replayed by the plain route, every AOV bit for bit;
  7. the flagship, spheres + NIF at 512^2 spp 64: kernel route vs plain
     route at its slot pool (R = 131072, J = 2) with spp 4 (held as in
     phase 3), which also counts its segments for K1's bound, and the
     bank kernel vs its plain version on those records, bit for bit;
     then one warm-up and three timed renders with the env, three
     without (same trajectories), done == 512^2 * 64, finite image; the
     flagship's image on the pixels of its first 2,048 slots (4,096
     pixels, all 64 samples each) against the kernel route replaying
     those slots (bit for bit) and the plain route (held as in phase 3);
     the three kernels alone with CUDA events; the env MLP kernel against
     its plain version on every escape of the flagship, beside the
     torch.matmul chain on the same escapes (``envk.within_yardstick``);
     the kernel and the chain timed in turns on those escapes and on
     65,536 directions;
  8. the stress ladder, grids 512, 1024 and 2048 at 256^2 spp 8,
     max_path_length 5, in HBM mode: host build time; kernel vs plain at
     the frame's pool with spp 1, where the plain version counts the
     walk at each level (K3's bound); one warm-up and three timed
     renders, done == 256^2 * 8, finite image, K3 launched and K1 not;
     K3 alone with CUDA events; a counting launch of K3 at the frame's
     shapes, its image bit for bit K3's (cycles split between the group
     scan, the slab tests, the row tests and the rest; the blocks each
     warp stages against the sum over its lanes); the frame's own pixels on its
     first slots and on a block of slots around its median lit slot,
     replayed by both routes, rtol = atol = 1e-5;
  9. grid 512 at the Cornell main path's traffic, 1440^2 spp 64: kernel
     vs plain at its pool with spp 1 (the walk counts for K3's bound),
     one warm-up and three timed renders, done, finite, K3 alone, and
     K3's counting launch, as in phase 8;
  10. path A at full width: ``render(mode="shadow-trace")`` of phase 9's
     scene (grid 512, HBM mode) at 1440^2, chunk 65,536: one warm-up,
     three timed frames with all AOVs and three with normals only (hits,
     finite AOVs where hit, K6 launched twice per chunk, K4 and K5 not);
     K6 alone over one frame's calls (CUDA events); each launch alone
     (CUDA events) beside the blocks its bundles' walks tested (max and
     mean over its 64 bundles, each launch logged)
     and the blocks tested past the bundles' stops (speculative); the
     frame's (bundle, block) pairs walked and the (lane, block) pairs its
     hits need (K6's bound); K6 against its plain version on the frame's
     own launches
     (the primary and occlusion call of the chunk with the median lit
     pixel, and the heaviest occlusion call), every output bit for bit;
     the frame's 16 bundles from its first triangle hit and 16 around its
     median lit pixel replayed by the plain route, every AOV bit for bit;
     then the glue route on phase 6b's Cornell + monkey frame (K5)
     against phase 6b's K4 frame, as in 3d, and its 16 bundles around its
     median sphere pixel replayed by the plain route, every AOV bit for
     bit;
  11. path B at full width: ``render_streaming`` of phase 4's scene at
     1440^2 spp 4 (spp is the one cut) under a sky-gradient env, slot pool
     R = 131072, J = 16: one warm-up and three timed frames, done == 1440^2
     * 4, finite image, K5 launched and K1 not, the iteration count; K5
     alone over one frame's calls (CUDA events), its pairs walked and
     needed; K5 against its plain version on the frame's own launches of
     the first iteration that walks a block and of a mid-frame iteration;
     then the grid-512 scene at 256^2 spp 8 (K6);
  12. sharded and progressive, on a mesh of 3 shards of the card: the
     Cornell + monkey at 64x64 spp 4, ``render_streaming_sharded`` against
     its plain route bit for bit, image and ``done`` (``chunk_slots=256``:
     K1, the plain route the same render with the megakernel's entry
     replaced by ``megakernel_path_trace_ref``; ``chunk_slots=200``: the
     XLA loop with K5, against the plain walks); spheres + NIF 48x32 spp 2
     on 2 shards (``done`` bit for bit, the image at the env tolerance);
     the main path's last shard (1440^2 on 3 shards: R = 131072, J = 6,
     n_valid 500,736) at spp 1 with the plan's rows, seed and n_valid, K1
     against ``megakernel_path_trace_ref`` bit for bit; the main path at
     1440^2 spp 64 on the 3 shards (done, finite, and as a sanity check
     the mean within SHARDED_MEAN_REL of the one-device frame timed in
     turns with it); ``render_shadow_sharded`` of the 1440^2 raster-order
     rays against one ``shadow_trace`` call, every field bit for bit;
     ``render(mode="path-trace", progress_callback=...)`` at 64x64 spp 20,
     each frame against the plain route's, and at 1440^2 spp 64; the f16
     readback of the path trace and of the shadow AOVs against the f32
     ones rounded (``_prep_f``), with the copy to the host of a stand-in
     tensor of the image's shape in f32 and in f16 timed; two gloo
     processes with 2 shards of the card each
     (tests/torch_multihost_worker.py) against one process with 4, bit for
     bit;
  13. the application: ``trace_torch.run`` (the CLI, in this process) with
     the README's commands at their own sizes, each kernel's launches
     counted from 0 around each: (a) ``--scene box -w 1440 -H 1440
     --samples 64 --gpu-only``, its EXR bit for bit ``render_streaming`` of
     the same scene and params; (b) ``--scene box-simple --render-mode
     shadow-trace --visualise normal`` (768x432, the oracle and the CPU
     twin), the card within MSE 1e-3 of the oracle; (c) ``--mesh-file
     assets/test_scene.dae --samples 512 --gpu-only``; (d) ``--scene
     spheres --nif-hdri assets/nif/synthetic_sky/assets.extra --samples
     1000 --gpu-only``; (e) ``--compile-only`` at 1440^2 spp 1000 (no
     image, no launch); (f) the grid-512 heightfield written as a binary
     PLY, shadow-traced at 1440^2 twice with ``--scene-cache`` (``auto``
     picks HBM mode: path A, K6), the second run a cache hit with the same
     image, then path-traced at 256^2 spp 8, max_path_length 5 under the
     NIF sky (K3 in record mode, K2); (g)
     ``--progressive`` at 256^2 spp 32, and one ``utils/profiling.trace``
     around a 256^2 frame (the trace's size, its ``streaming.*`` spans as
     the program recorded them, held against the profile's, and the
     card's idle time under each);
  14. the per-sample wavefront and NIF training
     (``per_sample_and_training``): ``path_trace_sample``'s kernel route
     against its plain route on Cornell + monkey 64x64 spp 2 (K5), stress24
     in HBM mode 32x32 spp 2 with the f32 and the bf16 payload (K6) and
     spheres + NIF 48x32 spp 2 (K2, the env term with the XLA env
     function's angles), every sample's fields bit for bit and the NIF-lit
     image within ``envk.within_high_frequency``; ``render(mode=
     "path-trace", streaming=False)`` of the Cornell + monkey at 1440^2 spp
     4 (spp is the one cut) in chunks of 65,536: a warm-up of one chunk
     under the NIF (K2's own output on its escapes against
     ``env_mlp_ref`` beside the torch.matmul chain,
     ``envk.within_yardstick``) and three timed frames, finite, no
     material error, the mean within 15% of ``render_streaming``'s at spp
     4, K5's launches and the host syncs counted, K5 alone over the first
     frame's own calls (CUDA events) and the rest the host's;
     ``render_path_sharded`` on 3 shards of the card, a 64x64 window kernel
     vs plain bit for bit and the 1440^2 spp 4 frame under the NIF timed
     (K2 on a shard's 691,200 rays gated as above); ``train_nif`` at 6 x
     320, E = 12, batch 4,096 on ``synth_hdri`` at 512x1024: 20 steps on
     the card and on the CPU from the same seed, the loss curves within
     1e-4 of each other, then 300 steps timed (steps/s, the loss at least
     halved), then the trained NIF saved (no h5py), loaded and rendered
     (spheres 512^2 spp 16: K1's record mode, K2, the bank).
  15. the "bvh" and "dense" intersectors (``intersectors``): (a) K7
     (closest and any hit) and K8 against their plain versions, every
     output bit for bit, on the calls of a Cornell + monkey 64x64 shadow
     trace (camera rays and their shadow rays), on one 65,536-ray chunk of
     the 1440^2 frame, and (K7) on stress24; the plain versions and the
     kernels timed on the chunk, and K8's library yardstick (six f32
     torch.matmul per block of 512 rows, the test, min and argmin); (b)
     ``render(mode="shadow-trace")`` of Cornell + monkey at 1440^2 through
     each: a warm-up and 3 frames, the launches per frame, K7/K8 alone
     over a frame's calls (CUDA events, and behind a spin kernel), the
     pixels that differ from phase 6b's K4 frame per AOV (counted, not
     gated: visit order and the dense test resolve ties otherwise); K7's
     counting launch over the frame's calls (node visits, leaf tests: its
     bound); (c) the grid-512 heightfield built for "bvh" (build seconds)
     and shadow-traced at 1440^2, K7 against its plain version on its
     first chunk, "dense" without its tables refused; (d) path B through
     each, ``render_streaming`` of Cornell + monkey at 1440^2 spp 4 on the
     XLA-loop integrator: frames, iterations, the kernel's share, done,
     finite, the mean within 15% of the megakernel's at spp 4; (e)
     ``render(streaming=False)`` at 64x64 spp 2 through each, kernel route
     against plain route bit for bit; (f) ``trace_torch.run`` with the
     README's second command and ``--intersector bvh`` / ``dense``: the
     card's image equal to the CPU twin's (MSE 0), the oracle's MSE
     printed. Each path's launches counted from 0 around it.
Before the last two lines: a JSON object with each kernel's launches on
its main path (and ``launches_per_sample``: in each of phase 14's
runs), its largest deviation from its plain version, its times and its
bound (the least time the card could take for the same work:
f32 instructions at the instruction rate, half the 67 TFLOP/s that count an FMA
as two; the previous basis beside it as ``bound_ms_flop_basis``); then
the card's nvidia-smi line. The last line is the JSON status object.
Exits non-zero, printing no result, when no CUDA device is available.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import os
import sys
import time

sys.modules["jax"] = None  # the port must never import jax

import numpy as np  # noqa: E402
import torch  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-5
FULL, SPP = 1440, 64
NIF_SIZE, NIF_SPP = 512, 64
NIF_DIR = os.path.join(ROOT, "assets", "nif", "synthetic_urban_4k")
ENV_DIRS = 65536      # seeded directions of the env MLP checks
SUB_MAIN = 128        # Cornell main-path slots replayed by both versions,
SUB_MAIN_ROWS = 4     # on their first 4 of 16 stream rows (~40 s plain)
SUB_NIF = 2048        # flagship slots replayed by both routes
# The stress ladder at the JAX package's big-scene configuration
# (experiments/bigscene_bench.py:29-45): 256^2, spp 8, max_path_length 5.
LADDER = (512, 1024, 2048)
BIG_SIZE, BIG_SPP, BIG_MPL = 256, 8, 5
MAIN_GRID = 512       # the rung also rendered at the Cornell main traffic
# Slots of each rung's frame replayed by both routes: (its first slots, a
# block around its median lit slot), sized so the plain replays stay
# within about half a minute a rung.
LADDER_REPLAY = {512: (2048, 1024), 1024: (512, 256), 2048: (512, 256)}

# The spheres + urban_4k golden is the JAX package's jitted render; the
# port holds it to the split tolerance of tests/test_torch_env.py
# (test_render_holds_spheres_nif_golden): at least this share of the
# elements within rtol 1e-2, all within rtol 5e-2, and the image mean
# within 5e-4 relative.
GOLDEN_NIF_WITHIN_1E2 = 0.98
GOLDEN_NIF_MAX_REL = 5e-2
GOLDEN_NIF_MEAN_REL = 5e-4

# Card peaks for the bounds (NVIDIA's H100 SXM data sheet, dense, at 700 W):
PEAK_F32 = 67e12          # FLOP/s on the CUDA cores, an FMA counted as two
PEAK_BF16 = 989e12        # FLOP/s on the tensor cores
PEAK_BYTES = 3.35e12      # HBM bytes/s
# The row tests' arithmetic can use only half of PEAK_F32: it is built
# with -fmad=false, and only the closest-hit and shadow kernels' chain
# holds FMAs (where XLA contracts, rows.cuh), each one instruction. So the
# bounds count f32 instructions at the instruction rate, 132 SMs x 128 lanes
# x 1.98 GHz (the previous basis, FLOP at PEAK_F32, is kept beside them):
PEAK_F32_INSTR = PEAK_F32 / 2
# f32 add/sub/mul/div of one test, counted from ops/cuda/megakernel.cu
# (compares, min/max and selects not counted, so the bound stays low);
# none is an FMA there, so each is one instruction:
SLAB_TEST_FLOPS = 15  # one AABB: per axis 2 sub, 2 mul, 1 scale
ROW_TEST_FLOPS = 49   # row_chain 42 (6 dots of 5, recip 4, t 2, b1/b2 6)
#                       + acceptance 7 (et 2, eps 3, b1+b2 and 1+eps 2)
AP_TEST_FLOPS = 45    # one sphere/disc row: oc 3, tca 5, l2 7, td 2, t 2,
#                       dn 5, on 5, t_dsc 2, h 9, d2 5
# The same row test as rows.cuh contracts it (K4, K5, K6): 6 dots of 3
# (a product, 2 FMAs), the reciprocal 3, t 2, b1/b2 4, acceptance 6:
ROW_TEST_INSTR_FMA = 33
REC_BYTES = 40        # one path record, f32 x 10
# The shadow trace (K4): its frame's first bundles replayed by the plain
# route, and the bundles the plain version advances together on the card.
SHADOW_REPLAY = 16
SHADOW_REF_BUNDLES = 64
SLAB_FLAG_FLOPS = 18  # one (ray, block) slab flag: per axis 1 div, 2 sub, 3 mul
SHADOW_AP_FLOPS = 25  # one (ray, sphere or disc) test of K4's twins
# Where the glue and the K4 route may differ: on sphere hits only, as
# the t difference carries over (routes_agree). Measured on the Cornell +
# monkey 1440^2 frame (the CPU plain versions, which the card's kernels
# equal bit for bit): 1,491 of 34,357 sphere pixels differ, |dt|/t at
# most 1.18e-5, |d hit_p| <= |dt|, |d normal| <= 0.99 |dt| / r,
# |d rgb| <= 1.6 |d normal|.
SPHERE_SHARE = 0.1
SPHERE_T_REL = 5e-5
# Path B (the XLA-loop integrator) at full width: Cornell + monkey 1440^2
# at this spp, and the grid-512 scene at 256^2 spp 8.
PATH_B_SPP = 4
PATH_B_HBM = (256, 8)
# Bytes K5/K6 move per padded ray: the ray in (8 f32), t, row, n, m out
# (18 x 4 bytes), and per bundle and list entry the order and bound in.
INTERSECT_RAY_BYTES = (8 + 18) * 4


def sky(d: torch.Tensor) -> torch.Tensor:
    """An environment light that is not a NIF (a sky gradient over the
    direction's y): it sends ``render_streaming`` to the XLA-loop
    integrator, as tests/test_torch_glue.py ``sky``."""
    from ipu_ray_lib_tpu_torch.ops.vec3 import fma

    t = 0.5 * (d[:, 1] + 1.0)
    return torch.stack([fma(-0.5, t, 1.0), fma(-0.3, t, 1.0),
                        torch.ones_like(t)], -1) * 0.7


def log(*a):
    print(*a, flush=True)


_T0 = time.perf_counter()


def phase(name: str) -> None:
    """Log the start of a phase with the seconds since the script began."""
    log(f"[phase {name}] at {time.perf_counter() - _T0:.1f} s")


def close_count(a: np.ndarray, b: np.ndarray) -> tuple[int, float]:
    """(elements outside rtol = atol = TOL, max abs difference)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    bad = ~np.isclose(a, b, rtol=TOL, atol=TOL)
    return int(bad.sum()), float(np.max(np.abs(a - b))) if a.size else 0.0


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn, reps: int = 3,
             hold_ms: float = 0.0) -> tuple[list[float], object]:
    """CUDA-event times (ms) of ``reps`` calls, and the last result. With
    ``hold_ms`` a spin kernel of about that long runs before each call, so
    that the host has queued the call's launches before the card reaches
    them: the time is the card's, not the host's launch rate."""
    out, ms = None, []
    for _ in range(reps):
        if hold_ms:
            torch.cuda._sleep(int(hold_ms * 2e6))  # ~2e6 cycles per ms
        ev0 = torch.cuda.Event(enable_timing=True)
        ev1 = torch.cuda.Event(enable_timing=True)
        ev0.record()
        out = fn()
        ev1.record()
        torch.cuda.synchronize()
        ms.append(ev0.elapsed_time(ev1))
    return ms, out


def median(xs):
    return sorted(xs)[len(xs) // 2]


def k45_counting(launch) -> dict:
    """A counting launch of K4 or K5 (``launch(counters)`` makes one or
    more): the summed counters and the cycle split (shares of the
    lane-cycles)."""
    from ipu_ray_lib_tpu_torch.ops.cuda.build import K45_COUNTERS

    c = torch.zeros(len(K45_COUNTERS), dtype=torch.int64, device="cuda")
    launch(c)
    cnt = dict(zip(K45_COUNTERS, c.tolist()))
    cyc = {k: v for k, v in cnt.items() if k.startswith("cyc_")}
    tot = max(sum(cyc.values()), 1)
    cnt["split"] = {k[4:]: round(v / tot, 4) for k, v in cyc.items()}
    return cnt


@contextlib.contextmanager
def plain_walks():
    """The plain route: the closest-hit wrappers' CUDA calls (K5, K6)
    replaced by the plain versions on the same device (for replays
    only)."""
    from ipu_ray_lib_tpu_torch.ops import intersect_hbm as ih
    from ipu_ray_lib_tpu_torch.ops import intersect_kernel as ik

    saved = ik.dense_walk_cuda, ih.super_walk_cuda
    ik.dense_walk_cuda = ik.dense_walk_ref
    ih.super_walk_cuda = ih.super_walk_ref
    try:
        yield
    finally:
        ik.dense_walk_cuda, ih.super_walk_cuda = saved


def env_chain(dirs, env, exact_uv: bool = False, chunk: int = 1 << 21):
    """Library yardstick for the env MLP (never called by the port): the
    same network as a chain of bf16 torch.matmul with f32 bias, features
    from the plain torch math (``exact_uv``: the XLA env function's
    angles, as ``envk.env_mlp(..., exact_uv=True)`` takes them), in chunks
    of ``chunk`` directions (to bound its f32 temporaries). It sums on the
    same tensor cores as the kernel, so its deviation from the plain
    version shows how far a tensor-core sum order moves the result
    (``envk.within_yardstick``)."""
    from ipu_ray_lib_tpu_torch.nif.model import (decode_rgb, equirect_uvn,
                                                 fourier_features)

    def one(d):
        un, vn = equirect_uvn(d, env.rotation, exact_uv=exact_uv)
        feats = fourier_features(un, vn, env.config.embedding_dimension)
        x = feats
        for l, (_, _, relu, concat) in enumerate(env.layers):
            w, b = env.layer(l)
            if concat:
                x = torch.cat([x, feats], dim=1)
            x = torch.matmul(x.to(torch.bfloat16), w).to(torch.float32) + b
            if relu:
                x = torch.clamp_min(x, 0.0)
        return decode_rgb(x, env.max, env.mean, env.config.log_tone_map)

    return torch.cat([one(dirs[i:i + chunk])
                      for i in range(0, dirs.shape[0], chunk)])


# Phase 12, the sharded and progressive paths: a mesh of SHARDS shards of
# one card; the two-rank check at TWO_RANK_SIZE^2 spp TWO_RANK_SPP.
SHARDS = 3
SHARDED_MEAN_REL = 0.02  # the sharded frame's mean against one device's
TWO_RANK_SIZE, TWO_RANK_SPP = 256, 4
RANK_TIMEOUT = 300


def bits_equal(a, b) -> bool:
    """Bit for bit (+0 and -0 apart; NaN equal to its own bits)."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.kind == "f":
        a, b = a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}")
    return bool(np.array_equal(a, b))


def sharded_and_progressive(dev, scene, params, env, full=FULL,
                            spp=SPP) -> dict:
    """Phase 12: the sharded path trace (``render_streaming_sharded``) and
    shadow trace (``render_shadow_sharded``) on a mesh of SHARDS shards of
    ``dev``, the progressive path trace and the f16 readback, each
    kernel route against its plain route; ``scene``/``params``: the
    Cornell + monkey frame at full^2 spp. Raises on any failed check.
    Returns the numbers it logged."""
    import socket
    import subprocess
    import tempfile

    from ipu_ray_lib_tpu_torch.ops import env as envk
    from ipu_ray_lib_tpu_torch.ops import intersect_kernel as ik
    from ipu_ray_lib_tpu_torch.ops import megakernel as mk
    from ipu_ray_lib_tpu_torch.ops import shadow as sh
    from ipu_ray_lib_tpu_torch.ops.camera import generate_camera_rays
    from ipu_ray_lib_tpu_torch.parallel import (make_ray_mesh,
                                                render_shadow_sharded,
                                                render_streaming_sharded,
                                                shard_plan, shard_seeds)
    from ipu_ray_lib_tpu_torch.render import streaming
    from ipu_ray_lib_tpu_torch.render.renderer import _prep_f, render
    from ipu_ray_lib_tpu_torch.render.shadow import shadow_trace
    from ipu_ray_lib_tpu_torch.render.streaming import (render_streaming,
                                                        trace_batch,
                                                        uses_megakernel)
    from ipu_ray_lib_tpu_torch.runtime.device import gpu_identity
    from ipu_ray_lib_tpu_torch.scene.build import build_scene
    from ipu_ray_lib_tpu_torch.scene.builtin import (make_cornell_box_scene,
                                                     make_primitive_scene)

    monkey = os.path.join(ROOT, "assets", "monkey_bust.glb")
    t_phase = time.perf_counter()
    rmesh = make_ray_mesh([dev] * SHARDS)
    out = {"launches": {}}

    @contextlib.contextmanager
    def plain_megakernel():
        """The plain route of every path trace that reaches the megakernel:
        its entry replaced by ``megakernel_path_trace_ref`` on the same
        device (for replays only)."""
        saved = streaming.megakernel_path_trace
        streaming.megakernel_path_trace = mk.megakernel_path_trace_ref
        try:
            yield
        finally:
            streaming.megakernel_path_trace = saved

    # -- two processes (gloo), 2 shards of the card each, against one
    # process with 4 shards: started first, so that their start-up
    # overlaps the plain routes below, and collected before anything is
    # timed --
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    worker = os.path.join(ROOT, "tests", "torch_multihost_worker.py")
    tmp = tempfile.TemporaryDirectory()
    outs = [os.path.join(tmp.name, f"rank{r}.npz") for r in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, worker, str(port), str(r), "2", outs[r],
         "--device", str(dev), "--shards", "2", "--size",
         str(TWO_RANK_SIZE), "--spp", str(TWO_RANK_SPP), "--monkey",
         "--chunk-slots", str(1 << 17)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(2)]
    try:
        # -- the kernel route against the plain route, 64x64 spp 4 on SHARDS
        # shards: the megakernel (K1; R = 256, J = 6) and the XLA loop (K5;
        # R = 200 does not tile into 256) --
        ms, mp = build_scene(make_cornell_box_scene(monkey, box_only=False),
                             device=dev, image_width=64, image_height=64,
                             samples_per_pixel=4)
        for chunk in (256, 200):
            plan = shard_plan(mp, SHARDS, chunk)
            mega = uses_megakernel(plan.slots, None)
            if mega != (chunk == 256):
                raise AssertionError(f"chunk_slots {chunk} took the wrong "
                                     "route")
            mk.reset_launches()
            ik.reset_launches()
            (krgb, kdone), t_k = timed(lambda: render_streaming_sharded(
                ms, mp, rmesh, chunk_slots=chunk))
            kl = {"K1": mk.launches, "K5": ik.launches}
            with plain_megakernel() if mega else plain_walks():
                (prgb, pdone), t_p = timed(lambda: render_streaming_sharded(
                    ms, mp, rmesh, chunk_slots=chunk))
            same = bits_equal(krgb, prgb)
            name = f"sharded 64x64 spp 4, {SHARDS} shards, chunk_slots {chunk}"
            log(f"[{name}] R={plan.slots} J={plan.j_per_slot} n_valid "
                f"{plan.n_valid}, {'K1' if mega else 'XLA loop + K5'}: kernel "
                f"route {t_k:.3f} s, plain route {t_p:.3f} s; bit for bit "
                f"{same}; done {kdone}/{pdone}; launches {kl}")
            routed = (kl == {"K1": SHARDS, "K5": 0} if mega
                      else kl["K1"] == 0 and kl["K5"] > 0)
            if (not same or kdone != pdone or kdone != 64 * 64 * 4
                    or not routed):
                raise AssertionError(f"{name}: the kernel route disagrees "
                                     "with the plain route")
            out["launches"][f"chunk_slots {chunk}"] = kl

        # -- spheres + NIF 48x32 spp 2 on 2 shards (K1 record mode, K2, bank):
        # done bit for bit, the image at the env tolerance --
        ns, np_ = build_scene(make_primitive_scene(), device=dev,
                              image_width=48, image_height=32,
                              samples_per_pixel=2)
        for m in (mk, envk):
            m.reset_launches()
        (krgb, kdone), t_k = timed(lambda: render_streaming_sharded(
            ns, np_, make_ray_mesh([dev] * 2), env=env))
        kl = {"K1 record": mk.launches, "env MLP": envk.launches,
              "bank": mk.bank_launches}
        with plain_megakernel():
            (prgb, pdone), t_p = timed(lambda: render_streaming_sharded(
                ns, np_, make_ray_mesh([dev] * 2), env=env))
        dev_ = envk.deviation(krgb, prgb)
        out_of = envk.within_high_frequency(dev_)
        log(f"[sharded spheres+NIF 48x32 spp 2, 2 shards] kernel route "
            f"{t_k:.3f} s, plain route {t_p:.3f} s; done {kdone}/{pdone}; "
            f"within 1e-5 {dev_['within_1e5']:.6f}, within 1e-2 "
            f"{dev_['within_1e2']:.6f}, max rel {dev_['max_rel']:.4g}; "
            f"launches {kl}")
        if (out_of or kdone != pdone or kdone != 48 * 32 * 2
                or set(kl.values()) != {2}):
            raise AssertionError(f"sharded NIF render: {out_of}, done "
                                 f"{kdone} vs {pdone}, launches {kl}")
        out["launches"]["spheres+NIF"] = kl

        # -- the main path's last shard (full^2 on SHARDS shards: R = 131072,
        # J = 6, a partial pool) at spp 1 with the plan's rows, seed and
        # n_valid: K1 against its plain version bit for bit --
        plan = shard_plan(params, SHARDS)
        last = SHARDS - 1
        lrows, lcols = plan.coords(last, dev)
        lseed = int(shard_seeds(params.rng_seed, SHARDS, 0)[last])

        def last_shard():
            flat, d = trace_batch(scene, lrows, lcols, lseed,
                                  plan.n_valid[last], params=params,
                                  slots=plan.slots,
                                  j_per_slot=plan.j_per_slot, spp=1)
            return flat.cpu().numpy(), int(d)

        (kflat, kdone), t_k = timed(last_shard)
        with plain_megakernel():
            (pflat, pdone), t_p = timed(last_shard)
        same = bits_equal(kflat, pflat)
        out["last_shard"] = dict(n_valid=plan.n_valid[last], done=kdone,
                                 kernel_s=t_k, plain_s=t_p)
        log(f"[sharded main path, last shard] {full}^2 on {SHARDS} shards, "
            f"shard {last}: R={plan.slots} J={plan.j_per_slot} n_valid "
            f"{plan.n_valid[last]} seed {lseed:#x} spp 1: K1 {t_k:.3f} s, "
            f"plain {t_p:.3f} s; bit for bit {same}; done {kdone}/{pdone}")
        if not same or kdone != pdone or kdone != plan.n_valid[last]:
            raise AssertionError("the main path's last shard: K1 disagrees "
                                 "with its plain version")

        logs = [p.communicate(timeout=RANK_TIMEOUT)[0].decode()
                for p in procs]
        t_ranks = time.perf_counter() - t0
        for p, lg in zip(procs, logs):
            if p.returncode != 0:
                raise AssertionError(f"a rank failed ({p.returncode}):\n"
                                     f"{lg[-3000:]}")
        s2, p2 = build_scene(make_cornell_box_scene(monkey, box_only=False),
                             device=dev, image_width=TWO_RANK_SIZE,
                             image_height=TWO_RANK_SIZE,
                             samples_per_pixel=TWO_RANK_SPP)
        one4, one4_done = render_streaming_sharded(s2, p2,
                                                   make_ray_mesh([dev] * 4))
        ranks = [np.load(o) for o in outs]
        same = [bits_equal(r["rgb"], one4) for r in ranks]
        dones = [int(r["done"]) for r in ranks]
        out["two_ranks_s"] = t_ranks
        log(f"[two ranks] {TWO_RANK_SIZE}^2 spp {TWO_RANK_SPP}, 2 processes "
            f"x 2 shards of {dev}: collected {t_ranks:.1f} s after their "
            f"start (they ran beside the checks above); each rank's image bit "
            f"for bit the one-process "
            f"4-shard render's {same}; done {dones} (one process "
            f"{one4_done})")
        if not all(same) or dones != [one4_done] * 2:
            raise AssertionError("two ranks disagree with one process")

        # -- the sharded main path: Cornell + monkey full^2 spp on SHARDS
        # shards (R = 131072, J = 6), timed in turns with one device --
        log(f"[sharded main path] {full}^2 spp {spp} on {SHARDS} shards of "
            f"{dev}: R={plan.slots} J={plan.j_per_slot} n_valid "
            f"{plan.n_valid}")
        mk.reset_launches()
        (srgb, sdone), t_warm = timed(lambda: render_streaming_sharded(
            scene, params, rmesh))
        k1_sh = mk.launches
        t_sh, t_one = [], []
        for _ in range(3):
            (one, one_done), t = timed(lambda: render_streaming(scene, params))
            t_one.append(t)
            (srgb, sdone), t = timed(lambda: render_streaming_sharded(
                scene, params, rmesh))
            t_sh.append(t)
        paths = full * full * spp
        smean, omean = float(srgb.mean()), float(one.mean())
        out["main"] = dict(
            frame_s=t_sh, one_device_s=t_one, paths_per_s=paths / min(t_sh),
            one_device_paths_per_s=paths / min(t_one), mean=smean,
            one_device_mean=omean, slots=plan.slots,
            j_per_slot=plan.j_per_slot, k1_launches=k1_sh)
        log(f"[sharded main path] warm-up {t_warm:.3f} s; frames "
            f"{', '.join(f'{t:.3f}' for t in t_sh)} s, best "
            f"{paths / min(t_sh) / 1e6:.2f} M paths/s; one device in turns "
            f"{', '.join(f'{t:.3f}' for t in t_one)} s, best "
            f"{paths / min(t_one) / 1e6:.2f} M paths/s; mean {smean:.6f} (one "
            f"device {omean:.6f}); done {sdone}; K1 launches {k1_sh}; "
            f"{gpu_identity()}")
        if (sdone != paths or one_done != paths
                or srgb.shape != (full, full, 3)
                or not np.isfinite(srgb).all()
                or abs(smean - omean) > SHARDED_MEAN_REL * omean
                or k1_sh != SHARDS):
            raise AssertionError("the sharded main path failed its checks")

        # -- the sharded shadow trace of the full^2 raster-order rays against
        # one shadow_trace call on all of them (the shards' bundles of 1,024
        # rays fall where one call's do when full^2 / SHARDS is a multiple) --
        rr, cc = np.meshgrid(np.arange(full), np.arange(full), indexing="ij")
        rows = rr.ravel().astype(np.float32)
        cols = cc.ravel().astype(np.float32)
        if (full * full // SHARDS) % 1024:
            raise AssertionError("the shards' bundles would not align")
        sh.reset_launches()
        res_s, t_w = timed(lambda: render_shadow_sharded(scene, params, rows,
                                                         cols, rmesh))
        k4_sh = sh.launches
        _, t_s = timed(lambda: render_shadow_sharded(scene, params, rows, cols,
                                                     rmesh))

        def one_call():
            _, d = generate_camera_rays(
                torch.from_numpy(rows).to(dev), torch.from_numpy(cols).to(dev),
                params.image_width, params.image_height, params.fov_radians)
            r = shadow_trace(scene, None, d, intersector=params.intersector)
            return type(r)(*(t.cpu() for t in r))

        res_1, t_1 = timed(one_call)
        diff = [f for f in res_1._fields
                if not bits_equal(getattr(res_s, f).numpy(),
                                  getattr(res_1, f).numpy())]
        hits = int((res_s.geom_id >= 0).sum())
        out["shadow"] = dict(frame_ms=[t_w * 1e3, t_s * 1e3],
                             one_call_ms=t_1 * 1e3, k4_launches=k4_sh,
                             hits=hits)
        log(f"[sharded shadow] {full}^2 rays on {SHARDS} shards: "
            f"{t_w * 1e3:.1f}, {t_s * 1e3:.1f} ms (one call {t_1 * 1e3:.1f} "
            f"ms); fields differing from one call {diff}; hits {hits}; K4 "
            f"launches {k4_sh}")
        if diff or not hits or k4_sh != SHARDS:
            raise AssertionError("the sharded shadow trace differs from one "
                                 "call")

        # -- the progressive path trace, 64x64 spp 20 (batches 16 + 4), each
        # frame against the plain route's with the same batch seeds --
        pp = dataclasses.replace(mp, samples_per_pixel=20)
        frames, plain_frames = [], []
        mk.reset_launches()
        prog = render(ms, pp, mode="path-trace",
                      progress_callback=lambda bi, im: frames.append(
                          im.copy()))
        prog_l = mk.launches
        with plain_megakernel():
            plain, t_pp = timed(lambda: render(
                ms, pp, mode="path-trace",
                progress_callback=lambda bi, im: plain_frames.append(
                    im.copy())))
        bad = [bi for bi, (a, b) in enumerate(zip(frames, plain_frames))
               if not bits_equal(a, b)]
        log(f"[progressive 64x64 spp 20] callbacks {len(frames)}, frames "
            f"differing from the plain route {bad}, image bit for bit "
            f"{bits_equal(prog.rgb, plain.rgb)}; K1 launches {prog_l}; plain "
            f"route {t_pp:.3f} s")
        if (len(frames) != 2 or len(plain_frames) != 2 or bad
                or not bits_equal(prog.rgb, plain.rgb) or prog_l != 2):
            raise AssertionError("the progressive path trace differs from the "
                                 "plain route")
        frames = []
        mk.reset_launches()
        prog, t_prog = timed(lambda: render(
            scene, params, mode="path-trace",
            progress_callback=lambda bi, im: frames.append(im)))
        out["progressive"] = dict(frame_s=t_prog, callbacks=len(frames),
                                  k1_launches=mk.launches)
        log(f"[progressive {full}^2 spp {spp}] {t_prog:.3f} s, callbacks "
            f"{len(frames)}, K1 launches {mk.launches}, the last frame is the "
            f"image {bits_equal(frames[-1], prog.rgb)}")
        if (len(frames) != -(-spp // 16)
                or not bits_equal(frames[-1], prog.rgb)
                or not np.isfinite(prog.rgb).all()):
            raise AssertionError("the full-size progressive render failed")

        # -- the f16 readback: the path trace's image and the shadow AOVs --
        (f32, _), t32 = timed(lambda: render_streaming(scene, params))
        (f16, d16), t16 = timed(lambda: render_streaming(scene, params,
                                                         readback_f16=True))
        ok_img = bits_equal(f16, f32.astype(np.float16).astype(np.float32))
        a32, a16 = [], []
        img_t = torch.rand((full * full, 3), device=dev)
        for _ in range(5):
            _, t = timed(lambda: img_t.cpu())
            a32.append(t * 1e3)
            _, t = timed(lambda: img_t.to(torch.float16).cpu())
            a16.append(t * 1e3)
        s32, ts32 = timed(lambda: render(scene, params))
        s16, ts16 = timed(lambda: render(scene, params, readback_f16=True))
        fmax = float(np.finfo(np.float16).max)
        bad_aov = []
        for f in ("rgb", "t", "normal", "hit_p"):
            want = _prep_f(torch.from_numpy(getattr(s32, f)), True).numpy()
            if not bits_equal(getattr(s16, f), want.astype(np.float32)):
                bad_aov.append(f)
        bad_aov += [f for f in ("geom_id", "prim_id")
                    if not bits_equal(getattr(s16, f), getattr(s32, f))]
        out["f16"] = dict(frame_s=[t32, t16], shadow_frame_ms=[ts32 * 1e3,
                                                               ts16 * 1e3],
                          standin_readback_ms=[median(a32), median(a16)])
        log(f"[f16 readback] path trace {full}^2 spp {spp}: f32 {t32:.3f} s, "
            f"f16 {t16:.3f} s, the rounded f32 image bit for bit {ok_img}; a "
            f"stand-in tensor of the image's shape [{full * full}, 3] read "
            f"back: f32 {median(a32):.2f} ms, "
            f"cast + f16 {median(a16):.2f} ms (median of 5); shadow frame f32 "
            f"{ts32 * 1e3:.1f} ms, f16 {ts16 * 1e3:.1f} ms; AOVs differing "
            f"from the rounded f32 ones {bad_aov} (f16 max {fmax})")
        if not ok_img or d16 != full * full * spp or bad_aov:
            raise AssertionError("the f16 readback differs from the rounded "
                                 "f32")
    finally:
        for p in procs:
            p.kill()
            p.wait()
        tmp.cleanup()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[sharded] {json.dumps(out)}")
    return out


# Phase 13: the README's trace.py commands through trace_torch.py, at
# their own sizes (ROADMAP queue 1 items 4-5). (f) writes this grid's
# heightfield as a binary PLY.
APP_GRID = 512
APP_PROFILE = (256, 32)  # the progressive run and the profiled frame
FRAME_SPANS = ("streaming.upload", "streaming.batch", "streaming.readback",
               "streaming.scatter")  # the profiled frame's spans, in order


def write_ply(path: str, mesh) -> None:
    """A mesh as a binary little-endian PLY: float x, y, z per vertex and a
    uchar-counted int list per triangle (the port's importer reads it)."""
    tris = np.asarray(mesh.triangles)
    face = np.zeros(len(tris), np.dtype([("n", "u1"), ("i", "<i4", (3,))]))
    face["n"], face["i"] = 3, tris
    with open(path, "wb") as f:
        f.write((f"ply\nformat binary_little_endian 1.0\nelement vertex "
                 f"{len(mesh.vertices)}\nproperty float x\nproperty float y\n"
                 f"property float z\nelement face {len(tris)}\nproperty list "
                 "uchar int vertex_indices\nend_header\n").encode())
        f.write(np.asarray(mesh.vertices, "<f4").tobytes())
        f.write(face.tobytes())


def application(dev) -> dict:
    """Phase 13: ``trace_torch.run`` (the CLI's flow, in this process) with
    the README's commands at their own sizes, each kernel's launches
    counted from 0 around each command: (a) the main path through the CLI,
    its image against ``render_streaming`` of the same scene and params bit
    for bit; (b) the shadow trace with the oracle and the CPU twin, the
    card against the oracle within MSE 1e-3 (tests/test_cli.py:31) and
    equal to the CPU twin (K4 against its plain version); (c) an
    imported Collada scene; (d) the NIF light (K2); (e) compile only; (f)
    a 522,242-triangle PLY shadow-traced twice through the scene cache
    (path A, K6), the second run a cache hit with the same image, then
    path-traced at 256^2 spp 8 under the NIF sky (K3, K2); (g) the
    progressive path trace, and one ``utils/profiling.trace`` around a
    frame: its ``streaming.*`` spans, in order, and the card's idle time
    under each (``benchmark/spans.py``). Raises on any failed check.
    Returns the numbers it logged."""
    import tempfile

    from ipu_ray_lib_tpu_torch.ops import env as envk
    from ipu_ray_lib_tpu_torch.ops import intersect_hbm as ih
    from ipu_ray_lib_tpu_torch.ops import intersect_kernel as ik
    from ipu_ray_lib_tpu_torch.ops import megakernel as mk
    from ipu_ray_lib_tpu_torch.ops import shadow as sh
    from ipu_ray_lib_tpu_torch.render.renderer import DEFAULT_CHUNK
    from ipu_ray_lib_tpu_torch.render.streaming import render_streaming
    from ipu_ray_lib_tpu_torch.scene.build import build_scene
    from ipu_ray_lib_tpu_torch.scene.builtin import (make_cornell_box_scene,
                                                     make_stress_scene)
    from ipu_ray_lib_tpu_torch.scene.types import PathTraceSettings
    from ipu_ray_lib_tpu_torch.utils import profiling
    from ipu_ray_lib_tpu_torch.utils.exr import read_exr
    import trace_torch
    from benchmark import harness as bench_harness
    from benchmark import spans as bench_spans
    from benchmark import stats as bench_stats

    os.chdir(ROOT)  # the CLI finds assets/monkey_bust.glb as trace.py does
    t_phase = time.perf_counter()
    tmp = tempfile.TemporaryDirectory()
    out = {"commands": {}}

    def cli(name, argv):
        for m in (mk, envk, sh, ik, ih):
            m.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rec = trace_torch.run(argv + ["-o", os.path.join(tmp.name, name),
                                      "--log-level", "warn"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {"k1": mk.launches, "k3": mk.hbm_launches,
                    "bank": mk.bank_launches, "env": envk.launches,
                    "k4": sh.launches, "k5": ik.launches, "k6": ih.launches}
        p = rec.get("params")
        out["commands"][name] = dict(
            argv=argv, wall_s=wall, seconds=rec["seconds"], mse=rec["mse"],
            launches=launches, cache_hit=rec["cache_hit"],
            intersector=None if p is None else p.intersector)
        log(f"[app {name}] trace_torch.py {' '.join(argv)}: {wall:.2f} s; "
            + ", ".join(f"{k} {v:.3f} s" for k, v in rec["seconds"].items())
            + f"; launches {launches}"
            + (f"; MSE {rec['mse']}" if rec["mse"] else ""))
        return rec, launches

    def image(rec, shape):
        img = read_exr(rec["outputs"]["gpu"])
        if img.shape != shape or not np.isfinite(img).all():
            raise AssertionError(f"bad image {img.shape}, want {shape}")
        return img

    try:
        # (a) the main path through the CLI, against render_streaming of
        # the same scene and params (the CLI's slot pool: its --chunk-size,
        # 65,536, as trace.py passes it):
        rec, n = cli("a-main", ["--scene", "box", "-w", str(FULL), "-H",
                                str(FULL), "--samples", str(SPP),
                                "--gpu-only"])
        img = image(rec, (FULL, FULL, 3))
        desc = make_cornell_box_scene(os.path.join(ROOT, "assets",
                                                   "monkey_bust.glb"))
        desc.path_trace = PathTraceSettings(samples_per_pixel=SPP)
        scene, params = build_scene(desc, device=dev, image_width=FULL,
                                    image_height=FULL, samples_per_pixel=SPP)
        (ref, done), t_ref = timed(lambda: render_streaming(
            scene, params, chunk_slots=DEFAULT_CHUNK))
        same = bits_equal(img, ref)
        same_params = params == rec["params"]
        out["a"] = dict(bits_equal=same, params_equal=same_params,
                        render_streaming_s=t_ref, done=done,
                        mean=float(img.mean()))
        log(f"[app a] the CLI's {FULL}^2 spp {SPP} image against "
            f"render_streaming(chunk_slots={DEFAULT_CHUNK}) of the same "
            f"scene and params: bit for bit {same}, params equal "
            f"{same_params}; render_streaming {t_ref:.3f} s, done {done}, "
            f"mean {float(img.mean()):.6f}")
        if (not same or not same_params or n["k1"] < 1
                or done != FULL * FULL * SPP):
            raise AssertionError("(a): the CLI's main path differs from "
                                 "render_streaming")

        # (b) the shadow trace with the oracle and the CPU twin:
        rec, n = cli("b-shadow-oracle", ["--scene", "box-simple",
                                         "--render-mode", "shadow-trace",
                                         "--visualise", "normal"])
        image(rec, (432, 768, 3))
        out["b"] = dict(rec["mse"], oracle_rays_per_s=768 * 432
                        / rec["seconds"]["oracle"])
        log(f"[app b] MSE card vs oracle {rec['mse']['oracle']:.6g} (limit "
            f"1e-3), card vs CPU twin {rec['mse']['cpu']:.6g} (limit 0); "
            f"oracle {out['b']['oracle_rays_per_s']:.4g} rays/s; hits "
            f"{rec['hit_count']}")
        if not rec["mse"]["oracle"] < 1e-3 or n["k4"] < 1:
            raise AssertionError("(b): the card's shadow trace is off the "
                                 "oracle")
        # K4 against its plain version (the CPU twin) at this path's
        # shapes: equal, as every K4 check above holds it.
        if rec["mse"]["cpu"] != 0:
            raise AssertionError("(b): the card's shadow trace differs from "
                                 "the CPU twin")

        # (c) an imported scene:
        rec, n = cli("c-collada", ["--mesh-file", "assets/test_scene.dae",
                                   "--samples", "512", "--gpu-only"])
        img = image(rec, (432, 768, 3))
        if not img.mean() > 0 or n["k1"] < 1:
            raise AssertionError("(c): the Collada scene rendered black")

        # (d) the NIF light (K2):
        rec, n = cli("d-nif", ["--scene", "spheres", "--nif-hdri",
                               "assets/nif/synthetic_sky/assets.extra",
                               "--samples", "1000", "--gpu-only"])
        img = image(rec, (432, 768, 3))
        if not img.mean() > 0 or n["env"] < 1 or n["bank"] < 1:
            raise AssertionError("(d): the NIF-lit render failed")

        # (e) compile only: builds, writes no image:
        rec, n = cli("e-compile-only", ["--scene", "box", "-w", str(FULL),
                                        "-H", str(FULL), "--samples", "1000",
                                        "--compile-only"])
        written = [f for f in os.listdir(tmp.name) if f.startswith("e-")]
        if rec["outputs"] or written or "compile" not in rec["seconds"] \
                or any(n.values()):
            raise AssertionError(f"(e): compile-only wrote {written} or "
                                 f"launched {n}")

        # (f) a large imported scene, twice through the scene cache:
        ply = os.path.join(tmp.name, f"stress{APP_GRID}.ply")
        cache = os.path.join(tmp.name, "cache")
        t0 = time.perf_counter()
        write_ply(ply, make_stress_scene(APP_GRID).meshes[0])
        t_write = time.perf_counter() - t0
        argv = ["--mesh-file", ply, "--render-mode", "shadow-trace", "-w",
                str(FULL), "-H", str(FULL), "--gpu-only", "--scene-cache",
                cache]
        rec1, n1 = cli("f-ply-build", argv)
        rec2, n2 = cli("f-ply-cached", argv)
        a, b = (image(r, (FULL, FULL, 3)) for r in (rec1, rec2))
        same = bits_equal(a, b)
        out["f"] = dict(ply_write_s=t_write, ply_bytes=os.path.getsize(ply),
                        bundle_bytes=sum(os.path.getsize(os.path.join(
                            cache, f)) for f in os.listdir(cache)),
                        bits_equal=same)
        log(f"[app f] PLY of grid {APP_GRID} ({out['f']['ply_bytes']} bytes,"
            f" written in {t_write:.2f} s): import "
            f"{rec1['seconds']['import']:.2f} s, build "
            f"{rec1['seconds']['build']:.2f} s, bundle save "
            f"{rec1['seconds']['cache_save']:.2f} s "
            f"({out['f']['bundle_bytes']} bytes), load "
            f"{rec2['seconds']['cache_load']:.2f} s; intersector "
            f"{rec1['params'].intersector}; images bit for bit {same}")
        if (not same or rec1["cache_hit"] or not rec2["cache_hit"]
                or rec1["params"].intersector != "pallas-hbm"
                or n1["k6"] < 1 or n2["k6"] < 1):
            raise AssertionError("(f): the cached large scene differs")
        # ... and path-traced at the ladder's cell (K3; a new key), lit by
        # the NIF sky (the PLY holds no emitter):
        size, spp = BIG_SIZE, BIG_SPP
        rec, n = cli("f-ply-path", ["--mesh-file", ply, "-w", str(size),
                                    "-H", str(size), "--samples", str(spp),
                                    "--max-path-length", str(BIG_MPL),
                                    "--nif-hdri",
                                    "assets/nif/synthetic_sky/assets.extra",
                                    "--gpu-only", "--scene-cache", cache])
        img = image(rec, (size, size, 3))
        if (rec["cache_hit"] or n["k3"] < 1 or n["env"] < 1
                or not img.mean() > 0):
            raise AssertionError("(f): the large scene's path trace failed")

        # (g) progressive, and one profiled frame:
        size, spp = APP_PROFILE
        rec, n = cli("g-progressive", ["--scene", "box", "-w", str(size),
                                       "-H", str(size), "--samples",
                                       str(spp), "--progressive",
                                       "--gpu-only"])
        image(rec, (size, size, 3))
        if n["k1"] != -(-spp // 16):
            raise AssertionError(f"(g): {n['k1']} K1 launches")
        gs, gp = build_scene(make_cornell_box_scene(os.path.join(
            ROOT, "assets", "monkey_bust.glb")), device=dev,
            image_width=size, image_height=size, samples_per_pixel=spp)
        render_streaming(gs, gp)  # warm
        path = os.path.join(tmp.name, "frame_trace.json")
        n0 = len(profiling.recorded_spans())
        with profiling.trace(path) as prof:
            (_, gdone), t_prof = timed(lambda: render_streaming(gs, gp))
        dev_ev, host, _ = bench_harness._events(prof)
        # the spans as the benchmark reads them: the program's recorder
        mine = sorted(profiling.recorded_spans()[n0:])
        if not mine:
            raise AssertionError("(g): no streaming.* span recorded")
        # each inside the profile's range of it, on one clock; none copied
        # onto the card's row
        prof_spans = sorted(h for h in host if h[2].startswith("streaming."))
        clock_us = max(max(ks - s, e - ke) for (s, e, _), (ks, ke, _)
                       in zip(mine, prof_spans)) * 1e-3
        if ([h[2] for h in prof_spans] != [h[2] for h in mine]
                or clock_us > 1000.0
                or any(e.name.startswith("streaming.") for e in dev_ev)):
            raise AssertionError(
                f"(g): recorded spans {mine} against the profile's "
                f"{prof_spans} (clock {clock_us} us), or a card-side copy")
        lo, hi = mine[0][0], max(h[1] for h in mine)
        cards = [[(e.start, e.end) for e in dev_ev]]
        idle = sum(e - s for s, e in bench_stats.gaps(cards[0], lo, hi))
        under = {n: bench_spans.idle_under(cards, mine, lo, hi, (n,))
                 for n in FRAME_SPANS}
        out["g"] = dict(
            trace_bytes=os.path.getsize(path), frame_s=t_prof,
            spans=[h[2] for h in mine], device_events=len(dev_ev),
            frame_ms=(hi - lo) * 1e-6, idle_ms=idle * 1e-6,
            idle_ms_under={n: v * 1e-6 for n, v in under.items()
                           if v is not None},
            idle_under_no_span_ms=(idle - bench_spans.idle_under(
                cards, mine, lo, hi, ("streaming.",))) * 1e-6,
            clock_us=clock_us)
        log(f"[app g] torch.profiler around a {size}^2 spp {spp} frame "
            f"({t_prof:.3f} s): trace {out['g']['trace_bytes']} bytes, "
            f"spans {out['g']['spans']}, {len(dev_ev)} device events; "
            f"the card idle {out['g']['idle_ms']:.3f} ms of the spans' "
            f"{out['g']['frame_ms']:.3f} ms, by span (ms) "
            f"{out['g']['idle_ms_under']}, under no span "
            f"{out['g']['idle_under_no_span_ms']:.3f} ms; the recorder "
            f"within {clock_us:.1f} us of the profile's ranges")
        if (out["g"]["spans"] != list(FRAME_SPANS)
                or not out["g"]["trace_bytes"] or gdone != size * size * spp):
            raise AssertionError("(g): the frame's spans or trace are wrong")
    finally:
        tmp.cleanup()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[app] {json.dumps(out, default=str)}")
    return out


# Phase 14: the per-sample wavefront (render/path.py, ``render(streaming=
# False)``, ``render_path_sharded``) and NIF training (nif/train.py).
PS_SPP = 4            # the full-width per-sample frame's spp (cut from 64)
PS_MEAN_REL = 0.15    # its mean against render_streaming's at that spp
PS_WINDOW = 64        # the kernel-vs-plain window of the sharded route
TRAIN_ARCH = (12, 6, 320)      # E, layers, width: the reference family's
TRAIN_STEPS, TRAIN_BATCH = 300, 4096
TRAIN_HDRI = (512, 1024)
# The card's first TRAIN_CURVE_STEPS losses against the plain CPU run of
# the same steps (the same initial weights and batches; f32 products
# summed in other orders), the first step and the whole curve (measured
# on an H100: the first bit for bit, the curve within 2.78e-5, the weights
# after it within 3.7e-4 of a largest 0.88; tests/test_torch_nif_train.py
# holds the CPU's 50-step curve against optax's at the same 1e-4):
TRAIN_CURVE_STEPS = 20
TRAIN_FIRST_LOSS_REL = 1e-4
TRAIN_CURVE_REL = 1e-4
TRAINED_SIZE, TRAINED_SPP = 512, 16


def per_sample_and_training(dev, scene, params, full=FULL) -> dict:
    """Phase 14: (a) ``path_trace_sample``'s kernel route against its plain
    route (the closest-hit walks swapped for their plain versions on the
    card; the env MLP for ``env_mlp_ref``): Cornell + monkey 64x64 (K5),
    stress24 in HBM mode with the f32 and the bf16 payload (K6), spheres +
    NIF 48x32 (K2), every field bit for bit and the NIF-lit image within
    ``envk.within_high_frequency``; (b) ``render(streaming=False)`` of
    ``scene`` (Cornell + monkey) at full^2 spp PS_SPP in chunks of 65,536:
    a warm-up of one chunk under the NIF, then three timed frames, K5's
    launches and the host syncs, the frame split into K5 (CUDA events over
    the first frame's own calls) and the rest; (c) ``render_path_sharded``
    on SHARDS shards of the card, kernel vs plain on a PS_WINDOW^2 window
    and the full^2 spp PS_SPP frame under the NIF timed; in (b)'s warm-up
    and (c)'s frame, K2's own output on the first call's escapes against
    ``env_mlp_ref`` beside the torch.matmul chain (``envk.within_yardstick``);
    (d) ``train_nif`` at 6 x 320, E = 12 on ``synth_hdri``:
    TRAIN_CURVE_STEPS steps on the card against the CPU's, 300 steps timed,
    then the trained NIF saved, loaded and rendered through K1's record
    mode, K2 and the bank. Raises on any failed check; returns the numbers
    it logged."""
    import tempfile

    from ipu_ray_lib_tpu_torch.nif.model import load_nif_env
    from ipu_ray_lib_tpu_torch.nif.synth import synth_hdri
    from ipu_ray_lib_tpu_torch.nif.train import save_nif_assets, train_nif
    from ipu_ray_lib_tpu_torch.ops import env as envk
    from ipu_ray_lib_tpu_torch.ops import intersect_hbm as ih
    from ipu_ray_lib_tpu_torch.ops import intersect_kernel as ik
    from ipu_ray_lib_tpu_torch.ops import megakernel as mk
    from ipu_ray_lib_tpu_torch.ops.camera import (generate_camera_rays,
                                                  pixel_grid)
    from ipu_ray_lib_tpu_torch.parallel import (make_ray_mesh,
                                                render_path_sharded,
                                                shard_rays)
    from ipu_ray_lib_tpu_torch.render import streaming as rmod
    from ipu_ray_lib_tpu_torch.render.path import path_trace_sample
    from ipu_ray_lib_tpu_torch.render.renderer import DEFAULT_CHUNK, render
    from ipu_ray_lib_tpu_torch.render.streaming import render_streaming
    from ipu_ray_lib_tpu_torch.scene.build import build_scene
    from ipu_ray_lib_tpu_torch.scene.builtin import (make_cornell_box_scene,
                                                     make_primitive_scene,
                                                     make_stress_scene)
    from ipu_ray_lib_tpu_torch.utils import threefry as tf

    t_phase = time.perf_counter()
    out = {"launches": {}, "k2_gates": {},
           "max_abs_err": {"k5": 0.0, "k6": 0.0, "env": 0.0}}
    monkey = os.path.join(ROOT, "assets", "monkey_bust.glb")

    def reset():
        for m in (ik, ih, envk, mk):
            m.reset_launches()

    def counts() -> dict:
        return {"k5": ik.launches, "k6": ih.launches, "env": envk.launches,
                "k1": mk.launches, "k3": mk.hbm_launches,
                "bank": mk.bank_launches}

    def need(name, got, keys):
        """The kernels ``keys`` each launched at least once in ``got``."""
        missing = [k for k in keys if got[k] < 1]
        if missing:
            raise AssertionError(f"{name}: {missing} never launched")

    # -- (a) path_trace_sample: kernel route vs plain route --
    def sample_routes(name, key_err, sc, p, size_wh, spp, env=None):
        w, h = size_wh
        rows, cols = pixel_grid(w, h, 0, 0, dev)
        base = tf.PRNGKey(p.rng_seed)
        res = {"kernel": [], "plain": []}
        reset()
        for s in range(spp):
            skey = tf.fold_in(base, s)
            o, d = generate_camera_rays(rows, cols, p.image_width,
                                        p.image_height, p.fov_radians,
                                        p.anti_alias_scale,
                                        tf.fold_in(skey, 0xC0FFEE))
            run = lambda: path_trace_sample(
                sc, o, d, skey, p.max_path_length, p.roulette_start_depth,
                intersector=p.intersector)
            r = run()
            e = None if env is None else envk.env_mlp(r.esc_dir, env,
                                                      exact_uv=True)
            res["kernel"].append((r, e))
        got = counts()
        torch.cuda.synchronize()
        for s in range(spp):
            skey = tf.fold_in(base, s)
            o, d = generate_camera_rays(rows, cols, p.image_width,
                                        p.image_height, p.fov_radians,
                                        p.anti_alias_scale,
                                        tf.fold_in(skey, 0xC0FFEE))
            with plain_walks():
                r = path_trace_sample(sc, o, d, skey, p.max_path_length,
                                      p.roulette_start_depth,
                                      intersector=p.intersector)
            e = (None if env is None
                 else envk.env_mlp_ref(r.esc_dir, env, exact_uv=True))
            res["plain"].append((r, e))
        bad, e_max, img = 0, 0.0, {}
        for route in ("kernel", "plain"):
            acc = 0.0
            for r, e in res[route]:
                rgb = r.rgb
                if e is not None:
                    rgb = rgb + torch.where(r.escaped[:, None],
                                            r.esc_throughput * e, 0.0)
                acc = acc + rgb
            img[route] = (acc / spp).cpu().numpy()
        for (rk, _), (rp, _) in zip(res["kernel"], res["plain"]):
            for f in rk._fields:
                a, b = getattr(rk, f), getattr(rp, f)
                bad += int((a != b).sum())
                if a.is_floating_point():
                    e_max = max(e_max, float((a - b).abs().max()))
        out["max_abs_err"][key_err] = max(out["max_abs_err"][key_err], e_max)
        n_esc = sum(int(r.escaped.sum()) for r, _ in res["kernel"])
        line = (f"[per-sample {name}] {w}x{h} spp {spp}: launches {got}; "
                f"{bad} elements of the samples' fields differ from the "
                f"plain route; escapes {n_esc}")
        out_of = []
        if env is not None:
            dv = envk.deviation(img["kernel"], img["plain"])
            out_of = envk.within_high_frequency(dv)
            out["max_abs_err"]["env"] = max(
                out["max_abs_err"]["env"],
                float(np.abs(img["kernel"] - img["plain"]).max()))
            line += (f"; the NIF-lit image vs plain: within 1e-5 "
                     f"{dv['within_1e5']:.6f}, within 1e-2 "
                     f"{dv['within_1e2']:.6f}, max rel {dv['max_rel']:.4g}")
        elif not np.array_equal(img["kernel"], img["plain"]):
            bad += 1
        log(line)
        out["launches"][f"a_{name}"] = got
        if bad or out_of or not np.isfinite(img["kernel"]).all():
            raise AssertionError(f"per-sample {name}: the kernel route "
                                 f"disagrees with the plain route ({bad}, "
                                 f"{out_of})")
        return got

    small = lambda desc, size, **kw: build_scene(
        desc, device=dev, image_width=size[0], image_height=size[1],
        samples_per_pixel=2, **kw)
    sc, p = small(make_cornell_box_scene(monkey, box_only=False), (64, 64))
    need("Cornell + monkey", sample_routes("cornell+monkey", "k5", sc, p,
                                           (64, 64), 2), ["k5"])
    for split in (False, True):
        sc, p = small(make_stress_scene(24), (32, 32),
                      intersector="pallas-hbm", payload_split=split)
        need("stress24", sample_routes(
            f"stress24 {'bf16' if split else 'f32'} payload", "k6", sc, p,
            (32, 32), 2), ["k6"])
    env = load_nif_env(NIF_DIR, device=dev)
    sc, p = small(make_primitive_scene(), (48, 32))
    need("spheres + NIF", sample_routes("spheres+NIF", "env", sc, p,
                                        (48, 32), 2, env=env), ["env"])

    # -- K2 as the main path calls it --
    @contextlib.contextmanager
    def recording_env():
        """The env MLP's calls from ``env_term`` (render/streaming.py, the
        env term of every per-sample path) recorded as (dirs, rgb) for the
        length of the block."""
        k2_calls, saved_env = [], rmod.env_mlp

        def rec_env(dirs, env_, exact_uv=False):
            rgb = saved_env(dirs, env_, exact_uv)
            k2_calls.append((dirs, rgb))
            return rgb

        rmod.env_mlp = rec_env
        try:
            yield k2_calls
        finally:
            rmod.env_mlp = saved_env

    def k2_gate(name, k2_calls):
        """K2 (``exact_uv``) on the escaped rows of the first call that a
        main-path run made, its own output against ``env_mlp_ref`` beside
        the torch.matmul chain: the gate of ``envk.within_yardstick``."""
        dirs, got = k2_calls[0]
        esc = dirs.abs().sum(dim=1) > 0   # escape directions are unit
        dirs, got = dirs[esc], got[esc]
        want = envk.env_mlp_ref(dirs, env, exact_uv=True)
        want_np = want.cpu().numpy()
        dk = envk.deviation(got.cpu().numpy(), want_np)
        dl = envk.deviation(env_chain(dirs, env, exact_uv=True).cpu().numpy(),
                            want_np)
        bad = envk.within_yardstick(dk, dl)
        e_max = float((got - want).abs().max())
        out["max_abs_err"]["env"] = max(out["max_abs_err"]["env"], e_max)
        out["k2_gates"][name] = dict(rows=int(esc.numel()),
                                     escapes=int(esc.sum()), kernel=dk,
                                     chain=dl, max_abs_err=e_max)
        log(f"[per-sample K2] {name}: {int(esc.numel())} rows, "
            f"{int(esc.sum())} escapes; kernel (exact_uv) vs plain "
            f"{json.dumps(dk)}, max |diff| {e_max:.3g}; torch.matmul chain "
            f"vs plain {json.dumps(dl)}; gate failures {bad}")
        if bad or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"per-sample K2 {name}: outside its "
                                 f"tolerance: {bad}")

    # -- (b) render(streaming=False) at full width --
    pf = dataclasses.replace(params, samples_per_pixel=PS_SPP)
    n_paths = full * full * PS_SPP
    frame = lambda st=None: render(scene, pf, mode="path-trace",
                                   chunk_size=DEFAULT_CHUNK, streaming=False,
                                   stats=st)
    # The warm-up: one chunk of the frame (its centred window of
    # DEFAULT_CHUNK pixels at spp 1) under the NIF, K2's input recorded.
    side = int(DEFAULT_CHUNK ** 0.5)
    c0 = (full - side) // 2
    p_chunk = dataclasses.replace(params, samples_per_pixel=1, window_w=side,
                                  window_h=side, window_c=c0, window_r=c0)
    reset()
    with recording_env() as k2_calls:
        (_, t_warm) = timed(lambda: render(
            scene, p_chunk, mode="path-trace", chunk_size=DEFAULT_CHUNK,
            streaming=False, env=env))
    got_c = counts()
    out["launches"]["b_chunk_nif"] = got_c
    need("per-sample chunk under the NIF", got_c, ["k5", "env"])
    k2_gate(f"render(streaming=False), a chunk of {side * side}", k2_calls)
    del k2_calls
    # Three timed frames; the first also keeps K5's calls (inputs only),
    # to time K5 alone:
    calls, times, st = [], [], {}
    saved = ik.dense_walk_cuda

    def rec(sc_, *a):
        calls.append(a)
        return saved(sc_, *a)

    reset()
    for i in range(3):
        st = {}
        ik.dense_walk_cuda = rec if i == 0 else saved
        try:
            o_b, t = timed(lambda: frame(st))
        finally:
            ik.dense_walk_cuda = saved
        times.append(t)
    got = {k: v // 3 for k, v in counts().items()}
    need("per-sample frame", got, ["k5"])
    k5_ms, _ = event_ms(lambda: [ik.walk_cuda(scene, *a, hbm=False)
                                 for a in calls])
    # and behind a spin kernel, the card's time (the host's launch rate
    # hidden):
    k5_card_ms, _ = event_ms(lambda: [ik.walk_cuda(scene, *a, hbm=False)
                                      for a in calls], hold_ms=300.0)
    del calls
    (srgb, _), _ = timed(lambda: render_streaming(scene, pf))
    mean_rel = abs(float(o_b.rgb.mean()) / float(srgb.mean()) - 1.0)
    fm = median(times) * 1e3
    out["frame"] = dict(
        warmup_chunk_s=t_warm, frames_s=times,
        paths_per_s=n_paths / min(times), launches=got, syncs=st["syncs"],
        bounces=st["bounces"], errors=st["errors"], k5_ms=k5_ms,
        k5_card_ms=k5_card_ms, frame_ms=fm,
        host_share=1 - median(k5_card_ms) / fm, mean=float(o_b.rgb.mean()),
        streaming_mean=float(srgb.mean()), mean_rel=mean_rel)
    out["launches"]["b_frame"] = got
    log(f"[per-sample frame] Cornell + monkey {full}^2 spp {PS_SPP}, chunks "
        f"of {DEFAULT_CHUNK}: warm-up (one chunk, spp 1, under the NIF) "
        f"{t_warm:.3f} s, frames {', '.join(f'{t:.3f}' for t in times)} s "
        f"(the first keeps K5's inputs), best "
        f"{n_paths / min(times) / 1e6:.2f} M paths/s; launches per frame "
        f"{got}; host syncs {st['syncs']}, bounces {st['bounces']}, material "
        f"errors {st['errors']}; K5 alone over the frame's calls "
        f"{', '.join(f'{t:.2f}' for t in k5_ms)} ms (behind a spin kernel "
        f"{', '.join(f'{t:.2f}' for t in k5_card_ms)} ms), host share (frame "
        f"minus K5) {1 - median(k5_card_ms) / fm:.3f}; mean "
        f"{float(o_b.rgb.mean()):.6f} "
        f"vs render_streaming's {float(srgb.mean()):.6f} (rel "
        f"{mean_rel:.4f})")
    if (st["errors"] or not np.isfinite(o_b.rgb).all()
            or o_b.rgb.shape != (full, full, 3) or mean_rel > PS_MEAN_REL):
        raise AssertionError("the per-sample frame failed its checks")

    # -- (c) render_path_sharded on SHARDS shards of the card --
    rmesh = make_ray_mesh([dev] * SHARDS)

    def grid(n, c0):
        """The n x n window at (c0, c0), padded to whole shards."""
        rows, cols = pixel_grid(n, n, c0, c0, "cpu")
        pad = shard_rays(n * n, rmesh) - n * n
        return (torch.nn.functional.pad(rows, (0, pad)),
                torch.nn.functional.pad(cols, (0, pad)))

    rows, cols = grid(PS_WINDOW, (full - PS_WINDOW) // 2)
    key = tf.PRNGKey(params.rng_seed)
    pw = dataclasses.replace(params, samples_per_pixel=2)
    reset()
    a_k = render_path_sharded(scene, pw, rows, cols, key, rmesh)
    got_w = counts()
    with plain_walks():
        a_p = render_path_sharded(scene, pw, rows, cols, key, rmesh)
    out["launches"]["c_window"] = got_w
    need("sharded window", got_w, ["k5"])
    ok_w = bits_equal(a_k.numpy(), a_p.numpy())
    # The full frame under the NIF (trace_torch.py --nif-hdri --devices N):
    rows, cols = grid(full, 0)
    reset()
    s_st = {}
    with recording_env() as k2_calls:
        s_rgb, t_sh = timed(lambda: render_path_sharded(
            scene, pf, rows, cols, key, rmesh, env=env, stats=s_st))
    got_s = counts()
    out["launches"]["c_frame_nif"] = got_s
    need("sharded frame", got_s, ["k5", "env"])
    k2_gate(f"render_path_sharded, a shard of {rows.shape[0] // SHARDS}",
            k2_calls)
    del k2_calls
    out["sharded"] = dict(window_bits_equal=ok_w, window_launches=got_w,
                          frame_s=t_sh, frame_launches=got_s,
                          syncs=s_st["syncs"],
                          mean=float(s_rgb.mean()))
    log(f"[per-sample sharded] {SHARDS} shards: {PS_WINDOW}^2 window spp 2 "
        f"kernel vs plain bit for bit {ok_w} (launches {got_w}); {full}^2 "
        f"spp {PS_SPP} under the NIF: {t_sh:.3f} s = "
        f"{n_paths / t_sh / 1e6:.2f} M paths/s, launches {got_s}, host syncs "
        f"{s_st['syncs']}, mean {float(s_rgb.mean()):.6f}")
    if not ok_w or not torch.isfinite(s_rgb).all():
        raise AssertionError("render_path_sharded failed its checks")

    # -- (d) NIF training at the reference family's width --
    img = synth_hdri(*TRAIN_HDRI, seed=11)
    E, L, W = TRAIN_ARCH
    # TRAIN_CURVE_STEPS steps on the card and on the CPU from the same
    # seed: the card's run also starts cuBLAS and autograd (its time is
    # the cold start), so that the timed run is the steady state.
    curve, cpu_curve = [], []
    (m_card, _), t_cold = timed(lambda: train_nif(
        img, E, L, W, steps=TRAIN_CURVE_STEPS, batch_size=TRAIN_BATCH,
        device=dev, losses=curve))
    (m_cpu, _), t_cpu = timed(lambda: train_nif(
        img, E, L, W, steps=TRAIN_CURVE_STEPS, batch_size=TRAIN_BATCH,
        device="cpu", losses=cpu_curve))
    curve_rel = np.abs(np.asarray(curve) / np.asarray(cpu_curve) - 1.0)
    top = max(float(k.detach().abs().max()) for k in m_cpu.kernels)
    w_diff = max(float((a.detach().cpu() - b.detach()).abs().max())
                 for a, b in zip(m_card.parameters(), m_cpu.parameters()))
    losses = []
    (model, meta), t_train = timed(lambda: train_nif(
        img, E, L, W, steps=TRAIN_STEPS, batch_size=TRAIN_BATCH,
        device=dev, losses=losses))
    tail = float(np.mean(losses[-10:]))
    with tempfile.TemporaryDirectory() as tmp:
        save_nif_assets(model, meta, tmp)
        tenv = load_nif_env(tmp, device=dev)
    sc, p = build_scene(make_primitive_scene(), device=dev,
                        image_width=TRAINED_SIZE, image_height=TRAINED_SIZE,
                        samples_per_pixel=TRAINED_SPP)
    reset()
    (trgb, tdone), t_r = timed(lambda: render_streaming(sc, p, env=tenv))
    got_t = counts()
    out["training"] = dict(
        steps=TRAIN_STEPS, seconds=t_train, steps_per_s=TRAIN_STEPS / t_train,
        cold_steps=TRAIN_CURVE_STEPS, cold_s=t_cold, cpu_s=t_cpu,
        curve=curve, cpu_curve=cpu_curve,
        first_loss_rel=float(curve_rel[0]),
        curve_max_rel=float(curve_rel.max()),
        weights_max_abs_diff=w_diff, weights_max_abs=top,
        first_loss=losses[0], last10_loss=tail,
        render_s=t_r, render_launches=got_t, render_mean=float(trgb.mean()))
    out["launches"]["d_render"] = got_t
    log(f"[NIF training] {L} x {W}, E = {E}, batch {TRAIN_BATCH}, "
        f"synth_hdri {TRAIN_HDRI[0]}x{TRAIN_HDRI[1]}: {TRAIN_STEPS} steps in "
        f"{t_train:.3f} s = {TRAIN_STEPS / t_train:.1f} steps/s (the cold "
        f"{TRAIN_CURVE_STEPS} steps before it {t_cold:.3f} s); loss "
        f"{losses[0]:.6g} -> {tail:.6g} (mean of the last 10); the card's "
        f"first {TRAIN_CURVE_STEPS} losses vs the CPU's (its run "
        f"{t_cpu:.3f} s): first step rel {curve_rel[0]:.3g}, largest rel "
        f"{curve_rel.max():.3g} (at step {int(curve_rel.argmax())}), the "
        f"weights after them within {w_diff:.3g} (largest weight "
        f"{top:.3g}); saved, loaded and rendered (spheres {TRAINED_SIZE}^2 "
        f"spp {TRAINED_SPP}): {t_r:.3f} s, launches {got_t}, done {tdone}, "
        f"mean {float(trgb.mean()):.6f}")
    need("trained NIF render", got_t, ["k1", "env", "bank"])
    if (not np.isfinite(losses).all() or tail > 0.5 * losses[0]
            or curve_rel[0] > TRAIN_FIRST_LOSS_REL
            or curve_rel.max() > TRAIN_CURVE_REL
            or not np.isfinite(trgb).all()
            or tdone != TRAINED_SIZE * TRAINED_SIZE * TRAINED_SPP):
        raise AssertionError("NIF training failed its checks")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[per-sample] {json.dumps(out)}")
    return out


# Phase 15: the "bvh" and "dense" intersectors (K7, ops/cuda/bvh.cu; K8,
# ops/cuda/dense.cu) on every route that takes them.
# f32 instructions of one step of K7 (bvh.cu; compares, min/max and
# selects not counted, as above): the slab test, per axis lo + ext, 2 sub,
# 2 mul and the scale (15 + 3); and of one leaf test, the watertight
# triangle (9 sub; px/py 6 FMA; e 3 mul + 3 FMA; 2 x (2 add, 2 mul) for
# dx0, dy0; de 2 mul + 2 FMA + 1 mul; det 2 add; 3 mul; t_scaled 1 mul + 2
# FMA; 2 mul (t_far * det); 1 div, 1 mul; delta z/x/y 1 mul + 2 x (1 add,
# 1 mul); delta_e 5; delta_t 2 mul + 2 FMA + 2 mul), which bounds the
# sphere's and the disc's (fewer):
BVH_STEP_INSTR = 18
BVH_LEAF_INSTR = 58
# One (ray, triangle row) pair of K8 (dense.cu): 6 dots of 3 (a product
# and 2 FMAs), t 2 (sub, div), b1/b2 4, et 2 (add, div), eps 3 (add, FMA,
# mul), b1 + b2 and 1 + eps 2:
DENSE_PAIR_INSTR = 31
BVH_NODE_BYTES = 32
# The phase's sizes: the kernels against their plain versions on the
# 64^2 frame's calls and one 65,536-ray chunk of the 1440^2 frame; the
# shadow frames (warm-up + 3 each); path B at PATH_B_SPP, 2 frames each;
# the per-sample routes at 64^2 spp 2.
P15_SMALL = 64
P15_FRAMES = 3
P15_PATH_FRAMES = 2


def p15_entry(p15, key, max_err) -> dict:
    """K7's or K8's line of the kernels JSON from phase 15: its launches
    and times on the 1440^2 shadow frame (``launches_paths``: on each of
    the phase's paths), the plain version and the kernel on one chunk."""
    m = "bvh" if key == "k7" else "dense"
    fr = p15["shadow"][m]
    ch = p15["chunk"]
    return {
        "name": "bvh_walk" if key == "k7" else "dense_closest_tri",
        "route": "cuda",
        "source": f"ipu_ray_lib_tpu_torch/ops/cuda/{m}.cu",
        "replaces": ("ipu_ray_lib_tpu/ops/traversal.py:102" if key == "k7"
                     else "ipu_ray_lib_tpu/ops/dense.py:169"),
        "replaces_note": "a jnp lax loop, not a Pallas kernel",
        "launches": fr["launches"][key], "max_abs_err": max_err,
        "ms": median(fr["kernel_ms"]), "ms_card": median(fr["kernel_card_ms"]),
        "plain_ms": ch["plain_ms"][key],
        "bound_ms": fr["bound"][0], "bound_by": fr["bound"][1],
        "library_ms": ch["library_ms"] if key == "k8" else None,
        "ms_shape": f"one Cornell + monkey {FULL}^2 shadow frame: "
                    f"{fr['n_calls']} launches",
        "plain_shape": f"one {ch['rays']}-ray chunk of that frame",
        "kernel_ms_at_plain_shape": ch["kernel_ms"][key],
        "library_shape": (f"one {ch['rays']}-ray chunk of that frame"
                          if key == "k8" else None),
        "launches_paths": {k: v[key] for k, v in p15["launches"].items()
                           if k.endswith(m)},
        "frame_ms": median(fr["frames_s"]) * 1e3,
        "path_b": p15["path_b"][m],
        **({"counters": fr["counts"], "grid512": p15["grid512"]}
           if key == "k7" else {"pairs": fr["pairs"]}),
    }


@contextlib.contextmanager
def recording(mod, name):
    """``mod.name`` (a kernel's wrapper) records the arguments of its calls
    for the length of the block."""
    calls, saved = [], getattr(mod, name)

    def rec(*a):
        calls.append(a)
        return saved(*a)

    setattr(mod, name, rec)
    try:
        yield calls
    finally:
        setattr(mod, name, saved)


def yardstick_dense(rows, o, d, t_min, t_max):
    """Library yardstick for K8 (never called by the port): the JAX
    package's form, six f32 ``torch.matmul`` per block of 512 rows (TF32
    off), the elementwise test, ``min`` and ``argmin`` (utils/constants'
    WATERTIGHT_EPS_SCALE, the 1e-3 clamp)."""
    from ipu_ray_lib_tpu_torch.ops.dense import DENSE_COLS, TRI_BLOCK
    from ipu_ray_lib_tpu_torch.utils.constants import WATERTIGHT_EPS_SCALE

    best_t, best_i = t_max.clone(), torch.full_like(t_max, -1,
                                                    dtype=torch.int32)
    o_mag = o.abs().amax(dim=1, keepdim=True)
    for b0 in range(0, rows.shape[0], TRI_BLOCK):
        blk = rows[b0:b0 + TRI_BLOCK]
        tn, g1, g2 = (blk[:, DENSE_COLS[k]].t() for k in ("tn", "g1", "g2"))
        col = lambda k: blk[:, DENSE_COLS[k]][None]  # noqa: E731
        dn, on = torch.matmul(d, tn), torch.matmul(o, tn)
        t = (col("tnp0") - on) / dn
        b1 = torch.matmul(o, g1) + t * torch.matmul(d, g1) - col("g1p0")
        b2 = torch.matmul(o, g2) + t * torch.matmul(d, g2) - col("g2p0")
        et = (col("tnp0").abs() + on.abs()) / torch.where(dn == 0, 1.0,
                                                          dn).abs()
        eps = torch.clamp_max(float(WATERTIGHT_EPS_SCALE) * (
            col("tS") + col("tG") * (o_mag + et)), 1e-3)
        ok = ((dn != 0) & (b1 >= -eps) & (b2 >= -eps) & (b1 + b2 <= 1 + eps)
              & (t > t_min[:, None]) & (t < best_t[:, None]))
        t = torch.where(ok, t, float("inf"))
        lb, li = t.min(dim=1)
        better = lb < best_t
        best_t = torch.where(better, lb, best_t)
        best_i = torch.where(better, (li + b0).to(torch.int32), best_i)
    return best_t, best_i


def intersectors(dev, k4_frame, mega_mean, full=FULL) -> dict:
    """Phase 15: the ``"bvh"`` and ``"dense"`` intersectors, K7 and K8.

    (a) each kernel against its plain version, bit for bit, on the calls
    of a Cornell + monkey 64^2 shadow trace (camera rays and their shadow
    rays; K7 closest and any hit, K8), on one 65,536-ray chunk of the
    1440^2 frame, and on stress24 (K7);
    (b) ``render(mode="shadow-trace")`` of Cornell + monkey at 1440^2
    through each: a warm-up and 3 timed frames, K7/K8 alone over a
    frame's calls (CUDA events), the pixels that differ from phase 6b's K4
    frame counted (ties resolve otherwise; not gated); K7's counting launch
    over the frame's calls (its node visits and leaf tests: its bound);
    K8's library yardstick on the chunk;
    (c) the grid-512 heightfield (522,242 triangles) built for "bvh"
    (build seconds) and shadow-traced at 1440^2; "dense" on it, its tables
    skipped, raises;
    (d) ``render_streaming`` of Cornell + monkey at 1440^2 spp PATH_B_SPP
    on the XLA-loop integrator through each: frames, iterations, the
    kernel's share; the mean within PS_MEAN_REL of the megakernel's
    (``mega_mean``);
    (e) ``render(streaming=False)`` at 64^2 spp 2 through each, the kernel
    route against the plain route, bit for bit;
    (f) ``trace_torch.run`` with the README's second command and
    ``--intersector bvh`` / ``dense``: the card's image against the CPU
    twin at MSE 0, the oracle's MSE printed.
    Each path's launches are counted from 0 around it."""
    import dataclasses as dc
    import tempfile

    import trace_torch
    from ipu_ray_lib_tpu_torch.ops import bvh as kb
    from ipu_ray_lib_tpu_torch.ops import dense as kd
    from ipu_ray_lib_tpu_torch.ops import intersect_hbm as ih
    from ipu_ray_lib_tpu_torch.ops import intersect_kernel as ik
    from ipu_ray_lib_tpu_torch.ops import megakernel as mk
    from ipu_ray_lib_tpu_torch.ops import shadow as sh
    from ipu_ray_lib_tpu_torch.ops.camera import generate_camera_rays
    from ipu_ray_lib_tpu_torch.ops.cuda import build as cb
    from ipu_ray_lib_tpu_torch.render.pixels import pixel_stream
    from ipu_ray_lib_tpu_torch.render.renderer import DEFAULT_CHUNK, render
    from ipu_ray_lib_tpu_torch.render.streaming import render_streaming
    from ipu_ray_lib_tpu_torch.scene.build import build_scene
    from ipu_ray_lib_tpu_torch.scene.builtin import (make_cornell_box_scene,
                                                     make_stress_scene)

    t_phase = time.perf_counter()
    monkey = os.path.join(ROOT, "assets", "monkey_bust.glb")
    out = {"launches": {}, "max_abs_err": {"k7": 0.0, "k8": 0.0}}
    plain = {"k7": kb.bvh_walk_ref, "k8": kd.dense_closest_tri_ref}
    kern = {"k7": kb.bvh_walk_cuda, "k8": kd.dense_closest_tri_cuda}

    def reset():
        for m in (kb, kd, ik, ih, sh, mk):
            m.reset_launches()

    def counts() -> dict:
        return {"k7": kb.launches, "k8": kd.launches, "k4": sh.launches,
                "k5": ik.launches, "k6": ih.launches, "k1": mk.launches}

    def hold(name, key, calls):
        """Each recorded call of kernel ``key`` run by the kernel and by
        the plain version on the same inputs: every output bit for bit."""
        for a in calls:
            got = kern[key](*a)
            torch.cuda.synchronize()
            want = plain[key](*a)
            for g, w in zip(got, want):
                if w is None:
                    continue
                if not bits_equal(g.cpu().numpy(), w.cpu().numpy()):
                    raise AssertionError(f"{name}: {key} disagrees with its "
                                         "plain version")
                if g.is_floating_point():
                    fin = torch.isfinite(w)
                    e = float((g[fin] - w[fin]).abs().max()) if fin.any() \
                        else 0.0
                    out["max_abs_err"][key] = max(out["max_abs_err"][key], e)
        log(f"[p15 {name}] {key}: {len(calls)} calls of "
            f"{[a[2].shape[0] for a in calls][:4]}... rays, kernel vs plain "
            "bit for bit")

    def shadow_calls(sc, p, **kw):
        """A shadow-trace render with K7's and K8's calls recorded."""
        with recording(kb, "bvh_walk_cuda") as c7, \
                recording(kd, "dense_closest_tri_cuda") as c8:
            res = render(sc, p, **kw)
        return res, {"k7": c7, "k8": c8}

    # ---- (a) kernel vs plain ----
    cs, cp = build_scene(make_cornell_box_scene(monkey, box_only=False),
                         device=dev, image_width=full, image_height=full,
                         intersector="dense")
    params = {m: dc.replace(cp, intersector=m) for m in ("bvh", "dense")}
    small = {m: dc.replace(p, image_width=P15_SMALL, image_height=P15_SMALL,
                           window_w=P15_SMALL, window_h=P15_SMALL)
             for m, p in params.items()}
    for m, key in (("bvh", "k7"), ("dense", "k8")):
        _, calls = shadow_calls(cs, small[m], chunk_size=P15_SMALL ** 2)
        hold(f"Cornell + monkey {P15_SMALL}^2 shadow trace, {m}", key,
             calls[key])
    rows, cols = (a[:DEFAULT_CHUNK] for a in pixel_stream(cp).coords(
        dev, -(-full * full // DEFAULT_CHUNK) * DEFAULT_CHUNK))
    _, d0 = generate_camera_rays(rows, cols, full, full, cp.fov_radians)
    n0 = d0.shape[0]
    zeros, inf = (torch.zeros(n0, device=dev),
                  torch.full((n0,), float("inf"), device=dev))
    o0 = torch.zeros_like(d0)
    chunk7 = (cs, o0, d0, zeros, inf, False, True)
    chunk8 = (cs.dense_rows, o0, d0, zeros, inf)
    hold(f"one {n0}-ray chunk of the {full}^2 frame", "k7", [chunk7])
    hold(f"one {n0}-ray chunk of the {full}^2 frame", "k8", [chunk8])
    s24, p24 = build_scene(make_stress_scene(24), device=dev,
                           image_width=P15_SMALL, image_height=P15_SMALL,
                           intersector="bvh")
    _, calls = shadow_calls(s24, p24, chunk_size=P15_SMALL ** 2)
    hold(f"stress24 {P15_SMALL}^2 shadow trace", "k7", calls["k7"])
    # the plain versions' and the kernels' times on the chunk:
    t_plain = {}
    for key, a in (("k7", chunk7), ("k8", chunk8)):
        _, t_plain[key] = timed(lambda: plain[key](*a))
    k_chunk = {key: median(event_ms(lambda: kern[key](*a))[0])
               for key, a in (("k7", chunk7), ("k8", chunk8))}
    torch.backends.cuda.matmul.allow_tf32 = False
    lib_chunk = median(event_ms(lambda: yardstick_dense(*chunk8))[0])
    yt, yi = yardstick_dense(*chunk8)
    kt, ki = kern["k8"](*chunk8)
    out["yardstick_agree"] = float((yi == ki).float().mean())
    out["chunk"] = dict(rays=n0, kernel_ms=k_chunk, library_ms=lib_chunk,
                        plain_ms={k: v * 1e3 for k, v in t_plain.items()})
    log(f"[p15 chunk] {n0} rays: K7 {k_chunk['k7']:.3f} ms (plain "
        f"{t_plain['k7'] * 1e3:.1f} ms), K8 {k_chunk['k8']:.3f} ms (plain "
        f"{t_plain['k8'] * 1e3:.1f} ms, torch.matmul yardstick "
        f"{lib_chunk:.3f} ms, its rows equal K8's on "
        f"{out['yardstick_agree']:.4f} of the rays)")

    # ---- (b) the shadow trace at full width ----
    n_frame = full * full
    frames = {}
    for m, key in (("bvh", "k7"), ("dense", "k8")):
        p = params[m]
        res, t_warm = timed(lambda: render(cs, p))
        times = []
        for _ in range(P15_FRAMES):
            reset()
            res, t = timed(lambda: render(cs, p))
            times.append(t)
            got = counts()
        (_, calls), _ = timed(lambda: shadow_calls(cs, p))
        k_ms, _ = event_ms(lambda: [kern[key](*a) for a in calls[key]])
        card_ms, _ = event_ms(lambda: [kern[key](*a) for a in calls[key]],
                              hold_ms=300.0)
        hit = res.geom_id >= 0
        finite = all(bool(np.isfinite(getattr(res, f)[hit]).all())
                     for f in ("rgb", "t", "normal", "hit_p"))
        diff = {f: int((getattr(res, f) != getattr(k4_frame, f)).reshape(
            n_frame, -1).any(axis=1).sum()) for f in
            ("rgb", "t", "geom_id", "prim_id", "normal", "hit_p")}
        frames[m] = dict(warmup_s=t_warm, frames_s=times, launches=got,
                         kernel_ms=k_ms, kernel_card_ms=card_ms,
                         hits=res.hit_count, differ_from_k4=diff,
                         n_calls=len(calls[key]))
        out["launches"][f"b_{m}"] = got
        log(f"[p15 shadow {m}] Cornell + monkey {full}^2: warm-up "
            f"{t_warm:.3f} s, frames {', '.join(f'{t:.4f}' for t in times)} "
            f"s; launches per frame {got}; {key.upper()} alone over the "
            f"frame's {len(calls[key])} calls "
            f"{', '.join(f'{t:.2f}' for t in k_ms)} ms (behind a spin kernel "
            f"{', '.join(f'{t:.2f}' for t in card_ms)} ms); hits "
            f"{res.hit_count} (K4 frame {k4_frame.hit_count}); pixels that "
            f"differ from the K4 frame per AOV {diff}")
        if (not finite or got[key] < 1 or got["k4"] or got["k5"]
                or not 0 < res.hit_count < n_frame):
            raise AssertionError(f"(b) {m}: non-finite AOVs, no hits or the "
                                 "wrong kernels")
        # The bound over the frame's calls, for its real rays only (each
        # chunk's closest hit, then its any hit; the last chunk's padding
        # rays are not the frame's): each ray's inputs read once and its
        # outputs written once, as the call needs them (camera rays: no
        # origin; closest hit: t, geom, prim (K8: t, row); K7's any hit:
        # its flag), the tables once; K7's operations from its counting
        # launch over the real rays (node visits, leaf tests), K8's from
        # the pairs (padded rows x real rays).
        chunk = calls[key][0][2].shape[0]
        if len(calls[key]) != 2 * -(-n_frame // chunk) or (
                key == "k7" and any(a[5] != (i % 2 == 1)
                                    for i, a in enumerate(calls[key]))):
            raise AssertionError(f"(b) {m}: not one closest and one any hit "
                                 "per chunk")
        real = [min(chunk, n_frame - (i // 2) * chunk)
                for i in range(len(calls[key]))]
        rays = sum(real)
        words = 0
        for i, n_ in enumerate(real):
            camera = i % 2 == 0
            out_words = (3 if camera else 1) if key == "k7" else 2
            words += n_ * ((5 if camera else 8) + out_words)
        if key == "k7":
            c = torch.zeros(len(cb.BVH_COUNTERS), dtype=torch.int64,
                            device=dev)
            for (sc_, o_, d_, lo_, hi_, any_, zo_), n_ in zip(calls[key],
                                                              real):
                i_ = torch.empty(n_, dtype=torch.int32, device=dev)
                cb.launch_bvh(sc_, o_[:n_], d_[:n_], lo_[:n_], hi_[:n_],
                              torch.empty(n_, device=dev), i_, i_.clone(),
                              any_hit=any_, zero_origin=zo_, counters=c)
            cnt = dict(zip(cb.BVH_COUNTERS, c.tolist()))
            ops = (cnt["node_visits"] * BVH_STEP_INSTR
                   + cnt["leaf_tests"] * BVH_LEAF_INSTR)
            tables = (cs.bvh_nodes.numel() + cs.verts.numel()
                      + cs.tri_v.numel()) * 4
            frames[m]["counts"] = cnt
        else:
            frames[m]["pairs"] = rays * cs.dense_rows.shape[0]
            ops = frames[m]["pairs"] * DENSE_PAIR_INSTR
            tables = cs.dense_rows.numel() * 4
        nbytes = words * 4 + tables
        frames[m].update(rays=rays, bytes=nbytes, ops=ops,
                         bound_parts={"operations": ops / PEAK_F32_INSTR
                                      * 1e3,
                                      "bytes": nbytes / PEAK_BYTES * 1e3})
        frames[m]["bound"] = max((v, k) for k, v in
                                 frames[m]["bound_parts"].items())
        log(f"[p15 bound {key.upper()}] {rays} real rays of "
            f"{sum(a[2].shape[0] for a in calls[key])} traced, "
            f"{frames[m].get('counts') or frames[m]['pairs']}, {nbytes} "
            f"bytes: {frames[m]['bound'][0]:.4f} ms "
            f"({frames[m]['bound'][1]}; operations "
            f"{frames[m]['bound_parts']['operations']:.4f} ms, bytes "
            f"{frames[m]['bound_parts']['bytes']:.4f} ms)")
        del calls
    out["shadow"] = frames

    # ---- (c) "bvh" at any size: the grid-512 heightfield ----
    (bs, bp), t_build = timed(lambda: build_scene(
        make_stress_scene(MAIN_GRID), device=dev, image_width=full,
        image_height=full, intersector="bvh"))
    res, t_warm = timed(lambda: render(bs, bp))
    times = []
    for _ in range(P15_FRAMES):
        reset()
        res, t = timed(lambda: render(bs, bp))
        times.append(t)
        got_c = counts()
    out["launches"]["c_bvh"] = got_c
    (_, calls), _ = timed(lambda: shadow_calls(bs, bp))
    k_ms_c, _ = event_ms(lambda: [kb.bvh_walk_cuda(*a) for a in calls["k7"]])
    hold(f"grid {MAIN_GRID} {full}^2, chunk 0", "k7", calls["k7"][:2])
    hit = res.geom_id >= 0
    try:
        render(bs, dc.replace(bp, intersector="dense"))
        refused = False
    except RuntimeError as e:
        refused = "DENSE_TABLE_MAX_TRIS" in str(e)
    out["grid512"] = dict(build_s=t_build, nodes=bp.num_bvh_nodes,
                          warmup_s=t_warm, frames_s=times, k7_ms=k_ms_c,
                          hits=res.hit_count, dense_refused=refused)
    log(f"[p15 grid {MAIN_GRID}] build {t_build:.2f} s ({bp.num_bvh_nodes} "
        f"nodes); {full}^2 shadow trace through bvh: warm-up {t_warm:.3f} "
        f"s, frames {', '.join(f'{t:.4f}' for t in times)} s; launches "
        f"{got_c}; K7 alone over the frame's {len(calls['k7'])} calls "
        f"{', '.join(f'{t:.2f}' for t in k_ms_c)} ms; hits {res.hit_count};"
        f" 'dense' without its tables refused: {refused}")
    if (not refused or got_c["k7"] < 1 or not hit.any()
            or not all(bool(np.isfinite(getattr(res, f)[hit]).all())
                       for f in ("t", "normal", "hit_p"))):
        raise AssertionError("(c) the grid-512 scene through bvh failed")
    del bs, calls

    # ---- (d) path B (the XLA loop) through each ----
    paths = {}
    for m, key in (("bvh", "k7"), ("dense", "k8")):
        pb = dc.replace(params[m], samples_per_pixel=PATH_B_SPP)
        times, st = [], {}
        for i in range(P15_PATH_FRAMES):
            reset()
            st = {}
            with recording(kb, "bvh_walk_cuda") as c7, \
                    recording(kd, "dense_closest_tri_cuda") as c8:
                (rgb, done), t = timed(lambda: render_streaming(cs, pb,
                                                                stats=st))
            times.append(t)
            got = counts()
            calls = {"k7": c7, "k8": c8}[key] if i == 0 else calls
        # the loop's calls (bounce rays from non-zero origins, offset
        # t_min, dead lanes at t_max = -1) against the plain version, then
        # the kernel alone over all of them behind a spin kernel: the
        # card's time, not the host's launch rate
        hold(f"path B {m}", key, calls[:2])
        k_ms, _ = event_ms(lambda: [kern[key](*a) for a in calls], reps=2,
                           hold_ms=300.0)
        mean_rel = abs(float(rgb.mean()) / mega_mean - 1.0)
        share = median(k_ms) / (median(times) * 1e3)
        paths[m] = dict(frames_s=times, iterations=st["iters"],
                        launches=got, kernel_card_ms=k_ms,
                        kernel_share=share, mean=float(rgb.mean()),
                        mean_rel=mean_rel, done=done)
        out["launches"][f"d_{m}"] = got
        log(f"[p15 path B {m}] Cornell + monkey {full}^2 spp {PATH_B_SPP}, "
            f"no env: frames {', '.join(f'{t:.3f}' for t in times)} s, "
            f"{st['iters']} iterations, launches {got}; {key.upper()} alone "
            f"over the frame's {len(calls)} calls behind a spin kernel "
            f"{', '.join(f'{t:.1f}' for t in k_ms)} ms (share "
            f"{share:.4f}); done {done}; mean "
            f"{float(rgb.mean()):.6f} vs the megakernel's {mega_mean:.6f} "
            f"(rel {mean_rel:.4f})")
        if (done != n_frame * PATH_B_SPP or not np.isfinite(rgb).all()
                or mean_rel > PS_MEAN_REL or got[key] < 1 or got["k1"]
                or got["k5"]):
            raise AssertionError(f"(d) path B through {m} failed")
        del calls
    out["path_b"] = paths

    # ---- (e) the per-sample wavefront: kernel route vs plain route ----
    for m, key in (("bvh", "k7"), ("dense", "k8")):
        p = dc.replace(small[m], samples_per_pixel=2)
        reset()
        ker = render(cs, p, mode="path-trace", streaming=False,
                     chunk_size=P15_SMALL ** 2)
        got = counts()
        mod, name = (kb, "bvh_walk_cuda") if key == "k7" else \
            (kd, "dense_closest_tri_cuda")
        saved = getattr(mod, name)
        setattr(mod, name, plain[key])
        try:
            pln = render(cs, p, mode="path-trace", streaming=False,
                         chunk_size=P15_SMALL ** 2)
        finally:
            setattr(mod, name, saved)
        same = bits_equal(ker.rgb, pln.rgb)
        out["launches"][f"e_{m}"] = got
        log(f"[p15 per-sample {m}] {P15_SMALL}^2 spp 2: kernel route vs "
            f"plain route bit for bit {same}; launches {got}; mean "
            f"{float(ker.rgb.mean()):.6f}")
        if not same or got[key] < 1:
            raise AssertionError(f"(e) per-sample route through {m} failed")

    # ---- (f) trace_torch.py with --intersector bvh / dense ----
    tmp = tempfile.TemporaryDirectory()
    out["cli"] = {}
    try:
        for m, key in (("bvh", "k7"), ("dense", "k8")):
            reset()
            rec, t = timed(lambda: trace_torch.run([
                "--scene", "box-simple", "--render-mode", "shadow-trace",
                "--visualise", "normal", "--intersector", m, "-o",
                os.path.join(tmp.name, m), "--log-level", "warn"]))
            got = counts()
            out["cli"][m] = dict(seconds=t, mse=rec["mse"], launches=got,
                                 parts=rec["seconds"])
            out["launches"][f"f_{m}"] = got
            log(f"[p15 cli {m}] --scene box-simple --render-mode "
                f"shadow-trace --visualise normal --intersector {m}: {t:.2f} "
                f"s ({', '.join(f'{k} {v:.2f}' for k, v in rec['seconds'].items())}"
                f"); MSE vs the CPU twin {rec['mse']['cpu']}, vs the oracle "
                f"{rec['mse']['oracle']:.4g}; launches {got}")
            if rec["mse"]["cpu"] != 0 or got[key] < 1:
                raise AssertionError(f"(f) the CLI through {m} failed")
    finally:
        tmp.cleanup()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"[p15] {json.dumps(out, default=str)}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    quick = "--quick" in sys.argv[1:]

    from ipu_ray_lib_tpu_torch.bvh.builder import INVALID_GEOM_ID
    from ipu_ray_lib_tpu_torch.nif.model import load_nif_env
    from ipu_ray_lib_tpu_torch.ops import env as envk
    from ipu_ray_lib_tpu_torch.ops import intersect_hbm as ih
    from ipu_ray_lib_tpu_torch.ops import intersect_kernel as ik
    from ipu_ray_lib_tpu_torch.ops import megakernel as mk
    from ipu_ray_lib_tpu_torch.ops import shadow as sh
    from ipu_ray_lib_tpu_torch.ops.camera import generate_camera_rays
    from ipu_ray_lib_tpu_torch.ops.cull import super_cull_lists_bundle
    from ipu_ray_lib_tpu_torch.render import renderer as rnd
    from ipu_ray_lib_tpu_torch.render.pixels import pixel_stream
    from ipu_ray_lib_tpu_torch.render.renderer import (DEFAULT_CHUNK,
                                                       _read_back, render)
    from ipu_ray_lib_tpu_torch.scene import types as st
    from ipu_ray_lib_tpu_torch.ops.cuda import build as cuda_build
    from ipu_ray_lib_tpu_torch.render.shadow import (DEFAULT_LIGHT_POS,
                                                     shadow_trace)
    from ipu_ray_lib_tpu_torch.render.streaming import (
        ACTIVE_CHECK, MAX_K_PER_DISPATCH, SPP_BATCH, render_streaming,
        slot_pool)
    from ipu_ray_lib_tpu_torch.runtime.device import cuda_device, gpu_identity
    from ipu_ray_lib_tpu_torch.scene.build import build_scene
    from ipu_ray_lib_tpu_torch.scene.builtin import (make_cornell_box_scene,
                                                     make_primitive_scene,
                                                     make_stress_scene)

    dev = cuda_device(0)
    identity = gpu_identity()
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    log(f"gpu: {identity}")

    t0 = time.perf_counter()
    cuda_build.load()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"(nvcc {cuda_build.build_info.get('seconds', 0.0):.2f} s)")
    log(cuda_build.build_info.get("log", ""))
    # ptxas' registers, spills and shared memory of K4's and K5's
    # instantiations (<counting launch>):
    fn, res = None, {}
    for line in cuda_build.build_info.get("log", "").splitlines():
        if "Function properties for" in line:
            fn = line.split()[-1]
        elif fn and ("shadow_kernel" in fn or "bundle_kernel" in fn) and (
                "Used" in line or "spill" in line):
            res.setdefault(fn, []).append(line.split(":", 1)[-1].strip())
    for fn, lines in sorted(res.items()):
        log(f"[ptxas K4/K5] {fn}: {'; '.join(lines)}")

    mesh = os.path.join(ROOT, "assets", "monkey_bust.glb")
    err = {"k1": 0.0, "k1_rec": 0.0, "env": 0.0, "bank": 0.0, "k3": 0.0,
           "k4": 0.0, "k5": 0.0, "k6": 0.0, "k7": 0.0, "k8": 0.0}

    def stream(params, chunk=1 << 17):
        n_pix = params.window_w * params.window_h
        R, J = slot_pool(n_pix, chunk)
        rows, cols = pixel_stream(params).coords(dev, R * J)
        return rows, cols, R, J, n_pix

    def bad_pixels(a, b):
        return int((~np.isclose(a, b, rtol=TOL, atol=TOL)).any(axis=1).sum())

    def fmt_dev(d):
        return (f"within 1e-5 {d['within_1e5']:.6f}, within 1e-2 "
                f"{d['within_1e2']:.6f}, max rel {d['max_rel']:.4g}, mean rel "
                f"{d['mean_rel']:.3g}")

    def compare(name, scene, params, rows, cols, R, J, n_valid, spp,
                seed=1442, env=None, stats=None, key="k1", slot0=0,
                k_total=None):
        """Kernel route and plain route on the same stream and seed (one
        dispatch of K = J*spp paths per slot; the slots are slots
        [slot0, slot0 + R) of their pool, their paths numbered as in a
        schedule of ``k_total`` paths per slot, J*spp by default). Without
        ``env`` the images
        agree at rtol = atol = 1e-5. With ``env`` the tensor-core env MLP
        sums in its own order, so ``done`` and every path record (the
        trajectories: colour, throughput, escape flag, direction) agree
        bit for bit, the records banked with the env term left out (the
        bank kernel against the plain bank) and every pixel none of whose
        paths escaped too, and the images at the env tolerance
        (``envk.within_high_frequency``).
        Returns (kernel image, plain image, kernel s, plain s, the mask of
        the pixels one of whose paths escaped, or None)."""
        kw = dict(params=params, slots=R, j_per_slot=J, spp=spp,
                  max_iters=J * spp * params.max_path_length + 16,
                  slot0=slot0, k_total=k_total)
        (fk, dk), t_k = timed(lambda: mk.megakernel_path_trace(
            scene, rows, cols, seed, n_valid, env=env, **kw))
        if env is None:
            (fp, dp), t_p = timed(lambda: mk.megakernel_path_trace_ref(
                scene, rows, cols, seed, n_valid, stats=stats, **kw))
            fk, fp = fk.cpu().numpy(), fp.cpu().numpy()
            bad, e = close_count(fk, fp)
            err[key] = max(err[key], e)
            log(f"[{name}] R={R} J={J} spp={spp}: kernel {t_k:.3f} s, plain "
                f"{t_p:.3f} s, done {int(dk)}/{int(dp)}, mismatched pixels "
                f"{bad_pixels(fk, fp)} of {R * J}, max |diff| {e:.3g}")
            if bad or int(dk) != int(dp):
                raise AssertionError(f"{name}: kernel disagrees with plain "
                                     f"({bad} elements, done {int(dk)} vs "
                                     f"{int(dp)})")
            return fk, fp, t_k, t_p, None
        # The plain route by hand, to keep its records: the plain trace in
        # record mode, the plain env MLP and the plain bank.
        (rec_p, dp), t_p = timed(lambda: mk._trace(
            mk._accumulate_plain, scene, rows, cols, seed, n_valid,
            record=True, stats=stats, **kw))
        rec_k, dk_rec = mk.trace_records(scene, rows, cols, seed, n_valid,
                                         **kw)
        real = mk.real_records(rec_p, dp)
        rec_bad = int((rec_k[:, real] != rec_p[:, real]).sum())
        # The records banked with every env term left out: the bank
        # kernel against the plain bank, bit for bit.
        no_env = lambda r: torch.cat([r[:6], torch.zeros_like(r[6:7]),
                                      r[7:]])
        bank_bad = int((mk.bank(no_env(rec_k), dk_rec, spp)
                        != mk.bank_ref(no_env(rec_p), dp, spp)).sum())
        err[key] = max(err[key], float((rec_k[:, real] - rec_p[:, real])
                                       .abs().max()))
        wet = mk.escaped_pixels(rec_p, dp, spp).cpu().numpy()
        (fp, _), t_img = timed(lambda: (mk.image(rec_p, dp, spp, env,
                                                 envk.env_mlp_ref,
                                                 mk.bank_ref), None))
        fk, fp = fk.cpu().numpy(), fp.cpu().numpy()
        dev_ = envk.deviation(fk, fp)
        dry_bad = int((fk[~wet] != fp[~wet]).sum())
        out_of = envk.within_high_frequency(dev_)
        log(f"[{name}] R={R} J={J} spp={spp}, env: kernel {t_k:.3f} s, plain "
            f"{t_p + t_img:.3f} s, done {int(dk)}/{int(dp.sum())} (record mode "
            f"{int(dk_rec.sum())}); {rec_bad} record fields of "
            f"{int(real.sum()) * 10} differ, {bank_bad} banked without the "
            f"env; the image vs plain "
            f"{fmt_dev(dev_)}, max |diff| {float(np.abs(fk - fp).max()):.3g};"
            f" {int((~wet).sum())} of {wet.size} pixels without an escaped "
            f"path, {dry_bad} elements of them differ")
        if (rec_bad or bank_bad or dry_bad or out_of
                or int(dk) != int(dp.sum())
                or not torch.equal(dk_rec.long(), dp.long())):
            raise AssertionError(f"{name}: kernel route disagrees with plain "
                                 f"(records {rec_bad}, dry pixels {dry_bad}, "
                                 f"tolerance {out_of}, done {int(dk)} vs "
                                 f"{int(dp.sum())})")
        return fk, fp, t_k, t_p + t_img, wet

    def kernel_vs_plain(name, scene, params, spp, **kw):
        rows, cols, R, J, n_pix = stream(params)
        return compare(name, scene, params, rows, cols, R, J, n_pix, spp,
                       **kw)

    def replay(name, scene, params, rgb, rows, cols, R, J, spp, slot0, n,
               key, env=None, jn=None):
        """A frame's own pixels on its slots [slot0, slot0 + n) (its
        first ``jn`` stream rows, all J by default, all spp samples; the
        frame ran one spp batch seeded params.rng_seed), replayed by the
        kernel and the plain route and held against the frame's image at
        rtol = atol = 1e-5. A path's pid (slot*J*spp + k) and its pixel
        (row k // spp) do not depend on the rows replayed, so the first
        jn rows of a slot replay its first jn*spp paths."""
        jn = J if jn is None else jn
        idx = (np.arange(jn)[:, None] * R + slot0
               + np.arange(n)[None]).ravel()
        want = rgb.reshape(-1, 3)[pixel_stream(params).order[idx]]
        idx_t = torch.from_numpy(idx).to(dev)
        sub_k, sub_p, t_k, t_p, wet = compare(
            f"{name}, slots {slot0}..{slot0 + n - 1}"
            + (f", stream rows 0..{jn - 1} of {J}" if jn < J else ""),
            scene, params, rows[idx_t], cols[idx_t], n, jn, n * jn, spp,
            seed=params.rng_seed, env=env, key=key, slot0=slot0,
            k_total=J * spp)
        for what, got in (("kernel", sub_k), ("plain", sub_p)):
            if env is not None and what == "kernel":
                # the same kernels on the same paths: bit for bit
                bad = int((got != want).sum())
                extra = ""
            elif env is not None:
                # the plain env MLP sums otherwise: the env tolerance, and
                # the pixels without an escaped path bit for bit
                out_of = envk.within_high_frequency(envk.deviation(got, want))
                dry_bad = int((got[~wet] != want[~wet]).sum())
                bad = len(out_of) + dry_bad
                extra = (f"; {fmt_dev(envk.deviation(got, want))}, pixels "
                         f"without an escape differing {dry_bad}")
            else:
                bad, e = close_count(got, want)
                err[key] = max(err[key], e)
                extra = ""
            log(f"[{name} pixels] {what} on slots {slot0}..{slot0 + n - 1} "
                f"vs the frame's image: {bad_pixels(got, want)} of {n * jn} "
                f"pixels differ at 1e-5, max |diff| "
                f"{float(np.abs(got - want).max()):.3g}, lit "
                f"{int((want.sum(axis=1) > 0).sum())}{extra}")
            if bad:
                raise AssertionError(f"{name} pixels disagree with the "
                                     f"{what} route ({bad})")
        return t_k, t_p

    def k1_counts(name, scene, params, rows, cols, R, J, n_valid, spp, walk,
                  want, seed=1442):
        """A counting launch of K1 against the plain walk's counts ``walk``
        (segments, and the admitted (segment, block) pairs as the lanes'
        blocks), exactly, its image bit for bit K1's ``want`` (the
        kernel's image of ``compare`` on the same stream and seed)."""
        kw = dict(params=params, slots=R, j_per_slot=J, spp=spp,
                  max_iters=J * spp * params.max_path_length + 16)
        c = torch.zeros(len(cuda_build.COUNTERS), dtype=torch.int64,
                        device=dev)
        acc, done = mk._trace(mk._accumulate_cuda, scene, rows, cols, seed,
                              n_valid, counters=c, **kw)
        got = dict(zip(cuda_build.COUNTERS, c.tolist()))
        same = np.array_equal(mk.image(acc, done, spp).cpu().numpy(), want)
        log(f"[{name} K1 counting launch] image bit for bit {same}; "
            f"segments {got['segments']}, lanes' blocks {got['lane_blocks']};"
            f" the plain walk's {walk['segments']}, {walk['block_tests']}")
        if (not same or got["segments"] != walk["segments"]
                or got["lane_blocks"] != walk["block_tests"]):
            raise AssertionError(f"{name}: K1's counting launch disagrees "
                                 "with the plain walk")

    phase("2")
    # ---- 2. Cornell: kernel vs plain, and vs the golden ----
    gs, gp = build_scene(make_cornell_box_scene(None, box_only=False),
                         device=dev, image_width=48, image_height=32,
                         samples_per_pixel=2)
    kernel_vs_plain("golden 48x32", gs, gp, 2)
    golden = np.load(os.path.join(ROOT, "tests", "golden", "box48x32_spp2.npy"))
    rgb, done = render_streaming(gs, gp)
    bad, e = close_count(rgb, golden)
    log(f"[golden 48x32] render_streaming vs golden: {bad} elements "
        f"outside 1e-5, max |diff| {e:.3g}, done {done}")
    if bad or done != 48 * 32 * 2:
        raise AssertionError("golden image mismatch")

    ms, mp = build_scene(make_cornell_box_scene(mesh, box_only=False),
                         device=dev, image_width=64, image_height=64,
                         samples_per_pixel=4)
    walk2 = {}
    k64, f64, _, _, _ = kernel_vs_plain("monkey 64x64", ms, mp, 4, stats=walk2)
    small_mean = float(f64[:64 * 64].mean())
    k1_counts("monkey 64x64", ms, mp, *stream(mp), 4, walk2, k64)

    phase("3")
    # ---- 3. spheres + NIF: kernel route vs plain route, golden, env MLP ----
    env = load_nif_env(NIF_DIR, device=dev)
    ns, np_ = build_scene(make_primitive_scene(), device=dev, image_width=48,
                          image_height=32, samples_per_pixel=2)
    kernel_vs_plain("spheres+NIF 48x32", ns, np_, 2, env=env, key="k1_rec")
    nif_golden = np.load(os.path.join(ROOT, "tests", "golden",
                                      "spheres_nif48x32_spp2.npy"))
    rgb, done = render_streaming(ns, np_, env=env)
    rel = np.abs(rgb - nif_golden) / np.maximum(np.abs(nif_golden), 1e-30)
    bad, _ = close_count(rgb, nif_golden)
    within = float((rel <= 1e-2).mean())
    mean_rel = abs(float(rgb.mean()) / float(nif_golden.mean()) - 1.0)
    log(f"[spheres+NIF golden 48x32] render_streaming vs golden: {bad} of "
        f"{rgb.size} elements outside 1e-5, {within:.4f} within rtol 1e-2, "
        f"max rel {rel.max():.4g}, mean rel {mean_rel:.3g}, done {done}")
    if (done != 48 * 32 * 2 or within < GOLDEN_NIF_WITHIN_1E2
            or rel.max() > GOLDEN_NIF_MAX_REL
            or mean_rel > GOLDEN_NIF_MEAN_REL):
        raise AssertionError("spheres+NIF golden outside the CPU test's "
                             "tolerance")
    n6, p6 = build_scene(make_primitive_scene(), device=dev, image_width=64,
                         image_height=64, samples_per_pixel=4)
    kernel_vs_plain("spheres+NIF 64x64", n6, p6, 4, env=env, key="k1_rec")

    # Library yardstick for the env MLP (env_chain, never called by the
    # port): how far a tensor-core sum order moves the result.
    from ipu_ray_lib_tpu_torch.nif.model import equirect_uvn

    def library_mlp(d):
        return env_chain(d, env)

    def env_worst(name, dirs, got, want, lib, k=6):
        """Where the kernel lies furthest from the plain version: the
        elements beyond rtol 1e-2, how many of them the chain misses too,
        their brightness against all, their elevation, the decoded value
        (the log radiance, which the relative difference of exp follows),
        and the ``k`` largest relative differences with their directions
        and the chain's difference there."""
        g, w, c = got.double(), want.double(), lib.double()
        rel = (g - w).abs() / w.abs().clamp_min(1e-30)
        rel_c = (c - w).abs() / w.abs().clamp_min(1e-30)
        over = rel > 1e-2
        rows = over.any(dim=1)
        top = torch.topk(rel.flatten(), k).indices
        r_, ch = top // 3, top % 3
        un, vn = equirect_uvn(dirs[r_], env.rotation)
        q = lambda x: [round(float(v), 6) for v in x]
        summ = dict(
            over_1e2=int(over.sum()), chain_over_1e2_there=int(
                (over & (rel_c > 1e-2)).sum()),
            median_plain=float(w.abs().median()),
            median_plain_over=float(w[over].abs().median())
            if bool(over.any()) else None,
            dir_y_over=q(torch.quantile(dirs[rows][:, 1].double(), torch.tensor(
                [0.0, 0.5, 1.0], dtype=torch.float64, device=dirs.device)))
            if bool(rows.any()) else None,
            worst=[dict(dir=q(dirs[i]), uv=[round(float(u), 6),
                                            round(float(v), 6)],
                        ch="RGB"[int(c_)], plain=float(w[i, c_]),
                        kernel=float(g[i, c_]), chain=float(c[i, c_]),
                        log_plain=float(torch.log(w[i, c_].abs())),
                        rel=float(rel[i, c_]), rel_chain=float(rel_c[i, c_]))
                   for i, c_, u, v in zip(r_.tolist(), ch.tolist(), un, vn)])
        log(f"[{name}] where the kernel lies furthest: {json.dumps(summ)}")
        return summ

    def env_gate(name, got, want, lib, dirs):
        """The env MLP kernel's output ``got`` against the plain version's
        ``want``, beside the library chain's ``lib``, on ``dirs``: the gate
        of ``envk.within_yardstick``. Returns (kernel, chain) deviations."""
        env_worst(name, dirs, got, want, lib)
        want_np = want.cpu().numpy()
        dk_ = envk.deviation(got.cpu().numpy(), want_np)
        dl_ = envk.deviation(lib.cpu().numpy(), want_np)
        err["env"] = max(err["env"], float((got - want).abs().max()))
        bad = envk.within_yardstick(dk_, dl_)
        log(f"[{name}] kernel vs plain: {fmt_dev(dk_)}, max |diff| "
            f"{float((got - want).abs().max()):.3g}, finite "
            f"{bool(torch.isfinite(got).all())}; torch.matmul chain vs plain: "
            f"{fmt_dev(dl_)}; gate (slack: shares "
            f"{envk.YARDSTICK_SHARE_SLACK:g}, max rel x"
            f"{envk.YARDSTICK_MAX_REL_SLACK:g}, mean rel "
            f"{envk.YARDSTICK_MEAN_REL_SLACK:g}) failures {bad}")
        if bad or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name}: the env MLP kernel lies outside "
                                 f"its tolerance: {bad}")
        return dk_, dl_

    rng = np.random.default_rng(7)
    dirs_np = rng.normal(size=(ENV_DIRS, 3)).astype(np.float32)
    dirs_np /= np.linalg.norm(dirs_np, axis=1, keepdims=True)
    dirs = torch.from_numpy(dirs_np).to(dev)
    env_k, t_ek = timed(lambda: envk.env_mlp(dirs, env))
    env_p, t_ep = timed(lambda: envk.env_mlp_ref(dirs, env))
    log(f"[env MLP, {ENV_DIRS} directions] kernel {t_ek:.4f} s, plain "
        f"{t_ep:.3f} s")
    env_dev_small = env_gate(f"env MLP, {ENV_DIRS} directions", env_k, env_p,
                             library_mlp(dirs), dirs)
    # The launch refuses a pack whose stages overfill the kernel's weight
    # ring (more k-tiles or n-tiles a stage than env_mlp.cu's KG, NCH):
    for knob in ("MMA_KG", "MMA_NCH"):
        keep = getattr(envk, knob)
        setattr(envk, knob, 2 * keep)
        try:
            wide = envk.pack_mma(env)
        finally:
            setattr(envk, knob, keep)
        one = dirs[:1].contiguous()
        try:
            cuda_build.launch_env_mlp(one, torch.empty_like(one), env, wide)
            refused = False
        except RuntimeError:
            refused = True
        log(f"[env MLP] a pack with {knob} x2 refused at launch: {refused}")
        if not refused:
            raise AssertionError(f"the env MLP launch took stages past its "
                                 f"ring ({knob} x2)")

    phase("3b")
    # ---- 3b. HBM mode (K3): kernel vs plain, the stress golden ----
    def hbm_scene(scene_desc, w, h, spp, **kw):
        return build_scene(scene_desc, device=dev, image_width=w,
                           image_height=h, samples_per_pixel=spp,
                           intersector="pallas-hbm", **kw)

    hs, hp = hbm_scene(make_stress_scene(24), 32, 32, 2, max_path_length=4)
    kernel_vs_plain("stress24 HBM 32x32", hs, hp, 2, key="k3")
    hgold = np.load(os.path.join(ROOT, "tests", "golden",
                                 "stress24_hbm32x32_spp2.npy"))
    rgb, done = render_streaming(hs, hp)
    bad, e = close_count(rgb, hgold)
    log(f"[stress24 HBM golden] render_streaming vs golden: {bad} elements "
        f"outside 1e-5, max |diff| {e:.3g}, done {done}")
    if bad or done != 32 * 32 * 2:
        raise AssertionError("HBM golden image mismatch")
    hm, hmp = hbm_scene(make_cornell_box_scene(mesh, box_only=False), 64,
                        64, 4)
    kernel_vs_plain("monkey 64x64 HBM", hm, hmp, 4, key="k3")
    hm, hmp = hbm_scene(make_cornell_box_scene(mesh, box_only=False), 64,
                        64, 4, payload_split=True)
    kernel_vs_plain("monkey 64x64 HBM, bf16 payload", hm, hmp, 4, key="k3")
    hs, hp = hbm_scene(make_stress_scene(24), 32, 32, 2, max_path_length=4,
                       payload_split=True)
    kernel_vs_plain("stress24 HBM 32x32, bf16 payload", hs, hp, 2, key="k3")
    hs, hp = hbm_scene(make_stress_scene(24), 48, 32, 2)
    kernel_vs_plain("stress24 HBM + NIF 48x32", hs, hp, 2, env=env, key="k3")
    # K3's counting launch against the plain walk's counts (segments,
    # slab tests at each level, blocks walked), exactly:
    hs, hp = hbm_scene(make_stress_scene(64), 32, 32, 2)
    rows3, cols3, R3, J3, n3 = stream(hp)
    kw3 = dict(params=hp, slots=R3, j_per_slot=J3, spp=2,
               max_iters=J3 * 2 * hp.max_path_length + 16)
    walk3 = {}
    ref3, _ = mk._trace(mk._accumulate_plain, hs, rows3, cols3, 1442, n3,
                        stats=walk3, **kw3)
    c3 = torch.zeros(len(cuda_build.COUNTERS), dtype=torch.int64, device=dev)
    acc3, _ = mk._trace(mk._accumulate_cuda, hs, rows3, cols3, 1442, n3,
                        counters=c3, **kw3)
    got3 = dict(zip(cuda_build.COUNTERS, c3.tolist()))
    want3 = {k: walk3[k] for k in ("segments", "group_tests", "super_tests",
                                   "member_tests")}
    want3["lane_blocks"] = walk3["block_tests"]
    same3 = torch.equal(acc3, ref3)
    log(f"[stress64 HBM 32x32 counting launch] accumulator bit for bit "
        f"{same3}; counters {got3}; the plain walk's counts {want3}")
    if not same3 or any(got3[k] != v for k, v in want3.items()):
        raise AssertionError("K3's counting launch disagrees with the "
                             "plain walk")
    # A pool that is not whole warps: its last warp's lanes past the pool
    # take part in the walk with no path of their own.
    compare("stress64 HBM, a pool of 1000 slots", hs, hp, rows3[:1000],
            cols3[:1000], 1000, 1, 1000, 2, key="k3")

    def records_vs_plain(name, scene, params, rows, cols, R, J, n_valid,
                         walk):
        """K3 in record mode against the plain route at one path per
        pixel (spp 1): every finished path's colour, throughput, escape
        flag and last direction, which follow each hit the walk finds;
        ``walk`` gains the plain version's counts at each level."""
        kw = dict(params=params, slots=R, j_per_slot=J, spp=1,
                  max_iters=J * params.max_path_length + 16)
        (rk, dk), t_k = timed(lambda: mk.trace_records(
            scene, rows, cols, 1442, n_valid, **kw))
        (rp_, dp), t_p = timed(lambda: mk._trace(
            mk._accumulate_plain, scene, rows, cols, 1442, n_valid,
            record=True, stats=walk, **kw))
        real = (torch.arange(J, device=dev)[:, None]
                < dp.to(dev)[None, :])
        got, want = rk[:, real].cpu().numpy(), rp_[:, real].cpu().numpy()
        bad, e = close_count(got, want)
        err["k3"] = max(err["k3"], e)
        n_esc = int(want[6].sum())
        log(f"[{name}] R={R} J={J} spp 1, record mode: kernel {t_k:.3f} s, "
            f"plain {t_p:.3f} s, done {int(dk.sum())}/{int(dp.sum())}, "
            f"{bad} of {got.size} record fields differ, max |diff| {e:.3g}; "
            f"{got.shape[1]} paths, {n_esc} escaped; walk {walk}")
        if bad or not torch.equal(dk.cpu().to(torch.int64), dp.cpu()):
            raise AssertionError(f"{name}: K3 records disagree with the "
                                 f"plain version ({bad} fields)")
        return t_k, t_p

    def hbm_bound(scene, walk, scale, R, J):
        """K3's bound: the larger of its operations (the plain walk's
        counts x scale) at the f32 peak and its bytes (every table read
        once, the stream read, the accumulator and done written once)."""
        slab = (walk["group_tests"] + walk["super_tests"]
                + walk["member_tests"])
        ops = scale * (slab * SLAB_TEST_FLOPS
                       + walk["block_tests"] * 128 * ROW_TEST_FLOPS
                       + walk["segments"] * scene.n_ap * AP_TEST_FLOPS)
        nbytes = (sum(t.numel() * t.element_size() for t in (
            scene.p, scene.nrm, scene.baabb, scene.saabb, scene.sgaabb,
            scene.ap, scene.apay)) + R * J * (2 + 3) * 4 + R * 4)
        return (max((ops / PEAK_F32_INSTR * 1e3, "operations"),
                    (nbytes / PEAK_BYTES * 1e3, "bytes")), ops, nbytes,
                max(ops / PEAK_F32, nbytes / PEAK_BYTES) * 1e3)

    def walk_summary(c):
        """Derived measures of a counting launch's counters: the cycle
        split, per segment the slab tests and the blocks a lane walks, and
        for the warp walk the lanes walking together, the blocks the warp
        stages (the union over its lanes) and the walk's SIMT efficiency
        (the lanes' blocks over union x lanes)."""
        cyc = {k: c[f"cyc_{k}"] for k in ("group", "slab", "rows", "other")}
        tot = sum(cyc.values())
        seg = max(c["segments"], 1)
        out = {"cycles": cyc,
               "share": {k: v / tot for k, v in cyc.items()},
               "per_segment": {k: c[k] / seg for k in (
                   "group_tests", "super_tests", "member_tests",
                   "lane_blocks")}}
        if c["warp_walks"]:
            lanes = c["warp_lanes"] / c["warp_walks"]
            out.update(lanes_per_walk=lanes,
                       union_per_walk=c["union_blocks"] / c["warp_walks"],
                       lane_blocks_per_walk=c["lane_blocks"] / c["warp_walks"],
                       simt_efficiency=c["lane_blocks"]
                       / max(c["union_blocks"] * lanes, 1),
                       spread_share=c["spread_blocks"]
                       / max(c["union_blocks"], 1))
        return out

    def walk_counters(name, scene, rows, cols, n_valid, kw, want):
        """One counting launch of K3 (K1 on a VMEM-mode scene) at a
        frame's shapes (the counters of cuda_build.COUNTERS, compiled in
        only there), its image held bit for bit against ``want``, the
        kernel's image at those shapes."""
        c = torch.zeros(len(cuda_build.COUNTERS), dtype=torch.int64,
                        device=dev)
        acc, done = mk._trace(mk._accumulate_cuda, scene, rows, cols,
                              kw["params"].rng_seed, n_valid, counters=c,
                              **kw)
        same = torch.equal(mk.image(acc, done, kw["spp"]), want)
        cnt = dict(zip(cuda_build.COUNTERS, c.tolist()))
        summ = walk_summary(cnt)
        log(f"[{name} counters] image bit for bit {same}; "
            f"{json.dumps(cnt)}; {json.dumps(summ)}")
        if not same:
            raise AssertionError(f"{name}: the counting launch disagrees "
                                 "with its launch")
        return dict(counters=cnt, summary=summ)

    def rung(grid, width, spp, mpl, replays):
        """One scene of the stress ladder: host build, the walk counts of
        the plain version at the frame's pool with spp 1 (kernel vs plain
        there too), one warm-up and three timed renders, K3 alone, the
        frame's own pixels replayed by both routes."""
        t0 = time.perf_counter()
        desc = make_stress_scene(grid)
        t_make = time.perf_counter() - t0
        rs, rp = build_scene(desc, device=dev, image_width=width,
                             image_height=width, samples_per_pixel=spp,
                             max_path_length=mpl)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        n_tri = len(desc.meshes[0].triangles)
        nb = rs.num_blocks
        split = bool((rs.nrm == rs.nrm.to(torch.bfloat16).float()).all())
        log(f"[stress{grid}] {n_tri} triangles, {nb} blocks, "
            f"{rs.saabb.shape[0]} supers, {rs.sgaabb.shape[0]} groups, "
            f"{nb * 128} padded rows, bf16 payload {split}; intersector "
            f"{rp.intersector}; host build {t_build:.2f} s (scene "
            f"{t_make:.2f} s); tables "
            f"{(rs.p.numel() + rs.nrm.numel()) * 4 / 1e6:.1f} MB; "
            f"{width}^2 spp {spp} max_path_length {mpl}")
        if rp.intersector != "pallas-hbm":
            raise AssertionError("the ladder must run the HBM walk")
        rows, cols, R, J, n_pix = stream(rp)
        walk = {}
        t_k1, t_p1 = records_vs_plain(f"stress{grid} pool", rs, rp, rows,
                                      cols, R, J, n_pix, walk)
        if J * spp > MAX_K_PER_DISPATCH or spp > SPP_BATCH:
            raise AssertionError("the frame no longer runs one spp batch")
        mk.reset_launches()
        (rgb, done), t_warm = timed(lambda: render_streaming(rs, rp))
        times = []
        for _ in range(3):
            (rgb, done), t = timed(lambda: render_streaming(rs, rp))
            times.append(t)
        n_launch = mk.hbm_launches
        paths = width * width * spp
        finite = bool(np.isfinite(rgb).all())
        log(f"[stress{grid} frame] {width}^2 spp {spp}: warm-up "
            f"{t_warm:.3f} s, runs {', '.join(f'{t:.4f}' for t in times)} s;"
            f" best {min(times):.4f} s = {paths / min(times) / 1e6:.2f} M "
            f"paths/s; mean {float(rgb.mean()):.6f}; done {done}; finite "
            f"{finite}; K3 launches {n_launch}, K1 launches {mk.launches}")
        if done != paths or not finite or rgb.shape != (width, width, 3):
            raise AssertionError(f"stress{grid} frame: done {done} of "
                                 f"{paths}, finite {finite}")
        if n_launch < 1 or mk.launches:
            raise AssertionError("the frame did not run K3 alone")
        kw = dict(params=rp, slots=R, j_per_slot=J, spp=spp,
                  max_iters=J * spp * mpl + 16, k_total=J * spp)
        k_ms, (k_img, _) = event_ms(lambda: mk.megakernel_path_trace(
            rs, rows, cols, rp.rng_seed, n_pix, **kw))
        (bound, by), ops, nbytes, _ = hbm_bound(rs, walk, spp, R, J)
        log(f"[stress{grid} K3 alone] {', '.join(f'{t:.2f}' for t in k_ms)} "
            f"ms (CUDA events); bound {bound:.3f} ms ({by}: {ops:.4g} f32 "
            f"instructions, {nbytes / 1e6:.1f} MB)")
        counted = walk_counters(f"stress{grid}", rs, rows, cols, n_pix, kw,
                                k_img)
        # The slots whose pixels the frame lit (slot s owns stream
        # positions s + j*R):
        lit = rgb.reshape(-1, 3)[pixel_stream(rp).order].sum(axis=1) > 0
        lit = np.flatnonzero(np.pad(lit, (0, R * J - lit.size))
                             .reshape(J, R).any(axis=0))
        if not lit.size:
            raise AssertionError(f"stress{grid} frame: no lit pixel")
        n_first, n_lit = (min(n, R) for n in replays)
        lit0 = min(int(lit[lit.size // 2]) // 256 * 256, R - n_lit)
        for slot0, n in ((0, n_first), (lit0, n_lit)):
            replay(f"stress{grid} frame", rs, rp, rgb, rows, cols, R, J,
                   spp, slot0, n, "k3")
        return dict(build_s=t_build, times=times, k_ms=k_ms, bound=bound,
                    by=by, launches=n_launch, walk=walk, plain_s=t_p1,
                    kernel_s=t_k1, R=R, J=J, counted=counted)

    phase("3c")
    # ---- 3c. the shadow trace (K4): kernel vs plain, bit for bit ----
    def k4_vs_plain(name, scene, origins, dirs, stats=None,
                    bundles=sh.REF_BUNDLES):
        """K4 and its plain version on the same culled rays; all outputs
        held bit for bit (== on every element; inf == inf)."""
        args = sh.shadow_inputs(scene, origins, dirs)
        light = DEFAULT_LIGHT_POS
        (kf, ki), t_k = timed(lambda: sh.shadow_trace_cuda(scene, *args,
                                                           light=light))
        (pf, pi), t_p = timed(lambda: sh.shadow_trace_ref(
            scene, *args, light=light, stats=stats, bundles=bundles))
        same = torch.equal(kf, pf) and torch.equal(ki, pi)
        fin = torch.isfinite(kf) & torch.isfinite(pf)
        e = float((kf - pf)[fin].abs().max()) if bool(fin.any()) else 0.0
        err["k4"] = max(err["k4"], e)
        n = dirs.shape[0]
        log(f"[K4 {name}] {n} rays, {args[0].shape[0]} bundles: kernel "
            f"{t_k:.4f} s, plain {t_p:.3f} s; bit for bit {same} (max "
            f"|diff| {e:.3g}); hits tri {int((ki[0, :n] >= 0).sum())}, sphere "
            f"{int((ki[1, :n] >= 0).sum())}, disc {int((ki[2, :n] >= 0).sum())}, "
            f"occluded {int(ki[3, :n].sum())}")
        if not same:
            bad = int((kf != pf).any(0).logical_or((ki != pi).any(0)).sum())
            raise AssertionError(f"K4 {name}: kernel disagrees with plain on "
                                 f"{bad} rays")
        return kf, ki, t_k, t_p

    def frame_rays(params):
        """All pixels of a window as camera directions, stream order."""
        rows, cols = pixel_stream(params).coords(
            dev, params.window_w * params.window_h)
        return generate_camera_rays(rows, cols, params.image_width,
                                    params.image_height,
                                    params.fov_radians)[1]

    def smooth_scene():
        """A UV-sphere mesh with vertex normals over a floor, under an
        emissive quad: its shading normal depends on the barycentrics."""
        n_lat, n_lon, c = 6, 10, np.array([0.0, -0.4, -3.2])
        th = np.linspace(0.25, np.pi - 0.25, n_lat + 1)
        ph = np.linspace(0.0, 2 * np.pi, n_lon + 1)[:-1]
        tt, pp = np.meshgrid(th, ph, indexing="ij")
        nrm = np.stack([np.sin(tt) * np.cos(pp), np.cos(tt),
                        np.sin(tt) * np.sin(pp)], -1).reshape(-1, 3)
        idx = np.arange((n_lat + 1) * n_lon).reshape(n_lat + 1, n_lon)
        nx = np.roll(idx, -1, axis=1)
        a, b, cc, d = idx[:-1], idx[1:], nx[:-1], nx[1:]
        tris = np.concatenate([np.stack([a, b, cc], -1).reshape(-1, 3),
                               np.stack([b, d, cc], -1).reshape(-1, 3)])
        quad = np.array([[0, 1, 2], [0, 2, 3]])
        desc = st.SceneDescription()
        desc.meshes = [
            st.HostMesh(triangles=tris, vertices=c + nrm,
                        normals=nrm.astype(np.float32)),
            st.HostMesh(triangles=quad, vertices=np.array(
                [[-6, -1.4, 0], [6, -1.4, 0], [6, -1.4, -12], [-6, -1.4, -12]])),
            st.HostMesh(triangles=quad, vertices=np.array(
                [[-1.5, 2.5, -2], [1.5, 2.5, -2], [1.5, 2.5, -5], [-1.5, 2.5, -5]]))]
        zero = np.zeros(3, np.float32)
        desc.materials = [
            st.Material(np.array([0.75] * 3, np.float32), zero,
                        st.MaterialType.DIFFUSE),
            st.Material(np.array([0.5, 0.45, 0.4], np.float32), zero,
                        st.MaterialType.DIFFUSE),
            st.Material(np.array([0.78] * 3, np.float32),
                        np.array([12.0] * 3, np.float32),
                        st.MaterialType.DIFFUSE)]
        desc.mat_ids = [0, 1, 2]
        desc.camera = st.Camera(horizontal_fov=float(np.pi / 3))
        desc.validate()
        return desc

    box, box_p = build_scene(make_cornell_box_scene(None, box_only=False),
                             device=dev, image_width=48, image_height=32,
                             intersector="pallas")
    k4_vs_plain("Cornell box 48x32", box, None, frame_rays(box_p))
    mon, mon_p = build_scene(make_cornell_box_scene(mesh, box_only=False),
                             device=dev, image_width=64, image_height=64,
                             intersector="pallas")
    k4_vs_plain("Cornell + monkey 64x64", mon, None, frame_rays(mon_p))
    smo, smo_p = build_scene(smooth_scene(), device=dev, image_width=64,
                             image_height=64, intersector="pallas")
    k4_vs_plain("vertex-normal mesh 64x64", smo, None, frame_rays(smo_p))
    # Random rays from origins spread over the box (a third aimed at the
    # spheres and the disc), 3,000 rays: bundles with spread origins and a
    # padded last bundle.
    rng = np.random.default_rng(5)
    b_np = box.baabb.cpu().numpy()
    lo, hi = b_np[:, 0:3].min(0), b_np[:, 3:6].max(0)
    ro = rng.uniform(lo + 0.1 * (hi - lo), hi - 0.1 * (hi - lo),
                     (3000, 3)).astype(np.float32)
    rd = rng.normal(size=(3000, 3)).astype(np.float32)
    tg = box.ap.cpu().numpy()[:, 1:4]
    rd[:1000] = (tg[rng.integers(0, len(tg), 1000)]
                 + rng.normal(0, 20, (1000, 3)).astype(np.float32) - ro[:1000])
    rd /= np.linalg.norm(rd, axis=1, keepdims=True)
    k4_vs_plain("random rays, spread origins", box,
                torch.from_numpy(ro).to(dev), torch.from_numpy(rd).to(dev))
    # The shadow golden (the JAX package's render, chunk 512) through the
    # port's render on the card, every AOV bit for bit:
    sgold = np.load(os.path.join(ROOT, "tests", "golden",
                                 "shadow_box48x32.npz"))
    sh.reset_launches()
    out = render(box, box_p, chunk_size=512)
    bad = {k: int((~(getattr(out, k) == sgold[k])).sum()) for k in sgold}
    log(f"[K4 shadow golden 48x32] render vs golden, elements differing per "
        f"AOV: {bad}; hits {out.hit_count}; K4 launches {sh.launches}")
    if any(bad.values()) or sh.launches != 3:
        raise AssertionError("shadow golden mismatch on the card")

    phase("3d")
    # ---- 3d. the closest-hit kernels K5 and K6: kernel vs plain ----
    def walk_inputs(scene, o, d, hbm):
        """The culled, padded inputs of one K5 (K6 with ``hbm``) launch
        for rays (o, d), t in (0, inf)."""
        R = d.shape[0]
        args = ik.intersect_inputs(
            o, d, torch.zeros(R, device=dev),
            torch.full((R,), float("inf"), device=dev))
        cull = super_cull_lists_bundle if hbm else ik.block_cull_lists_bundle
        return (*cull(scene, *args[:4], args[4].shape[1] // 1024), args[4])

    def walks_equal(name, key, scene, inp, kout, hbm):
        """A kernel's raw outputs ``kout`` against its plain version on the
        same inputs: every output (the blocks each bundle tested too) bit
        for bit. Returns the plain version's seconds."""
        plain = ih.super_walk_ref if hbm else ik.dense_walk_ref
        pout, t_p = timed(lambda: plain(scene, *inp))
        same = all(torch.equal(a, b) for a, b in zip(kout, pout))
        e = 0.0
        for a, b in zip(kout[:4], pout[:4]):
            fin = torch.isfinite(a) & torch.isfinite(b)
            if bool(fin.any()):
                e = max(e, float((a - b)[fin].abs().max()))
        err[key] = max(err[key], e)
        n_hit = int((kout[1] >= 0).sum())
        # The (lane, block) pairs the lanes tested: K5's culled walk
        # between the pairs its hits need and the dense walk's; K6 all.
        dense = int(pout[4].sum()) * 1024
        need = (0 if hbm else
                ik.needed_pairs(scene, inp[1], inp[3], pout[0], pout[4],
                                members=1))
        tested = int(kout[6].sum())
        log(f"[{'K6' if hbm else 'K5'} {name}] {inp[3].shape[1]} padded "
            f"rays, {inp[0].shape[0]} bundles: plain {t_p:.3f} s; bit for "
            f"bit {same} (max |diff| {e:.3g}); hits {n_hit}; blocks tested "
            f"{int(kout[4].sum())}; (lane, block) pairs tested {tested}, "
            f"needed {need}, dense {dense}")
        if not same:
            raise AssertionError(f"{name}: the closest-hit kernel disagrees "
                                 "with its plain version")
        if not (need <= tested <= dense and (tested == dense or not hbm)):
            raise AssertionError(f"{name}: the (lane, block) pairs tested "
                                 "lie outside [needed, dense]")
        return t_p

    def intersect_vs_plain(name, scene, o, d, hbm):
        """K5 (K6 with ``hbm``) and its plain version on the same culled
        rays. Returns (the kernel's outputs, kernel s, plain s)."""
        inp = walk_inputs(scene, o, d, hbm)
        kout, t_k = timed(lambda: ik.walk_cuda(scene, *inp, hbm=hbm))
        t_p = walks_equal(name, "k6" if hbm else "k5", scene, inp, kout, hbm)
        return kout, t_k, t_p

    def bounce_rays(scene, o, d, hbm, seed):
        """Rays of one diffuse bounce: from the rays' hit points, pushed
        off the surface, into seeded directions of the normal's
        hemisphere."""
        hit_fn = ih.pallas_intersect_hbm if hbm else ik.pallas_intersect
        R = d.shape[0]
        t, tri, n, _ = hit_fn(scene, o, d, torch.zeros(R, device=dev),
                              torch.full((R,), float("inf"), device=dev))
        hit = tri >= 0
        p = o[hit] + d[hit] * t[hit, None]
        n = n[hit]
        g = torch.Generator(device=dev).manual_seed(seed)
        nd = torch.randn(p.shape, generator=g, device=dev)
        nd = nd / nd.norm(dim=1, keepdim=True)
        nd = torch.where((nd * n).sum(1, keepdim=True) < 0, -nd, nd)
        p = p + n * 1e-2 * (1.0 + p.abs().amax(1, keepdim=True))
        return p.contiguous(), nd.contiguous()

    @contextlib.contextmanager
    def recording(mod, name, calls):
        """Keep every call of ``mod.name`` (a kernel's launch) with its
        outputs in ``calls``."""
        fn = getattr(mod, name)

        def rec(scene, *a):
            out = fn(scene, *a)
            calls.append((a, out))
            return out

        setattr(mod, name, rec)
        try:
            yield
        finally:
            setattr(mod, name, fn)

    def routes_agree(name, a, b, scene):
        """The fused route's frame ``a`` against the glue route's ``b``:
        ids everywhere, and every AOV of every pixel that does not show a
        sphere, bit for bit. On sphere hits XLA rounds the two routes'
        sphere tests differently (in the JAX package too,
        tests/test_torch_glue.py), by far more than an ulp where a ray
        grazes the sphere. Those pixels are held to the limits that follow
        from the t difference (``SPHERE_*``, measured on this frame on the
        CPU): at most SPHERE_SHARE of them differ, |dt| <= SPHERE_T_REL t,
        |d hit_p| <= |dt| + 1 ulp, |d normal| <= 2 |dt| / r (r the least
        sphere radius), |d rgb| <= 2 |d normal| + 2^-20; and their glue
        pixels are held against the plain route (``glue_replay``)."""
        sph = np.isin(a.geom_id, scene.sphere_geom.cpu().numpy()).reshape(-1)
        n = sph.size
        off, on = {}, {}
        for k in ("rgb", "t", "normal", "hit_p"):
            dif = (getattr(a, k).reshape(n, -1)
                   != getattr(b, k).reshape(n, -1)).any(axis=1)
            off[k] = int((dif & ~sph).sum())
            on[k] = int((dif & sph).sum())
        g = lambda o, k: getattr(o, k).reshape(n, -1)[sph].astype(np.float64)
        ta = g(a, "t")[:, 0]
        dt = np.abs(ta - g(b, "t")[:, 0])
        hp = g(a, "hit_p")
        dh = np.abs(hp - g(b, "hit_p")).max(1)
        dn = np.abs(g(a, "normal") - g(b, "normal")).max(1)
        dr = np.abs(g(a, "rgb") - g(b, "rgb")).max(1)
        S = scene.n_spheres
        r = float(np.sqrt(scene.ap[:S, 7].cpu().numpy().astype(np.float64)
                          ).min())
        ulp = np.spacing(np.abs(hp).max(1).astype(np.float32))
        over = {"t": int((dt > SPHERE_T_REL * np.abs(ta)).sum()),
                "hit_p": int((dh > dt + ulp).sum()),
                "normal": int((dn > 2.0 * dt / r).sum()),
                "rgb": int((dr > 2.0 * dn + 2.0 ** -20).sum())}
        n_sph = int(sph.sum())
        n_dif = int(((dt > 0) | (dh > 0) | (dn > 0) | (dr > 0)).sum())
        ids = (np.array_equal(a.geom_id, b.geom_id)
               and np.array_equal(a.prim_id, b.prim_id))
        rel = float((dt / np.abs(ta)).max()) if n_sph else 0.0
        log(f"[{name}] glue route vs K4 route: ids equal {ids}; pixels "
            f"differing off the spheres {off}; sphere-hit pixels differing "
            f"{on} of {n_sph} ({n_dif} in all, limit "
            f"{SPHERE_SHARE * n_sph:.0f}); largest |dt|/t {rel:.3g} (limit "
            f"{SPHERE_T_REL:g}), |d hit_p| {dh.max(initial=0):.3g}, "
            f"|d normal| {dn.max(initial=0):.3g}, |d rgb| "
            f"{dr.max(initial=0):.3g}; pixels past their limits {over}")
        if not ids or any(off.values()):
            raise AssertionError(f"{name}: the glue route disagrees with the "
                                 "K4 route")
        if n_dif > SPHERE_SHARE * n_sph or any(over.values()):
            raise AssertionError(f"{name}: the routes' sphere hits differ "
                                 "past their limits")
        return sph

    def glue_replay(name, scene, params, out, g0, n):
        """The glue route's frame ``out`` on its stream pixels [g0, g0 + n)
        (whole bundles) against the plain route (camera, cull, plain K5/K6,
        the glue in torch), every AOV bit for bit."""
        n_fr = params.window_w * params.window_h
        stream_ = pixel_stream(params)
        pix = stream_.order[g0:g0 + n]
        rows, cols = (a[g0:g0 + len(pix)] for a in stream_.coords(dev, n_fr))
        d_rep = generate_camera_rays(rows, cols, params.image_width,
                                     params.image_height,
                                     params.fov_radians)[1]
        with plain_walks():
            rep = shadow_trace(scene, None, d_rep,
                               intersector=params.intersector, fused=False)
        rep = [a.cpu().numpy() for a in rep[:6]]
        rep[2] = np.where(rep[2] == INVALID_GEOM_ID, -1, rep[2])
        bad = {k: int((getattr(out, k).reshape((n_fr, -1))[pix]
                       != rep[i].reshape((len(pix), -1))).sum())
               for i, k in enumerate(("rgb", "t", "geom_id", "prim_id",
                                      "normal", "hit_p"))}
        log(f"[{name}] stream pixels {g0}..{g0 + len(pix) - 1} vs the plain "
            f"route: elements differing per AOV {bad}; hits "
            f"{int((rep[2] >= 0).sum())}")
        if any(bad.values()):
            raise AssertionError(f"{name}: the glue route's pixels disagree "
                                 "with the plain route")

    def path_b_routes(name, scene, params):
        """Path B, the kernel route against the plain route (the same
        integrator with the plain closest-hit walk), bit for bit."""
        (krgb, kdone), t_k = timed(lambda: render_streaming(scene, params,
                                                            env=sky))
        with plain_walks():
            (prgb, pdone), t_p = timed(lambda: render_streaming(
                scene, params, env=sky))
        same = np.array_equal(krgb, prgb)
        n_pix = params.window_w * params.window_h
        log(f"[path B {name}] kernel route {t_k:.3f} s, plain route "
            f"{t_p:.3f} s; bit for bit {same}; done {kdone}/{pdone}; mean "
            f"{float(krgb.mean()):.6f}")
        if (not same or kdone != pdone
                or kdone != n_pix * params.samples_per_pixel):
            raise AssertionError(f"path B {name}: the kernel route disagrees "
                                 "with the plain route")

    intersect_vs_plain("Cornell box 48x32", box, torch.zeros_like(
        frame_rays(box_p)), frame_rays(box_p), False)
    mon_d = frame_rays(mon_p)
    mon_h, _ = build_scene(make_cornell_box_scene(mesh, box_only=False),
                           device=dev, image_width=64, image_height=64,
                           intersector="pallas-hbm")
    for hbm, sc in ((False, mon), (True, mon_h)):
        zo = torch.zeros_like(mon_d)
        intersect_vs_plain("Cornell + monkey 64x64", sc, zo, mon_d, hbm)
        bo, bd = bounce_rays(sc, zo, mon_d, hbm, 11)
        intersect_vs_plain("Cornell + monkey 64x64, one bounce", sc, bo, bd,
                           hbm)
    for split in (False, True):
        s24, s24_p = hbm_scene(make_stress_scene(24), 48, 32, 1,
                               payload_split=split)
        d24 = frame_rays(s24_p)
        intersect_vs_plain(f"stress24 48x32, {'bf16' if split else 'f32'} "
                           "payload", s24, torch.zeros_like(d24), d24, True)
    box_h, _ = build_scene(make_cornell_box_scene(None, box_only=False),
                           device=dev, image_width=48, image_height=32,
                           intersector="pallas-hbm")
    ro_t, rd_t = torch.from_numpy(ro).to(dev), torch.from_numpy(rd).to(dev)
    intersect_vs_plain("random rays, spread origins", box, ro_t, rd_t, False)
    intersect_vs_plain("random rays, spread origins", box_h, ro_t, rd_t, True)
    ik.reset_launches()
    sh.reset_launches()
    out = render(box, box_p, chunk_size=512, fused=False)
    bad = {k: int((~(getattr(out, k) == sgold[k])).sum()) for k in sgold}
    log(f"[glue shadow golden 48x32] render(fused=False) vs golden, elements "
        f"differing per AOV: {bad}; hits {out.hit_count}; K5 launches "
        f"{ik.launches}, K4 launches {sh.launches}")
    if any(bad.values()) or ik.launches != 6 or sh.launches:
        raise AssertionError("the glue route misses the shadow golden")
    gout64 = render(mon, mon_p, fused=False)
    routes_agree("Cornell + monkey 64x64", render(mon, mon_p), gout64, mon)
    glue_replay("glue Cornell + monkey 64x64", mon, mon_p, gout64, 0, 4096)
    path_b_routes("Cornell box 48x32 spp 2", box,
                  dataclasses.replace(box_p, samples_per_pixel=2))
    pb_h, pb_hp = hbm_scene(make_stress_scene(24), 32, 32, 2)
    path_b_routes("stress24 HBM 32x32 spp 2", pb_h, pb_hp)

    if quick:
        log("quick mode: stopping before the full-size phases")
        return 0

    phase("4")
    # ---- 4. Cornell main path's slot pool at spp 1 (+ walk counts) ----
    scene, params = build_scene(make_cornell_box_scene(mesh, box_only=False),
                                device=dev, image_width=FULL,
                                image_height=FULL, samples_per_pixel=SPP)
    log(f"bench scene: {scene.p.shape[0]} triangle rows in "
        f"{scene.num_blocks} blocks, {scene.n_ap} sphere/disc rows")
    walk = {}
    k_pool, _, k_main, p_main, _ = kernel_vs_plain(
        "monkey 1440^2 pool", scene, params, 1, stats=walk)
    k1_counts("monkey 1440^2 pool", scene, params, *stream(params), 1, walk,
              k_pool)

    phase("5")
    # ---- 5. Cornell main path at full size ----
    mk.reset_launches()
    (rgb, done), t_warm = timed(lambda: render_streaming(scene, params))
    times = []
    for _ in range(3):
        (rgb, done), t = timed(lambda: render_streaming(scene, params))
        times.append(t)
    k1_launches = mk.launches
    paths = FULL * FULL * SPP
    best = min(times)
    finite = bool(np.isfinite(rgb).all())
    mean = float(rgb.mean())
    log(f"[main] {FULL}^2 spp {SPP}: warm-up {t_warm:.3f} s, runs "
        f"{', '.join(f'{t:.3f}' for t in times)} s; best {best:.3f} s = "
        f"{paths / best / 1e6:.2f} M paths/s; mean {mean:.6f} (64x64 plain "
        f"{small_mean:.6f}); done {done}; finite {finite}; launches "
        f"{k1_launches}")
    if done != paths:
        raise AssertionError(f"done {done} != {paths}")
    if rgb.shape != (FULL, FULL, 3) or not finite:
        raise AssertionError("full-size image has the wrong shape or non-finite values")
    if abs(mean - small_mean) > 0.15 * small_mean:
        raise AssertionError("full-size image mean far from the small render's")
    if k1_launches < 1:
        raise AssertionError("main path launched no kernel")

    # Kernel alone at the main path's shapes (CUDA events; the one launch
    # render_streaming makes per frame), for the host/kernel split:
    rows, cols, R, J, n_pix = stream(params)
    kw = dict(params=params, slots=R, j_per_slot=J, spp=SPP,
              max_iters=J * SPP * params.max_path_length + 16, k_total=J * SPP)
    k_ms, (k1_img, _) = event_ms(lambda: mk.megakernel_path_trace(
        scene, rows, cols, params.rng_seed, n_pix, **kw))
    main_ms = median(k_ms)
    counted5 = walk_counters(f"monkey {FULL}^2", scene, rows, cols, n_pix,
                             kw, k1_img)
    log(f"[main] kernel alone (CUDA events): "
        f"{', '.join(f'{t:.2f}' for t in k_ms)} ms; median end to end "
        f"{median(times) * 1e3:.2f} ms")
    # K1's bound: the (segment, block) pairs and segments the plain version
    # counted at the pool with spp 1, scaled to spp 64:
    k1_ops = SPP * (walk["block_tests"] * 128 * ROW_TEST_FLOPS
                    + walk["segments"] * scene.n_ap * AP_TEST_FLOPS)
    k1_bound_ms = k1_ops / PEAK_F32_INSTR * 1e3
    log(f"[K1 bound] spp 1 pool: {walk['segments']} segments, "
        f"{walk['block_tests']} admitted (segment, block) pairs; x{SPP}: "
        f"{k1_ops:.4g} f32 instructions -> {k1_bound_ms:.2f} ms at "
        f"{PEAK_F32_INSTR / 1e12:.1f} T/s (as FLOP at 67 TFLOP/s "
        f"{k1_ops / PEAK_F32 * 1e3:.2f} ms; kernel {main_ms:.2f} ms)")

    # The main path's own pixels at spp 64, held against both versions.
    # A path's pid (slot*K_tot + k) and its pixels do not depend on the
    # pool size, so a pool of the main pool's first SUB slots, with the
    # same J, spp, k_total and seed (render_streaming runs one batch
    # here, seeded params.rng_seed, weight 1), replays those slots' paths.
    if J * SPP > MAX_K_PER_DISPATCH or SPP > SPP_BATCH:
        raise AssertionError("the main path no longer runs one spp batch")
    replay("monkey 1440^2 main path", scene, params, rgb, rows, cols, R, J,
           SPP, 0, SUB_MAIN, "k1", jn=SUB_MAIN_ROWS)

    phase("6")
    # ---- 6. plain vs kernel time at 256^2 spp 4 (plain, kernel, kernel, plain) ----
    ss, sp = build_scene(make_cornell_box_scene(mesh, box_only=False),
                         device=dev, image_width=256, image_height=256,
                         samples_per_pixel=4)
    rows6, cols6, R6, J6, n6_pix = stream(sp)
    kw6 = dict(params=sp, slots=R6, j_per_slot=J6, spp=4,
               max_iters=J6 * 4 * sp.max_path_length + 16)
    t_p, t_k = [], []
    for fn, acc in ((mk.megakernel_path_trace_ref, t_p),
                    (mk.megakernel_path_trace, t_k),
                    (mk.megakernel_path_trace, t_k),
                    (mk.megakernel_path_trace_ref, t_p)):
        _, t = timed(lambda: fn(ss, rows6, cols6, 1442, n6_pix, **kw6))
        acc.append(t)
    log(f"[256^2 spp 4] plain {', '.join(f'{t:.3f}' for t in t_p)} s; "
        f"kernel {', '.join(f'{t:.4f}' for t in t_k)} s")

    phase("6b")
    # ---- 6b. the shadow-trace main path: Cornell + monkey at 1440^2 ----
    # ``render`` in shadow-trace mode on phase 4's scene (VMEM mode): one
    # warm-up, three timed frames with every AOV, three with normals only.
    if params.intersector != "pallas":
        raise AssertionError("the shadow trace runs K4 in VMEM mode")
    n_frame = FULL * FULL
    sh.reset_launches()
    rnd.reset_counters()
    sout, t_warm = timed(lambda: render(scene, params))
    s_all, s_nrm = [], []
    for _ in range(3):
        sout, t = timed(lambda: render(scene, params))
        s_all.append(t)
    for _ in range(3):
        nout, t = timed(lambda: render(scene, params, aovs=("normal",)))
        s_nrm.append(t)
    k4_launches = sh.launches
    hit = sout.geom_id >= 0
    finite = all(bool(np.isfinite(getattr(sout, f)[hit]).all())
                 for f in ("rgb", "t", "normal", "hit_p"))
    log(f"[shadow main] {FULL}^2 shadow trace, Cornell + monkey: warm-up "
        f"{t_warm:.3f} s; all AOVs {', '.join(f'{t:.4f}' for t in s_all)} s; "
        f"normals only {', '.join(f'{t:.4f}' for t in s_nrm)} s; best "
        f"{n_frame / min(s_all) / 1e6:.2f} / {n_frame / min(s_nrm) / 1e6:.2f} "
        f"M rays/s; hits {sout.hit_count} of {n_frame}; finite where hit "
        f"{finite}; K4 launches {k4_launches}")
    if (sout.rgb.shape != (FULL, FULL, 3) or not finite
            or not 0 < sout.hit_count < n_frame or k4_launches < 1):
        raise AssertionError("shadow main path: wrong shape, non-finite "
                             "AOVs, no hits or no K4 launch")
    if not (np.array_equal(nout.normal, sout.normal)
            and np.array_equal(nout.geom_id, sout.geom_id)
            and not nout.rgb.any()):
        raise AssertionError("normals-only frame differs from the full one")

    # The graph route (render/renderer.py): the frames above replayed the
    # chunk loop captured at their key's first call. Replayed frames at two
    # zooms against the eager loop (a progress callback keeps the loop on
    # the host), every AOV's md5, each route's K4 launches and pinned
    # readbacks; the readback alone on the replayed frame's buffers (its
    # wall ms from an idle card, 3 runs); the first zoom's replayed frame
    # held while the second renders, its md5 unchanged; the captures'
    # cost.
    n_before = sh.launches
    held = None
    md5_of = lambda o: [hashlib.md5(getattr(o, f).tobytes()).hexdigest()
                        for f in sout._fields]
    for zoom in (0.985, 1.015):
        pz = dataclasses.replace(params,
                                 fov_radians=params.fov_radians * zoom)
        sh.launches = 0
        p0 = rnd.pinned_readbacks
        eout, t_e = timed(lambda: render(
            scene, pz, progress_callback=lambda i, rgb: None))
        n_e, sh.launches = sh.launches, 0
        p1 = rnd.pinned_readbacks
        gout, t_g = timed(lambda: render(scene, pz))
        n_g = sh.launches
        pins = (p1 - p0, rnd.pinned_readbacks - p1)
        md5 = [md5_of(o) for o in (eout, gout)]
        bufs = next(reversed(scene._frame_graphs.values())).bufs
        rb_ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            rb, t = timed(lambda: _read_back(bufs, pz, scene.device, False))
            rb_ms.append(t * 1e3)
        rb_same = md5_of(rb) == md5[1]
        log(f"[shadow graph] zoom {zoom}: replay {t_g * 1e3:.2f} ms, eager "
            f"(with a callback) {t_e * 1e3:.2f} ms; md5 equal on "
            f"{sum(a == b for a, b in zip(*md5))} of {len(md5[0])} AOVs; K4 "
            f"launches eager {n_e}, replayed {n_g}; readback "
            f"{', '.join(f'{t:.2f}' for t in rb_ms)} ms (its md5 equal "
            f"{rb_same}); pinned readbacks eager {pins[0]}, replayed "
            f"{pins[1]} ({rnd.pinned_readbacks} in all)")
        if md5[0] != md5[1] or n_e != n_g or n_g < 1:
            raise AssertionError("a replayed shadow frame differs from the "
                                 "eager loop's")
        if not rb_same or pins != (1, 1):
            raise AssertionError("the readback alone differs from the "
                                 "frame's, or a frame made other than one "
                                 "pinned copy")
        if held is not None:
            kept = md5_of(held[0]) == held[1]
            log(f"[shadow graph] the zoom {held[2]} frame, held while zoom "
                f"{zoom} rendered: md5 unchanged {kept}; the two frames "
                f"differ {held[1] != md5[1]}")
            if not kept or held[1] == md5[1]:
                raise AssertionError("a held shadow frame changed under the "
                                     "next frame, or the zoom moved nothing")
        held = (gout, md5[1], zoom)
    del held, rb, gout, eout
    sh.launches = n_before
    log(f"[shadow graph] captures {rnd.graph_captures}, replays "
        f"{rnd.graph_replays}; capture ms " + ", ".join(
            f"{'+'.join(k[8])}: {fg.capture_ms:.1f}"
            for k, fg in scene._frame_graphs.items()))

    # Where the frame's time goes, piece by piece at its shapes (CUDA
    # events, 3 runs each): camera rays + cull, K4 alone (the kernels
    # behind the view of the whole frame), the epilogue, un-tiling on the
    # device; the device-to-host copy of the six AOVs on the host clock.
    n_chunks = -(-n_frame // DEFAULT_CHUNK)

    frame_coords = pixel_stream(params).coords(dev,
                                               n_chunks * DEFAULT_CHUNK)

    def chunk_dirs(ci):
        rows, cols = (a[ci * DEFAULT_CHUNK:(ci + 1) * DEFAULT_CHUNK]
                      for a in frame_coords)
        return generate_camera_rays(rows, cols, FULL, FULL,
                                    params.fov_radians)[1]

    def all_inputs():
        return [(d, sh.shadow_inputs(scene, None, d))
                for d in map(chunk_dirs, range(n_chunks))]

    light = DEFAULT_LIGHT_POS
    cull_ms, inputs = event_ms(all_inputs)
    k4_ms, k_outs = event_ms(lambda: [sh.shadow_trace_cuda(scene, *a,
                                                           light=light)
                                      for _, a in inputs])
    # The same launches behind a spin kernel: the card's time alone, apart
    # from the host's launch rate (``ms`` above is timed without it, as the
    # earlier kernels were).
    k4_card_ms, _ = event_ms(lambda: [sh.shadow_trace_cuda(scene, *a,
                                                           light=light)
                                      for _, a in inputs], hold_ms=40.0)
    epi_ms, epis = event_ms(lambda: [
        sh.shadow_epilogue(scene, None, d, f, i, light, 0.05)
        for (d, _), (f, i) in zip(inputs, k_outs)])
    stream_aovs = [torch.cat([e[k] for e in epis])[:n_frame]
                   for k in (0, 1, 2, 3, 4, 5)]
    inv_t = pixel_stream(params).inverse(dev)
    untile_ms, raster = event_ms(lambda: [a.index_select(0, inv_t)
                                          for a in stream_aovs])
    d2h = []
    for _ in range(3):
        _, t = timed(lambda: [a.cpu() for a in raster])
        d2h.append(t * 1e3)
    nbytes = sum(a.numel() * a.element_size() for a in raster)
    e2e_ms = median(s_all) * 1e3
    log(f"[shadow main breakdown] per frame ({n_chunks} chunks of "
        f"{DEFAULT_CHUNK} rays): camera + cull "
        f"{', '.join(f'{t:.2f}' for t in cull_ms)} ms; K4 alone "
        f"{', '.join(f'{t:.2f}' for t in k4_ms)} ms (behind a spin kernel "
        f"{', '.join(f'{t:.2f}' for t in k4_card_ms)} ms); epilogue "
        f"{', '.join(f'{t:.2f}' for t in epi_ms)} ms; un-tiling "
        f"{', '.join(f'{t:.2f}' for t in untile_ms)} ms; device-to-host "
        f"{nbytes / 1e6:.1f} MB {', '.join(f'{t:.2f}' for t in d2h)} ms; end "
        f"to end (median) {e2e_ms:.2f} ms all AOVs, "
        f"{median(s_nrm) * 1e3:.2f} ms normals only; host share (end to end "
        f"minus K4) {e2e_ms - median(k4_ms):.2f} ms = "
        f"{1 - median(k4_ms) / e2e_ms:.3f}")

    # K4 against its plain version over the whole frame, chunk by chunk,
    # bit for bit; the plain version counts the (bundle, block) pairs each
    # walk tests, for K4's bound.
    k4_walk = {}
    t0 = time.perf_counter()
    k4_bad = 0
    for (_, a), (kf, ki) in zip(inputs, k_outs):
        pf, pi = sh.shadow_trace_ref(scene, *a, light=light, stats=k4_walk,
                                     bundles=SHADOW_REF_BUNDLES)
        k4_bad += int(((kf != pf).any(0) | (ki != pi).any(0)).sum())
        fin = torch.isfinite(kf) & torch.isfinite(pf)
        err["k4"] = max(err["k4"], float((kf - pf)[fin].abs().max()))
    torch.cuda.synchronize()
    k4_plain_ms = (time.perf_counter() - t0) * 1e3
    # The (lane, block) pairs the frame's hits need (K4's bound): the
    # primary walk's, from each lane's hit t (the kernel's out_f[3]), as
    # for K5 and K6; the occlusion walk's, counted by the plain version.
    k4_need_p = sum(ik.needed_pairs(scene, a[1], a[3], kf[3].contiguous(),
                                    a[0], members=1)
                    for (_, a), (kf, _) in zip(inputs, k_outs))
    k4_need_o = k4_walk["occlusion_needed"]
    # The (lane, block) pairs K4's lanes tested, launch by launch: the
    # primary walk's between the pairs its hits need and the dense walk's
    # (1,024 per walked block), the occlusion walk's at most the dense
    # walk's (a lane stops at its first occluder); the bundles' blocks
    # equal the plain version's (bundle, block) pairs.
    k4_lp = [0, 0, 0, 0]
    for (_, a), (kf, _) in zip(inputs, k_outs):
        pr = torch.zeros((4, a[0].shape[0]), dtype=torch.int32, device=dev)
        sh.shadow_trace_cuda(scene, *a, light=light, pairs=pr)
        pr = [int(x) for x in pr.sum(dim=1).tolist()]
        need = ik.needed_pairs(scene, a[1], a[3], kf[3].contiguous(), a[0],
                               members=1)
        if not (need <= pr[2] <= pr[0] * 1024 and pr[3] <= pr[1] * 1024):
            raise AssertionError("K4: a launch's (lane, block) pairs lie "
                                 "outside [needed, dense]")
        k4_lp = [x + y for x, y in zip(k4_lp, pr)]
    if (k4_lp[0] != k4_walk["primary_pairs"]
            or k4_lp[1] != k4_walk["occlusion_pairs"]):
        raise AssertionError("K4's bundles walked other blocks than the plain "
                             "version's")
    k4_count = k45_counting(lambda c: [sh.shadow_trace_cuda(
        scene, *a, light=light, counters=c) for _, a in inputs])
    log(f"[K4 pairs] (lane, block) pairs tested: primary {k4_lp[2]} "
        f"(needed {k4_need_p}, dense {k4_lp[0] * 1024}), occlusion "
        f"{k4_lp[3]} (needed by the nearest occluders {k4_need_o}, dense "
        f"{k4_lp[1] * 1024}); every launch within [needed, dense]")
    log(f"[K4 counting launch] the frame's {n_chunks} launches: "
        f"{json.dumps(k4_count)}")
    rp_frame = n_chunks * DEFAULT_CHUNK
    log(f"[shadow main] K4 vs plain over the frame's {rp_frame} rays: "
        f"{k4_bad} rays differ (max |diff| {err['k4']:.3g}); plain "
        f"{k4_plain_ms:.0f} ms; walk {k4_walk}")
    if k4_bad:
        raise AssertionError("K4 disagrees with its plain version on the "
                             "main path's frame")
    # The frame's own pixels replayed by the plain route (camera, cull,
    # plain K4, epilogue), every AOV: its first SHADOW_REPLAY bundles, and
    # as many around its median lit pixel (the first tiles lie outside the
    # box). A chunk is a whole number of bundles, so these are the frame's
    # own bundles.
    n_rep = SHADOW_REPLAY * 1024
    order = pixel_stream(params).order
    lit = np.flatnonzero(sout.geom_id.reshape(-1)[order] >= 0)
    last = -(-n_frame // 1024) - SHADOW_REPLAY
    mid = min(max(int(lit[len(lit) // 2]) // 1024 - SHADOW_REPLAY // 2, 0),
              last)
    for b0 in (0, mid):
        g0 = b0 * 1024
        pix = order[g0:g0 + n_rep]
        rows, cols = (a[g0:g0 + len(pix)]
                      for a in pixel_stream(params).coords(dev, n_frame))
        d_rep = generate_camera_rays(rows, cols, FULL, FULL,
                                     params.fov_radians)[1]
        a_rep = sh.shadow_inputs(scene, None, d_rep)
        rep = [a.cpu().numpy() for a in sh.shadow_epilogue(
            scene, None, d_rep, *sh.shadow_trace_ref(scene, *a_rep,
                                                     light=light),
            light, 0.05)]
        rep[2] = np.where(rep[2] == INVALID_GEOM_ID, -1, rep[2])
        rep_bad = {k: int((getattr(sout, k).reshape((n_frame, -1))[pix]
                           != rep[i].reshape((len(pix), -1))).sum())
                   for i, k in enumerate(("rgb", "t", "geom_id", "prim_id",
                                          "normal", "hit_p"))}
        log(f"[shadow main pixels] the frame's stream pixels {g0}.."
            f"{g0 + len(pix) - 1} vs the plain route: elements differing per "
            f"AOV {rep_bad}; hits {int((rep[2] >= 0).sum())}")
        if any(rep_bad.values()):
            raise AssertionError("the shadow frame's pixels disagree with the "
                                 "plain route")
    k4_pairs = k4_walk["primary_pairs"] + k4_walk["occlusion_pairs"]
    k4_side = (rp_frame * scene.num_blocks * SLAB_FLAG_FLOPS
               + 2 * rp_frame * (scene.n_spheres + scene.n_discs)
               * SHADOW_AP_FLOPS)
    k4_ops = (k4_need_p + k4_need_o) * 128 * ROW_TEST_INSTR_FMA + k4_side
    k4_flop = (k4_need_p + k4_need_o) * 128 * ROW_TEST_FLOPS + k4_side
    k4_ops_bundles = k4_pairs * 1024 * 128 * ROW_TEST_INSTR_FMA + k4_side
    k4_bytes = (rp_frame * (8 + 4 + 4) * 4
                + n_chunks * inputs[0][1][1].numel() * 8
                + sum(t.numel() * t.element_size() for t in (
                    scene.p, scene.nrm, scene.baabb, scene.ap)))
    k4_bound = max((k4_ops / PEAK_F32_INSTR * 1e3, "operations"),
                   (k4_bytes / PEAK_BYTES * 1e3, "bytes"))
    k4_bound_flop = max(k4_flop / PEAK_F32, k4_bytes / PEAK_BYTES) * 1e3
    log(f"[K4 bound] {k4_need_p} primary + {k4_need_o} occlusion (lane, "
        f"block) pairs the hits need x 128 x {ROW_TEST_INSTR_FMA} "
        f"instructions + slab flags + sphere/disc tests = {k4_ops:.4g} f32 "
        f"instructions -> {k4_ops / PEAK_F32_INSTR * 1e3:.3f} ms (as FLOP "
        f"at 67 TFLOP/s {k4_flop / PEAK_F32 * 1e3:.3f} ms); "
        f"{k4_bytes / 1e6:.1f} MB -> "
        f"{k4_bytes / PEAK_BYTES * 1e3:.3f} ms; kernel {median(k4_ms):.2f} ms"
        f" (the walks test {k4_walk['primary_pairs']} primary + "
        f"{k4_walk['occlusion_pairs']} occlusion (bundle, block) pairs, "
        f"{(k4_pairs) * 1024} lanes' worth: counted so, the bound was "
        f"{k4_ops_bundles / PEAK_F32_INSTR * 1e3:.3f} ms)")

    phase("7")
    # ---- 7. the flagship: spheres + NIF at 512^2 spp 64 ----
    fs, fp = build_scene(make_primitive_scene(), device=dev,
                         image_width=NIF_SIZE, image_height=NIF_SIZE,
                         samples_per_pixel=NIF_SPP)
    f_paths = NIF_SIZE * NIF_SIZE * NIF_SPP
    # Kernel route vs plain route at the flagship's pool with spp 4 (and
    # the plain version's segment count for K1's bound):
    fwalk = {}
    rows7, cols7, R7, J7, n7_pix = stream(fp)
    CUT = 4
    compare(f"spheres+NIF {NIF_SIZE}^2 pool", fs, fp, rows7, cols7, R7, J7,
            n7_pix, CUT, env=env, stats=fwalk, key="k1_rec")
    # Record mode alone at that shape, kernel (CUDA events) and plain:
    kw_cut = dict(params=fp, slots=R7, j_per_slot=J7, spp=CUT,
                  max_iters=J7 * CUT * fp.max_path_length + 16)
    k_rec_cut, _ = event_ms(lambda: mk.trace_records(
        fs, rows7, cols7, 1442, n7_pix, **kw_cut))
    _, p_rec_cut = timed(lambda: mk._trace(
        mk._accumulate_plain, fs, rows7, cols7, 1442, n7_pix, record=True,
        **kw_cut))
    log(f"[spheres+NIF {NIF_SIZE}^2 pool] record mode alone at spp {CUT}: "
        f"kernel {', '.join(f'{t:.2f}' for t in k_rec_cut)} ms, plain "
        f"{p_rec_cut:.3f} s")
    kw7 = dict(params=fp, slots=R7, j_per_slot=J7, spp=NIF_SPP,
               max_iters=J7 * NIF_SPP * fp.max_path_length + 16,
               k_total=J7 * NIF_SPP)
    if J7 * NIF_SPP > MAX_K_PER_DISPATCH or NIF_SPP > SPP_BATCH:
        raise AssertionError("the flagship no longer runs one spp batch")

    mk.reset_launches()
    envk.reset_launches()
    (frgb, fdone), t_warm = timed(lambda: render_streaming(fs, fp, env=env))
    f_times = []
    for _ in range(3):
        (frgb, fdone), t = timed(lambda: render_streaming(fs, fp, env=env))
        f_times.append(t)
    launches = {"k1_rec": mk.launches, "env": envk.launches,
                "bank": mk.bank_launches}
    f_finite = bool(np.isfinite(frgb).all())
    f_best = min(f_times)
    log(f"[flagship] spheres+NIF {NIF_SIZE}^2 spp {NIF_SPP}: warm-up "
        f"{t_warm:.3f} s, runs {', '.join(f'{t:.3f}' for t in f_times)} s; "
        f"best {f_best:.3f} s = {f_paths / f_best / 1e6:.2f} M paths/s; mean "
        f"{float(frgb.mean()):.6f}; done {fdone}; finite {f_finite}; "
        f"launches {launches}")
    if fdone != f_paths:
        raise AssertionError(f"flagship done {fdone} != {f_paths}")
    if frgb.shape != (NIF_SIZE, NIF_SIZE, 3) or not f_finite:
        raise AssertionError("flagship image has the wrong shape or "
                             "non-finite values")
    if min(launches.values()) < 1:
        raise AssertionError(f"the flagship skipped a kernel: {launches}")
    nv_times = []
    for _ in range(3):
        _, t = timed(lambda: render_streaming(fs, fp))
        nv_times.append(t)
    log(f"[flagship] without env (same trajectories): "
        f"{', '.join(f'{t:.3f}' for t in nv_times)} s; the env costs "
        f"{(median(f_times) - median(nv_times)) * 1e3:.1f} ms per frame "
        f"(medians)")

    # The flagship's own pixels at spp 64 against both routes: the first
    # SUB7 slots of its pool replayed with the same J, spp, k_total and
    # seed, as phase 5 does for the Cornell main path.
    replay(f"spheres+NIF {NIF_SIZE}^2 flagship", fs, fp, frgb, rows7, cols7,
           R7, J7, NIF_SPP, 0, SUB_NIF, "k1_rec", env=env)

    # The three kernels alone at the flagship's shapes (CUDA events):
    rec_ms, (rec, fdone_t) = event_ms(lambda: mk.trace_records(
        fs, rows7, cols7, fp.rng_seed, n7_pix, **kw7))
    esc = mk.escaped_records(rec, fdone_t)
    fdirs = rec[7:10][:, esc].t().contiguous()
    n_esc = int(fdirs.shape[0])
    mlp_ms, frgb_esc = event_ms(lambda: envk.env_mlp(fdirs, env))
    rec[7:10][:, esc] = frgb_esc.t()
    bank_ms, _ = event_ms(lambda: mk.bank(rec, fdone_t, NIF_SPP))
    bank_plain, t_bank_p = timed(lambda: mk.bank_ref(rec, fdone_t, NIF_SPP))
    bank_kern = mk.bank(rec, fdone_t, NIF_SPP)
    e = float((bank_kern - bank_plain).abs().max())
    err["bank"] = max(err["bank"], e)
    log(f"[flagship kernels alone] K1 record mode "
        f"{', '.join(f'{t:.2f}' for t in rec_ms)} ms; env MLP on {n_esc} "
        f"escaped paths of {f_paths} "
        f"{', '.join(f'{t:.2f}' for t in mlp_ms)} ms; bank "
        f"{', '.join(f'{t:.3f}' for t in bank_ms)} ms (plain "
        f"{t_bank_p * 1e3:.1f} ms, bit for bit "
        f"{torch.equal(bank_kern, bank_plain)})")
    if not torch.equal(bank_kern, bank_plain):
        raise AssertionError("bank kernel disagrees with its plain version")

    # The env MLP kernel on every escape of the flagship against its plain
    # version (in chunks), beside the library chain on the same escapes:
    # the gate of env_gate. Then the kernel and the chain timed in turns
    # (chain, kernel, kernel, chain) on those escapes and on the ENV_DIRS
    # seeded directions.
    env_ref, t_env_plain = [], 0.0
    for i in range(0, n_esc, 1 << 18):
        ref, t = timed(lambda: envk.env_mlp_ref(fdirs[i:i + (1 << 18)], env))
        env_ref.append(ref)
        t_env_plain += t
    env_ref = torch.cat(env_ref)
    log(f"[flagship env MLP] plain on all {n_esc} escapes: "
        f"{t_env_plain:.2f} s")
    lib_out = library_mlp(fdirs)
    env_dev_esc = env_gate(f"flagship env MLP, all {n_esc} escapes",
                           frgb_esc, env_ref, lib_out, fdirs)
    del env_ref, lib_out
    lib_ms, env_turn_ms, lib_small_ms, env_k_ms = [], [], [], []
    for fn, acc in ((lambda: library_mlp(fdirs), lib_ms),
                    (lambda: envk.env_mlp(fdirs, env), env_turn_ms),
                    (lambda: envk.env_mlp(fdirs, env), env_turn_ms),
                    (lambda: library_mlp(fdirs), lib_ms),
                    (lambda: library_mlp(dirs), lib_small_ms),
                    (lambda: envk.env_mlp(dirs, env), env_k_ms),
                    (lambda: envk.env_mlp(dirs, env), env_k_ms),
                    (lambda: library_mlp(dirs), lib_small_ms)):
        acc.extend(event_ms(fn, reps=1)[0])
    log(f"[env MLP yardstick] on the flagship's {n_esc} escapes, in turns: "
        f"torch.matmul chain {', '.join(f'{t:.2f}' for t in lib_ms)} ms, "
        f"kernel {', '.join(f'{t:.2f}' for t in env_turn_ms)} ms (the "
        f"kernel alone before: {', '.join(f'{t:.2f}' for t in mlp_ms)} ms);"
        f" on {ENV_DIRS} directions: chain "
        f"{', '.join(f'{t:.3f}' for t in lib_small_ms)} ms, kernel "
        f"{', '.join(f'{t:.3f}' for t in env_k_ms)} ms, plain "
        f"{t_ep * 1e3:.1f} ms; kernel faster than the chain "
        f"{max(env_turn_ms) < min(lib_ms)}")

    phase("8")
    # ---- 8. the stress ladder in HBM mode (K3) ----
    ladder = {g: rung(g, BIG_SIZE, BIG_SPP, BIG_MPL, LADDER_REPLAY[g])
              for g in LADDER}

    phase("9")
    # ---- 9. grid 512 at the Cornell main path's traffic: 1440^2 spp 64,
    # the default max_path_length; the walk counts for K3's bound at its
    # pool with spp 1 ----
    bs, bp = build_scene(make_stress_scene(MAIN_GRID), device=dev,
                         image_width=FULL, image_height=FULL,
                         samples_per_pixel=SPP)
    rows9, cols9, R9, J9, n9_pix = stream(bp)
    walk9 = {}
    records_vs_plain(f"stress{MAIN_GRID} {FULL}^2 pool", bs, bp, rows9,
                     cols9, R9, J9, n9_pix, walk9)
    mk.reset_launches()
    (rgb9, done9), t_warm = timed(lambda: render_streaming(bs, bp))
    times9 = []
    for _ in range(3):
        (rgb9, done9), t = timed(lambda: render_streaming(bs, bp))
        times9.append(t)
    k3_launches = mk.hbm_launches
    finite9 = bool(np.isfinite(rgb9).all())
    log(f"[stress{MAIN_GRID} main traffic] {FULL}^2 spp {SPP}: warm-up "
        f"{t_warm:.3f} s, runs {', '.join(f'{t:.3f}' for t in times9)} s; best "
        f"{min(times9):.3f} s = {paths / min(times9) / 1e6:.2f} M paths/s; "
        f"mean {float(rgb9.mean()):.6f}; done {done9}; finite {finite9}; K3 "
        f"launches {k3_launches}")
    if done9 != paths or not finite9 or rgb9.shape != (FULL, FULL, 3):
        raise AssertionError(f"stress{MAIN_GRID} main-traffic frame: done "
                             f"{done9}, finite {finite9}")
    if k3_launches < 1 or mk.launches:
        raise AssertionError("the main-traffic frame did not run K3 alone")
    kw9 = dict(params=bp, slots=R9, j_per_slot=J9, spp=SPP,
               max_iters=J9 * SPP * bp.max_path_length + 16,
               k_total=J9 * SPP)
    k3_ms, (k3_img, _) = event_ms(lambda: mk.megakernel_path_trace(
        bs, rows9, cols9, bp.rng_seed, n9_pix, **kw9))
    (k3_bound, k3_by), k3_ops, k3_bytes, k3_bound_flop = hbm_bound(
        bs, walk9, SPP, R9, J9)
    log(f"[stress{MAIN_GRID} main traffic] K3 alone "
        f"{', '.join(f'{t:.2f}' for t in k3_ms)} ms (CUDA events); bound "
        f"{k3_bound:.3f} ms ({k3_by}: {k3_ops:.4g} f32 instructions = the "
        f"pool's spp-1 counts x{SPP}, {k3_bytes / 1e6:.1f} MB; counted as "
        f"FLOP at 67 TFLOP/s {k3_bound_flop:.3f} ms)")
    counted9 = walk_counters(f"stress{MAIN_GRID} {FULL}^2", bs, rows9, cols9,
                             n9_pix, kw9, k3_img)

    phase("10")
    # ---- 10. path A at full width: the shadow trace of the grid-512
    # scene (HBM mode) at 1440^2, the glue route through K6 ----
    if bp.intersector != "pallas-hbm":
        raise AssertionError("path A must run the HBM-mode glue route")
    for m in (ik, ih, sh):
        m.reset_launches()
    aout, t_warm_a = timed(lambda: render(bs, bp))
    a_all, a_nrm = [], []
    for _ in range(3):
        aout, t = timed(lambda: render(bs, bp))
        a_all.append(t)
    for _ in range(3):
        anrm, t = timed(lambda: render(bs, bp, aovs=("normal",)))
        a_nrm.append(t)
    k6_launches = ih.launches
    a_hit = aout.geom_id >= 0
    a_finite = all(bool(np.isfinite(getattr(aout, f)[a_hit]).all())
                   for f in ("rgb", "t", "normal", "hit_p"))
    log(f"[path A] stress{MAIN_GRID} {FULL}^2 shadow trace, HBM mode: "
        f"warm-up {t_warm_a:.3f} s; all AOVs "
        f"{', '.join(f'{t:.4f}' for t in a_all)} s; normals only "
        f"{', '.join(f'{t:.4f}' for t in a_nrm)} s; best "
        f"{n_frame / min(a_all) / 1e6:.2f} / {n_frame / min(a_nrm) / 1e6:.2f} "
        f"M rays/s; hits {aout.hit_count} of {n_frame}; finite where hit "
        f"{a_finite}; K6 launches {k6_launches}, K5 {ik.launches}, K4 "
        f"{sh.launches}")
    if (aout.rgb.shape != (FULL, FULL, 3) or not a_finite
            or not 0 < aout.hit_count < n_frame
            or k6_launches != 2 * n_chunks * 7 or ik.launches or sh.launches):
        raise AssertionError("path A: wrong shape, non-finite AOVs, no hits, "
                             "or not K6 alone twice per chunk")
    if not (np.array_equal(anrm.normal, aout.normal)
            and np.array_equal(anrm.geom_id, aout.geom_id)):
        raise AssertionError("path A: the normals-only frame differs")
    # K6 alone over one frame's 2 * n_chunks calls (CUDA events), and the
    # frame's (bundle, block) pairs from the kernel's own counts:
    a_calls = []
    with recording(ih, "super_walk_cuda", a_calls):
        render(bs, bp, aovs=("normal",))
    if len(a_calls) != 2 * n_chunks:
        raise AssertionError("path A: not two K6 calls per chunk")
    k6_ms, _ = event_ms(lambda: [ik.walk_cuda(bs, *a, hbm=True)
                                 for a, _ in a_calls])
    k6_pairs = sum(int(o[4].sum()) for _, o in a_calls)
    k6_spec = sum(int(o[5].sum()) for _, o in a_calls)
    # Per launch: its time alone (CUDA events, best of 2), and the blocks
    # its 64 bundles' walks tested (max, mean): a launch once took as long
    # as its longest bundle, 39 us a block on one SM.
    k6_per = []
    for a, o in a_calls:
        t_l = min(event_ms(lambda: ik.walk_cuda(bs, *a, hbm=True), 2)[0])
        pr = o[4].double()
        k6_per.append(dict(ms=t_l, max=int(pr.max()), mean=float(pr.mean()),
                           spec=int(o[5].sum()),
                           listed=8 * int(a[0].sum())))
    k6_heavy = max(k6_per, key=lambda r: r["ms"])
    k6_heavy_b = max(k6_per, key=lambda r: r["max"])
    k6_dist = dict(
        launch_ms_max=k6_heavy["ms"], launch_ms_sum=sum(r["ms"] for r in k6_per),
        heaviest_launch=k6_heavy,
        heaviest_bundle_launch=dict(k6_heavy_b, ratio=k6_heavy_b["max"]
                                    / max(k6_heavy_b["mean"], 1e-9)),
        zero_work_launches=sum(r["listed"] == 0 for r in k6_per),
        speculative_blocks=k6_spec)
    log(f"[path A] K6 per launch: {json.dumps(k6_dist)}; every launch: "
        f"{json.dumps(k6_per)}")
    k6_need = sum(ik.needed_pairs(bs, a[1], a[3], o[0], o[4], members=8)
                  for a, o in a_calls)
    k6_rays = sum(a[3].shape[1] for a, _ in a_calls)
    k6_list_bytes = sum(a[1].numel() * 8 + a[0].numel() * 4
                        for a, _ in a_calls)
    log(f"[path A] K6 alone over the frame's {len(a_calls)} calls: "
        f"{', '.join(f'{t:.2f}' for t in k6_ms)} ms (CUDA events); "
        f"{k6_pairs} (bundle, block) pairs walked and {k6_spec} tested past "
        f"their bundles' stops (speculative), {k6_need} (lane, block) "
        f"pairs needed ({k6_need / (k6_pairs * 1024):.4f} of the walked "
        f"lanes); frame median {median(a_all) * 1e3:.2f} ms all AOVs, host "
        f"share (frame minus K6) "
        f"{1 - median(k6_ms) / (median(a_all) * 1e3):.3f}")
    # K6 against its plain version on the frame's own launches: the
    # primary and the occlusion call of the chunk that holds the median
    # lit pixel, and the occlusion call that walked the most (64 bundles
    # each), every output bit for bit.
    a_order = pixel_stream(bp).order
    a_lit = np.flatnonzero(aout.geom_id.reshape(-1)[a_order] >= 0)
    c_mid = int(a_lit[len(a_lit) // 2]) // DEFAULT_CHUNK
    c_occ = max(range(n_chunks), key=lambda c: int(a_calls[2 * c + 1][1][4]
                                                   .sum()))
    k6_rep_k = k6_rep_p = 0.0
    for ci in sorted({2 * c_mid, 2 * c_mid + 1, 2 * c_occ + 1}):
        a, o = a_calls[ci]
        _, t_k = timed(lambda: ik.walk_cuda(bs, *a, hbm=True))
        k6_rep_k += t_k
        k6_rep_p += walks_equal(
            f"path A chunk {ci // 2} {('primary', 'occlusion')[ci % 2]} "
            "call", "k6", bs, a, o, True)
    # The frame's pixels replayed by the plain route, every AOV bit for
    # bit: the 16 bundles from its first triangle hit, and 16 around its
    # median lit pixel; and K6 against its plain version on their primary
    # rays.
    a_tri = torch.cat([o[1][:DEFAULT_CHUNK] for _, o in a_calls[0::2]])
    a_first = min(int(torch.nonzero(a_tri >= 0)[0, 0]) // 1024, last)
    a_mid = min(max(int(a_lit[len(a_lit) // 2]) // 1024 - SHADOW_REPLAY // 2,
                    0), last)
    for b0 in (a_first, a_mid):
        g0 = b0 * 1024
        pix = a_order[g0:g0 + n_rep]
        rows, cols = (a[g0:g0 + len(pix)]
                      for a in pixel_stream(bp).coords(dev, n_frame))
        d_rep = generate_camera_rays(rows, cols, FULL, FULL,
                                     bp.fov_radians)[1]
        intersect_vs_plain(f"path A, stream pixels {g0}..{g0 + len(pix) - 1}",
                           bs, torch.zeros_like(d_rep), d_rep, True)
        glue_replay("path A pixels", bs, bp, aout, g0, n_rep)
    # The glue route on phase 6b's Cornell + monkey frame (K5) against
    # phase 6b's K4 frame:
    ik.reset_launches()
    gout, t_glue = timed(lambda: render(scene, params, fused=False))
    log(f"[glue Cornell + monkey {FULL}^2] {t_glue:.3f} s, K5 launches "
        f"{ik.launches}")
    g_sph = routes_agree(f"Cornell + monkey {FULL}^2", sout, gout, scene)
    # Its sphere pixels against the plain route: the 16 bundles around
    # the frame's median sphere pixel in stream order.
    g_at = np.flatnonzero(g_sph[order])
    g_b0 = min(max(int(g_at[len(g_at) // 2]) // 1024 - SHADOW_REPLAY // 2,
                   0), last)
    glue_replay(f"glue Cornell + monkey {FULL}^2 sphere pixels", scene,
                params, gout, g_b0 * 1024, n_rep)

    phase("11")
    # ---- 11. path B at full width: the XLA-loop integrator under the sky
    # env, Cornell + monkey at 1440^2 spp PATH_B_SPP (K5) ----
    pb = dataclasses.replace(params, samples_per_pixel=PATH_B_SPP)
    b_paths = FULL * FULL * PATH_B_SPP
    for m in (ik, ih, mk):
        m.reset_launches()
    b_stats = {}
    (brgb, bdone), t_warm_b = timed(lambda: render_streaming(
        scene, pb, env=sky, stats=b_stats))
    b_times = []
    for _ in range(3):
        (brgb, bdone), t = timed(lambda: render_streaming(scene, pb, env=sky,
                                                          stats=b_stats))
        b_times.append(t)
    k5_launches = ik.launches
    b_iters = b_stats["iters"] // 4
    b_finite = bool(np.isfinite(brgb).all())
    log(f"[path B] Cornell + monkey {FULL}^2 spp {PATH_B_SPP}, sky env, "
        f"XLA-loop integrator: warm-up {t_warm_b:.3f} s, runs "
        f"{', '.join(f'{t:.3f}' for t in b_times)} s; best "
        f"{b_paths / min(b_times) / 1e6:.2f} M paths/s; {b_iters} "
        f"iterations per frame; mean {float(brgb.mean()):.6f}; done {bdone}; "
        f"finite {b_finite}; K5 launches {k5_launches}, K6 {ih.launches}, "
        f"K1 {mk.launches}, K3 {mk.hbm_launches}")
    # One K5 launch per iteration; the host reads the active slots every
    # ACTIVE_CHECK iterations, so up to ACTIVE_CHECK - 1 idle ones follow:
    if (bdone != b_paths or not b_finite or brgb.shape != (FULL, FULL, 3)
            or not 4 * b_iters <= k5_launches < 4 * (b_iters + ACTIVE_CHECK)
            or ih.launches or mk.launches or mk.hbm_launches):
        raise AssertionError("path B: done, finite or the kernels launched "
                             "are wrong")
    b_calls = []
    with recording(ik, "dense_walk_cuda", b_calls):
        render_streaming(scene, pb, env=sky)
    k5_ms, _ = event_ms(lambda: [ik.walk_cuda(scene, *a, hbm=False)
                                 for a, _ in b_calls])
    k5_card_ms, _ = event_ms(lambda: [ik.walk_cuda(scene, *a, hbm=False)
                                      for a, _ in b_calls], hold_ms=300.0)
    k5_pairs = sum(int(o[4].sum()) for _, o in b_calls)
    k5_spec = sum(int(o[5].sum()) for _, o in b_calls)
    k5_need = k5_tested = 0
    for a, o in b_calls:  # each launch's pairs within [needed, dense]
        need = ik.needed_pairs(scene, a[1], a[3], o[0], o[4], members=1)
        tested = int(o[6].sum())
        if not need <= tested <= int(o[4].sum()) * 1024:
            raise AssertionError("K5: a launch's (lane, block) pairs lie "
                                 "outside [needed, dense]")
        k5_need += need
        k5_tested += tested
    k5_count = k45_counting(lambda c: [ik.walk_cuda(
        scene, *a, hbm=False, counters=c) for a, _ in b_calls])
    log(f"[K5 pairs] (lane, block) pairs tested {k5_tested}, needed "
        f"{k5_need}, dense {k5_pairs * 1024}; every launch within [needed, "
        f"dense]")
    log(f"[K5 counting launch] the frame's {len(b_calls)} launches: "
        f"{json.dumps(k5_count)}")
    k5_rays = sum(a[3].shape[1] for a, _ in b_calls)
    k5_list_bytes = sum(a[1].numel() * 8 + a[0].numel() * 4
                        for a, _ in b_calls)
    log(f"[path B] K5 alone over the frame's {len(b_calls)} calls: "
        f"{', '.join(f'{t:.2f}' for t in k5_ms)} ms (CUDA events, summed; "
        f"behind a spin kernel {', '.join(f'{t:.2f}' for t in k5_card_ms)} "
        f"ms); "
        f"{k5_pairs} (bundle, block) pairs walked and {k5_spec} tested past "
        f"their bundles' stops, {k5_need} (lane, block) "
        f"pairs needed ({k5_need / (k5_pairs * 1024):.4f} of the walked "
        f"lanes); frame median {median(b_times) * 1e3:.1f} ms, host share "
        f"(frame minus K5) {1 - median(k5_ms) / (median(b_times) * 1e3):.3f}")
    # K5 against its plain version on the frame's first iteration that
    # walked a block (the first slots' camera rays miss the box) and on a
    # mid-frame iteration:
    b_first = next(i for i, (_, o) in enumerate(b_calls)
                   if int(o[4].sum()) > 0)
    k5_rep_k = k5_rep_p = 0.0
    for it in (b_first, len(b_calls) // 2):
        a, o = b_calls[it]
        _, t_k = timed(lambda: ik.walk_cuda(scene, *a, hbm=False))
        k5_rep_k += t_k
        k5_rep_p += walks_equal(f"path B iteration {it}", "k5", scene, a, o,
                                False)
    # Path B on the grid-512 scene at 256^2 spp 8 (K6):
    w_b, spp_b = PATH_B_HBM
    pbh = dataclasses.replace(bp, image_width=w_b, image_height=w_b,
                              window_w=w_b, window_h=w_b,
                              samples_per_pixel=spp_b)
    ih.reset_launches()
    (hrgb, hdone), t_bh = timed(lambda: render_streaming(bs, pbh, env=sky))
    log(f"[path B] stress{MAIN_GRID} {w_b}^2 spp {spp_b}, sky env: "
        f"{t_bh:.3f} s = {w_b * w_b * spp_b / t_bh / 1e6:.2f} M paths/s; "
        f"done {hdone}; mean {float(hrgb.mean()):.6f}; K6 launches "
        f"{ih.launches}")
    if (hdone != w_b * w_b * spp_b or not np.isfinite(hrgb).all()
            or ih.launches < 1):
        raise AssertionError("path B on the grid-512 scene failed")

    phase("12")
    # ---- 12. sharded and progressive: render_streaming_sharded and
    # render_shadow_sharded on SHARDS shards of the card, the progressive
    # path trace, the f16 readback, two ranks on the card ----
    sharded_and_progressive(dev, scene, params, env)

    phase("13")
    # ---- 13. the application: trace_torch.py with the README's commands
    app = application(dev)

    phase("14")
    # ---- 14. the per-sample wavefront (render(streaming=False),
    # render_path_sharded) through K5, K6 and K2, and NIF training ----
    ps = per_sample_and_training(dev, scene, params)
    for k in ("k5", "k6", "env"):
        err[k] = max(err[k], ps["max_abs_err"][k])

    phase("15")
    # ---- 15. the "bvh" and "dense" intersectors: K7 and K8 on the shadow
    # trace, the XLA loop, the per-sample wavefront and the CLI ----
    p15 = intersectors(dev, sout, ps["frame"]["streaming_mean"])
    for k in ("k7", "k8"):
        err[k] = max(err[k], p15["max_abs_err"][k])

    def ps_launches(k):
        """Kernel ``k``'s launches in each of phase 14's runs."""
        return {run: n[k] for run, n in ps["launches"].items()}

    def intersect_bound(sc, need, rays, list_bytes):
        """K5/K6's bound over one frame's calls: the (lane, block) pairs
        its closest hits need (``needed_pairs``) x 128 rows x
        ROW_TEST_INSTR_FMA at the f32 instruction rate, or its bytes (every ray,
        list and output once, the tables once); and the previous basis,
        x ROW_TEST_FLOPS at 67 TFLOP/s."""
        ops = need * 128 * ROW_TEST_INSTR_FMA
        nbytes = (rays * INTERSECT_RAY_BYTES + list_bytes
                  + (sc.p.numel() + sc.nrm.numel()) * 4)
        return (*max((ops / PEAK_F32_INSTR * 1e3, "operations"),
                     (nbytes / PEAK_BYTES * 1e3, "bytes")),
                max(need * 128 * ROW_TEST_FLOPS / PEAK_F32,
                    nbytes / PEAK_BYTES) * 1e3)

    # Bounds (the larger of bytes / 3.35 TB/s and operations / peak):
    macs = env.macs
    seg64 = fwalk["segments"] * (NIF_SPP // CUT)
    rec_ops = (fwalk["block_tests"] * (NIF_SPP // CUT) * 128 * ROW_TEST_FLOPS
               + seg64 * fs.n_ap * AP_TEST_FLOPS)
    rec_bytes = int(fdone_t.sum()) * REC_BYTES
    bounds = {
        "k1": (k1_bound_ms, "operations", k1_ops / PEAK_F32 * 1e3),
        "k1_rec": (*max((rec_ops / PEAK_F32_INSTR * 1e3, "operations"),
                        (rec_bytes / PEAK_BYTES * 1e3, "bytes")),
                   max(rec_ops / PEAK_F32, rec_bytes / PEAK_BYTES) * 1e3),
        "env": (*max((n_esc * 2 * macs / PEAK_BF16 * 1e3, "operations"),
                     (n_esc * 24 / PEAK_BYTES * 1e3, "bytes")), None),
        "bank": (*max((rec_bytes / PEAK_BYTES * 1e3, "bytes"),
                      (n_esc * 6 / PEAK_F32 * 1e3, "operations")), None),
        "k3": (k3_bound, k3_by, k3_bound_flop),
        "k4": (*k4_bound, k4_bound_flop),
        "k5": intersect_bound(scene, k5_need, k5_rays, k5_list_bytes),
        "k6": intersect_bound(bs, k6_need, k6_rays, k6_list_bytes),
    }
    phase("end")
    log(f"[bounds] K1 {bounds['k1'][0]:.3f} ms ({bounds['k1'][1]}) vs "
        f"{main_ms:.2f} ms; K1 record mode {bounds['k1_rec'][0]:.3f} ms "
        f"({bounds['k1_rec'][1]}; {seg64} segments at spp {NIF_SPP}) vs "
        f"{median(rec_ms):.2f} ms; env MLP {bounds['env'][0]:.3f} ms "
        f"({n_esc} x 2 x {macs} FLOP at 989 TFLOP/s) vs "
        f"{median(mlp_ms):.2f} ms; bank {bounds['bank'][0]:.3f} ms "
        f"({rec_bytes} record bytes) vs {median(bank_ms):.3f} ms")

    cli_key = {"k1": "k1", "k1_rec": "k1", "env": "env", "bank": "bank",
               "k3": "k3", "k4": "k4", "k5": "k5", "k6": "k6"}

    def entry(name, source, replaces, key, n_launch, ms_, shape, plain_ms,
              kernel_ms_plain_shape, plain_shape, library_ms=None,
              library_shape=None, **more):
        """One kernel's line: ``ms`` and ``bound_ms`` on its main path;
        ``plain_ms`` (and the kernel at the same shape) where the plain
        version can run in this script's time; ``launches_cli``: its
        launches in each of phase 13's commands (K1's count includes its
        record mode)."""
        more["launches_cli"] = {c: v["launches"][cli_key[key]]
                                for c, v in app["commands"].items()}
        return {"name": name, "route": "cuda",
                "source": f"ipu_ray_lib_tpu_torch/ops/cuda/{source}",
                "replaces": replaces, "launches": n_launch,
                "max_abs_err": err[key], "ms": ms_, "plain_ms": plain_ms,
                "bound_ms": bounds[key][0], "bound_by": bounds[key][1],
                "bound_ms_flop_basis": bounds[key][2],
                "library_ms": library_ms, "ms_shape": shape,
                "plain_shape": plain_shape,
                "kernel_ms_at_plain_shape": kernel_ms_plain_shape,
                "library_shape": library_shape, **more}

    mega = "ipu_ray_lib_tpu/ops/pallas/megakernel.py"
    r512 = ladder[MAIN_GRID]
    log(json.dumps({"kernels": [
        entry("megakernel_path_trace", "megakernel.cu", f"{mega}:329",
              "k1", k1_launches, main_ms,
              f"Cornell main path's launch, {FULL}^2 spp {SPP}",
              p_main * 1e3, k_main * 1e3,
              f"its slot pool (R={R}, J={J}) at spp 1",
              counters=counted5["summary"]),
        entry("megakernel_path_trace[record]", "megakernel.cu",
              f"{mega}:2362", "k1_rec", launches["k1_rec"], median(rec_ms),
              f"flagship launch, spheres+NIF {NIF_SIZE}^2 spp {NIF_SPP}",
              p_rec_cut * 1e3, median(k_rec_cut),
              f"its slot pool (R={R7}, J={J7}) at spp {CUT}",
              launches_per_sample=ps_launches("k1")),
        entry("env_mlp", "env_mlp.cu", f"{mega}:2304", "env",
              launches["env"], median(mlp_ms),
              f"the flagship's {n_esc} escaped paths", t_env_plain * 1e3,
              median(mlp_ms), "the same escapes, in chunks of 262144",
              median(lib_ms), "the same escapes, in chunks of 2097152",
              kernel_ms_small=median(env_k_ms),
              library_ms_small=median(lib_small_ms),
              plain_ms_small=t_ep * 1e3,
              small_shape=f"{ENV_DIRS} seeded directions",
              kernel_ms_turns=env_turn_ms, library_ms_turns=lib_ms,
              launches_per_sample=ps_launches("env"),
              tolerance="envk.within_yardstick: no further from the plain "
                        "version than the torch.matmul chain, plus slack",
              deviation={"escapes": {"kernel": env_dev_esc[0],
                                     "chain": env_dev_esc[1]},
                         "seeded": {"kernel": env_dev_small[0],
                                    "chain": env_dev_small[1]}}),
        entry("bank", "megakernel.cu", f"{mega}:2409", "bank",
              launches["bank"], median(bank_ms),
              f"the flagship's records, {NIF_SIZE}^2 spp {NIF_SPP}",
              t_bank_p * 1e3, median(bank_ms), "the same records",
              launches_per_sample=ps_launches("bank")),
        entry("megakernel_path_trace[hbm]", "megakernel.cu", f"{mega}:1056",
              "k3", k3_launches, median(k3_ms),
              f"stress grid 512 (522,242 triangles) at {FULL}^2 spp {SPP}",
              r512["plain_s"] * 1e3, r512["kernel_s"] * 1e3,
              f"the grid-512 rung's slot pool (R={r512['R']}, "
              f"J={r512['J']}) at spp 1, {BIG_SIZE}^2, max_path_length "
              f"{BIG_MPL}",
              ladder_ms={str(g): median(r["k_ms"]) for g, r in ladder.items()},
              ladder_bound_ms={str(g): r["bound"] for g, r in ladder.items()},
              ladder_shape=f"{BIG_SIZE}^2 spp {BIG_SPP}, max_path_length "
                           f"{BIG_MPL}",
              counters={"1440": counted9["summary"], **{
                  str(g): r["counted"]["summary"]
                  for g, r in ladder.items()}}),
        entry("shadow_trace", "shadow.cu",
              "ipu_ray_lib_tpu/ops/pallas/shadow_kernel.py:56", "k4",
              k4_launches, median(k4_ms),
              f"one Cornell + monkey {FULL}^2 shadow frame: {n_chunks} "
              f"launches of {DEFAULT_CHUNK} rays", k4_plain_ms,
              median(k4_ms), "the same frame, chunk by chunk",
              needed_pairs=[k4_need_p, k4_need_o],
              pairs=[k4_walk["primary_pairs"], k4_walk["occlusion_pairs"]],
              lane_pairs_tested=k4_lp[2:], counters=k4_count,
              ms_card=median(k4_card_ms),
              bound_ms_bundle_pairs=k4_ops_bundles / PEAK_F32_INSTR * 1e3,
              frame_ms_all_aovs=median(s_all) * 1e3,
              frame_ms_normals=median(s_nrm) * 1e3,
              epilogue_ms=median(epi_ms), camera_cull_ms=median(cull_ms),
              untile_ms=median(untile_ms), d2h_ms=median(d2h)),
        entry("dense_intersect", "intersect.cu",
              "ipu_ray_lib_tpu/ops/pallas/intersect_kernel.py:184", "k5",
              k5_launches, median(k5_ms),
              f"one path-B frame, Cornell + monkey {FULL}^2 spp "
              f"{PATH_B_SPP}: {len(b_calls)} launches of 131072 rays",
              k5_rep_p * 1e3, k5_rep_k * 1e3,
              "the frame's first and a mid-frame iteration",
              pairs=k5_pairs, needed_pairs=k5_need,
              lane_pairs_tested=k5_tested, counters=k5_count,
              ms_card=median(k5_card_ms),
              speculative_blocks=k5_spec,
              frame_ms=median(b_times) * 1e3,
              iterations=b_iters, launches_per_sample=ps_launches("k5"),
              per_sample_frame_k5_ms=ps["frame"]["k5_card_ms"],
              per_sample_frame_ms=ps["frame"]["frame_ms"]),
        entry("hbm_intersect", "intersect.cu",
              "ipu_ray_lib_tpu/ops/pallas/intersect_hbm.py:47", "k6",
              k6_launches, median(k6_ms),
              f"one path-A frame, stress grid {MAIN_GRID} at {FULL}^2: "
              f"{len(a_calls)} launches of {DEFAULT_CHUNK} rays",
              k6_rep_p * 1e3, k6_rep_k * 1e3,
              "the frame's primary and occlusion calls of one chunk and "
              "its heaviest occlusion call", pairs=k6_pairs,
              needed_pairs=k6_need, speculative_blocks=k6_spec,
              distribution={k: v for k, v in k6_dist.items()
                            if k != "speculative_blocks"},
              frame_ms_all_aovs=median(a_all) * 1e3,
              frame_ms_normals=median(a_nrm) * 1e3,
              launches_per_sample=ps_launches("k6")),
        *(p15_entry(p15, key, err[key]) for key in ("k7", "k8")),
    ]}))
    log(identity)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
