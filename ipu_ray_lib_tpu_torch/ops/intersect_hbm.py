"""Closest hit against the blocked tables of a scene of any size (K6).

Port of ``pallas_intersect_hbm`` (ipu_ray_lib_tpu/ops/pallas/intersect_hbm.py:
263-320), whose Pallas kernel ``_hbm_kernel`` (:47) walks each bundle's
*super* list (``SB = 8`` blocks per super) from the bundle cull against
the super AABBs (ops/cull.py ``super_cull_lists_bundle``), nearest first,
tests all 8 member blocks of each listed super (no member cull), and
stops after every ``CHECK_EVERY = 2`` supers once the bundle's largest
best t is below the next super's distance bound. Ties resolve as in K5
(ops/intersect_kernel.py): the lowest row inside a block, the first block
in walk order across blocks and members. A winner's row is its global
row ``(super * SB + member) * TB + lane``.

On the TPU the tables stream from HBM through a double-buffered window;
the ray axis is cut into calls of ``RB_PER_CALL`` bundles only to bound
its scalar memory, which changes no result, so one call does all bundles
here. Above ``HBM_SPLIT_MIN_TRIS`` padded rows the JAX package keeps the
payload in bf16 and rounds the winner's barycentrics to bf16 before they
weight it; the port's payload then holds the same bf16 values in f32
(``TorchScene.payload_split``) and rounds the barycentrics alike.

The CUDA kernel (``ops/cuda/intersect.cu``, ``intersect_kernel<true>``)
and :func:`super_walk_ref` share K5's contract and raw outputs.
"""

from __future__ import annotations

from .cull import BR, super_cull_lists_bundle
from .intersect_kernel import (intersect_epilogue, intersect_inputs,
                               walk_cuda, walk_ref, REF_BUNDLES)
from .tables import SB

CHECK_EVERY = 2

# CUDA kernel launches since the last reset.
launches = 0


def reset_launches() -> None:
    global launches
    launches = 0


def super_walk_ref(scene, counts, order, dists, rays, *,
                   bundles: int = REF_BUNDLES):
    """Plain version of K6: counts [nrb] i32, order/dists [nrb, ns] from
    the super cull, rays [8, nrb*BR] -> (t, tri, n, m, pairs); a bundle
    tests 8 blocks per listed super it walks."""
    return walk_ref(scene, counts, order, dists, rays, members=SB,
                    check_every=CHECK_EVERY, split=scene.payload_split,
                    bundles=bundles)


def super_walk_cuda(scene, counts, order, dists, rays):
    """K6 on the card; counts its launches."""
    global launches
    out = walk_cuda(scene, counts, order, dists, rays, hbm=True)
    launches += 1
    return out


def pallas_intersect_hbm(scene, origins, dirs, t_min, t_max):
    """Closest hit of R rays against the scene's blocked triangles through
    the super lists (any scene size): the kernel on a CUDA scene, the plain
    version on a CPU scene. Same results as ``pallas_intersect``."""
    R = dirs.shape[0]
    o_pad, d_pad, tmin_pad, tmax_pad, rays = intersect_inputs(
        origins, dirs, t_min, t_max)
    lists = super_cull_lists_bundle(scene, o_pad, d_pad, tmin_pad, tmax_pad,
                                    rays.shape[1] // BR)
    dev = scene.device.type
    if dev == "cuda":
        out = super_walk_cuda(scene, *lists, rays)
    elif dev == "cpu":
        out = super_walk_ref(scene, *lists, rays)
    else:
        raise ValueError(f"unsupported device {scene.device}")
    return intersect_epilogue(out, t_max, R)
