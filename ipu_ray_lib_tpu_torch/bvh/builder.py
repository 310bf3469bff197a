"""BVH2 build + compact flatten, host side.

Fills the role of the reference's Embree-callback BVH build and
flattening pass (ref: include/embree_utils/bvh.hpp:27-126,
src/CompactBvhBuild.cpp:6-56), re-designed for the TPU runtime:

* Built here with a binned-SAH builder (the native C++ build in
  :mod:`.cbuilder`; the same algorithm in numpy,
  :func:`build_bvh_python`) — no Embree dependency.
* Flattened depth-first with the first child adjacent and an explicit
  second-child index, exactly like the reference's compact node array —
  *plus* a per-node **miss link**, which converts the array into a
  threaded ("stackless") BVH: traversal needs no per-ray stack, giving
  uniform control flow that maps onto TPU vector lanes.
* Box extents are stored fp16, conservatively rounded up so boxes never
  shrink (ref: include/CompactBVH2Node.hpp:69-71); build raises if an
  extent exceeds fp16 max (65504), matching src/CompactBvhBuild.cpp:15-18.

Node encoding (SoA arrays, one row per node):
  mins[N,3]  f32   box minimum corner
  exts[N,3]  f16   box extents (>= true extent)
  meta[N]    i32   leaf: primID within its geometry; inner: second-child index
  geom[N]    i32   leaf: geomID; inner: INVALID_GEOM_ID sentinel
  miss[N]    i32   node to visit when the box test fails (or after a leaf);
                   == N means traversal is done

The hit-successor of an inner node is implicitly ``index + 1`` (first
child adjacent); the hit-successor of a leaf is its miss link. Multi-prim
leaves are emitted as runs of single-prim nodes chained by miss links so
the node encoding stays uniform.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.half import round_to_half_not_smaller

INVALID_GEOM_ID = 0xFFFF
MAX_HALF = 65504.0

_NUM_BINS = 16
# One primitive per leaf, the reference build configuration (ref:
# include/embree_utils/bvh.hpp:47-60: branching factor 2, maxLeafSize 1,
# SAH):
MAX_LEAF_SIZE = 1


@dataclass
class CompactBvh:
    mins: np.ndarray  # [N,3] f32
    exts: np.ndarray  # [N,3] f16
    meta: np.ndarray  # [N] i32
    geom: np.ndarray  # [N] i32
    miss: np.ndarray  # [N] i32
    max_depth: int

    @property
    def num_nodes(self) -> int:
        return len(self.mins)


def _surface_area(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    d = np.maximum(hi - lo, 0.0)
    return 2.0 * (d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0])


def build_bvh(
    prim_lo: np.ndarray,
    prim_hi: np.ndarray,
    geom_ids: np.ndarray,
    prim_ids: np.ndarray,
) -> CompactBvh:
    """Binned-SAH BVH2 over per-primitive AABBs (one primitive per
    leaf), flattened compactly: the native build (:mod:`.cbuilder`), the
    JAX package's, whose leaf order the blocked tables follow. It raises
    where that build cannot run; :func:`build_bvh_python` is the same
    algorithm in numpy, called only by name."""
    from .cbuilder import build_bvh_native

    return build_bvh_native(prim_lo, prim_hi, geom_ids, prim_ids)


def build_bvh_python(prim_lo, prim_hi, geom_ids, prim_ids) -> CompactBvh:
    prim_lo = np.asarray(prim_lo, np.float32).reshape(-1, 3)
    prim_hi = np.asarray(prim_hi, np.float32).reshape(-1, 3)
    geom_ids = np.asarray(geom_ids, np.int64)
    prim_ids = np.asarray(prim_ids, np.int64)
    n = len(prim_lo)
    if n == 0:
        raise ValueError("Cannot build a BVH over zero primitives.")
    centroids = 0.5 * (prim_lo + prim_hi)

    # ---- Top-down binned-SAH build of the (pointer-free) tree ----------
    nodes_lo: list[np.ndarray] = []
    nodes_hi: list[np.ndarray] = []
    nodes_left: list[int] = []   # -1 => leaf
    nodes_right: list[int] = []
    nodes_prim: list[np.ndarray] = []

    def make_node(idx: np.ndarray) -> int:
        me = len(nodes_lo)
        nodes_lo.append(prim_lo[idx].min(axis=0))
        nodes_hi.append(prim_hi[idx].max(axis=0))
        nodes_left.append(-1)
        nodes_right.append(-1)
        nodes_prim.append(idx)
        return me

    def split(idx: np.ndarray):
        count = len(idx)
        if count <= MAX_LEAF_SIZE:
            return None
        cent = centroids[idx]
        clo, chi = cent.min(axis=0), cent.max(axis=0)
        axis = int(np.argmax(chi - clo))
        extent = float(chi[axis] - clo[axis])
        if extent <= 0.0:
            half = count // 2  # degenerate: identical centroids
            return idx[:half], idx[half:]
        scale = _NUM_BINS * (1.0 - 1e-6) / extent
        bins = np.minimum(
            ((cent[:, axis] - clo[axis]) * scale).astype(np.int32), _NUM_BINS - 1
        )
        bin_counts = np.bincount(bins, minlength=_NUM_BINS)
        bin_lo = np.full((_NUM_BINS, 3), np.inf, np.float32)
        bin_hi = np.full((_NUM_BINS, 3), -np.inf, np.float32)
        for b in np.nonzero(bin_counts)[0]:
            sel = bins == b
            bin_lo[b] = prim_lo[idx[sel]].min(axis=0)
            bin_hi[b] = prim_hi[idx[sel]].max(axis=0)
        lcount = np.cumsum(bin_counts)[:-1]
        rcount = count - lcount
        llo = np.minimum.accumulate(bin_lo, axis=0)[:-1]
        lhi = np.maximum.accumulate(bin_hi, axis=0)[:-1]
        rlo = np.minimum.accumulate(bin_lo[::-1], axis=0)[::-1][1:]
        rhi = np.maximum.accumulate(bin_hi[::-1], axis=0)[::-1][1:]
        cost = _surface_area(llo, lhi) * lcount + _surface_area(rlo, rhi) * rcount
        valid = (lcount > 0) & (rcount > 0)
        if not np.any(valid):
            order = np.argsort(cent[:, axis], kind="stable")
            half = count // 2
            return idx[order[:half]], idx[order[half:]]
        best = int(np.argmin(np.where(valid, cost, np.inf)))
        go_left = bins <= best
        return idx[go_left], idx[~go_left]

    root = make_node(np.arange(n))
    work = [root]
    while work:
        node = work.pop()
        parts = split(nodes_prim[node])
        if parts is None:
            continue
        li, ri = parts
        left = make_node(li)
        right = make_node(ri)
        nodes_left[node] = left
        nodes_right[node] = right
        nodes_prim[node] = np.empty(0, np.int64)
        work.append(right)
        work.append(left)

    return _flatten(
        nodes_lo, nodes_hi, nodes_left, nodes_right, nodes_prim, geom_ids, prim_ids
    )


def _flatten(nodes_lo, nodes_hi, nodes_left, nodes_right, nodes_prim,
             geom_ids, prim_ids) -> CompactBvh:
    """Assign positions arithmetically (via subtree sizes), then fill arrays.

    Because the first child is adjacent, the emitted position of every node
    is fully determined by subtree sizes — no patch-up passes needed.
    """
    t_n = len(nodes_lo)

    # Emitted size of each subtree (leaves expand to one node per prim).
    size = np.zeros(t_n, np.int64)
    # Post-order via reverse pre-order:
    order: list[int] = []
    stack = [0]
    while stack:
        node = stack.pop()
        order.append(node)
        if nodes_left[node] >= 0:
            stack.append(nodes_left[node])
            stack.append(nodes_right[node])
    for node in reversed(order):
        if nodes_left[node] < 0:
            size[node] = len(nodes_prim[node])
        else:
            size[node] = 1 + size[nodes_left[node]] + size[nodes_right[node]]

    n_out = int(size[0])
    mins = np.empty((n_out, 3), np.float32)
    exts_f32 = np.empty((n_out, 3), np.float32)
    meta = np.empty(n_out, np.int32)
    geom = np.empty(n_out, np.int32)
    miss = np.empty(n_out, np.int32)
    SENTINEL = n_out

    max_depth = 0
    # Frames: (tree node, emitted position, miss link, depth)
    stack2 = [(0, 0, SENTINEL, 1)]
    while stack2:
        node, pos, miss_link, depth = stack2.pop()
        if depth > max_depth:
            max_depth = depth
        lo, hi = nodes_lo[node], nodes_hi[node]
        prims = nodes_prim[node]
        if nodes_left[node] < 0:
            k = len(prims)
            for j, p in enumerate(prims):
                me = pos + j
                mins[me] = lo
                exts_f32[me] = np.maximum(hi - lo, 0.0)
                meta[me] = np.int32(prim_ids[p])
                geom[me] = np.int32(geom_ids[p])
                miss[me] = me + 1 if j + 1 < k else miss_link
        else:
            left, right = nodes_left[node], nodes_right[node]
            right_pos = pos + 1 + int(size[left])
            mins[pos] = lo
            exts_f32[pos] = np.maximum(hi - lo, 0.0)
            meta[pos] = np.int32(right_pos)
            geom[pos] = INVALID_GEOM_ID
            miss[pos] = miss_link
            # Left child sits at pos+1; if its box misses, skip to right.
            stack2.append((left, pos + 1, right_pos, depth + 1))
            stack2.append((right, right_pos, miss_link, depth + 1))

    if np.any(exts_f32 > MAX_HALF):
        raise ValueError("Cannot compress BVH bounds into fp16 (half)")
    exts = round_to_half_not_smaller(exts_f32)
    return CompactBvh(mins, exts, meta, geom, miss, max_depth)
