"""Conservative float16 rounding for BVH extents.

The compact BVH stores box extents (dx,dy,dz) in fp16 to save 25% node
memory (ref: include/CompactBVH2Node.hpp:69-71). Extents must be rounded
*up* so boxes never shrink (ref: include/precision_utils.hpp:31-47) —
otherwise traversal could miss hits.

Implemented here with vectorised numpy bit manipulation rather than a
scalar loop: this runs at host scene-build time over whole node arrays.
"""

import numpy as np


def round_to_half_not_smaller(x: np.ndarray) -> np.ndarray:
    """Round float32 values to float16 such that result >= input.

    Assumes non-negative finite inputs (box extents). Values that would
    overflow fp16 must be rejected by the caller (max half = 65504).
    """
    x = np.asarray(x, dtype=np.float32)
    h = x.astype(np.float16)
    # Where the rounded value shrank, bump to the next representable half.
    # For positive halves, the next value up is bit-pattern + 1.
    bits = h.view(np.uint16)
    need_bump = h.astype(np.float32) < x
    bumped = (bits + np.uint16(1)).view(np.float16)
    return np.where(need_bump, bumped, h)
