"""Numeric constants shared by all renderers.

Mirrors the semantics of the reference's constants
(ref: include/embree_utils/geometry.hpp:14-20 and
include/precision_utils.hpp:19-29) without sharing any code: these are the
standard PBRT-style floating-point error-bound helpers.
"""

import numpy as np

_DOUBLE_PI = 3.14159265358979323846264338327950288

PI = np.float32(_DOUBLE_PI)
TWO_PI = np.float32(2.0 * _DOUBLE_PI)
INV_PI = np.float32(1.0 / _DOUBLE_PI)
INV_2PI = np.float32(1.0 / (2.0 * _DOUBLE_PI))
PI_BY_2 = np.float32(_DOUBLE_PI / 2.0)
PI_BY_4 = np.float32(_DOUBLE_PI / 4.0)

# Half of float32 epsilon: the classic PBRT "machine epsilon" (2^-24).
MACHINE_EPSILON = np.float32(np.finfo(np.float32).eps * 0.5)


def gamma(n: int) -> np.float32:
    """PBRT floating-point error bound helper: n*eps / (1 - n*eps)."""
    ni = MACHINE_EPSILON * n
    return np.float32(ni / (1.0 - ni))


# Scale-aware self-intersection epsilon (ref: include/precision_utils.hpp:29).
RAY_EPSILON = np.float32(MACHINE_EPSILON * 1500.0)

# Watertight acceptance widening for the dense plane+barycentric test
# (the hot-path analogue of the reference's PBRT watertight contract,
# ref: src/Mesh.cpp:8-104). The barycentric b1 = og1 + t*dg1 - g1p0 is
# accepted down to -eps with
#     eps = WATERTIGHT_EPS_SCALE * (S_tri + G_tri * (|o|_inf + E_t)),
#     E_t = (|tnp0| + |o.n|) * |1/(d.n)|   (>= |t| and its error scale),
#     S_tri = |g1p0| + |g2p0|,  G_tri = ||g1||_1 + ||g2||_1  (per-tri cols)
# which dominates the rounding of every term in the b chain:
#   * gamma_4-style accumulation over the og/dg FMA chains
#     (|og1| <= G*|o|_inf, |t*dg1| <= G*E_t, |g1p0| <= S),
#   * the Newton-refined reciprocal's t error (|dt| <~ gamma_6 * E_t),
#   * f32 quantisation of the f64-built g/tnp0 table entries.
# A true shared-edge point has some b == 0 exactly, so with the widened
# band it is accepted by at least one incident triangle: cracks are
# impossible by construction. (The two incident triangles may BOTH
# accept within the band — a benign double hit at equal t; the
# reference's optional exact-edge double recompute resolves such ties
# exactly instead, README.md:109-120 — not expressible on TPU f32.)
# 16*eps_mach covers the chain; x2 safety for the table quantisation.
# Kernels CLAMP the resulting eps at 1e-3: near-grazing pairs (n.d -> 0)
# blow E_t up and would otherwise turn the widened test into accept-all
# (garbage hits instead of escapes on open scenes). 1e-3 is 10-100x the
# legitimate edge-acceptance bound for sane geometry; a grazing-plane
# triangle's own t is numerically meaningless anyway — the shared-edge
# NEIGHBOR's well-conditioned test is what makes edge points watertight:
WATERTIGHT_EPS_SCALE = np.float32(32.0 * MACHINE_EPSILON)
