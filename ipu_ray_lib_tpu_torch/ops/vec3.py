"""Component-tuple vec3 helpers: a vec3 is a tuple of three tensors of one
shape, as in the megakernel (megakernel.py:209-234). Every helper keeps
the reference's operation order, so results round the same way."""

from __future__ import annotations

import functools

import numpy as np
import torch

TINY = float(np.float32(1e-30))


@functools.cache
def const3(x: float, y: float, z: float, device: torch.device) -> torch.Tensor:
    """The f32 vector [3] (x, y, z) on ``device``, made once and kept for
    good (read only): a copy from the host cannot be captured in a CUDA
    graph, and a captured graph reads the tensor whenever it replays
    (render/renderer.py)."""
    return torch.tensor([x, y, z], dtype=torch.float32, device=device)


def dot3(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def cross3(a, b):
    return (a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0])


def sqrt(x):
    """The correctly rounded f32 square root (as the kernels' ``sqrtf``
    and XLA's): ``torch.sqrt`` of an f32 CPU tensor of more than 512
    elements is not, so it is taken in float64, which rounds to the same
    f32 value as one correct rounding."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def inv_sqrt(x):
    """1 / sqrt(max(x, 1e-30)) with an IEEE division: ``torch.rsqrt`` is
    approximate on CUDA, and the kernel uses this same form."""
    return torch.reciprocal(torch.sqrt(torch.clamp_min(x, 1e-30)))


def fma(a, b, c):
    """f32 ``a * b + c`` rounded once, as XLA's CPU backend contracts a
    product and a sum inside a fused computation. Evaluated in float64,
    where the product of two f32 is exact; the sum rounds there and again
    to f32, which differs from one rounding only when the float64 sum
    lands on an f32 tie (about 2**-29 of the cases)."""
    up = lambda x: x.to(torch.float64) if torch.is_tensor(x) else x
    return (up(a) * up(b) + up(c)).to(torch.float32)


def sum3(a, b):
    """a0*b0 + a1*b1 + a2*b2 as XLA reduces a dot or a sum over the last
    axis: in order, each product fused into the running sum."""
    return fma(a[2], b[2], fma(a[1], b[1], a[0] * b[0]))


def rowdot(a, b):
    """``sum(a * b, axis=-1)`` of [R, 3] rows, as XLA reduces it."""
    return sum3(tuple(a[:, c] for c in range(3)),
                tuple(b[:, c] for c in range(3)))


def unit(v):
    """Rows of v [R, 3] over max(|v|, 1e-30), as XLA compiles
    ``v / maximum(linalg.norm(v, axis=-1, keepdims=True), 1e-30)``."""
    return v / torch.clamp_min(sqrt(rowdot(v, v)), TINY)[:, None]


def normalize3(v):
    il = inv_sqrt(dot3(v, v))
    return (v[0] * il, v[1] * il, v[2] * il)


def where3(m, a, b):
    return (torch.where(m, a[0], b[0]), torch.where(m, a[1], b[1]),
            torch.where(m, a[2], b[2]))


def scale3(v, s):
    return (v[0] * s, v[1] * s, v[2] * s)


def add3(a, b):
    return (a[0] + b[0], a[1] + b[1], a[2] + b[2])
