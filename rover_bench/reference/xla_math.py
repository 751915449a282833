"""Frozen copy of the parts of ``husky_rover_mppi_isaacsim_torch/core/xla_math.py``
(commit c6c4900) that JAX's draws (:mod:`.jax_random`) need; it imports
nothing of the port.

XLA's CPU backend lets LLVM contract ``a * b + c`` into a fused
multiply-add, and its ``sqrt`` is correctly rounded. torch has no fused
multiply-add. :func:`fma_f32` forms one exactly (the float32 product exact
in float64, the float64 sum rounded to odd, then one rounding to float32);
a true FMA on the card (``__fmaf_rn``) gives the same bits.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import Tensor

FLT_MIN = 2.0 ** -126


def f32(bits: int) -> float:
    """The float32 of the bit pattern ``bits``, as a Python float."""
    return float(np.array(bits, np.uint32).view(np.float32))


def fma_f32(a: Tensor, b, c) -> Tensor:
    """``a * b + c`` rounded once to float32, as a fused multiply-add does
    (module note): float32 operands, the product exact in float64, the sum
    rounded to odd there, then to float32. ``b`` and ``c`` may be Python
    floats that are float32 values."""
    p = a.to(torch.float64) * (b.to(torch.float64) if isinstance(b, Tensor) else b)
    c = c.to(torch.float64) if isinstance(c, Tensor) else torch.full_like(p, c)
    if p.is_cuda:  # branch-free: no host read on the card
        return _round_odd_sum(p, c).to(torch.float32)
    # the float64 sum rounds once; rounding it to float32 can only go wrong
    # where it lies on a float32 midpoint (or in float32's subnormal range):
    # those few are rounded to odd first
    p, c = torch.broadcast_tensors(p, c)
    s = p + c
    bits = s.view(torch.int64)
    suspect = ((bits & 0x1FFFFFFF) == 0x10000000) | (torch.abs(s) < FLT_MIN)
    out = s.to(torch.float32)
    idx = torch.nonzero(suspect.reshape(-1)).flatten()
    if idx.numel():
        flat = out.reshape(-1)
        pi, ci = p.reshape(-1)[idx], c.reshape(-1)[idx]
        flat[idx] = _round_odd_sum(pi, ci).to(torch.float32)
        out = flat.reshape(out.shape)
    return out


def _two_sum(a: Tensor, b: Tensor) -> tuple[Tensor, Tensor]:
    """``s + err == a + b`` exactly, ``s`` the rounded sum (Knuth's TwoSum)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _round_odd_sum(a: Tensor, b: Tensor) -> Tensor:
    """``a + b`` (float64) rounded to odd: the rounded sum, moved one unit
    away from it toward the exact sum where it was inexact and even."""
    s, err = _two_sum(a, b)
    bits = s.view(torch.int64)
    odd = (err != 0) & ((bits & 1) == 0) & (s != 0)
    away = (err > 0) == (s > 0)  # the exact sum lies beyond s, away from zero
    bits = torch.where(odd, bits + torch.where(away, 1, -1), bits)
    return bits.view(torch.float64)


def sqrt_f32(a: Tensor) -> Tensor:
    """The correctly rounded float32 square root of float32 ``a`` >= 0, as
    XLA's ``sqrt`` and CUDA's ``__fsqrt_rn`` give it. ``torch.sqrt`` on the
    CPU is not that: it may be one unit in the last place off, and a
    parallel chunk of it has been seen to come out of a ~1e-4 approximation.
    So a float64 root is polished by two Newton steps and rounded to
    float32, and the neighbour on the far side of an exact float64 midpoint
    test replaces it where the rounding went the wrong way."""
    a64 = a.to(torch.float64)
    s = torch.sqrt(a64)
    for _ in range(2):
        s = 0.5 * (s + a64 / s)
    r = torch.where(a > 0, s.to(torch.float32), a)
    up = torch.nextafter(r, torch.full_like(r, math.inf))
    mid = (r.to(torch.float64) + up.to(torch.float64)) * 0.5  # exact; so is its square
    r = torch.where((a > 0) & (a64 > mid * mid), up, r)
    down = torch.nextafter(r, torch.zeros_like(r))
    mid = (r.to(torch.float64) + down.to(torch.float64)) * 0.5
    return torch.where((a > 0) & (a64 < mid * mid), down, r)
