"""Exact Euclidean distance transform for costmap construction.

Counterpart of ``edt_exact_sq``, ``edt_exact``, ``normalize_minmax`` and
``distance_costmap`` in ``husky_rover_mppi_isaacsim_tpu/ops/edt.py``: exact
1D row distances by two cummin passes (stage 1, plain torch on every
device), then the column lower envelope
``D2[y, x] = min_y' (y - y')^2 + g2[y', x]`` (stage 2). All in float32 with
the ``_BIG`` sentinel held in float32; squared distances of a map with
obstacles are integers, exact in float32.

Stage 2 follows the device: :func:`edt_exact_sq` sends CUDA tensors through
kernel K2 (:mod:`.edt_cuda`) and CPU tensors through the plain row blocks of
:func:`minplus_envelope`. :func:`edt_exact_sq_plain` runs the plain blocks on
either device, for the comparisons with K2.

:func:`chamfer5` is the host numpy copy of the JAX package's cv2-compatible
5x5 chamfer transform, the distance of :func:`..terrain.costmap.reference_costmap`.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from ..core import xla_math

_BIG = 1e12
_ROW_BLOCK = 64  # envelope rows per pass: bounds the (block, rows, cols) broadcast


def _row_distances(occupied: Tensor) -> Tensor:
    """Per-row distance (pixels, along the last axis) to the nearest occupied
    cell: ``fwd[j] = j + cummin(d0[k] - k)``, ``bwd`` the same reversed."""
    width = occupied.shape[-1]
    col = torch.arange(width, dtype=torch.float32, device=occupied.device)
    d0 = torch.where(occupied, 0.0, _BIG).to(torch.float32)
    fwd = col + torch.cummin(d0 - col, dim=-1).values
    bwd = -col + torch.cummin((d0 + col).flip(-1), dim=-1).values.flip(-1)
    return torch.minimum(fwd, bwd)


def row_distances_sq(occupied: Tensor) -> Tensor:
    """Stage 1: squared per-row distances, clamped to the ``_BIG`` sentinel."""
    g = _row_distances(occupied)
    return torch.clamp(g * g, max=_BIG)


def minplus_envelope(g2: Tensor) -> Tensor:
    """Stage 2 in plain torch, the plain version of kernel K2:
    ``min_y' (y - y')^2 + g2[y', x]`` over ``_ROW_BLOCK``-row blocks."""
    rows = g2.shape[-2]
    ys = torch.arange(rows, dtype=torch.float32, device=g2.device)
    out = []
    for y0 in range(0, rows, _ROW_BLOCK):
        off = (ys[y0:y0 + _ROW_BLOCK, None] - ys[None, :]) ** 2   # (b, rows)
        out.append(torch.amin(off[:, :, None] + g2[None, :, :], dim=1))
    return torch.cat(out, dim=0)


def edt_exact_sq_plain(occupied: Tensor) -> Tensor:
    """Exact squared L2 EDT of a boolean grid (True = obstacle), in pixels^2,
    with the plain envelope on the grid's device."""
    return minplus_envelope(row_distances_sq(occupied))


def edt_exact_sq(occupied: Tensor) -> Tensor:
    """Exact squared L2 EDT of a boolean grid (True = obstacle), in pixels^2:
    K2 on a CUDA grid, the plain envelope on a CPU grid."""
    from .edt_cuda import edt_minplus_cuda  # edt_cuda imports this module

    return edt_minplus_cuda(row_distances_sq(occupied))


def edt_exact(occupied: Tensor) -> Tensor:
    """Exact L2 EDT (pixels), correctly rounded on every device."""
    return xla_math.sqrt_f32(edt_exact_sq(occupied))


def normalize_minmax(d: Tensor) -> Tensor:
    """cv2.NORM_MINMAX over the whole array; a constant array gives zeros.
    ``(d - min) / (max - min)``, each operation rounded once, as in the JAX
    package's eager ops."""
    lo = torch.amin(d)
    rng = torch.amax(d) - lo
    ok = rng > 0
    return torch.where(ok, (d - lo) / torch.where(ok, rng, torch.ones_like(rng)),
                       torch.zeros_like(d))


def distance_costmap(occupied: Tensor, falloff_power: float = 20.0) -> Tensor:
    """Obstacle costmap: exact EDT, min-max normalize, ``(1 - d)^p``
    (MPPI_isaac.py:374-377). An obstacle-free map gives a zero costmap. The
    JAX package's bits: its correctly rounded square root and glibc's
    ``powf``, which XLA calls for ``** p`` (:mod:`..core.xla_math`)."""
    cost = xla_math.pow_f32(1.0 - normalize_minmax(edt_exact(occupied)), falloff_power)
    return torch.where(torch.any(occupied), cost, torch.zeros_like(cost))


# OpenCV's 5x5 DIST_L2 chamfer weights (a, b, c), and the forward mask: every
# neighbour strictly before its pixel in raster order, as (dy, dx, weight)
_CHAMFER_A, _CHAMFER_B, _CHAMFER_C = 1.0, 1.4, 2.1969
_CHAMFER_FWD = ((-1, -1, _CHAMFER_B), (-1, 0, _CHAMFER_A), (-1, 1, _CHAMFER_B),
                (0, -1, _CHAMFER_A), (-2, -1, _CHAMFER_C), (-2, 1, _CHAMFER_C),
                (-1, -2, _CHAMFER_C), (-1, 2, _CHAMFER_C))


def chamfer5(binary_free: np.ndarray) -> np.ndarray:
    """5x5 chamfer distance transform of an image (0 = obstacle, nonzero =
    free), float32 pixels: the two-pass raster scan of the JAX package's
    ``_chamfer5_numpy`` with OpenCV's DIST_L2 weights (1.0, 1.4, 2.1969),
    which matches ``cv2.distanceTransform(img, DIST_L2, 5)`` to 1e-3.

    Host numpy, one route: no cv2 and no native library. Every forward-mask
    neighbour of pixel (y, x) lies at a smaller ``t = 3y + x``, so the
    pixels of one constant ``t`` (a wavefront) depend only on earlier
    wavefronts and update as one vector operation; the backward pass walks
    ``t`` down with the mask mirrored. Each pixel takes the min over the
    same eight float32 sums as in the sequential scan, and min is exact, so
    the result is bit-equal to it."""
    h, w = binary_free.shape
    big = np.float32(1e9)
    pad = 2
    dp = np.pad(np.where(binary_free == 0, np.float32(0), big).astype(np.float32), pad,
                constant_values=big)
    flat = dp.reshape(-1)  # a view: writes land in dp
    stride = w + 2 * pad
    ys, xs = np.mgrid[0:h, 0:w]
    t = (3 * ys + xs).ravel()
    order = np.argsort(t, kind="stable")
    pixels = ((ys + pad) * stride + xs + pad).ravel()[order]
    bounds = np.concatenate([[0], np.cumsum(np.bincount(t))])
    waves = [pixels[bounds[i]:bounds[i + 1]] for i in range(len(bounds) - 1)]
    for sign, sweep in ((1, waves), (-1, waves[::-1])):
        offsets = [(sign * (dy * stride + dx), wgt) for dy, dx, wgt in _CHAMFER_FWD]
        for idx in sweep:
            v = flat[idx]
            for off, wgt in offsets:
                v = np.minimum(v, flat[idx + off] + wgt)
            flat[idx] = v
    return dp[pad:-pad, pad:-pad]
