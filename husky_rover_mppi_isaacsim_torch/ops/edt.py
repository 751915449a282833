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
"""

from __future__ import annotations

import torch
from torch import Tensor

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
    """Exact L2 EDT (pixels)."""
    return torch.sqrt(edt_exact_sq(occupied))


def normalize_minmax(d: Tensor) -> Tensor:
    """cv2.NORM_MINMAX over the whole array; a constant array gives zeros."""
    lo = torch.amin(d)
    rng = torch.amax(d) - lo
    ok = rng > 0
    return torch.where(ok, (d - lo) / torch.where(ok, rng, torch.ones_like(rng)),
                       torch.zeros_like(d))


def distance_costmap(occupied: Tensor, falloff_power: float = 20.0) -> Tensor:
    """Obstacle costmap: exact EDT, min-max normalize, ``(1 - d)^p``
    (MPPI_isaac.py:374-377). An obstacle-free map gives a zero costmap."""
    cost = (1.0 - normalize_minmax(edt_exact(occupied))) ** falloff_power
    return torch.where(torch.any(occupied), cost, torch.zeros_like(cost))
