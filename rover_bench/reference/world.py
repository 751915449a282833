"""The plain reference of the world: the thesis crater DEM and the obstacle
costmap of the thesis map's 750 obstacles.

Both are worked out in float64 from the formulas of the source
(MPPI_isaac.py:307-377, MPPI_OO_current.py:722-726), with the exact
separable Euclidean distance transform; the port computes them in float32,
so they are compared by a gap, and the reference's loops run on these.
Nothing here imports the port.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor


def crater_surface(grid_size: int, half_width: float, bumps, device=None) -> Tensor:
    """The crater-like double Gaussians (MPPI_isaac.py:318-320) in float64:
    ``sum (h - 0.5) exp(-r^2 / 2w^2) - (h + 0.5) exp(-r^2 / 2(w/2)^2)`` over a
    ``grid_size``^2 mesh of ``[-half_width, half_width]``, row = y."""
    x = torch.linspace(-half_width, half_width, grid_size, dtype=torch.float64, device=device)
    X, Y = torch.meshgrid(x, x, indexing="xy")
    Z = torch.zeros_like(X)
    for (cx, cy), height, width in bumps:
        r2 = (X - cx) ** 2 + (Y - cy) ** 2
        Z = Z + (height - 0.5) * torch.exp(-r2 / (2.0 * width ** 2))
        Z = Z - (height + 0.5) * torch.exp(-r2 / (2.0 * (width / 2.0) ** 2))
    return Z


def obstacles(num: int, seed: int, extent: float, r_max: float) -> np.ndarray:
    """The deterministic obstacle field (MPPI_OO_current.py:722-726): x, y,
    r per obstacle from ``RandomState(seed)``."""
    rng = np.random.RandomState(seed)
    out = np.empty((num, 3))
    for i in range(num):
        out[i, 0] = rng.uniform(-extent, extent)
        out[i, 1] = rng.uniform(-extent, extent)
        out[i, 2] = rng.uniform(0.0, r_max)
    return out


def occupancy(obs: np.ndarray, half_width: float, size: int, robot_radius: float,
              origin=(0.0, 0.0), margin: float = 0.1) -> np.ndarray:
    """Boolean obstacle image (True = obstacle) in the reference's swapped
    local frame ``x_local = y - y0``, ``y_local = x - x0``
    (MPPI_isaac.py:361-372): a cell is an obstacle within ``r/2 +
    robot_radius + margin`` of an obstacle's centre."""
    lin = np.linspace(-half_width, half_width, size)
    x0, y0 = origin
    occ = np.zeros((size, size), dtype=bool)
    for xg, yg, r in obs:
        xl, yl = yg - y0, xg - x0
        rad = r / 2.0 + robot_radius + margin
        cols = np.flatnonzero(np.abs(lin - xl) <= rad)
        rows = np.flatnonzero(np.abs(lin - yl) <= rad)
        if cols.size == 0 or rows.size == 0:
            continue
        m = (lin[cols][None, :] - xl) ** 2 + (lin[rows][:, None] - yl) ** 2 <= rad ** 2
        occ[np.ix_(rows, cols)] |= m
    return occ


def edt(occupied: Tensor, block: int = 32) -> Tensor:
    """Exact Euclidean distance (pixels) to the nearest obstacle, float64:
    the row distances by two running minima, then for every pixel the
    least ``(y - y')^2 + g(y', x)^2`` over all rows ``y'``."""
    occ = occupied.to(torch.bool)
    rows, cols = occ.shape
    col = torch.arange(cols, dtype=torch.float64, device=occ.device)
    big = torch.full_like(col, 1e18)
    d0 = torch.where(occ, torch.zeros_like(col), big)
    fwd = col + torch.cummin(d0 - col, dim=-1).values
    bwd = -col + torch.cummin((d0 + col).flip(-1), dim=-1).values.flip(-1)
    g2 = torch.clamp(torch.minimum(fwd, bwd), max=1e9) ** 2
    ys = torch.arange(rows, dtype=torch.float64, device=occ.device)
    out = []
    for y0 in range(0, rows, block):
        off = (ys[y0:y0 + block, None] - ys[None, :]) ** 2
        out.append(torch.amin(off[:, :, None] + g2[None], dim=1))
    return torch.sqrt(torch.cat(out))


def costmap(occupied: np.ndarray, falloff_power: float, device=None) -> Tensor:
    """``(1 - minmax(edt))^p`` in float64 (MPPI_isaac.py:374-377); a map
    with no obstacle is all zero."""
    occ = torch.as_tensor(occupied, device=device)
    if not bool(occ.any()):
        return torch.zeros(occ.shape, dtype=torch.float64, device=device)
    d = edt(occ)
    d = (d - d.min()) / (d.max() - d.min())
    return (1.0 - d) ** falloff_power
