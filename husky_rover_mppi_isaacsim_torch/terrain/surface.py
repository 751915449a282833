"""Analytic and imported lunar surfaces for the MPPI stack.

Counterpart of ``husky_rover_mppi_isaacsim_tpu/terrain/surface.py``:
``bump_surface``, ``crater_surface`` and ``STANDALONE_CRATER_BUMPS``
(displacement_on_surface.py:48-79, MPPI_isaac.py:307-356), and
``imported_surface`` (a window of a DEM ``.npy``, MPPI_isaac.py:283-305)
with ``surface_heightfield``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from ..core import xla_math
from ..core.heightfield import HeightField


def _meshgrid(grid_size: int, half_width: float, dtype, device):
    x = xla_math.xla_linspace(-half_width, half_width, grid_size, dtype, device=device)
    return torch.meshgrid(x, x, indexing="xy")


def _scalar(v: float, like: Tensor) -> Tensor:
    """``v`` as a 0-d tensor of ``like``'s dtype: a division by it stays a
    division on every device (the card turns one by a Python float into a
    multiply by its reciprocal)."""
    return torch.tensor(v, dtype=like.dtype, device=like.device)


def bump_surface(grid_size: int, half_width: float, bumps, with_ramp: bool = True,
                 dtype=torch.float32, device=None) -> Tensor:
    """Sum of Gaussian hills, optional ``0.85*arctan(0.5x)`` ramp. In
    float32 each operation is rounded as the JAX package's eager ops are,
    with XLA's ``exp`` and ``atan2f(x, 1)``: the same bits."""
    X, Y = _meshgrid(grid_size, half_width, dtype, device)
    Z = torch.zeros_like(X)
    for (cx, cy), height, width in bumps:
        dx, dy = X - cx, Y - cy
        Z = Z + height * xla_math.xla_exp(-(dx * dx + dy * dy) / _scalar(2.0 * width**2, X))
    if with_ramp:
        Z = Z + 0.85 * xla_math.xla_atan(0.5 * X)
    return Z


def crater_surface(grid_size: int, half_width: float, bumps,
                   dtype=torch.float32, device=None) -> Tensor:
    """Crater-like double Gaussians: a broad rim minus a narrow bowl
    (MPPI_isaac.py:318-320). In float32 each operation is rounded as the
    JAX package's eager ops are, with XLA's ``exp``: the same bits."""
    X, Y = _meshgrid(grid_size, half_width, dtype, device)
    Z = torch.zeros_like(X)
    for (cx, cy), height, width in bumps:
        dx, dy = X - cx, Y - cy
        r2 = dx * dx + dy * dy
        Z = Z + (height - 0.5) * xla_math.xla_exp(-r2 / _scalar(2.0 * width**2, X))
        Z = Z - (height + 0.5) * xla_math.xla_exp(-r2 / _scalar(2.0 * (width / 2.0) ** 2, X))
    return Z


def imported_surface(path, start: int = 1000, end: int = 2500) -> np.ndarray:
    """A DEM window from ``.npy`` (MPPI_isaac.py:283-305: rows and columns
    ``[start:end]`` of a 0.1 m/px LOLA-derived array, 1000:2500 for the
    150 m ``test_nathan`` map); a file no larger than the window is that
    window already. Returns the numpy array as stored."""
    z = np.load(path)
    if z.shape[0] > end - start:
        z = z[start:end, start:end]
    return z


def surface_heightfield(z, half_width: float, dtype=None, device=None) -> HeightField:
    """Wrap a height array in the controller's :class:`HeightField` window,
    on ``device`` (where ``z`` lies when not given)."""
    return HeightField.create(z, half_width, dtype=dtype, device=device)


# Crater bumps of the standalone 150 m experiments (MPPI_OO_current.py:753-763),
# the JAX package's list.
STANDALONE_CRATER_BUMPS = [
    ((-2.7, -19.0), 3.4, 12.23),
    ((-0.57, -0.05), 4.39, 11.52),
    ((-48.56, 12.78), 3.6, 12.4),
    ((-27.89, 38.56), 4.0, 12.7),
    ((-50.12, 19.34), 3.7, 13.0),
    ((20.45, -48.78), 4.4, 12.9),
    ((-20.67, -40.12), 4.2, 12.9),
    ((42.78, 21.56), 4.5, 12.7),
    ((-36.12, -33.34), 3.9, 13.0),
]
