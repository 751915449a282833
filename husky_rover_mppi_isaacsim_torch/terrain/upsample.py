"""Catmull-Rom bicubic point sampling (a = -0.5, clamped 4x4 taps).

Counterpart of ``cubic_kernel`` and ``bicubic_point_sample`` in
``husky_rover_mppi_isaacsim_tpu/terrain/upsample.py``
(geometry_clipmaps_warp.py:211-279): what the small-scale terrain's base
noise resize needs. The separable ``upsample_bicubic`` is not ported.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

_A = -0.5


def cubic_kernel(x: np.ndarray, a: float = _A) -> np.ndarray:
    """Keys' cubic convolution kernel (PIL/OpenCV bicubic, a = -0.5)."""
    x = np.abs(x)
    return np.where(
        x <= 1.0,
        ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0,
        np.where(x < 2.0, (((x - 5.0) * x + 8.0) * x - 4.0) * a, 0.0),
    )


def _weights(frac: Tensor, offs: Tensor) -> Tensor:
    t = torch.abs(offs - frac)
    return torch.where(
        t <= 1.0,
        ((_A + 2.0) * t - (_A + 3.0)) * t * t + 1.0,
        torch.where(t < 2.0, (((t - 5.0) * t + 8.0) * t - 4.0) * _A, torch.zeros_like(t)),
    )


def bicubic_point_sample(z: Tensor, x: Tensor, y: Tensor) -> Tensor:
    """Catmull-Rom bicubic sample of ``z`` at fractional pixel coordinates;
    ``x`` indexes rows, ``y`` columns (reference axis convention). Taps
    outside the grid clamp to its edge."""
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    offs = torch.arange(-1, 3, device=z.device)
    wx = _weights((x - x0)[..., None], offs)  # (..., 4)
    wy = _weights((y - y0)[..., None], offs)
    xi = torch.clamp(x0[..., None] + offs, 0, z.shape[-2] - 1)
    yi = torch.clamp(y0[..., None] + offs, 0, z.shape[-1] - 1)
    patch = z[xi[..., :, None], yi[..., None, :]]  # (..., 4, 4)
    return torch.einsum("...i,...ij,...j->...", wx, patch, wy)
