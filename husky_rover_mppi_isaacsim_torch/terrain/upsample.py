"""Bicubic LR -> HR DEM upsampling and the clipmap's point samplers.

Counterpart of ``husky_rover_mppi_isaacsim_tpu/terrain/upsample.py``:
:func:`upsample_bicubic` is the separable Catmull-Rom (a = -0.5) integer
upsample of the streamed blocks (PIL's pixel-center convention, edges
clamped; high_resolution_DEM_workers.py:107-196), and
:func:`bicubic_point_sample` / :func:`bilinear_point_sample` are the 4x4 and
2x2 samplers at fractional pixels (geometry_clipmaps_warp.py:180-279).

In float32 the upsample and the bicubic sampler give the JAX package's
bits: XLA's CPU code contracts the Catmull-Rom weights' ``a * b + c`` into
fused multiply-adds and emits each einsum as a column-major GEMV (per
output row, its columns in 8-wide tiles), whose order of products, sums
and FMAs is copied here (:func:`..core.xla_math.xla_fma`: fused in float32,
rounded twice in float64; on the card the upsample's pass is the 4-tap
kernel, :mod:`..ops.upsample_cuda`).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from ..core.xla_math import xla_fma
from ..ops.upsample_cuda import upsample_taps_cuda

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
    near = xla_fma(xla_fma(t, _A + 2.0, -(_A + 3.0)) * t, t, 1.0)
    far = xla_fma(xla_fma(t - 5.0, t, 8.0), t, -4.0) * _A
    return torch.where(t <= 1.0, near, torch.where(t < 2.0, far, torch.zeros_like(t)))


def bicubic_point_sample(z: Tensor, x: Tensor, y: Tensor) -> Tensor:
    """Catmull-Rom bicubic sample of ``z`` at fractional pixel coordinates;
    ``x`` indexes rows, ``y`` columns (reference axis convention). Taps
    outside the grid clamp to its edge. In float32 the JAX package's bits
    (module note): each row of the patch is contracted with the row weights
    by fused multiply-adds, then the four results with the column weights
    by plain products and sums, in tap order."""
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    offs = torch.arange(-1, 3, device=z.device).to(z.dtype)
    wx = _weights((x - x0.to(x.dtype))[..., None], offs)  # (..., 4)
    wy = _weights((y - y0.to(y.dtype))[..., None], offs)
    ioffs = torch.arange(-1, 3, device=z.device)
    xi = torch.clamp(x0[..., None] + ioffs, 0, z.shape[-2] - 1)
    yi = torch.clamp(y0[..., None] + ioffs, 0, z.shape[-1] - 1)
    patch = z[xi[..., :, None], yi[..., None, :]]  # (..., 4, 4)
    rows = wx[..., 0, None] * patch[..., 0, :]
    for i in range(1, 4):
        rows = xla_fma(wx[..., i, None], patch[..., i, :], rows)
    out = wy[..., 0] * rows[..., 0]
    for j in range(1, 4):
        out = out + wy[..., j] * rows[..., j]
    return out


def _tap_sum(kw: Tensor, taps: list) -> Tensor:
    """``sum_f kw[:, f] * taps[f]`` over the four taps of an axis pass, as
    XLA's CPU dot emits it for the output's ``m`` columns: the columns of
    its 8-wide tiles by fused multiply-adds from zero; the rest by fused
    multiply-adds from the first product, or, where one column is left, by
    plain products and sums."""
    w = [kw[:, f, None] for f in range(4)]
    m = taps[0].shape[1]
    main = 8 * (m // 8)
    parts = []
    if main:
        acc = xla_fma(w[0], taps[0][:, :main], 0.0)
        for f in range(1, 4):
            acc = xla_fma(w[f], taps[f][:, :main], acc)
        parts.append(acc)
    if m - main == 1:
        acc = w[0] * taps[0][:, main:]
        for f in range(1, 4):
            acc = acc + w[f] * taps[f][:, main:]
        parts.append(acc)
    elif m > main:
        acc = w[0] * taps[0][:, main:]
        for f in range(1, 4):
            acc = xla_fma(w[f], taps[f][:, main:], acc)
        parts.append(acc)
    return torch.cat(parts, dim=1) if len(parts) > 1 else parts[0]


def upsample_bicubic(lr: Tensor, factor: int) -> Tensor:
    """Upsample ``(H, W)`` by an integer factor with Catmull-Rom bicubic.

    Output pixel ``o`` samples source coordinate ``(o + 0.5)/f - 0.5``;
    edges clamp. Each axis pass gathers four taps per output row and
    contracts them with the row's weights (in the image's dtype) in a fixed
    order: on the card one launch of the 4-tap kernel
    (:mod:`..ops.upsample_cuda`, float32), on the CPU its plain version
    :func:`_tap_sum`; the same bits either way, and in float32 the JAX
    package's."""

    def axis_pass(img: Tensor) -> Tensor:  # upsample the leading axis
        n = img.shape[0]
        src = (np.arange(n * factor) + 0.5) / factor - 0.5
        i0 = np.floor(src).astype(np.int64)
        offs = np.arange(-1, 3)
        kw = cubic_kernel(offs[None, :] - (src - i0)[:, None])
        kw = torch.as_tensor(kw / kw.sum(axis=1, keepdims=True), dtype=img.dtype,
                             device=img.device)
        idx = torch.as_tensor(np.clip(i0[:, None] + offs[None, :], 0, n - 1), device=img.device)
        return upsample_taps_cuda(img, kw, idx)

    return axis_pass(axis_pass(lr).T.contiguous()).T


def _take2d(z: Tensor, rows: Tensor, cols: Tensor) -> Tensor:
    """``z[rows, cols]`` through ``torch.take`` on the flat index: 0-d index
    tensors would otherwise become Python ints, a host sync each."""
    return torch.take(z, rows * z.shape[-1] + cols)


def bilinear_point_sample(z: Tensor, x: Tensor, y: Tensor) -> Tensor:
    """2x2 bilinear sample of ``z`` at fractional pixel coordinates (the
    clipmap's fast path, geometry_clipmaps_warp.py:180-208); ``x`` indexes
    rows, ``y`` columns. Cells outside the grid clamp to its edge."""
    x0 = torch.floor(x).to(torch.int64)
    y0 = torch.floor(y).to(torch.int64)
    fx = x - x0
    fy = y - y0
    h, w = z.shape[-2], z.shape[-1]
    x1 = torch.clamp(x0 + 1, 0, h - 1)
    y1 = torch.clamp(y0 + 1, 0, w - 1)
    x0 = torch.clamp(x0, 0, h - 1)
    y0 = torch.clamp(y0, 0, w - 1)
    return (_take2d(z, x0, y0) * (1 - fx) * (1 - fy) + _take2d(z, x0, y1) * (1 - fx) * fy
            + _take2d(z, x1, y0) * fx * (1 - fy) + _take2d(z, x1, y1) * fx * fy)
