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
rounded twice in float64; on the card both passes of a block are one
kernel, :mod:`..ops.upsample_cuda`, which computes only the crop a caller
keeps: :func:`upsample_block`).
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


_TABLES: dict = {}


def axis_tables(n: int, factor: int, dtype, device) -> tuple[Tensor, Tensor]:
    """One axis pass's table for ``n`` source rows: the Catmull-Rom weights
    ``(n·factor, 4)`` in ``dtype`` (formed in float64, normalized, then
    rounded) and the clamped source row indices ``(n·factor, 4)`` int32.
    Built once per ``(n, factor, dtype, device)`` and kept: the same tensors
    for the same key."""
    key = (n, factor, dtype, torch.device(device))
    hit = _TABLES.get(key)
    if hit is None:
        src = (np.arange(n * factor) + 0.5) / factor - 0.5
        i0 = np.floor(src).astype(np.int64)
        offs = np.arange(-1, 3)
        kw = cubic_kernel(offs[None, :] - (src - i0)[:, None])
        kw = torch.as_tensor(kw / kw.sum(axis=1, keepdims=True), dtype=dtype, device=device)
        idx = torch.as_tensor(np.clip(i0[:, None] + offs[None, :], 0, n - 1).astype(np.int32),
                              device=device)
        hit = _TABLES.setdefault(key, (kw, idx))
    return hit


def _axis_pass(img: Tensor, table: tuple) -> Tensor:
    """Upsample the leading axis of ``img`` by the table's four taps a row."""
    kw, idx = table
    idx = idx.long()
    return _tap_sum(kw, [img[idx[:, f]] for f in range(4)])


def upsample_block_plain(lr: Tensor, rows: tuple, cols: tuple, start: tuple,
                         size: tuple) -> Tensor:
    """The block upsample's plain version: both axis passes in full (rows by
    the table ``rows``, then columns by ``cols``, each :func:`_tap_sum`),
    then the crop of ``size`` at ``start``, contiguous."""
    (r0, c0), (n_rows, n_cols) = start, size
    full = _axis_pass(_axis_pass(lr, rows).T.contiguous(), cols).T
    return full[r0:r0 + n_rows, c0:c0 + n_cols].contiguous()


def upsample_block(lr: Tensor, factor: int, start: tuple = (0, 0),
                   size: tuple | None = None) -> Tensor:
    """``upsample_bicubic(lr, factor)[r0:r0+R, c0:c0+C]`` for ``start = (r0,
    c0)`` and ``size = (R, C)`` (default: the rest of the upsample),
    contiguous. On the card one launch of the block kernel
    (:mod:`..ops.upsample_cuda`, float32), which computes the crop alone; on
    the CPU its plain version :func:`upsample_block_plain`. The same bits
    either way, and in float32 the JAX package's."""
    n_r, n_c = lr.shape
    if size is None:
        size = (n_r * factor - start[0], n_c * factor - start[1])
    if not (factor >= 1 and all(0 <= s0 and 0 < s and s0 + s <= n * factor
                                for s0, s, n in zip(start, size, (n_r, n_c)))):
        raise ValueError(f"the crop {tuple(size)} at {tuple(start)} leaves the "
                         f"{n_r * factor} x {n_c * factor} upsample (factor {factor})")
    rows = axis_tables(n_r, factor, lr.dtype, lr.device)
    cols = axis_tables(n_c, factor, lr.dtype, lr.device)
    return upsample_taps_cuda(lr, rows, cols, tuple(start), tuple(size))


def upsample_bicubic(lr: Tensor, factor: int) -> Tensor:
    """Upsample ``(H, W)`` by an integer factor with Catmull-Rom bicubic.

    Output pixel ``o`` samples source coordinate ``(o + 0.5)/f - 0.5``;
    edges clamp. Each axis pass gathers four taps per output row and
    contracts them with the row's weights (in the image's dtype) in a fixed
    order: :func:`upsample_block` with the crop set to everything (on the
    card one launch, float32). In float32 the JAX package's bits."""
    return upsample_block(lr, factor)


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
