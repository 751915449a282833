"""The bicubic upsample of a block (csrc/upsample_taps.cu): both axis passes
of :func:`..terrain.upsample.upsample_bicubic` for one output crop,
``upsample_bicubic(lr, factor)[r0:r0+R, c0:c0+C]``, row-major, in one
launch.

The port's own kernel, not a port of a TPU kernel: its counterpart is the
two dots of the JAX package's jitted ``upsample_bicubic``
(``husky_rover_mppi_isaacsim_tpu/terrain/upsample.py:36-58``), evaluated
as XLA's CPU code evaluates them. Its plain version is
:func:`..terrain.upsample.upsample_block_plain` (the two passes of
``_tap_sum``, then the slice).

On CPU tensors :data:`upsample_taps_cuda` runs the plain version and counts
no launch. On CUDA tensors it launches the kernel, or raises: ``lr`` a
float32 (n_r, n_c); the row pass's table ``(kw_r, idx_r)`` ((n_r·f, 4)
float32 weights, integer LR row indices) and the column pass's ``(kw_c,
idx_c)`` ((n_c·f, 4)), as :func:`..terrain.upsample.axis_tables` builds
them; a crop inside the upsample; one device. The two are ``torch.equal``.
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from . import cuda_build

_P = ctypes.c_void_p
_I = ctypes.c_int


def _aligned(t: Tensor) -> Tensor:
    """``t`` contiguous at a 16-byte boundary (the kernel's vector loads)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


class CudaUpsampleBlock:
    """Callable block upsample wrapper. ``launches`` counts kernel launches
    and nothing else; the library is built at the first CUDA call."""

    source = "upsample_taps.cu"

    def __init__(self):
        self.launches = 0
        self.built: cuda_build.BuiltLibrary | None = None

    def load(self) -> cuda_build.BuiltLibrary:
        if self.built is None:
            built = cuda_build.build(self.source)
            fn = built.lib.upsample_block_f32
            fn.argtypes = [_P, _I, _P, _P, _I, _P, _P, _I, _I, _I, _I, _P, _P]
            fn.restype = _I
            built.lib.upsample_block_floor.argtypes = [_I, _I, _P]
            built.lib.upsample_block_floor.restype = _I
            self.built = built
        return self.built

    def __call__(self, lr: Tensor, rows: tuple, cols: tuple, start: tuple,
                 size: tuple) -> Tensor:
        """``(R, C)`` contiguous: the upsample of ``lr`` by the tables
        ``rows`` (the leading axis's) and ``cols``, cropped to ``size`` at
        ``start``."""
        (kw_r, idx_r), (kw_c, idx_c) = rows, cols
        (r0, c0), (n_rows, n_cols) = start, size
        if not lr.is_cuda:
            from ..terrain.upsample import upsample_block_plain

            return upsample_block_plain(lr, rows, cols, start, size)
        if lr.dtype != torch.float32 or kw_r.dtype != torch.float32 or kw_c.dtype != torch.float32:
            raise TypeError("the block upsample takes a float32 patch and float32 weights")
        if (lr.ndim != 2 or any(kw.ndim != 2 or kw.shape[1] != 4 or ix.shape != kw.shape
                                or ix.dtype.is_floating_point
                                for kw, ix in ((kw_r, idx_r), (kw_c, idx_c)))):
            raise ValueError(f"the block upsample takes an (n_r, n_c) patch and (m, 4) weights "
                             f"and integer indices, got {tuple(lr.shape)}, {tuple(kw_r.shape)}, "
                             f"{tuple(idx_r.shape)}, {tuple(kw_c.shape)}, {tuple(idx_c.shape)}")
        if len({lr.device, kw_r.device, idx_r.device, kw_c.device, idx_c.device}) != 1:
            raise ValueError("the block upsample's inputs lie on different devices")
        if not (0 <= r0 and 0 < n_rows and r0 + n_rows <= kw_r.shape[0]
                and 0 <= c0 and 0 < n_cols and c0 + n_cols <= kw_c.shape[0]):
            raise ValueError(f"the crop {tuple(size)} at {tuple(start)} leaves the "
                             f"{kw_r.shape[0]} x {kw_c.shape[0]} upsample")
        if kw_r.shape[0] % lr.shape[0] or kw_c.shape[0] != kw_r.shape[0] // lr.shape[0] * lr.shape[1]:
            raise ValueError("the tables do not upsample the patch by one integer factor")
        out = torch.empty((n_rows, n_cols), dtype=torch.float32, device=lr.device)
        with torch.cuda.device(lr.device):
            self.launch(lr.contiguous(), (_aligned(kw_r), _aligned(idx_r.to(torch.int32))),
                        (_aligned(kw_c), _aligned(idx_c.to(torch.int32))), (r0, c0), out)
        return out

    def launch(self, lr: Tensor, rows: tuple, cols: tuple, start: tuple, out: Tensor) -> None:
        """Launch on the current stream, no checks: contiguous ``lr`` (n_r,
        n_c) float32, 16-byte aligned tables (float32 weights, int32
        indices) and ``out`` (R, C) float32, the crop at ``start``, on one
        card."""
        (kw_r, idx_r), (kw_c, idx_c) = rows, cols
        rc = self.load().lib.upsample_block_f32(
            lr.data_ptr(), lr.shape[1], kw_r.data_ptr(), idx_r.data_ptr(), kw_r.shape[0],
            kw_c.data_ptr(), idx_c.data_ptr(), start[0], start[1], out.shape[0], out.shape[1],
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"upsample_block_f32 launch failed: cudaError {rc}")
        self.launches += 1

    def launch_floor(self, size: tuple) -> None:
        """Launch the empty kernel of the grid and block of a ``size`` crop
        on the current stream: the launch floor the kernel's time is held
        against. Not a launch of the kernel: it is not counted."""
        rc = self.load().lib.upsample_block_floor(size[0], size[1],
                                                  torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"upsample_block_floor launch failed: cudaError {rc}")


upsample_taps_cuda = CudaUpsampleBlock()
