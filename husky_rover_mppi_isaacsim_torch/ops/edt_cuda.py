"""Wrapper of kernel K2, the hand-written CUDA min-plus envelope of the exact
squared EDT (csrc/edt_minplus.cu).

Replaces the Pallas TPU kernel ``husky_rover_mppi_isaacsim_tpu/ops/
edt_pallas.py::_minplus_kernel`` (reached through ``edt_minplus_pallas``).
Same contract as the plain :func:`.edt.minplus_envelope`: ``g2`` (R, C) of
per-row squared distances in, ``D2[y, x] = min_y' (y - y')^2 + g2[y', x]``
(R, C) out, bit-equal to the plain version.

On CPU tensors :data:`edt_minplus_cuda` runs the plain version. On CUDA
tensors it launches the kernel, or raises: float32, contiguous, one device,
at most :data:`MAX_ROWS` rows.
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from . import cuda_build
from .edt import minplus_envelope

_P = ctypes.c_void_p
_I = ctypes.c_int

# Offsets (y - y')^2 are exact in float32 while (R - 1)^2 < 2^24.
MAX_ROWS = 4096


class CudaMinPlus:
    """Callable K2 wrapper. ``launches`` counts kernel launches and nothing
    else; the library is built at the first CUDA call."""

    source = "edt_minplus.cu"

    def __init__(self):
        self.launches = 0
        self.built: cuda_build.BuiltLibrary | None = None

    def load(self) -> cuda_build.BuiltLibrary:
        if self.built is None:
            built = cuda_build.build(self.source)
            fn = built.lib.edt_minplus_f32
            fn.argtypes = [_P, _P, _I, _I, _P]
            fn.restype = _I
            self.built = built
        return self.built

    def __call__(self, g2: Tensor) -> Tensor:
        if not g2.is_cuda:
            return minplus_envelope(g2)
        out = torch.empty_like(g2)
        with torch.cuda.device(g2.device):
            self.launch(g2, out)
        return out

    def launch(self, g2: Tensor, out: Tensor) -> None:
        """Launch K2 on the current stream: ``g2`` and ``out`` contiguous
        (R, C) float32 on one card (see :func:`check_input`)."""
        check_input(g2)
        if out.shape != g2.shape or out.dtype != g2.dtype or out.device != g2.device:
            raise ValueError("out must match g2's shape, dtype and device")
        R, C = g2.shape
        rc = self.load().lib.edt_minplus_f32(
            g2.data_ptr(), out.data_ptr(), R, C, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"edt_minplus_f32 launch failed: cudaError {rc}")
        self.launches += 1


def check_input(g2: Tensor) -> None:
    """Raise unless K2 takes ``g2``: a contiguous (R, C) float32 tensor with
    R <= :data:`MAX_ROWS`. Reads no data, so it also runs on the CPU."""
    if g2.dtype != torch.float32:
        raise TypeError(f"the CUDA min-plus takes float32 only, got {g2.dtype}")
    if g2.ndim != 2:
        raise ValueError(f"g2 must be (R, C), got {tuple(g2.shape)}")
    if g2.shape[0] > MAX_ROWS:
        raise ValueError(f"{g2.shape[0]} rows: offsets are exact in float32 only up to "
                         f"{MAX_ROWS} rows")
    if not g2.is_contiguous():
        raise ValueError("g2 must be contiguous")


edt_minplus_cuda = CudaMinPlus()
