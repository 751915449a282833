"""The bicubic upsample's 4-tap pass (csrc/upsample_taps.cu): one axis of
:func:`..terrain.upsample.upsample_bicubic`, ``out[r, c] = sum_f kw[r, f] *
img[idx[r, f], c]`` in one launch.

The port's own kernel, not a port of a TPU kernel: its counterpart is the
dot of the JAX package's jitted ``upsample_bicubic``
(``husky_rover_mppi_isaacsim_tpu/terrain/upsample.py:36-58``), evaluated
as XLA's CPU code evaluates it. Its plain version is
:func:`..terrain.upsample._tap_sum` on the gathered taps.

On CPU tensors :data:`upsample_taps_cuda` runs the plain version and counts
no launch. On CUDA tensors it launches the kernel, or raises: ``img`` a
contiguous float32 (n, m), ``kw`` (rows, 4) float32, ``idx`` (rows, 4)
integer row indices into ``img``, one device. The two are ``torch.equal``.
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from . import cuda_build

_P = ctypes.c_void_p
_I = ctypes.c_int


class CudaUpsampleTaps:
    """Callable 4-tap pass wrapper. ``launches`` counts kernel launches and
    nothing else; the library is built at the first CUDA call."""

    source = "upsample_taps.cu"

    def __init__(self):
        self.launches = 0
        self.built: cuda_build.BuiltLibrary | None = None

    def load(self) -> cuda_build.BuiltLibrary:
        if self.built is None:
            built = cuda_build.build(self.source)
            fn = built.lib.upsample_taps_f32
            fn.argtypes = [_P, _I, _P, _P, _I, _P, _P]
            fn.restype = _I
            self.built = built
        return self.built

    def __call__(self, img: Tensor, kw: Tensor, idx: Tensor) -> Tensor:
        """``(rows, m)``: the taps ``img[idx[:, f]]`` weighted by ``kw[:, f]``
        and summed in XLA's order (``_tap_sum``)."""
        from ..terrain.upsample import _tap_sum

        if not img.is_cuda:
            return _tap_sum(kw, [img[idx[:, f]] for f in range(4)])
        if img.dtype != torch.float32 or kw.dtype != torch.float32:
            raise TypeError("the 4-tap pass takes a float32 image and float32 weights")
        if (img.ndim != 2 or kw.ndim != 2 or kw.shape[1] != 4 or idx.shape != kw.shape
                or idx.dtype.is_floating_point):
            raise ValueError(f"the 4-tap pass takes an (n, m) image, (rows, 4) weights and "
                             f"(rows, 4) integer indices, got {tuple(img.shape)}, "
                             f"{tuple(kw.shape)}, {tuple(idx.shape)} {idx.dtype}")
        if len({img.device, kw.device, idx.device}) != 1:
            raise ValueError("the 4-tap pass's inputs lie on different devices")
        img = img.contiguous()
        kw = kw.contiguous() if kw.data_ptr() % 16 == 0 else kw.clone()  # float4 loads
        idx = idx.to(torch.int32).contiguous()
        if idx.data_ptr() % 16:
            idx = idx.clone()
        out = torch.empty((kw.shape[0], img.shape[1]), dtype=torch.float32, device=img.device)
        with torch.cuda.device(img.device):
            self.launch(img, kw, idx, out)
        return out

    def launch(self, img: Tensor, kw: Tensor, idx: Tensor, out: Tensor) -> None:
        """Launch on the current stream, no checks: contiguous ``img`` (n,
        m) float32, ``kw`` (rows, 4) float32, ``idx`` (rows, 4) int32 and
        ``out`` (rows, m) float32 on one card."""
        rc = self.load().lib.upsample_taps_f32(
            img.data_ptr(), img.shape[1], kw.data_ptr(), idx.data_ptr(), kw.shape[0],
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"upsample_taps_f32 launch failed: cudaError {rc}")
        self.launches += 1


upsample_taps_cuda = CudaUpsampleTaps()
