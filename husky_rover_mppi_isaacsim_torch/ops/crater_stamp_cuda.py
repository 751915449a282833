"""The crater stamp kernel (csrc/crater_stamp.cu): every live slot's patch
added into a block raster at its placement, in slot order, in one launch.

The port's own kernel, not a port of a TPU kernel: the JAX package stamps a
block's craters inside one jitted program, a ``lax.scan`` of
``dynamic_update_slice`` adds over a tier padded to a fixed capacity
(``husky_rover_mppi_isaacsim_tpu/terrain/craters.py:269-294``). Its plain
version is :func:`..terrain.craters.stamp_patches`, one in-place slice add
per live slot.

On CPU tensors :data:`crater_stamp_cuda` runs the plain version and counts
no launch. On CUDA tensors it launches the kernel, or raises: a contiguous
float32 raster and patches, int32 placements inside the raster, a bool
mask, one device. The kernel adds the same float32 values to each pixel in
the same order as the plain version, so the two are bit-equal.
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from . import cuda_build


class CudaCraterStamp:
    """Callable stamp wrapper. ``launches`` counts kernel launches and
    nothing else; the library is built at the first CUDA call."""

    source = "crater_stamp.cu"

    def __init__(self):
        self.launches = 0
        self.built: cuda_build.BuiltLibrary | None = None

    def load(self) -> cuda_build.BuiltLibrary:
        if self.built is None:
            built = cuda_build.build(self.source)
            fn = built.lib.crater_stamp_f32
            p, n = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [p, n, n, p, p, p, p, n, n, p]
            fn.restype = n
            self.built = built
        return self.built

    def __call__(self, buf: Tensor, patches: Tensor, row0: Tensor, col0: Tensor,
                 mask: Tensor) -> Tensor:
        """Add ``patches[s]`` (``(slots, P, P)``) into ``buf`` (``(rows,
        cols)``) at ``(row0[s], col0[s])`` for every ``s`` with ``mask[s]``,
        in slot order, in place; returns ``buf``."""
        if buf.dtype != torch.float32 or patches.dtype != torch.float32:
            raise TypeError(f"the crater stamp takes float32 rasters and patches, got "
                            f"{buf.dtype}, {patches.dtype}")
        if row0.dtype != torch.int32 or col0.dtype != torch.int32 or mask.dtype != torch.bool:
            raise TypeError(f"the crater stamp takes int32 placements and a bool mask, got "
                            f"{row0.dtype}, {col0.dtype}, {mask.dtype}")
        slots = patches.shape[0]
        if (buf.ndim != 2 or patches.ndim != 3 or patches.shape[1] != patches.shape[2]
                or any(t.shape != (slots,) for t in (row0, col0, mask))):
            raise ValueError(f"the crater stamp takes a (rows, cols) raster, (slots, P, P) "
                             f"patches and (slots,) placements and mask, got "
                             f"{tuple(buf.shape)}, {tuple(patches.shape)}, {tuple(row0.shape)}, "
                             f"{tuple(col0.shape)}, {tuple(mask.shape)}")
        if len({t.device for t in (buf, patches, row0, col0, mask)}) != 1:
            raise ValueError("the crater stamp's inputs lie on different devices")
        if not buf.is_cuda:
            from ..terrain.craters import stamp_patches

            return stamp_patches(buf, patches, row0, col0, mask)
        if not buf.is_contiguous():
            raise ValueError("the crater stamp writes a contiguous raster in place")
        with torch.cuda.device(buf.device):
            self.launch(buf, patches.contiguous(), row0.contiguous(), col0.contiguous(),
                        mask.contiguous())
        return buf

    def launch(self, buf: Tensor, patches: Tensor, row0: Tensor, col0: Tensor,
               mask: Tensor) -> None:
        """Launch the stamp on the current stream: contiguous ``buf``
        (rows, cols) float32, ``patches`` (slots, P, P) float32, ``row0``,
        ``col0`` (slots,) int32 with every patch inside ``buf``, ``mask``
        (slots,) bool, all on the card."""
        rc = self.load().lib.crater_stamp_f32(
            buf.data_ptr(), buf.shape[0], buf.shape[1], patches.data_ptr(), row0.data_ptr(),
            col0.data_ptr(), mask.data_ptr(), patches.shape[0], patches.shape[1],
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"crater_stamp_f32 launch failed: cudaError {rc}")
        self.launches += 1


crater_stamp_cuda = CudaCraterStamp()
