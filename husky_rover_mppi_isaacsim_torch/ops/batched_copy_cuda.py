"""Wrapper of the batched copy kernel (csrc/batched_copy.cu): many tensor
copies ``dst.copy_(src)`` in one launch on the current stream.

No TPU kernel stands behind it. :class:`..core.graphs.Graphed` fills a
graph's static inputs with it between replays (one launch in place of one
``copy_`` a tensor), from the records its copy plan packs.

A copy is a record of the kernel's parameter (:func:`row`): the
destination's and the source's addresses, the elements, the element's
bytes, and the walk: the destination's dims in its own memory order, dims
of size 1 dropped and neighbours merged where the source allows, with the
source's sizes and strides along it (at most :data:`MAX_RANK`). The
destination has to be dense (it is written contiguously along the walk);
the source may be strided, of a real or boolean dtype (:data:`DTYPES`,
copied as its bytes). The records reach the kernel as its parameter:
nothing is uploaded, and a launch call of more than :data:`CAPACITY`
copies is several launches. The caller keeps a source clear of every
destination, where the copies' order would matter.
"""

from __future__ import annotations

import ctypes
import struct

import torch
from torch import Tensor

from . import cuda_build

MAX_RANK = 4
CAPACITY = 48       # copies a launch takes (the kernel's kCapacity)
# what the kernel copies as bytes: no complex dtype (a conjugate view's bit
# is not in its bytes) and no quantized one
DTYPES = frozenset((torch.float64, torch.float32, torch.float16, torch.bfloat16, torch.int64,
                    torch.int32, torch.int16, torch.int8, torch.uint8, torch.bool,
                    *(getattr(torch, f"uint{b}") for b in (16, 32, 64) if hasattr(torch, f"uint{b}"))))
# the kernel's Copy: dst, src, numel, esize, rank, size[4] (int32), stride[4]
RECORD = struct.Struct(f"<qqqii{MAX_RANK}i{MAX_RANK}q")
_SOURCE = struct.Struct("<q")  # the record's source address, after the destination's
_INT32 = 2 ** 31

_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def current_stream(device_index: int) -> int:
    """The current stream of a card, as the handle a launch takes."""
    if _raw_stream is not None:
        return _raw_stream(device_index)
    return torch.cuda.current_stream(device_index).cuda_stream


def walk(dst: Tensor, src: Tensor) -> tuple[list, list] | None:
    """The sizes of ``dst``'s dims in its memory order (dims of size 1
    dropped, neighbours merged where ``src``'s strides allow) and
    ``src``'s strides along them; ``None`` if ``dst`` is not dense or a
    size is beyond int32. ``dst`` and ``src`` have one shape."""
    shape, ds, ss = dst.shape, dst.stride(), src.stride()
    dims = sorted((d for d in range(dst.dim()) if shape[d] != 1), key=lambda d: -ds[d])
    expect = 1
    for d in reversed(dims):
        if ds[d] != expect:
            return None
        expect *= shape[d]
    sizes, strides = [], []
    for d in dims:
        if sizes and strides[-1] == ss[d] * shape[d]:
            sizes[-1] *= shape[d]
            strides[-1] = ss[d]
        else:
            sizes.append(shape[d])
            strides.append(ss[d])
    if not sizes:
        return [1], [1]
    if max(sizes) >= _INT32:
        return None
    return sizes, strides


def takes(src: Tensor) -> bool:
    """Whether the kernel copies from ``src``: a strided tensor of at most
    :data:`MAX_RANK` dims and one of :data:`DTYPES`."""
    return src.layout is torch.strided and src.dim() <= MAX_RANK and src.dtype in DTYPES


def row(dst: Tensor, src: Tensor) -> bytes | None:
    """The kernel's record of ``dst.copy_(src)`` (module docstring), or
    ``None`` where ``dst`` is not dense (:func:`walk`). ``src`` is one the
    kernel takes (:func:`takes`), of ``dst``'s shape and dtype."""
    w = walk(dst, src)
    if w is None:
        return None
    sizes, strides = w
    pad = MAX_RANK - len(sizes)
    return RECORD.pack(dst.data_ptr(), src.data_ptr(), src.numel(), src.element_size(),
                       len(sizes), *sizes, *[1] * pad, *strides, *[0] * pad)


def set_source(rows: bytearray, at: int, src: Tensor) -> None:
    """Point the record at byte ``at`` of ``rows`` (:func:`row`) at
    ``src``, a source of the same shape, dtype and strides as the one it
    was made for."""
    _SOURCE.pack_into(rows, at + 8, src.data_ptr())


def extent(t: Tensor) -> tuple[int, int] | None:
    """The bytes ``[start, end)`` a strided tensor's elements lie in, or
    ``None`` for a tensor of no element."""
    if t.numel() == 0:
        return None
    start = t.data_ptr()
    return start, start + t.element_size() * (1 + sum((n - 1) * s for n, s in
                                                      zip(t.shape, t.stride())))


class CudaBatchedCopy:
    """The kernel's launches (module docstring). ``launches`` counts kernel
    launches and nothing else; the library is built at the first
    launch."""

    source = "batched_copy.cu"

    def __init__(self):
        self.launches = 0
        self.built: cuda_build.BuiltLibrary | None = None

    def load(self) -> cuda_build.BuiltLibrary:
        if self.built is None:
            built = cuda_build.build(self.source)
            p, n = ctypes.c_void_p, ctypes.c_int
            lib = built.lib
            lib.batched_copy.argtypes = [ctypes.c_char_p, n, n, p]
            lib.batched_copy.restype = n
            lib.batched_copy_blocks.argtypes = [ctypes.c_char_p, n]
            lib.batched_copy_blocks.restype = n
            lib.batched_copy_floor.argtypes = [n, p]
            lib.batched_copy_floor.restype = n
            lib.batched_copy_capacity.argtypes = []
            lib.batched_copy_capacity.restype = n
            if lib.batched_copy_capacity() != CAPACITY:
                raise RuntimeError(f"{self.source} takes {lib.batched_copy_capacity()} copies "
                                   f"a launch, the wrapper packs {CAPACITY}")
            self.built = built
        return self.built

    def launch(self, rows: bytes, n: int, device_index: int) -> None:
        """Launch the copies of ``n`` packed records (:func:`row`) on the
        card's current stream."""
        rc = self.load().lib.batched_copy(rows, n, device_index, current_stream(device_index))
        if rc < 0:
            raise RuntimeError(f"batched_copy launch failed: cudaError {-rc}")
        self.launches += rc

    def blocks(self, rows: bytes, n: int) -> int:
        """The grid of the first launch of ``n`` packed records."""
        return self.load().lib.batched_copy_blocks(rows, n)

    def launch_floor(self, blocks: int, device_index: int) -> None:
        """Launch the empty kernel of a batch's grid (``blocks``) and block
        on the card's current stream: the launch floor the batch's time is
        held against. Not a launch of the copy: it is not counted."""
        rc = self.load().lib.batched_copy_floor(blocks, current_stream(device_index))
        if rc != 0:
            raise RuntimeError(f"batched_copy_floor launch failed: cudaError {rc}")


batched_copy = CudaBatchedCopy()
