"""The crater block kernel (csrc/crater_block.cu): every live crater of a
radius tier rendered and added into a guarded block raster, in slot order,
in one launch, with no patch tensor on the card.

The port's own kernel, not a port of a TPU kernel: its counterpart is the
JAX package's one jitted block program
(``husky_rover_mppi_isaacsim_tpu/terrain/craters.py:227-296``, a
``lax.scan`` that renders each chunk's patches and scans
``dynamic_update_slice`` adds). Its plain version is
:func:`..terrain.craters.crater_block_plain`: every slot rendered as a
``(P, P)`` patch (``_render_patches``), the live ones added by
``stamp_patches``, one slice add each.

On CPU tensors :data:`crater_block_cuda` runs the plain version and counts
no launch. On CUDA tensors it launches the kernel, or raises: a contiguous
square float32 raster, the field's float32 / int32 / bool columns, int32
placements inside the raster, float32 profile tables of 256 columns, the
tile lists of :func:`tile_bins`, one device. The kernel adds each pixel's
heights in the plain version's order with its float32 arithmetic, glibc's
and XLA's functions included (``csrc/xla_math.cuh``, the device copies of
:mod:`..core.xla_math`), so the two are ``torch.equal``, and both are the
JAX package's bits.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

from . import cuda_build
from ..terrain.craters import ATAN2_UNFUSED_MAX_PX

TILE_PX = 32  # the kernel's tile side (csrc/crater_block.cu kTile)
TABLE_SIZE = 256  # terrain/craters.py TABLE_SIZE


class TileBins(NamedTuple):
    """The live slots binned by raster tile: tile ``tile_ids[t]`` (row-major
    over ``ceil(side / TILE_PX)`` columns) holds the slots
    ``slots[start[t]:start[t + 1]]``, in slot order. int32 arrays."""

    tile_ids: np.ndarray | Tensor  # (tiles,)
    start: np.ndarray | Tensor     # (tiles + 1,)
    slots: np.ndarray | Tensor     # (entries,)


def half_px(radius: np.ndarray, resolution: float) -> np.ndarray:
    """Each crater's half-width in pixels as ``_render_patches`` computes it
    (``floor(radius / resolution)`` in float32, a true division), int64."""
    r = np.asarray(radius, np.float32)
    return np.floor(r / np.float32(resolution)).astype(np.int64)


def tile_bins(row0: np.ndarray, col0: np.ndarray, radius: np.ndarray, mask: np.ndarray,
              resolution: float, patch_px: int, side: int) -> TileBins:
    """Bin the live slots by ``TILE_PX`` x ``TILE_PX`` tile of a ``(side,
    side)`` raster (host numpy). A slot is listed in every tile that its
    nonzero square (``2 * half_px + 1`` pixels on a side, centered at its
    patch corner + ``patch_px // 2`` and cut to its patch window) overlaps;
    each tile's list is in slot order, and tiles no square overlaps are left
    out."""
    live = np.flatnonzero(np.asarray(mask, bool))
    tiles_x = -(-side // TILE_PX)
    if live.size == 0:
        empty = np.zeros((0,), np.int32)
        return TileBins(empty, np.zeros((1,), np.int32), empty)
    h = half_px(np.asarray(radius)[live], resolution)
    c = patch_px // 2
    r0 = np.asarray(row0, np.int64)[live]
    c0 = np.asarray(col0, np.int64)[live]
    lo, hi = np.maximum(c - h, 0), np.minimum(c + h, patch_px - 1)
    tr0, tr1 = (r0 + lo) // TILE_PX, (r0 + hi) // TILE_PX
    tc0, tc1 = (c0 + lo) // TILE_PX, (c0 + hi) // TILE_PX
    width = tc1 - tc0 + 1
    counts = (tr1 - tr0 + 1) * width
    rep = np.repeat(np.arange(live.size), counts)
    k = np.arange(rep.size) - np.repeat(np.cumsum(counts) - counts, counts)
    tile = (tr0[rep] + k // width[rep]) * tiles_x + tc0[rep] + k % width[rep]
    order = np.argsort(tile, kind="stable")  # stable: slot order within a tile
    tile, slots = tile[order], live[rep[order]]
    tile_ids, first = np.unique(tile, return_index=True)
    start = np.append(first, tile.size)
    return TileBins(tile_ids.astype(np.int32), start.astype(np.int32), slots.astype(np.int32))


class CudaCraterBlock:
    """Callable crater block wrapper. ``launches`` counts kernel launches
    and nothing else; the library is built at the first CUDA call."""

    source = "crater_block.cu"
    # the kernel's device functions by their check entry's op code
    XLA_MATH_OPS = ("atan2", "exp", "cos", "sin", "atan")

    def __init__(self):
        self.launches = 0
        self.built: cuda_build.BuiltLibrary | None = None

    def load(self) -> cuda_build.BuiltLibrary:
        if self.built is None:
            built = cuda_build.build(self.source)
            p, n, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            fn = built.lib.crater_block_f32
            fn.argtypes = [p, n, p, p, p, n, *[p] * 12, n, n, f, f, p]
            fn.restype = n
            check = built.lib.crater_block_xla_math_f32
            check.argtypes = [p, p, p, n, n, p]
            check.restype = n
            self.built = built
        return self.built

    def __call__(self, buf: Tensor, profiles, field, row0: Tensor, col0: Tensor,
                 resolution: float, z_scale: float, patch_px: int,
                 bins: TileBins | None = None, chunk: int | None = None) -> Tensor:
        """Add every live crater of ``field`` (a :class:`..terrain.craters.
        CraterField`, ``(slots,)`` columns) into ``buf`` (``(side, side)``)
        with its ``(patch_px, patch_px)`` patch corner at ``(row0[s],
        col0[s])``, in slot order, in place; returns ``buf``. ``bins``: the
        tile lists of :func:`tile_bins` on ``buf``'s device (computed here,
        with a host read of the placements and the field, when None on the
        card; unused on the CPU). ``chunk`` bounds the CPU route's patches
        per render."""
        from ..terrain.craters import crater_block_plain

        self._check(buf, profiles, field, row0, col0, patch_px)
        if not buf.is_cuda:
            return crater_block_plain(buf, profiles, field, row0, col0, resolution, z_scale,
                                      patch_px, chunk=chunk)
        if not buf.is_contiguous():
            raise ValueError("the crater block kernel writes a contiguous raster in place")
        if bins is None:
            bins = TileBins(*(torch.from_numpy(a).to(buf.device) for a in tile_bins(
                row0.cpu().numpy(), col0.cpu().numpy(), field.radius.cpu().numpy(),
                field.mask.cpu().numpy(), resolution, patch_px, buf.shape[0])))
        for t in bins:
            if t.dtype != torch.int32 or t.ndim != 1 or t.device != buf.device:
                raise ValueError("the crater block kernel takes int32 tile lists on the "
                                 "raster's device")
        if bins.start.shape[0] != bins.tile_ids.shape[0] + 1:
            raise ValueError("tile_start must hold one offset more than there are tiles")
        field = type(field)(*(f.contiguous() for f in field))
        profiles = type(profiles)(*(t.contiguous() for t in profiles))
        bins = TileBins(*(t.contiguous() for t in bins))
        with torch.cuda.device(buf.device):
            self.launch(buf, profiles, field, row0.contiguous(), col0.contiguous(), resolution,
                        z_scale, patch_px, bins)
        return buf

    @staticmethod
    def _check(buf, profiles, field, row0, col0, patch_px) -> None:
        floats = (buf, field.radius, field.rotation, field.xy_factor, field.marks_intensity,
                  *profiles)
        if any(t.dtype != torch.float32 for t in floats):
            raise TypeError("the crater block kernel takes a float32 raster, float32 crater "
                            "columns and float32 profile tables")
        ints = (field.deformation_id, field.marks_id, field.profile_id, row0, col0)
        if any(t.dtype != torch.int32 for t in ints) or field.mask.dtype != torch.bool:
            raise TypeError("the crater block kernel takes int32 ids and placements and a "
                            "bool mask")
        slots = field.mask.shape[0]
        columns = (field.radius, field.rotation, field.xy_factor, field.marks_intensity,
                   *ints, field.mask)
        if (buf.ndim != 2 or buf.shape[0] != buf.shape[1] or patch_px > buf.shape[0]
                or any(t.shape != (slots,) for t in columns)
                or any(t.ndim != 2 or t.shape[1] != TABLE_SIZE for t in profiles)):
            raise ValueError(f"the crater block kernel takes a square (side, side) raster of "
                             f"side >= patch_px, (slots,) crater columns and placements and "
                             f"(profiles, {TABLE_SIZE}) tables, got {tuple(buf.shape)}, "
                             f"{[tuple(t.shape) for t in columns]}, "
                             f"{[tuple(t.shape) for t in profiles]}")
        if len({t.device for t in (*floats, *columns)}) != 1:
            raise ValueError("the crater block kernel's inputs lie on different devices")

    def launch(self, buf: Tensor, profiles, field, row0: Tensor, col0: Tensor,
               resolution: float, z_scale: float, patch_px: int, bins: TileBins) -> None:
        """Launch the kernel on the current stream, no checks: ``buf``
        contiguous ``(side, side)`` float32 on the card, the field's columns,
        the placements, the tables and ``bins`` as :meth:`__call__` takes
        them (contiguous)."""
        tiles = bins.tile_ids.shape[0]
        if tiles == 0:
            return
        cols = (field.radius, field.rotation, field.xy_factor, field.marks_intensity,
                field.deformation_id, field.marks_id, field.profile_id, row0, col0)
        rc = self.load().lib.crater_block_f32(
            buf.data_ptr(), buf.shape[0], bins.tile_ids.data_ptr(), bins.start.data_ptr(),
            bins.slots.data_ptr(), tiles, *(c.data_ptr() for c in cols),
            *(t.data_ptr() for t in profiles), patch_px,
            int(patch_px > ATAN2_UNFUSED_MAX_PX), resolution, z_scale,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"crater_block_f32 launch failed: cudaError {rc}")
        self.launches += 1

    def xla_math(self, op: str, a: Tensor, b: Tensor | None = None) -> Tensor:
        """The kernel's device function ``op`` (``"atan2"``, ``"exp"``,
        ``"cos"``, ``"sin"`` or ``"atan"`` of ``csrc/xla_math.cuh``)
        elementwise on contiguous float32 ``a`` (and ``b``, atan2's ``x``) on
        the card: the check against :mod:`..core.xla_math`."""
        code = self.XLA_MATH_OPS.index(op)
        out = torch.empty_like(a)
        rc = self.load().lib.crater_block_xla_math_f32(
            a.data_ptr(), (b if b is not None else a).data_ptr(), out.data_ptr(), a.numel(),
            code, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"crater_block_xla_math_f32 launch failed: cudaError {rc}")
        return out


crater_block_cuda = CudaCraterBlock()
