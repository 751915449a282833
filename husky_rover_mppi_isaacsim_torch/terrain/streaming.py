"""Streamed high-resolution terrain windows.

Counterpart of ``husky_rover_mppi_isaacsim_tpu/terrain/streaming.py``, the
replacement for ``HighResDEMGen`` and its worker pools
(high_resolution_DEM_generator.py, high_resolution_DEM_workers.py). A
sliding (2N+3)^2 grid of blocks: each block is a bicubic upsample of a
low-resolution patch plus the crater stamp of its radius tiers, built on the
streamer's device and cached; a shift rolls the window (``torch.roll``) and
writes the entering blocks with slice assignments, then builds the next band
in the travel direction ahead of need.

Crater metadata (hardcore Poisson, data-dependent shapes) is sampled on the
host with numpy from ONE generator, in visit order: blocks must be built in
the JAX package's order (the initial window row by row, the entering blocks
of a shift, the prefetch band and its corner) for the two packages to see
the same craters. Per-crater appearance comes from a generator keyed by the
block and does not depend on the order.

:meth:`TerrainStreamer.prestage_shift` composes the shifted window for an
anticipated anchor ahead of the crossing (drawing the entering blocks'
craters then, in the order the shift would); the shift itself then swaps it
in. The stage is keyed on the source window's identity and its
``Tensor._version``, so a window written in place since (a deformation
stamp) is never swapped for a stale stage.

With ``StreamerConf.native_pool`` on (``"auto"`` on a CPU streamer,
``"always"`` on any device) :meth:`TerrainStreamer.bulk_build` upsamples
every missing block's LR patch on the native C++ :class:`..native.TilePool`
(host threads, the reference's upsample workers) from a host copy of the LR
DEM, then uploads each base to the streamer's device and stamps its craters
there. On the card the uploads, and the crater fields' on both routes, go
through pinned buffers without a host sync (:class:`..core.device.
HostUploader`). Every caller of ``bulk_build`` takes the route: the first
window, a shift's entering blocks, :meth:`TerrainStreamer.prestage_shift`
and the prefetch band. The pool is created at first use, raises where the
native library does not build, and is closed with the streamer
(:meth:`TerrainStreamer.close`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
from torch import Tensor

from ..core.device import HostUploader, run_device
from .craters import (
    CraterField,
    CraterProfiles,
    CraterSamplerConf,
    build_profiles,
    randomize_metadata,
    render_crater_block,
)
from .point_process import BoundingBox, hardcore_poisson
from .upsample import _take2d, bilinear_point_sample, upsample_block


def window_normal(window: Tensor, px: Tensor, py: Tensor, res: Tensor) -> Tensor:
    """Quad normal at fractional window pixels. The window layout is
    [row = x, col = y]: dz/dx differences run along i, dz/dy along j, and
    n is proportional to (-dz/dx, -dz/dy, 1)."""
    n = window.shape[0]
    i = torch.clamp(torch.floor(px).to(torch.int64), 0, n - 2)
    j = torch.clamp(torch.floor(py).to(torch.int64), 0, n - 2)
    q00 = _take2d(window, i, j)
    q01 = _take2d(window, i, j + 1)
    q10 = _take2d(window, i + 1, j)
    q11 = _take2d(window, i + 1, j + 1)
    vx = -res / 2.0 * (q10 - q00 - q01 + q11)
    vy = -res / 2.0 * (q01 - q00 - q10 + q11)
    vz = res * res * torch.ones_like(vx)
    v = torch.stack([vx, vy, vz], dim=-1)
    return v / torch.linalg.norm(v, dim=-1, keepdim=True)


NATIVE_POOL_MODES = ("auto", "always", "never")


def check_native_pool(mode: str) -> None:
    if mode not in NATIVE_POOL_MODES:
        raise ValueError(f"native_pool={mode!r}: expected one of {NATIVE_POOL_MODES}")


@dataclasses.dataclass
class StreamerConf:
    """Window geometry (HighResDEMConf semantics,
    high_resolution_DEM_generator.py:42-87)."""

    block_size: float = 50.0       # meters per block
    resolution: float = 0.05       # HR meters/px
    lr_resolution: float = 5.0     # LR meters/px (LOLA tiles)
    num_blocks: int = 2            # window side = 2*num_blocks + 3 blocks
    pad_size: float = 10.0         # crater-render padding (m)
    z_scale: float = 1.0
    seed: int = 42
    crater: CraterSamplerConf = dataclasses.field(default_factory=CraterSamplerConf)
    generate_craters: bool = True
    max_cached_blocks: int = 256
    prefetch: bool = True          # travel-direction block prefetch on shift
    # Route the blocks' bicubic upsamples through the native C++ TilePool
    # (csrc/husky_native.cpp, the worker-pool role of
    # high_resolution_DEM_workers.py:199-466): "auto" on a CPU streamer
    # only, "always" on any device, "never" not at all. The crater stamp
    # runs on the streamer's device either way.
    native_pool: str = "auto"      # "auto" | "always" | "never"
    native_pool_workers: int = 8   # the reference's 8 upsample workers

    def __post_init__(self) -> None:
        if not (self.block_size > 0 and self.resolution > 0):
            raise ValueError("block_size and resolution must be positive")
        ratio = self.lr_resolution / self.resolution
        if abs(ratio - round(ratio)) >= 1e-9:
            raise ValueError("lr_resolution must be an integer multiple of resolution")
        lr_block = self.block_size / self.lr_resolution
        if abs(lr_block - round(lr_block)) >= 1e-9:
            raise ValueError("block_size must be an integer number of LR pixels")
        check_native_pool(self.native_pool)

    @property
    def blocks_per_side(self) -> int:
        return 2 * self.num_blocks + 3

    @property
    def block_px(self) -> int:
        return int(round(self.block_size / self.resolution))

    @property
    def window_px(self) -> int:
        return self.blocks_per_side * self.block_px

    @property
    def window_size(self) -> float:
        return self.blocks_per_side * self.block_size

    @property
    def upscale_factor(self) -> int:
        return int(round(self.lr_resolution / self.resolution))

    @property
    def pad_px(self) -> int:
        return int(round(self.pad_size / self.resolution))


class TerrainStreamer:
    """Sliding HR terrain window over a low-resolution source DEM.

    Axis convention matches the reference DEM layout (row = x, col = y,
    map_manager.py:88-90 after its flip/transpose), so the window can be
    handed directly to the MPPI surface with the rotated controller frame
    (env/frames.py).
    """

    def __init__(self, conf: StreamerConf, lr_dem: np.ndarray,
                 lr_center: Tuple[float, float] = (0.0, 0.0), device=None):
        """Args:
            lr_dem: (H, W) low-resolution source DEM (meters), row = x.
            lr_center: world coordinate of the LR DEM center.
            device: where the LR DEM, the profile tables, the block cache
                and the window live (default: the card, see
                :func:`..core.device.run_device`).
        """
        check_native_pool(conf.native_pool)
        self.conf = conf
        self.device = run_device(device)
        self.lr_dem = lr_dem
        self.lr_center = lr_center
        self.rng = np.random.default_rng(conf.seed)
        self.profiles: CraterProfiles = build_profiles(
            conf.crater.num_profiles, conf.crater.seed, device=self.device)
        self.crater_blocks: Dict[Tuple[int, int], tuple] = {}
        self.block_cache: Dict[Tuple[int, int], Tensor] = {}
        self.blocks_built = 0  # blocks finished (either route), cache hits not counted
        self.anchor: Tuple[int, int] | None = None  # SW block index of window
        self.window: Tensor | None = None
        self.shift_count = 0
        # (anchor, staged window, source window, source version)
        self._staged_shift: tuple | None = None
        self.staged_shift_hits = 0
        # tests: compose every swapped-in stage again and require equality
        self.verify_stage = False
        self.staged_shift_verified = 0
        self._res = torch.tensor(conf.resolution, dtype=torch.float32, device=self.device)
        self._upload = HostUploader(self.device)
        self._pool = None  # the native TilePool, created at first use

    @property
    def lr_dem(self) -> Tensor:
        """The LR DEM on the streamer's device. Setting it keeps a float32
        host copy beside it, which the tile pool route reads."""
        return self._lr_dem

    @lr_dem.setter
    def lr_dem(self, value) -> None:
        host = value.cpu().numpy() if isinstance(value, Tensor) else np.asarray(value)
        self._lr_host = np.ascontiguousarray(host, np.float32)
        self._lr_dem = torch.as_tensor(self._lr_host, device=self.device)

    def close(self) -> None:
        """Close the tile pool, if one was started. Idempotent."""
        if self._pool is not None:
            self._pool.close()
            self._pool = None

    # --- coordinates --------------------------------------------------------

    def block_index(self, position) -> Tuple[int, int]:
        """Block containing a world position (cast_coordinates_to_block_space,
        high_resolution_DEM_generator.py:234-253), on the host in float64."""
        bs = self.conf.block_size
        return (int(np.floor(position[0] / bs)), int(np.floor(position[1] / bs)))

    def window_origin(self) -> Tuple[float, float]:
        """World coordinate of the window's [0, 0] pixel."""
        bs = self.conf.block_size
        return (self.anchor[0] * bs, self.anchor[1] * bs)

    # --- crater metadata ----------------------------------------------------

    def _block_region(self, bx: int, by: int) -> BoundingBox:
        bs = self.conf.block_size
        return BoundingBox(bx * bs, (bx + 1) * bs, by * bs, (by + 1) * bs)

    def _sample_block_craters(self, bx: int, by: int) -> None:
        """Sample crater metadata for one block with neighbor-aware hardcore
        rejection (CraterSampler.sample_craters_by_block,
        crater_distribution.py:503-583)."""
        if (bx, by) in self.crater_blocks:
            return
        prev_c, prev_r = [], []
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                blk = self.crater_blocks.get((bx + dx, by + dy))
                if blk is not None:
                    prev_c.append(blk[0])
                    prev_r.append(blk[1])
        prev = None
        if prev_c:
            prev = (np.concatenate(prev_c), np.concatenate(prev_r))
        cc = self.conf.crater
        coords, radius = hardcore_poisson(
            self.rng, self._block_region(bx, by), cc.densities,
            cc.radius_ranges, prev, cc.num_repeat,
        )
        if coords.shape[0] > cc.capacity_per_block:
            coords = coords[: cc.capacity_per_block]
            radius = radius[: cc.capacity_per_block]
        self.crater_blocks[(bx, by)] = (coords, radius)

    def sample_craters_by_region(self, bx0: int, bx1: int, by0: int, by1: int) -> int:
        """Sample crater metadata for every missing block in the region with
        as few Poisson draws as possible: the missing set is decomposed into
        maximal empty rectangles (one hardcore-Poisson draw per rectangle,
        conditioned on neighboring existing craters), then split per block
        (crater_distribution.py:532-583, 647-700). Returns the number of
        rectangles drawn."""
        from .database import decompose_empty_rectangles

        occ = np.zeros((bx1 - bx0, by1 - by0), bool)  # True = already sampled
        for (bx, by) in self.crater_blocks:
            if bx0 <= bx < bx1 and by0 <= by < by1:
                occ[bx - bx0, by - by0] = True
        rects = decompose_empty_rectangles(occ)
        cc = self.conf.crater
        bs = self.conf.block_size
        for r, c, hh, ww in rects:
            rbx0, rby0 = bx0 + r, by0 + c
            region = BoundingBox(rbx0 * bs, (rbx0 + hh) * bs, rby0 * bs, (rby0 + ww) * bs)
            # condition on craters in blocks bordering the rectangle
            prev_c, prev_r = [], []
            for bx in range(rbx0 - 1, rbx0 + hh + 1):
                for by in range(rby0 - 1, rby0 + ww + 1):
                    inside = rbx0 <= bx < rbx0 + hh and rby0 <= by < rby0 + ww
                    blk = self.crater_blocks.get((bx, by))
                    if blk is not None and not inside:
                        prev_c.append(blk[0])
                        prev_r.append(blk[1])
            prev = None
            if prev_c:
                prev = (np.concatenate(prev_c), np.concatenate(prev_r))
            coords, radius = hardcore_poisson(
                self.rng, region, cc.densities, cc.radius_ranges, prev, cc.num_repeat)
            # split the draw into per-block metadata lists
            bix = np.floor(coords[:, 0] / bs).astype(int)
            biy = np.floor(coords[:, 1] / bs).astype(int)
            for bx in range(rbx0, rbx0 + hh):
                for by in range(rby0, rby0 + ww):
                    sel = (bix == bx) & (biy == by)
                    self.crater_blocks[(bx, by)] = (coords[sel][: cc.capacity_per_block],
                                                    radius[sel][: cc.capacity_per_block])
        return len(rects)

    def save_crater_db(self, folder: str) -> None:
        """Persist crater metadata blocks (CraterDB save_to_disk,
        crater_database.py:19-33)."""
        from .database import BlockDB, BlockDBConf

        db = BlockDB(BlockDBConf(block_size=self.conf.block_size, compress=False))
        for key, (coords, radius) in self.crater_blocks.items():
            db.add(key, {"coordinates": coords, "radius": radius})
        db.save_to_disk(folder)

    def load_crater_db(self, folder: str) -> None:
        from .database import BlockDB, BlockDBConf

        db = BlockDB(BlockDBConf(block_size=self.conf.block_size, compress=False))
        db.load_from_disk(folder)
        for key in db.keys():
            payload = db.get(key)
            self.crater_blocks[tuple(key)] = (payload["coordinates"], payload["radius"])

    @property
    def _tier_specs(self):
        """Per radius tier ``(r_hi, capacity, patch_px)``, largest radius
        first. Each density tier renders at ITS OWN patch size instead of
        the global maximum: the small-crater tier (most craters) would
        otherwise render patches several times its diameter. Capacities
        follow the conf (1.5x the expected count + 64, rounded to 64) and
        cap a tier's craters as in the JAX package."""
        conf = self.conf
        padded = conf.block_size + 2 * conf.pad_size
        area = padded * padded
        specs = []
        for d, (_lo, hi) in zip(conf.crater.densities, conf.crater.radius_ranges):
            cap = int(area * d * 1.5) + 64
            cap = -(-cap // 64) * 64
            p = int(np.ceil(2 * hi / conf.resolution)) + 4
            specs.append((float(hi), cap, -(-p // 8) * 8))
        specs.sort(key=lambda s: -s[0])
        return specs

    def _block_fields(self, bx: int, by: int):
        """Metadata of a block and its 8 neighbors (craters bleed across
        block borders, CraterDB.get_block_data_with_neighbors), filtered to
        craters fully inside the padded raster (``check_if_crater_is_in_
        block``, crater_generation.py:169-181), then split into radius
        tiers. Returns ``[(field, patch_px), ...]``: one :class:`CraterField`
        of CPU tensors per tier of :attr:`_tier_specs`, padded to the tier's
        capacity with masked slots after the live ones, as in the JAX
        package, so that a tier's stamp always has the shape
        ``(capacity, patch_px)``. A padded slot is zero but for its xy
        factor, 1 as :func:`randomize_metadata` pads it (JAX pads 0: its
        render divides by it, and ``torch.take`` refuses the NaN index that
        follows, where ``jnp.take`` clamps)."""
        cc = self.conf.crater
        conf = self.conf
        coords, radius = [], []
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                self._sample_block_craters(bx + dx, by + dy)
                c, r = self.crater_blocks[(bx + dx, by + dy)]
                coords.append(c)
                radius.append(r)
        coords = np.concatenate(coords)
        radius = np.concatenate(radius)
        # keep craters whose patch lies inside the padded raster
        origin = np.array([bx * conf.block_size, by * conf.block_size])
        size_px = conf.block_px + 2 * conf.pad_px
        coord_px = (coords - origin) / conf.resolution + conf.pad_px
        c_half = radius / conf.resolution
        keep = (
            (coord_px[:, 0] - c_half >= 0)
            & (coord_px[:, 1] - c_half >= 0)
            & (coord_px[:, 0] + c_half < size_px)
            & (coord_px[:, 1] + c_half < size_px)
        )
        coords, radius = coords[keep], radius[keep]
        # Deterministic per-crater appearance: a dedicated generator keyed by
        # the block so metadata does not depend on build order. One draw for
        # the whole block BEFORE the tier split keeps the metadata stream
        # independent of the tier boundaries.
        meta_rng = np.random.default_rng((self.conf.seed, 0x5EED, bx & 0xFFFF, by & 0xFFFF))
        n = coords.shape[0]
        meta = randomize_metadata(meta_rng, coords, radius, cc.num_profiles, n,
                                  cc.min_xy_ratio, cc.max_xy_ratio, as_numpy=True)
        specs = self._tier_specs
        # each crater renders in the smallest tier patch that covers it
        # (falls back to the largest tier when a radius exceeds every range)
        tier = np.zeros((n,), np.int32)
        for i, (r_hi, _cap, _p) in enumerate(specs):
            tier[radius <= r_hi + 1e-9] = i
        out = []
        for i, (_r_hi, cap, patch_px) in enumerate(specs):
            sel = np.flatnonzero(tier == i)[:cap]
            field = CraterField(*(np.zeros((cap,) + f.shape[1:], f.dtype) for f in meta))
            field.xy_factor[:] = 1.0
            for dst, src in zip(field, meta):
                dst[:sel.shape[0]] = src[sel]
            out.append((CraterField(*(torch.from_numpy(f) for f in field)), patch_px))
        return out

    # --- block building -----------------------------------------------------

    def _lr_indices(self, bx: int, by: int):
        """LR rows and columns of the patch covering a block + 2 LR pixels
        of margin, clamped at the LR DEM edges (querry_low_res_dem
        semantics)."""
        lr_px = int(round(self.conf.block_size / self.conf.lr_resolution))
        margin = 2
        h, w = self.lr_dem.shape
        cx, cy = self.lr_center
        # LR pixel of the block's SW corner, relative to the LR DEM's
        # world-center anchor
        px = int(round((bx * self.conf.block_size - cx) / self.conf.lr_resolution)) + h // 2
        py = int(round((by * self.conf.block_size - cy) / self.conf.lr_resolution)) + w // 2
        xs = np.clip(np.arange(px - margin, px + lr_px + margin), 0, h - 1)
        ys = np.clip(np.arange(py - margin, py + lr_px + margin), 0, w - 1)
        return xs, ys

    def _lr_patch(self, bx: int, by: int) -> Tensor:
        """The block's LR patch on the streamer's device."""
        xs, ys = self._lr_indices(bx, by)
        xs = torch.as_tensor(xs, device=self.device)
        ys = torch.as_tensor(ys, device=self.device)
        return self.lr_dem[xs][:, ys]

    def _lr_patch_host(self, bx: int, by: int) -> np.ndarray:
        """The block's LR patch from the host copy (no device read)."""
        xs, ys = self._lr_indices(bx, by)
        return self._lr_host[np.ix_(xs, ys)]

    def tile_pool(self):
        """The native TilePool when the route is on for this streamer's
        device, else None. Created at first use; raises where the native
        library does not build."""
        mode = self.conf.native_pool
        if mode == "never" or (mode == "auto" and self.device.type != "cpu"):
            return None
        if self._pool is None:
            from .. import native

            self._pool = native.TilePool(self.conf.native_pool_workers)
        return self._pool

    def bulk_build(self, keys) -> int:
        """Build every block of ``keys`` that is not cached, in order.
        With the tile pool on, the bicubic upsamples of all of them run
        concurrently on its C++ threads (shortest-queue dispatch, the
        8-worker upsample pool of high_resolution_DEM_workers.py:107-196),
        then each base is uploaded and stamped in order; otherwise each
        block builds through :meth:`build_block`. Returns the number
        built."""
        missing = [k for k in keys if k not in self.block_cache]
        if not missing:
            return 0
        pool = self.tile_pool()
        if pool is None:
            for k in missing:
                self.build_block(*k)
            return len(missing)
        from .. import native

        f = self.conf.upscale_factor
        jobs = {pool.submit(native.BICUBIC, self._lr_patch_host(*k), f): k for k in missing}
        results = pool.collect_all(timeout_s=300.0)
        m, bpx = 2 * f, self.conf.block_px
        for jid, (bx, by) in jobs.items():
            self._finish_block(bx, by, self._upload(results[jid][m:m + bpx, m:m + bpx]))
        return len(missing)

    def build_block(self, bx: int, by: int) -> Tensor:
        """Build one HR block: bicubic upsample of the LR patch + crater
        stamp (the two worker jobs of generate_terrain_blocks,
        high_resolution_DEM_generator.py:760-784)."""
        cached = self.block_cache.get((bx, by))
        if cached is not None:
            return cached
        conf = self.conf
        m = 2 * conf.upscale_factor
        base = upsample_block(self._lr_patch(bx, by), conf.upscale_factor, (m, m),
                              (conf.block_px, conf.block_px))
        return self._finish_block(bx, by, base)

    def _finish_block(self, bx: int, by: int, hr: Tensor) -> Tensor:
        """Crater stamp + cache insert for an upsampled block base."""
        conf = self.conf
        if conf.generate_craters:
            origin = np.asarray([bx * conf.block_size, by * conf.block_size], np.float32)
            for field, patch_px in self._block_fields(bx, by):
                if field.mask.any():  # one crater block launch per tier on the card
                    hr = hr + render_crater_block(
                        self.profiles, field, origin, conf.resolution, conf.z_scale,
                        conf.block_px, conf.pad_px, patch_px=patch_px, upload=self._upload)
        hr = hr.contiguous()
        self.blocks_built += 1
        if len(self.block_cache) >= conf.max_cached_blocks:
            self.block_cache.pop(next(iter(self.block_cache)))
        self.block_cache[(bx, by)] = hr
        return hr

    # --- window management --------------------------------------------------

    def update(self, position) -> bool:
        """Re-anchor the window so ``position`` is in its center block;
        returns True when the window shifted (update_visual_mesh trigger
        semantics, large_scale_terrain_manager.py:202-257).

        A shift of less than a window rolls the existing window and writes
        the newly exposed blocks (the reference's in-array memmove
        ``shift_dem``, high_resolution_DEM_generator.py:356-419), then builds
        the next band of blocks in the travel direction ahead of need. A
        first call or a larger jump builds the whole window."""
        bx, by = self.block_index(position)
        n = self.conf.num_blocks + 1  # center block offset inside the window
        new_anchor = (bx - n, by - n)
        if new_anchor == self.anchor and self.window is not None:
            return False
        old_anchor = self.anchor
        self.anchor = new_anchor
        side = self.conf.blocks_per_side
        small_shift = (
            self.window is not None
            and old_anchor is not None
            and abs(new_anchor[0] - old_anchor[0]) < side
            and abs(new_anchor[1] - old_anchor[1]) < side
        )
        staged, self._staged_shift = self._staged_shift, None
        if not small_shift:
            self.bulk_build([(new_anchor[0] + i, new_anchor[1] + j)
                             for i in range(side) for j in range(side)])
            self.window = torch.cat([
                torch.cat([self.build_block(new_anchor[0] + i, new_anchor[1] + j)
                           for j in range(side)], dim=1)
                for i in range(side)], dim=0)
        else:
            if staged is not None and staged[0] == new_anchor and self._stage_current(staged):
                # the pre-staged window: its roll and entering blocks ran
                # while the control loop kept going
                if self.verify_stage:
                    if not torch.equal(staged[1], self._compose_shift(old_anchor, new_anchor)):
                        raise AssertionError("staged window != the shift's compose")
                    self.staged_shift_verified += 1
                self.window = staged[1]
                self.staged_shift_hits += 1
            else:
                self.window = self._compose_shift(old_anchor, new_anchor)
            if self.conf.prefetch:
                self._prefetch(new_anchor[0] - old_anchor[0], new_anchor[1] - old_anchor[1])
        self.shift_count += 1
        return True

    def _stage_current(self, staged) -> bool:
        """The stage was composed from the live window as it is now."""
        return staged[2] is self.window and staged[3] == self.window._version

    def _compose_shift(self, old_anchor, new_anchor, source: Tensor | None = None) -> Tensor:
        """Shifted window for ``old_anchor -> new_anchor``: build the
        entering blocks (row-major over the new window, the JAX package's
        order), roll the window (or ``source``) and write them in.
        ``torch.roll`` makes a new window; the old one is released with its
        last reference. On the card every block and the source are marked
        as read on the current stream, so that the caching allocator does
        not hand their memory out while a side stream still reads them."""
        side = self.conf.blocks_per_side
        bpx = self.conf.block_px
        di = new_anchor[0] - old_anchor[0]
        dj = new_anchor[1] - old_anchor[1]
        entering = [
            (i, j)
            for i in range(side) for j in range(side)
            if not (0 <= new_anchor[0] + i - old_anchor[0] < side
                    and 0 <= new_anchor[1] + j - old_anchor[1] < side)
        ]
        self.bulk_build([(new_anchor[0] + i, new_anchor[1] + j) for i, j in entering])
        source = self.window if source is None else source
        blocks = [self.build_block(new_anchor[0] + i, new_anchor[1] + j) for i, j in entering]
        if source.is_cuda:
            stream = torch.cuda.current_stream(source.device)
            for t in [source] + blocks:
                t.record_stream(stream)
        window = torch.roll(source, (-di * bpx, -dj * bpx), (0, 1))
        for (i, j), block in zip(entering, blocks):
            window[i * bpx:(i + 1) * bpx, j * bpx:(j + 1) * bpx] = block
        return window

    def prestage_shift(self, new_anchor: Tuple[int, int]) -> None:
        """Compose the shifted window for an anticipated anchor now, so that
        the crossing in :meth:`update` only swaps it in. Entering blocks are
        built (and their craters drawn) as the shift would build them. The
        stage is keyed on the source window's identity and version: a new
        window, or a write into this one, invalidates it. Nothing is staged
        for a jump that :meth:`update` would serve by a full rebuild."""
        if self.window is None or self.anchor is None or new_anchor == self.anchor:
            return
        side = self.conf.blocks_per_side
        if (abs(new_anchor[0] - self.anchor[0]) >= side
                or abs(new_anchor[1] - self.anchor[1]) >= side):
            return
        src = self.window
        staged = self._staged_shift
        if staged is not None and staged[0] == new_anchor and self._stage_current(staged):
            return
        version = src._version
        win = self._compose_shift(self.anchor, new_anchor, source=src)
        self._staged_shift = (new_anchor, win, src, version)

    def _prefetch(self, di: int, dj: int) -> None:
        """Build (and cache) the band of blocks one step further along the
        travel direction, and on a diagonal the corner block where the two
        bands meet. This consumes the crater generator for blocks the rover
        may never see, as in the JAX package."""
        side = self.conf.blocks_per_side
        a = self.anchor
        band = []
        if di:
            row = a[0] + (side if di > 0 else -1)
            band += [(row, a[1] + j) for j in range(side)]
        if dj:
            col = a[1] + (side if dj > 0 else -1)
            band += [(a[0] + i, col) for i in range(side)]
        if di and dj:
            band.append((a[0] + (side if di > 0 else -1), a[1] + (side if dj > 0 else -1)))
        self.bulk_build(band)

    # --- queries ------------------------------------------------------------

    def _to_window_px(self, x, y):
        """World coordinates -> fractional window pixels, float32 on the
        streamer's device; the division is by a tensor (a true division on
        the card too)."""
        ox, oy = self.window_origin()
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        y = torch.as_tensor(y, dtype=torch.float32, device=self.device)
        return (x - ox) / self._res, (y - oy) / self._res

    def get_height(self, x, y) -> Tensor:
        """Bilinear height query in world coordinates
        (get_height_global, large_scale_terrain_manager.py:96-150)."""
        px, py = self._to_window_px(x, y)
        return bilinear_point_sample(self.window, px, py)

    def get_normal(self, x, y) -> Tensor:
        """Quad normal in world coordinates (get_normal_local semantics,
        quad-normal formula of the projection kernels)."""
        px, py = self._to_window_px(x, y)
        return window_normal(self.window, px, py, self._res)
