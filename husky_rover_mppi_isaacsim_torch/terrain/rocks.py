"""Procedural rock scatter + block databases.

Counterpart of ``husky_rover_mppi_isaacsim_tpu/terrain/rocks.py`` (the
re-design of ``rock_distribution.py``, ``rock_database.py`` and the sampling
half of ``rock_manager.py``):

* rock positions, scales and prototype ids are sampled per block on the
  host with numpy, from a generator keyed by (seed, block): the JAX
  package's draws, so both packages place the same rocks;
* height + surface-tangent quaternion per rock are one vectorized query on
  the terrain's device (:func:`rock_surface_window` against a streamed
  window, :func:`rock_surface_hf` against a fixed heightfield);
* the quaternion's random tangent direction is the JAX package's draw
  (``_per_rock_rand``): ``jax.random``'s stream keyed by (seed, block,
  index in the block) through :mod:`..core.jax_random`, so a rock's draw
  depends on its block and its index in it, never on which blocks share a
  batch, and the quaternions are the JAX package's;
* blocks are stored through the native fixed-accuracy codec
  (:func:`.database.pack_native`) at the reference's ZFP tolerance 1e-3,
  as the JAX package stores them: what comes back
  from the store, positions included, is a multiple of 1e-3;
* ``rocks_data`` feeds the MPPI costmap as ``extract_rocks_data`` does
  (visual_terrain_stack_full_terrain.py:240-260).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
from torch import Tensor

from ..core import geometry as geom
from ..core import heightfield as hfield
from ..core import jax_random as jr
from ..core.heightfield import HeightField
from . import point_process as pp
from .database import pack_native, unpack_array
from .streaming import window_normal
from .upsample import bilinear_point_sample


@dataclasses.dataclass
class RockDistConf:
    """One rock size class (the RSCfg_* dicts,
    visual_terrain_stack_full_terrain.py:45-105)."""

    parent_density: float = 0.01
    child_density: float = 10.0
    sigma: float = 4.5
    scale_min: float = 0.05
    scale_max: float = 0.2
    block_size: float = 25.0
    num_assets: int = 16          # prototype id range (instancer variants)
    seed: int = 67


@dataclasses.dataclass
class RockBlock:
    """Struct-of-arrays rock block (utils.py:34-41 RockBlockData)."""

    coordinates: np.ndarray   # (N, 2)
    height: np.ndarray        # (N,)
    quaternion: np.ndarray    # (N, 4) xyzw
    scale: np.ndarray         # (N, 3)
    ids: np.ndarray           # (N,) int32 prototype ids


def sample_block_positions(rng: np.random.Generator, conf: RockDistConf,
                           bx: int, by: int) -> np.ndarray:
    """Thomas-process rock positions for one block (DynamicDistribute.run,
    rock_distribution.py:359-486)."""
    bs = conf.block_size
    region = pp.BoundingBox(bx * bs, (bx + 1) * bs, by * bs, (by + 1) * bs)
    return pp.thomas_point_process(rng, region, conf.parent_density, conf.child_density,
                                   conf.sigma)


def quat_from_normal_and_rand(normal: Tensor, rand: Tensor) -> Tensor:
    """Tangent-frame quaternion (xyzw): vx = normalize(cross(n, random)),
    vy = cross(n, vx), R = [vx, vy, n] (``_get_random_tangent_vector``,
    geometry_clipmaps_warp.py:363-422)."""
    vx = geom.normalize(geom.cross3(normal, rand))
    vy = geom.cross3(normal, vx)
    m = torch.stack([vx, vy, normal], dim=-1)  # (N, 3, 3), columns vx, vy, n
    w = torch.sqrt(torch.clamp(1.0 + m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2],
                               min=1e-12)) / 2.0
    qx = (m[..., 2, 1] - m[..., 1, 2]) / (4.0 * w)
    qy = (m[..., 0, 2] - m[..., 2, 0]) / (4.0 * w)
    qz = (m[..., 1, 0] - m[..., 0, 1]) / (4.0 * w)
    quat = torch.stack([qx, qy, qz, w], dim=-1)
    return quat / torch.linalg.norm(quat, dim=-1, keepdim=True)


def tangent_draws(shape: tuple, key: Tensor, dtype=torch.float32) -> Tensor:
    """``shape + (3,)`` uniforms in [-1, 1) on the key's device, the random
    tangent directions of :func:`quat_from_normal_and_rand`: JAX's draw
    ``jax.random.uniform(key, shape + (3,), dtype, -1, 1)``
    (rocks.py:99)."""
    return jr.uniform(key, tuple(shape) + (3,), dtype, -1.0, 1.0)


def orientation_from_normal(normal: Tensor, key: Tensor | None = None,
                            rand: Tensor | None = None, dtype=None) -> Tensor:
    """A random surface-tangent quaternion (xyzw) per normal: the tangent-
    frame half of ``_bilinear_interpolation_and_random_orientation`` and
    ``_get_random_tangent_vector`` (geometry_clipmaps_warp.py:363-422).
    The tangent directions are ``rand`` (``normal.shape[:-1] + (3,)``, in
    [-1, 1)) where given, else JAX's draws from ``key`` (a
    :mod:`..core.jax_random` key, :func:`tangent_draws`)."""
    dtype = dtype or normal.dtype
    if rand is None:
        if key is None:
            raise ValueError("orientation_from_normal needs a key or rand")
        rand = tangent_draws(normal.shape[:-1], key.to(normal.device), dtype)
    return quat_from_normal_and_rand(normal.to(dtype), rand.to(normal.device, dtype))


def surface_orientation(hf: HeightField, xy: Tensor, key: Tensor | None = None,
                        rand: Tensor | None = None):
    """Height, random surface-tangent quaternion (xyzw) and normal per point
    ``xy`` (N, 2) over a fixed heightfield window; the tangents as in
    :func:`orientation_from_normal`. Returns ``(height (N,), quaternion
    (N, 4), normal (N, 3))``."""
    x, y = xy[:, 0], xy[:, 1]
    q = hfield.corners_at(hf, x, y)
    height = hfield.bilinear(x, y, q, hf.resolution)
    normal = hfield.quad_normal(q, hf.resolution)
    return height, orientation_from_normal(normal, key, rand, xy.dtype), normal


def provider_orientation(provider, xy, key: Tensor | None = None,
                         rand: Tensor | None = None):
    """Height, tangent quaternion and normal from any world-coordinate
    height provider with vectorized ``get_height(x, y)`` and
    ``get_normal(x, y)`` (the ``TerrainStreamer`` / ``MapManager``
    surface): the rock-placement query the reference routes through
    ``NestedGeometryClipmapManager.get_height_and_random_scale``
    (nested_geometry_clipmaps_manager.py:220-237). ``xy`` (N, 2), numpy or
    a tensor, goes to the provider's device; the tangents as in
    :func:`orientation_from_normal`."""
    xy = torch.as_tensor(np.asarray(xy) if not isinstance(xy, Tensor) else xy)
    height = provider.get_height(xy[:, 0], xy[:, 1])
    normal = provider.get_normal(xy[:, 0], xy[:, 1])
    return height, orientation_from_normal(normal, key, rand), normal


def rock_tangent_draws(seed: int, blk, idx, dtype=torch.float32) -> Tensor:
    """``(N, 3)`` tangent draws of rocks keyed by (seed, block, index in the
    block), JAX's ``_per_rock_rand`` (rocks.py:103-112): row r is
    ``uniform(fold_in(fold_in(fold_in(key(seed), bx), by), i), (3,),
    dtype, -1, 1)`` for ``blk[r] = (bx, by)`` and ``idx[r] = i``, on the
    CPU. A row depends on its rock alone, never on the batch."""
    blk = torch.as_tensor(np.asarray(blk, np.int64)).reshape(-1, 2)
    idx = torch.as_tensor(np.asarray(idx, np.int64)).reshape(-1)
    k = jr.fold_in(jr.fold_in(jr.fold_in(jr.key(seed), blk[:, 0]), blk[:, 1]), idx)
    return jr.uniform(k, (3,), dtype, -1.0, 1.0)


def rock_surface_hf(hf: HeightField, xy: Tensor, rand: Tensor):
    """Heights + tangent quaternions of rocks at ``xy`` (N, 2) against a
    fixed :class:`HeightField`."""
    x, y = xy[:, 0], xy[:, 1]
    q = hfield.corners_at(hf, x, y)
    h = hfield.bilinear(x, y, q, hf.resolution)
    return h, quat_from_normal_and_rand(hfield.quad_normal(q, hf.resolution), rand)


def rock_surface_window(window: Tensor, ox: float, oy: float, res: Tensor, xy: Tensor,
                        rand: Tensor):
    """Heights + tangent quaternions against a streamed window in world
    coordinates (NestedGeometryClipmapManager.get_height_and_random_scale,
    nested_geometry_clipmaps_manager.py:220-237). ``res`` is a 0-d tensor:
    the division must be a true one on the card too."""
    px = (xy[:, 0] - ox) / res
    py = (xy[:, 1] - oy) / res
    h = bilinear_point_sample(window, px, py)
    return h, quat_from_normal_and_rand(window_normal(window, px, py, res), rand)


class RockDB:
    """Per-block rock storage (rock_database.py:22-400). With ``compress``
    float fields go through the native fixed-accuracy codec at the
    reference's ZFP tolerance 1e-3 (utils.py:43-53), ids as int32; each
    field packs as ``((bytes, kind), shape)``, the JAX ``RockDB``'s layout
    and bytes."""

    TOLERANCE = 1e-3

    def __init__(self, compress: bool = True):
        self._blocks: Dict[Tuple[int, int], object] = {}
        self.compress = compress

    def _pack(self, block: RockBlock) -> dict:
        packed = {}
        for name, arr in dataclasses.asdict(block).items():
            kind, buf, shape = pack_native(arr, self.TOLERANCE)
            packed[name] = ((buf, kind), shape)
        return packed

    def _unpack(self, packed: dict) -> RockBlock:
        return RockBlock(**{name: unpack_array((kind, buf, shape), self.TOLERANCE)
                            for name, ((buf, kind), shape) in packed.items()})

    def __contains__(self, key) -> bool:
        return tuple(key) in self._blocks

    def add(self, key, block: RockBlock) -> None:
        self._blocks[tuple(key)] = self._pack(block) if self.compress else block

    def get(self, key) -> RockBlock:
        blk = self._blocks[tuple(key)]
        return self._unpack(blk) if self.compress else blk

    def keys(self):
        return self._blocks.keys()


class RockSampler:
    """Block-based rock sampling against a heightfield (RockSampler +
    RockGenerator.sample, rock_distribution.py:518-756 /
    rock_manager.py:702-737)."""

    def __init__(self, conf: RockDistConf, hf):
        """``hf`` is a fixed :class:`HeightField` window, or a streamed
        terrain: a :class:`~.streaming.TerrainStreamer` or an object with
        one as ``.streamer`` (MapManager)."""
        self.conf = conf
        self.hf = hf
        self.db = RockDB()

    def _block_rng(self, bx: int, by: int) -> np.random.Generator:
        """Per-block generator keyed by (seed, block): block contents do not
        depend on the visit order."""
        return np.random.default_rng(
            (self.conf.seed, 0x52C3, bx & 0xFFFFFFFF, by & 0xFFFFFFFF))

    def sample_block(self, bx: int, by: int) -> RockBlock:
        if (bx, by) not in self.db:
            self.sample_blocks([(bx, by)])
        return self.db.get((bx, by))

    def sample_blocks(self, keys) -> None:
        """Sample every missing block: host point-process metadata per
        block, then ONE surface query on the device over the concatenated
        rocks and one copy back."""
        missing = [k for k in keys if k not in self.db]
        if not missing:
            return
        metas, xs, blks, idxs = [], [], [], []
        for bx, by in missing:
            rng = self._block_rng(bx, by)
            xy = sample_block_positions(rng, self.conf, bx, by)
            n = xy.shape[0]
            scale_xyz = rng.uniform(self.conf.scale_min, self.conf.scale_max,
                                    (n, 1)) * np.ones((1, 3))
            ids = rng.integers(0, self.conf.num_assets, n).astype(np.int32)
            metas.append(((bx, by), xy, scale_xyz, ids))
            if n:
                xs.append(np.asarray(xy, np.float64))
                blks.append(np.tile([bx, by], (n, 1)))
                idxs.append(np.arange(n))
        if xs:
            # JAX draws in the fixed window's dtype, float32 against a stream
            dtype = self.hf.z.dtype if isinstance(self.hf, HeightField) else torch.float32
            rand = rock_tangent_draws(self.conf.seed, np.concatenate(blks),
                                      np.concatenate(idxs), dtype)
            h_all, q_all = self._surface_query(np.concatenate(xs).astype(np.float32), rand)
        cursor = 0
        for key, xy, scale_xyz, ids in metas:
            n = xy.shape[0]
            if n == 0:
                h, quat = np.zeros((0,)), np.zeros((0, 4))
            else:
                h, quat = h_all[cursor:cursor + n], q_all[cursor:cursor + n]
                cursor += n
            self.db.add(key, RockBlock(
                coordinates=xy.astype(np.float32), height=h.astype(np.float32),
                quaternion=quat.astype(np.float32), scale=scale_xyz.astype(np.float32),
                ids=ids))

    def _surface_query(self, xy: np.ndarray, rand: Tensor):
        """Heights (n,) and quaternions (n, 4) of a rock batch, as numpy."""
        if isinstance(self.hf, HeightField):
            dev = self.hf.z.device
            h, q = rock_surface_hf(self.hf, torch.as_tensor(xy, dtype=self.hf.z.dtype,
                                                            device=dev),
                                   rand.to(device=dev, dtype=self.hf.z.dtype))
        else:
            streamer = getattr(self.hf, "streamer", self.hf)
            ox, oy = streamer.window_origin()
            dev = streamer.window.device
            res = torch.tensor(streamer.conf.resolution, dtype=torch.float32, device=dev)
            h, q = rock_surface_window(streamer.window, ox, oy, res,
                                       torch.as_tensor(xy, device=dev), rand.to(dev))
        return h.cpu().numpy(), q.cpu().numpy()

    def sample_region(self, position, block_span: int = 1) -> RockBlock:
        """Sample the (2*span+1)^2 blocks around a position; returns the
        concatenated blocks (RockGenerator.sample region logic,
        rock_manager.py:702-737)."""
        bs = self.conf.block_size
        bx = int(np.floor(position[0] / bs))
        by = int(np.floor(position[1] / bs))
        span = range(-block_span, block_span + 1)
        keys = [(bx + dx, by + dy) for dx in span for dy in span]
        self.sample_blocks(keys)
        blocks = [self.db.get(k) for k in keys]
        return RockBlock(
            coordinates=np.concatenate([b.coordinates for b in blocks]),
            height=np.concatenate([b.height for b in blocks]),
            quaternion=np.concatenate([b.quaternion for b in blocks]),
            scale=np.concatenate([b.scale for b in blocks]),
            ids=np.concatenate([b.ids for b in blocks]),
        )


def rocks_to_obstacles(blocks: RockBlock, min_radius: float = 0.0) -> np.ndarray:
    """Rocks -> MPPI obstacle list [x, y, radius], the rock -> costmap bridge
    (extract_rocks_data, visual_terrain_stack_full_terrain.py:240-260:
    radius taken as the rock scale)."""
    radius = blocks.scale[:, 0]
    keep = radius >= min_radius
    return np.concatenate([blocks.coordinates[keep], radius[keep, None]], axis=-1)
