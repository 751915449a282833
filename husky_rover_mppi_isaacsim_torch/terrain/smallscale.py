"""Small-scale procedural terrain: base noise + hardcore-Poisson craters, and
the thesis statistics terrain.

Counterpart of ``BaseTerrainGeneratorConf``, ``random_base_terrain``,
``MoonyardConf``, ``MoonyardGenerator`` and ``thesis_statistics_terrain`` in
``husky_rover_mppi_isaacsim_tpu/terrain/smallscale.py``
(terrain_generation.py:456-590).

One documented divergence: the JAX package draws the two base-noise grids
(the low-resolution 4x4, 5x5 or 3x3 grid and the 100x100 grid) with
``jax.random``. Here they come from a ``torch.Generator`` seeded with the
terrain seed, or are injected as tensors (``base_noise``), so the port's
thesis DEM is the same procedure with a different base-noise stream. The
craters come from numpy with the JAX package's seed and draw order and are
the same craters. The mesh export (``dem_to_mesh_grid``) stays on the host
in numpy, as in the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import Tensor

from ..core.device import run_device
from .craters import (
    CraterProfiles,
    CraterSamplerConf,
    build_profiles,
    randomize_metadata,
    render_crater_block,
)
from .point_process import BoundingBox, hardcore_poisson
from .upsample import bicubic_point_sample


@dataclasses.dataclass
class BaseTerrainGeneratorConf:
    """terrain_generation.py BaseTerrainGeneratorConf."""

    x_size: float = 10.0
    y_size: float = 10.0
    resolution: float = 0.02
    max_elevation: float = 0.5
    min_elevation: float = -0.25
    seed: int = 42
    z_scale: float = 1.0


def _resize_bicubic(img: Tensor, out_shape: tuple) -> Tensor:
    """cv2.INTER_CUBIC-style resize via Catmull-Rom point sampling at the
    pixel-center mapping ``src = (dst + 0.5) * scale - 0.5``."""
    h_in, w_in = img.shape
    h_out, w_out = out_shape
    ar = lambda n: torch.arange(n, dtype=img.dtype, device=img.device)  # noqa: E731
    rows = (ar(h_out) + 0.5) * (h_in / h_out) - 0.5
    cols = (ar(w_out) + 0.5) * (w_in / w_out) - 0.5
    rr, cc = torch.meshgrid(rows, cols, indexing="ij")
    return bicubic_point_sample(img, rr, cc)


def base_noise_shapes(is_lab: bool = False, is_yard: bool = False) -> tuple:
    """Shapes of the two base-noise grids: the low-resolution grid's drawn
    values, then the 100x100 high-frequency grid."""
    return ((3, 3) if is_lab else (5, 5) if is_yard else (4, 4)), (100, 100)


def random_base_terrain(
    conf: BaseTerrainGeneratorConf, generator: torch.Generator | None = None,
    is_lab: bool = False, is_yard: bool = False, base_noise=None,
    dtype=torch.float32, device=None,
) -> Tensor:
    """Low + high-frequency noise terrain (generateRandomTerrain,
    terrain_generation.py:475-504). ``base_noise``: the two grids as tensors
    of :func:`base_noise_shapes`, already in ``[min, max)`` and
    ``[0.01 min, 0.01 max)``; else drawn uniform from ``generator``."""
    x_px = int(conf.x_size / conf.resolution)
    y_px = int(conf.y_size / conf.resolution)
    lo, hi = conf.min_elevation, conf.max_elevation
    if base_noise is None:
        if generator is None:
            raise ValueError("random_base_terrain needs a generator or base_noise")
        shapes = base_noise_shapes(is_lab, is_yard)
        base_noise = [a + (b - a) * torch.rand(s, generator=generator, dtype=dtype,
                                               device=device)
                      for s, a, b in zip(shapes, (lo, 0.01 * lo), (hi, 0.01 * hi))]
    low, high = (torch.as_tensor(t, dtype=dtype, device=device) for t in base_noise)
    if is_lab:
        lr = torch.zeros((4, 4), dtype=dtype, device=device)
        lr[:-1, 1:] = low
    elif is_yard:
        lr = torch.zeros((7, 7), dtype=dtype, device=device)
        lr[1:-1, 1:-1] = low
    else:
        lr = low
    return _resize_bicubic(lr, (x_px, y_px)) + _resize_bicubic(high, (x_px, y_px))


@dataclasses.dataclass
class MoonyardConf:
    base: BaseTerrainGeneratorConf = dataclasses.field(
        default_factory=BaseTerrainGeneratorConf)
    crater: CraterSamplerConf = dataclasses.field(
        default_factory=lambda: CraterSamplerConf(
            densities=(0.1,), radius_ranges=((0.3, 1.0),), num_profiles=32))
    is_lab: bool = False
    is_yard: bool = True
    z_scale: float = 1.0


class MoonyardGenerator:
    """GenerateProceduralMoonYard (terrain_generation.py:505-590): base noise
    + hardcore-Poisson craters; ``randomize`` returns a fresh DEM on
    ``device`` (default: the card, see :func:`..core.device.run_device`).
    Craters come from ``np.random.default_rng(seed)``, the base
    noise from a ``torch.Generator`` seeded with the same seed."""

    def __init__(self, conf: MoonyardConf, dtype=torch.float32, device=None):
        self.conf = conf
        self.dtype = dtype
        self.device = run_device(device)
        self.rng = np.random.default_rng(conf.base.seed)
        self.generator = torch.Generator(device=self.device).manual_seed(conf.base.seed)
        self.profiles: CraterProfiles = build_profiles(
            conf.crater.num_profiles, conf.crater.seed, device=self.device)
        self.x_px = int(conf.base.x_size / conf.base.resolution)
        self.y_px = int(conf.base.y_size / conf.base.resolution)
        r_max = max(hi for _, hi in conf.crater.radius_ranges)
        p = int(np.ceil(2 * r_max / conf.base.resolution)) + 4
        self._patch_px = -(-p // 8) * 8
        area = conf.base.x_size * conf.base.y_size
        cap = int(area * sum(conf.crater.densities) * 1.5) + 64
        self._capacity = -(-cap // 256) * 256

    def randomize(self, base_noise=None) -> Tensor:
        """New base terrain + crater field (randomize,
        terrain_generation.py:546-558); ``base_noise`` as in
        :func:`random_base_terrain`."""
        dem = random_base_terrain(self.conf.base, self.generator, self.conf.is_lab,
                                  self.conf.is_yard, base_noise, self.dtype, self.device)
        cc = self.conf.crater
        region = BoundingBox(0.0, self.conf.base.x_size, 0.0, self.conf.base.y_size)
        coords, radius = hardcore_poisson(self.rng, region, cc.densities, cc.radius_ranges,
                                          None, cc.num_repeat)
        coords, radius = coords[:self._capacity], radius[:self._capacity]
        field = randomize_metadata(self.rng, coords, radius, cc.num_profiles,
                                   self._capacity, cc.min_xy_ratio, cc.max_xy_ratio)
        # the block renderer is square: render the enclosing square, crop
        side = max(self.x_px, self.y_px)
        craters = render_crater_block(self.profiles, field, (0.0, 0.0),
                                      self.conf.base.resolution, self.conf.z_scale,
                                      block_px=side, pad_px=0, patch_px=self._patch_px,
                                      chunk=256)
        return dem + craters[:dem.shape[0], :dem.shape[1]]


def thesis_statistics_terrain(
    seed: int = 42, size_m: float = 150.0, resolution: float = 0.1,
    crater_densities: tuple = (0.02, 0.05, 0.13),
    crater_radius_ranges: tuple = ((1.5, 2.5), (0.75, 1.5), (0.25, 0.5)),
    max_elevation: float = 1.2, min_elevation: float = -1.2, z_scale: float = 1.0,
    base_noise=None, dtype=torch.float32, device=None,
) -> Tensor:
    """Terrain statistically matched to the thesis's test map (work
    summarise:47-49): ``size_m`` square at ``resolution`` m/px, low-frequency
    base undulation and hardcore-Poisson craters at 0.2 craters/m^2 in
    total. Returns heights ``(N, N)`` on ``device``, row = x."""
    conf = MoonyardConf(
        base=BaseTerrainGeneratorConf(
            x_size=size_m, y_size=size_m, resolution=resolution,
            max_elevation=max_elevation, min_elevation=min_elevation, seed=seed),
        crater=CraterSamplerConf(densities=crater_densities,
                                 radius_ranges=crater_radius_ranges,
                                 num_profiles=64, seed=seed),
        is_lab=False, is_yard=False, z_scale=z_scale,
    )
    return MoonyardGenerator(conf, dtype, device).randomize(base_noise)


def dem_to_mesh_grid(dem, resolution: float) -> tuple[np.ndarray, np.ndarray]:
    """Vertices ``(H W, 3)`` and triangle indices ``(2 (H-1)(W-1), 3)`` of the
    regular grid mesh, two triangles per pixel (buildGrid,
    terrain_manager.py:151-193). ``dem`` may be a tensor on any device; the
    mesh is numpy on the host."""
    dem = dem.cpu().numpy() if isinstance(dem, Tensor) else np.asarray(dem)
    h, w = dem.shape
    xx, yy = np.meshgrid(np.arange(h) * resolution, np.arange(w) * resolution, indexing="ij")
    vertices = np.stack([xx.ravel(), yy.ravel(), dem.ravel()], axis=-1)
    idx = np.arange(h * w).reshape(h, w)
    a, b = idx[:-1, :-1].ravel(), idx[:-1, 1:].ravel()
    c, d = idx[1:, :-1].ravel(), idx[1:, 1:].ravel()
    tris = np.concatenate([np.stack([a, b, c], axis=-1), np.stack([b, d, c], axis=-1)], axis=0)
    return vertices, tris
