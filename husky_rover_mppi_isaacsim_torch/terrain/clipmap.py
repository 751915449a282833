"""Geometry clipmaps: multi-LOD terrain sampling for visualization/export.

Counterpart of ``husky_rover_mppi_isaacsim_tpu/terrain/clipmap.py`` (the
re-design of ``geometry_clipmaps*.py``):

* the LOD ring layout is generated vectorized in numpy
  (:func:`build_ring_layout`, replacing ``geometry_clipmaps_numba.py:24-256``)
  and cached as arrays;
* per update, one gather per LOD interpolates every vertex height from a 2x
  average-pool pyramid of the DEM on the DEM's device (:meth:`Clipmap.sample`,
  replacing the ``_bilinear/_bicubic`` warp kernels,
  geometry_clipmaps_warp.py:180-279);
* :class:`NestedClipmap` pairs a fine (HR window) and a coarse (LR DEM)
  clipmap like ``NestedGeometryClipmapManager``, with its rock-placement
  query.

There is no USD stage to mutate; the sampled vertex buffer is the product.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

from .rocks import surface_orientation
from .upsample import bicubic_point_sample, bilinear_point_sample


@dataclasses.dataclass
class ClipmapSpec:
    """GeometryClipmapConf essentials (geometry_clipmaps.py:31-60)."""

    num_lods: int = 4
    ring_size: int = 16        # vertices per ring side at each LOD
    resolution: float = 0.05   # finest-LOD vertex spacing (m)
    interpolation: str = "bilinear"  # "bilinear" | "bicubic"


class RingLayout(NamedTuple):
    """Static clipmap vertex layout: 2D offsets + LOD id per vertex and a
    triangle index buffer."""

    offsets: np.ndarray    # (V, 2) vertex offsets from the center (m)
    lods: np.ndarray       # (V,) LOD id
    triangles: np.ndarray  # (T, 3) indices


def build_ring_layout(spec: ClipmapSpec) -> RingLayout:
    """Concentric LOD rings: LOD 0 is a dense (2n+1)^2 grid; each coarser
    LOD covers double the extent at double the spacing, skipping the region
    covered by the finer LOD (the clipmap 'backbone' the numba builder
    tessellates, geometry_clipmaps_numba.py:24-256)."""
    n = spec.ring_size
    offsets, lods, triangles = [], [], []
    base = 0
    for lod in range(spec.num_lods):
        spacing = spec.resolution * (2**lod)
        coords = np.arange(-n, n + 1) * spacing
        xx, yy = np.meshgrid(coords, coords, indexing="ij")
        pts = np.stack([xx.ravel(), yy.ravel()], axis=-1)
        keep = np.ones(pts.shape[0], dtype=bool)
        if lod > 0:
            inner = n * spacing / 2
            keep = np.maximum(np.abs(pts[:, 0]), np.abs(pts[:, 1])) >= inner
        # triangles over the full grid, masked to kept vertices
        side = 2 * n + 1
        idx = np.arange(side * side).reshape(side, side)
        a = idx[:-1, :-1].ravel()
        b = idx[:-1, 1:].ravel()
        c = idx[1:, :-1].ravel()
        d = idx[1:, 1:].ravel()
        tris = np.concatenate(
            [np.stack([a, b, c], axis=-1), np.stack([b, d, c], axis=-1)],
            axis=0,
        )
        tri_keep = keep[tris].all(axis=-1)
        # remap to the compacted vertex list
        remap = -np.ones(side * side, np.int64)
        remap[np.flatnonzero(keep)] = np.arange(keep.sum())
        offsets.append(pts[keep])
        lods.append(np.full(int(keep.sum()), lod))
        triangles.append(remap[tris[tri_keep]] + base)
        base += int(keep.sum())
    return RingLayout(
        np.concatenate(offsets), np.concatenate(lods),
        np.concatenate(triangles),
    )


def build_lod_pyramid(z: Tensor, num_lods: int) -> list[Tensor]:
    """2x average-pool pyramid of the source DEM, finest level first."""
    levels = [z]
    for _ in range(num_lods - 1):
        cur = levels[-1]
        h, w = cur.shape
        cur = cur[: h - h % 2, : w - w % 2]
        levels.append((cur[0::2, 0::2] + cur[1::2, 0::2] + cur[0::2, 1::2]
                       + cur[1::2, 1::2]) / 4.0)
    return levels


class Clipmap:
    """One clipmap over a DEM array (GeoClipmap + GeoClipmapManager roles)."""

    def __init__(self, spec: ClipmapSpec, z, origin=(0.0, 0.0),
                 source_resolution: float | None = None, device=None):
        self.spec = spec
        self.layout = build_ring_layout(spec)
        z = torch.as_tensor(z, device=device)
        self.pyramid = build_lod_pyramid(z, spec.num_lods)
        self.origin = origin
        self.source_resolution = source_resolution or spec.resolution
        self._offsets = torch.as_tensor(self.layout.offsets, dtype=torch.float32,
                                        device=z.device)
        self._lods = torch.as_tensor(self.layout.lods, device=z.device)

    def update_dem(self, z: Tensor, origin=None) -> None:
        """Re-seat the clipmap on new DEM contents (``update_DEM``,
        geometry_clipmaps.py:283-348): rebuild the LOD pyramid from the new
        array and move the world origin when the window shifted. The layout
        (mesh backbone) is untouched."""
        self.pyramid = build_lod_pyramid(z, self.spec.num_lods)
        if origin is not None:
            self.origin = origin

    def sample(self, center) -> Tensor:
        """Vertex positions (V, 3) of the clipmap centered at ``center``,
        the ``update_geoclipmap`` equivalent."""
        cx, cy = center
        sampler = (bicubic_point_sample if self.spec.interpolation == "bicubic"
                   else bilinear_point_sample)
        xs = self._offsets[:, 0] + cx
        ys = self._offsets[:, 1] + cy
        z = torch.zeros(xs.shape[0], dtype=torch.float32, device=xs.device)
        for lod, level in enumerate(self.pyramid):
            scale = 2**lod
            # a 0-d tensor divisor: a true division on the card too
            res = torch.tensor(self.source_resolution * scale, dtype=torch.float32,
                               device=xs.device)
            # 2x average pooling puts level-L pixel p's center at source
            # pixel 2^L*p + (2^L-1)/2: subtract that half-kernel shift, or
            # every coarse ring reads southwest of its vertices
            shift = (scale - 1) / 2.0 * self.source_resolution
            px = (xs - self.origin[0] - shift) / res
            py = (ys - self.origin[1] - shift) / res
            z = torch.where(self._lods == lod, sampler(level, px, py), z)
        return torch.stack([xs, ys, z], dim=-1)


class NestedClipmap:
    """Fine (HR window) + coarse (LR DEM) clipmap pair
    (NestedGeometryClipmapManager, nested_geometry_clipmaps_manager.py:71-265)."""

    def __init__(self, fine: Clipmap, coarse: Clipmap):
        self.fine = fine
        self.coarse = coarse

    def sample(self, center):
        return self.fine.sample(center), self.coarse.sample(center)

    def get_height_and_random_orientation(self, xy: Tensor, key: Tensor,
                                          hf) -> tuple[Tensor, Tensor, Tensor]:
        """Rock-placement query (get_height_and_random_scale,
        nested_geometry_clipmaps_manager.py:220-237) against the
        :class:`HeightField` ``hf``: per point of ``xy`` (N, 2) the bilinear
        height (N,), a random surface-tangent quaternion xyzw (N, 4) and the
        quad normal (N, 3). The tangent draw is JAX's from ``key`` (a
        :mod:`..core.jax_random` key; :func:`.rocks.surface_orientation`)."""
        return surface_orientation(hf, xy, key)
