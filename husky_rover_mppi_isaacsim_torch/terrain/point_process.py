"""Point processes on the host in numpy: the hardcore Poisson process for
crater placement and the Thomas cluster process for rocks.

Numpy copies of ``BoundingBox``, ``sample_poisson``, ``hardcore_rejection``,
``reject_inside_previous``, ``hardcore_poisson`` and ``thomas_point_process``
in ``husky_rover_mppi_isaacsim_tpu/terrain/point_process.py`` (whose module
imports jax), with the same draw order (DynamicDistribute,
crater_distribution.py:46-289), so one ``np.random.Generator`` gives both
packages the same points.

The fixed-capacity variants (:class:`MaskedPoints`, :func:`poisson_fixed`,
:func:`hardcore_thin_fixed`, :func:`thomas_fixed`) are torch on any device,
with static shapes (a mask marks the valid points). They take the JAX
package's key and split it in its order, and draw JAX's counts, uniforms
and normals from it (:mod:`..core.jax_random`), so a key gives the JAX
package's points; :func:`hardcore_thin_masked` is the draw-free half of the
thinning.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch
from torch import Tensor

from ..core import jax_random as jr


@dataclasses.dataclass
class BoundingBox:
    """Region in meters (utils.py:23-30)."""

    x_min: float = 0.0
    x_max: float = 0.0
    y_min: float = 0.0
    y_max: float = 0.0

    @property
    def area(self) -> float:
        return (self.x_max - self.x_min) * (self.y_max - self.y_min)


def sample_poisson(rng: np.random.Generator, region: BoundingBox, density: float,
                   r_minmax: Tuple[float, float]):
    """Poisson point count + uniform radii/coords, reference draw order
    (crater_distribution.py:63-86: count, radii, x, y)."""
    num = rng.poisson(region.area * density)
    radius = rng.uniform(r_minmax[0], r_minmax[1], num)
    x = rng.uniform(region.x_min, region.x_max, num)
    y = rng.uniform(region.y_min, region.y_max, num)
    return np.stack([x, y]).T, radius


def _cell_groups(coords: np.ndarray, cell: float):
    """Spatial binning: (sorted point order, group slices, lookup
    ``(gx, gy) -> (start, stop)`` into the sorted order)."""
    g = np.floor(coords / cell).astype(np.int64)
    gx, gy = g[:, 0], g[:, 1]
    span = gy.max() - gy.min() + 1 if gy.size else 1
    key = (gx - gx.min()) * span + (gy - gy.min())
    order = np.argsort(key, kind="stable")
    sorted_key = key[order]
    uniq, starts = np.unique(sorted_key, return_index=True)
    stops = np.append(starts[1:], sorted_key.size)
    lookup = {}
    base_x, base_y = gx.min(), gy.min()
    for u, s, e in zip(uniq, starts, stops):
        lookup[(u // span + base_x, u % span + base_y)] = (s, e)
    return order, list(zip(uniq, starts, stops)), lookup


def _neighbor_indices(lookup, order, cx: int, cy: int):
    """Point indices (original numbering) in the 3x3 cell neighborhood."""
    out = []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            se = lookup.get((cx + dx, cy + dy))
            if se is not None:
                out.append(order[se[0]:se[1]])
    return np.concatenate(out) if out else np.empty(0, np.int64)


def hardcore_rejection(rng: np.random.Generator, coords: np.ndarray, radius: np.ndarray):
    """Age-mark hardcore thinning (crater_distribution.py:87-110): a point
    survives if it is older (smaller mark) than every point inside its
    radius. Dense for small draws, grid-binned (cell = max radius, 3x3
    neighborhoods) above 768 points; both keep the same set."""
    mark_age = rng.uniform(0, 1, coords.shape[0])
    n = coords.shape[0]
    if n == 0:
        return coords, radius
    if n <= 768:
        dist = np.linalg.norm(coords[:, None, :] - coords[None, :, :], axis=-1)
        in_disk = (dist < radius[:, None]) & (dist > 0)
        neighbor_min = np.where(in_disk, mark_age[None, :], np.inf).min(axis=1)
        keep = mark_age < neighbor_min
        return coords[keep], radius[keep]
    cell = float(max(radius.max(), 1e-6))
    order, groups, lookup = _cell_groups(coords, cell)
    keep = np.ones(n, dtype=bool)
    g = np.floor(coords / cell).astype(np.int64)
    span = g[:, 1].max() - g[:, 1].min() + 1
    base_x, base_y = g[:, 0].min(), g[:, 1].min()
    for u, s, e in groups:
        idx = order[s:e]
        cx, cy = u // span + base_x, u % span + base_y
        cand = _neighbor_indices(lookup, order, cx, cy)
        d = np.linalg.norm(coords[idx][:, None, :] - coords[cand][None, :, :], axis=-1)
        in_disk = (d < radius[idx][:, None]) & (d > 0)
        nmin = np.where(in_disk, mark_age[cand][None, :], np.inf).min(axis=1)
        keep[idx] = mark_age[idx] < nmin
    return coords[keep], radius[keep]


def reject_inside_previous(coords: np.ndarray, radius: np.ndarray,
                           prev: Tuple[np.ndarray, np.ndarray] | None):
    """Drop new points inside previously placed disks
    (crater_distribution.py:112-135); dense for small products, grid-binned
    over the previous disks above."""
    if prev is None or prev[0].shape[0] == 0:
        return coords, radius
    n_prev, n_new = prev[0].shape[0], coords.shape[0]
    if n_prev * n_new <= 1 << 22:
        keep = np.ones(n_new, dtype=bool)
        chunk = 4096
        for s in range(0, n_prev, chunk):
            pc = prev[0][s:s + chunk]
            pr = prev[1][s:s + chunk]
            dist = np.linalg.norm(pc[:, None, :] - coords[None, :, :], axis=-1)
            keep &= ~np.any((dist < pr[:, None]) & (dist > 0), axis=0)
        return coords[keep], radius[keep]
    cell = float(max(prev[1].max(), 1e-6))
    order, _, lookup = _cell_groups(prev[0], cell)
    keep = np.ones(n_new, dtype=bool)
    gnew = np.floor(coords / cell).astype(np.int64)
    order_new, groups_new, _ = _cell_groups(coords, cell)
    span = gnew[:, 1].max() - gnew[:, 1].min() + 1 if n_new else 1
    base_x, base_y = gnew[:, 0].min(), gnew[:, 1].min()
    for u, s, e in groups_new:
        idx = order_new[s:e]
        cx, cy = u // span + base_x, u % span + base_y
        cand = _neighbor_indices(lookup, order, cx, cy)
        if cand.size == 0:
            continue
        d = np.linalg.norm(coords[idx][:, None, :] - prev[0][cand][None, :, :], axis=-1)
        hit = np.any((d < prev[1][cand][None, :]) & (d > 0), axis=1)
        keep[idx] &= ~hit
    return coords[keep], radius[keep]


def hardcore_poisson(rng: np.random.Generator, region: BoundingBox, densities,
                     radius_ranges, prev: Tuple[np.ndarray, np.ndarray] | None = None,
                     num_repeat: int = 1):
    """Tiered hardcore Poisson process (run_HC, crater_distribution.py:
    191-227): per density/radius tier, repeated sample + thin, then reject
    against all previously accepted points."""
    if prev is not None and prev[1].shape[0] == 0:
        prev = None
    if prev is not None:
        # only previous disks that can reach into the region matter
        px, py, pr = prev[0][:, 0], prev[0][:, 1], prev[1]
        near = ((px >= region.x_min - pr) & (px <= region.x_max + pr)
                & (py >= region.y_min - pr) & (py <= region.y_max + pr))
        prev = (prev[0][near], prev[1][near])
        if prev[1].shape[0] == 0:
            prev = None
    all_coords, all_radius = [], []
    for density, r_minmax in zip(densities, radius_ranges):
        coords, radius = sample_poisson(rng, region, density, r_minmax)
        for _ in range(num_repeat):
            coords, radius = hardcore_rejection(rng, coords, radius)
            new_c, new_r = sample_poisson(rng, region, density, r_minmax)
            coords = np.concatenate([coords, new_c])
            radius = np.concatenate([radius, new_r])
        coords, radius = hardcore_rejection(rng, coords, radius)
        coords, radius = reject_inside_previous(coords, radius, prev)
        all_coords.append(coords)
        all_radius.append(radius)
        prev = (
            np.concatenate([prev[0], coords], axis=0) if prev is not None else coords,
            np.concatenate([prev[1], radius], axis=0) if prev is not None else radius,
        )
    return np.concatenate(all_coords, axis=0), np.concatenate(all_radius, axis=0)


def thomas_point_process(rng: np.random.Generator, region: BoundingBox, parent_density: float,
                         child_density: float, sigma: float) -> np.ndarray:
    """Thomas cluster process (rock_distribution.py Thomas semantics):
    Poisson parents on a region extended by 4 sigma, Poisson-many
    N(parent, sigma) children, clipped to the region. Returns (n, 2)."""
    ext = BoundingBox(region.x_min - 4 * sigma, region.x_max + 4 * sigma,
                      region.y_min - 4 * sigma, region.y_max + 4 * sigma)
    num_parents = rng.poisson(ext.area * parent_density)
    px = rng.uniform(ext.x_min, ext.x_max, num_parents)
    py = rng.uniform(ext.y_min, ext.y_max, num_parents)
    num_children = rng.poisson(child_density, num_parents)
    total = int(num_children.sum())
    cx = np.repeat(px, num_children) + rng.normal(0, sigma, total)
    cy = np.repeat(py, num_children) + rng.normal(0, sigma, total)
    inside = ((cx >= region.x_min) & (cx <= region.x_max)
              & (cy >= region.y_min) & (cy <= region.y_max))
    return np.stack([cx[inside], cy[inside]]).T


# --- fixed capacity, torch ----------------------------------------------------

class MaskedPoints(NamedTuple):
    """Fixed-capacity point set: ``points`` (C, 2), ``radius`` (C,),
    ``mask`` (C,) validity."""

    points: Tensor
    radius: Tensor
    mask: Tensor

    @property
    def capacity(self) -> int:
        return self.points.shape[0]


def poisson_fixed(key: Tensor, region: tuple, density: float, r_minmax: tuple,
                  capacity: int, dtype=torch.float32) -> MaskedPoints:
    """Poisson process with static shapes: ``capacity`` uniform candidates
    in ``region`` ``(x_min, x_max, y_min, y_max)``, the first
    ``min(Poisson(area * density), capacity)`` of them valid, on the key's
    device. JAX's draws from JAX's key (``point_process.py:243-264``):
    ``k1, k2, k3, k4 = split(key, 4)`` for the count, x, y and the radii."""
    x_min, x_max, y_min, y_max = region
    area = (x_max - x_min) * (y_max - y_min)
    k1, k2, k3, k4 = jr.split(key, 4)
    count = torch.clamp(jr.poisson(k1, area * density), max=capacity)
    mask = torch.arange(capacity, device=key.device) < count
    x = jr.uniform(k2, (capacity,), dtype, x_min, x_max)
    y = jr.uniform(k3, (capacity,), dtype, y_min, y_max)
    r = jr.uniform(k4, (capacity,), dtype, r_minmax[0], r_minmax[1])
    return MaskedPoints(torch.stack([x, y], dim=-1), r, mask)


def hardcore_thin_masked(pts: MaskedPoints, marks: Tensor) -> MaskedPoints:
    """Age-mark hardcore thinning on a fixed-capacity set, given the marks
    (C,): a valid point survives if it is older (smaller mark) than every
    valid point strictly inside its radius (the O(C^2) pairwise form of
    the JAX ``hardcore_thin_fixed``)."""
    diff = pts.points[:, None, :] - pts.points[None, :, :]
    dist = torch.sqrt(torch.sum(diff * diff, dim=-1))
    in_disk = (dist < pts.radius[:, None]) & (dist > 0)
    in_disk = in_disk & pts.mask[None, :] & pts.mask[:, None]
    older = marks[:, None] < marks[None, :]
    keep = torch.all(torch.where(in_disk, older, True), dim=-1) & pts.mask
    return MaskedPoints(pts.points, pts.radius, keep)


def hardcore_thin_fixed(key: Tensor, pts: MaskedPoints) -> MaskedPoints:
    """:func:`hardcore_thin_masked` with JAX's marks, ``uniform(key, (C,))``
    in the points' dtype (``point_process.py:267-278``)."""
    return hardcore_thin_masked(pts, jr.uniform(key, (pts.capacity,), pts.points.dtype))


def thomas_fixed(key: Tensor, region: tuple, parent_density: float, child_density: float,
                 sigma: float, parent_capacity: int, children_per_parent: int,
                 dtype=torch.float32) -> MaskedPoints:
    """Thomas cluster process with static (parents x children) capacity:
    Poisson parents on the region grown by 4 sigma, Poisson-many
    N(parent, sigma) children each (capped at ``children_per_parent``), only
    children inside ``region`` valid; radii are zero. JAX's draws from
    JAX's key (``point_process.py:281-318``): ``k1, ..., k5 = split(key,
    5)`` for the parent count, parent x, parent y, the child counts and the
    child offsets."""
    dev = key.device
    x_min, x_max, y_min, y_max = region
    ext = (x_min - 4 * sigma, x_max + 4 * sigma, y_min - 4 * sigma, y_max + 4 * sigma)
    area = (ext[1] - ext[0]) * (ext[3] - ext[2])
    k1, k2, k3, k4, k5 = jr.split(key, 5)
    n_parents = torch.clamp(jr.poisson(k1, area * parent_density), max=parent_capacity)
    pmask = torch.arange(parent_capacity, device=dev) < n_parents
    px = jr.uniform(k2, (parent_capacity,), dtype, ext[0], ext[1])
    py = jr.uniform(k3, (parent_capacity,), dtype, ext[2], ext[3])
    n_children = torch.clamp(jr.poisson(k4, child_density, (parent_capacity,)),
                             max=children_per_parent)
    cmask = ((torch.arange(children_per_parent, device=dev)[None, :] < n_children[:, None])
             & pmask[:, None])
    noise = jr.normal(k5, (parent_capacity, children_per_parent, 2), dtype) * sigma
    cx = px[:, None] + noise[..., 0]
    cy = py[:, None] + noise[..., 1]
    inside = (cx >= x_min) & (cx <= x_max) & (cy >= y_min) & (cy <= y_max)
    points = torch.stack([cx, cy], dim=-1).reshape(-1, 2)
    mask = (cmask & inside).reshape(-1)
    return MaskedPoints(points, torch.zeros(points.shape[0], dtype=dtype, device=dev), mask)
