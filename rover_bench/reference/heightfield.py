"""Frozen copy of ``husky_rover_mppi_isaacsim_torch/core/heightfield.py`` (commit c6c4900), the plain version
the benchmark's reference is built from; it imports nothing of the port.
Its own docstring follows.

Heightfield (2.5D DEM) geometry ops on torch tensors.

Counterpart of ``husky_rover_mppi_isaacsim_tpu/core/heightfield.py`` with the
same semantics (the Warp ``projection_warp.py`` device functions):

* cell index ``i = trunc((x - x_min)/res)``, ``j = -trunc((y + y_min)/res)``
  with trunc (not floor) and a true division;
* out-of-window lookups follow the JAX gather semantics: a negative index
  wraps once (``i + n``), then clamps to ``[0, n-1]``. Torch indexing raises
  on CPU and device-asserts on CUDA, so :func:`wrap_clamp` writes it out;
* bilinear weights use trunc fractions and the transposed pairing.

The window scalars are 0-d tensors on the DEM's device: dividing by a CUDA
tensor is a true division, where dividing by a Python float would be turned
into a multiply by the reciprocal and flip cell indices at cell boundaries.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor


class HeightField(NamedTuple):
    """A regular-grid 2.5D heightfield window.

    Attributes:
        z: ``(rows, cols)`` heights; row ``j`` counts down from
           ``y = +half_width``, column ``i`` counts up from ``x_min``.
        x_min, y_min: 0-d tensors, ``-half_width`` (the reference's quirky
           ``j = -trunc((y + y_min)/res)`` formula is kept verbatim).
        resolution: 0-d tensor, cell size in meters.
    """

    z: Tensor
    x_min: Tensor
    y_min: Tensor
    resolution: Tensor

    @property
    def grid_size(self) -> int:
        return self.z.shape[-1]

    @classmethod
    def create(cls, z, half_width: float, dtype=None, device=None) -> "HeightField":
        """Window over ``[-half_width, half_width]^2`` with resolution
        ``2*half_width/grid`` (as the JAX ``HeightField.create``)."""
        z = torch.as_tensor(z, dtype=dtype, device=device)
        scalar = lambda v: torch.tensor(v, dtype=z.dtype, device=z.device)
        res = scalar(2.0 * half_width / z.shape[-1])
        hw = scalar(half_width)
        return cls(z=z, x_min=-hw, y_min=-hw, resolution=res)


def wrap_clamp(idx: Tensor, n: int) -> Tensor:
    """JAX ``x[idx]`` semantics: wrap a negative index once, then clamp."""
    return torch.where(idx < 0, idx + n, idx).clamp(0, n - 1)


def corner_cell(hf: HeightField, x: Tensor, y: Tensor) -> tuple[Tensor, Tensor]:
    """Cell indices of the quad containing (x, y) (projection_warp.py:39-40)."""
    i = torch.trunc((x - hf.x_min) / hf.resolution).to(torch.int64)
    j = (-torch.trunc((y + hf.y_min) / hf.resolution)).to(torch.int64)
    return i, j


def grid_lookup(grid: Tensor, i: Tensor, j: Tensor) -> Tensor:
    """``grid[j, i]`` with the JAX index semantics, any index shape.
    ``torch.take`` on the flat index: indexing with 0-d index tensors would
    turn them into Python ints, a host sync each."""
    rows, cols = grid.shape[-2:]
    return torch.take(grid, wrap_clamp(j, rows) * cols + wrap_clamp(i, cols))


def gather_corners(hf: HeightField, i: Tensor, j: Tensor) -> Tensor:
    """Quad corner heights ``q[a, b] = z[j + a, i + b]``, shape
    ``batch + (2, 2)`` (projection_warp.py:43-46)."""
    z = hf.z
    q00 = grid_lookup(z, i, j)
    q01 = grid_lookup(z, i + 1, j)
    q10 = grid_lookup(z, i, j + 1)
    q11 = grid_lookup(z, i + 1, j + 1)
    return torch.stack(
        [torch.stack([q00, q01], dim=-1), torch.stack([q10, q11], dim=-1)],
        dim=-2,
    )


def corners_at(hf: HeightField, x: Tensor, y: Tensor) -> Tensor:
    """Fused :func:`corner_cell` + :func:`gather_corners`."""
    i, j = corner_cell(hf, x, y)
    return gather_corners(hf, i, j)


def bilinear(x: Tensor, y: Tensor, q: Tensor, resolution: Tensor) -> Tensor:
    """Bilinear height with trunc fractions and the transposed weights
    (projection_warp.py:89-98): the x-fraction weights ``q[1,0]``."""
    xn = x / resolution
    yn = y / resolution
    x2 = xn - torch.trunc(xn)
    y2 = yn - torch.trunc(yn)
    q00 = q[..., 0, 0]
    q01 = q[..., 0, 1]
    q10 = q[..., 1, 0]
    q11 = q[..., 1, 1]
    return (
        (1.0 - x2) * (1.0 - y2) * q00
        + x2 * (1.0 - y2) * q10
        + (1.0 - x2) * y2 * q01
        + x2 * y2 * q11
    )


def dot3(a: Tensor, b: Tensor) -> Tensor:
    """``sum(a * b, -1)`` over 3-vectors, summed left to right."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def quad_normal(q: Tensor, resolution: Tensor) -> Tensor:
    """Unit normal of the quad (projection_warp.py:141-151), ``batch+(3,)``."""
    q00 = q[..., 0, 0]
    q01 = q[..., 0, 1]
    q10 = q[..., 1, 0]
    q11 = q[..., 1, 1]
    vx = -resolution / 2.0 * (q01 - q00 - q10 + q11)
    vy = -resolution / 2.0 * (q10 - q00 - q01 + q11)
    vz = (resolution * resolution).expand_as(vx)
    norm = torch.sqrt(vx * vx + vy * vy + vz * vz)
    return torch.stack([vx, vy, vz], dim=-1) / norm[..., None]


def tangent_project(normal: Tensor, heading: Tensor) -> Tensor:
    """Project ``heading`` onto the plane of ``normal`` and renormalize
    (projection_warp.py:181-190)."""
    proj = heading - dot3(heading, normal)[..., None] * normal
    return proj / torch.sqrt(dot3(proj, proj))[..., None]


def nearest_height(hf: HeightField, x: Tensor, y: Tensor) -> Tensor:
    """Truncated-index height lookup, used for the wheel tracks
    (projection_warp.py:338-347)."""
    i, j = corner_cell(hf, x, y)
    return grid_lookup(hf.z, i, j)


