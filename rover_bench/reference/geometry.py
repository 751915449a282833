"""Frozen copy of ``husky_rover_mppi_isaacsim_torch/core/geometry.py`` (commit c6c4900), the plain version
the benchmark's reference is built from; it imports nothing of the port.
Its own docstring follows.

Rigid-body geometry helpers: Rodrigues rotation and heading updates.

Counterpart of ``husky_rover_mppi_isaacsim_tpu/core/geometry.py``
(projection_warp.py:207-275 math), batched over leading axes.
"""

from __future__ import annotations

import torch
from torch import Tensor

from .heightfield import dot3


def cross3(a: Tensor, b: Tensor) -> Tensor:
    """``a x b`` over the last axis, written out (the JAX ``jnp.cross``)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def normalize(v: Tensor) -> Tensor:
    """``v / sqrt(v.v)`` along the last axis."""
    return v / torch.sqrt(dot3(v, v))[..., None]


def rodrigues_rotate(v: Tensor, axis: Tensor, angle: Tensor) -> Tensor:
    """Rotate ``v`` by ``angle`` about unit ``axis`` (projection_warp.py:239-244)."""
    cos_t = torch.cos(angle)[..., None]
    sin_t = torch.sin(angle)[..., None]
    return (
        v * cos_t
        + cross3(axis, v) * sin_t
        + axis * dot3(axis, v)[..., None] * (1.0 - cos_t)
    )


def update_position(
    x: Tensor, y: Tensor, heading: Tensor, linear_velocity: Tensor, dt: float
) -> tuple[Tensor, Tensor]:
    """Euler step along the re-normalized heading (projection_warp.py:207-223)."""
    heading = normalize(heading)
    disp = heading * (linear_velocity * dt)[..., None]
    return x + disp[..., 0], y + disp[..., 1]


def update_orientation(
    heading: Tensor, angular_velocity: Tensor, normal: Tensor, dt: float
) -> Tensor:
    """Rotate the heading about the surface normal by ``w*dt`` and
    renormalize (projection_warp.py:225-248)."""
    heading = normalize(heading)
    rotated = rodrigues_rotate(heading, normal, angular_velocity * dt)
    return normalize(rotated)
