"""Rigid-body geometry helpers: Rodrigues rotation, heading updates, and the
alignment of rover-level values with batched leading axes.

Counterpart of ``husky_rover_mppi_isaacsim_tpu/core/geometry.py``
(projection_warp.py:207-275 math), batched over leading axes.
"""

from __future__ import annotations

import torch
from torch import Tensor

from .heightfield import dot3


def align_leading(value, like: Tensor, ndim: int) -> Tensor:
    """``value`` as a tensor of ``like``'s dtype and device with unit axes
    appended up to ``ndim`` axes, so that its axes line up with the leading
    axes of ``like`` (a rover-level ``(N,)`` against an ``(N, K, ...)``
    batch, as under ``jax.vmap``; a 0-d value broadcasts over everything).
    A reshape only: the values, and so every later rounding, are unchanged."""
    value = torch.as_tensor(value, dtype=like.dtype, device=like.device)
    return value.reshape(value.shape + (1,) * (ndim - value.ndim))


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


def update_orientation_2d(heading: Tensor, angular_velocity: Tensor, dt: float) -> Tensor:
    """Planar heading rotation, z forced to 0 (projection_warp.py:251-275)."""
    theta = angular_velocity * dt
    cos_t = torch.cos(theta)
    sin_t = torch.sin(theta)
    new_x = cos_t * heading[..., 0] - sin_t * heading[..., 1]
    new_y = sin_t * heading[..., 0] + cos_t * heading[..., 1]
    norm = torch.sqrt(new_x * new_x + new_y * new_y)
    safe = norm > 0.0
    denom = torch.where(safe, norm, torch.ones_like(norm))
    new_x = torch.where(safe, new_x / denom, new_x)
    new_y = torch.where(safe, new_y / denom, new_y)
    return torch.stack([new_x, new_y, torch.zeros_like(new_x)], dim=-1)
