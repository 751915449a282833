"""Frozen copy of ``husky_rover_mppi_isaacsim_torch/mppi/rollout.py`` (commit c6c4900), the plain version
the benchmark's reference is built from; it imports nothing of the port.
Its own docstring follows.

Batched 2.5D trajectory rollouts over a heightfield, in eager torch.

Counterpart of ``rollout_25d`` in
``husky_rover_mppi_isaacsim_tpu/mppi/rollout.py`` (projection_warp.py:284-383):
the whole sample batch advances one horizon step at a time, with direct
gathers on the whole DEM. The per-step op order is the JAX one, so float64
rollouts match the JAX package and the NumPy oracle.

:func:`rollout_25d` is also the plain version of the hand-written CUDA
rollout kernel (:mod:`..ops.rollout_cuda`), which takes it for CPU tensors.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from . import geometry as geom
from . import heightfield as hfield
from .heightfield import HeightField

WHEEL_OFFSET = 0.2  # m, lateral wheel-track offset (projection_warp.py:333)


class Rollout(NamedTuple):
    """Trajectory bundle, each field ``batch + (H, 3)``."""

    trajectory: Tensor   # (x, y, bilinear height)
    headings: Tensor     # unit heading after each step
    left_wheel: Tensor   # (x, y, nearest-cell height) of the left track
    right_wheel: Tensor  # same for the right track


def start_heading(hf: HeightField, position: Tensor, heading: Tensor) -> Tensor:
    """Pre-loop heading: project onto the start cell's plane
    (projection_warp.py:306-310)."""
    q0 = hfield.corners_at(hf, position[..., 0], position[..., 1])
    return hfield.tangent_project(hfield.quad_normal(q0, hf.resolution), heading)


def rollout_25d(
    hf: HeightField,
    position: Tensor,
    heading: Tensor,
    linear_velocities: Tensor,
    angular_velocities: Tensor,
    dt: float,
    wheels: bool = True,
) -> Rollout:
    """Surface-riding kinematic rollout (projection_warp.py:284-350).

    ``position`` is ``(2,)`` or ``batch + (2,)``, ``heading`` ``(3,)`` or
    ``batch + (3,)``, the velocities ``batch + (H,)``. With ``wheels=False``
    the wheel-track lookups are skipped and ``left_wheel = right_wheel =
    trajectory`` (the body-slope critic and the optimal rollout)."""
    lin = linear_velocities
    batch = lin.shape[:-1]
    pos = position.to(lin.dtype).expand(batch + (2,))
    hv = heading.to(lin.dtype).expand(batch + (3,))
    prev = start_heading(hf, pos, hv)
    x, y = pos[..., 0], pos[..., 1]

    traj, heads, lws, rws = [], [], [], []
    for t in range(lin.shape[-1]):
        x, y = geom.update_position(x, y, prev, lin[..., t], dt)
        q = hfield.corners_at(hf, x, y)
        height = hfield.bilinear(x, y, q, hf.resolution)
        normal = hfield.quad_normal(q, hf.resolution)
        prev = hfield.tangent_project(normal, prev)
        current = geom.update_orientation(prev, angular_velocities[..., t], normal, dt)
        traj.append(torch.stack([x, y, height], dim=-1))
        heads.append(current)
        if wheels:
            # +/- offset along normal x heading, nearest-cell height
            # (projection_warp.py:332-348)
            right = WHEEL_OFFSET * geom.cross3(normal, current)
            lx, ly = x + right[..., 0], y + right[..., 1]
            rx, ry = x - right[..., 0], y - right[..., 1]
            lws.append(torch.stack([lx, ly, hfield.nearest_height(hf, lx, ly)], dim=-1))
            rws.append(torch.stack([rx, ry, hfield.nearest_height(hf, rx, ry)], dim=-1))
        prev = current

    traj = torch.stack(traj, dim=-2)
    heads = torch.stack(heads, dim=-2)
    if not wheels:
        return Rollout(traj, heads, traj, traj)
    return Rollout(traj, heads, torch.stack(lws, dim=-2), torch.stack(rws, dim=-2))
