"""World <-> controller frame transforms for streamed-terrain operation.

Counterpart of ``husky_rover_mppi_isaacsim_tpu/env/frames.py``. The full
stack runs the MPPI controller in a *rotated block-local frame*: with the
terrain window anchored at block ``(bx, by)`` and half-block offset ``hb``,

    ctrl.x =  world.y - by - hb
    ctrl.y = -(world.x - bx - hb)

(visual_terrain_stack_full_terrain.py:492-497 and the goal mapping :445-455).
Under that rotation the controller's ``Z[j, i]`` indexing lands on the
streamer window's ``[row = world x, col = world y]`` layout. On a block shift
``(dx, dy)`` every controller-frame point rebases by ``(-dy, +dx)``
(:569-575). Plain functions on tensors (or Python floats).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor


class BlockFrame(NamedTuple):
    """Anchor of the current terrain window: the center block's south-west
    corner and half a block, as 0-d tensors or floats."""

    block_x: Tensor
    block_y: Tensor
    half_block: Tensor

    def origin(self) -> tuple[Tensor, Tensor]:
        """Window-center origin (bx + hb, by + hb) (:446, :563)."""
        return self.block_x + self.half_block, self.block_y + self.half_block


def world_to_controller(frame: BlockFrame, x: Tensor, y: Tensor):
    """(:492-497): ctrl = (y - by - hb, -(x - bx - hb))."""
    cx = y - frame.block_y - frame.half_block
    cy = -(x - frame.block_x - frame.half_block)
    return cx, cy


def controller_to_world(frame: BlockFrame, cx: Tensor, cy: Tensor):
    """Inverse of :func:`world_to_controller`."""
    x = -cy + frame.block_x + frame.half_block
    y = cx + frame.block_y + frame.half_block
    return x, y


def rebase_on_shift(points: Tensor, shift_x, shift_y) -> Tensor:
    """Rebase controller-frame points after a block shift (dx, dy) in world:
    ctrl points move by (-dy, +dx) (:569-575). ``points`` is ``(..., 2)``."""
    return torch.stack([points[..., 0] - shift_y, points[..., 1] + shift_x], dim=-1)


def heading_world_to_controller(heading: Tensor) -> Tensor:
    """Rotate a world heading vector into the controller frame
    (:498-499: ``[h[1], -h[0], h[2]]``)."""
    return torch.stack([heading[..., 1], -heading[..., 0], heading[..., 2]], dim=-1)


def ema_quat(q1: Tensor, q2: Tensor, alpha) -> Tensor:
    """Hemisphere-corrected exponential moving average of two quaternions
    (``EMAquat``, visual_terrain_stack_full_terrain.py:14-26): lerp
    ``q1 -> q2`` with weight ``alpha``, its sign flipped when the two lie in
    opposite hemispheres, then renormalized. Batched over leading axes."""
    dot = torch.sum(q1 * q2, dim=-1, keepdim=True)
    alpha = torch.as_tensor(alpha, dtype=q1.dtype, device=q1.device)
    a = torch.where(dot < 0, -alpha, alpha)
    q = q1 * (1.0 - a) + q2 * a
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)
