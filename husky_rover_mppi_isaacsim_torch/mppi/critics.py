"""MPPI critic stack and importance-weighted reduction.

Counterpart of ``husky_rover_mppi_isaacsim_tpu/mppi/critics.py``
(critics_warp.py:302-329)::

    cost = 100.5 * path_follow + 50.5 * avoid_slope_wheels
         +   0.5 * maximise_speed + 25.0 * avoid_obstacle

with a deterministic two-pass minimum in the softmax weights.

The rover-level arguments (pose ``x``, ``y``, ``goal``) may carry a leading
rover axis ``(N,)`` against trajectories ``(N, K, H, 3)``: they line up with
the leading axes, as under the JAX package's ``jax.vmap`` over rovers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from ..core.geometry import align_leading
from ..core.heightfield import grid_lookup
from ..dynamics.skid_steer import require_full_fp32_matmul


class CriticWeights(NamedTuple):
    """Critic mixing weights (critics_warp.py:324-329)."""

    path_follow: float = 100.5
    slope_wheels: float = 50.5
    speed: float = 0.5
    obstacle: float = 25.0


class Costmap(NamedTuple):
    """Obstacle costmap over the heightfield's window: ``cost`` is
    ``(size, size)``, row ``iy = trunc((half_width - y)/res)``, column
    ``ix = trunc((x + half_width)/res)`` (critics_warp.py:245-248).
    ``half_width`` and ``resolution`` are 0-d tensors on the cost's device."""

    cost: Tensor
    half_width: Tensor
    resolution: Tensor

    @property
    def size(self) -> int:
        return self.cost.shape[-1]


def path_follow_critic(x: Tensor, y: Tensor, goal: Tensor, trajectory: Tensor,
                       horizon_m: Tensor) -> Tensor:
    """Goal-progress critic (critics_warp.py:86-127): far from the goal, the
    scaled squared distance of the last waypoint to an intermediate goal
    ``horizon_m`` along the goal direction; near it, 10x L1 tracking of every
    waypoint but the last."""
    eps = 1e-6
    gx, gy = goal[..., 0], goal[..., 1]
    x_diff = gx - x
    y_diff = gy - y
    dist = torch.sqrt(x_diff * x_diff + y_diff * y_diff)
    last = trajectory[..., -1, :]
    lead = last.ndim - 1  # the sample axes (..., K) of a per-sample cost
    inter_x = align_leading(x + x_diff * horizon_m / (dist + eps), last, lead)
    inter_y = align_leading(y + y_diff * horizon_m / (dist + eps), last, lead)
    scale = align_leading(1.0 + 2.0 * horizon_m / dist, last, lead)
    far = ((last[..., 0] - inter_x) ** 2 + (last[..., 1] - inter_y) ** 2) * scale
    goal_x = align_leading(gx, trajectory, lead + 1)
    goal_y = align_leading(gy, trajectory, lead + 1)
    near = torch.sum(
        10.0 * (torch.abs(trajectory[..., :-1, 0] - goal_x)
                + torch.abs(trajectory[..., :-1, 1] - goal_y)),
        dim=-1,
    )
    return torch.where(align_leading(dist, last, lead) > horizon_m, far, near)


def _pair_slope(points: Tensor) -> Tensor:
    """(1 + 5*|dz/d|)^2 over waypoint pairs (i, i+2), i = 0, 2, ... < H-3
    (critics_warp.py:151-164)."""
    eps = 1e-6
    idx = torch.arange(0, points.shape[-2] - 3, 2, device=points.device)
    p0 = points[..., idx, :]
    p1 = points[..., idx + 2, :]
    dz = p1[..., 2] - p0[..., 2]
    d = torch.sqrt((p1[..., 0] - p0[..., 0]) ** 2 + (p1[..., 1] - p0[..., 1]) ** 2)
    return (1.0 + 5.0 * torch.abs(dz / (d + eps))) ** 2


def avoid_slope_critic(trajectory: Tensor) -> Tensor:
    """Body-frame slope critic (critics_warp.py:130-166), which the offline
    rescorers of :mod:`.evaluation` use."""
    return torch.sum(_pair_slope(trajectory), dim=-1)


def avoid_slope_wheels_critic(left_wheel: Tensor, right_wheel: Tensor) -> Tensor:
    """Per-pair max of left/right wheel-track slopes (critics_warp.py:168-218)."""
    return torch.sum(torch.maximum(_pair_slope(left_wheel), _pair_slope(right_wheel)),
                     dim=-1)


def costmap_cells(trajectory: Tensor, costmap: Costmap) -> tuple[Tensor, Tensor]:
    """Waypoint -> costmap cell indices (critics_warp.py:245-248), trunc."""
    ix = torch.trunc((trajectory[..., 0] + costmap.half_width) / costmap.resolution)
    iy = torch.trunc((-trajectory[..., 1] + costmap.half_width) / costmap.resolution)
    return ix.to(torch.int64), iy.to(torch.int64)


def avoid_obstacle_critic(trajectory: Tensor, costmap: Costmap) -> Tensor:
    """Nearest-cell costmap lookup per waypoint; cells above 0.99 add 1e5
    each (critics_warp.py:220-267). Out-of-map cells follow the JAX gather
    semantics (wrap a negative index once, then clamp)."""
    ix, iy = costmap_cells(trajectory, costmap)
    cell = grid_lookup(costmap.cost, ix, iy)
    hit = torch.where(cell > 0.99, 1e5, 0.0).to(cell.dtype)
    return torch.sum(hit + cell, dim=-1)


def maximise_speed_critic(x: Tensor, y: Tensor, goal: Tensor,
                          linear_velocities: Tensor, target_speed: Tensor) -> Tensor:
    """Sum of (v_max - v)/(v + 1e-4), off within 2 m of the goal
    (critics_warp.py:269-300)."""
    x_diff = goal[..., 0] - x
    y_diff = goal[..., 1] - y
    dist = torch.sqrt(x_diff * x_diff + y_diff * y_diff)
    diff = torch.sum((target_speed - linear_velocities) / (linear_velocities + 1e-4),
                     dim=-1)
    dist = align_leading(dist, diff, diff.ndim)
    return torch.where(dist < 2.0, torch.zeros_like(diff), diff)


def evaluate_trajectories(
    x: Tensor, y: Tensor, goal: Tensor, trajectory: Tensor,
    left_wheel: Tensor, right_wheel: Tensor, linear_velocities: Tensor,
    target_speed: Tensor, costmap: Costmap, horizon_m: Tensor,
    weights: CriticWeights = CriticWeights(),
) -> Tensor:
    """Total per-sample cost (critics_warp.py:302-329)."""
    cost = weights.path_follow * path_follow_critic(x, y, goal, trajectory, horizon_m)
    cost = cost + weights.slope_wheels * avoid_slope_wheels_critic(left_wheel, right_wheel)
    cost = cost + weights.speed * maximise_speed_critic(
        x, y, goal, linear_velocities, target_speed)
    cost = cost + weights.obstacle * avoid_obstacle_critic(trajectory, costmap)
    return cost


def goal_angle_critic(x: Tensor, y: Tensor, goal: Tensor, goal_orientation: Tensor,
                      trajectory: Tensor) -> Tensor:
    """Terminal-orientation critic (``_goal_angle_critic``,
    critics_warp.py:4-40), kept but unused in the production sum, like the
    reference and the JAX package. Within 0.5 m of the goal: |atan(dy/dx) -
    goal_orientation| of the last trajectory segment (``atan``, not
    ``atan2``: the reference's quirk, kept)."""
    dist = torch.sqrt((x - goal[0]) ** 2 + (y - goal[1]) ** 2)
    p0 = trajectory[..., -2, :]
    p1 = trajectory[..., -1, :]
    ang = torch.arctan((p1[..., 1] - p0[..., 1]) / (p1[..., 0] - p0[..., 0]))
    return torch.where(dist < 0.5, torch.abs(ang - goal_orientation), torch.zeros_like(ang))


def path_orientation_critic(x: Tensor, y: Tensor, goal: Tensor, trajectory: Tensor) -> Tensor:
    """Progress-direction critic (``_path_orientation_critic``,
    critics_warp.py:43-82), kept but unused in the production sum: a
    rollout whose last segment points away from the goal costs the negated
    scalar product over the L1 goal offset."""
    x_diff = goal[0] - x
    y_diff = goal[1] - y
    p0 = trajectory[..., -2, :]
    p1 = trajectory[..., -1, :]
    sp = x_diff * (p1[..., 0] - p0[..., 0]) + y_diff * (p1[..., 1] - p0[..., 1])
    return torch.where(sp <= 0, -sp / (torch.abs(x_diff) + torch.abs(y_diff)),
                       torch.zeros_like(sp))


def softmax_weights(costs: Tensor, temperature: float, min_cost: Tensor | None = None) -> Tensor:
    """``exp(-(c - min c)/T)`` with a two-pass min (critics_warp.py:338-347).
    ``mppi_step`` passes ``min_cost`` (``...``, 1), its minimum (all-reduced
    in the sharded step); without it the local min is taken, as in the JAX
    package's ``softmax_weights``, the form ``tests/test_torch_critics.py``
    holds against JAX."""
    if min_cost is None:
        min_cost = torch.amin(costs, dim=-1, keepdim=True)
    return torch.exp(-(costs - min_cost) / temperature)


def weighted_sums(weights: Tensor, u1: Tensor, u2: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """The three sums of the weighted update: ``sum_k w_k`` (``...``, 1) and
    ``sum_k w_k u_k`` for each input (``...``, H), full float32 on the card
    (no TF32)."""
    require_full_fp32_matmul(u1)
    total = torch.sum(weights, dim=-1)[..., None]
    return (total, torch.einsum("...k,...kh->...h", weights, u1),
            torch.einsum("...k,...kh->...h", weights, u2))


def weighted_update(weights: Tensor, u1: Tensor, u2: Tensor) -> tuple[Tensor, Tensor]:
    """``sum_k w_k u_k / sum_k w_k`` (critics_warp.py:350-376): the JAX
    package's ``weighted_update``, kept under its name for
    ``tests/test_torch_critics.py`` to hold against JAX. ``mppi_step`` calls
    :func:`weighted_sums` and divides, so that the sharded step can
    all-reduce the sums first."""
    total, sum1, sum2 = weighted_sums(weights, u1, u2)
    return sum1 / total, sum2 / total
