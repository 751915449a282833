"""Path metrics (compute_path_metrics, MPPI_isaac.py:231-256), vectorized.

Counterpart of ``husky_rover_mppi_isaacsim_tpu/env/metrics.py``.
"""

from __future__ import annotations

import torch
from torch import Tensor


def path_metrics(trajectory: Tensor, stride: int = 20) -> dict:
    """Total length, accumulated up/down slope angles (deg) and climbed
    height over strided segments, with the reference's k=20 stride and
    segment endpoints (i-1, i+k). ``trajectory`` is ``(T, 3)`` or
    ``(..., T, 3)``; every value of the dict is ``batch``-shaped."""
    t = trajectory.shape[-2]
    idx = torch.arange(1, max(t - stride, 1), stride, device=trajectory.device)
    seg = trajectory[..., idx + stride, :] - trajectory[..., idx - 1, :]
    seg_len = torch.linalg.vector_norm(seg, dim=-1)
    planar = torch.linalg.vector_norm(seg[..., :2], dim=-1)
    angle = torch.rad2deg(torch.atan2(seg[..., 2], planar))
    valid = seg_len > 0
    zero = torch.zeros_like(angle)
    return {
        "total_length": torch.sum(seg_len, dim=-1),
        "total_angle_up": torch.sum(torch.where(valid & (angle > 0), angle, zero), dim=-1),
        "total_angle_down": torch.sum(torch.where(valid & (angle < 0), -angle, zero), dim=-1),
        "total_distance_up": torch.sum(torch.where(seg[..., 2] > 0, seg[..., 2], zero), dim=-1),
    }


def goal_distances(positions: Tensor, goals: Tensor) -> Tensor:
    """Euclidean distance of each rover to its goal."""
    return torch.linalg.vector_norm(positions - goals, dim=-1)


def success_mask(positions: Tensor, goals: Tensor, box: float = 0.5) -> Tensor:
    """The reference's per-axis 0.5 m stop box (MPPI_isaac.py:763)."""
    d = torch.abs(positions - goals)
    return (d[..., 0] <= box) & (d[..., 1] <= box)
