"""Shared float64 helpers of the worldbuilders: host draws onto the device,
scalars as 0-d device tensors, and scipy's extrinsic Euler quaternions.

A division by a Python float on the card is a multiply by its reciprocal;
every division by a scalar here divides by a 0-d tensor on the device (a
true division, as numpy's)."""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

F64 = torch.float64


def f64(x, device) -> Tensor:
    """Host values (a numpy draw, a list) as float64 on ``device``."""
    if isinstance(x, Tensor):
        return x.to(device=device, dtype=F64)
    return torch.as_tensor(np.asarray(x, np.float64), device=device)


def scalar(x, device, dtype=F64) -> Tensor:
    """``x`` as a 0-d tensor on ``device``."""
    return torch.full((), x, dtype=dtype, device=device)


def _elementary_quat(axis: int, angle: Tensor) -> Tensor:
    """scipy's ``_make_elementary_quat``: xyzw, cos and sin of half the
    angle."""
    quat = torch.zeros(angle.shape + (4,), dtype=angle.dtype, device=angle.device)
    quat[..., 3] = torch.cos(angle / 2.0)
    quat[..., axis] = torch.sin(angle / 2.0)
    return quat


def _compose_quat(p: Tensor, q: Tensor) -> Tensor:
    """scipy's ``compose_quat`` (xyzw), its products in its order."""
    c0 = p[..., 1] * q[..., 2] - p[..., 2] * q[..., 1]
    c1 = p[..., 2] * q[..., 0] - p[..., 0] * q[..., 2]
    c2 = p[..., 0] * q[..., 1] - p[..., 1] * q[..., 0]
    qx = p[..., 3] * q[..., 0] + q[..., 3] * p[..., 0] + c0
    qy = p[..., 3] * q[..., 1] + q[..., 3] * p[..., 1] + c1
    qz = p[..., 3] * q[..., 2] + q[..., 3] * p[..., 2] + c2
    qw = p[..., 3] * q[..., 3] - p[..., 0] * q[..., 0] - p[..., 1] * q[..., 1] \
        - p[..., 2] * q[..., 2]
    return torch.stack([qx, qy, qz, qw], dim=-1)


def quat_from_extrinsic_euler(seq: str, angles: Tensor) -> Tensor:
    """``Rotation.from_euler(seq, angles).as_quat()`` for an extrinsic
    (lower-case) ``seq`` in radians: xyzw, not made canonical (w may be
    negative, as scipy returns it)."""
    axes = ["xyz".index(a) for a in seq]
    quat = _elementary_quat(axes[0], angles[..., 0])
    for i in range(1, len(axes)):
        quat = _compose_quat(_elementary_quat(axes[i], angles[..., i]), quat)
    return quat
