"""Husky skid-steer dynamics: first-order wheel-speed lag + diff-drive map.

Counterpart of ``husky_rover_mppi_isaacsim_tpu/dynamics/skid_steer.py``
(sampling_warp.py:96-139)::

    w_t   = a * w_{t-1} + k * (1 - a) * u_t          (per wheel, unclamped)
    v_t   = clamp((w_l + w_r) / 2,       v_min, v_max)
    omega = clamp((-w_l + w_r) / track,  w_min, w_max)

:func:`wheel_lag_scan` is the exact sequential form; :func:`wheel_lag_matmul`
the same linear recurrence as one lower-triangular Toeplitz matmul, which
differs only in summation order. Both take a leading rover axis: inputs
``(N, K, H)`` with wheel speeds ``(N,)``, rover ``n``'s speeds applying to
its K samples, as under the JAX package's ``jax.vmap`` over rovers.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from ..core.geometry import align_leading


class DiffDriveLimits(NamedTuple):
    """Velocity clamps (config.yaml:10-16)."""

    v_min: float = 0.0
    v_max: float = 2.0
    w_min: float = -1.0
    w_max: float = 1.0


def require_full_fp32_matmul(t: Tensor) -> None:
    """Raise unless a float32 CUDA matmul runs in full float32.

    TF32 keeps ~3 decimal digits and would drift every commanded velocity
    and optimal input from the reference (the twin of the JAX package's
    ``precision=HIGHEST``). Entry points set ``allow_tf32 = False`` and
    ``set_float32_matmul_precision("highest")``."""
    if t.is_cuda and t.dtype == torch.float32 and (
            torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "float32 matmuls must run in full precision: set "
            "torch.backends.cuda.matmul.allow_tf32 = False and "
            "torch.set_float32_matmul_precision('highest')")


def _to_velocities(w_left, w_right, track, limits: DiffDriveLimits):
    lin = torch.clamp((w_left + w_right) / 2.0, limits.v_min, limits.v_max)
    ang = torch.clamp((-w_left + w_right) / track, limits.w_min, limits.w_max)
    return lin, ang


def wheel_lag_scan(
    u1: Tensor, u2: Tensor, left0, right0, track,
    limits: DiffDriveLimits, k: float, a: float,
) -> tuple[Tensor, Tensor]:
    """Exact sequential wheel-lag conversion of ``(..., H)`` wheel inputs;
    ``left0``/``right0`` line up with the leading axes of the batch."""
    batch = u1.shape[:-1]
    left = align_leading(left0, u1, len(batch)).expand(batch)
    right = align_leading(right0, u1, len(batch)).expand(batch)
    wl, wr = [], []
    for t in range(u1.shape[-1]):
        left = left * a + u1[..., t] * k * (1.0 - a)
        right = right * a + u2[..., t] * k * (1.0 - a)
        wl.append(left)
        wr.append(right)
    return _to_velocities(torch.stack(wl, -1), torch.stack(wr, -1), track, limits)


def lag_matrix(horizon: int, k: float, a: float, dtype, device=None) -> Tensor:
    """Lower-triangular Toeplitz kernel ``L[t, s] = k(1-a) a^(t-s)``, s <= t."""
    t = torch.arange(horizon, device=device)
    expo = t[:, None] - t[None, :]
    powers = torch.pow(torch.full((), a, dtype=dtype, device=device),
                       expo.clamp(min=0).to(dtype))
    mat = torch.where(expo >= 0, powers, torch.zeros((), dtype=dtype, device=device))
    return mat * (k * (1.0 - a))


def wheel_lag_matmul(
    u1: Tensor, u2: Tensor, left0, right0, track,
    limits: DiffDriveLimits, k: float, a: float,
) -> tuple[Tensor, Tensor]:
    """Toeplitz-matmul form of :func:`wheel_lag_scan` (a plain ``torch.matmul``)."""
    require_full_fp32_matmul(u1)
    horizon = u1.shape[-1]
    dt, dev = u1.dtype, u1.device
    lag = lag_matrix(horizon, k, a, dt, dev)
    decay = torch.pow(torch.full((), a, dtype=dt, device=dev),
                      torch.arange(1, horizon + 1, dtype=dt, device=dev))
    l0 = align_leading(left0, u1, u1.ndim)
    r0 = align_leading(right0, u1, u1.ndim)
    wl = l0 * decay + torch.matmul(u1, lag.T)
    wr = r0 * decay + torch.matmul(u2, lag.T)
    return _to_velocities(wl, wr, track, limits)


def inverse_diff_drive(lin: Tensor, ang: Tensor, track) -> tuple[Tensor, Tensor]:
    """Wheel speeds realizing (v, omega) (MPPI_isaac.py:783-784)."""
    half = ang * track / 2.0
    return lin - half, lin + half
