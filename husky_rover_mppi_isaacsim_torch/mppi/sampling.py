"""MPPI input sampling: receding-horizon perturbation of the optimal sequence.

Counterpart of ``husky_rover_mppi_isaacsim_tpu/mppi/sampling.py``
(sampling_warp.py:54-92). :func:`perturb` is pure given the noise, so tests
inject one numpy noise array into both packages; :func:`sample_noise` draws
the production noise from an explicit ``torch.Generator`` (torch cannot
reproduce JAX's threefry stream, so the two packages' draws differ).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor


class InputLimits(NamedTuple):
    """Per-channel perturbation parameters (config.yaml:18-24)."""

    std_u1: float = 0.25
    min_u1: float = -1.0
    max_u1: float = 1.0
    std_u2: float = 0.25
    min_u2: float = -1.0
    max_u2: float = 1.0


def shift_receding(optimal_u: Tensor) -> Tensor:
    """Shift one step forward along the last (horizon) axis, repeating the
    last entry (sampling_warp.py:71-92)."""
    return torch.cat([optimal_u[..., 1:], optimal_u[..., -1:]], dim=-1)


def perturb(
    optimal_u1: Tensor, optimal_u2: Tensor, noise: Tensor,
    std_u1: Tensor, std_u2: Tensor, limits: InputLimits,
) -> tuple[Tensor, Tensor]:
    """Clamped perturbed inputs ``(u1, u2)``, each ``(K, H)``, from the
    ``(H,)`` previous optimum, ``()`` stds and ``(2, K, H)`` standard-normal
    noise; with a leading rover axis ``(N, H)``, ``(N,)`` and
    ``(N, 2, K, H)`` -> ``(N, K, H)``."""
    base1 = shift_receding(optimal_u1)
    base2 = shift_receding(optimal_u2)
    u1 = torch.clamp(base1[..., None, :] + std_u1[..., None, None] * noise[..., 0, :, :],
                     limits.min_u1, limits.max_u1)
    u2 = torch.clamp(base2[..., None, :] + std_u2[..., None, None] * noise[..., 1, :, :],
                     limits.min_u2, limits.max_u2)
    return u1, u2


def sample_noise(generator: torch.Generator, num_samples: int, horizon: int,
                 dtype=torch.float32, device=None) -> Tensor:
    """Standard-normal noise of shape ``(2, K, H)``; ``generator`` must live
    on ``device``."""
    return torch.randn((2, num_samples, horizon), generator=generator,
                       dtype=dtype, device=device)


class LoopSeedSequence:
    """Mirror of the reference's per-loop seed stream
    ``np.random.default_rng(42).integers(H+1, 1000)`` (MPPI_isaac.py:409, 517),
    the same numpy stream as the JAX package's class."""

    def __init__(self, horizon: int, seed: int = 42):
        self._rng = np.random.default_rng(seed)
        self._low = horizon + 1
        self._high = 1000

    def next_seed(self) -> int:
        return int(self._rng.integers(self._low, self._high))
