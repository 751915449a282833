"""MPPI input sampling: receding-horizon perturbation of the optimal sequence.

Counterpart of ``husky_rover_mppi_isaacsim_tpu/mppi/sampling.py``
(sampling_warp.py:54-92). :func:`perturb` is pure given the noise, so tests
may inject one numpy noise array into both packages; :func:`sample_noise`
draws the production noise from a JAX key (:mod:`..core.jax_random`), the
JAX package's draw from the same key: on the card one launch of the
``jax_normal`` kernel (:mod:`..ops.jax_normal_cuda`), on the CPU its plain
version. :func:`loop_key` is the JAX package's per-loop key.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

from ..core import jax_random as jr
from ..ops.jax_normal_cuda import jax_normal


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


def sample_noise(key: Tensor, num_samples: int, horizon: int, dtype=torch.float32,
                 path: tuple = ()) -> Tensor:
    """Standard-normal noise of shape ``(2, K, H)`` on the key's device:
    ``jax.random.normal(key, (2, K, H), dtype)`` (JAX ``sampling.py:75-78``)
    of the key taken down ``path`` (:func:`..core.jax_random.derive`)."""
    return jax_normal(key, (2, num_samples, horizon), dtype, path=path)


def sample_noise_block(key: Tensor, num_samples: int, horizon: int, start: int, stop: int,
                       dtype=torch.float32) -> Tensor:
    """The samples ``start:stop`` of :func:`sample_noise`'s ``(2, K, H)``,
    ``(2, stop - start, H)``, drawn alone: their iota counts are those of
    the full draw (the kernel's count offset), so a rank's or a rover's
    block equals the slice of the whole."""
    shape, offset, outer_stride = jr.slice_counts((2, num_samples, horizon), 1, start, stop)
    draw = jax_normal(key, shape, dtype, offset=offset, outer_stride=outer_stride)
    return draw.reshape(2, stop - start, horizon)


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


def loop_key(base_key: Tensor, loop_seed: int) -> Tensor:
    """Key for one control loop, derived from the replayable loop seed
    (JAX ``sampling.py:98-100``)."""
    return jr.fold_in(base_key, loop_seed)
