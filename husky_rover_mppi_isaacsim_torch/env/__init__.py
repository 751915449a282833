"""Vectorized rover environment and the N-rover closed loop (counterpart of
the JAX ``env``; its large-scale loop, robot manager and frames are not
ported yet)."""

from .closed_loop import (
    ClosedLoopConfig,
    LoopState,
    closed_loop_step,
    init_loop_state,
    loop_noise,
    run_episode,
)
from .metrics import goal_distances, path_metrics, success_mask
from .rover_sim import (
    RoverParams,
    RoverState,
    contact_forces,
    reset_mask,
    step,
    teleport,
    wheel_contact_forces,
)

__all__ = [
    "ClosedLoopConfig",
    "LoopState",
    "closed_loop_step",
    "init_loop_state",
    "loop_noise",
    "run_episode",
    "goal_distances",
    "path_metrics",
    "success_mask",
    "RoverParams",
    "RoverState",
    "contact_forces",
    "reset_mask",
    "step",
    "teleport",
    "wheel_contact_forces",
]
