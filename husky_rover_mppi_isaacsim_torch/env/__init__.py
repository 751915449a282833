"""Vectorized rover environment, the N-rover closed loop, the controller
frames, the streamed-terrain loop and the named-robot registry (counterpart
of the JAX ``env``)."""

from . import frames

from .closed_loop import (
    ClosedLoopConfig,
    LoopState,
    clone_state,
    closed_loop_step,
    init_loop_state,
    run_episode,
    step_noise,
)
from .largescale_loop import LargeScaleClosedLoop, LargeScaleLoopConf, LargeScaleRunResult
from .metrics import goal_distances, path_metrics, success_mask
from .robot_manager import RobotManager, RobotSpec
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
    "clone_state",
    "closed_loop_step",
    "init_loop_state",
    "run_episode",
    "step_noise",
    "frames",
    "LargeScaleClosedLoop",
    "LargeScaleLoopConf",
    "LargeScaleRunResult",
    "goal_distances",
    "path_metrics",
    "success_mask",
    "RobotManager",
    "RobotSpec",
    "RoverParams",
    "RoverState",
    "contact_forces",
    "reset_mask",
    "step",
    "teleport",
    "wheel_contact_forces",
]
