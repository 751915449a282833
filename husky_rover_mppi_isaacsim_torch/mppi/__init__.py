"""The MPPI controller (counterpart of the JAX ``mppi``)."""

from .controller import (
    ControllerState,
    GoalSeekResult,
    GoalSeekTrace,
    MPPIConfig,
    MPPIController,
    RobotState,
    StepOutput,
    goal_seek,
    goal_seek_recorded,
    kinematic_advance,
    masked_steps,
    mppi_step,
)
from .critics import Costmap, CriticWeights, evaluate_trajectories
from .reference_rollout import rollout_25d_reference
from .rollout import Rollout, rollout_2d, rollout_25d
from .sampling import InputLimits, LoopSeedSequence, loop_key, perturb, sample_noise
