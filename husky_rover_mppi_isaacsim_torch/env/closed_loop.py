"""Full-stack closed loop: MPPI controllers driving simulated rovers.

Counterpart of ``husky_rover_mppi_isaacsim_tpu/env/closed_loop.py``, the
env-step semantics of ``visual_terrain_stack_full_terrain.py:466-541``
vectorized over N rovers:

* MPPI runs every sim step, but wheel commands are latched every 3rd step
  (``if i % 3 == 0``, :477-483) and the PI integrator resets at each latch;
* a per-step PI trim on the latched commands from the measured yaw rate
  (:500-508);
* the controller's wheel-speed feedback is the stored *commanded* speeds,
  not the measured ones (:513-515);
* adaptive exploration stds ``max(0.25, 0.25 -/+ yaw^2/3)`` (:510-511).

One sim step is one batched :func:`..mppi.controller.mppi_step` for all N
rovers (two K1 launches on the card: N x K samples and N optimal rollouts)
plus one physics step. The step index is a 0-d int32 on the rovers' device,
as in the JAX package, and the latch a ``torch.where`` on it, so the step
reads nothing back and has one fixed sequence of operations: on the card
:func:`run_episode` replays it as one CUDA graph per step
(:class:`..core.graphs.Graphed`, the JAX ``lax.scan`` body), its step key
an input of the graph. The draws are JAX's: ``k_noise, k_phys =
split(key)``, the noise from ``k_noise`` and the wheel slip from ``k_phys``
(JAX ``closed_loop.py:125-128``), three ``jax_normal`` launches inside the
step's graph on the card. It syncs the host not at all.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
from torch import Tensor

from ..core import jax_random as jr
from ..core import trace
from ..core.graphs import Graphed
from ..core.heightfield import HeightField
from ..mppi.controller import ControllerState, MPPIConfig, RobotState, mppi_step
from ..mppi.critics import Costmap
from ..ops.jax_normal_cuda import jax_normal
from . import rover_sim
from .rover_sim import RoverParams, RoverState


@dataclasses.dataclass(frozen=True)
class ClosedLoopConfig:
    """Static closed-loop parameters (visual_terrain_stack semantics)."""

    mppi: MPPIConfig = MPPIConfig()
    rover: RoverParams = RoverParams()
    latch_every: int = 3          # new wheel command every 3 sim steps (:477)
    pi_kp: float = 1.0 / 20.0     # err/20 (:507-508)
    pi_ki: float = 1.0 / 39.0     # total_err/39
    std_base: float = 0.25        # adaptive-std constants of the full stack
    std_gain: float = 1.0 / 3.0   # (:510-511)


class LoopState(NamedTuple):
    """Per-rover closed-loop state (leading axis = rover)."""

    rovers: RoverState
    ctrl: ControllerState          # batched: every field (N, ...)
    latched_left: Tensor           # (N,) latched wheel command
    latched_right: Tensor
    stored_left: Tensor            # (N,) commanded speeds fed back to MPPI
    stored_right: Tensor
    err_total: Tensor              # (N,) PI integrator
    step_index: Tensor             # () int32, sim steps taken


def init_loop_state(config: ClosedLoopConfig, rovers: RoverState,
                    dtype=torch.float32) -> LoopState:
    """Controllers at rest (zero optimal inputs, stds at ``std_base``) for
    every rover, on the rovers' device."""
    n = rovers.position.shape[0]
    dev = rovers.position.device
    ctrl = ControllerState.create(config.mppi, dtype, dev)
    full = lambda v: torch.full((n,), v, dtype=dtype, device=dev)  # noqa: E731
    ctrl = ControllerState(
        optimal_u1=ctrl.optimal_u1.repeat(n, 1),
        optimal_u2=ctrl.optimal_u2.repeat(n, 1),
        std_u1=full(config.std_base),  # the full stack starts at std_base
        std_u2=full(config.std_base),
    )
    return LoopState(rovers=rovers, ctrl=ctrl, latched_left=full(0.0),
                     latched_right=full(0.0), stored_left=full(0.0),
                     stored_right=full(0.0), err_total=full(0.0),
                     step_index=torch.zeros((), dtype=torch.int32, device=dev))


K_NOISE = (("split", 2, 0),)  # k_noise of `k_noise, k_phys = split(key)`
K_PHYS = (("split", 2, 1),)


def step_noise(key: Tensor, config: MPPIConfig, n: int, dtype=torch.float32,
               key_path: tuple = ()) -> Tensor:
    """One step's exploration noise ``(N, 2, K, H)`` from the step's key
    (``key`` taken down ``key_path``), drawn as the JAX package draws and
    lays it out: ``normal(k_noise, (2, N*K, H))`` reshaped to ``(2, N, K,
    H)``, rover axis moved first (``closed_loop.py:125-128``); one
    ``jax_normal`` launch on the card."""
    k, h = config.num_samples, config.horizon
    draw = jax_normal(key, (2, n * k, h), dtype, path=tuple(key_path) + K_NOISE)
    return draw.reshape(2, n, k, h).permute(1, 0, 2, 3)


def closed_loop_step(
    config: ClosedLoopConfig,
    hf: HeightField,
    costmap: Costmap,
    goals: Tensor,
    state: LoopState,
    key: Tensor,
    key_path: tuple = (),
) -> LoopState:
    """One sim step of the full stack for all N rovers: MPPI step ->
    wheel commands -> latch every ``latch_every``-th -> PI trim from the
    measured yaw rate -> physics step -> adapted stds.

    ``key`` taken down ``key_path`` (:func:`..core.jax_random.derive`; a
    caller that carries a key passes it and the path to the step's key) is
    the step's JAX key: ``k_noise, k_phys = split(key)``, the
    noise from ``k_noise`` (:func:`step_noise`) and the wheel slip from
    ``k_phys`` when ``config.rover.slip_std > 0``."""
    mcfg = config.mppi
    n = state.rovers.position.shape[0]
    trace.mark("noise")
    noise = step_noise(key, mcfg, n, state.rovers.position.dtype, key_path)

    robot_view = RobotState(position=state.rovers.position, z=state.rovers.z,
                            heading=state.rovers.heading, left_wheel_speed=state.stored_left,
                            right_wheel_speed=state.stored_right)
    new_ctrl, out = mppi_step(mcfg, hf, costmap, goals, robot_view, state.ctrl, noise)
    trace.mark("physics")

    # wheel commands from the optimal (v, w) (:474-475)
    lin_cmd, ang_cmd = out.linear_velocity, out.angular_velocity
    left_stored = lin_cmd - ang_cmd * mcfg.robot_radius / 2
    right_stored = lin_cmd + ang_cmd * mcfg.robot_radius / 2

    # latch every `latch_every` steps, resetting the PI integrator (:477-483)
    latch = (state.step_index % config.latch_every) == 0
    latched_left = torch.where(latch, left_stored, state.latched_left)
    latched_right = torch.where(latch, right_stored, state.latched_right)
    err_total = torch.where(latch, torch.zeros_like(state.err_total), state.err_total)

    # PI yaw-rate trim on the latched commands (:500-508)
    err = state.rovers.yaw_rate - ang_cmd
    err_total = err_total + err
    trim = err * config.pi_kp + err_total * config.pi_ki
    rovers = rover_sim.step(config.rover, hf, state.rovers, latched_left + trim,
                            latched_right - trim, key=key, path=tuple(key_path) + K_PHYS)

    # adaptive stds from the measured yaw rate (:510-511)
    yaw2 = rovers.yaw_rate * rovers.yaw_rate
    base = config.std_base
    new_ctrl = new_ctrl._replace(
        std_u1=torch.clamp(base - yaw2 * config.std_gain, min=base),
        std_u2=torch.clamp(base + yaw2 * config.std_gain, min=base),
    )
    return LoopState(rovers=rovers, ctrl=new_ctrl, latched_left=latched_left,
                     latched_right=latched_right, stored_left=left_stored,
                     stored_right=right_stored, err_total=err_total,
                     step_index=state.step_index + 1)


def run_episode(
    config: ClosedLoopConfig,
    hf: HeightField,
    costmap: Costmap,
    goals: Tensor,
    state: LoopState,
    key: Tensor,
    num_steps: int,
    record_every: int = 1,
    step_fn: Callable | None = None,
) -> tuple[LoopState, Tensor]:
    """Run ``num_steps`` sim steps with no host sync. Returns the final
    state and the rover positions after steps 0, r, 2r, ... (r =
    ``record_every``), ``(ceil(num_steps / r), N, 2)``: the JAX
    ``path[::record_every]``. Step ``i`` runs on ``split(key,
    num_steps)[i]`` (JAX ``closed_loop.py:193``).

    ``step_fn`` runs one step: by default a new
    :class:`..core.graphs.Graphed` :func:`closed_loop_step` (one CUDA graph
    replay a step on the card, the eager step on the CPU);
    :func:`closed_loop_step` itself runs the steps eagerly on the card (the
    reference the graph is held against). The final state is cloned out of
    the graph's buffers."""
    n = state.rovers.position.shape[0]
    pos = state.rovers.position
    path = torch.empty((-(-num_steps // record_every), n, 2), dtype=pos.dtype,
                       device=pos.device)
    if step_fn is None:
        step_fn = Graphed(closed_loop_step)
    keys = jr.split(key, num_steps)
    for i in range(num_steps):
        state = step_fn(config, hf, costmap, goals, state, keys[i])
        if i % record_every == 0:
            path[i // record_every] = state.rovers.position
    return clone_state(state), path


def clone_state(state: LoopState) -> LoopState:
    """A copy of every tensor of ``state`` (a graph's outputs are
    overwritten by its next replay)."""
    return LoopState(RoverState(*(t.clone() for t in state.rovers)),
                     ControllerState(*(t.clone() for t in state.ctrl)),
                     *(t.clone() for t in state[2:]))
