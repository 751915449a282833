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
(:class:`..core.graphs.Graphed`, the JAX ``lax.scan`` body), its noise and
slip drawn outside the graph (:func:`draw_step_noise`) from the same
generator calls as the eager step's. It syncs the host not at all.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
from torch import Tensor

from ..core.graphs import Graphed
from ..core.heightfield import HeightField
from ..mppi.controller import ControllerState, MPPIConfig, RobotState, mppi_step
from ..mppi.critics import Costmap
from ..mppi.sampling import sample_noise
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


def loop_noise(generator: torch.Generator, config: MPPIConfig, n: int, dtype=torch.float32,
               device=None) -> Tensor:
    """One step's exploration noise ``(N, 2, K, H)``, drawn as the JAX
    package lays it out: ``(2, N*K, H)`` reshaped to ``(2, N, K, H)``, rover
    axis moved first (``closed_loop.py:126-128``)."""
    k, h = config.num_samples, config.horizon
    draw = sample_noise(generator, n * k, h, dtype, device)
    return draw.reshape(2, n, k, h).permute(1, 0, 2, 3)


def draw_step_noise(config: ClosedLoopConfig, generator: torch.Generator | None, n: int,
                    dtype=torch.float32, device=None, noise: Tensor | None = None
                    ) -> tuple[Tensor, Tensor | None]:
    """The draws of one :func:`closed_loop_step` of ``n`` rovers, made as
    the eager step makes them, in its order: the exploration noise
    (:func:`loop_noise`, unless ``noise`` is given), then the ``(2, n)``
    wheel-slip normals where ``config.rover.slip_std > 0`` (else ``None``).
    A graphed step takes both as inputs."""
    if generator is None and (noise is None or config.rover.slip_std > 0.0):
        raise ValueError("a closed-loop step needs a generator: for the noise unless it is "
                         "given, and for the wheel slip when slip_std > 0")
    if noise is None:
        noise = loop_noise(generator, config.mppi, n, dtype, device)
    slip = None
    if config.rover.slip_std > 0.0:
        slip = torch.randn((2, n), generator=generator, dtype=dtype, device=device)
    return noise, slip


def closed_loop_step(
    config: ClosedLoopConfig,
    hf: HeightField,
    costmap: Costmap,
    goals: Tensor,
    state: LoopState,
    generator: torch.Generator | None = None,
    noise: Tensor | None = None,
    slip_normals: Tensor | None = None,
) -> LoopState:
    """One sim step of the full stack for all N rovers: MPPI step ->
    wheel commands -> latch every ``latch_every``-th -> PI trim from the
    measured yaw rate -> physics step -> adapted stds.

    ``noise`` (N, 2, K, H) replays given draws (tests replay JAX's); else
    it comes from ``generator`` (:func:`loop_noise`), which also draws the
    physics slip when ``config.rover.slip_std > 0`` unless ``slip_normals``
    ``(2, N)`` are given (:func:`draw_step_noise` makes both draws)."""
    mcfg = config.mppi
    n = state.rovers.position.shape[0]
    dtype, dev = state.rovers.position.dtype, state.rovers.position.device
    draws = noise is None or (config.rover.slip_std > 0.0 and slip_normals is None)
    if generator is None and draws:
        raise ValueError("closed_loop_step needs a generator: for the noise unless "
                         "it is given, and for the wheel slip when slip_std > 0 unless "
                         "slip_normals are given")
    if noise is None:
        noise = loop_noise(generator, mcfg, n, dtype, dev)

    robot_view = RobotState(position=state.rovers.position, z=state.rovers.z,
                            heading=state.rovers.heading, left_wheel_speed=state.stored_left,
                            right_wheel_speed=state.stored_right)
    new_ctrl, out = mppi_step(mcfg, hf, costmap, goals, robot_view, state.ctrl, noise)

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
                            latched_right - trim, generator=generator,
                            slip_normals=slip_normals)

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
    generator: torch.Generator | None,
    num_steps: int,
    record_every: int = 1,
    noise_source: Callable[[], Tensor] | None = None,
    step_fn: Callable | None = None,
) -> tuple[LoopState, Tensor]:
    """Run ``num_steps`` sim steps with no host sync. Returns the final
    state and the rover positions after steps 0, r, 2r, ... (r =
    ``record_every``), ``(ceil(num_steps / r), N, 2)``: the JAX
    ``path[::record_every]``. Noise comes from ``noise_source()`` when
    given (tests replay a fixed sequence), else from ``generator``.

    ``step_fn`` runs one step: by default a new
    :class:`..core.graphs.Graphed` :func:`closed_loop_step` (one CUDA graph
    replay a step on the card, the eager step on the CPU);
    :func:`closed_loop_step` itself runs the steps eagerly on the card (the
    reference the graph is held against). The final state is cloned out of
    the graph's buffers."""
    n = state.rovers.position.shape[0]
    pos = state.rovers.position
    dtype, dev = pos.dtype, pos.device
    path = torch.empty((-(-num_steps // record_every), n, 2), dtype=pos.dtype,
                       device=pos.device)
    if step_fn is None:
        step_fn = Graphed(closed_loop_step)
    for i in range(num_steps):
        given = noise_source() if noise_source is not None else None
        noise, slip = draw_step_noise(config, generator, n, dtype, dev, noise=given)
        state = step_fn(config, hf, costmap, goals, state, None, noise, slip)
        if i % record_every == 0:
            path[i // record_every] = state.rovers.position
    return clone_state(state), path


def clone_state(state: LoopState) -> LoopState:
    """A copy of every tensor of ``state`` (a graph's outputs are
    overwritten by its next replay)."""
    return LoopState(RoverState(*(t.clone() for t in state.rovers)),
                     ControllerState(*(t.clone() for t in state.ctrl)),
                     *(t.clone() for t in state[2:]))
