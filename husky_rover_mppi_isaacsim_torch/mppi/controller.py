"""The MPPI controller: one control step and the goal-seek loops.

Counterpart of ``husky_rover_mppi_isaacsim_tpu/mppi/controller.py``
(MPPI_isaac.py:402-806). The rollout engine follows the device: on CUDA
tensors both rollouts of a step go through kernel K1
(:mod:`..ops.rollout_cuda`), and the 2D projection's sample rollout
through the planar rollout kernel (:mod:`..ops.rollout_2d_cuda`); on CPU
tensors through the plain :func:`.rollout.rollout_25d` and
:func:`.rollout.rollout_2d`. There is no engine switch in the config.

:func:`mppi_step` and :func:`kinematic_advance` also take N rovers at once:
every state field, the goal and the noise with a leading rover axis (the
JAX package's ``jax.vmap`` over rovers, ``env/closed_loop.py:131-132``).
The rover axis goes into K1's launch grid, so a step of N rovers is still
two launches.

:class:`MPPIController` is the host-side wrapper with the replayable
per-loop seed stream (JAX ``MPPIController``).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, ClassVar, NamedTuple

import numpy as np
import torch
from torch import Tensor

from ..core.device import run_device
from ..core.graphs import Graphed
from ..core.heightfield import HeightField
from ..dynamics.skid_steer import (
    DiffDriveLimits,
    inverse_diff_drive,
    wheel_lag_matmul,
    wheel_lag_scan,
)
from ..ops import rollout_2d_cuda, rollout_cuda
from . import critics as crit
from .critics import Costmap, CriticWeights
from .sampling import InputLimits, LoopSeedSequence, perturb, sample_noise


@dataclasses.dataclass(frozen=True)
class MPPIConfig:
    """Static controller configuration (config.yaml + MPPI_isaac.py:419-440),
    the JAX ``MPPIConfig`` without its TPU gather-engine and patch fields."""

    num_samples: int = 1000          # number_of_trajectories
    horizon: int = 100               # number_of_iterations
    dt: float = 0.045
    robot_radius: float = 1.2        # wheel track ("frame_work.robot_radius")
    temperature: float = 0.3
    limits: DiffDriveLimits = DiffDriveLimits()
    inputs: InputLimits = InputLimits()
    critic_weights: CriticWeights = CriticWeights()
    projection: str = "3d"           # "3d" | "2d" rollout for the samples
    # (k, a) wheel-lag constants: rollouts vs optimal sequence
    # (MPPI_isaac.py:548-549 / 688-689).
    rollout_lag: tuple = (3.5, 0.96)
    optimal_lag: tuple = (3.0, 0.92)
    # exploration-noise floor: sigma = max(b, b -/+ omega^2) after each loop
    # (MPPI_isaac.py:777-778)
    sigma_base: float = 0.4
    # "wheels": per-pair max of the wheel-track slopes (critics_warp.py:
    # 168-218); "body": body-trajectory slope (the thesis statistics runs)
    slope_critic: str = "wheels"
    exact: bool = False              # True: sequential wheel lag; False: Toeplitz matmul
    return_rollouts: bool = False    # include all K trajectories in the output

    # fields of the JAX MPPIConfig the port dropped: the TPU gather engines'
    # and patch fields, and two initial velocities no step reads; the
    # configuration loader refuses them by name
    TPU_ONLY_FIELDS: ClassVar[frozenset] = frozenset((
        "gather_engine", "patch_size", "costmap_patch_size", "chunk_patches", "pallas_block_k",
        "dem_resolution", "costmap_resolution", "initial_linear_velocity",
        "initial_angular_velocity"))

    def __post_init__(self):
        if self.projection not in ("3d", "2d"):
            raise ValueError(f"projection={self.projection!r} — must be '3d' or '2d'")
        if self.slope_critic not in ("wheels", "body"):
            raise ValueError(
                f"slope_critic={self.slope_critic!r} — must be 'wheels' or 'body'")

    @property
    def horizon_m(self) -> float:
        """Lookahead distance dt * v_max * H (MPPI_isaac.py:440)."""
        return self.dt * self.limits.v_max * self.horizon


# MPPIConfig fields that hold a NamedTuple, by field name
NESTED_CONFIG = {"limits": DiffDriveLimits, "inputs": InputLimits,
                 "critic_weights": CriticWeights}


class RobotState(NamedTuple):
    """Kinematic rover state (MPPI_isaac.py:381-400)."""

    position: Tensor          # (2,) x, y
    z: Tensor                 # () surface height
    heading: Tensor           # (3,) unit heading
    left_wheel_speed: Tensor  # ()
    right_wheel_speed: Tensor # ()

    @classmethod
    def create(cls, x, y, heading, dtype=torch.float32, device=None,
               wheel_speed: float = 0.0) -> "RobotState":
        """At ``(x, y)``, heading normalized, both wheels at ``wheel_speed``
        (the thesis protocol starts rolling at 1 m/s, MPPI_OO_current.py
        Robot init)."""
        heading = torch.as_tensor(heading, dtype=dtype, device=device)
        heading = heading / torch.linalg.norm(heading)
        full = lambda v: torch.full((), v, dtype=dtype, device=device)  # noqa: E731
        return cls(
            position=torch.tensor([x, y], dtype=dtype, device=device),
            z=full(0.0),
            heading=heading,
            left_wheel_speed=full(wheel_speed),
            right_wheel_speed=full(wheel_speed),
        )


class ControllerState(NamedTuple):
    """Persistent controller memory across control loops."""

    optimal_u1: Tensor  # (H,)
    optimal_u2: Tensor  # (H,)
    std_u1: Tensor      # (), adapted online (MPPI_isaac.py:777-778)
    std_u2: Tensor      # ()

    @classmethod
    def create(cls, config: MPPIConfig, dtype=torch.float32, device=None,
               initial_u: float = 0.0) -> "ControllerState":
        h = config.horizon
        return cls(
            optimal_u1=torch.full((h,), initial_u, dtype=dtype, device=device),
            optimal_u2=torch.full((h,), initial_u, dtype=dtype, device=device),
            std_u1=torch.tensor(config.inputs.std_u1, dtype=dtype, device=device),
            std_u2=torch.tensor(config.inputs.std_u2, dtype=dtype, device=device),
        )


class StepOutput(NamedTuple):
    """Result of one control step."""

    linear_velocity: Tensor     # (): optimal v for the next command
    angular_velocity: Tensor    # (): optimal omega
    optimal_trajectory: Tensor  # (H, 3)
    optimal_headings: Tensor    # (H, 3)
    optimal_linear: Tensor      # (H,)
    optimal_angular: Tensor     # (H,)
    costs: Tensor               # (K,)
    weights: Tensor             # (K,)
    rollouts: Tensor | None     # (K, H, 3) when config.return_rollouts


def mppi_step(
    config: MPPIConfig, hf: HeightField, costmap: Costmap, goal: Tensor,
    robot: RobotState, ctrl: ControllerState, noise: Tensor,
    reduce: Callable[[Tensor, str], None] | None = None,
) -> tuple[ControllerState, StepOutput]:
    """One MPPI control step (MPPI_isaac.py:505-752): perturb -> wheel lag ->
    K rollouts -> critics -> softmax weights -> weighted inputs -> optimal
    wheel lag -> optimal rollout.

    Unbatched: ``goal`` (2,), the state fields as in :class:`RobotState` and
    :class:`ControllerState`, ``noise`` (2, K, H). For N rovers: ``goal``
    (N, 2), every state field with a leading (N,), ``noise`` (N, 2, K, H);
    every output then leads with (N,).

    ``reduce(t, op)``, where given, combines the step's sample reductions
    in place across the holders of the other samples: the cost minimum
    (``op="min"``), then the total weight and the two weighted input sums
    (``op="sum"``), in that order (:mod:`..parallel.mesh`'s all-reduces).
    Costs and weights are then this holder's samples only."""
    wheel_lag = wheel_lag_scan if config.exact else wheel_lag_matmul
    dtype, dev = noise.dtype, noise.device
    # torch.full, not torch.tensor: a host-to-device copy would sync the stream
    track = torch.full((), config.robot_radius, dtype=dtype, device=dev)
    horizon_m = torch.full((), config.horizon_m, dtype=dtype, device=dev)

    # 1. receding-horizon input perturbation (sampling_warp.py:54-92)
    u1, u2 = perturb(ctrl.optimal_u1, ctrl.optimal_u2, noise,
                     ctrl.std_u1, ctrl.std_u2, config.inputs)

    # 2. inputs -> wheel velocities -> (v, omega) (sampling_warp.py:96-139)
    k_r, a_r = config.rollout_lag
    lin, ang = wheel_lag(u1, u2, robot.left_wheel_speed, robot.right_wheel_speed,
                         track, config.limits, k_r, a_r)

    # 3. K rollouts (projection_warp.py:284-350)
    if config.projection == "2d":
        traj, _ = rollout_2d_cuda.rollout_2d_cuda(hf, robot.position, robot.heading, lin, ang,
                                                  config.dt)
        lw = rw = traj  # no wheel tracks: the wheel critic degrades to body
    else:
        # body-slope mode never reads the wheel tracks: K1 skips them and
        # returns lw = rw = traj, the body critic form (:404-407)
        traj, _, lw, rw = rollout_cuda.rollout_25d_cuda(
            hf, robot.position, robot.heading, lin, ang, config.dt,
            wheels=config.slope_critic == "wheels")

    # 4. critic stack (critics_warp.py:302-329)
    costs = crit.evaluate_trajectories(
        robot.position[..., 0], robot.position[..., 1], goal, traj, lw, rw, lin,
        torch.full((), config.limits.v_max, dtype=dtype, device=dev), costmap,
        horizon_m, config.critic_weights)

    # 5. importance weights + weighted optimal inputs (critics_warp.py:338-376)
    min_cost = torch.amin(costs, dim=-1, keepdim=True)
    if reduce is not None:
        reduce(min_cost, "min")
    weights = crit.softmax_weights(costs, config.temperature, min_cost)
    total, sum1, sum2 = crit.weighted_sums(weights, u1, u2)
    if reduce is not None:
        for t in (total, sum1, sum2):
            reduce(t, "sum")
    opt_u1, opt_u2 = sum1 / total, sum2 / total

    # 6. optimal-sequence conversion, softer lag (MPPI_isaac.py:672-692)
    k_o, a_o = config.optimal_lag
    opt_lin, opt_ang = wheel_lag(opt_u1[..., None, :], opt_u2[..., None, :],
                                 robot.left_wheel_speed, robot.right_wheel_speed, track,
                                 config.limits, k_o, a_o)
    opt_lin, opt_ang = opt_lin[..., 0, :], opt_ang[..., 0, :]

    # 7. optimal rollout: always 3D, wheel tracks never read
    #    (MPPI_isaac.py:696-720)
    opt = rollout_cuda.rollout_25d_cuda(hf, robot.position, robot.heading,
                                        opt_lin[..., None, :], opt_ang[..., None, :],
                                        config.dt, wheels=False)

    b = config.sigma_base
    sq = opt_ang[..., 0] * opt_ang[..., 0]
    new_ctrl = ControllerState(
        optimal_u1=opt_u1,
        optimal_u2=opt_u2,
        std_u1=torch.clamp(b - sq, min=b),
        std_u2=torch.clamp(b + sq, min=b),
    )
    out = StepOutput(
        linear_velocity=opt_lin[..., 0],
        angular_velocity=opt_ang[..., 0],
        optimal_trajectory=opt.trajectory[..., 0, :, :],
        optimal_headings=opt.headings[..., 0, :, :],
        optimal_linear=opt_lin,
        optimal_angular=opt_ang,
        costs=costs,
        weights=weights,
        rollouts=traj if config.return_rollouts else None,
    )
    return new_ctrl, out


def kinematic_advance(config: MPPIConfig, robot: RobotState, out: StepOutput) -> RobotState:
    """Advance to the first waypoint of the optimal rollout
    (MPPI_isaac.py:769-784), for one rover or a leading rover axis."""
    track = torch.full((), config.robot_radius, dtype=out.linear_velocity.dtype,
                       device=out.linear_velocity.device)
    left, right = inverse_diff_drive(out.linear_velocity, out.angular_velocity, track)
    return RobotState(
        position=out.optimal_trajectory[..., 0, :2],
        z=out.optimal_trajectory[..., 0, 2],
        heading=out.optimal_headings[..., 0, :],
        left_wheel_speed=left,
        right_wheel_speed=right,
    )


NoiseSource = Callable[[], Tensor]


class GoalSeekResult(NamedTuple):
    robot: RobotState
    ctrl: ControllerState
    loops: Tensor    # () active control loops
    reached: Tensor  # () bool
    steps: int       # control steps computed, masked ones included


class GoalSeekTrace(NamedTuple):
    """Recorded goal-seek episode."""

    robot: RobotState
    ctrl: ControllerState
    loops: Tensor
    reached: Tensor
    steps: int
    positions: Tensor   # (max_loops, 3), valid up to ``loops``
    velocities: Tensor  # (max_loops,) commanded linear velocity per loop


def goal_seek(
    config: MPPIConfig, hf: HeightField, costmap: Costmap, goal: Tensor,
    robot: RobotState, ctrl: ControllerState, generator: torch.Generator | None,
    max_loops: int = 3500, unroll: int = 4, noise_source: NoiseSource | None = None,
    steps_fn: Callable | None = None,
) -> GoalSeekResult:
    """Goal-seeking loop (MPPI_Controller.run, MPPI_isaac.py:755-806): stop
    when |dx| <= 0.5 and |dy| <= 0.5, or after ``max_loops`` loops.

    Runs ``unroll`` masked control steps between host syncs of the stop
    flag; steps after the stop leave the state frozen, so results equal a
    one-step loop. Noise comes from ``noise_source()`` when given (tests
    replay a fixed sequence), else from ``generator``, drawn before each
    ``unroll`` steps in the order the steps use it.

    ``steps_fn`` runs the ``unroll`` steps: by default a new
    :class:`..core.graphs.Graphed` of :func:`masked_steps` (one CUDA graph
    replay on the card, the eager function on the CPU); a caller that
    replays one graph across episodes passes its own, and
    :func:`masked_steps` itself runs the steps eagerly on the card (the
    reference the graph is held against)."""
    r = _goal_seek_loop(config, hf, costmap, goal, robot, ctrl, generator,
                        max_loops, unroll, noise_source, False, steps_fn)
    return GoalSeekResult(*r[:5])


def goal_seek_recorded(
    config: MPPIConfig, hf: HeightField, costmap: Costmap, goal: Tensor,
    robot: RobotState, ctrl: ControllerState, generator: torch.Generator | None,
    max_loops: int = 1500, unroll: int = 4, noise_source: NoiseSource | None = None,
    steps_fn: Callable | None = None,
) -> GoalSeekTrace:
    """:func:`goal_seek` that also records the position and commanded
    velocity of every active loop (consumers slice ``[:loops]``)."""
    robot, ctrl, loops, halt, steps, bp, bv = _goal_seek_loop(
        config, hf, costmap, goal, robot, ctrl, generator, max_loops, unroll,
        noise_source, True, steps_fn)
    return GoalSeekTrace(robot, ctrl, loops, halt, steps,
                         bp[:max_loops], bv[:max_loops])


def goal_reached(position: Tensor, goal: Tensor) -> Tensor:
    """The stop box |dx| <= 0.5 and |dy| <= 0.5 (MPPI_isaac.py:795), a 0-d
    bool on the device."""
    d = torch.abs(position - goal)
    return (d[0] <= 0.5) & (d[1] <= 0.5)


def masked_steps(config: MPPIConfig, max_loops: int, hf: HeightField, costmap: Costmap,
                 goal: Tensor, robot: RobotState, ctrl: ControllerState, loop: Tensor,
                 halt: Tensor, positions: Tensor, velocities: Tensor, noises: tuple):
    """One masked control step per noise ``(2, K, H)`` of ``noises`` (the
    body of the JAX ``lax.while_loop``, controller.py:556): a step taken
    after the stop (``halt``) or past ``max_loops`` leaves the state as it
    was. Records each active loop's position and commanded velocity at
    index ``loop`` of ``positions`` ``(n, 3)`` and ``velocities`` ``(n,)``
    in place (``n = 0``: no record). Returns ``(robot, ctrl, loop, halt,
    positions, velocities)``; reads nothing back to the host."""
    record = positions.shape[0] > 0
    for noise in noises:
        active = ~halt & (loop < max_loops)
        ctrl2, out = mppi_step(config, hf, costmap, goal, robot, ctrl, noise)
        robot2 = kinematic_advance(config, robot, out)
        robot = RobotState(*(torch.where(active, n, o) for n, o in zip(robot2, robot)))
        ctrl = ControllerState(*(torch.where(active, n, o) for n, o in zip(ctrl2, ctrl)))
        if record:  # index_copy_: indexing with a device scalar would sync
            at = loop.view(1)
            positions.index_copy_(0, at, torch.cat([robot.position, robot.z[None]])[None])
            v_old = velocities.index_select(0, at)
            velocities.index_copy_(0, at, torch.where(active, out.linear_velocity, v_old))
        loop = loop + active.to(torch.int64)
        halt = goal_reached(robot.position, goal)
    return robot, ctrl, loop, halt, positions, velocities


def _goal_seek_loop(config, hf, costmap, goal, robot, ctrl, generator,
                    max_loops, unroll, noise_source, record, steps_fn):
    """Shared loop of :func:`goal_seek` and :func:`goal_seek_recorded`:
    ``unroll`` masked steps per call of ``steps_fn``, then the loop's one
    host sync, the stop flag. The state it returns is cloned out of the
    graph's buffers, which the next replay overwrites."""
    dtype, dev = robot.position.dtype, robot.position.device
    if noise_source is None:
        if generator is None:
            raise ValueError("goal_seek needs a generator or a noise_source")
        noise_source = lambda: sample_noise(  # noqa: E731
            generator, config.num_samples, config.horizon, dtype, dev)
    if steps_fn is None:
        steps_fn = Graphed(masked_steps)
    n_buf = max_loops + 1 if record else 0
    bp = torch.zeros((n_buf, 3), dtype=dtype, device=dev)
    bv = torch.zeros((n_buf,), dtype=dtype, device=dev)
    loop = torch.zeros((), dtype=torch.int64, device=dev)
    halt = goal_reached(robot.position, goal)
    steps = 0
    while not bool(halt | (loop >= max_loops)):
        noises = tuple(noise_source() for _ in range(unroll))
        robot, ctrl, loop, halt, bp, bv = steps_fn(config, max_loops, hf, costmap, goal, robot,
                                                   ctrl, loop, halt, bp, bv, noises)
        steps += unroll
    clone = lambda nt: type(nt)(*(t.clone() for t in nt))  # noqa: E731
    return clone(robot), clone(ctrl), loop.clone(), halt.clone(), steps, bp.clone(), bv.clone()


def loop_generator_seed(seed: int, loop_seed: int) -> int:
    """The ``torch.Generator`` seed of one control loop, from the
    controller's seed and the loop's seed of :class:`LoopSeedSequence` (the
    JAX package folds the loop seed into ``key(seed)``; torch cannot
    reproduce that stream, so the two packages' draws differ)."""
    state = np.random.SeedSequence((seed, loop_seed)).generate_state(1, np.uint64)
    return int(state[0] >> 1)


class MPPIController:
    """Host-side convenience wrapper mirroring the reference controller's
    surface API (``warp_setup``/``MPPI_step``/``run``) around
    :func:`mppi_step`. Owns the world on its device and the replayable
    per-loop seed stream: loop ``n`` draws its noise from a
    ``torch.Generator`` on the device seeded with
    ``loop_generator_seed(seed, n-th loop seed)``.

    ``device`` is the card unless the caller names another
    (:func:`..core.device.run_device`); the world moves there. A step runs
    ``step_fn``: a :class:`..core.graphs.Graphed` :func:`mppi_step` (one
    CUDA graph replay on the card, the JAX package's jitted step,
    controller.py:625), whose outputs the next step overwrites; setting it
    to :func:`mppi_step` runs the steps eagerly (the reference the graph is
    held against)."""

    def __init__(self, config: MPPIConfig, hf: HeightField, costmap: Costmap, goal_xy,
                 seed: int = 42, device=None):
        self.device = run_device(device)
        self.config = config
        self.hf = HeightField(*(t.to(self.device) for t in hf))
        self.costmap = Costmap(*(t.to(self.device) for t in costmap))
        self.goal = torch.as_tensor(goal_xy, dtype=self.hf.z.dtype, device=self.device)
        self.seed = seed
        self.seeds = LoopSeedSequence(config.horizon, seed)
        self._generator = torch.Generator(device=self.device)
        self.loop = 0
        self.step_fn: Callable = Graphed(mppi_step)

    def step(self, robot: RobotState, ctrl: ControllerState,
             noise: Tensor | None = None) -> tuple[ControllerState, StepOutput]:
        """One control step; draws the loop noise from the seed stream
        unless ``noise`` (2, K, H) is given (tests replay JAX's draws). On
        the card the outputs are the step graph's buffers: the next step
        overwrites them."""
        if noise is None:
            self._generator.manual_seed(loop_generator_seed(self.seed, self.seeds.next_seed()))
            noise = sample_noise(self._generator, self.config.num_samples, self.config.horizon,
                                 self.hf.z.dtype, self.device)
        self.loop += 1
        return self.step_fn(self.config, self.hf, self.costmap, self.goal, robot, ctrl, noise)

    def run(self, robot: RobotState, max_loops: int = 3500
            ) -> tuple[RobotState, ControllerState, Tensor]:
        """Host-visible goal-seek loop (one host sync per loop, for the stop
        test; :func:`goal_seek` syncs once per ``unroll`` loops). Stops when
        |dx| <= 0.5 and |dy| <= 0.5 or after ``max_loops`` loops of this
        controller. Returns the final robot and controller states and the
        positions visited, ``(loops + 1, 2)``, on the device. What it keeps
        of a step it clones: the next step's replay overwrites the rest."""
        robot = RobotState(*(t.to(self.device) for t in robot))
        ctrl = ControllerState.create(self.config, self.hf.z.dtype, self.device)
        trajectory = [robot.position]
        while (self.loop < max_loops
               and bool((torch.abs(robot.position - self.goal) > 0.5).any())):
            ctrl, out = self.step(robot, ctrl)
            robot = kinematic_advance(self.config, robot, out)
            trajectory.append(robot.position.clone())
        clone = lambda nt: type(nt)(*(t.clone() for t in nt))  # noqa: E731
        return clone(robot), clone(ctrl), torch.stack(trajectory)
