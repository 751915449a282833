"""The plain reference of the loops the benchmark drives: one MPPI control
step, the goal-seek's masked steps and the closed-loop sim step (MPPI,
latch, PI trim, skid-steer physics with slip).

Transcribed from the JAX package's formulas, neither imported nor taken
from the port: the critics and the weighted update
(``husky_rover_mppi_isaacsim_tpu/mppi/critics.py``), the perturbation
(``mppi/sampling.py``), the wheel lag (``dynamics/skid_steer.py``), the
control step and the goal-seek loop's body (``mppi/controller.py``), the
closed-loop step (``env/closed_loop.py``) and the rover physics
(``env/rover_sim.py``). Two pieces are this folder's frozen copies of the
port's plain versions of its hand-written kernels: K1's surface-riding
rollout (:func:`.rollout.rollout_25d`, whose per-step surface functions of
:mod:`.heightfield` and :mod:`.geometry` the physics rides with too) and
JAX's normal draw (:func:`.jax_random.normal`).

Every function runs in the dtype of the state it is given: float64 for
the check, float32 with TF32 matmuls for the control. A leading rover
axis ``R`` (empty for one rover) goes in front of every per-rover value,
as under the JAX package's ``jax.vmap`` over rovers. Configuration comes
as the benchmark's configuration dicts.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch import Tensor

from . import geometry as geom
from . import heightfield as hfield
from . import jax_random as jr
from .heightfield import HeightField
from .rollout import rollout_25d

SPLIT_SUB = (("split", 2, 1),)   # `sub` of `key, sub = split(key)`
SPLIT_NEXT = (("split", 2, 0),)  # the `key` it carries on
K_NOISE = (("split", 2, 0),)     # `k_noise, k_phys = split(key)`
K_PHYS = (("split", 2, 1),)


class Mppi(NamedTuple):
    """The controller's constants (config.yaml:1-28, MPPI_isaac.py:419-440)."""

    num_samples: int = 1000
    horizon: int = 100
    dt: float = 0.045
    robot_radius: float = 1.2
    temperature: float = 0.3
    v_min: float = 0.0
    v_max: float = 2.0
    w_min: float = -1.0
    w_max: float = 1.0
    std_u: float = 0.25
    u_min: float = -1.0
    u_max: float = 1.0
    rollout_lag: tuple = (3.5, 0.96)
    optimal_lag: tuple = (3.0, 0.92)
    sigma_base: float = 0.4
    critic_weights: tuple = (100.5, 50.5, 0.5, 25.0)

    @classmethod
    def from_config(cls, mppi: dict) -> "Mppi":
        known = {k: (tuple(v) if isinstance(v, list) else v) for k, v in mppi.items()
                 if k in cls._fields}
        return cls(**known)


class Costmap(NamedTuple):
    """``cost[iy, ix]`` with ``ix = trunc((x + half_width)/res)``, ``iy =
    trunc((half_width - y)/res)`` (critics_warp.py:245-248); the window
    scalars are 0-d tensors on the cost's device."""

    cost: Tensor
    half_width: Tensor
    resolution: Tensor

    @classmethod
    def create(cls, cost: Tensor, half_width: float) -> "Costmap":
        s = lambda v: torch.tensor(v, dtype=cost.dtype, device=cost.device)
        return cls(cost, s(half_width), s(2.0 * half_width / cost.shape[-1]))


class Robot(NamedTuple):
    position: Tensor
    z: Tensor
    heading: Tensor
    left_wheel_speed: Tensor
    right_wheel_speed: Tensor


class Ctrl(NamedTuple):
    optimal_u1: Tensor
    optimal_u2: Tensor
    std_u1: Tensor
    std_u2: Tensor


class Rovers(NamedTuple):
    position: Tensor
    z: Tensor
    heading: Tensor
    wheel_left: Tensor
    wheel_right: Tensor
    yaw_rate: Tensor


class Loop(NamedTuple):
    rovers: Rovers
    ctrl: Ctrl
    latched_left: Tensor
    latched_right: Tensor
    stored_left: Tensor
    stored_right: Tensor
    err_total: Tensor
    step_index: Tensor


def _per_sample(v: Tensor, axes: int) -> Tensor:
    """A per-rover value ``R`` with ``axes`` unit axes appended, against
    ``R + (K, ...)``."""
    return v.reshape(v.shape + (1,) * axes)


def _take(grid: Tensor, i: Tensor, j: Tensor) -> Tensor:
    """``grid[j, i]`` as a JAX gather reads it: a negative index wraps
    once, then every index clamps into the grid."""
    rows, cols = grid.shape
    i = torch.where(i < 0, i + cols, i).clamp(0, cols - 1)
    j = torch.where(j < 0, j + rows, j).clamp(0, rows - 1)
    return grid[j, i]


# --- critics (mppi/critics.py; critics_warp.py:86-376) ---------------------

def path_follow_critic(x, y, goal, traj, horizon_m: float) -> Tensor:
    """Far from the goal: the last waypoint's squared distance to a point
    ``horizon_m`` along the goal direction, times ``1 + 2 horizon/dist``;
    within ``horizon_m``: 10x the L1 distance of every waypoint but the
    last to the goal."""
    eps = 1e-6
    x_diff = goal[..., 0] - x
    y_diff = goal[..., 1] - y
    dist = torch.sqrt(x_diff * x_diff + y_diff * y_diff)
    inter_x = _per_sample(x + x_diff * horizon_m / (dist + eps), 1)
    inter_y = _per_sample(y + y_diff * horizon_m / (dist + eps), 1)
    last = traj[..., -1, :]
    far = (last[..., 0] - inter_x) ** 2 + (last[..., 1] - inter_y) ** 2
    far = far * _per_sample(1.0 + 2.0 * horizon_m / dist, 1)
    gx, gy = _per_sample(goal[..., 0], 2), _per_sample(goal[..., 1], 2)
    near = torch.sum(10.0 * (torch.abs(traj[..., :-1, 0] - gx)
                             + torch.abs(traj[..., :-1, 1] - gy)), dim=-1)
    return torch.where(_per_sample(dist > horizon_m, 1), far, near)


def _pair_slope(points: Tensor) -> Tensor:
    """``(1 + 5 |dz/d|)^2`` over the waypoint pairs ``(i, i+2)``, ``i = 0, 2,
    ... < H-3``."""
    idx = torch.arange(0, points.shape[-2] - 3, 2, device=points.device)
    p0, p1 = points[..., idx, :], points[..., idx + 2, :]
    dz = p1[..., 2] - p0[..., 2]
    d = torch.sqrt((p1[..., 0] - p0[..., 0]) ** 2 + (p1[..., 1] - p0[..., 1]) ** 2)
    return (1.0 + 5.0 * torch.abs(dz / (d + 1e-6))) ** 2


def slope_wheels_critic(left: Tensor, right: Tensor) -> Tensor:
    return torch.sum(torch.maximum(_pair_slope(left), _pair_slope(right)), dim=-1)


def obstacle_critic(traj: Tensor, cm: Costmap) -> Tensor:
    """The truncated cell of every waypoint; a cell over 0.99 adds 1e5."""
    ix = torch.trunc((traj[..., 0] + cm.half_width) / cm.resolution).to(torch.int64)
    iy = torch.trunc((-traj[..., 1] + cm.half_width) / cm.resolution).to(torch.int64)
    cell = _take(cm.cost, ix, iy)
    return torch.sum(torch.where(cell > 0.99, 1e5, 0.0) + cell, dim=-1)


def speed_critic(x, y, goal, lin: Tensor, v_max: float) -> Tensor:
    """``sum (v_max - v)/(v + 1e-4)``, nought within 2 m of the goal."""
    x_diff = goal[..., 0] - x
    y_diff = goal[..., 1] - y
    dist = torch.sqrt(x_diff * x_diff + y_diff * y_diff)
    diff = torch.sum((v_max - lin) / (lin + 1e-4), dim=-1)
    return torch.where(_per_sample(dist < 2.0, 1), torch.zeros_like(diff), diff)


def costs(m: Mppi, x, y, goal, ro, lin: Tensor, cm: Costmap) -> Tensor:
    w_path, w_slope, w_speed, w_obstacle = m.critic_weights
    horizon_m = m.dt * m.v_max * m.horizon
    return (w_path * path_follow_critic(x, y, goal, ro.trajectory, horizon_m)
            + w_slope * slope_wheels_critic(ro.left_wheel, ro.right_wheel)
            + w_speed * speed_critic(x, y, goal, lin, m.v_max)
            + w_obstacle * obstacle_critic(ro.trajectory, cm))


# --- sampling and the wheel lag (mppi/sampling.py, dynamics/skid_steer.py) --

def perturb(u: Tensor, std: Tensor, noise: Tensor, m: Mppi) -> Tensor:
    """The receding shift (``u[1:]`` then ``u[-1]``) plus ``std`` times the
    noise, clipped to the input range: ``R + (K, H)``."""
    base = torch.cat([u[..., 1:], u[..., -1:]], dim=-1)
    return torch.clamp(base[..., None, :] + _per_sample(std, 2) * noise, m.u_min, m.u_max)


def wheel_lag(m: Mppi, u1: Tensor, u2: Tensor, left0: Tensor, right0: Tensor,
              lag: tuple) -> tuple[Tensor, Tensor]:
    """``w_t = a w_{t-1} + k (1-a) u_t`` on each wheel from the rover's
    speeds, as one lower-triangular Toeplitz matmul (``wheel_lag_matmul``),
    then ``v = clip((w_l + w_r)/2)``, ``omega = clip((w_r - w_l)/track)``."""
    k, a = lag
    h, dtype, dev = u1.shape[-1], u1.dtype, u1.device
    t = torch.arange(h, device=dev)
    expo = t[:, None] - t[None, :]
    mat = torch.where(expo >= 0, a ** expo.clamp(min=0).to(dtype),
                      torch.zeros((), dtype=dtype, device=dev)) * (k * (1.0 - a))
    decay = a ** torch.arange(1, h + 1, dtype=dtype, device=dev)
    wl = _per_sample(left0, 2) * decay + torch.matmul(u1, mat.T)
    wr = _per_sample(right0, 2) * decay + torch.matmul(u2, mat.T)
    lin = torch.clamp((wl + wr) / 2.0, m.v_min, m.v_max)
    ang = torch.clamp((-wl + wr) / m.robot_radius, m.w_min, m.w_max)
    return lin, ang


# --- the control step (mppi/controller.py:296-473) --------------------------

def mppi_step(m: Mppi, hf: HeightField, cm: Costmap, goal: Tensor, robot: Robot, ctrl: Ctrl,
              noise: Tensor):
    """One control step for ``R`` rovers (``noise`` ``R + (2, K, H)``).
    Returns ``(ctrl, v, omega, optimal trajectory R + (H, 3), optimal
    headings R + (H, 3), sample rollouts)``."""
    u1 = perturb(ctrl.optimal_u1, ctrl.std_u1, noise[..., 0, :, :], m)
    u2 = perturb(ctrl.optimal_u2, ctrl.std_u2, noise[..., 1, :, :], m)
    lin, ang = wheel_lag(m, u1, u2, robot.left_wheel_speed, robot.right_wheel_speed,
                         m.rollout_lag)
    ro = rollout_25d(hf, robot.position[..., None, :], robot.heading[..., None, :], lin, ang,
                     m.dt, wheels=True)
    cost = costs(m, robot.position[..., 0], robot.position[..., 1], goal, ro, lin, cm)
    weights = torch.exp(-(cost - torch.amin(cost, dim=-1, keepdim=True)) / m.temperature)
    total = torch.sum(weights, dim=-1)[..., None]
    opt_u1 = torch.einsum("...k,...kh->...h", weights, u1) / total
    opt_u2 = torch.einsum("...k,...kh->...h", weights, u2) / total
    opt_lin, opt_ang = wheel_lag(m, opt_u1[..., None, :], opt_u2[..., None, :],
                                 robot.left_wheel_speed, robot.right_wheel_speed, m.optimal_lag)
    opt = rollout_25d(hf, robot.position[..., None, :], robot.heading[..., None, :], opt_lin,
                      opt_ang, m.dt, wheels=False)
    b = m.sigma_base
    sq = opt_ang[..., 0, 0] ** 2
    new = Ctrl(opt_u1, opt_u2, torch.clamp(b - sq, min=b), torch.clamp(b + sq, min=b))
    return (new, opt_lin[..., 0, 0], opt_ang[..., 0, 0], opt.trajectory[..., 0, :, :],
            opt.headings[..., 0, :, :], ro)


def kinematic_advance(m: Mppi, v: Tensor, w: Tensor, traj: Tensor, heads: Tensor) -> Robot:
    """The rover at the optimal rollout's first waypoint, with the wheel
    speeds that realise ``(v, omega)``."""
    half = w * m.robot_radius / 2.0
    return Robot(traj[..., 0, :2], traj[..., 0, 2], heads[..., 0, :], v - half, v + half)


def goal_reached(position: Tensor, goal: Tensor) -> Tensor:
    d = torch.abs(position - goal)
    return (d[..., 0] <= 0.5) & (d[..., 1] <= 0.5)


def masked_steps(m: Mppi, max_loops: int, hf: HeightField, cm: Costmap, goal: Tensor,
                 robot: Robot, ctrl: Ctrl, loop: Tensor, halt: Tensor, keys: Tensor, n: int):
    """``n`` masked steps of the goal-seek loop's body (controller.py:532-556)
    for ``R`` independent replays: ``key, sub = split(key)``, noise ``(2, K,
    H)`` from ``sub``, a step that leaves the state as it was after the stop
    or past ``max_loops``. ``keys`` is ``R + (2,)``. Returns ``(robot, ctrl,
    loop, halt, keys, sample rollouts of the first step)``."""
    first = None
    shape = (2, m.num_samples, m.horizon)
    for _ in range(n):
        flat = keys.reshape(-1, 2)
        noise = torch.stack([jr.normal(jr.derive(k, SPLIT_SUB), shape, torch.float32)
                             for k in flat]).reshape(keys.shape[:-1] + shape)
        keys = torch.stack([jr.derive(k, SPLIT_NEXT) for k in flat]).reshape(keys.shape)
        active = ~halt & (loop < max_loops)
        ctrl2, v, w, traj, heads, ro = mppi_step(m, hf, cm, goal, robot, ctrl,
                                                 noise.to(robot.position.dtype))
        first = ro if first is None else first
        robot2 = kinematic_advance(m, v, w, traj, heads)

        def keep(new, old):
            return torch.where(_per_sample(active, new.ndim - active.ndim), new, old)
        robot = Robot(*map(keep, robot2, robot))
        ctrl = Ctrl(*map(keep, ctrl2, ctrl))
        loop = loop + active.to(loop.dtype)
        halt = goal_reached(robot.position, goal)
    return robot, ctrl, loop, halt, keys, first


def dem_cells(hf: HeightField, ro, start: Tensor) -> int:
    """DEM cells one rover's sample rollouts read: every step's quad
    corners, the start cell's, and the wheel tracks' nearest cells (K1's
    byte rule counts each once)."""
    rows, cols = hf.z.shape
    pts = torch.cat([ro.trajectory[..., :2].reshape(-1, 2), start.reshape(-1, 2)])
    flat = []
    for xy, quad in ((pts, True), (ro.left_wheel[..., :2].reshape(-1, 2), False),
                     (ro.right_wheel[..., :2].reshape(-1, 2), False)):
        i, j = hfield.corner_cell(hf, xy[:, 0], xy[:, 1])
        for di, dj in ((0, 0), (1, 0), (0, 1), (1, 1)) if quad else ((0, 0),):
            flat.append(hfield.wrap_clamp(j + dj, rows) * cols + hfield.wrap_clamp(i + di, cols))
    return int(torch.unique(torch.cat(flat)).numel())


# --- the simulated rovers and the closed loop (env/rover_sim.py, env/closed_loop.py)

class Physics(NamedTuple):
    """The simulated Husky (``RoverParams``)."""

    track: float = 1.2
    wheel_tau: float = 0.05
    physics_dt: float = 1.0 / 60
    slip_std: float = 0.0
    v_max: float = 5.0
    w_max: float = 4.0

    @classmethod
    def from_config(cls, d: dict) -> "Physics":
        return cls(**{k: v for k, v in d.items() if k in cls._fields})


def rover_step(p: Physics, hf: HeightField, s: Rovers, cmd_left: Tensor, cmd_right: Tensor,
               key: Tensor, path: tuple) -> Rovers:
    """One physics step of every rover (rover_sim.py:71-128): the wheel
    drives' exponential approach, slip ``k1, k2 = split(key)``, skid-steer,
    then the surface riding of K1's step (position along the heading,
    bilinear height, quad normal, tangent projection, rotation about the
    normal)."""
    dt = p.physics_dt
    alpha = 1.0 - math.exp(-dt / p.wheel_tau)
    wl = s.wheel_left + (cmd_left - s.wheel_left) * alpha
    wr = s.wheel_right + (cmd_right - s.wheel_right) * alpha
    if p.slip_std > 0.0:
        draw = [jr.normal(jr.derive(key, tuple(path) + (("split", 2, i),)), wl.shape,
                          torch.float32).to(wl.dtype) for i in (0, 1)]
        wl = wl * (1.0 + p.slip_std * draw[0])
        wr = wr * (1.0 + p.slip_std * draw[1])
    lin = torch.clamp((wl + wr) / 2.0, -p.v_max, p.v_max)
    ang = torch.clamp((-wl + wr) / p.track, -p.w_max, p.w_max)
    x, y = geom.update_position(s.position[:, 0], s.position[:, 1], s.heading, lin, dt)
    q = hfield.corners_at(hf, x, y)
    z = hfield.bilinear(x, y, q, hf.resolution)
    normal = hfield.quad_normal(q, hf.resolution)
    heading = geom.update_orientation(hfield.tangent_project(normal, s.heading), ang, normal, dt)
    return Rovers(torch.stack([x, y], dim=-1), z, heading, wl, wr, ang)


class LoopConsts(NamedTuple):
    """The closed loop's latch and trims (closed_loop.py:46-56)."""

    latch_every: int = 3
    pi_kp: float = 1.0 / 20.0
    pi_ki: float = 1.0 / 39.0
    std_base: float = 0.25
    std_gain: float = 1.0 / 3.0


def closed_loop_step(m: Mppi, p: Physics, c: LoopConsts, hf: HeightField, cm: Costmap,
                     goals: Tensor, state: Loop, key: Tensor, key_path: tuple = ()) -> Loop:
    """One sim step of every rover (closed_loop.py:107-173): MPPI on noise
    ``normal(k_noise, (2, N*K, H))`` laid out ``(N, 2, K, H)`` and the
    commanded wheel speeds, the latch every ``latch_every``-th step, the PI
    yaw-rate trim, the physics step on ``k_phys``, the stds adapted to the
    measured yaw rate."""
    n = state.rovers.position.shape[0]
    draw = jr.normal(jr.derive(key, tuple(key_path) + K_NOISE),
                     (2, n * m.num_samples, m.horizon), torch.float32)
    noise = draw.reshape(2, n, m.num_samples, m.horizon).permute(1, 0, 2, 3)
    robot = Robot(state.rovers.position, state.rovers.z, state.rovers.heading,
                  state.stored_left, state.stored_right)
    ctrl, lin_cmd, ang_cmd, *_ = mppi_step(m, hf, cm, goals, robot, state.ctrl,
                                           noise.to(state.rovers.position.dtype))
    left_stored = lin_cmd - ang_cmd * m.robot_radius / 2
    right_stored = lin_cmd + ang_cmd * m.robot_radius / 2
    latch = (state.step_index % c.latch_every) == 0
    latched_left = torch.where(latch, left_stored, state.latched_left)
    latched_right = torch.where(latch, right_stored, state.latched_right)
    err_total = torch.where(latch, torch.zeros_like(state.err_total), state.err_total)
    err = state.rovers.yaw_rate - ang_cmd
    err_total = err_total + err
    trim = err * c.pi_kp + err_total * c.pi_ki
    rovers = rover_step(p, hf, state.rovers, latched_left + trim, latched_right - trim, key,
                        tuple(key_path) + K_PHYS)
    yaw2 = rovers.yaw_rate * rovers.yaw_rate
    ctrl = ctrl._replace(std_u1=torch.clamp(c.std_base - yaw2 * c.std_gain, min=c.std_base),
                         std_u2=torch.clamp(c.std_base + yaw2 * c.std_gain, min=c.std_base))
    return Loop(rovers, ctrl, latched_left, latched_right, left_stored, right_stored, err_total,
                state.step_index + 1)
