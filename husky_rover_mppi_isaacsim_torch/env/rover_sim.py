"""Vectorized rover physics surrogate: N simulated Huskies in lockstep.

Counterpart of ``husky_rover_mppi_isaacsim_tpu/env/rover_sim.py``, the
batched stand-in for the PhysX Husky of the reference
(visual_terrain_stack_full_terrain.py:330-335):

* wheel velocity drives: first-order tracking of the commanded wheel speeds;
* skid-steer body kinematics ``v = (l + r)/2``, ``w = (r - l)/track``;
* surface riding on the DEM: the rollouts' corner gather, quad normal,
  tangent projection and Rodrigues rotation, at the physics rate;
* optional multiplicative wheel slip.

Every state field leads with the rover axis. The slip noise is JAX's: two
normals from ``k1, k2 = split(key)`` (JAX ``rover_sim.py:99-101``), drawn on
the card by the ``jax_normal`` kernel (:mod:`..ops.jax_normal_cuda`), one
launch each, so a key gives the JAX package's slip.

Physical parameters are Python floats; every division by one goes through a
0-d tensor on the state's device, because CUDA torch turns ``t / float``
into a multiply by the reciprocal, which is not what the CPU or JAX compute.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from ..core import geometry as geom
from ..ops.jax_normal_cuda import jax_normal
from ..core import heightfield as hfield
from ..core.heightfield import HeightField


class RoverParams(NamedTuple):
    """Physical parameters of the simulated Husky (the JAX defaults, which
    ``cfg/physics/default_physics.yaml`` repeats)."""

    track: float = 1.2            # wheel track [m] (config.yaml robot_radius)
    wheel_tau: float = 0.05       # wheel-drive tracking time constant [s]
    physics_dt: float = 1.0 / 60  # physics step, 60 Hz
    slip_std: float = 0.0         # multiplicative wheel slip noise
    v_max: float = 5.0            # hard actuator limits
    w_max: float = 4.0
    mass: float = 46.0            # Husky body mass [kg]
    yaw_inertia: float = 2.6      # body yaw inertia [kg m^2]
    gravity: float = 1.62         # lunar surface gravity [m/s^2]


class RoverState(NamedTuple):
    """Batched rover state, leading axis = rover."""

    position: Tensor     # (N, 2)
    z: Tensor            # (N,)
    heading: Tensor      # (N, 3) unit
    wheel_left: Tensor   # (N,) actual left wheel linear speed [m/s]
    wheel_right: Tensor  # (N,)
    yaw_rate: Tensor     # (N,) measured body yaw rate [rad/s]

    @classmethod
    def create(cls, positions, headings, hf: HeightField, dtype=None) -> "RoverState":
        """Rovers at ``positions`` (N, 2) with ``headings`` ((3,) or (N, 3),
        normalized), standing on the DEM, wheels at rest; on the DEM's
        device, in its dtype unless ``dtype`` is given."""
        positions = torch.as_tensor(positions, dtype=dtype or hf.z.dtype, device=hf.z.device)
        n = positions.shape[0]
        headings = torch.as_tensor(headings, dtype=positions.dtype, device=positions.device)
        headings = geom.normalize(headings.broadcast_to((n, 3)))
        z = hfield.height_at(hf, positions[:, 0], positions[:, 1])
        zero = lambda: torch.zeros((n,), dtype=positions.dtype, device=positions.device)  # noqa: E731
        return cls(positions, z, headings, zero(), zero(), zero())


def _scalar(value: float, like: Tensor) -> Tensor:
    """A 0-d tensor on ``like``'s device and dtype (``torch.full``: no
    host-to-device copy, so no stream sync)."""
    return torch.full((), value, dtype=like.dtype, device=like.device)


def step(
    params: RoverParams,
    hf: HeightField,
    state: RoverState,
    cmd_left: Tensor,
    cmd_right: Tensor,
    key: Tensor | None = None,
    ext_force: Tensor | None = None,
    ext_torque: Tensor | None = None,
    path: tuple = (),
) -> RoverState:
    """Advance every rover one physics step under wheel-speed commands
    (JAX ``rover_sim.step``).

    ``ext_force`` (N, 3) / ``ext_torque`` (N,) act for one step: the
    in-plane force along the heading accelerates the body, the torque adds
    yaw rate. Slip (``params.slip_std > 0``) draws from the key ``key``
    taken down ``path`` (:func:`..core.jax_random.derive`; a caller passes
    its own key and the path to its physics key, so that no key is formed
    apart from a draw): ``k1, k2 = split(key)``, then ``normal(k1, (N,))``
    for the left wheels and ``normal(k2, (N,))`` for the right; with no key,
    no slip (the JAX ``key=None``)."""
    dt = params.physics_dt
    wl0 = state.wheel_left
    # wheel velocity drives: exponential approach, alpha in the state's dtype
    alpha = 1.0 - torch.exp(_scalar(-dt / params.wheel_tau, wl0))
    wl = wl0 + (cmd_left - wl0) * alpha
    wr = state.wheel_right + (cmd_right - state.wheel_right) * alpha
    if key is not None and params.slip_std > 0.0:
        path = tuple(path)
        slip_l = jax_normal(key, wl.shape, wl.dtype, path=path + (("split", 2, 0),))
        slip_r = jax_normal(key, wr.shape, wr.dtype, path=path + (("split", 2, 1),))
        wl = wl * (1.0 + params.slip_std * slip_l)
        wr = wr * (1.0 + params.slip_std * slip_r)

    lin = (wl + wr) / 2.0
    ang = (-wl + wr) / _scalar(params.track, wl)
    if ext_force is not None:
        lin = lin + dt * hfield.dot3(ext_force, state.heading) / _scalar(params.mass, wl)
    if ext_torque is not None:
        ang = ang + dt * ext_torque / _scalar(params.yaw_inertia, wl)
    lin = torch.clamp(lin, -params.v_max, params.v_max)
    ang = torch.clamp(ang, -params.w_max, params.w_max)

    x, y = geom.update_position(state.position[:, 0], state.position[:, 1], state.heading,
                                lin, dt)
    q = hfield.corners_at(hf, x, y)
    z = hfield.bilinear(x, y, q, hf.resolution)
    normal = hfield.quad_normal(q, hf.resolution)
    heading = hfield.tangent_project(normal, state.heading)
    heading = geom.update_orientation(heading, ang, normal, dt)
    return RoverState(position=torch.stack([x, y], dim=-1), z=z, heading=heading,
                      wheel_left=wl, wheel_right=wr, yaw_rate=ang)


def contact_forces(params: RoverParams, hf: HeightField, state: RoverState) -> Tensor:
    """Per-rover ground contact force (N, 3): the body weight carried along
    the local quad normal, ``m g n_z n`` (quasi-static proxy of the
    reference's PhysX contact readback)."""
    normal = hfield.normal_at(hf, state.position[:, 0], state.position[:, 1])
    load = params.mass * params.gravity * normal[:, 2]
    return normal * load[:, None]


def wheel_contact_forces(params: RoverParams, hf: HeightField, state: RoverState,
                         wheelbase: float, com_height: float = 0.2) -> Tensor:
    """Per-wheel normal loads (N, 4), order [FL, FR, RL, RR]: ``m g n_z / 4``
    each, shifted toward the downhill wheels by the in-plane components of
    gravity acting at ``com_height`` (``m a h / (2 d)`` per pair, d the track
    or the wheelbase); negative loads clip to 0 (lift-off)."""
    n = hfield.normal_at(hf, state.position[:, 0], state.position[:, 1])
    f = hfield.tangent_project(n, state.heading)      # unit forward on the surface
    left = geom.cross3(n, f)                          # unit left axis
    g = params.gravity
    total = params.mass * g * n[:, 2]
    a_lat = -g * left[:, 2]    # gravity along +left (left side low > 0)
    a_long = -g * f[:, 2]      # gravity along +forward (downhill > 0)
    d_lat = params.mass * a_lat * com_height / _scalar(2.0 * params.track, n)
    d_long = params.mass * a_long * com_height / _scalar(2.0 * wheelbase, n)
    base = total / 4.0
    loads = torch.stack([base + d_lat + d_long, base - d_lat + d_long,
                         base + d_lat - d_long, base - d_lat - d_long], dim=-1)
    return torch.clamp(loads, min=0.0)


def teleport(state: RoverState, hf: HeightField, index: int, position, heading) -> RoverState:
    """Teleport rover ``index`` (a Python int): new pose on the DEM, wheel
    state zeroed (RobotManager.teleport_robot semantics). Returns a new
    state; the fields of ``state`` are not written. With ``position`` and
    ``heading`` on the state's device it waits for nothing."""
    position = torch.as_tensor(position, dtype=state.position.dtype,
                               device=state.position.device)
    heading = geom.normalize(torch.as_tensor(heading, dtype=state.heading.dtype,
                                             device=state.heading.device))
    z = hfield.height_at(hf, position[0], position[1])

    def put(field: Tensor, value: Tensor | None = None) -> Tensor:
        """``field`` with row ``index`` set to ``value`` (zeroed without
        one). Device values and fills only: writing a Python number into a
        CUDA tensor copies it from the host, a stream sync."""
        out = field.clone()
        if value is None:
            out[index].zero_()
        else:
            out[index] = value
        return out

    return RoverState(
        position=put(state.position, position),
        z=put(state.z, z.to(state.z.dtype)),
        heading=put(state.heading, heading),
        wheel_left=put(state.wheel_left),
        wheel_right=put(state.wheel_right),
        yaw_rate=put(state.yaw_rate),
    )


def reset_mask(state: RoverState, hf: HeightField, mask: Tensor, positions,
               headings) -> RoverState:
    """Reset the rovers selected by ``mask`` (N,) to ``positions`` (N, 2)
    and ``headings`` (N, 3), wheel state zeroed; the others keep theirs."""
    positions = torch.as_tensor(positions, dtype=state.position.dtype,
                                device=state.position.device)
    headings = geom.normalize(torch.as_tensor(headings, dtype=state.heading.dtype,
                                              device=state.heading.device))
    z = hfield.height_at(hf, positions[:, 0], positions[:, 1])
    m1 = mask[:, None]
    zero = torch.zeros_like(state.wheel_left)
    return RoverState(
        position=torch.where(m1, positions, state.position),
        z=torch.where(mask, z, state.z),
        heading=torch.where(m1, headings, state.heading),
        wheel_left=torch.where(mask, zero, state.wheel_left),
        wheel_right=torch.where(mask, zero, state.wheel_right),
        yaw_rate=torch.where(mask, zero, state.yaw_rate),
    )
