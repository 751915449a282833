"""Turn state of the JAX package, given as numpy arrays and plain attributes,
into this package's objects, so that both packages can be fed the same world
and state. Nothing here imports jax: JAX arrays pass through ``np.asarray``
and the JAX ``MPPIConfig`` is read by field name. The objects lie on the
CPU; ``.to(device)`` on their tensors moves them to the card.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.heightfield import HeightField
from .env.closed_loop import ClosedLoopConfig, LoopState
from .env.frames import BlockFrame
from .env.robot_manager import RobotManager, RobotSpec
from .env.rover_sim import RoverParams, RoverState
from .mppi.controller import NESTED_CONFIG, ControllerState, MPPIConfig, RobotState
from .mppi.critics import Costmap
from .mppi.evaluation import TrajectoryLog
from .physics.deformation import DeformationEngineConf
from .shell.sim_manager import SimulationManagerConf
from .terrain.craters import CraterField, CraterProfiles
from .terrain.point_process import MaskedPoints
from .terrain.rocks import RockBlock
from .terrain.streaming import TerrainStreamer


def _tensor(a):
    return torch.as_tensor(np.array(a))  # np.array copies: no shared buffer


def heightfield_from_numpy(z, x_min, y_min, resolution) -> HeightField:
    """HeightField from the JAX one's fields (dtype follows ``z``)."""
    z = _tensor(z)
    s = lambda v: torch.tensor(float(np.asarray(v)), dtype=z.dtype, device=z.device)  # noqa: E731
    return HeightField(z=z, x_min=s(x_min), y_min=s(y_min), resolution=s(resolution))


def costmap_from_numpy(cost, half_width, resolution) -> Costmap:
    """Costmap from the JAX one's fields (dtype follows ``cost``)."""
    cost = _tensor(cost)
    s = lambda v: torch.tensor(float(np.asarray(v)), dtype=cost.dtype, device=cost.device)  # noqa: E731
    return Costmap(cost=cost, half_width=s(half_width), resolution=s(resolution))


def robot_state_from_numpy(position, z, heading, left_wheel_speed,
                           right_wheel_speed) -> RobotState:
    """RobotState from the JAX one's fields, in their order."""
    return RobotState(*(_tensor(a) for a in (
        position, z, heading, left_wheel_speed, right_wheel_speed)))


def controller_state_from_numpy(optimal_u1, optimal_u2, std_u1, std_u2) -> ControllerState:
    """ControllerState from the JAX one's fields, in their order."""
    return ControllerState(*(_tensor(a) for a in (
        optimal_u1, optimal_u2, std_u1, std_u2)))


def config_from_jax(cfg) -> MPPIConfig:
    """This package's MPPIConfig from the JAX one: every field this config
    has is read by name; the JAX gather-engine and patch fields are dropped."""
    kw = {}
    for f in dataclasses.fields(MPPIConfig):
        v = getattr(cfg, f.name)
        kw[f.name] = NESTED_CONFIG[f.name](*v) if f.name in NESTED_CONFIG else v
    return MPPIConfig(**kw)


def rover_state_from_numpy(position, z, heading, wheel_left, wheel_right,
                           yaw_rate) -> RoverState:
    """RoverState from the JAX one's fields, in their order."""
    return RoverState(*(_tensor(a) for a in (
        position, z, heading, wheel_left, wheel_right, yaw_rate)))


def rover_params_from_jax(params) -> RoverParams:
    """RoverParams from the JAX one, read by field name."""
    return RoverParams(**{f: float(getattr(params, f)) for f in RoverParams._fields})


def closed_loop_config_from_jax(cfg) -> ClosedLoopConfig:
    """ClosedLoopConfig from the JAX one: the MPPI and rover parts through
    :func:`config_from_jax` and :func:`rover_params_from_jax`, the rest by
    field name."""
    kw = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(ClosedLoopConfig)}
    kw["mppi"] = config_from_jax(cfg.mppi)
    kw["rover"] = rover_params_from_jax(cfg.rover)
    return ClosedLoopConfig(**kw)


def loop_state_from_jax(state) -> LoopState:
    """LoopState from the JAX one (arrays through ``np.asarray``); the step
    index stays a 0-d int32 tensor."""
    return LoopState(
        rovers=rover_state_from_numpy(*(np.asarray(a) for a in state.rovers)),
        ctrl=controller_state_from_numpy(*(np.asarray(a) for a in state.ctrl)),
        latched_left=_tensor(state.latched_left), latched_right=_tensor(state.latched_right),
        stored_left=_tensor(state.stored_left), stored_right=_tensor(state.stored_right),
        err_total=_tensor(state.err_total),
        step_index=torch.tensor(int(np.asarray(state.step_index)), dtype=torch.int32))


def crater_profiles_from_numpy(deformation, marks, height) -> CraterProfiles:
    """CraterProfiles from the JAX one's tables, in their order."""
    return CraterProfiles(*(_tensor(a) for a in (deformation, marks, height)))


def crater_field_from_numpy(*fields) -> CraterField:
    """CraterField from the JAX one's nine arrays, in their order."""
    return CraterField(*(_tensor(a) for a in fields))


def trajectory_log_from_jax(log) -> TrajectoryLog:
    """This package's TrajectoryLog from the JAX one, read by field name."""
    return TrajectoryLog(step=int(log.step), trajectory=np.array(log.trajectory),
                         linear_velocities=np.array(log.linear_velocities),
                         start=tuple(log.start), goal=tuple(log.goal))


def streamer_state_from_numpy(streamer: TerrainStreamer, lr_dem, anchor, crater_blocks,
                              rng_state, window, block_cache=None) -> TerrainStreamer:
    """Load the JAX streamer's state into this package's ``streamer`` (of
    the same ``StreamerConf``), in place, on its device: the LR DEM, the
    window and its anchor, the crater metadata per block ``{(bx, by):
    (coords, radii)}``, the crater generator's ``rng.bit_generator.state``
    and, where given, the cached blocks ``{(bx, by): array}`` (else the
    cache is emptied: a later shift builds what enters). The next shift
    then draws the craters the JAX streamer would draw."""
    dev = streamer.device
    streamer.lr_dem = _tensor(lr_dem).to(dtype=torch.float32, device=dev)
    streamer.anchor = (int(anchor[0]), int(anchor[1]))
    streamer.crater_blocks = {
        (int(k[0]), int(k[1])): (np.array(c, np.float64).reshape(-1, 2),
                                 np.array(r, np.float64).reshape(-1))
        for k, (c, r) in crater_blocks.items()}
    streamer.rng.bit_generator.state = rng_state
    streamer.window = _tensor(window).to(dtype=torch.float32, device=dev)
    streamer.block_cache = {
        (int(k[0]), int(k[1])): _tensor(b).to(dtype=torch.float32, device=dev)
        for k, b in (block_cache or {}).items()}
    return streamer


def rock_block_from_numpy(coordinates, height, quaternion, scale, ids) -> RockBlock:
    """RockBlock from the JAX one's fields, in their order (numpy copies)."""
    return RockBlock(*(np.array(a) for a in (coordinates, height, quaternion, scale, ids)))


def block_frame_from_jax(frame) -> BlockFrame:
    """BlockFrame (floats) from the JAX one's 0-d arrays."""
    return BlockFrame(*(float(np.asarray(v)) for v in frame))


def deformation_engine_conf_from_jax(conf) -> DeformationEngineConf:
    """This package's DeformationEngineConf from the JAX one: every field,
    the nested confs included, read by name."""

    def copy(cls, src):
        kw = {}
        for f in dataclasses.fields(cls):
            v = getattr(src, f.name)
            kw[f.name] = copy(type(getattr(cls(), f.name)), v) if dataclasses.is_dataclass(v) \
                else v
        return cls(**kw)

    return copy(DeformationEngineConf, conf)


def largescale_checkpoint_from_jax(loop, path) -> dict:
    """The state a traverse checkpoint written by the JAX package carries,
    loaded into this package's objects on ``loop``'s device (``loop``: a
    ``LargeScaleClosedLoop`` of the same configuration, which gives the
    template's shapes): ``{"state": LoopState, "costmap": Costmap,
    "crater_blocks": {(bx, by): (coords, radii)}, "path": (T, 2),
    "meta": dict}`` plus ``window`` and ``counts`` where the file has them.
    Neither package's file holds control noise state: a chunk's noise
    follows from the seed and the chunk index."""
    payload, meta = loop.load_checkpoint(path)
    state = payload["state"]
    out = {
        "state": state,
        "costmap": payload["costmap"],
        "crater_blocks": {tuple(int(v) for v in k.split("|")): (v["c"], v["r"])
                          for k, v in payload["craters"].items()},
        "path": payload["path"],
        "meta": meta,
    }
    for name in ("window", "counts"):
        if name in payload:
            out[name] = payload[name]
    return out


def robot_manager_from_jax(rm) -> RobotManager:
    """A RobotManager with the JAX one's registry: capacity, and every
    robot's spec (name, slot, spawn pose, namespace, active flag). The queue
    of pending edits (closures over JAX arrays) is not copied."""
    out = RobotManager(rm.max_robots)
    for name in rm.names:
        spec = rm.spec(name)
        out._robots[name] = RobotSpec(
            spec.name, int(spec.slot), tuple(float(v) for v in spec.spawn_position),
            tuple(float(v) for v in spec.spawn_heading), spec.namespace, bool(spec.active))
    return out


def masked_points_from_jax(pts) -> MaskedPoints:
    """MaskedPoints from the JAX one's fields (points, radius, mask)."""
    return MaskedPoints(*(_tensor(np.asarray(a)) for a in pts))


def simulation_manager_conf_from_jax(conf) -> SimulationManagerConf:
    """SimulationManagerConf from the JAX one: the loop through
    :func:`closed_loop_config_from_jax`, the rest by field name."""
    kw = {f.name: getattr(conf, f.name) for f in dataclasses.fields(SimulationManagerConf)}
    kw["loop"] = closed_loop_config_from_jax(conf.loop)
    return SimulationManagerConf(**kw)
