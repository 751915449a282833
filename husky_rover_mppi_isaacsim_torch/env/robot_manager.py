"""Named-robot management over the vectorized rover simulator.

Counterpart of ``husky_rover_mppi_isaacsim_tpu/env/robot_manager.py``, the
re-design of ``src/robots/robot.py`` (``RobotManager``: spawn / teleport /
reset / reset_all with ``max_robots`` capacity and namespaced robot names,
:32-267) and of the deferred-modification semantics of the ROS wrappers
(``robot_manager_ros2.py:20-118``: every request is queued and applied
*between* physics steps, never inside one).

The "stage" is a fixed-capacity :class:`~.rover_sim.RoverState` (every slot
exists from the start; spawning activates one), so every operation is a
slot update on the device and the manager is a thin host-side registry.
Queued edits build their poses on the state's device with ``torch.full``
and write slots by Python index: applying them copies nothing from the host
and waits for nothing. The readbacks (:meth:`RobotManager.pose`,
:meth:`RobotManager.velocities`) are the only host syncs.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch
from torch import Tensor

from ..core.heightfield import HeightField
from . import rover_sim
from .rover_sim import RoverState

Modification = Callable[[RoverState, HeightField], RoverState]


@dataclasses.dataclass
class RobotSpec:
    """Per-robot registration record (name, namespace, spawn pose;
    robot.py:270-300)."""

    name: str
    slot: int
    spawn_position: Tuple[float, float]
    spawn_heading: Tuple[float, float, float]
    namespace: str = ""
    active: bool = True


def _device_vector(values, like: Tensor) -> Tensor:
    """``values`` (Python floats) as a 1-d tensor in ``like``'s dtype on its
    device, built by fills: no host-to-device copy, so no stream sync."""
    return torch.stack([torch.full((), float(v), dtype=like.dtype, device=like.device)
                        for v in values])


def _teleport_slot(slot: int, position, heading) -> Modification:
    def apply(state: RoverState, hf: HeightField) -> RoverState:
        return rover_sim.teleport(state, hf, slot, _device_vector(position, state.position),
                                  _device_vector(heading, state.heading))
    return apply


class RobotManager:
    """Fixed-capacity registry of named rovers over one ``RoverState``: at
    most ``max_robots`` robots, unique names, spawn / teleport / reset /
    reset_all, every request deferred until :meth:`apply_modifications`
    (robot.py:32-130)."""

    def __init__(self, max_robots: int = 5):
        self.max_robots = int(max_robots)
        self._robots: Dict[str, RobotSpec] = {}
        self._modifications: List[Modification] = []

    # -- registry ---------------------------------------------------------

    @property
    def names(self) -> List[str]:
        return list(self._robots)

    def __contains__(self, name: str) -> bool:
        return name in self._robots

    def spec(self, name: str) -> RobotSpec:
        return self._robots[name]

    def slot(self, name: str) -> int:
        return self._robots[name].slot

    def active_mask(self) -> np.ndarray:
        mask = np.zeros((self.max_robots,), bool)
        for spec in self._robots.values():
            mask[spec.slot] = spec.active
        return mask

    def initial_state(self, hf: HeightField, dtype=None) -> RoverState:
        """The fixed-capacity state on ``hf``'s device: every slot exists
        from step 0; registered robots stand at their spawn pose, the other
        slots at the origin facing +x."""
        positions = np.zeros((self.max_robots, 2), np.float64)
        headings = np.tile(np.array([1.0, 0.0, 0.0]), (self.max_robots, 1))
        for spec in self._robots.values():
            positions[spec.slot] = spec.spawn_position
            headings[spec.slot] = spec.spawn_heading
        return RoverState.create(positions, headings, hf, dtype=dtype)

    # -- deferred request surface (robot_manager_ros2.py:20-118) ----------

    def spawn(self, name: str, position: Tuple[float, float],
              heading: Tuple[float, float, float] = (1.0, 0.0, 0.0),
              namespace: str = "") -> RobotSpec:
        """Register a robot in the first free slot and enqueue its
        placement at the spawn pose (Spawn topic)."""
        if name in self._robots:
            raise ValueError(f"robot {name!r} already spawned")
        if len(self._robots) >= self.max_robots:
            raise RuntimeError(f"max_robots={self.max_robots} reached (robot.py:75-80 caps)")
        used = {s.slot for s in self._robots.values()}
        slot = next(i for i in range(self.max_robots) if i not in used)
        spec = RobotSpec(name, slot, tuple(position), tuple(heading), namespace)
        self._robots[name] = spec
        self._modifications.append(_teleport_slot(slot, spec.spawn_position, spec.spawn_heading))
        return spec

    def teleport(self, name: str, position: Tuple[float, float],
                 heading: Tuple[float, float, float] = (1.0, 0.0, 0.0)) -> None:
        """Enqueue a teleport, wheel state zeroed (Teleport topic,
        robot.py:316-329)."""
        self._modifications.append(_teleport_slot(self._robots[name].slot, position, heading))

    def reset(self, name: str) -> None:
        """Enqueue a reset to the spawn pose (Reset topic)."""
        spec = self._robots[name]
        self.teleport(name, spec.spawn_position, spec.spawn_heading)

    def reset_all(self) -> None:
        """Enqueue a reset of every registered robot (ResetAll topic)."""
        for name in list(self._robots):
            self.reset(name)

    def enqueue(self, fn: Modification) -> None:
        """Arbitrary deferred stage edit (base_wrapper_ros2.py:78-92)."""
        self._modifications.append(fn)

    @property
    def pending(self) -> int:
        return len(self._modifications)

    def apply_modifications(self, state: RoverState, hf: HeightField) -> RoverState:
        """Run the queued edits, in order, between physics steps
        (simulation_manager_ros2.py:226-230)."""
        mods, self._modifications = self._modifications, []
        for fn in mods:
            state = fn(state, hf)
        return state

    # -- readbacks (RobotRigidGroup surface): host syncs -------------------

    def pose(self, state: RoverState, name: str) -> tuple[np.ndarray, float, np.ndarray]:
        """(position xy, z, heading) of one robot (robot.py get_pose)."""
        slot = self._robots[name].slot
        return (state.position[slot].cpu().numpy(), float(state.z[slot]),
                state.heading[slot].cpu().numpy())

    def velocities(self, state: RoverState, name: str) -> tuple[float, float]:
        """(linear speed, yaw rate) readback (RobotRigidGroup velocities)."""
        slot = self._robots[name].slot
        lin = float((state.wheel_left[slot] + state.wheel_right[slot]) / 2.0)
        return lin, float(state.yaw_rate[slot])

    def contact_forces(self, params: rover_sim.RoverParams, hf: HeightField,
                       state: RoverState) -> Tensor:
        """All-slot contact force readback (robot.py:449-462)."""
        return rover_sim.contact_forces(params, hf, state)
