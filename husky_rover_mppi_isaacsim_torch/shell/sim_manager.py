"""Simulation manager: the host loop that owns the closed-loop core.

Counterpart of ``husky_rover_mppi_isaacsim_tpu/shell/sim_manager.py``, the
re-design of ``ROS2_SimulationManager``
(src/environments_wrappers/ros2/simulation_manager_ros2.py:135-251). The
reference's loop per tick: ``world.step`` -> lab/robot ``periodic_update`` ->
``apply_modifications`` (deferred stage edits, applied only *between*
physics steps, :216-233) -> deformation hook -> monitor check, all paced by
a realtime ``Rate``. Here ``world.step`` is one
:func:`~..env.closed_loop.closed_loop_step` over every robot slot at once
(two K1 launches on the card), replayed on the card as one CUDA graph a
tick (:class:`~..core.graphs.Graphed`), and the "stage" edits are slot
updates queued on the :class:`~..env.robot_manager.RobotManager` by bus
subscribers. The graph copies the state into its buffers at every tick, so
an edit made between ticks reaches the next one.

A tick copies nothing to the host unless something subscribes to
``POSE_STATE``: only then are the poses read back for the message.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
from torch import Tensor

from ..core import jax_random as jr
from ..core.device import run_device
from ..core.heightfield import HeightField
from ..core.graphs import Graphed
from ..env.closed_loop import ClosedLoopConfig, LoopState, closed_loop_step, init_loop_state
from ..env.robot_manager import RobotManager
from ..mppi.critics import Costmap
from ..ops.jax_normal_cuda import SPLIT_NEXT, SPLIT_SUB, jax_normal
from .monitor import ThreadMonitor
from .pubsub import MessageBus, Topics


def tick(config: ClosedLoopConfig, hf: HeightField, costmap: Costmap, goals: Tensor,
         state: LoopState, key: Tensor) -> tuple[LoopState, Tensor]:
    """One tick's closed-loop step on the carried key (JAX
    ``sim_manager.py:107``): ``key, sub = split(key)``, the step drawing from
    ``sub``. Returns the state and the key carried on; on the card the split
    is one ``jax_normal`` launch that draws nothing."""
    state = closed_loop_step(config, hf, costmap, goals, state, key, SPLIT_SUB)
    _, key = jax_normal(key, (0,), next_path=SPLIT_NEXT)
    return state, key
from .rate import Rate


@dataclasses.dataclass
class SimulationManagerConf:
    """Loop pacing knobs (cfg/environment largescale.yaml:3-5: physics 60 Hz,
    rendering 30 Hz, realtime-enforced)."""

    loop: ClosedLoopConfig = dataclasses.field(default_factory=ClosedLoopConfig)
    realtime: bool = False       # pace to physics_dt wall-clock
    seed: int = 42               # the loop's key: jax_random.key(seed)
    monitor_poll_s: float = 1.0


class SimulationManager:
    """Owns the bus, the robots and the monitor, and drives the loop.

    ``device`` is the card unless the caller names another
    (:func:`..core.device.run_device`); the world and the goals move there.
    Exploration noise (and wheel slip, where ``slip_std > 0``) is the JAX
    package's: the manager carries ``key(conf.seed)`` and splits it each
    tick, ``key, sub = split(key)``, the tick's step drawing from ``sub``
    (JAX ``sim_manager.py:71, :107``).
    A tick runs ``step_fn``: a :class:`..core.graphs.Graphed` :func:`tick`
    (its outputs, ``state`` and ``key``, are overwritten by the next tick),
    or :func:`tick` itself to run the ticks eagerly on the card. The
    monitor is a thread: call :meth:`close` (or use the manager as a
    context manager) when done."""

    def __init__(self, conf: SimulationManagerConf, hf: HeightField, costmap: Costmap,
                 robots: RobotManager, goals, bus: Optional[MessageBus] = None,
                 deform_hook: Optional[Callable[[LoopState], LoopState]] = None,
                 device=None):
        self.device = run_device(device)
        self.conf = conf
        self.hf = HeightField(*(t.to(self.device) for t in hf))
        self.costmap = Costmap(*(t.to(self.device) for t in costmap))
        self.robots = robots
        self.bus = bus or MessageBus()
        dtype = self.hf.z.dtype
        self.goals = torch.as_tensor(np.asarray(goals), dtype=dtype, device=self.device)
        self.deform_hook = deform_hook
        self.key = jr.key(conf.seed, self.device)
        self.state = init_loop_state(conf.loop, robots.initial_state(self.hf, dtype=dtype), dtype)
        self.step_count = 0
        self.step_fn: Callable = Graphed(tick)
        self._wire_bus()
        self.monitor = ThreadMonitor(poll_s=conf.monitor_poll_s)
        self.monitor.start()

    # Topic surface -> deferred RobotManager requests (robot_manager_ros2.py
    # :20-118; callbacks only enqueue, application happens between steps).
    def _wire_bus(self) -> None:
        b = self.bus
        b.subscribe(Topics.ROBOT_SPAWN, lambda m: self.robots.spawn(
            m["name"], m["position"], m.get("heading", (1.0, 0.0, 0.0))))
        b.subscribe(Topics.ROBOT_TELEPORT, lambda m: self.robots.teleport(
            m["name"], m["position"], m.get("heading", (1.0, 0.0, 0.0))))
        b.subscribe(Topics.ROBOT_RESET, lambda m: self.robots.reset(m["name"]))
        b.subscribe(Topics.ROBOT_RESET_ALL, lambda m: self.robots.reset_all())

    def apply_modifications(self) -> None:
        """Flush deferred stage edits between steps (:226-230)."""
        if self.robots.pending:
            rovers = self.robots.apply_modifications(self.state.rovers, self.hf)
            self.state = self.state._replace(rovers=rovers)

    def step(self) -> LoopState:
        """One sim tick: closed-loop step -> pose publish (only when
        subscribed) -> deferred-edit flush -> deformation hook."""
        self.state, self.key = self.step_fn(self.conf.loop, self.hf, self.costmap, self.goals,
                                            self.state, self.key)
        self.step_count += 1
        if self.bus.has_subscribers(Topics.POSE_STATE):
            # a device-to-host copy: paid only when someone listens
            self.bus.publish(Topics.POSE_STATE, {
                "step": self.step_count,
                "positions": self.state.rovers.position.cpu().numpy(),
                "headings": self.state.rovers.heading.cpu().numpy(),
            })
        self.apply_modifications()
        if self.deform_hook is not None:
            self.state = self.deform_hook(self.state)
        return self.state

    def run_simulation(self, num_steps: int) -> LoopState:
        """Main loop with the monitor check and optional realtime pacing
        (simulation_manager_ros2.py:208-251)."""
        rate = Rate(1.0 / self.conf.loop.rover.physics_dt) if self.conf.realtime else None
        for _ in range(num_steps):
            if not self.monitor.is_alive:
                break
            self.step()
            if rate is not None:
                rate.sleep()
        return self.state

    def close(self) -> None:
        self.monitor.stop(run_shutdowns=True)

    def __enter__(self) -> "SimulationManager":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
