"""Streamed-terrain full-stack closed loop (synchronous path).

Counterpart of ``husky_rover_mppi_isaacsim_tpu/env/largescale_loop.py``, the
re-design of ``visual_terrain_stack_full_terrain.py:293-582``: an MPPI-driven
rover crossing procedurally streamed lunar terrain. The reference composes
LargeScaleTerrainManager + a PhysX Husky + the MPPI controller, with three
pieces of glue this module reproduces:

* the controller runs in the **rotated block-local frame**
  (``ctrl.x = world.y - oy``, ``ctrl.y = -(world.x - ox)`` with
  ``(ox, oy) = block + half_block``, :436-455, :492-497): under that
  rotation the controller's ``Z[j, i]`` indexing maps exactly onto the
  streamer window layout (row = world x, col = world y), so the live window
  tensor seats directly as the MPPI heightfield (:423-431);
* commands are **latched every 3rd sim step with a PI yaw-rate trim**
  (:477-511), reused from :mod:`.closed_loop` (same semantics, N=1);
* on every **block shift** (:546-576) the heightfield re-seats on the
  shifted window, the costmap rebuilds from the streamed ``rocks_data`` at
  the new origin, and robot position and goal rebase by ``(-dy, +dx)`` in the
  controller frame.

One chunk is ``terrain_check_every`` closed-loop steps on the device with no
host sync (on the card each step is two launches of kernel K1 on the live
window); the host then reads five scalars (world position, world heading,
reached) and runs the terrain cascade. A costmap build is one launch of
kernel K2.

Ported: the synchronous loop (``pipeline_depth=0``, ``prestage_shifts=
False``). The pipelined loop and its terrain worker, shift pre-staging,
wheel-track deformation, checkpoints and resume are not: the configuration
keeps their fields, and a value that asks for one raises
``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional

import numpy as np
import torch
from torch import Tensor

from ..core.heightfield import HeightField
from ..mppi.critics import Costmap
from ..terrain.costmap import as_costmap, update_costmap_with_obstacles
from ..terrain.orchestrator import LargeScaleConf, LargeScaleTerrainManager
from . import closed_loop, frames
from .closed_loop import ClosedLoopConfig, LoopState
from .rover_sim import RoverState


@dataclasses.dataclass
class LargeScaleLoopConf:
    """Full-stack run configuration (the ``__main__`` parameters of
    visual_terrain_stack_full_terrain.py:377-455), under the JAX package's
    field names. The defaults of ``prestage_shifts`` and ``pipeline_depth``
    are the values this package serves; the JAX package's are True and 4."""

    terrain: LargeScaleConf = dataclasses.field(default_factory=LargeScaleConf)
    loop: ClosedLoopConfig = dataclasses.field(default_factory=ClosedLoopConfig)
    start: tuple = (0.0, 0.0)          # world (x, y) (:377-379)
    goal: tuple = (65.0, 65.0)         # world goal (:420-421)
    costmap_robot_radius: float = 0.3  # Surface radius_robot (:449)
    costmap_falloff: float = 20.0      # (1-d)^20 (MPPI_isaac.py:374-377)
    goal_tolerance: float = 0.5        # |dx|,|dy| stop box (MPPI_isaac.py:795)
    max_steps: int = 20000
    # Sim steps per chunk = steps between host-side terrain polls. The
    # reference checks every tick but gates updates on 2 m of travel
    # (update_every_n_meters); 12 steps is <= 0.4 m at 2 m/s, far finer than
    # the gate.
    terrain_check_every: int = 12
    prestage_shifts: bool = False      # True: not ported
    prestage_lookahead_m: float = 6.0
    pipeline_depth: int = 0            # > 0 (the pipelined loop): not ported
    checkpoint_path: Optional[str] = None   # not ported
    checkpoint_every_steps: int = 0         # not ported
    verify_prestage: bool = False           # needs pre-staging: not ported
    seed: int = 42
    deform: Optional[object] = None    # wheel-track deformation: not ported
    wheelbase: float = 0.512  # Husky front<->rear wheel separation (m)

    @property
    def costmap_size(self) -> int:
        """costmap = DEM grid / 8 (MPPI_isaac.py:271-272)."""
        return self.terrain.streamer_conf.window_px // 8

    def refuse_unported(self) -> None:
        """Raise ``NotImplementedError`` for every option the port cannot
        serve yet, naming what is missing."""
        if self.pipeline_depth > 0:
            raise NotImplementedError(
                f"pipeline_depth={self.pipeline_depth}: the pipelined loop and its terrain "
                "worker are not ported; pass pipeline_depth=0 (the synchronous loop)")
        if self.prestage_shifts or self.verify_prestage:
            raise NotImplementedError(
                "prestage_shifts / verify_prestage: shift pre-staging "
                "(TerrainStreamer.prestage_shift and the staged costmap) is not ported; "
                "pass prestage_shifts=False")
        if self.deform is not None:
            raise NotImplementedError(
                "deform: wheel-track deformation (physics/deformation.py) is not ported")
        if self.checkpoint_path is not None or self.checkpoint_every_steps:
            raise NotImplementedError(
                "checkpoint_path / checkpoint_every_steps: checkpoints (aux/checkpoint.py) "
                "are not ported")


@dataclasses.dataclass
class LargeScaleRunResult:
    reached: bool
    steps: int
    block_shifts: int
    distance_m: float
    final_position: tuple
    wall_s: float
    shift_latencies_s: List[float]
    costmap_rebuilds: int
    path_world: np.ndarray  # (T, 2), one point per chunk
    # steady-state rate: steps and seconds after the first 240 sim steps
    steady_steps: int = 0
    steady_wall_s: float = 0.0
    # pre-staging is not ported: every shift counts as a miss
    prestage_hits: int = 0
    prestage_misses: int = 0


def run_chunk(conf: LargeScaleLoopConf, hf: HeightField, costmap: Costmap,
              frame: frames.BlockFrame, state: LoopState, goal_ctrl: Tensor,
              generator: torch.Generator | None = None,
              noise: Tensor | None = None) -> tuple[LoopState, Tensor]:
    """``conf.terrain_check_every`` masked closed-loop steps (N=1) with no
    host sync: once the rover is inside the goal stop box (checked EVERY sim
    step, in the rotated frame: the box is axis-swapped but identical) the
    state freezes under a ``torch.where``, so a long chunk cannot overshoot
    through the box between host polls (MPPI_OO_current.py:670 stop
    semantics). ``noise`` ``(steps, 1, 2, K, H)`` replays given draws; else
    each step draws from ``generator``.

    Returns the state and a ``(5,)`` tensor: world x, y, world heading x, y,
    and 1.0 when the stop box was reached. The host-side step index advances
    by the chunk's steps whether or not the state froze (the JAX package
    freezes it with the rest; a frozen rover is not stepped further)."""
    tol = conf.goal_tolerance

    def in_box(st):
        d = torch.abs(st.rovers.position[0] - goal_ctrl[0])
        return (d[0] < tol) & (d[1] < tol)

    def keep(old, new):
        return [torch.where(done, a, b) for a, b in zip(old, new)]

    done = in_box(state)
    for s in range(conf.terrain_check_every):
        new = closed_loop.closed_loop_step(conf.loop, hf, costmap, goal_ctrl, state, generator,
                                           None if noise is None else noise[s])
        state = LoopState(RoverState(*keep(state.rovers, new.rovers)),
                          type(new.ctrl)(*keep(state.ctrl, new.ctrl)),
                          *keep(state[2:7], new[2:7]), step_index=new.step_index)
        done = done | in_box(state)
    pos = state.rovers.position[0]
    h = state.rovers.heading[0]
    # rotated block frame -> world (frames.controller_to_world)
    ox, oy = frame.origin()
    pose = torch.stack([-pos[1] + ox, pos[0] + oy, -h[1], h[0], done.to(pos.dtype)])
    return state, pose


class LargeScaleClosedLoop:
    """Host-side loop that seats the closed loop on the streamed window."""

    def __init__(self, conf: LargeScaleLoopConf, lstm: LargeScaleTerrainManager | None = None,
                 phase_cb: Callable[[str, float], None] | None = None, device=None):
        """``lstm`` injects a prebuilt terrain manager (on ``device``);
        ``phase_cb(name, seconds)`` gets one call per construction phase.
        ``device`` is where the terrain, the state and the controller live
        (default: the CPU; the entry point passes the card)."""
        conf.refuse_unported()
        t0 = time.perf_counter()

        def _mark(name):
            nonlocal t0
            if phase_cb is not None:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                phase_cb(name, time.perf_counter() - t0)
            t0 = time.perf_counter()

        self.conf = conf
        self.device = torch.device(device) if device is not None else torch.device("cpu")
        if lstm is None:
            self.lstm = LargeScaleTerrainManager(conf.terrain, device=self.device)
            self.lstm.build()
        else:
            self.lstm = lstm
        _mark("terrain_build")
        streamer = self.lstm.map_manager.streamer
        self.window_half = streamer.conf.window_size / 2.0
        self.half_block = streamer.conf.block_size / 2.0

        # controller frame anchored at the current center block (:432-444)
        self.block_x, self.block_y = self.lstm.get_hr_map_current_block_coordinates()
        self.hf = self._window_heightfield()
        _mark("window_heightfield")
        self.costmap = self._build_costmap()
        _mark("first_costmap")
        self.prestage_misses = 0
        self.shift_phase_log: List[dict] = []  # per-shift phase timings
        self.costmap_log: List[tuple] = []     # (first chunk served, costmap, frame)
        self.last_state: LoopState | None = None

    @property
    def frame(self) -> frames.BlockFrame:
        """The controller frame's anchor, as floats."""
        return frames.BlockFrame(float(self.block_x), float(self.block_y),
                                 float(self.half_block))

    def _scalar(self, v: float) -> Tensor:
        return torch.tensor(v, dtype=torch.float32, device=self.device)

    # -- the chunk -----------------------------------------------------------

    def chunk(self, state: LoopState, goal_ctrl: Tensor, generator: torch.Generator | None = None,
              noise: Tensor | None = None) -> tuple[LoopState, Tensor]:
        """One :func:`run_chunk` on the live window, costmap and frame."""
        return run_chunk(self.conf, self.hf, self.costmap, self.frame, state, goal_ctrl,
                         generator, noise)

    # -- window / costmap seating ----------------------------------------------

    def _window_heightfield(self) -> HeightField:
        """Seat the MPPI heightfield on the live streamed window (:423-431).
        The controller frame is window-centered, so half_width = window/2 and
        the raw window is Z (row = x = controller j, col = y = controller i
        under the rotated frame)."""
        return HeightField.create(self.lstm.map_manager.streamer.window, self.window_half)

    def _rocks_for(self, position) -> np.ndarray:
        """Obstacle list [x, y, radius] for the rock region around a world
        position: exactly what ``update_visual_mesh`` + ``extract_rocks_data``
        produce once the rover is there (rock blocks are keyed by seed and
        block, and cached)."""
        span = self.conf.terrain.rock_block_span
        obstacles = []
        for sampler in self.lstm.rock_samplers:
            block = sampler.sample_region(position, block_span=span)
            pos = np.asarray(block.coordinates).reshape(-1, 2)
            sc = np.asarray(block.scale).reshape(-1, 3)
            if pos.shape[0] == 0:
                continue
            radius = np.maximum(sc[:, 0], sc[:, 1])
            obstacles.append(np.concatenate([pos, radius[:, None]], axis=-1))
        if not obstacles:
            return np.zeros((0, 3), np.float32)
        return np.concatenate(obstacles, axis=0)

    def _build_costmap(self, block_xy=None, obstacles=None) -> Costmap:
        """Costmap from the streamed rocks at the current (or a given) window
        origin (:448-449, :559-563); on the card its EDT runs kernel K2."""
        bx, by = block_xy if block_xy is not None else (self.block_x, self.block_y)
        origin = (bx + self.half_block, by + self.half_block)
        if obstacles is None:
            obstacles = self.lstm.extract_rocks_data()
        if obstacles.shape[0] == 0:
            # free-space window: zero cost everywhere (the min-max
            # normalization of the distance transform is undefined)
            size = self.conf.costmap_size
            return as_costmap(np.zeros((size, size), np.float32), self.window_half,
                              device=self.device)
        return update_costmap_with_obstacles(
            self.conf.costmap_size, self.window_half, obstacles[:, :2], obstacles[:, 2],
            self.conf.costmap_robot_radius, falloff_power=self.conf.costmap_falloff,
            origin=origin, device=self.device)

    # -- frame plumbing --------------------------------------------------------

    def _initial_state(self) -> LoopState:
        cx, cy = frames.world_to_controller(self.frame, self._scalar(self.conf.start[0]),
                                            self._scalar(self.conf.start[1]))
        # world +x heading in the rotated frame (:440, :493: [h.y, -h.x, h.z])
        heading = frames.heading_world_to_controller(
            torch.tensor([1.0, 0.0, 0.0], dtype=torch.float32, device=self.device))
        rovers = RoverState.create(torch.stack([cx, cy])[None, :], heading[None, :], self.hf)
        return closed_loop.init_loop_state(self.conf.loop, rovers)

    def _goal_ctrl(self) -> Tensor:
        gx, gy = frames.world_to_controller(self.frame, self._scalar(self.conf.goal[0]),
                                            self._scalar(self.conf.goal[1]))
        return torch.stack([gx, gy])[None, :]

    def _world_position(self, state: LoopState) -> tuple:
        """One device -> host transfer for the rover's world position."""
        cx, cy = state.rovers.position[0].tolist()
        ox, oy = self.frame.origin()
        # inverse of the rotated frame (frames.controller_to_world, host-side)
        return -cy + ox, cx + oy

    # -- block-shift rebasing (:546-576) ---------------------------------------

    def _on_block_shift(self, state: LoopState, goal_ctrl: Tensor) -> tuple:
        bx, by = self.lstm.get_hr_map_current_block_coordinates()
        shift_x = bx - self.block_x
        shift_y = by - self.block_y
        self.block_x, self.block_y = bx, by
        # re-seat the controller on the live window + rebuilt costmap
        t0 = time.perf_counter()
        self.hf = self._window_heightfield()
        t1 = time.perf_counter()
        self.costmap = self._build_costmap()
        self.prestage_misses += 1
        t2 = time.perf_counter()
        self.shift_phase_log.append({"hit": False, "reseat_s": round(t1 - t0, 4),
                                     "costmap_s": round(t2 - t1, 4)})
        # rebase controller-frame points by (-dy, +dx) (:569-575)
        new_pos = frames.rebase_on_shift(state.rovers.position, shift_x, shift_y)
        state = state._replace(rovers=state.rovers._replace(position=new_pos))
        goal_ctrl = frames.rebase_on_shift(goal_ctrl, shift_x, shift_y)
        return state, goal_ctrl, (shift_x, shift_y)

    # -- main loop (:466-576) ---------------------------------------------------

    def run(self, record_path: bool = True,
            noise_source: Callable[[int], Tensor] | None = None) -> LargeScaleRunResult:
        """Drive the rover to the goal, synchronously: a chunk on the
        device, one host read of five scalars, the terrain cascade, and on a
        block shift the re-seat, the costmap rebuild and the rebase.
        ``noise_source(chunk_index)`` ``(steps, 1, 2, K, H)`` replays given
        exploration noise (the tests replay the JAX package's); else it
        comes from a ``torch.Generator`` on the device seeded ``conf.seed``."""
        conf = self.conf
        state = self._initial_state()
        goal_ctrl = self._goal_ctrl()
        generator = None
        if noise_source is None or conf.loop.rover.slip_std > 0.0:
            generator = torch.Generator(device=self.device).manual_seed(conf.seed)

        path: List[tuple] = []
        shift_latencies: List[float] = []
        block_shifts = steps = chunk_idx = 0
        reached = False
        steady_after = 240  # sim steps of warm-up before steady-state timing
        t_steady, steps_at_steady = None, 0
        # per-chunk host-side phase accumulators (rate decomposition)
        acc = {"dispatch_s": 0.0, "fetch_s": 0.0, "terrain_s": 0.0, "shift_s": 0.0}
        self.chunk_phase_acc = acc
        self.costmap_log = [(0, self.costmap, self.frame)]
        sp = conf.terrain.starting_position
        t0 = time.perf_counter()
        while steps < conf.max_steps:
            if t_steady is None and steps >= steady_after:
                t_steady, steps_at_steady = time.perf_counter(), steps
            t_a = time.perf_counter()
            noise = None if noise_source is None else noise_source(chunk_idx)
            state, pose = self.chunk(state, goal_ctrl, generator, noise)
            steps += conf.terrain_check_every
            chunk_idx += 1
            t_b = time.perf_counter()
            # the single host <-> device round trip of the interval
            wx, wy, _hx, _hy, reached_f = pose.tolist()
            t_c = time.perf_counter()
            acc["dispatch_s"] += t_b - t_a
            acc["fetch_s"] += t_c - t_b
            if record_path:
                path.append((wx, wy))
            if reached_f:
                reached = True
                break

            # terrain cascade (the update gate lives inside the orchestrator)
            self.lstm.update_visual_mesh((wx - sp[0], wy - sp[1]))
            acc["terrain_s"] += time.perf_counter() - t_c

            if self.lstm.get_hr_map_current_block_coordinates() != (self.block_x, self.block_y):
                t_shift = time.perf_counter()
                state, goal_ctrl, _ = self._on_block_shift(state, goal_ctrl)
                if self.device.type == "cuda":
                    # the shift latency is what the rover waits: the device's
                    # share of the re-seat and the costmap build included
                    torch.cuda.synchronize(self.device)
                dt = time.perf_counter() - t_shift
                log = self.shift_phase_log[-1]
                log["rebase_s"] = round(dt - log["reseat_s"] - log["costmap_s"], 4)
                shift_latencies.append(dt)
                acc["shift_s"] += dt
                block_shifts += 1
                self.costmap_log.append((chunk_idx, self.costmap, self.frame))

        wall = time.perf_counter() - t0
        self.last_state = state
        wx, wy = self._world_position(state)
        return LargeScaleRunResult(
            reached=reached, steps=steps, block_shifts=block_shifts,
            distance_m=float(np.linalg.norm(np.asarray(conf.goal, np.float64)
                                            - np.asarray(conf.start, np.float64))),
            final_position=(wx, wy), wall_s=wall, shift_latencies_s=shift_latencies,
            costmap_rebuilds=block_shifts,
            path_world=np.asarray(path) if path else np.zeros((0, 2)),
            steady_steps=steps - steps_at_steady if t_steady else 0,
            steady_wall_s=(time.perf_counter() - t_steady) if t_steady else 0.0,
            prestage_hits=0, prestage_misses=self.prestage_misses)
