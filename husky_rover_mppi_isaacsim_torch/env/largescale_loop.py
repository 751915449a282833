"""Streamed-terrain full-stack closed loop.

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
window), replayed on the card as one CUDA graph (the JAX ``_make_chunk_fn``,
largescale_loop.py:318-415): the chunk's noise is drawn before it, and the
frame origin (a tensor, not the Python floats a capture would freeze) and
the rebased goal are copied into the graph's buffers at every chunk. The
window and the costmap are the graph's in-place arguments: it reads them
where they lie, and a re-seat (a block shift, a pre-staged hit, a resume)
copies the new window and costmap into them once. The synchronous loop then
hands the window buffer back to the streamer, so that one 7000^2 window
lives and deformation stamps reach the graph. The host then reads five
scalars (world position, world heading, reached) and runs the terrain
cascade. A costmap build is one launch of kernel K2.

Two loops, as in the JAX package. The synchronous one reads each chunk's
pose before the next chunk and pre-stages a predicted shift (the shifted
window and its costmap) on a background thread. The pipelined one
(``pipeline_depth > 0``, the default) keeps that many chunks in flight and
hands every terrain mutation to one worker thread: on the card the worker
issues its terrain work (block builds, crater stamps, costmaps with their
K2 launch) on its own CUDA stream, and a shift event carries a CUDA event
the main stream waits on before the first chunk that reads the new window
and costmap; poses come back through pinned host buffers. The dispatch
waits while the worker has not yet taken up a pose older than the
pipeline's own lag (``pipeline_depth + 1`` chunks) plus
``WORKER_SLACK_STEPS`` sim steps (:func:`dispatch_bound_chunks`; the
port's bound, not in the JAX loop: a graphed chunk runs a sim step in
~1 ms, faster than the cascade, and an unbounded lag left the terrain
metres behind the rover). Wheel-track
deformation (``deform``) stamps the live window in place once per chunk and
always runs the synchronous loop. A traverse checkpoints to one ``.npz``
file (:mod:`..aux.checkpoint`) and resumes from it: on the synchronous path
bit-identically, the control noise generator's state included.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import deque
from typing import Callable, List, Optional

import numpy as np
import torch
from torch import Tensor

from ..aux import checkpoint as ckpt
from ..core.device import run_device
from ..core.graphs import Graphed
from ..core.heightfield import HeightField
from ..mppi.critics import Costmap
from ..ops import measure
from ..physics.deformation import DeformationEngine, DeformationEngineConf
from ..terrain.costmap import as_costmap, update_costmap_with_obstacles
from ..terrain.orchestrator import LargeScaleConf, LargeScaleTerrainManager
from . import closed_loop, frames, rover_sim
from .closed_loop import ClosedLoopConfig, LoopState
from .rover_sim import RoverState


# The terrain worker's slack in the pipelined loop, in sim steps: beyond the
# pipeline's own lag of pipeline_depth + 1 chunks (the newest pose the host
# has read is that old when it dispatches), the dispatch waits while the
# worker has not yet taken up a pose more than this many steps older. 36
# steps (0.6 s at the 60 Hz physics step, <= 1.2 m at 2 m/s) keep the
# 12-step loop's bound of 8 chunks at depth 4; the 48-step loop of
# bench_torch.py's traverse gets 6 chunks (288 steps, <= 9.6 m), not 8
# (384 steps, <= 12.8 m).
WORKER_SLACK_STEPS = 36


def dispatch_bound_chunks(pipeline_depth: int, chunk_steps: int) -> int:
    """How many chunks the pipelined dispatch may run ahead of the pose
    the terrain worker has taken up: the pipeline's own lag of
    ``pipeline_depth + 1`` chunks and :data:`WORKER_SLACK_STEPS` sim steps,
    rounded up to whole chunks of ``chunk_steps``."""
    return pipeline_depth + 1 + -(-WORKER_SLACK_STEPS // chunk_steps)


@dataclasses.dataclass
class LargeScaleLoopConf:
    """Full-stack run configuration (the ``__main__`` parameters of
    visual_terrain_stack_full_terrain.py:377-455), under the JAX package's
    field names and defaults."""

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
    # Pre-stage the next block shift: when the heading lookahead crosses
    # into a new block, compose that window and build its costmap ahead of
    # time, so that the shift only swaps them in (the latency-hiding role of
    # the reference's 8+1 worker processes, high_resolution_DEM_workers.py).
    prestage_shifts: bool = True
    prestage_lookahead_m: float = 6.0
    # Chunks kept in flight beyond the one being processed: the host reads
    # the pose only for terrain gating and logging, which tolerates that
    # lag (a 12-step chunk is 0.2 s, <= 0.4 m at 2 m/s, against the 2 m
    # update gate and the 6 m lookahead). The dispatch also waits while the
    # terrain worker is more than WORKER_SLACK_STEPS sim steps behind that
    # lag (dispatch_bound_chunks). 0 = the synchronous loop; deformation
    # always runs it.
    pipeline_depth: int = 4
    # Every `checkpoint_every_steps` sim steps the traverse state goes to
    # `checkpoint_path`; `LargeScaleClosedLoop.resume(conf, path)` continues
    # it, bit-identically on the synchronous path. The pipelined path drains
    # first, so its snapshot is consistent at the drain point.
    checkpoint_path: Optional[str] = None
    checkpoint_every_steps: int = 0
    # Tests: on every pre-stage hit also run the synchronous rebuild and
    # require the staged costmap, and the staged window, to be equal to it
    # (costs the latency gain).
    verify_prestage: bool = False
    seed: int = 42
    deform: Optional[DeformationEngineConf] = None  # wheel-track deformation
    wheelbase: float = 0.512  # Husky front<->rear wheel separation (m)

    @property
    def costmap_size(self) -> int:
        """costmap = DEM grid / 8 (MPPI_isaac.py:271-272)."""
        return self.terrain.streamer_conf.window_px // 8


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
    prestage_hits: int = 0
    prestage_misses: int = 0
    # host seconds between consecutive chunk dispatches: the longest of the
    # run, and for each shift the longest within 12 chunks before and 2
    # after the first chunk that runs on the shifted window
    max_dispatch_gap_s: float = 0.0
    shift_dispatch_gaps_s: List[float] = dataclasses.field(default_factory=list)


def _roll_pass_counts(counts: Tensor, di_px: int, dj_px: int) -> Tensor:
    """Shift the per-pixel deformation pass counts like the window roll
    (``torch.roll(window, (-di, -dj))``) and zero the band that enters. One
    expression serves every direction: output pixel ``(r, c)`` keeps the
    count of ``(r + di, c + dj)`` where that lies in the window, so a jump
    of a whole window or more (the streamer's full rebuild) resets them
    all."""
    n0, n1 = counts.shape
    rolled = torch.roll(counts, (-di_px, -dj_px), (0, 1))
    rows = torch.arange(n0, device=counts.device)[:, None] + di_px
    cols = torch.arange(n1, device=counts.device)[None, :] + dj_px
    keep = (rows >= 0) & (rows < n0) & (cols >= 0) & (cols < n1)
    return torch.where(keep, rolled, torch.zeros_like(rolled))


def run_chunk(conf: LargeScaleLoopConf, hf: HeightField, costmap: Costmap, origin,
              state: LoopState, goal_ctrl: Tensor, generator: torch.Generator | None = None,
              noise=None, slip=None) -> tuple[LoopState, Tensor]:
    """``conf.terrain_check_every`` masked closed-loop steps (N=1) with no
    host sync: once the rover is inside the goal stop box (checked EVERY sim
    step, in the rotated frame: the box is axis-swapped but identical) the
    state freezes under a ``torch.where``, so a long chunk cannot overshoot
    through the box between host polls (MPPI_OO_current.py:670 stop
    semantics). ``noise`` ``(steps, 1, 2, K, H)`` (or a sequence of
    ``(1, 2, K, H)``) replays given draws, ``slip`` a sequence of ``(2, 1)``
    slip normals; else each step draws from ``generator``. ``origin`` is the
    controller frame's world origin ``(ox, oy)`` (``frames.BlockFrame.origin``),
    as floats or, for a CUDA graph of the chunk, as a ``(2,)`` tensor.

    Returns the state and a ``(5,)`` tensor: world x, y, world heading x, y,
    and 1.0 when the stop box was reached. The step index advances by the
    chunk's steps whether or not the state froze (the JAX package freezes
    it with the rest; a frozen rover is not stepped further)."""
    tol = conf.goal_tolerance

    def in_box(st):
        d = torch.abs(st.rovers.position[0] - goal_ctrl[0])
        return (d[0] < tol) & (d[1] < tol)

    def keep(old, new):
        return [torch.where(done, a, b) for a, b in zip(old, new)]

    done = in_box(state)
    for s in range(conf.terrain_check_every):
        new = closed_loop.closed_loop_step(conf.loop, hf, costmap, goal_ctrl, state, generator,
                                           None if noise is None else noise[s],
                                           None if slip is None else slip[s])
        state = LoopState(RoverState(*keep(state.rovers, new.rovers)),
                          type(new.ctrl)(*keep(state.ctrl, new.ctrl)),
                          *keep(state[2:7], new[2:7]), step_index=new.step_index)
        done = done | in_box(state)
    pos = state.rovers.position[0]
    h = state.rovers.heading[0]
    # rotated block frame -> world (frames.controller_to_world)
    ox, oy = origin[0], origin[1]
    pose = torch.stack([-pos[1] + ox, pos[0] + oy, -h[1], h[0], done.to(pos.dtype)])
    return state, pose


def _dispatch_gaps(times: List[float], shift_chunks: List[int]) -> tuple[float, List[float]]:
    """The longest gap between consecutive dispatches, and for each shift
    (seated before dispatch ``c``) the longest gap ending in ``[c - 12,
    c + 2]``."""
    gaps = np.diff(np.asarray(times, np.float64))
    if gaps.size == 0:
        return 0.0, [0.0 for _ in shift_chunks]
    around = []
    for c in shift_chunks:
        lo, hi = max(c - 12, 1), min(c + 2, len(times) - 1)
        around.append(float(gaps[lo - 1:hi].max()) if hi >= lo else 0.0)
    return float(gaps.max()), around


class _TerrainWorker:
    """One serial background thread owning every terrain-side mutation of
    the pipelined loop: shift pre-staging, the update cascade (streamer
    roll, crater sampling, clipmaps, rocks) and the shift-time costmap
    build. The main thread dispatches chunks, submits (coalesced) poses
    here and applies completed shift events, so the crater generator, the
    rock store, ``rocks_data`` and the streamer's window and anchor are
    touched by this thread alone (JAX ``_TerrainWorker``).

    On the card the thread issues its device work on a stream of its own;
    each shift event carries a CUDA event recorded on that stream after its
    window and costmap are complete. A failure is kept in ``error`` and
    raised by the main loop."""

    def __init__(self, loop: "LargeScaleClosedLoop"):
        self.loop = loop
        self._cond = threading.Condition()
        self._pending = None      # newest submitted (pose, chunk index), coalesced
        self._started = -1        # chunk index of the newest pose taken up
        self._busy = False
        self._stop = False
        self._events: List[dict] = []
        self._last_block = (loop.block_x, loop.block_y)
        self.error: Optional[BaseException] = None
        self.terrain_s = 0.0
        self.prestage_s = 0.0
        self.stream = None
        if loop.device.type == "cuda":
            self.stream = torch.cuda.Stream(device=loop.device)
            # the worker's first reads (the window, the cached blocks) were
            # written on the main stream
            self.stream.wait_stream(torch.cuda.current_stream(loop.device))
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, pose, chunk: int) -> None:
        """Queue the world pose after chunk ``chunk``; a not-yet-started
        older pose is replaced (the cascade gates on 2 m of travel, so only
        the newest matters, and the streamer never re-anchors backwards off
        a stale pose)."""
        with self._cond:
            self._pending = (pose, chunk)
            self._cond.notify_all()

    def wait_for(self, chunk: int) -> bool:
        """Block while the worker still has work and has not yet taken up
        the pose of chunk ``chunk`` or a later one: the bound on how far
        the rover may run ahead of the terrain. Returns whether it
        blocked."""
        blocked = False
        with self._cond:
            while (self._started < chunk and (self._pending is not None or self._busy)
                   and self.error is None):
                blocked = True
                self._cond.wait(timeout=0.2)
        return blocked

    def pop_events(self) -> List[dict]:
        with self._cond:
            evs, self._events = self._events, []
            return evs

    def drain(self) -> None:
        """Block until the queue is empty and the worker is idle."""
        with self._cond:
            while (self._pending is not None or self._busy) and self.error is None:
                self._cond.wait(timeout=0.2)

    def stop(self) -> None:
        with self._cond:
            self._stop = True
            self._pending = None  # no further cascade on teardown
            self._cond.notify_all()
        self._thread.join(timeout=60.0)

    def _run(self) -> None:
        ctx = (torch.cuda.stream(self.stream) if self.stream is not None
               else contextlib.nullcontext())
        with ctx:
            while True:
                with self._cond:
                    while self._pending is None and not self._stop:
                        self._cond.wait()
                    if self._pending is None and self._stop:
                        return
                    (pose, self._started), self._pending = self._pending, None
                    self._busy = True
                    self._cond.notify_all()
                try:
                    if self.error is None:
                        self._process(pose)
                except BaseException as e:  # raised by the main loop
                    self.error = e
                finally:
                    with self._cond:
                        self._busy = False
                        self._cond.notify_all()

    def _process(self, pose) -> None:
        loop = self.loop
        wx, wy, hx, hy = pose
        t0 = time.perf_counter()
        if loop.conf.prestage_shifts:
            loop._prestage_inline(wx, wy, hx, hy)
        t1 = time.perf_counter()
        self.prestage_s += t1 - t0
        sp = loop.conf.terrain.starting_position
        updated, corrected = loop.lstm.update_visual_mesh((wx - sp[0], wy - sp[1]))
        bx, by = loop.lstm.get_hr_map_current_block_coordinates()
        if (bx, by) != self._last_block:
            self._last_block = (bx, by)
            upd_pos = loop.lstm._to_global(corrected) if updated else (wx, wy)
            ev = loop._prepare_shift_event(bx, by, upd_pos)
            if self.stream is not None:
                ev["event"] = torch.cuda.Event()
                ev["event"].record(self.stream)
            with self._cond:
                self._events.append(ev)
        self.terrain_s += time.perf_counter() - t1


class LargeScaleClosedLoop:
    """Host-side loop that seats the closed loop on the streamed window."""

    def __init__(self, conf: LargeScaleLoopConf, lstm: LargeScaleTerrainManager | None = None,
                 phase_cb: Callable[[str, float], None] | None = None, device=None):
        """``lstm`` injects a prebuilt terrain manager (on ``device``);
        ``phase_cb(name, seconds)`` gets one call per construction phase.
        ``device`` is where the terrain, the state and the controller live
        (default: the card; see :func:`..core.device.run_device`)."""
        t0 = time.perf_counter()

        def _mark(name):
            nonlocal t0
            if phase_cb is not None:
                if self.device.type == "cuda":
                    torch.cuda.synchronize(self.device)
                phase_cb(name, time.perf_counter() - t0)
            t0 = time.perf_counter()

        self.conf = conf
        self.device = run_device(device)
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
        # verify_prestage also composes every swapped-in staged window again
        streamer.verify_stage = conf.verify_prestage
        self.block_x, self.block_y = self.lstm.get_hr_map_current_block_coordinates()
        self.hf = self._window_heightfield()
        _mark("window_heightfield")
        # costmap builds by kind: K2 launches once per build with obstacles
        self.costmap_builds = {"first": 0, "staged": 0, "miss": 0, "verify": 0}
        self.costmap = self._build_costmap()
        self.costmap_builds["first"] += 1
        _mark("first_costmap")
        self.deform_engine = DeformationEngine(conf.deform) if conf.deform is not None else None
        self.pass_counts: Tensor | None = None
        if self.deform_engine is not None:
            self.pass_counts = torch.zeros(streamer.window.shape, dtype=torch.int32,
                                           device=self.device)
        self._staged = None          # (center block key, rock keys, costmap)
        self._prestage_thread: threading.Thread | None = None
        self._staging_key = None     # the crossing the thread in flight stages
        self._prestage_error: BaseException | None = None
        self.prestage_hits = 0
        self.prestage_misses = 0
        self.shift_phase_log: List[dict] = []  # per-shift phase timings
        # (first chunk served, costmap, frame, world position of its rocks)
        self.costmap_log: List[tuple] = []
        self.last_state: LoopState | None = None
        self.worker_s = {"terrain_s": 0.0, "prestage_s": 0.0}
        self.dispatched_steps = 0  # sim steps issued by the last run (chunks in flight included)
        self.worker_blocking_waits = 0  # dispatches of the last pipelined run that waited
        # the chunk: a CUDA graph on the card (run_chunk itself runs it
        # eagerly) that reads its window and costmap in place: the leaves
        # below, which _seat_leaves fills from the live window and costmap
        self.chunk_fn: Callable = Graphed(run_chunk, in_place_args=(1, 2))
        self._leaf_hf = self.hf
        self._leaf_cm = Costmap(*(t.clone() for t in self.costmap))
        self._seated = (self.hf.z, *self.costmap)

    @property
    def frame(self) -> frames.BlockFrame:
        """The controller frame's anchor, as floats."""
        return frames.BlockFrame(float(self.block_x), float(self.block_y),
                                 float(self.half_block))

    def _scalar(self, v: float) -> Tensor:
        return torch.tensor(v, dtype=torch.float32, device=self.device)

    def _full(self, v: float) -> Tensor:
        """A 0-d float32 tensor filled on the device (no host round trip)."""
        return torch.full((), float(v), dtype=torch.float32, device=self.device)

    # -- the chunk -----------------------------------------------------------

    def chunk(self, state: LoopState, goal_ctrl: Tensor, generator: torch.Generator | None = None,
              noise: Tensor | None = None) -> tuple[LoopState, Tensor]:
        """One :func:`run_chunk` on the live window, costmap and frame, run
        by ``chunk_fn`` (on the card one graph replay, whose outputs the
        next chunk overwrites), its draws made first in the eager chunk's
        order; with deformation, then one wheel-track stamp on the live
        window."""
        n = self.conf.terrain_check_every
        draws = [closed_loop.draw_step_noise(self.conf.loop, generator, 1, noise=(
            None if noise is None else noise[s]), device=self.device) for s in range(n)]
        slips = None if draws[0][1] is None else tuple(d[1] for d in draws)
        hf, costmap = self._seat_leaves()
        state, pose = self.chunk_fn(self.conf, hf, costmap, self.origin(), state,
                                    goal_ctrl, None, tuple(d[0] for d in draws), slips)
        if self.deform_engine is not None:
            self._deform(state)
        return state, pose

    def origin(self) -> Tensor:
        """The controller frame's world origin ``(ox, oy)`` as a float32
        ``(2,)`` tensor on the device, made by fills (no host sync)."""
        ox, oy = self.frame.origin()
        return torch.stack([self._full(ox), self._full(oy)])

    def wheel_stamp_inputs(self, state: LoopState) -> tuple[Tensor, Tensor, Tensor]:
        """The four wheels' world positions ``(4, 2)`` from the rover's world
        pose, their yaws ``(4,)`` and measured normal loads ``(4,)``
        (``wheel_contact_forces``): the inputs of one wheel-track stamp."""
        conf = self.conf
        loads = rover_sim.wheel_contact_forces(conf.loop.rover, self.hf, state.rovers,
                                               wheelbase=conf.wheelbase)
        pos, h = state.rovers.position[0], state.rovers.heading[0]
        ox, oy = self.frame.origin()
        # rotated block frame -> world (as in run_chunk's pose)
        wx, wy, hx, hy = -pos[1] + ox, pos[0] + oy, -h[1], h[0]
        yaw = torch.atan2(hy, hx)
        fwd = torch.stack([hx, hy])
        left = torch.stack([-hy, hx])
        body = torch.stack([wx, wy])
        wb, track = conf.wheelbase, conf.loop.rover.track
        positions = torch.stack([
            body + fwd * wb / 2 + left * track / 2,
            body + fwd * wb / 2 - left * track / 2,
            body - fwd * wb / 2 + left * track / 2,
            body - fwd * wb / 2 - left * track / 2,
        ])
        return positions, yaw.expand(4), loads[0]

    def _deform(self, state: LoopState) -> None:
        """Wheel-track deformation from the measured per-wheel loads, once
        per chunk (simulation_manager_ros2.py:231-233 semantics; JAX
        :392-413): one ``deform_window`` stamp into the live window and its
        pass counts, in place, so that ``streamer.window`` and ``self.hf.z``
        (the same tensor) are the deformed window. No host sync."""
        streamer = self.lstm.map_manager.streamer
        wox, woy = streamer.window_origin()
        self.deform_engine.deform_window(
            streamer.window, self.pass_counts, streamer._res, (self._full(wox), self._full(woy)),
            *self.wheel_stamp_inputs(state))

    # -- window / costmap seating ----------------------------------------------

    def _seat_leaves(self) -> tuple[HeightField, Costmap]:
        """The chunk graph's window and costmap leaves, holding the live
        ``hf`` and ``costmap``: copied into them on the current stream when
        the live ones are other tensors than at the last seat (a shift, a
        pre-staged hit, a re-seat, a resume), else left as they are. In
        place writes into the live window (deformation) reach the graph
        because the synchronous loop seats the leaf itself as the live
        window (:meth:`_adopt_window`)."""
        live = (self.hf.z, *self.costmap)
        if any(a is not b for a, b in zip(live, self._seated)):
            for leaf, t in zip((self._leaf_hf.z, *self._leaf_cm), live):
                if leaf is not t:
                    leaf.copy_(t)
            self._seated = live
        return self._leaf_hf, self._leaf_cm

    def _adopt_window(self) -> None:
        """Synchronous loop, after the streamer's window changed: copy it
        into the graph's window leaf and hand the leaf back to the streamer
        as its window (the new tensor is released), so that one window
        lives and ``hf`` is the leaf. The pipelined loop does not: its
        streamer belongs to the terrain worker."""
        streamer, leaf = self.lstm.map_manager.streamer, self._leaf_hf.z
        if streamer.window is not leaf:
            leaf.copy_(streamer.window)
            streamer.window = leaf
        self.hf = self._leaf_hf

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
        block, and cached), so a costmap staged from a predicted position is
        equal to the synchronous rebuild."""
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

    def costmap_for(self, block_xy, rocks_position) -> Costmap:
        """The synchronous build of the costmap for a center block and the
        rocks around a world position: what a seated costmap (a
        ``costmap_log`` entry) must equal."""
        return self._build_costmap(block_xy=block_xy, obstacles=self._rocks_for(rocks_position))

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

    def _generator(self, resume: Optional[dict]) -> torch.Generator:
        """The control noise generator: seeded ``conf.seed``, or at the
        state a checkpoint stored."""
        gen = torch.Generator(device=self.device).manual_seed(self.conf.seed)
        if resume and resume.get("generator_state") is not None:
            gen.set_state(resume["generator_state"])
        return gen

    # -- shift pre-staging (the worker-pool latency hiding,
    #    high_resolution_DEM_workers.py:199-765) -------------------------------

    def _rock_keys(self, position) -> tuple:
        """Per-sampler rock-block indices a costmap built at ``position``
        depends on (sample_region quantizes to the sampler's block size)."""
        return tuple((int(np.floor(position[0] / s.conf.block_size)),
                      int(np.floor(position[1] / s.conf.block_size)))
                     for s in self.lstm.rock_samplers)

    def _quantized_update_pos(self, wx: float, wy: float) -> tuple:
        """The position ``update_visual_mesh`` would refresh rocks at (the
        orchestrator quantizes local coordinates to the update threshold)."""
        sp = self.conf.terrain.starting_position
        q = self.conf.terrain.update_every_n_meters
        lx, ly = wx - sp[0], wy - sp[1]
        return ((lx // q) * q + sp[0], (ly // q) * q + sp[1])

    def _would_shift(self, local) -> bool:
        """Whether ``update_visual_mesh(local)`` will shift the streamer
        window: the orchestrator's travel gate and quantization, then the
        anchor the streamer would adopt at that corrected position against
        its current one."""
        lstm = self.lstm
        q = lstm.settings.update_every_n_meters
        last = lstm.last_update_coordinates
        if last is not None:
            dx = local[0] - last[0]
            dy = local[1] - last[1]
            if (dx * dx + dy * dy) ** 0.5 <= q:
                return False
        corrected = ((local[0] // q) * q, (local[1] // q) * q)
        gx, gy = lstm._to_global(corrected)
        streamer = lstm.map_manager.streamer
        n = streamer.conf.num_blocks + 1
        bx, by = streamer.block_index((gx, gy))
        return (bx - n, by - n) != streamer.anchor

    def _join_prestage(self) -> None:
        """Wait for an in-flight background pre-stage; raise what it
        raised."""
        t = self._prestage_thread
        if t is not None:
            t.join()
        self._prestage_thread = None
        err, self._prestage_error = self._prestage_error, None
        if err is not None:
            raise err

    def _predict_crossing(self, wx: float, wy: float, hx: float, hy: float):
        """The crossing predictor of both pre-staging paths: the heading
        lookahead's center-block SW corner and the anchor the streamer would
        adopt there, or ``None`` when no crossing is imminent. Returns
        ``(key, new_anchor, px, py)``."""
        streamer = self.lstm.map_manager.streamer
        bs = streamer.conf.block_size
        L = self.conf.prestage_lookahead_m
        norm = float(np.hypot(hx, hy)) or 1.0
        px, py = wx + L * hx / norm, wy + L * hy / norm
        pred_blk = streamer.block_index((px, py))
        cur_blk = streamer.block_index((wx, wy))
        if pred_blk == cur_blk:
            return None
        a = streamer.anchor
        new_anchor = (a[0] + pred_blk[0] - cur_blk[0], a[1] + pred_blk[1] - cur_blk[1])
        return ((pred_blk[0] * bs, pred_blk[1] * bs), new_anchor, px, py)

    def _stage(self, key, px: float, py: float) -> None:
        """Build and keep the costmap for a predicted crossing."""
        qpos = self._quantized_update_pos(px, py)
        rock_keys = self._rock_keys(qpos)
        cm = self._build_costmap(block_xy=key, obstacles=self._rocks_for(qpos))
        self.costmap_builds["staged"] += 1
        self._staged = (key, rock_keys, cm)

    def _maybe_prestage(self, wx: float, wy: float, hx: float, hy: float) -> None:
        """Synchronous loop: predict the next center-block crossing from the
        heading lookahead and, on a background thread while the chunks go
        on, compose the shifted window inside the streamer and build its
        costmap. One staging in flight at a time; the main thread joins it
        before any update that will shift, and before staging another
        crossing (so which crossings are staged, and the crater draws their
        blocks make, follow from the poses alone: a resumed traverse repeats
        them). Under deformation no window is staged (the live window
        changes every chunk), as in the JAX package's background stage."""
        pred = self._predict_crossing(wx, wy, hx, hy)
        if pred is None:
            return
        key, new_anchor, px, py = pred
        if self._prestage_thread is not None:
            if self._prestage_thread.is_alive() and self._staging_key == key:
                return
            self._join_prestage()
        streamer = self.lstm.map_manager.streamer
        if self._staged is not None and self._staged[0] == key:
            if self.deform_engine is None:
                streamer.prestage_shift(new_anchor)
            return

        def work():
            try:
                if self.deform_engine is None:
                    streamer.prestage_shift(new_anchor)
                self._stage(key, px, py)
            except BaseException as e:  # raised by _join_prestage
                self._prestage_error = e

        self._staging_key = key
        self._prestage_thread = threading.Thread(target=work, daemon=True)
        self._prestage_thread.start()

    def _prestage_inline(self, wx: float, wy: float, hx: float, hy: float) -> None:
        """Pipelined loop: the same pre-staging, run on the terrain worker
        thread itself."""
        pred = self._predict_crossing(wx, wy, hx, hy)
        if pred is None:
            return
        key, new_anchor, px, py = pred
        self.lstm.map_manager.streamer.prestage_shift(new_anchor)
        if self._staged is not None and self._staged[0] == key:
            return
        self._stage(key, px, py)

    def _seat_costmap(self, bx, by, update_pos) -> tuple[Costmap, bool]:
        """The costmap for the new center block: the staged one when its
        block and rock-region keys match what the synchronous rebuild would
        use (then equal to it, rock blocks being keyed by seed and block),
        else the rebuild. With ``verify_prestage`` a hit is also rebuilt and
        must be ``torch.equal`` to the staged costmap."""
        staged, self._staged = self._staged, None
        hit = (staged is not None and staged[0] == (bx, by) and update_pos is not None
               and staged[1] == self._rock_keys(update_pos))
        if not hit:
            self.costmap_builds["miss"] += 1
            return self._build_costmap(block_xy=(bx, by)), False
        if self.conf.verify_prestage:
            sync = self._build_costmap(block_xy=(bx, by))
            self.costmap_builds["verify"] += 1
            if not torch.equal(staged[2].cost, sync.cost):
                raise AssertionError("staged costmap != synchronous rebuild")
        return staged[2], True

    # -- pipelined shift events (worker -> main) -------------------------------

    def _prepare_shift_event(self, bx, by, upd_pos) -> dict:
        """Everything the main thread needs to re-seat after a block shift,
        made on the worker thread (the costmap build reads ``rocks_data`` and
        the rock store)."""
        t0 = time.perf_counter()
        cm, hit = self._seat_costmap(bx, by, upd_pos)
        return {"bx": bx, "by": by, "window": self.lstm.map_manager.streamer.window,
                "costmap": cm, "hit": hit, "rocks_pos": self.lstm._last_rocks_position,
                "costmap_s": round(time.perf_counter() - t0, 4)}

    def _apply_shift_event(self, ev: dict, state: LoopState, goal_ctrl: Tensor):
        """Main-thread half of a pipelined block shift: the main stream
        waits for the event's window and costmap, then the re-seat and one
        rebase of the (possibly still in-flight) state; no host wait."""
        t0 = time.perf_counter()
        if "event" in ev:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(ev["event"])
            # made on the worker's stream and read on this one: the caching
            # allocator must not reuse them before this stream's reads end
            ev["window"].record_stream(stream)
            for t in ev["costmap"]:
                t.record_stream(stream)
        bx, by = ev["bx"], ev["by"]
        shift_x, shift_y = bx - self.block_x, by - self.block_y
        self.block_x, self.block_y = bx, by
        self.hf = HeightField.create(ev["window"], self.window_half)
        self.costmap = ev["costmap"]
        if ev["hit"]:
            self.prestage_hits += 1
        else:
            self.prestage_misses += 1
        new_pos = frames.rebase_on_shift(state.rovers.position, shift_x, shift_y)
        state = state._replace(rovers=state.rovers._replace(position=new_pos))
        goal_ctrl = frames.rebase_on_shift(goal_ctrl, shift_x, shift_y)
        self.shift_phase_log.append({
            "hit": ev["hit"], "reseat_s": 0.0,
            "costmap_s": ev["costmap_s"] if not ev["hit"] else 0.0,
            "worker_costmap_s": ev["costmap_s"],
            "rebase_s": round(time.perf_counter() - t0, 4)})
        return state, goal_ctrl

    # -- block-shift rebasing (:546-576) ---------------------------------------

    def _on_block_shift(self, state: LoopState, goal_ctrl: Tensor, update_pos=None) -> tuple:
        self._join_prestage()
        bx, by = self.lstm.get_hr_map_current_block_coordinates()
        shift_x = bx - self.block_x
        shift_y = by - self.block_y
        self.block_x, self.block_y = bx, by
        # re-seat the controller on the live window and the staged or
        # rebuilt costmap
        t0 = time.perf_counter()
        self._adopt_window()
        t1 = time.perf_counter()
        self.costmap, hit = self._seat_costmap(bx, by, update_pos)
        if hit:
            self.prestage_hits += 1
        else:
            self.prestage_misses += 1
        t2 = time.perf_counter()
        self.shift_phase_log.append({"hit": hit, "reseat_s": round(t1 - t0, 4),
                                     "costmap_s": round(t2 - t1, 4)})
        # rebase controller-frame points by (-dy, +dx) (:569-575)
        new_pos = frames.rebase_on_shift(state.rovers.position, shift_x, shift_y)
        state = state._replace(rovers=state.rovers._replace(position=new_pos))
        goal_ctrl = frames.rebase_on_shift(goal_ctrl, shift_x, shift_y)
        return state, goal_ctrl, (shift_x, shift_y)

    # -- checkpoint / resume -----------------------------------------------------

    def _template(self, meta: dict) -> dict:
        """The :func:`..aux.checkpoint.restore` template of a traverse
        checkpoint with ``meta``'s structure (the JAX package's leaves)."""
        state0 = self._initial_state()
        template = {
            "state": state0,
            "costmap": self.costmap,
            "craters": {k: {"c": np.zeros((n, 2), np.float64), "r": np.zeros((n,), np.float64)}
                        for k, n in meta["crater_counts"].items()},
            "path": np.zeros((meta["path_len"], 2), np.float64),
        }
        if meta["has_window"]:
            shape = self.lstm.map_manager.streamer.window.shape
            template["window"] = torch.zeros(shape, dtype=torch.float32, device=self.device)
            template["counts"] = torch.zeros(shape, dtype=torch.int32, device=self.device)
        return template

    def save_checkpoint(self, path, state: LoopState, chunk_idx: int, steps: int, path_world,
                        generator: torch.Generator | None = None) -> None:
        """Write the traverse to ``path`` through :mod:`..aux.checkpoint`:
        the loop state, the costmap, the crater metadata and the crater
        generator's state, the frame and cascade cursors, and the control
        noise generator's state (a ``uint8`` leaf the JAX package ignores).
        Without deformation the window is not stored: it re-composes exactly
        from the crater metadata. With deformation the window and the pass
        counts carry the track history and are stored."""
        streamer = self.lstm.map_manager.streamer
        craters = {f"{bx}|{by}": {"c": np.asarray(blk[0], np.float64).reshape(-1, 2),
                                  "r": np.asarray(blk[1], np.float64).reshape(-1)}
                   for (bx, by), blk in streamer.crater_blocks.items()}
        payload = {
            "state": state,
            "costmap": self.costmap,
            "craters": craters,
            "path": np.asarray(path_world, np.float64).reshape(-1, 2),
        }
        if self.deform_engine is not None:
            payload["window"] = streamer.window
            payload["counts"] = self.pass_counts
        if generator is not None:
            payload["generator"] = generator.get_state()
        lu = self.lstm.last_update_coordinates or (0.0, 0.0)
        rp = self.lstm._last_rocks_position
        meta = {
            "chunk_idx": int(chunk_idx),
            "steps": int(steps),
            "block_x": float(self.block_x),
            "block_y": float(self.block_y),
            "anchor": [int(a) for a in streamer.anchor],
            "last_update": [float(v) for v in lu],
            "rocks_pos": [float(v) for v in rp] if rp is not None else None,
            "rng_state": streamer.rng.bit_generator.state,
            "crater_counts": {k: int(v["r"].shape[0]) for k, v in craters.items()},
            "path_len": int(payload["path"].shape[0]),
            "prestage_hits": self.prestage_hits,
            "prestage_misses": self.prestage_misses,
            "has_window": self.deform_engine is not None,
        }
        ckpt.save(path, payload, meta)

    def load_checkpoint(self, path) -> tuple[dict, dict]:
        """``(payload, meta)`` of a traverse checkpoint written by either
        package, on this loop's device. The control noise generator's state
        is under ``payload["generator"]`` where the file has one (the JAX
        package writes none)."""
        meta = ckpt.load_metadata(path)
        template = self._template(meta)
        shape = ckpt.leaf_shapes(path).get("generator")
        if shape is not None:
            template["generator"] = torch.zeros(shape, dtype=torch.uint8)  # on the CPU
        return ckpt.restore(path, template)

    @classmethod
    def resume(cls, conf: LargeScaleLoopConf, path, device=None,
               lstm: LargeScaleTerrainManager | None = None):
        """Rebuild a loop from a checkpoint. Returns ``(loop, resume_info)``;
        pass the info to :meth:`run` as ``_resume`` to continue the
        traverse, on the synchronous path bit-identically to the
        uninterrupted run (terrain blocks come from the restored crater
        metadata and generator state, the window re-composes exactly, and
        the control noise generator continues from its stored state)."""
        loop = cls(conf, lstm=lstm, device=device)
        streamer = loop.lstm.map_manager.streamer
        payload, meta = loop.load_checkpoint(path)
        streamer.crater_blocks = {
            tuple(int(v) for v in k.split("|")): (np.asarray(payload["craters"][k]["c"]),
                                                  np.asarray(payload["craters"][k]["r"]))
            for k in payload["craters"]}
        streamer.rng.bit_generator.state = meta["rng_state"]
        streamer._staged_shift = None
        anchor = tuple(meta["anchor"])
        if meta["has_window"]:
            streamer.anchor = anchor
            streamer.window = payload["window"].contiguous()
            loop.pass_counts = payload["counts"].contiguous()
        elif streamer.anchor != anchor:
            # re-compose at the saved anchor from the restored crater
            # metadata (the full-rebuild path)
            n_off = streamer.conf.num_blocks + 1
            bs = streamer.conf.block_size
            streamer.anchor = None
            streamer.update(((anchor[0] + n_off) * bs + bs / 2.0,
                             (anchor[1] + n_off) * bs + bs / 2.0))
            assert streamer.anchor == anchor, (streamer.anchor, anchor)
        loop.block_x, loop.block_y = meta["block_x"], meta["block_y"]
        loop._adopt_window()
        loop.costmap = payload["costmap"]
        loop.lstm.last_update_coordinates = tuple(meta["last_update"])
        loop.prestage_hits = meta["prestage_hits"]
        loop.prestage_misses = meta["prestage_misses"]
        if meta["rocks_pos"] is not None:
            # rocks_data re-assembles from the seed-keyed rock store
            rp = tuple(meta["rocks_pos"])
            rocks_data = []
            for sampler in loop.lstm.rock_samplers:
                blk = sampler.sample_region(rp, block_span=conf.terrain.rock_block_span)
                rocks_data.append(blk.coordinates)
                rocks_data.append(blk.scale)
            loop.lstm.rocks_data = rocks_data
            loop.lstm._last_rocks_position = rp
        state = payload["state"]
        info = {"state": state,
                "chunk_idx": meta["chunk_idx"], "steps": meta["steps"],
                "path": [tuple(p) for p in np.asarray(payload["path"])],
                "generator_state": payload.get("generator")}
        return loop, info

    # -- main loop (:466-576) ---------------------------------------------------

    def measure_device_rate(self, chunks: int = 20) -> float:
        """Device rate of the chunk in sim steps per second: ``chunks``
        chunks issued back to back with no host read between them and one
        synchronize at the end (one warm-up chunk first). The gap to the
        ``run()`` wall rate is the host reads and the terrain bookkeeping.
        Advances from the last run's state (with deformation, stamps the
        window) and does not change the loop's result."""
        state = self.last_state if self.last_state is not None else self._initial_state()
        goal_ctrl = self._goal_ctrl()
        gen = torch.Generator(device=self.device).manual_seed(self.conf.seed + 1)
        box = {"state": state}

        def one():
            box["state"], _ = self.chunk(box["state"], goal_ctrl, gen)

        ms = measure.issue_ms(one, calls=chunks, device=self.device)
        return self.conf.terrain_check_every / (ms / 1e3)

    def run(self, record_path: bool = True, noise_source: Callable[[int], Tensor] | None = None,
            _resume: Optional[dict] = None) -> LargeScaleRunResult:
        """Drive the rover to the goal. ``pipeline_depth > 0`` runs the
        pipelined loop, else (and always under deformation) the synchronous
        one. ``noise_source(chunk_index)`` ``(steps, 1, 2, K, H)`` replays
        given exploration noise (the tests replay the JAX package's); else
        it comes from a ``torch.Generator`` on the device seeded
        ``conf.seed``. ``_resume`` is the info dict of :meth:`resume`."""
        if self.deform_engine is not None or self.conf.pipeline_depth <= 0:
            return self._run_sync(record_path, noise_source, _resume)
        return self._run_pipelined(record_path, noise_source, _resume)

    def _result(self, reached, steps, block_shifts, costmap_rebuilds, wall, path,
                shift_latencies, steps_at_steady, t_steady, state, dispatch_times,
                shift_chunks) -> LargeScaleRunResult:
        self.last_state = closed_loop.clone_state(state)  # out of the chunk graph's buffers
        wx, wy = self._world_position(state)
        gap_max, gaps = _dispatch_gaps(dispatch_times, shift_chunks)
        return LargeScaleRunResult(
            reached=reached, steps=steps, block_shifts=block_shifts,
            distance_m=float(np.linalg.norm(np.asarray(self.conf.goal, np.float64)
                                            - np.asarray(self.conf.start, np.float64))),
            final_position=(wx, wy), wall_s=wall, shift_latencies_s=shift_latencies,
            costmap_rebuilds=costmap_rebuilds,
            path_world=np.asarray(path) if path else np.zeros((0, 2)),
            steady_steps=steps - steps_at_steady if t_steady else 0,
            steady_wall_s=(time.perf_counter() - t_steady) if t_steady else 0.0,
            prestage_hits=self.prestage_hits, prestage_misses=self.prestage_misses,
            max_dispatch_gap_s=gap_max, shift_dispatch_gaps_s=gaps)

    def _run_sync(self, record_path: bool, noise_source, _resume) -> LargeScaleRunResult:
        """The synchronous loop: a chunk on the device, one host read of
        five scalars, the terrain cascade, on a block shift the re-seat, the
        costmap (staged or rebuilt) and the rebase, else possibly a
        background pre-stage."""
        conf = self.conf
        streamer = self.lstm.map_manager.streamer
        state = self._initial_state()
        goal_ctrl = self._goal_ctrl()
        generator = None
        if noise_source is None or conf.loop.rover.slip_std > 0.0:
            generator = self._generator(_resume)

        path: List[tuple] = []
        shift_latencies: List[float] = []
        block_shifts = steps = chunk_idx = 0
        reached = False
        if _resume:
            state = _resume["state"]
            chunk_idx = _resume["chunk_idx"]
            steps = _resume["steps"]
            path = list(_resume["path"]) if record_path else []
        last_ckpt = steps
        steady_after = 240  # sim steps of warm-up before steady-state timing
        t_steady, steps_at_steady = None, 0
        # per-chunk host-side phase accumulators (rate decomposition)
        acc = {"dispatch_s": 0.0, "fetch_s": 0.0, "terrain_s": 0.0, "prestage_s": 0.0,
               "shift_s": 0.0}
        self.chunk_phase_acc = acc
        self.costmap_log = [(chunk_idx, self.costmap, self.frame, self.lstm._last_rocks_position)]
        dispatch_times: List[float] = []
        shift_chunks: List[int] = []
        sp = conf.terrain.starting_position
        t0 = time.perf_counter()
        try:
            while steps < conf.max_steps:
                if t_steady is None and steps >= steady_after:
                    t_steady, steps_at_steady = time.perf_counter(), steps
                t_a = time.perf_counter()
                dispatch_times.append(t_a)
                noise = None if noise_source is None else noise_source(chunk_idx)
                state, pose = self.chunk(state, goal_ctrl, generator, noise)
                steps += conf.terrain_check_every
                chunk_idx += 1
                t_b = time.perf_counter()
                # the single host <-> device round trip of the interval
                wx, wy, hx, hy, reached_f = pose.tolist()
                t_c = time.perf_counter()
                acc["dispatch_s"] += t_b - t_a
                acc["fetch_s"] += t_c - t_b
                if record_path:
                    path.append((wx, wy))
                if reached_f:
                    reached = True
                    break

                # terrain cascade (the update gate lives inside the
                # orchestrator); an update that will shift the window first
                # settles a background pre-stage (they share the crater
                # generator)
                local = (wx - sp[0], wy - sp[1])
                if self._would_shift(local):
                    self._join_prestage()
                updated, corrected = self.lstm.update_visual_mesh(local)
                acc["terrain_s"] += time.perf_counter() - t_c

                if self.lstm.get_hr_map_current_block_coordinates() != (self.block_x,
                                                                        self.block_y):
                    t_shift = time.perf_counter()
                    upd_pos = self.lstm._to_global(corrected) if updated else (wx, wy)
                    state, goal_ctrl, shift = self._on_block_shift(state, goal_ctrl,
                                                                   update_pos=upd_pos)
                    if self.deform_engine is not None:
                        # carried-over pixels keep their decay state; the
                        # band that enters starts at 0
                        res = streamer.conf.resolution
                        self.pass_counts = _roll_pass_counts(
                            self.pass_counts, int(round(shift[0] / res)),
                            int(round(shift[1] / res)))
                    if self.device.type == "cuda":
                        # the shift latency is what the rover waits: the
                        # device's share of the re-seat and the costmap
                        torch.cuda.synchronize(self.device)
                    dt = time.perf_counter() - t_shift
                    log = self.shift_phase_log[-1]
                    log["rebase_s"] = round(dt - log["reseat_s"] - log["costmap_s"], 4)
                    shift_latencies.append(dt)
                    acc["shift_s"] += dt
                    block_shifts += 1
                    shift_chunks.append(len(dispatch_times))
                    self.costmap_log.append((chunk_idx, self.costmap, self.frame,
                                             self.lstm._last_rocks_position))
                elif conf.prestage_shifts:
                    t_p = time.perf_counter()
                    self._maybe_prestage(wx, wy, hx, hy)
                    acc["prestage_s"] += time.perf_counter() - t_p

                if (conf.checkpoint_every_steps and conf.checkpoint_path
                        and steps - last_ckpt >= conf.checkpoint_every_steps):
                    self._join_prestage()
                    self.save_checkpoint(conf.checkpoint_path, state, chunk_idx, steps, path,
                                         generator)
                    last_ckpt = steps
        finally:
            t = self._prestage_thread
            if t is not None:
                t.join()
        self._join_prestage()
        wall = time.perf_counter() - t0
        self.hf = self._window_heightfield()
        self.dispatched_steps = steps
        return self._result(reached, steps, block_shifts, block_shifts, wall, path,
                            shift_latencies, steps_at_steady, t_steady, state, dispatch_times,
                            shift_chunks)

    def _run_pipelined(self, record_path: bool, noise_source, _resume) -> LargeScaleRunResult:
        """Keep ``pipeline_depth`` chunks in flight and consume poses that
        many chunks late. Correct under the lag: the goal stop box freezes
        the state on the device every sim step, terrain updates gate on 2 m
        of travel, and a block shift is a re-seat: chunks issued before it
        run in the old frame, whose world poses are frame-independent, and
        the state is rebased once when the event applies. Each chunk's pose
        goes to a pinned host buffer (``non_blocking``) with a CUDA event
        recorded after it; the host waits on that event ``pipeline_depth``
        chunks later, and issues no other sync."""
        conf = self.conf
        state = self._initial_state()
        goal_ctrl = self._goal_ctrl()
        generator = None
        if noise_source is None or conf.loop.rover.slip_std > 0.0:
            generator = self._generator(_resume)
        n = conf.terrain_check_every
        depth = conf.pipeline_depth
        bound = dispatch_bound_chunks(depth, n)
        cuda = self.device.type == "cuda"
        pinned = [torch.empty(5, dtype=torch.float32, pin_memory=cuda) for _ in range(depth + 1)]

        path: List[tuple] = []
        shift_latencies: List[float] = []
        block_shifts = 0
        reached = False
        processed_steps = 0
        steady_after = 240
        t_steady, steps_at_steady = None, 0
        acc = {"dispatch_s": 0.0, "fetch_s": 0.0, "terrain_s": 0.0, "prestage_s": 0.0,
               "shift_s": 0.0, "worker_wait_s": 0.0}
        self.chunk_phase_acc = acc
        ready: deque = deque()   # (chunk index, pinned buffer, CUDA event)
        chunk_idx = dispatched_steps = 0
        if _resume:
            state = _resume["state"]
            chunk_idx = _resume["chunk_idx"]
            dispatched_steps = processed_steps = _resume["steps"]
            path = list(_resume["path"]) if record_path else []
        last_ckpt = dispatched_steps
        self.costmap_log = [(chunk_idx, self.costmap, self.frame, self.lstm._last_rocks_position)]
        dispatch_times: List[float] = []
        shift_chunks: List[int] = []
        self.worker_blocking_waits = 0
        worker = _TerrainWorker(self)
        t0 = time.perf_counter()

        def apply_events():
            nonlocal state, goal_ctrl, block_shifts
            for ev in worker.pop_events():
                t_s = time.perf_counter()
                state, goal_ctrl = self._apply_shift_event(ev, state, goal_ctrl)
                block_shifts += 1
                dt = time.perf_counter() - t_s
                shift_latencies.append(dt)
                acc["shift_s"] += dt
                shift_chunks.append(len(dispatch_times))
                self.costmap_log.append((chunk_idx, self.costmap, self.frame, ev["rocks_pos"]))

        def process(ci, buf, event) -> bool:
            """Read and consume one matured chunk's pose; True when the goal
            box latched inside it."""
            nonlocal processed_steps, t_steady, steps_at_steady
            t_b = time.perf_counter()
            if event is not None:
                event.synchronize()
            wx, wy, hx, hy, reached_f = buf.tolist()
            acc["fetch_s"] += time.perf_counter() - t_b
            if not reached:  # chunks after the goal latch are frozen
                processed_steps = (ci + 1) * n
            if t_steady is None and processed_steps >= steady_after:
                t_steady, steps_at_steady = time.perf_counter(), processed_steps
            if record_path and not reached:  # drop frozen duplicate poses
                path.append((wx, wy))
            if reached_f:
                return True
            worker.submit((wx, wy, hx, hy), ci)
            return False

        try:
            while dispatched_steps < conf.max_steps:
                if worker.error is not None:
                    raise worker.error
                apply_events()
                # the rover runs at most `bound` chunks ahead of the pose
                # the worker has taken up: a chunk replayed as a CUDA graph
                # outruns the cascade
                t_w = time.perf_counter()
                if worker.wait_for(chunk_idx - bound):
                    self.worker_blocking_waits += 1
                acc["worker_wait_s"] += time.perf_counter() - t_w
                t_a = time.perf_counter()
                dispatch_times.append(t_a)
                noise = None if noise_source is None else noise_source(chunk_idx)
                state, pose = self.chunk(state, goal_ctrl, generator, noise)
                buf = pinned[chunk_idx % (depth + 1)]
                buf.copy_(pose, non_blocking=cuda)
                event = None
                if cuda:
                    event = torch.cuda.Event()
                    event.record()
                ready.append((chunk_idx, buf, event))
                chunk_idx += 1
                dispatched_steps += n
                acc["dispatch_s"] += time.perf_counter() - t_a
                if len(ready) <= depth:
                    continue
                if process(*ready.popleft()):
                    reached = True
                    break
                if (conf.checkpoint_every_steps and conf.checkpoint_path
                        and processed_steps - last_ckpt >= conf.checkpoint_every_steps):
                    # a consistent snapshot: drain the chunks in flight and
                    # the terrain worker first
                    while ready:
                        if process(*ready.popleft()):
                            reached = True
                    if reached:
                        break
                    worker.drain()
                    if worker.error is not None:
                        raise worker.error  # never save a torn snapshot
                    apply_events()
                    self.save_checkpoint(conf.checkpoint_path, state, chunk_idx,
                                         dispatched_steps, path, generator)
                    last_ckpt = processed_steps
            # drain: the remaining poses (frozen after the goal box), then
            # the trailing terrain events, so that the final seating matches
            # the streamer
            while ready:
                if process(*ready.popleft()):
                    reached = True
            worker.drain()
            if worker.error is not None:
                raise worker.error
            apply_events()
        finally:
            worker.stop()
            acc["terrain_s"] += worker.terrain_s
            acc["prestage_s"] += worker.prestage_s
            self.worker_s = {"terrain_s": worker.terrain_s, "prestage_s": worker.prestage_s}
            if worker.stream is not None:
                torch.cuda.current_stream(self.device).wait_stream(worker.stream)

        wall = time.perf_counter() - t0
        self.hf = self._window_heightfield()
        self.dispatched_steps = dispatched_steps
        return self._result(reached, processed_steps, block_shifts, block_shifts, wall, path,
                            shift_latencies, steps_at_steady, t_steady, state, dispatch_times,
                            shift_chunks)
