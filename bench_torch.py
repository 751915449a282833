"""Benchmark of the PyTorch port on one NVIDIA GPU: the port of bench.py.

    python3 bench_torch.py

Prints ONE JSON line, bench.py's:
  {"metric": "mppi_rollout_steps_per_s", "value": N, "unit": "rollout-steps/s",
   "vs_baseline": N / 3.3e7, "detail": {...}}

Baseline: the reference Warp GPU controller runs ~3 ms per control loop at
K=1000 x H=100 => ~3.3e7 rollout-steps/s (BASELINE.md row 1).

The functions are bench.py's, under its names, and each returns what its
JAX counterpart returns. They run on the device the world lives on; the
world is built on the card (``core.device.run_device``: no card, no run);
the bench functions run on the CPU only at the tests' tiny shapes.

Measurement. Every loop runs as a CUDA-graph replay (``core.graphs.Graphed``,
the counterpart of bench.py's jitted ``lax.scan``): N dependent control
loops of ``mppi_step`` + ``kinematic_advance`` replayed in blocks, the noise
of each loop drawn fresh from a ``torch.Generator`` on the card, before its
block, into the graph's own buffers (no copy on replay); the vec env's
physics steps as graphs of a block of steps; the goal-seek episode through
``goal_seek`` with one graph of 4 masked steps shared by its episodes; the
closed loop through ``run_episode`` with one step graph shared by its
episodes. Warm-up and capture are set-up: they
run before the clock starts, and each graph's capture time is reported
apart (``repeats[key]["capture_ms"]``). A timed call ends by pulling a
compute-dependent scalar to the host. As in bench.py, a per-loop or
per-step time is the slope between two numbers of loops or steps, so the
fixed cost of a call cancels out. Unlike bench.py (the best of 2), each
timed key is the median of ``REPEATS`` repeats in one process (a repeat is
one slope: both numbers of loops, back to back; for the goal-seek one
episode; for the traverse one fresh world and traverse), and ``repeats``
holds each key's min, median and spread ((max - min) / median). The rates
beside the times are derived from the median times. Nothing here runs
``torch.profiler``: a trace slows the paths timed after it in the same
process.

Control noise comes from ``torch.Generator``s, not JAX's threefry: the
goal-seek's loop count and the traverse's step count and shifts are the
port's own sample, not a replay of the JAX bench's. The vec env's starts are
JAX's draw (``core.jax_random``), the closed loop's start and goal bench.py's
numpy draw: both are bench.py's.
"""

from __future__ import annotations

import dataclasses
import json
import math
import subprocess
import time

import numpy as np
import torch

from husky_rover_mppi_isaacsim_torch import native
from husky_rover_mppi_isaacsim_torch.cli import build_standalone_world, use_full_fp32_matmul
from husky_rover_mppi_isaacsim_torch.core import jax_random as jr
from husky_rover_mppi_isaacsim_torch.core.device import run_device
from husky_rover_mppi_isaacsim_torch.core.graphs import Graphed
from husky_rover_mppi_isaacsim_torch.env import rover_sim
from husky_rover_mppi_isaacsim_torch.env.closed_loop import (
    ClosedLoopConfig,
    closed_loop_step,
    init_loop_state,
    run_episode,
)
from husky_rover_mppi_isaacsim_torch.env.largescale_loop import (
    LargeScaleClosedLoop,
    LargeScaleLoopConf,
)
from husky_rover_mppi_isaacsim_torch.env.rover_sim import RoverParams, RoverState
from husky_rover_mppi_isaacsim_torch.mppi.controller import (
    ControllerState,
    MPPIConfig,
    RobotState,
    goal_seek,
    kinematic_advance,
    masked_steps,
    mppi_step,
)
from husky_rover_mppi_isaacsim_torch.ops.crater_block_cuda import crater_block_cuda
from husky_rover_mppi_isaacsim_torch.terrain.orchestrator import LargeScaleConf

BASELINE_ROLLOUT_STEPS_PER_S = 3.3e7
DTYPE = torch.float32
REPEATS = 5
# the control-loop graph reads the world (DEM, costmap) and the noise
# buffers where they lie
LOOPS_IN_PLACE = (1, 2, 6)

# The line's keys: bench.py's ``detail`` keys, with its two Pallas-engine
# keys renamed for the one CUDA route, without the keys of the TPU-only
# machinery the port does not have (the XLA and one-hot gather engines, the
# MXU selection's flop count, the TPU relay, the engine fields), plus
# ``repeats``; under ``largescale_streamed`` also the longest dispatch gap,
# the dispatches that waited for the terrain worker and the peak device
# memory.
RENAMED = {"k1000_h100_pallas_loop_ms": "k1000_h100_cuda_loop_ms",
           "k16384_h64_pallas_loop_ms": "k16384_h64_cuda_loop_ms"}
DROPPED = frozenset({"k1000_h100_direct_loop_ms", "k1000_h100_onehot_loop_ms",
                     "selection_gflops_per_loop", "mxu_peak_pct_at_best_loop",
                     "relay_rt", "gather_engine", "patch_size"})
DETAIL_KEYS = frozenset({
    "methodology", "k1000_h100_cuda_loop_ms", "k1000_h100_steps_per_s",
    "k1000_h100_vs_ref_3ms", "k16384_h64_cuda_loop_ms", "k16384_h64_steps_per_s",
    "k16384_h64_body_critic_loop_ms", "k16384_h64_body_critic_steps_per_s",
    "vec_env_4096_step_us", "vec_env_rover_steps_per_s", "goal_seek_loop_ms",
    "goal_seek_loops", "closed_loop_step_ms", "closed_loop_steps_per_s", "device",
    "largescale_streamed", "repeats"})
LARGESCALE_KEYS = frozenset({
    "window_px", "resolution_m", "costmap_px", "build_s", "build_phases_s", "reached",
    "distance_m", "sim_steps", "block_shifts", "wall_s", "sim_steps_per_s",
    "shift_latency_ms_mean", "shift_latency_ms_max", "prestage_hits", "prestage_misses",
    "staged_window_swaps", "shift_phases", "host_phase_totals_s", "cascade_phase_totals_s",
    "chunk_steps", "device_sim_steps_per_s", "max_dispatch_gap_ms", "worker_blocking_waits",
    "peak_device_memory_gb"})
# the traverse's timed keys, whose repeats the line carries
LARGESCALE_TIMED = ("build_s", "wall_s", "sim_steps_per_s", "shift_latency_ms_mean",
                    "shift_latency_ms_max", "device_sim_steps_per_s", "max_dispatch_gap_ms")


def build_world(device=None):
    """bench.py's world through the port's ``cli.build_standalone_world``:
    the 1500^2 crater DEM over +-75 m and the 750^2 costmap with the exact
    EDT (kernel K2 runs once)."""
    device = run_device(device)
    hf, cm, _ = build_standalone_world({}, DTYPE, device)
    return hf, cm


def _sync(x) -> float:
    """Completion barrier: pull a compute-dependent scalar to the host."""
    return float(x)


def _record(record: dict | None, samples: list, graph: Graphed | None = None) -> None:
    """Hand a bench function's per-repeat seconds (and its graph's capture
    time) to the caller."""
    if record is not None:
        record["samples_s"] = list(samples)
        record["capture_ms"] = None if graph is None else graph.capture_ms


def _slope(timed, ns, seed0: int, graph: Graphed, record: dict | None) -> float:
    """bench.py's slope: ``timed(n, seed)`` at each n of ``ns`` (the
    warm-up, then the capture), then ``REPEATS`` times at both n back to
    back; returns the median of the seconds per unit between ``ns[0]`` and
    ``ns[1]``."""
    for n in ns:
        timed(n, 0)
    slopes = []
    for s in range(REPEATS):
        ts = {}
        for n in ns:
            t0 = time.perf_counter()
            timed(n, seed0 + s)
            ts[n] = time.perf_counter() - t0
        slopes.append((ts[ns[1]] - ts[ns[0]]) / (ns[1] - ns[0]))
    _record(record, slopes, graph)
    return float(np.median(slopes))


def control_loops(config: MPPIConfig, hf, cm, goal, robot: RobotState, ctrl: ControllerState,
                  noises: tuple):
    """One dependent control loop per noise ``(2, K, H)`` of ``noises``:
    ``mppi_step`` then ``kinematic_advance`` (bench.py's scan body, the
    reference's ``run()`` loop). Returns ``(robot, ctrl)``."""
    for noise in noises:
        ctrl, out = mppi_step(config, hf, cm, goal, robot, ctrl, noise)
        robot = kinematic_advance(config, robot, out)
    return robot, ctrl


def bench_control_loop(hf, cm, config: MPPIConfig, ns=(8, 32), record: dict | None = None):
    """Sustained seconds per control loop and rollout steps per second:
    the slope between ``ns[1]`` and ``ns[0]`` dependent loops, each loop
    one ``mppi_step`` + ``kinematic_advance`` with fresh noise, replayed as
    graphs of ``gcd(ns)`` loops (the median of ``REPEATS`` slopes). Each
    block's noise is drawn into the graph's own buffers, read in place, so
    a replay copies no noise (bench.py draws it inside its scan)."""
    dev = hf.z.device
    goal = torch.tensor([65.0, 60.0], dtype=DTYPE, device=dev)
    robot = RobotState.create(-60.0, -60.0, [1.0, 0.5, 0.0], dtype=DTYPE, device=dev)
    ctrl = ControllerState.create(config, DTYPE, dev)
    K, H = config.num_samples, config.horizon
    unroll = math.gcd(*ns)
    noises = tuple(torch.empty((2, K, H), dtype=DTYPE, device=dev) for _ in range(unroll))
    loops = Graphed(control_loops, in_place_args=LOOPS_IN_PLACE)

    def timed(n, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        r, c = robot, ctrl
        for _ in range(n // unroll):
            for noise in noises:
                noise.normal_(generator=gen)  # sample_noise's draw, in place
            r, c = loops(config, hf, cm, goal, r, c, noises)
        return _sync(r.position[0] + c.optimal_u1[0])

    per_loop = _slope(timed, ns, 50, loops, record)
    return per_loop, K * H / per_loop


def vec_env_steps(params: RoverParams, hf, state: RoverState, cmd, n: int) -> RoverState:
    """``n`` physics steps of every rover under the wheel command ``cmd``
    on both sides (bench.py's vec-env scan body)."""
    for _ in range(n):
        state = rover_sim.step(params, hf, state, cmd, cmd)
    return state


def vec_env_start(hf, num_rovers: int) -> tuple[RoverState, torch.Tensor]:
    """bench.py's vec-env start (bench.py:128-129): rovers at
    ``jax.random.uniform(key(0), (N, 2), float32, -50, 50)``, heading +x,
    standing on the DEM; the wheel command 1.5 m/s."""
    pos = jr.uniform(jr.key(0, hf.z.device), (num_rovers, 2), DTYPE, -50.0, 50.0)
    state = RoverState.create(pos, [1.0, 0.0, 0.0], hf)
    return state, torch.full((num_rovers,), 1.5, dtype=hf.z.dtype, device=hf.z.device)


def bench_vec_env(hf, num_rovers: int = 4096, ns=(100, 400), record: dict | None = None):
    """BASELINE config 2: N Husky instances in lockstep (skid-steer dynamics
    + surface riding); seconds per physics step and rover-steps per second,
    the slope between ``ns[1]`` and ``ns[0]`` steps replayed as graphs of
    ``gcd(ns)`` steps (the median of ``REPEATS`` slopes)."""
    params = RoverParams()
    state0, cmd = vec_env_start(hf, num_rovers)
    block = math.gcd(*ns)
    steps = Graphed(vec_env_steps, in_place_args=(1,))

    def timed(n, _seed):
        s = state0
        for _ in range(n // block):
            s = steps(params, hf, s, cmd, block)
        return _sync(s.position[0, 0] + s.position[-1, 1])

    per_step = _slope(timed, ns, 0, steps, record)
    return per_step, num_rovers / per_step


def bench_goal_seek(hf, cm, config: MPPIConfig, max_loops: int = 400,
                    record: dict | None = None):
    """End-to-end goal-seek: whole ``goal_seek`` episodes (a host read of
    the stop flag every 4 loops), one graph of 4 masked steps shared by
    every episode. Two warm-up episodes (the graph's warm-up and capture),
    then ``REPEATS`` timed ones; returns the median seconds per executed
    loop (the best is ``repeats``' min) and the loops of the last."""
    dev = hf.z.device
    goal = torch.tensor([65.0, 60.0], dtype=DTYPE, device=dev)
    robot = RobotState.create(-60.0, -60.0, [1.0, 0.5, 0.0], dtype=DTYPE, device=dev)
    ctrl = ControllerState.create(config, DTYPE, dev)
    steps_fn = Graphed(masked_steps, in_place_args=(2, 3))

    def episode(seed):
        return goal_seek(config, hf, cm, goal, robot, ctrl,
                         torch.Generator(device=dev).manual_seed(seed), max_loops=max_loops,
                         steps_fn=steps_fn)

    for s in (0, 1):
        int(episode(s).loops)
    per_loop, loops = [], 1
    for s in range(2, 2 + REPEATS):
        t0 = time.perf_counter()
        res = episode(s)
        loops = int(res.loops)
        _sync(res.robot.position[0])
        per_loop.append((time.perf_counter() - t0) / max(loops, 1))
    _record(record, per_loop, steps_fn)
    return float(np.median(per_loop)), loops


def bench_closed_loop(hf, cm, config: MPPIConfig, ns=(16, 64), record: dict | None = None):
    """Full-stack closed-loop env rate (3:1 latched/PI loop + rover physics
    + MPPI per sim step) for one rover through ``run_episode``, one step
    graph shared by every episode; seconds per sim step and sim steps per
    second, the slope between ``ns[1]`` and ``ns[0]`` steps (the median of
    ``REPEATS`` slopes)."""
    dev = hf.z.device
    cl = ClosedLoopConfig(mppi=config)
    rng = np.random.default_rng(0)
    starts = rng.uniform(-40, 40, (1, 2))
    goals = torch.as_tensor(rng.uniform(-40, 40, (1, 2)), dtype=DTYPE, device=dev)
    state0 = init_loop_state(cl, RoverState.create(starts, [1.0, 0.0, 0.0], hf))
    step_fn = Graphed(closed_loop_step, in_place_args=(1, 2))

    def timed(n, seed):
        s, _ = run_episode(cl, hf, cm, goals, state0, torch.Generator(device=dev).manual_seed(seed),
                           n, step_fn=step_fn)
        return _sync(s.rovers.position[0, 0])

    per_step = _slope(timed, ns, 10, step_fn, record)
    return per_step, 1.0 / per_step


def bench_largescale_conf(traverse_m: float = 100.0) -> LargeScaleLoopConf:
    """bench.py's traverse: the reference demo's scale at the shipped
    defaults (25 m blocks at 2.5 cm/px, a 7000^2 window, an 875^2 costmap;
    the pipelined loop, ``pipeline_depth=4``, pre-staging on), K=1000 x
    H=100, (0, 0) -> (``traverse_m``, 8) within 40,000 sim steps, in chunks
    of 48 sim steps (the terrain gate is 2 m of travel and the goal box is
    checked every sim step on the card, so a 48-step chunk, ~1.6 m at 2 m/s,
    loses nothing)."""
    return LargeScaleLoopConf(
        terrain=LargeScaleConf(),
        loop=ClosedLoopConfig(mppi=MPPIConfig(num_samples=1000, horizon=100),
                              rover=RoverParams()),
        start=(0.0, 0.0),
        goal=(traverse_m, 8.0),
        max_steps=40000,
        terrain_check_every=48,
    )


def _largescale_run(conf: LargeScaleLoopConf, device: torch.device) -> dict:
    """One fresh world and traverse under bench.py's keys (unrounded), and
    the port's own: the longest gap between two chunk dispatches, the
    dispatches that waited for the terrain worker, the peak device memory
    allocated since the build began."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t_build = time.perf_counter()
    loop = LargeScaleClosedLoop(conf, device=device)
    streamer = loop.lstm.map_manager.streamer
    _sync(streamer.window[::500, ::500].sum())  # the build's work done on the card
    t_build = time.perf_counter() - t_build
    res = loop.run(record_path=False)
    shifts = res.shift_latencies_s
    device_rate = loop.measure_device_rate(chunks=20)
    peak = torch.cuda.max_memory_allocated(device) / 1e9 if cuda else None
    return {
        "window_px": streamer.conf.window_px,
        "resolution_m": streamer.conf.resolution,
        "costmap_px": conf.costmap_size,
        "build_s": t_build,
        "build_phases_s": dict(loop.lstm.build_phase_acc),
        "reached": bool(res.reached),
        "distance_m": res.distance_m,
        "sim_steps": res.steps,
        "block_shifts": res.block_shifts,
        "wall_s": res.wall_s,
        # the steady-state rate: after the first 240 sim steps (the chunk
        # graph's warm-up and capture)
        "sim_steps_per_s": (res.steady_steps / res.steady_wall_s if res.steady_wall_s > 0
                            else res.steps / max(res.wall_s, 1e-9)),
        "shift_latency_ms_mean": 1e3 * float(np.mean(shifts)) if shifts else None,
        "shift_latency_ms_max": 1e3 * float(np.max(shifts)) if shifts else None,
        "prestage_hits": res.prestage_hits,
        "prestage_misses": res.prestage_misses,
        "staged_window_swaps": streamer.staged_shift_hits,
        "shift_phases": list(loop.shift_phase_log),
        "host_phase_totals_s": dict(loop.chunk_phase_acc),
        "cascade_phase_totals_s": dict(loop.lstm.cascade_phase_acc),
        "chunk_steps": conf.terrain_check_every,
        # chunks issued back to back, one synchronize: the card's rate
        "device_sim_steps_per_s": device_rate,
        "max_dispatch_gap_ms": 1e3 * res.max_dispatch_gap_s,
        "worker_blocking_waits": loop.worker_blocking_waits,
        "peak_device_memory_gb": peak,
    }


def bench_largescale(traverse_m: float = 100.0, device=None, record: dict | None = None):
    """Streamed-terrain closed loop at the reference demo's scale
    (visual_terrain_stack_full_terrain.py:424-426: 25 m blocks @2.5 cm/px,
    num_blocks=2 => 7000^2-px window, 875^2 costmap @0.2 m): ``REPEATS``
    fresh worlds and traverses of :func:`bench_largescale_conf`. Returns
    the run whose steady sim steps per second is the median, with
    ``reached`` true only where every run reached the goal;
    ``record["runs"]`` gets every run."""
    device = run_device(device)
    conf = bench_largescale_conf(traverse_m)
    # set-up, done before the first build's clock starts: the host
    # runtime's g++ build (the rock and block stores' codec) and, on the
    # card, the crater block kernel's nvcc build
    native.available()
    if device.type == "cuda":
        crater_block_cuda.load()
    runs = [_largescale_run(conf, device) for _ in range(REPEATS)]
    order = sorted(range(len(runs)), key=lambda i: runs[i]["sim_steps_per_s"])
    out = dict(runs[order[len(runs) // 2]])
    out["reached"] = all(r["reached"] for r in runs)
    if record is not None:
        record["runs"] = runs
    return out


def card_name() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def _stats(values: list, capture_ms: float | None = None) -> dict:
    """min / median / spread ((max - min) / median) of one key's repeats."""
    v = [x for x in values if x is not None]  # a traverse without a shift has no latency
    if not v:
        return {"n": 0}
    med = float(np.median(v))
    out = {"min": min(v), "median": med, "spread": (max(v) - min(v)) / med if med else 0.0,
           "n": len(v)}
    if capture_ms is not None:
        out["capture_ms"] = capture_ms
    return out


def measure(device=None) -> dict:
    """The benchmark's line as a dict (what :func:`main` prints)."""
    device = run_device(device)
    use_full_fp32_matmul()
    hf, cm = build_world(device)

    def cfg(K, H):
        return MPPIConfig(num_samples=K, horizon=H, exact=False)

    rec = {k: {} for k in ("k1000_h100_cuda_loop_ms", "k16384_h64_cuda_loop_ms",
                           "k16384_h64_body_critic_loop_ms", "vec_env_4096_step_us",
                           "goal_seek_loop_ms", "closed_loop_step_ms", "largescale_streamed")}
    # the reference workload, K=1000 x H=100 (config.yaml)
    loop_cuda, sps_cuda = bench_control_loop(hf, cm, cfg(1000, 100),
                                             record=rec["k1000_h100_cuda_loop_ms"])
    # the large batched config (BASELINE config 1): 16k x 64
    loop_big, sps_big = bench_control_loop(hf, cm, cfg(16384, 64),
                                           record=rec["k16384_h64_cuda_loop_ms"])
    # the same batch under the thesis-statistics (body-slope) critic: K1
    # writes 6 channels instead of 12 and the wheel critics are skipped
    loop_big_body, sps_big_body = bench_control_loop(
        hf, cm, dataclasses.replace(cfg(16384, 64), slope_critic="body"),
        record=rec["k16384_h64_body_critic_loop_ms"])
    env_dt, env_steps_per_s = bench_vec_env(hf, record=rec["vec_env_4096_step_us"])
    gs_cfg = cfg(1000, 100)
    gs_loop_s, gs_loops = bench_goal_seek(hf, cm, gs_cfg, record=rec["goal_seek_loop_ms"])
    cl_dt, cl_steps_per_s = bench_closed_loop(hf, cm, gs_cfg, record=rec["closed_loop_step_ms"])
    del hf, cm
    # no `except` here, unlike bench.py: a failed traverse fails the run
    largescale = bench_largescale(device=device, record=rec["largescale_streamed"])

    best = 1000 * 100 / loop_cuda
    scale = {"vec_env_4096_step_us": 1e6}
    repeats = {key: _stats([scale.get(key, 1e3) * s for s in r["samples_s"]], r["capture_ms"])
               for key, r in rec.items() if "samples_s" in r}
    runs = rec["largescale_streamed"]["runs"]
    for key in LARGESCALE_TIMED:
        repeats[f"largescale_streamed.{key}"] = _stats([r[key] for r in runs])
    return {
        "metric": "mppi_rollout_steps_per_s",
        "value": max(best, sps_big),
        "unit": "rollout-steps/s",
        "vs_baseline": max(best, sps_big) / BASELINE_ROLLOUT_STEPS_PER_S,
        "detail": {
            "methodology": ("CUDA-graph replays, host-synced slope timing of dependent "
                            f"control loops; each timed key the median of {REPEATS} repeats "
                            "in one process (repeats: min / median / spread); capture apart"),
            "k1000_h100_cuda_loop_ms": loop_cuda * 1e3,
            "k1000_h100_steps_per_s": best,
            "k1000_h100_vs_ref_3ms": 3e-3 / loop_cuda,
            "k16384_h64_cuda_loop_ms": loop_big * 1e3,
            "k16384_h64_steps_per_s": sps_big,
            "k16384_h64_body_critic_loop_ms": loop_big_body * 1e3,
            "k16384_h64_body_critic_steps_per_s": sps_big_body,
            "vec_env_4096_step_us": env_dt * 1e6,
            "vec_env_rover_steps_per_s": env_steps_per_s,
            "goal_seek_loop_ms": gs_loop_s * 1e3,
            "goal_seek_loops": gs_loops,
            "closed_loop_step_ms": cl_dt * 1e3,
            "closed_loop_steps_per_s": cl_steps_per_s,
            "device": card_name(),
            "largescale_streamed": largescale,
            "repeats": repeats,
        },
    }


def main() -> int:
    print(json.dumps(measure()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
