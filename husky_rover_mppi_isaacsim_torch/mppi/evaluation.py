"""Offline controller evaluation and the thesis's 2D-vs-3D experiments.

Counterpart of ``husky_rover_mppi_isaacsim_tpu/mppi/evaluation.py``
(evaluate_trajectory.py:11-150, stats_results.py, compare_3d_2d.py):
logged runs are re-scored through the critics, collisions counted against
the costmap, and run populations compared with trimmed means. The two
experiment functions run paired goal-seek episodes per K with the 3D
(surface-riding, kernel K1 on the card) and the 2D (planar, the planar
rollout kernel ``csrc/rollout_2d.cu`` on the card) projection:

* :func:`run_2d_vs_3d_experiment` (``protocol=episode``): the crater DEM and
  the 750² costmap, episode-total rescoring, trimmed means;
* :func:`run_thesis_protocol_experiment` (``protocol=thesis``): the thesis
  statistics terrain and a 1500² (0.1 m/px) costmap, per-path rescoring
  with collision-abort and drop-5-greatest.

Each episode runs on the world's device with one host sync per ``unroll``
steps; on the card each arm (K, projection) replays one CUDA graph of
``unroll`` masked steps across its runs (the JAX runner's jitted
``goal_seek_recorded``, evaluation.py:301, 455), one planar rollout
launch a step inside the 2D arm's. Its recorded trace comes to the host in
one copy, and rescoring runs on CPU tensors and numpy. Control noise comes
from a ``torch.Generator`` seeded ``seed * 1000 + run`` (a different stream
from the JAX package's ``jax.random.key``), or from an injected per-run
noise source (tests).
"""

from __future__ import annotations

import ast
import csv
import dataclasses
import sys
import time
from typing import Callable

import numpy as np
import torch

from ..core.device import run_device
from ..core.graphs import Graphed
from ..core.heightfield import HeightField, grid_lookup
from . import critics as crit
from .controller import (
    ControllerState,
    MPPIConfig,
    NoiseSource,
    RobotState,
    goal_seek_recorded,
    masked_steps,
)
from .critics import Costmap

# (K, run index) -> the run's noise source; both arms of a run share it
RunNoise = Callable[[int, int], NoiseSource]


@dataclasses.dataclass
class TrajectoryLog:
    """One logged run (the reference's CSV schema: step id, XYZ, velocity,
    start, goal — trajectories_data.csv writers in MPPI_OO_current.py)."""

    step: int
    trajectory: np.ndarray          # (T, 3)
    linear_velocities: np.ndarray   # (T,)
    start: tuple
    goal: tuple


def save_trajectory_csv(path, logs) -> None:
    """CSV writer of the reference schema, one row per waypoint."""
    with open(path, "w", newline="") as fh:
        w = csv.writer(fh)
        for log in logs:
            for i, p in enumerate(log.trajectory):
                w.writerow([log.step, p[0], p[1], p[2], log.linear_velocities[i],
                            list(log.start), list(log.goal)])


def load_trajectory_csv(path) -> list[TrajectoryLog]:
    """Read :func:`save_trajectory_csv`'s schema back, runs sorted by step."""
    runs: dict[int, dict] = {}
    with open(path) as fh:
        for row in csv.reader(fh):
            if not row:
                continue
            step = int(float(row[0]))
            entry = runs.setdefault(step, {"pts": [], "v": [], "start": None, "goal": None})
            entry["pts"].append([float(row[1]), float(row[2]), float(row[3])])
            entry["v"].append(float(row[4]))
            entry["start"] = tuple(ast.literal_eval(row[5]))
            entry["goal"] = tuple(ast.literal_eval(row[6]))
    return [TrajectoryLog(step, np.array(e["pts"]), np.array(e["v"]), e["start"], e["goal"])
            for step, e in sorted(runs.items())]


def rescore_trajectory(log: TrajectoryLog, costmap: Costmap, target_speed: float = 2.0,
                       horizon_m: float = 9.0,
                       weights: crit.CriticWeights = crit.CriticWeights()) -> dict:
    """Critic re-scoring of one logged run (compute_cost,
    evaluate_trajectory.py:11-40), in the log's dtype on the costmap's
    device: each critic on the whole trajectory with the start position as
    the pose. The wheel-slope critic degrades to the body-slope critic
    (wheel tracks are not logged)."""
    traj = torch.as_tensor(np.asarray(log.trajectory), device=costmap.cost.device)
    s = lambda v: torch.tensor(float(v), dtype=traj.dtype, device=traj.device)  # noqa: E731
    x, y = s(log.start[0]), s(log.start[1])
    goal = torch.tensor([float(g) for g in log.goal], dtype=traj.dtype, device=traj.device)
    lin = torch.as_tensor(np.asarray(log.linear_velocities), device=traj.device)
    pf = float(crit.path_follow_critic(x, y, goal, traj, s(horizon_m)))
    slope = float(crit.avoid_slope_critic(traj))
    speed = float(crit.maximise_speed_critic(x, y, goal, lin, s(target_speed)))
    obstacle = float(crit.avoid_obstacle_critic(traj, costmap))
    return {
        "distance": pf, "slope": slope, "speed": speed, "obstacle": obstacle,
        "total": (weights.path_follow * pf + weights.slope_wheels * slope
                  + weights.speed * speed + weights.obstacle * obstacle),
    }


def count_collisions(log: TrajectoryLog, costmap: Costmap, threshold: float = 0.99) -> int:
    """Waypoints in cells above ``threshold`` (evaluate_trajectory.py:
    104-110), through the online critic's cell mapping and gather
    semantics (a negative index wraps once, then clamps), as the JAX
    package does (``ADVICE.md``: :func:`thesis_rescore` clips instead)."""
    traj = torch.as_tensor(np.asarray(log.trajectory), device=costmap.cost.device)
    ix, iy = crit.costmap_cells(traj, costmap)
    return int(torch.sum(grid_lookup(costmap.cost, ix, iy) > threshold))


def trimmed_mean(values, trim_fraction: float = 0.1) -> float:
    """Symmetric trimmed mean (the stats_results.py aggregation)."""
    v = np.sort(np.asarray(values, float))
    k = int(len(v) * trim_fraction)
    core = v[k: len(v) - k] if len(v) > 2 * k else v
    return float(core.mean())


def compare_populations(scores_a, scores_b, trim_fraction: float = 0.1) -> dict:
    """Per-critic trimmed-mean comparison of two run populations (the
    compare_3d_2d.py 2D-vs-3D tables)."""
    out = {}
    for key in scores_a[0].keys():
        a = trimmed_mean([s[key] for s in scores_a], trim_fraction)
        b = trimmed_mean([s[key] for s in scores_b], trim_fraction)
        out[key] = {"a": a, "b": b, "improvement_pct": 100.0 * (a - b) / a if a else 0.0}
    return out


def path_length(trajectory: np.ndarray, stride: int = 5) -> float:
    """Driven path length over every ``stride``-th waypoint, the thesis's
    "distance critic" for the stats tables (compute_length,
    evaluate_trajectory.py:42-53)."""
    pts = np.asarray(trajectory, float)[::stride]
    if len(pts) < 2:
        return 0.0
    return float(np.linalg.norm(np.diff(pts, axis=0), axis=1).sum())


def thesis_rescore(log: TrajectoryLog, costmap: Costmap, target_speed: float = 2.0) -> dict:
    """Per-critic raw scores of one driven path under the thesis's stats
    protocol (evaluate_trajectory.py:93-110, the "for stats" obstacle
    variant, critics_warp.py:256-265): path length, the speed critic over
    the logged velocities, the body-slope critic, bucketed near-miss costs
    (+1 / +100 / +1e4 / +1e6 for cells in (0.65, 0.75) / (0.75, 0.85) /
    (0.85, 0.95) / > 0.95) and ``collided`` (any cell > 0.99). Cells clip
    to the map. The first waypoint (the start) is dropped, like the
    reference's ``trajectories[1:]``. ``costmap`` lies on the CPU."""
    traj = np.asarray(log.trajectory, float)[1:]
    vels = np.asarray(log.linear_velocities, float)[1:]
    if len(traj) < 4:
        return {"distance": 0.0, "speed": 0.0, "slope": 0.0, "obstacle": 0.0,
                "collided": False}
    speed = float(np.sum((target_speed - vels) / (vels + 1e-4)))
    slope = float(torch.sum(crit.avoid_slope_critic(torch.from_numpy(traj))))

    half_w = float(costmap.half_width)
    res = float(costmap.resolution)
    size = costmap.cost.shape[-1]
    ix = np.trunc((traj[:, 0] + half_w) / res).astype(int)
    iy = np.trunc((-traj[:, 1] + half_w) / res).astype(int)
    cells = costmap.cost.numpy()[np.clip(iy, 0, size - 1), np.clip(ix, 0, size - 1)]
    obstacle = float(
        np.sum((cells > 0.65) & (cells < 0.75)) * 1.0
        + np.sum((cells > 0.75) & (cells < 0.85)) * 100.0
        + np.sum((cells > 0.85) & (cells < 0.95)) * 1e4
        + np.sum(cells > 0.95) * 1e6
    )
    return {"distance": path_length(traj), "speed": speed, "slope": slope,
            "obstacle": obstacle, "collided": bool((cells > 0.99).any())}


def trim_greatest(values, n: int = 5) -> list:
    """Drop the ``n`` greatest values (heapq.nlargest removal,
    evaluate_trajectory.py:178-196; exactly ``n``, not every duplicate)."""
    v = sorted(float(x) for x in values)
    return v[: max(len(v) - n, 1)] if len(v) > n else v


# -- the experiments -----------------------------------------------------------

def _costmap_on_cpu(cm: Costmap) -> Costmap:
    return Costmap(*(t.cpu() for t in cm))


def _run_episode(config: MPPIConfig, hf: HeightField, cm: Costmap, goal, robot: RobotState,
                 ctrl: ControllerState, seed: int, run_idx: int, max_loops: int,
                 noise: RunNoise | None, steps_fn: Graphed | None = None):
    """One recorded goal-seek episode on the world's device, its masked
    steps run by ``steps_fn`` (the arm's graph; a new one when ``None``).
    Returns ``(loops, reached,
    positions (max_loops, 3), velocities (max_loops,), steps)`` on the
    host, after one device-to-host copy."""
    dtype, dev = robot.position.dtype, robot.position.device
    gen, source = None, None
    if noise is None:
        gen = torch.Generator(device=dev).manual_seed(seed * 1000 + run_idx)
    else:
        source = noise(config.num_samples, run_idx)
    trace = goal_seek_recorded(config, hf, cm, torch.tensor(goal, dtype=dtype, device=dev),
                               robot, ctrl, gen, max_loops=max_loops, noise_source=source,
                               steps_fn=steps_fn)
    packed = torch.cat([trace.positions.reshape(-1), trace.velocities,
                        trace.loops.to(dtype).view(1), trace.reached.to(dtype).view(1)])
    host = packed.cpu().numpy()  # the run's one device-to-host copy
    n = max_loops
    return (int(host[4 * n]), bool(host[4 * n + 1]), host[:3 * n].reshape(n, 3),
            host[3 * n:4 * n], trace.steps)


def _finite(log: TrajectoryLog) -> bool:
    return bool(np.isfinite(log.trajectory).all() and np.isfinite(log.linear_velocities).all())


def run_2d_vs_3d_experiment(
    ks=(350, 500, 1000), runs_per_arm: int = 8, horizon: int = 100, max_loops: int = 1500,
    half_width: float = 75.0, grid_size: int = 1500, costmap_size: int = 750,
    seed: int = 42, trim_fraction: float = 0.1, span_fraction: float = 0.8,
    dtype=torch.float32, device=None, noise: RunNoise | None = None,
) -> dict:
    """The thesis's 2D-vs-3D projection experiment (compare_3d_2d.py /
    stats_results.py:8-80): for each K, ``runs_per_arm`` goal-seek episodes
    on the 150 m crater map + 750-obstacle costmap with the 3D and the 2D
    projection, each run re-scored through the critic stack, collisions
    counted, and the per-K trimmed-mean table. Start/goal pairs come from
    ``np.random.default_rng(seed)`` (the JAX package's stream); both arms
    share pairs and noise, so the comparison is paired. Beside the JAX
    table's entries, each K reports per arm ``wall_s``, ``steps`` (control
    steps, masked ones included) and ``finite`` (every recorded waypoint and
    velocity finite)."""
    from ..terrain import STANDALONE_CRATER_BUMPS, costmap_750, crater_surface

    device = run_device(device)
    z = crater_surface(grid_size, half_width, STANDALONE_CRATER_BUMPS, dtype=dtype,
                       device=device)
    hf = HeightField.create(z, half_width)
    cm = costmap_750(half_width=half_width, size=costmap_size, use_exact_edt=True, dtype=dtype,
                     device=device)
    cm_host = _costmap_on_cpu(cm)

    rng = np.random.default_rng(seed)
    lim = span_fraction * half_width
    pairs = []
    for _ in range(runs_per_arm):
        start = np.array([-lim, 0.0]) + rng.uniform(-0.15, 0.15, 2) * half_width
        goal = np.array([lim, 0.0]) + rng.uniform(-0.15, 0.15, 2) * half_width
        pairs.append((start, goal))

    table: dict = {"config": {"ks": list(ks), "runs_per_arm": runs_per_arm,
                              "horizon": horizon, "max_loops": max_loops},
                   "per_k": {}}
    for k in ks:
        scores = {"3d": [], "2d": []}
        collisions = {"3d": 0, "2d": 0}
        reached = {"3d": 0, "2d": 0}
        wall = {"3d": 0.0, "2d": 0.0}
        steps = {"3d": 0, "2d": 0}
        finite = {"3d": True, "2d": True}
        for proj in ("3d", "2d"):
            config = MPPIConfig(num_samples=int(k), horizon=horizon, projection=proj)
            graph = Graphed(masked_steps)  # one per arm, replayed across its runs
            t_arm = time.perf_counter()
            for run_idx, (start, goal) in enumerate(pairs):
                robot = RobotState.create(start[0], start[1], [1.0, 0.0, 0.0], dtype=dtype,
                                          device=device)
                ctrl = ControllerState.create(config, dtype, device)
                loops, hit, pos, vel, n_steps = _run_episode(
                    config, hf, cm, goal, robot, ctrl, seed, run_idx, max_loops, noise, graph)
                log = TrajectoryLog(step=run_idx, trajectory=pos[:max(loops, 2)],
                                    linear_velocities=vel[:max(loops, 2)],
                                    start=tuple(start), goal=tuple(goal))
                # re-score against the horizon the controller optimized
                scores[proj].append(rescore_trajectory(log, cm_host,
                                                       horizon_m=float(config.horizon_m)))
                collisions[proj] += count_collisions(log, cm_host)
                reached[proj] += int(hit)
                steps[proj] += n_steps
                finite[proj] &= _finite(log)
            wall[proj] = time.perf_counter() - t_arm
            print(f"[eval] K={k} {proj}: {len(pairs)} runs in {wall[proj]:.0f}s, "
                  f"reached={reached[proj]}", file=sys.stderr, flush=True)
        table["per_k"][int(k)] = {
            # a = 2D, b = 3D; improvement_pct > 0 means 3D is better
            "trimmed_means": compare_populations(scores["2d"], scores["3d"], trim_fraction),
            "collisions": collisions,
            "reached": reached,
            "wall_s": wall,
            "steps": steps,
            "finite": finite,
        }
    return table


def thesis_pairs(runs_per_arm: int, half_width: float, seed: int) -> list:
    """Paired start/goal/heading draws of the thesis protocol: x in
    U(-70, -55) -> U(55, 70) with the cross coordinate in U(-50, 50), the
    axis alternating per run, random heading (MPPI_OO_current.py:756-768)."""
    rng = np.random.default_rng(seed)
    pairs = []
    for i in range(runs_per_arm):
        lo, hi = 55.0, min(70.0, half_width - 2.0)
        a = rng.uniform(lo, hi)
        b = rng.uniform(lo, hi)
        off_s = rng.uniform(-50.0, 50.0)
        off_g = rng.uniform(-50.0, 50.0)
        hr = rng.uniform(0.0, 1.0), rng.uniform(-1.0, 1.0)
        if i % 2 == 0:  # x-axis traverse (:756-761)
            start, goal, heading = (-a, off_s), (b, off_g), [hr[0], hr[1], 0.0]
        else:           # y-axis traverse (:763-768)
            start, goal, heading = (off_s, -a), (off_g, b), [hr[1], hr[0], 0.0]
        pairs.append((np.asarray(start), np.asarray(goal), heading))
    return pairs


def run_thesis_protocol_experiment(
    ks=(350, 500, 1000), runs_per_arm: int = 64, horizon: int = 100, max_loops: int = 3500,
    half_width: float = 75.0, seed: int = 42, slope_weight: float = 35.5,
    sigma_base: float = 0.3, terrain_seed: int = 42, slope_critic: str = "body",
    terrain_z_scale: float = 1.0, dtype=torch.float32, device=None,
    noise: RunNoise | None = None, base_noise=None,
) -> dict:
    """The thesis's 2D-vs-3D statistics experiment under the thesis's own
    protocol: the thesis statistics terrain (``2 * half_width`` square at
    0.1 m/px, craters 1/5 m^2) with the 750-obstacle costmap at 0.1 m/px,
    paired starts/goals/headings (:func:`thesis_pairs`), optimal inputs and
    wheel speeds starting at 1, sigma base ``sigma_base``, slope weight
    ``slope_weight``, per-path rescoring (:func:`thesis_rescore`) with
    collided and unreached runs excluded and counted, and drop-5-greatest
    means. ``base_noise`` is handed to the terrain
    (:func:`..terrain.smallscale.thesis_statistics_terrain`). Beside the JAX
    table's entries, each arm reports ``wall_s``, ``steps`` and ``finite``
    as in :func:`run_2d_vs_3d_experiment`, and ``episode_s``, the part of
    ``wall_s`` spent in the episodes (the rest is the host's rescoring)."""
    from ..terrain import costmap_750, thesis_statistics_terrain

    device = run_device(device)
    z = thesis_statistics_terrain(seed=terrain_seed, size_m=2 * half_width,
                                  z_scale=terrain_z_scale,
                                  max_elevation=1.2 * terrain_z_scale,
                                  min_elevation=-1.2 * terrain_z_scale,
                                  base_noise=base_noise, dtype=dtype, device=device)
    hf = HeightField.create(z, half_width)
    # 0.1 m/px costmap, the reference protocol's grid (MPPI_OO_current.py:743)
    cm = costmap_750(half_width=half_width, size=int(round(2 * half_width / 0.1)),
                     use_exact_edt=True, dtype=dtype, device=device)
    cm_host = _costmap_on_cpu(cm)
    pairs = thesis_pairs(runs_per_arm, half_width, seed)
    weights = crit.CriticWeights(slope_wheels=slope_weight)

    table: dict = {
        "config": {
            "ks": list(ks), "runs_per_arm": runs_per_arm, "horizon": horizon,
            "max_loops": max_loops, "slope_weight": slope_weight, "sigma_base": sigma_base,
            "slope_critic": slope_critic, "terrain_z_scale": terrain_z_scale,
            "terrain": "thesis_statistics_terrain(150m@0.1m, craters 1/5m^2)",
            "protocol": "per-path rescore, collision-abort, drop-5-greatest",
        },
        "per_k": {},
    }
    for k in ks:
        per_arm: dict = {}
        for proj in ("3d", "2d"):
            config = MPPIConfig(num_samples=int(k), horizon=horizon, projection=proj,
                                critic_weights=weights, sigma_base=sigma_base,
                                slope_critic=slope_critic)
            graph = Graphed(masked_steps)  # one per arm, replayed across its runs
            scores, n_fail, n_collide, n_steps, finite = [], 0, 0, 0, True
            loops_list, v_means, v_stalls, episode_s = [], [], [], 0.0
            t_arm = time.perf_counter()
            for run_idx, (start, goal, heading) in enumerate(pairs):
                t_run = time.perf_counter()
                robot = RobotState.create(start[0], start[1], heading, dtype=dtype,
                                          device=device, wheel_speed=1.0)
                ctrl = ControllerState.create(config, dtype, device, initial_u=1.0)
                loops, reached, pos, vel, steps = _run_episode(
                    config, hf, cm, goal, robot, ctrl, seed, run_idx, max_loops, noise, graph)
                episode_s += time.perf_counter() - t_run
                n_steps += steps
                # the reference CSVs log the start pose as row 0 and the
                # rescorer drops it (trajectories[1:]); the trace holds only
                # driven waypoints, so the start row is prepended
                pts, vels = pos[:max(loops, 2)], vel[:max(loops, 2)]
                log = TrajectoryLog(
                    step=run_idx, trajectory=np.vstack([[start[0], start[1], pts[0, 2]], pts]),
                    linear_velocities=np.concatenate([vels[:1], vels]),
                    start=tuple(start), goal=tuple(goal))
                finite &= _finite(log)
                loops_list.append(loops)
                v = log.linear_velocities
                v_means.append(float(v.mean()))
                v_stalls.append(float((v < 0.1).mean()))
                if not reached:
                    n_fail += 1          # evaluate_trajectory.py:80-87
                    continue
                score = thesis_rescore(log, cm_host)
                if score.pop("collided"):
                    n_collide += 1       # :104-110 (1e8 -> excluded)
                    continue
                scores.append(score)
            wall = time.perf_counter() - t_arm
            per_arm[proj] = {
                "scores": scores, "failed": n_fail, "collided": n_collide,
                "completed": len(scores), "mean_loops": float(np.mean(loops_list)),
                "mean_velocity": float(np.mean(v_means)),
                "stall_fraction": float(np.mean(v_stalls)),
                "wall_s": wall, "episode_s": episode_s, "steps": n_steps, "finite": finite,
            }
            print(f"[thesis-eval] K={k} {proj}: {len(pairs)} runs in {wall:.0f}s, "
                  f"completed={len(scores)}, collided={n_collide}, failed={n_fail}",
                  file=sys.stderr, flush=True)
        critics = {}
        for critic in ("distance", "speed", "slope", "obstacle"):
            row = {}
            for p in ("2d", "3d"):
                vals = [sc[critic] for sc in per_arm[p]["scores"]]
                row[p] = float(np.mean(trim_greatest(vals))) if vals else None
            if row["2d"] is not None and row["3d"]:
                # stats_results.py convention: positive = 3D better
                row["beaten_by_pct"] = 100.0 * (row["2d"] - row["3d"]) / row["3d"]
            critics[critic] = row
        table["per_k"][int(k)] = {
            "arms": {p: {kk: vv for kk, vv in a.items() if kk != "scores"}
                     for p, a in per_arm.items()},
            "critics": critics,
        }
    return table
