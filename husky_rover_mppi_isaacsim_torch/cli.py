"""Command-line entry of the PyTorch port: the standalone goal-seek, the
2D-vs-3D evaluation, the N-rover closed loop and the streamed-terrain
full-stack loop.

Usage (dotted ``key=value`` overrides, the keys and defaults of the JAX
package's ``run_standalone`` and ``run_evaluation``)::

    python -m husky_rover_mppi_isaacsim_torch.cli mode=standalone \\
        start.x=-45 start.y=-40 goal.x=45 goal.y=40 mppi.num_samples=1000
    python -m husky_rover_mppi_isaacsim_torch.cli mode=evaluation \\
        evaluation.protocol=thesis evaluation.ks=[1000] evaluation.runs_per_arm=8
    python -m husky_rover_mppi_isaacsim_torch.cli mode=closed_loop num_rovers=4 steps=300
    python -m husky_rover_mppi_isaacsim_torch.cli mode=largescale goal.x=65 goal.y=65

``device=`` names the torch device, ``cuda`` by default: a run that asks for
the card where there is none raises; the CPU runs only with ``device=cpu``.
Each mode prints one JSON line that names the device. The YAML tree under
``cfg/`` is not read; the evaluation keys and defaults are those of
``cfg/mode/evaluation.yaml``, the closed loop's those of
``cfg/mode/closed_loop.yaml`` with ``cfg/config.yaml``'s ``mppi`` section
and ``cfg/physics/default_physics.yaml``; the streamed loop's keys are those
of the JAX ``run_largescale`` (``environment.largescale.*`` or
``largescale.*`` by ``LargeScaleConf`` field, ``mppi.*``, ``start``, ``goal``,
``max_steps``, ``terrain_check_every``, ``seed``, ``deformation.enable``,
``checkpoint.path``, ``checkpoint.every_steps``, ``resume``) and builds the
JAX run's configuration: the pipelined loop with shift pre-staging, the
synchronous loop under deformation.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from .core.heightfield import HeightField
from .env import (
    ClosedLoopConfig,
    LoopState,
    RoverParams,
    RoverState,
    goal_distances,
    init_loop_state,
    run_episode,
)
from .mppi import evaluation
from .mppi.controller import (
    NESTED_CONFIG,
    ControllerState,
    MPPIConfig,
    RobotState,
    goal_seek,
)
from .env.largescale_loop import LargeScaleClosedLoop, LargeScaleLoopConf
from .physics.deformation import DeformationEngineConf
from .terrain.costmap import costmap_750
from .terrain.orchestrator import LargeScaleConf
from .terrain.surface import STANDALONE_CRATER_BUMPS, crater_surface


def use_full_fp32_matmul() -> None:
    """Full float32 matmuls on the card: TF32 off, precision "highest"."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def build_standalone_world(world: dict, dtype=torch.float32, device=None):
    """The standalone world: crater DEM (``grid_size``² over
    ±``half_width``) and the 750-obstacle costmap (``costmap_size``²).
    Returns ``(heightfield, costmap, half_width)``."""
    hw = float(world.get("half_width", 75.0))
    grid = int(world.get("grid_size", 1500))
    z = crater_surface(grid, hw, STANDALONE_CRATER_BUMPS, dtype=dtype, device=device)
    hf = HeightField.create(z, hw)
    cm = costmap_750(half_width=hw, size=int(world.get("costmap_size", 750)),
                     dtype=dtype, device=device)
    return hf, cm, hw


def mppi_config(d) -> MPPIConfig:
    """MPPIConfig from a dict of its fields (nested limits as dicts)."""
    d = dict(d or {})
    for k, cls in NESTED_CONFIG.items():
        if isinstance(d.get(k), dict):
            d[k] = cls(**d[k])
    return MPPIConfig(**d)


def run_device(tree: dict) -> torch.device:
    """The ``device`` key (default ``cuda``). Raises when it names a CUDA
    device and there is none: nothing falls back to the CPU."""
    device = torch.device(str(tree.get("device", "cuda")))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device} asked for, but no CUDA device is present; "
                           "pass device=cpu to run on the CPU")
    return device


def world_tree(tree: dict) -> dict:
    """The world section: ``environment.world`` with ``world.*`` on top."""
    world = dict((tree.get("environment") or {}).get("world") or {})
    world.update(tree.get("world") or {})
    return world


def run_standalone(tree: dict) -> dict:
    """Goal-seek on the standalone world; the JAX ``run_standalone``'s keys
    (``mppi``, ``world``, ``start``, ``goal``, ``seed``, ``max_loops``) and
    ``device``. The result names the device beside ``wall_s``."""
    use_full_fp32_matmul()
    dtype = torch.float32
    device = run_device(tree)
    cfg = mppi_config(tree.get("mppi"))
    hf, cm, _ = build_standalone_world(world_tree(tree), dtype, device)
    start = tree.get("start", {"x": -60.0, "y": -60.0})
    goal_d = tree.get("goal", {"x": 65.0, "y": 60.0})
    goal = torch.tensor([goal_d["x"], goal_d["y"]], dtype=dtype, device=device)
    robot = RobotState.create(start["x"], start["y"], [1.0, 0.5, 0.0],
                              dtype=dtype, device=device)
    ctrl = ControllerState.create(cfg, dtype, device)
    gen = torch.Generator(device=device).manual_seed(int(tree.get("seed", 42)))

    t0 = time.perf_counter()
    res = goal_seek(cfg, hf, cm, goal, robot, ctrl, gen,
                    max_loops=int(tree.get("max_loops", 3500)))
    final = res.robot.position.tolist()  # waits for the device
    wall = time.perf_counter() - t0
    return {
        "mode": "standalone",
        "reached": bool(res.reached),
        "loops": int(res.loops),
        "final_position": final,
        "wall_s": round(wall, 2),
        "device": str(device),
    }


def run_evaluation(tree: dict) -> dict:
    """The thesis's 2D-vs-3D projection experiment; the JAX
    ``run_evaluation``'s keys without ``gather_engine`` (the rollout engine
    follows the device), plus ``device``. ``evaluation.protocol=thesis``
    runs the thesis statistics protocol and refuses ``runs_per_arm <= 5``
    (its drop-5-greatest trim); ``episode`` (the default) the episode-total
    comparison on the crater map."""
    use_full_fp32_matmul()
    ev = tree.get("evaluation") or {}
    world = world_tree(tree)
    ks = tuple(int(k) for k in ev.get("ks", (350, 500, 1000)))
    thesis = str(ev.get("protocol", "episode")) == "thesis"
    runs_per_arm = int(ev.get("runs_per_arm", 64 if thesis else 8))
    if thesis and runs_per_arm <= 5:
        raise SystemExit("evaluation.runs_per_arm must exceed the thesis protocol's "
                         f"drop-5-greatest trim (got {runs_per_arm})")
    device = run_device(tree)
    if thesis:
        table = evaluation.run_thesis_protocol_experiment(
            ks=ks, runs_per_arm=runs_per_arm,
            horizon=int(ev.get("horizon", 100)),
            max_loops=int(ev.get("max_loops", 3500)),
            half_width=float(world.get("half_width", 75.0)),
            seed=int(tree.get("seed", 42)),
            slope_weight=float(ev.get("slope_weight", 35.5)),
            sigma_base=float(ev.get("sigma_base", 0.3)),
            terrain_seed=int(ev.get("terrain_seed", 42)),
            slope_critic=str(ev.get("slope_critic", "body")),
            terrain_z_scale=float(ev.get("terrain_z_scale", 1.0)),
            device=device,
        )
    else:
        table = evaluation.run_2d_vs_3d_experiment(
            ks=ks, runs_per_arm=runs_per_arm,
            horizon=int(ev.get("horizon", 100)),
            max_loops=int(ev.get("max_loops", 1500)),
            half_width=float(world.get("half_width", 75.0)),
            grid_size=int(world.get("grid_size", 1500)),
            costmap_size=int(world.get("costmap_size", 750)),
            seed=int(tree.get("seed", 42)),
            span_fraction=float(ev.get("span_fraction", 0.8)),
            device=device,
        )
    return {"mode": "evaluation", **table, "device": str(device)}


def rover_params(tree: dict) -> RoverParams:
    """RoverParams from the physics section as the JAX ``_rover_params``
    reads it: ``physics.rover.*`` by field name, ``physics.dt`` as the
    physics step, ``|physics.gravity[2]|`` as gravity. Unset keys take
    ``cfg/physics/default_physics.yaml``'s values, which are the defaults."""
    phys = tree.get("physics") or {}
    kw = {k: float(v) for k, v in (phys.get("rover") or {}).items()
          if k in RoverParams._fields}
    if "dt" in phys and "physics_dt" not in kw:
        kw["physics_dt"] = float(phys["dt"])
    grav = phys.get("gravity")
    if isinstance(grav, (list, tuple)) and len(grav) == 3 and "gravity" not in kw:
        kw["gravity"] = abs(float(grav[2]))
    return RoverParams(**kw)


def closed_loop_config(tree: dict) -> ClosedLoopConfig:
    """ClosedLoopConfig from ``mppi.*`` and the physics section, as the JAX
    ``run_closed_loop`` builds it: the loop's own constants keep their
    defaults."""
    return ClosedLoopConfig(mppi=mppi_config(tree.get("mppi")), rover=rover_params(tree))


def spawn_points(seed: int, n: int, half_width: float) -> tuple[np.ndarray, np.ndarray]:
    """Starts and goals ``(n, 2)`` of the closed loop, the JAX CLI's numpy
    draw (``cli.py:179-183``): both uniform in ``+-min(40, 0.55 hw)``."""
    rng = np.random.default_rng(seed)
    lim = min(40.0, 0.55 * half_width)  # spawns and goals well inside the window
    starts = rng.uniform(-lim, lim, (n, 2))
    return starts, rng.uniform(-lim, lim, (n, 2))


class ClosedLoopRun(NamedTuple):
    """One closed-loop episode: final state, recorded positions
    ``(steps, N, 2)``, per-rover progress toward the goal [m] (numpy), wall
    seconds (host clock, ended by the copy of the final distances)."""

    state: LoopState
    path: torch.Tensor
    progress: np.ndarray
    wall_s: float
    device: torch.device


def closed_loop_episode(tree: dict) -> ClosedLoopRun:
    """N rovers under the latched/PI closed loop on the standalone world; the
    JAX ``run_closed_loop``'s keys (``num_rovers``, ``steps``, ``mppi``,
    ``physics``, ``world``, ``seed``) and ``device``. The exploration noise
    comes from a ``torch.Generator`` seeded 0 (the JAX run's ``key(0)``)."""
    use_full_fp32_matmul()
    dtype = torch.float32
    device = run_device(tree)
    n = int(tree.get("num_rovers", 4))
    steps = int(tree.get("steps", 300))
    cfg = closed_loop_config(tree)
    hf, cm, hw = build_standalone_world(world_tree(tree), dtype, device)
    starts, goals_np = spawn_points(int(tree.get("seed", 42)), n, hw)
    goals = torch.tensor(goals_np, dtype=dtype, device=device)
    state = init_loop_state(cfg, RoverState.create(starts, [1.0, 0.0, 0.0], hf))
    gen = torch.Generator(device=device).manual_seed(0)

    t0 = time.perf_counter()
    state, path = run_episode(cfg, hf, cm, goals, state, gen, num_steps=steps)
    d1 = goal_distances(state.rovers.position, goals).cpu().numpy()  # waits for the device
    wall = time.perf_counter() - t0
    d0 = np.linalg.norm(starts - goals.cpu().numpy(), axis=-1)
    return ClosedLoopRun(state, path, d0 - d1, wall, device)


def run_closed_loop(tree: dict) -> dict:
    """:func:`closed_loop_episode`, reported under the JAX run's keys and
    ``device``."""
    run = closed_loop_episode(tree)
    steps = int(tree.get("steps", 300))
    return {
        "mode": "closed_loop",
        "num_rovers": len(run.progress),
        "steps": steps,
        "mean_progress_m": float(run.progress.mean()),
        "wall_s": round(run.wall_s, 2),
        "sim_steps_per_s": round(steps / run.wall_s, 1),
        "device": str(run.device),
    }


def largescale_conf(tree: dict) -> LargeScaleLoopConf:
    """The streamed loop's configuration from the JAX ``run_largescale``'s
    keys, with its defaults (``pipeline_depth=4``, ``prestage_shifts``):
    ``deformation.enable`` sets a deformation engine at the window's
    resolution, ``checkpoint.path`` and ``checkpoint.every_steps`` the
    periodic checkpoint."""
    env = tree.get("environment") or {}
    ls = dict(env.get("largescale") or tree.get("largescale") or {})
    fields = {f.name for f in dataclasses.fields(LargeScaleConf)}
    kw = {k: v for k, v in ls.items() if k in fields}
    if "crater_gen_densities" in kw:
        kw["crater_gen_densities"] = tuple(kw["crater_gen_densities"])
    if "crater_gen_radius" in kw:
        kw["crater_gen_radius"] = tuple(tuple(r) for r in kw["crater_gen_radius"])
    if "rock_gen_cfgs" in kw:
        kw["rock_gen_cfgs"] = tuple(kw["rock_gen_cfgs"])
    terrain = LargeScaleConf(**kw)
    deform = None
    if (tree.get("deformation") or {}).get("enable"):
        deform = DeformationEngineConf(terrain_resolution=terrain.hr_dem_resolution)
    ck = tree.get("checkpoint") or {}
    start = tree.get("start", {"x": 0.0, "y": 0.0})
    goal = tree.get("goal", {"x": 65.0, "y": 65.0})
    return LargeScaleLoopConf(
        terrain=terrain, loop=closed_loop_config(tree),
        start=(start["x"], start["y"]), goal=(goal["x"], goal["y"]),
        max_steps=int(tree.get("max_steps", 20000)),
        terrain_check_every=int(tree.get("terrain_check_every", 12)),
        seed=int(tree.get("seed", 42)), deform=deform, checkpoint_path=ck.get("path"),
        checkpoint_every_steps=int(ck.get("every_steps", 0)))


class LargeScaleRun(NamedTuple):
    """One streamed traverse: the loop (terrain, costmaps, phase logs), its
    result, and the seconds the terrain build and first costmap took."""

    loop: LargeScaleClosedLoop
    result: object
    build_s: dict
    device: torch.device


def largescale_episode(tree: dict, conf: LargeScaleLoopConf | None = None) -> LargeScaleRun:
    """Build the streamed terrain and drive the traverse (the JAX
    ``run_largescale``) on ``device``; ``resume: <checkpoint>`` continues an
    interrupted traverse from its file (either package's). ``conf``
    replaces the configuration the keys build."""
    use_full_fp32_matmul()
    device = run_device(tree)
    conf = largescale_conf(tree) if conf is None else conf
    build_s = {}
    resume = tree.get("resume")
    if resume:
        t0 = time.perf_counter()
        loop, info = LargeScaleClosedLoop.resume(conf, resume, device=device)
        build_s["resume"] = round(time.perf_counter() - t0, 3)
        return LargeScaleRun(loop, loop.run(_resume=info), build_s, device)
    loop = LargeScaleClosedLoop(conf, device=device,
                                phase_cb=lambda name, s: build_s.update({name: round(s, 3)}))
    return LargeScaleRun(loop, loop.run(), build_s, device)


def largescale_report(run: LargeScaleRun) -> dict:
    """A traverse under the JAX run's result keys, plus the path taken
    (``pipeline_depth``, ``prestage_shifts``, ``deformation``), the longest
    gap between two chunk dispatches, ``build_s`` and ``device``."""
    res, lat = run.result, run.result.shift_latencies_s
    return {
        "mode": "largescale",
        "reached": bool(res.reached),
        "steps": res.steps,
        "block_shifts": res.block_shifts,
        "costmap_rebuilds": res.costmap_rebuilds,
        "distance_m": round(res.distance_m, 2),
        "final_position": [round(v, 3) for v in res.final_position],
        "wall_s": round(res.wall_s, 2),
        "sim_steps_per_s": round(res.steps / res.wall_s, 1),
        "shift_latency_ms": {
            "mean": round(1e3 * float(np.mean(lat)), 2) if lat else None,
            "max": round(1e3 * float(np.max(lat)), 2) if lat else None,
        },
        "prestage": {"hits": res.prestage_hits, "misses": res.prestage_misses},
        "pipeline_depth": run.loop.conf.pipeline_depth,
        "prestage_shifts": run.loop.conf.prestage_shifts,
        "deformation": run.loop.deform_engine is not None,
        "max_dispatch_gap_ms": round(1e3 * res.max_dispatch_gap_s, 2),
        "build_s": run.build_s,
        "device": str(run.device),
    }


def run_largescale(tree: dict) -> dict:
    """The full-stack streamed-terrain closed loop
    (visual_terrain_stack_full_terrain.py:293-582)."""
    return largescale_report(largescale_episode(tree))


MODES = {"standalone": run_standalone, "evaluation": run_evaluation,
         "closed_loop": run_closed_loop, "largescale": run_largescale}


def _parse_value(s: str):
    if s.startswith("[") and s.endswith("]"):  # a list: [350,500,1000]
        return [_parse_value(v.strip()) for v in s[1:-1].split(",") if v.strip()]
    low = s.lower()
    if low in ("true", "false"):
        return low == "true"
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    return s


def parse_overrides(argv) -> dict:
    """``a.b=c`` arguments -> nested dict ``{"a": {"b": c}}``."""
    tree: dict = {}
    for arg in argv:
        if "=" not in arg:
            raise SystemExit(f"expected key=value, got {arg!r}")
        key, value = arg.split("=", 1)
        node = tree
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = _parse_value(value)
    return tree


def main(argv=None) -> int:
    tree = parse_overrides(sys.argv[1:] if argv is None else argv)
    mode = tree.get("mode", "standalone")
    if mode not in MODES:
        print(f"mode {mode!r} is not ported; {sorted(MODES)} run", file=sys.stderr)
        return 2
    print(json.dumps(MODES[mode](tree)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
