"""Command-line entry of the PyTorch port, the counterpart of ``run.py``: the
standalone goal-seek, the 2D-vs-3D evaluation, the N-rover closed loop, the
streamed-terrain full-stack loop and synthetic-data generation.

Usage (the JAX CLI's composition: ``cfg/config.yaml`` or ``--config=``, the
``environment=`` / ``rendering=`` / ``physics=`` group files, ``mode=X``
merging ``cfg/mode/X.yaml``, then dotted ``key=value`` overrides read as
YAML)::

    python -m husky_rover_mppi_isaacsim_torch.cli mode=standalone \\
        start.x=-45 start.y=-40 goal.x=45 goal.y=40 mppi.num_samples=1000
    python -m husky_rover_mppi_isaacsim_torch.cli mode=standalone environment=lunaryard_80m
    python -m husky_rover_mppi_isaacsim_torch.cli mode=evaluation \\
        evaluation.protocol=thesis evaluation.ks=[1000] evaluation.runs_per_arm=8
    python -m husky_rover_mppi_isaacsim_torch.cli mode=closed_loop environment=lunalab
    python -m husky_rover_mppi_isaacsim_torch.cli mode=largescale
    python -m husky_rover_mppi_isaacsim_torch.cli mode=sdg sdg.num_images=10 "sdg.camera={}"

The tree is read by the port's own YAML reader (:mod:`.aux.yaml_reader`) and
instantiated into the port's config classes (:mod:`.aux.config`). The
``environment`` group's ``moonyard`` section (lunalab, lunaryard_*) makes the
standalone and closed-loop world a procedural yard with a free costmap.
``device=`` names the torch device, ``cuda`` by default: a run that asks for
the card where there is none raises; the CPU runs only with ``device=cpu``.
Each mode prints one JSON line with the JAX run's keys and ``device``.
``trace.out=PATH`` (modes standalone, evaluation and closed_loop) runs the
mode with the port's tracer on (:mod:`.core.trace`) and writes its spans
and counters to ``PATH`` at exit, as Chrome trace JSON.
"""

from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from .aux.config import apply_overrides, build_dataclass, instantiate_configs, load_config
from .aux.labeling import AutonomousLabeling, CameraIntrinsics, LabelingConf, rock_capacity
from .aux.render_fx import (
    ChromaticAberrationsConf,
    FlaresConf,
    MotionBlurConf,
    RenderSettings,
    apply_chromatic_aberrations,
    apply_lens_flare,
    apply_motion_blur,
)
from .core import jax_random as jr
from .core import trace
from .core.device import run_device
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
from .mppi.controller import ControllerState, MPPIConfig, RobotState, goal_seek
from .env.largescale_loop import LargeScaleClosedLoop, LargeScaleLoopConf
from .physics.deformation import DeformationEngineConf
from .terrain.costmap import as_costmap, costmap_750
from .terrain.craters import CraterSamplerConf
from .terrain.orchestrator import LargeScaleConf
from .terrain.point_process import BoundingBox, hardcore_poisson
from .terrain.rocks import RockDistConf
from .terrain.smallscale import BaseTerrainGeneratorConf, MoonyardConf, MoonyardGenerator
from .terrain.surface import STANDALONE_CRATER_BUMPS, crater_surface
from .utils.timer import wait_for

# the top of the configuration tree (the repository's cfg/config.yaml)
CONFIG = Path(__file__).resolve().parent.parent / "cfg" / "config.yaml"
# the config groups a ``group=name`` argument swaps for cfg/<group>/<name>.yaml
GROUPS = ("environment", "rendering", "physics")


def use_full_fp32_matmul() -> None:
    """Full float32 matmuls on the card: TF32 off, precision "highest"."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def moonyard_conf(moonyard: dict) -> MoonyardConf:
    """The small-scale yard or lab of an ``environment.moonyard`` section
    (``base``, ``crater``, ``is_lab``, ``is_yard``, ``z_scale``)."""
    crater = {k: (tuple(tuple(r) for r in v) if k == "radius_ranges"
                  else tuple(v) if k == "densities" else v)
              for k, v in (moonyard.get("crater") or {}).items()}
    return MoonyardConf(base=BaseTerrainGeneratorConf(**(moonyard.get("base") or {})),
                        crater=CraterSamplerConf(**crater),
                        is_lab=bool(moonyard.get("is_lab", False)),
                        is_yard=bool(moonyard.get("is_yard", True)),
                        z_scale=float(moonyard.get("z_scale", 1.0)))


def moonyard_dem(moonyard: dict, grid: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """The moonyard generator's DEM cropped or zero-padded to the square
    ``grid``² window, on ``device`` (the JAX ``_moonyard_dem``)."""
    dem = MoonyardGenerator(moonyard_conf(moonyard), dtype, device).randomize()
    out = torch.zeros((grid, grid), dtype=dtype, device=dem.device)
    sy, sx = min(grid, dem.shape[0]), min(grid, dem.shape[1])
    out[:sy, :sx] = dem[:sy, :sx]
    return out


def build_standalone_world(world: dict, dtype=torch.float32, device=None, moonyard=None):
    """The standalone world: crater DEM (``grid_size``² over
    ±``half_width``) and the 750-obstacle costmap (``costmap_size``²), or
    with ``moonyard`` (an ``environment.moonyard`` section) the yard's DEM
    and a free costmap. Returns ``(heightfield, costmap, half_width)``."""
    hw = float(world.get("half_width", 75.0))
    grid = int(world.get("grid_size", 1500))
    size = int(world.get("costmap_size", 750))
    if moonyard:
        hf = HeightField.create(moonyard_dem(moonyard, grid, dtype, device), hw)
        # no obstacle field in the labs and yards: free space
        cm = as_costmap(torch.zeros((size, size), dtype=dtype, device=hf.z.device), hw)
        return hf, cm, hw
    hf = HeightField.create(crater_surface(grid, hw, STANDALONE_CRATER_BUMPS, dtype=dtype,
                                           device=device), hw)
    cm = costmap_750(half_width=hw, size=size, use_exact_edt=True, dtype=dtype, device=device)
    return hf, cm, hw


def mppi_config(d) -> MPPIConfig:
    """MPPIConfig from the tree's ``mppi`` entry: an instance as it is, a
    dict of its fields (nested limits as dicts) built, TPU-only fields
    refused by name."""
    return d if isinstance(d, MPPIConfig) else build_dataclass(MPPIConfig, d or {})


def world_tree(tree: dict) -> dict:
    """The world section: ``environment.world`` with ``world.*`` on top."""
    world = dict((tree.get("environment") or {}).get("world") or {})
    world.update(tree.get("world") or {})
    return world


def moonyard_section(tree: dict):
    """``environment.moonyard``, or ``None``."""
    env = tree.get("environment")
    return env.get("moonyard") if isinstance(env, dict) else None


def run_standalone(tree: dict) -> dict:
    """Goal-seek on the standalone world; the JAX ``run_standalone``'s keys
    (``mppi``, ``world``, ``environment.moonyard``, ``start``, ``goal``,
    ``seed``, ``max_loops``) and ``device``. The result names the device beside ``wall_s``."""
    use_full_fp32_matmul()
    dtype = torch.float32
    device = run_device(tree.get("device"))
    cfg = mppi_config(tree.get("mppi"))
    hf, cm, _ = build_standalone_world(world_tree(tree), dtype, device, moonyard_section(tree))
    start = tree.get("start", {"x": -60.0, "y": -60.0})
    goal_d = tree.get("goal", {"x": 65.0, "y": 60.0})
    goal = torch.tensor([goal_d["x"], goal_d["y"]], dtype=dtype, device=device)
    robot = RobotState.create(start["x"], start["y"], [1.0, 0.5, 0.0],
                              dtype=dtype, device=device)
    ctrl = ControllerState.create(cfg, dtype, device)
    key = jr.key(int(tree.get("seed", 42)), device)  # JAX cli.py:141

    t0 = time.perf_counter()
    res = goal_seek(cfg, hf, cm, goal, robot, ctrl, key,
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
    device = run_device(tree.get("device"))
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
    """The tree's ``closed_loop`` where the configuration instantiated one,
    else ClosedLoopConfig from ``mppi`` and the physics section with the
    loop's own constants at their defaults, as the JAX ``run_closed_loop``
    builds it."""
    cl = tree.get("closed_loop")
    if isinstance(cl, ClosedLoopConfig):
        return cl
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
    ``physics``, ``world``, ``environment.moonyard``, ``seed``) and
    ``device``. The noise and slip come from ``key(0)``, the JAX run's
    key (JAX ``cli.py:187``)."""
    use_full_fp32_matmul()
    dtype = torch.float32
    device = run_device(tree.get("device"))
    n = int(tree.get("num_rovers", 4))
    steps = int(tree.get("steps", 300))
    cfg = closed_loop_config(tree)
    hf, cm, hw = build_standalone_world(world_tree(tree), dtype, device, moonyard_section(tree))
    starts, goals_np = spawn_points(int(tree.get("seed", 42)), n, hw)
    goals = torch.tensor(goals_np, dtype=dtype, device=device)
    state = init_loop_state(cfg, RoverState.create(starts, [1.0, 0.0, 0.0], hf))
    key = jr.key(0, device)

    t0 = time.perf_counter()
    state, path = run_episode(cfg, hf, cm, goals, state, key, num_steps=steps)
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
    periodic checkpoint. The tile pool fields of a ``terrain_streamer``
    section (``native_pool``, ``native_pool_workers``) go to the loop's
    streamer; the JAX package registers that section and reads nothing of
    it (the streamer's geometry comes from the ``largescale`` keys)."""
    env = tree.get("environment") or {}
    ls = dict(env.get("largescale") or tree.get("largescale") or {})
    fields = {f.name for f in dataclasses.fields(LargeScaleConf)}
    kw = {k: v for k, v in ls.items() if k in fields}
    if "crater_gen_densities" in kw:
        kw["crater_gen_densities"] = tuple(kw["crater_gen_densities"])
    if "crater_gen_radius" in kw:
        kw["crater_gen_radius"] = tuple(tuple(r) for r in kw["crater_gen_radius"])
    if "rock_gen_cfgs" in kw:
        kw["rock_gen_cfgs"] = tuple(c if isinstance(c, RockDistConf) else RockDistConf(**c)
                                    for c in kw["rock_gen_cfgs"])
    terrain = LargeScaleConf(**kw)
    streamer = tree.get("terrain_streamer")
    if streamer is not None:
        given = streamer if isinstance(streamer, dict) else dataclasses.asdict(streamer)
        for name in ("native_pool", "native_pool_workers"):
            if name in given:
                setattr(terrain.streamer_conf, name, given[name])
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
    device = run_device(tree.get("device"))
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


def render_settings_from_cfg(tree: dict) -> RenderSettings | None:
    """The ``rendering`` group as RenderSettings (the ``startSim`` path,
    src/environments_wrappers/__init__.py:96-135: lens flares, chromatic
    aberrations and motion blur from the rendering config before SDG)."""
    rend = tree.get("rendering") or {}
    if not isinstance(rend, dict):
        return None
    settings = RenderSettings()
    ca = dict(rend.get("chromatic_aberration") or {})
    if "strength" in ca:
        ca["strength"] = tuple(ca["strength"])
    for apply, cls, section in ((apply_lens_flare, FlaresConf, rend.get("flares")),
                                (apply_chromatic_aberrations, ChromaticAberrationsConf, ca),
                                (apply_motion_blur, MotionBlurConf, rend.get("motion_blur"))):
        fields = {f.name for f in dataclasses.fields(cls)}
        apply(cls(**{k: v for k, v in (section or {}).items() if k in fields}), settings)
    return settings


def _section(value):
    """An optional ``sdg`` sub-section: ``true`` is ``{}``, a mapping is
    itself, anything else (``false``, absent) is off."""
    if value is True:
        return {}
    return value if isinstance(value, dict) else None


def run_sdg(tree: dict) -> dict:
    """Synthetic-data generation (the JAX ``run_sdg``): ``sdg.num_images``
    fresh yards from the default ``MoonyardConf`` (the environment group's
    yard is not read, as in the JAX run) on ``device``, each with a
    hardcore-Poisson rock scatter (``sdg.rocks``: density, r_min, r_max;
    ``false`` turns it off; padded to ``labeling.rock_capacity`` of the
    density, so that the labeler's two CUDA graphs serve every frame) and a
    random sun, labeled top-down and, with
    ``sdg.camera`` (width, height, pitch_deg, mount_height, steps,
    cast_shadows), from a robot-mounted camera. The host draws (rocks,
    sun, camera pose) come from ``numpy.random.default_rng(seed)`` in the
    JAX run's order, so they equal its draws. The result adds the seconds
    spent per phase (``generator``, ``top_down``, ``camera``, ``write``)
    and ``device``."""
    use_full_fp32_matmul()
    device = run_device(tree.get("device"))
    sdg = tree.get("sdg", {})
    fields = {f.name for f in dataclasses.fields(LabelingConf)}
    conf = LabelingConf(**{k: v for k, v in sdg.items() if k in fields})
    gen = MoonyardGenerator(MoonyardConf(), device=device)
    cam_cfg, rock_cfg = _section(sdg.get("camera")), _section(sdg.get("rocks", {}))
    # one rock capacity for every frame (the passes are CUDA graphs on the
    # card); a frame that draws more rocks raises
    base = gen.conf.base
    capacity = 0 if rock_cfg is None else rock_capacity(float(rock_cfg.get("density", 0.08)),
                                                         base.x_size * base.y_size)
    labeler = AutonomousLabeling(conf, render_settings_from_cfg(tree), rock_capacity=capacity)
    rng = np.random.default_rng(int(tree.get("seed", 42)))
    res = gen.conf.base.resolution
    generator_s = 0.0
    for _ in range(conf.num_images):
        t0 = time.perf_counter()
        dem = wait_for(gen.randomize())
        generator_s += time.perf_counter() - t0
        rock_xy = rock_r = None
        if rock_cfg is not None:
            yard = BoundingBox(0.0, gen.conf.base.x_size, 0.0, gen.conf.base.y_size)
            rock_xy, rock_r = hardcore_poisson(
                rng, yard, (float(rock_cfg.get("density", 0.08)),),
                ((float(rock_cfg.get("r_min", 0.08)), float(rock_cfg.get("r_max", 0.4))),))
        # a random sun between captures (stellar-driven in the reference)
        az = rng.uniform(0, 2 * np.pi)
        el = rng.uniform(np.deg2rad(10), np.deg2rad(60))
        sun = (float(np.cos(el) * np.cos(az)), float(np.cos(el) * np.sin(az)),
               float(np.sin(el)))
        frame_id = labeler.frame  # the camera products join this capture's id
        labeler.record(dem, res, sun_direction=sun, rock_xy=rock_xy, rock_radius=rock_r)
        if cam_cfg is not None:
            h, w = dem.shape
            px = rng.uniform(0.15, 0.85) * h * res
            py = rng.uniform(0.15, 0.85) * w * res
            yaw = rng.uniform(0, 2 * np.pi)
            intr = CameraIntrinsics(width=int(cam_cfg.get("width", CameraIntrinsics.width)),
                                    height=int(cam_cfg.get("height", CameraIntrinsics.height)))
            labeler.record_camera(
                dem, res, (0.0, 0.0), (px, py), (float(np.cos(yaw)), float(np.sin(yaw))),
                float(dem[int(px / res), int(py / res)]), intrinsics=intr,
                sun_direction=sun, rock_xy=rock_xy, rock_radius=rock_r,
                mount_height=float(cam_cfg.get("mount_height", 0.8)),
                pitch_deg=float(cam_cfg.get("pitch_deg", 15.0)),
                steps=int(cam_cfg.get("steps", 128)),
                cast_shadows=bool(cam_cfg.get("cast_shadows", False)), frame=frame_id)
    return {
        "mode": "sdg",
        "num_images": conf.num_images,
        "camera": cam_cfg is not None,
        "output_dir": str(labeler.run_dir),
        "seconds": {"generator": generator_s, **labeler.seconds},
        "device": str(device),
    }


MODES = {"standalone": run_standalone, "evaluation": run_evaluation,
         "closed_loop": run_closed_loop, "largescale": run_largescale, "sdg": run_sdg}


def compose(argv) -> dict:
    """The instantiated configuration tree of a command line, composed as
    the JAX CLI's ``main`` does: ``cfg/config.yaml`` (or ``--config=``), a
    ``group=name`` argument for each of :data:`GROUPS` swapping in
    ``<group>/<name>.yaml`` beside it, ``mode=X`` merging ``mode/X.yaml``
    where there is one (losing to the dotted overrides), then the dotted
    ``key=value`` overrides and :func:`instantiate_configs`."""
    cfg_path, overrides = CONFIG, []
    for arg in argv:
        if arg.startswith("--config="):
            cfg_path = Path(arg.split("=", 1)[1])
        else:
            overrides.append(arg)
    tree = load_config(cfg_path) if cfg_path.exists() else {}
    group_ov = [o for o in overrides if o.split("=", 1)[0] in GROUPS]
    overrides = [o for o in overrides if o not in group_ov]
    for o in group_ov:
        group, name = o.split("=", 1)
        tree[group] = load_config(cfg_path.parent / group / f"{name}.yaml")
    for o in list(overrides):
        if o.startswith("mode="):
            mode_file = cfg_path.parent / "mode" / f"{o.split('=', 1)[1]}.yaml"
            if mode_file.exists():
                for k, v in load_config(mode_file).items():
                    if isinstance(v, dict) and isinstance(tree.get(k), dict):
                        tree[k].update(v)
                    else:
                        tree[k] = v
                overrides.remove(o)
    apply_overrides(tree, overrides)
    return instantiate_configs(tree)


# the modes that take ``trace.out=PATH``
TRACED_MODES = ("standalone", "evaluation", "closed_loop")


def main(argv=None) -> int:
    tree = compose(sys.argv[1:] if argv is None else argv)
    mode = tree.get("mode", "standalone")
    if mode not in MODES:
        print(f"unknown mode {mode!r}; choose from {sorted(MODES)}", file=sys.stderr)
        return 2
    out = (tree.get("trace") or {}).get("out")
    if out is None:
        print(json.dumps(MODES[mode](tree)))
        return 0
    if mode not in TRACED_MODES:
        print(f"trace.out is taken by the modes {list(TRACED_MODES)}, not {mode!r}",
              file=sys.stderr)
        return 2
    trace.enable()
    try:
        result = MODES[mode](tree)
    finally:
        trace.disable()
        trace.dump(out)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
