"""The thesis drivers' bodies on the port's own library: the 2D-vs-3D
statistics runs that produce the repository's scientific result.

Counterpart of the JAX package's three driver scripts, which stay as they
are: ``scripts/run_thesis_eval.py`` (:func:`thesis_eval`, with the K=500
wheel-critic ablation), ``scripts/run_eval_r05.py`` (:func:`terrain_stats`,
:func:`arm_summary`, :func:`eval_r05_calib`, :func:`eval_r05_full`) and
``scripts/run_eval_experiment.py`` (:func:`eval_experiment`). Each function
returns the JAX script's table with its keys. The JAX tables' TPU-only
``config.gather_engine`` is not written; in its place ``config`` records the
rollout kernels' routes (``kernel_routes``) and the device (``device``: the
card's name and power limit as ``nvidia-smi`` reports them).

Every function runs on the card unless ``device`` names another device,
and raises where the card is asked for and there is none
(:func:`..core.device.run_device`). The thesis DEM is the JAX package's:
its base noise is JAX's draw (:mod:`..core.jax_random`), on the CPU and on
the card alike. Control noise comes from ``torch.Generator``s, so a run on
the card is a fresh sample of the JAX protocol on JAX's terrain, not a
replay of its artifacts.
:func:`output_path` refuses the JAX artifacts' names: the thin ``main``s in
``scripts/torch_run_*.py`` write ``EVAL_torch*.json`` instead.
"""

from __future__ import annotations

import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from ..core.device import run_device
from .evaluation import run_2d_vs_3d_experiment, run_thesis_protocol_experiment

# the JAX package's artifacts, which no driver of the port writes
JAX_ARTIFACTS = frozenset(("EVAL.json", "EVAL_r04.json", "EVAL_r05.json",
                           "EVAL_R05_CALIB.json"))
PROTOCOL_KS = (350, 500, 1000)
PROTOCOL_MAX_LOOPS = 3500
CALIB_Z_SCALES = (0.5, 0.7, 1.0)
CALIB_K, CALIB_RUNS = 350, 16
ABLATION_K = 500
ABLATION_QUESTION = ("does the production wheel-slope critic (3D-only nearest-cell noise) "
                     "degrade the 3D arm relative to the thesis-stats body critic?")
CALIB_ANCHOR = {
    "source": "thesis reported outcomes (work summarise:58-60,73)",
    "targets": ["3D ~100% collision-free", "3-5% 3D margins at low K",
                "speeds up to 1.8 m/s"],
}


def output_path(out, default: str, root: Path) -> Path:
    """Where a driver writes its table: ``out`` when given, else ``root /
    default``. Raises ``ValueError`` for a JAX artifact's name, in any
    directory."""
    path = Path(out) if out else root / default
    if path.name in JAX_ARTIFACTS:
        raise ValueError(f"{path.name} is the JAX package's artifact; the port writes "
                         "EVAL_torch*.json")
    return path


def run_record(device) -> dict:
    """``config`` entries of a port run: the rollout kernels' routes and the
    device, a card's name and power limit (``nvidia-smi --query-gpu=name,
    power.limit``)."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"kernel_routes": {"rollout_3d": "plain", "rollout_2d": "plain"},
                "device": {"name": "cpu", "power_limit": None}}
    index = device.index if device.index is not None else torch.cuda.current_device()
    lines = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()
    return {"kernel_routes": {"rollout_3d": "cuda", "rollout_2d": "cuda"},
            "device": {"name": torch.cuda.get_device_name(index),
                       "power_limit": lines[index].rsplit(",", 1)[1].strip()}}


def terrain_statistics(z, resolution: float = 0.1) -> dict:
    """Measurable statistics of a height field on the host
    (``run_eval_r05.py::terrain_stats``, :42-72): RMS slope and slope
    percentiles at the grid's resolution, RMS height about a 5 m
    moving-average trend, the height span."""
    from scipy.signal import fftconvolve

    z = np.asarray(z)
    gx = np.diff(z, axis=0)[:, :-1] / resolution
    gy = np.diff(z, axis=1)[:-1, :] / resolution
    slope = np.degrees(np.arctan(np.hypot(gx, gy)))
    k = 50
    kern = np.ones((k, k)) / (k * k)
    trend = fftconvolve(z, kern, mode="same")
    rough = z - trend
    return {
        "rms_slope_deg": round(float(np.sqrt((slope ** 2).mean())), 2),
        "slope_p50_deg": round(float(np.percentile(slope, 50)), 2),
        "slope_p90_deg": round(float(np.percentile(slope, 90)), 2),
        "slope_p99_deg": round(float(np.percentile(slope, 99)), 2),
        "rms_height_m": round(float(rough.std()), 3),
        "height_span_m": round(float(z.max() - z.min()), 2),
    }


def terrain_stats(z_scale: float, device=None, base_noise=None, size_m: float = 150.0) -> dict:
    """The port's thesis statistics terrain at ``z_scale``, built as the
    JAX script builds it (seed 42, 0.1 m/px, elevations +-1.2 z_scale), and
    its :func:`terrain_statistics`."""
    from ..terrain import thesis_statistics_terrain

    z = thesis_statistics_terrain(seed=42, size_m=size_m, z_scale=z_scale,
                                  max_elevation=1.2 * z_scale, min_elevation=-1.2 * z_scale,
                                  base_noise=base_noise, device=run_device(device))
    return {"z_scale": z_scale, **terrain_statistics(z.cpu().numpy())}


def arm_summary(per_k: dict) -> dict:
    """Collision-free percentages per arm (the thesis's 100%-3D headline,
    work summarise:73): completed / (completed + collided), over runs that
    reached the goal (failures excluded, evaluate_trajectory.py:80-110);
    ``run_eval_r05.py:75-93``."""
    out = {}
    for k, row in per_k.items():
        arms = row["arms"]
        out[str(k)] = {
            a: {
                "collision_free_pct": round(
                    100.0 * arms[a]["completed"]
                    / max(arms[a]["completed"] + arms[a]["collided"], 1), 1),
                "collided": arms[a]["collided"],
                "completed": arms[a]["completed"],
                "failed": arms[a]["failed"],
            }
            for a in arms
        }
    return out


def thesis_eval(runs_per_arm: int = 64, ks=PROTOCOL_KS, ablation_k: int = ABLATION_K,
                max_loops: int = PROTOCOL_MAX_LOOPS, device=None, **protocol) -> dict:
    """``run_thesis_eval.py`` (EVAL_r04): the thesis protocol at ``ks``, then
    the mechanism ablation, the same paired comparison at ``ablation_k``
    with the wheel-slope critic, at ``max(16, runs_per_arm // 4)`` runs per
    arm. ``protocol`` goes to both runs of
    :func:`.evaluation.run_thesis_protocol_experiment`."""
    device = run_device(device)
    t0 = time.time()
    table = run_thesis_protocol_experiment(ks=ks, runs_per_arm=runs_per_arm,
                                           max_loops=max_loops, device=device, **protocol)
    table["config"].update(run_record(device))
    ablation = run_thesis_protocol_experiment(ks=(ablation_k,),
                                              runs_per_arm=max(16, runs_per_arm // 4),
                                              max_loops=max_loops, slope_critic="wheels",
                                              device=device, **protocol)
    table["ablation"] = {"question": ABLATION_QUESTION,
                         f"wheels_critic_K{ablation_k}": ablation["per_k"][ablation_k]}
    table["config"]["wall_s"] = round(time.time() - t0, 1)
    return table


def _r05_run(ks, runs_per_arm: int, z_scale: float, device, **protocol) -> dict:
    """``run_eval_r05.py::run``: the protocol at ``z_scale``, its wall time
    and :func:`arm_summary`."""
    t0 = time.time()
    table = run_thesis_protocol_experiment(ks=ks, runs_per_arm=runs_per_arm,
                                           terrain_z_scale=z_scale, device=device, **protocol)
    table["wall_s"] = round(time.time() - t0, 1)
    table["collision_free_pct"] = arm_summary(table["per_k"])
    return table


def eval_r05_calib(z_scales=CALIB_Z_SCALES, k: int = CALIB_K, runs_per_arm: int = CALIB_RUNS,
                   half_width: float = 75.0, device=None, **protocol) -> dict:
    """``run_eval_r05.py calib`` (EVAL_R05_CALIB): for each terrain z_scale,
    the terrain's statistics beside the protocol's outcomes at one K."""
    device = run_device(device)
    out = {"anchor": CALIB_ANCHOR, "sweep": [], "config": run_record(device)}
    for zs in z_scales:
        entry = terrain_stats(zs, device=device, size_m=2 * half_width)
        table = _r05_run((k,), runs_per_arm, zs, device, half_width=half_width, **protocol)
        entry[f"k{k}"] = table["per_k"][k]["critics"]
        entry["arms"] = table["per_k"][k]["arms"]
        entry["collision_free_pct"] = table["collision_free_pct"]
        entry["wall_s"] = table["wall_s"]
        out["sweep"].append(entry)
    return out


def eval_r05_full(z_scale: float, runs_per_arm: int = 64, ks=PROTOCOL_KS,
                  half_width: float = 75.0, device=None, **protocol) -> dict:
    """``run_eval_r05.py full Z`` (EVAL_r05): the whole protocol at
    ``z_scale``, with the terrain's statistics."""
    device = run_device(device)
    table = _r05_run(ks, runs_per_arm, z_scale, device, half_width=half_width, **protocol)
    table["config"].update(run_record(device))
    table["terrain_stats"] = terrain_stats(z_scale, device=device, size_m=2 * half_width)
    return table


def eval_experiment(runs_per_arm: int = 64, ks=PROTOCOL_KS, max_loops: int = 2000,
                    span_fraction: float = 0.45, device=None, **episode) -> dict:
    """``run_eval_experiment.py`` (EVAL): the episode-total 2D-vs-3D
    experiment on the crater map, ~65 m paired traverses under a 2000-loop
    cap. ``episode`` goes to :func:`.evaluation.run_2d_vs_3d_experiment`."""
    device = run_device(device)
    t0 = time.time()
    table = run_2d_vs_3d_experiment(ks=ks, runs_per_arm=runs_per_arm, max_loops=max_loops,
                                    span_fraction=span_fraction, device=device, **episode)
    table["config"].update(run_record(device))
    table["config"]["wall_s"] = round(time.time() - t0, 1)
    return table
