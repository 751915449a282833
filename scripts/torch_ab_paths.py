"""Time the PyTorch port's two host-bound paths for two checkouts in turns,
on one NVIDIA GPU.

    python3 scripts/torch_ab_paths.py --parent DIR [--bench] [--out FILE]

``DIR`` holds an earlier checkout of the repository (for example a
``git archive`` of the parent commit unpacked under ``build/``). The
checkouts run in turns (parent, this, this, parent), each in a process of
its own started from its root, so that each imports its own
``husky_rover_mppi_isaacsim_torch`` and builds its own kernels (built
before the timed region). A run drives:

* the flagship goal-seek (K=1000 x H=100, (-45, -40) -> (45, 40) on the
  standalone world): ``ms_per_loop`` = episode wall time (host clock,
  synchronised at the end) over its loops, with the loops and the final
  position;
* the CLI's default closed loop (4 rovers, 300 sim steps):
  ``ms_per_sim_step`` = the episode's wall time over its steps, with its
  mean progress.

With ``--bench`` a run is ``python3 bench_torch.py`` instead, and its
line is kept whole. With ``--terrain`` a run drives the streamed terrain at
the ``LargeScaleConf`` defaults instead (after one warm-up build):

* ``world_build_s``: the 7000^2 window's build (host clock, synchronised);
* ``crater_ms_per_block``: the crater block kernel on each of the first
  three blocks, the sum of its radius tiers' launches, each timed alone on
  a zeroed raster out of L2 (``ops.measure.cold_ms``);
* ``base_ms_per_block``: each of those blocks' upsampled base as the
  checkout builds it (``upsample_block`` of the kept crop, or an earlier
  checkout's full ``upsample_bicubic`` and its slice), one at a time out of
  L2 (CUDA events around the call: its host work included);
* ``block_build_ms``: ``build_block`` of each of them again (taken out of
  the block cache first; its craters come from the streamer's crater
  cache), CUDA events around the call, median of 7;
* the pipelined traverse (0, 0) -> (65, 65) (the CLI's default loop):
  ``shift_latency_ms`` of each block shift, with their mean and maximum.

Each run prints one JSON line; all of them also go to ``FILE`` (default
``build/ab_paths.json``). A checkout whose goal-seek takes a JAX key (the
port since its noise became JAX's) gets ``key(seed)``, an earlier one a
``torch.Generator`` seeded ``seed``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

RUN = r'''
import json, subprocess, time
import torch
from husky_rover_mppi_isaacsim_torch.cli import (
    build_standalone_world, closed_loop_episode, use_full_fp32_matmul)
from husky_rover_mppi_isaacsim_torch.mppi import (
    ControllerState, MPPIConfig, RobotState, goal_seek_recorded)

use_full_fp32_matmul()
cuda = torch.device("cuda")
try:  # a checkout whose noise is JAX's takes a key
    from husky_rover_mppi_isaacsim_torch.mppi import loop_key  # noqa: F401
    from husky_rover_mppi_isaacsim_torch.core.jax_random import key as jkey
    noise_key = lambda seed: jkey(seed, cuda)
except ImportError:
    noise_key = lambda seed: torch.Generator(device=cuda).manual_seed(seed)
hf, cm, _ = build_standalone_world({}, device=cuda)
cfg = MPPIConfig(num_samples=1000, horizon=100)

def episode(max_loops, seed):
    robot = RobotState.create(-45.0, -40.0, (1.0, 0.5, 0.0), device=cuda)
    ctrl = ControllerState.create(cfg, device=cuda)
    goal = torch.tensor((45.0, 40.0), device=cuda)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = goal_seek_recorded(cfg, hf, cm, goal, robot, ctrl, noise_key(seed), max_loops=max_loops)
    loops = int(res.loops)
    torch.cuda.synchronize()
    return res, loops, time.perf_counter() - t0

episode(4, 0)  # builds the kernels, outside the timed runs
res, loops, wall = episode(3500, 42)
closed_loop_episode({})  # warm-up
run = closed_loop_episode({})
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True, timeout=60).stdout.strip()
print(json.dumps({
    "card": smi, "flagship_loops": loops, "reached": bool(res.reached),
    "final_position": res.robot.position.tolist(), "flagship_wall_s": wall,
    "ms_per_loop": 1e3 * wall / max(loops, 1),
    "closed_loop_steps": 300, "closed_loop_wall_s": run.wall_s,
    "ms_per_sim_step": 1e3 * run.wall_s / 300,
    "mean_progress_m": float(run.progress.mean())}))
'''


RUN_TERRAIN = r'''
import json, subprocess, time
import numpy as np
import torch
from husky_rover_mppi_isaacsim_torch.cli import (
    largescale_conf, largescale_episode, use_full_fp32_matmul)
from husky_rover_mppi_isaacsim_torch.ops import crater_block_cuda as cbc
from husky_rover_mppi_isaacsim_torch.ops.measure import cold_ms, cuda_ms
from husky_rover_mppi_isaacsim_torch.terrain import craters as tcr
from husky_rover_mppi_isaacsim_torch.terrain.orchestrator import LargeScaleTerrainManager

use_full_fp32_matmul()
cuda = torch.device("cuda")
conf = largescale_conf({})
LargeScaleTerrainManager(conf.terrain, device=cuda).build()  # builds the kernels
torch.cuda.synchronize()
t0 = time.perf_counter()
lstm = LargeScaleTerrainManager(conf.terrain, device=cuda)
lstm.build()
torch.cuda.synchronize()
build_s = time.perf_counter() - t0
streamer = lstm.map_manager.streamer
sc = streamer.conf
per_block = []
for bx, by in list(streamer.block_cache)[:3]:
    origin = np.asarray([bx * sc.block_size, by * sc.block_size], np.float32)
    ms = 0.0
    for field, patch_px in streamer._block_fields(bx, by):
        if not field.mask.any():
            continue
        side = sc.block_px + 2 * sc.pad_px + 2 * patch_px
        row0, col0 = tcr.crater_placement(field, origin, sc.resolution, sc.block_px, sc.pad_px,
                                          patch_px)
        bins = cbc.TileBins(*(torch.from_numpy(a).to(cuda) for a in cbc.tile_bins(
            row0, col0, field.radius.numpy(), field.mask.numpy(), sc.resolution, patch_px,
            side)))
        sub = tcr.CraterField(*(f.to(cuda) for f in field))
        buf = torch.zeros((side, side), device=cuda)
        args = (streamer.profiles, sub, torch.from_numpy(row0).to(cuda),
                torch.from_numpy(col0).to(cuda), sc.resolution, sc.z_scale, patch_px)
        ms += cold_ms(lambda: cbc.crater_block_cuda.launch(buf, *args, bins), reset=buf.zero_)
    per_block.append(ms)
m, bpx = 2 * sc.upscale_factor, sc.block_px
try:  # a checkout with the block upsample: the kept crop alone
    from husky_rover_mppi_isaacsim_torch.terrain.upsample import upsample_block
    base = lambda lr: upsample_block(lr, sc.upscale_factor, (m, m), (bpx, bpx))
except ImportError:  # an earlier one: the full upsample, then the slice
    from husky_rover_mppi_isaacsim_torch.terrain.upsample import upsample_bicubic
    base = lambda lr: upsample_bicubic(lr, sc.upscale_factor)[m:m + bpx, m:m + bpx]
base_ms, build_ms = [], []
for bx, by in list(streamer.block_cache)[:3]:
    lr = streamer._lr_patch(bx, by)
    base_ms.append(cold_ms(lambda: base(lr)))

    def rebuild(bx=bx, by=by):
        streamer.block_cache.pop((bx, by))
        streamer.build_block(bx, by)

    build_ms.append(cuda_ms(rebuild))
del lstm, streamer
run = largescale_episode({})
lat = [1e3 * t for t in run.result.shift_latencies_s]
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True, timeout=60).stdout.strip()
print(json.dumps({
    "card": smi, "world_build_s": build_s, "crater_ms_per_block": per_block,
    "base_ms_per_block": base_ms, "block_build_ms": build_ms,
    "traverse_reached": bool(run.result.reached), "block_shifts": run.result.block_shifts,
    "shift_latency_ms": lat, "shift_latency_mean_ms": sum(lat) / max(len(lat), 1),
    "shift_latency_max_ms": max(lat, default=0.0)}))
'''


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, type=Path)
    ap.add_argument("--bench", action="store_true", help="run bench_torch.py in each turn")
    ap.add_argument("--terrain", action="store_true",
                    help="time the streamed terrain (world build, crater block, shifts)")
    ap.add_argument("--out", type=Path, default=ROOT / "build" / "ab_paths.json")
    args = ap.parse_args(argv)
    trees = {"parent": args.parent.resolve(), "this": ROOT}
    results = []
    for name in ("parent", "this", "this", "parent"):
        env = dict(os.environ, PYTHONPATH=str(trees[name]))
        cmd = (["bench_torch.py"] if args.bench else ["-c", RUN_TERRAIN] if args.terrain
               else ["-c", RUN])
        proc = subprocess.run([sys.executable, *cmd], cwd=trees[name], env=env,
                              capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
        result = {"tree": name, **json.loads(proc.stdout.strip().splitlines()[-1])}
        results.append(result)
        print(json.dumps(result), flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
