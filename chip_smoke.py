"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds kernels K1 (husky_rover_mppi_isaacsim_torch/csrc/rollout.cu), K2
(csrc/edt_minplus.cu), K3 (csrc/gather_probe.cu), the port's own crater
block kernel (csrc/crater_block.cu) and its planar rollout kernel
(csrc/rollout_2d.cu, the 2D arm's sample rollout) and the jax_normal kernel
(csrc/jax_normal.cu, JAX's normals for every control and slip draw) and
the block upsample kernel (csrc/upsample_taps.cu, both bicubic passes of a
streamed block's kept base in one launch) from the sources, one nvcc each, and the host runtime (csrc/husky_native.cpp)
with g++, all started together; holds the crater block kernel's device
copies of XLA's exp and glibc's atan2f, atanf, sinf and cosf
(csrc/xla_math.cuh) against their plain versions (core/xla_math.py) on 2^24
probes each, and those plain versions on the card against the CPU's, bit for
bit; holds each kernel against its plain
PyTorch version on the card, bit for bit (jax_normal at the loops' shapes,
with a split, a fold-in, a chunk's device index and a count offset, and
against the same plain draw on the CPU, which the CPU tests hold against
jax.random.normal; the planar rollout kernel on both outputs at K=1000,
500 and 350 x H=100 on the thesis DEM and on the crater DEM, a ragged K=33
x H=37 shape, a start off the DEM, N=4 rovers in one launch against
one-rover launches, and its cosf / sinf against torch's on the run's
arguments; its time beside the byte bound and the floor of its H-step
heading chain; K1 on every channel: the flagship shapes, the K=1
optimal rollout, a ragged K=33 x H=37 shape, a start off the DEM,
bench_torch.py's large batch (K=16384 x H=64, with and without the wheel
tracks) and its K=1 x H=64 optimal rollout, and N=4 rovers in one launch against one-rover launches; the
branch-free division and square root of K1 and the planar rollout kernel against `/` and sqrtf on 2^36 operand pairs and every
float32 operand; K1 on 8 samples against the float64 Warp-semantics
oracle, compat.warp_oracle); times each kernel back to
back and as one CUDA-graph replay of 20 launches (device time without the
host's issue time); builds the standalone world on the card (its
costmap through K2; its 1500^2 crater map and 750^2 costmap torch.equal to
the CPU's); checks one control step and one N=4 closed-loop step on
the card against the same steps on the CPU, and counts the device kernels of
each (a K1 call dispatches no torch operator but the output's empty); drives
the flagship goal-seek (K=1000 x H=100, (-45, -40) -> (45, 40) on the 150 m
crater map with the 750-obstacle costmap), the CLI's default closed loop (4
rovers, 300 sim steps, the same world and widths) and 4096 simulated rovers
for 400 physics steps; holds bench_torch.py's graphs against their eager
runs (its K=16384 x H=64 control loops under both slope critics, its vec
env's graph of 100 steps over 400 steps) and runs its measurement in this
process (bench.py's line, printed as it is: control loops, vec env,
goal-seek, closed loop and five 100 m traverses at 48-step chunks), after
the streamed-terrain slice and before the first profiler trace; drives the
host shell's SimulationManager (5 robot slots, 300 ticks over its message
bus: spawns, a teleport, a reset, a pose subscriber; its first ticks on the card against the CPU's), the
MPPIController's run on the flagship (its step bit-equal to mppi_step), and
the sharded step on torch.distributed ranks in their own processes (one
NCCL rank bit-equal to mppi_step, two gloo ranks sharing the card, the
rover x sample meshes, the scaling sweep's report); runs graft_entry_torch.py (its
entry step on the card with K1's two launches counted, each held against
the plain rollout bit for bit, the script in its own process, and its
dryrun_multichip(2) on two gloo ranks sharing the card); draws JAX's
world streams (core.jax_random: the thesis DEM's base-noise grids and
bench_torch.py's vec-env starts) on the card, torch.equal to the CPU's,
builds the seed-42 thesis DEM at z 0.7 on the card and on the CPU (each
DEM's statistics EVAL_r05.json's, the JAX package's terrain) and the SDG
yard on both, torch.equal; runs the thesis 2D-vs-3D evaluation protocol at full
width (K=1000 x H=100, 1500^2 DEM and 1500^2 costmap, one run per arm, the
protocol's 3500-loop cap), graphed and eager, with the plain 2D rollout
timed alone and the 2D arm's graph timed on the planar rollout kernel
against the same graph on the plain rollout it replaced; runs the thesis
drivers (mppi/thesis_runs.py: the r04 table with its wheel-critic
ablation, the r05 calibration and full run, the episode experiment) at 6
runs per arm, one K and one terrain scale under the full loop cap; runs
K3's probe entry point; and drives the streamed-terrain
full-stack loop (mode=largescale) at the LargeScaleConf defaults: builds the
7000^2 window twice on the crater block kernel (bit-equal) and once on its
plain version (every slot rendered as a patch, the live ones added by
slice adds; bit-equal to them), and once on the CPU (torch.equal to the
card's), holds the kernel against its plain version
on every radius tier of the world's first blocks and on each whole block
(timing the padded render it replaced beside it),
holds K1 on that window at two poses (the
second within one horizon of the window's edge after a block shift) and K2
at the 875^2 costmap against their plain versions (that costmap card = CPU),
checks that a shift
leaves world heights where they were, steps one 12-step chunk on the card
against the same chunk on the CPU, and drives traverses (0, 0) -> (65, 65)
through the CLI's entry, in turns: the synchronous loop with shift
pre-staging and its verification (every staged costmap and window
bit-equal to the rebuild; it checkpoints past its first shift), the CLI's
default pipelined loop (terrain worker on a side CUDA stream; every seated
costmap bit-equal to its rebuild) and the synchronous loop without
pre-staging, cut to SYNC_STEPS; then resumes the first from its checkpoint
(bit-identical to the uninterrupted run), reads the chunk's device rate, and
drives a short wheel-track-deformed traverse across a block border (K1 on the
deformed window bit-equal, a stamp on the card against the CPU); builds the
7000^2 window on the native tile pool (native_pool="always": bicubic bases on
the pool's 8 C++ threads, uploaded without a host sync, craters stamped on
the card) against the device route, the pool's bases on the card against the
CPU's, K1 on the pool-built window, and drives a synchronous traverse with
the CLI's override terrain_streamer.native_pool=always, cut to POOL_STEPS;
and drives the pipelined traverse once more with JAX's pacing (no wait on
the terrain worker), held to the criteria for removing the port's dispatch
bound (reached, the bounded run's block shifts, at least its pre-stage hits,
one costmap rebuild per shift) and reported beside the bounded run, then
both again at bench_torch.py's 48-step chunks (the bound, counted in sim
steps, is 8 chunks at 12 steps and 6 at 48). The streamed
chunk's graph reads the window and costmap in place (graph_chunk times it
against a graph that copies them).
K3, jax_normal and the block upsample are timed
beside an empty kernel of their grid and block (the launch floor); the
jax_normal kernel's bound counts the function's own operations a value
by pipe (JAX_NORMAL_OPS, each data-dependent side weighed by the draw's
values that take it), and the block upsample is held to its plain version
at the streamed block's crop, one launch a block, beside the one library
call that computes it (torch.linalg.multi_dot). The CLI's paths through its composed cfg/ tree: mode=sdg
(cfg/mode/sdg.yaml with its camera block on: 10 frames of the 500^2 yard
with rocks, a 640 x 480 camera marched in 128 steps with cast shadows)
under both rendering files, timed by phase (each frame's top-down and
camera passes replayed as two CUDA graphs), the same 10 frames through the
eager labeler and the graphed one in turns (every modality equal), and one
capture on the card held against the CPU's; K1 on the 4000^2 DEM of environment=lunaryard_80m
bit-equal to its plain version, that yard's goal-seek (-30, -30) -> (30, 30)
at K=1000 x H=100, and environment=lunalab's 4-rover closed loop; the
worldbuilders' rock request on that yard DEM (RequestMixer: hard-core Thomas
xy, image and normal-map clippers) on the card against the CPU; the SDG
frame's device kernels are counted after every timed path. Each path runs with the
kernels' launch counts set to 0 just before it and read just after. Each
phase prints one line; any failure raises and the exit code is not 0. The
last two lines are the kernel table (each kernel's time beside its bound,
its plain version and the one-call library time where there is one) and the
result, as JSON. Needs one CUDA card; without one it exits with code 1 and
prints no result. ``--only largescale`` (for iterating on the card) runs the
build and the streamed-terrain phases alone and prints neither the kernel
table nor the result; ``--only cli`` runs the build and the CLI's paths
the same way.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from unittest import mock

K, H, DT = 1000, 100, 0.045
START, GOAL, HEADING = (-45.0, -40.0), (45.0, 40.0), (1.0, 0.5, 0.0)
REPS = 7
# Control-loop cap of each evaluation run: the protocol's own. With the 2D
# arm's sample rollout one launch of the planar rollout kernel, both arms'
# graphs take well under a millisecond a loop.
EVAL_MAX_LOOPS = 3500
# the thesis drivers' phase: runs per arm (the protocol refuses 5 or fewer),
# its one terrain scale (the one EVAL_R05_CALIB.json picked) and its 2D
# arm's before/after timing: control loops graphed on the kernel and on the
# plain rollout_2d
DRIVER_RUNS, DRIVER_Z_SCALE, ARM_2D_LOOPS = 6, 0.7, 200
ROVERS, SIM_STEPS = 4, 300          # the CLI's closed-loop defaults
# The streamed traverses. The synchronous one without pre-staging is cut
# to SYNC_STEPS sim steps (past its first block shift); the prestage-verify
# traverse checkpoints at CKPT_EVERY sim steps (past its first shift) into
# the checkout's ignored build/ directory; the deformed traverse starts 1 m
# before the x = 25 m block border.
SYNC_STEPS, CKPT_EVERY = 3000, 3600
# dispatch_bound: the pipelined traverse bounded and unbounded at
# bench_torch.py's chunk of 48 sim steps too
CHUNK_48 = 48
# graph_chunk: chunks run eagerly and as a graph replay, in turns, on the
# second 7000^2 world; a block shift seats a new window half-way
GRAPH_CHUNKS = 12
# crater_block: the 7000^2 world's first blocks whose radius tiers the
# crater block kernel is held against its plain version on
CRATER_BLOCKS = 3
BUILD = Path(__file__).resolve().parent / "build"
CKPT = BUILD / "smoke_traverse.ckpt"
DEFORM_START, DEFORM_GOAL, DEFORM_STEPS = (24.0, 0.5), (30.0, 0.5), 480
# the peak device memory of the synchronous traverse without pre-staging
# as first measured (H100 80GB HBM3, 700 W), printed beside this run's
# (which excludes what earlier phases still hold)
UNSTAGED_TRAVERSE_PEAK_BYTES = 1.71e9
VEC_ROVERS, VEC_STEPS = 4096, 400   # bench.py's vec-env shapes
# bench.py's large batch (bench_torch.py: K1 at 512 blocks of 32 samples)
# and its control loops' start; bench_graphs holds BENCH_LOOPS of them
# graphed against eager, and the vec env's graph of VEC_BLOCK steps
BENCH_K, BENCH_H, BENCH_START, BENCH_LOOPS, VEC_BLOCK = 16384, 64, (-60.0, -60.0), 8, 100
# the simulation manager's run: 5 robot slots (3 robots spawned over the
# bus), 300 ticks timed in windows of 30, its first 5 ticks against the CPU;
# the teleport target of tick 100
SIM_SLOTS, SIM_TICKS, SIM_WINDOW, SIM_CHECK = 5, 300, 30, 5
SIM_SPAWNS = {"husky_0": START, "husky_1": (-40.0, 30.0), "husky_2": (35.0, -40.0)}
SIM_TELEPORT = (0.0, -20.0)
# the 2-rank sharded step's optimal inputs against the unsharded step's: the
# weighted sums are float32 sums of 500 + 500 terms against one of 1000
SHARD_U_ATOL = 1e-5
# mode=sdg as cfg/mode/sdg.yaml has it, its commented camera block switched
# on; the frames go to the checkout's ignored build/ directory
SDG_FRAMES = 10
SDG_ARGS = ["mode=sdg", f"sdg.num_images={SDG_FRAMES}", f"sdg.data_dir={BUILD / 'sdg'}",
            "sdg.camera={width: 640, height: 480, pitch_deg: 15.0, mount_height: 0.8, "
            "steps: 128, cast_shadows: true}"]
# the yard goal-seek (environment=lunaryard_80m: a 4000^2 DEM at 0.02 m/px)
# and the lab's closed loop (environment=lunalab), the widths of cfg/
YARD_ARGS = ["mode=standalone", "environment=lunaryard_80m", "start.x=-30", "start.y=-30",
             "goal.x=30", "goal.y=30"]
LAB_ARGS = ["mode=closed_loop", "environment=lunalab"]
# the card-vs-CPU tolerances of tests/test_torch_labeling.py and
# tests/test_torch_cli.py (each derived there): terrain shades, depths on
# the terrain and on rocks (a ray grazing a rock's silhouette takes the root
# of a near-zero discriminant), rock shades, the post-effected top-down
# rgb, and the share of pixels whose hit, class or instance may differ
SHADE_ATOL, DEPTH_RTOL, ROCK_RTOL, ROCK_SHADE_ATOL, WARP_ATOL = 1e-6, 1e-5, 1e-3, 1e-3, 1e-4
HIT_SHARE = 0.9999
# the tile pool route: the 7000^2 window's pool-built and device-built
# heights agree to tests/test_torch_native.py's bound on the synthetic LOLA
# DEM (float32 upsample sums in another order); the pool traverse (0, 0) ->
# (65, 65), synchronous with pre-staging, is cut to POOL_STEPS sim steps,
# past its first block shift: on H100 80GB HBM3 at 700 W its rover stood at
# (21.5, 21.9) after 2400 steps and at (24.3, 24.1) after 3000, short of the
# x, y = 25 m border (the path moves with the window's last bits)
ROUTE_ATOL, POOL_STEPS = 1e-4, 4200
# the worldbuilders' rock request on the lunaryard_80m DEM (4000^2 at
# 0.02 m/px): hard-core Thomas xy, z and orientation clipped from the DEM
WB_MPP, WB_SEED = 0.02, 11
# K1 against the Warp-semantics oracle: samples, and the CPU float32
# rollout tests' bound (tests/test_torch_rollout.py) on trajectory,
# headings and wheel xy, with >= 98% of wheel heights equal
ORACLE_SAMPLES, ORACLE_ATOL, ORACLE_WHEEL_Z_SHARE = 8, 5e-4, 0.98
# xla_math: probes per function (the crater block kernel's device copies of
# XLA's and glibc's functions against their plain versions), in chunks
XLA_MATH_PROBES, XLA_MATH_CHUNK = 1 << 24, 1 << 22


# one H100 SXM's published peaks (NVIDIA data sheet): HBM bytes per second,
# and float32 instructions per second outside the tensor cores (67 TFLOP/s
# counts an FMA as two operations; a lone add or min is one instruction,
# and 128 lanes per SM per clock is also the rate at which an SM issues
# instructions of any kind)
PEAK_BYTES_S = 3.35e12
PEAK_FP32_S = 67e12
PEAK_FP32_INSTR_S = PEAK_FP32_S / 2
# float32 operations of one K1 sample-step with wheel tracks, counted from
# csrc/rollout.cu (divisions and square roots as one each): an upper bound
K1_FLOPS_PER_STEP = 150
# float32 instructions of one planar rollout sample-step, counted from
# csrc/rollout_2d.cu with each division, square root, cosf, sinf and trunc
# as one: the velocity products 2, update_position 12, the rotation with
# its cosf and sinf 8, its norm 4, the guard and its divisions 3, the cell
# index 7, the fractions 6, the bilinear weights and sum 13 (the integer
# index arithmetic not counted)
ROLLOUT_2D_OPS_PER_STEP = 55
# dependent operations of one step of the planar rollout kernel's heading
# chain, counted from csrc/rollout_2d.cu (turn() in the Fast form): the
# rotation's product and difference 2, the norm's products and sum 2, the
# square root's rsqrt and its three corrections 4, the reciprocal's rcp and
# its two refinements 3, the quotient and its two corrections 3, the
# signed-zero select 1
ROLLOUT_2D_CHAIN_DEPTH = 15
# the chain floor counts each dependent operation at 4 cycles, the latency
# between an FP32 add, multiply or FMA and its dependent (an rsqrt or rcp
# takes longer, so the floor is a lower bound), at the card's highest SM
# clock as nvidia-smi reports it (clocks.max.sm)
DEPENDENT_OP_CYCLES = 4
# operations of the crater block kernel per (slot, pixel) pair inside a
# crater's rotated square, counted from csrc/crater_block.cu with each
# division, square root, atan2 and exp as one and a fused multiply-add as
# one: the square tests 5, the rotation 4 (two products, two FMAs), the
# rotated-square test 4, theta 2 (the atan2, an FMA), three table lookups
# 12 each (clamp 2, scale, floor, convert, index min, two subtractions, two
# loads, a product, an FMA), the marks 2, m 5 (the division, a product, an
# FMA, the square root, a product), the envelope 7 (two tests, one
# branch), the marks' FMA and the clamp 2, the height's division and
# products 3, the accumulation 1 (patches of 56 pixels or fewer add the
# unfused atan2 arguments' two products and two sums)
CRATER_OPS_PER_PAIR = 71
# operations of one jax_normal value, counted once from the function (JAX's
# float32 jax.random.normal as XLA's CPU program computes it,
# core/jax_random.py), not from a build: each data-dependent side counted
# only for the values that take it, a select as a branch (no operation)
# unless the value needs it, per-key constants not counted, a division
# or square root as one. By the pipe each issues on, per SM and clock on an
# H100 (NVIDIA's H100 data sheet: 64 INT32 lanes, 128 FP32 lanes, 16
# special-function lanes; four schedulers issuing 128 lanes' instructions):
# "alu" integer add, logic, shift, funnel shift, compare and float
# min / max / compare at 64; "fma" float add, multiply, FMA (and integer
# multiplies, none here) at 128; "xu" divisions, square roots and
# conversions at 16; and every one against the issue rate of 128.
#   common: the hash 72 alu (20 rounds of an add, a funnel shift and a
#     xor; 6 key injections of two adds), the output word's xor 1, the
#     uniform's shift and or 2, its sub and FMA 2 fma, its max 1; -x^2 1
#     fma; log1p's side test 1; erf_inv's side test 1, its 9-term
#     polynomial 8 FMAs, the |x| == 1 test 1, the products by x and
#     sqrt(2) 2 fma: 79 alu, 13 fma
#   log1p's rational side (|x^2| < sqrt(2) - 1): y^2, y * 0, two 7-op
#     polynomials, y * y^2, its product by the quotient, an FMA, the sum:
#     20 fma; the quotient 1 xu
#   its log side: y + 1, the exponent's add, the mantissa's sub and add,
#     the exponent's correction, z, x^3, three 2-FMA polynomials, q 2, r 2,
#     s 2, the result's FMA: 20 fma; the max, the exponent's shift and sub,
#     the mantissa's and-or (one LOP3), its test and select, the three
#     special-value tests: 9 alu; the exponent's conversion 1 xu
#   erf_inv's w < 5 side: w = -2.5 - l, 1 fma; its w >= 5 side: the square
#     root 1 xu, its add 1 fma
JAX_NORMAL_OPS = {"common": {"alu": 79, "fma": 13},
                  "rational": {"fma": 20, "xu": 1}, "log": {"alu": 9, "fma": 20, "xu": 1},
                  "w_lt5": {"fma": 1}, "w_ge5": {"fma": 1, "xu": 1}}
SM_LANES = {"alu": 64, "fma": 128, "xu": 16, "issue": 128}
H100_SMS = 132

def bound(bytes_moved, ops, op_rate):
    """The least time in ms for ``bytes_moved`` bytes and ``ops`` operations
    at ``op_rate`` per second, and which of the two sets it."""
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_S, ops / op_rate
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase(label, **fields):
    print(json.dumps({"phase": label, **fields}), flush=True)


def ptxas_lines(built):
    return [ln.strip() for ln in built.log.splitlines() if "registers" in ln or "spill" in ln]


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=["largescale", "cli"])
    only = ap.parse_args(argv).only

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 1

    from husky_rover_mppi_isaacsim_torch import env as tenv
    from husky_rover_mppi_isaacsim_torch import native
    from husky_rover_mppi_isaacsim_torch.aux.labeling import (
        AutonomousLabeling,
        CameraIntrinsics,
        LabelingConf,
        rock_capacity,
    )
    from husky_rover_mppi_isaacsim_torch.cli import (
        build_standalone_world,
        closed_loop_config,
        closed_loop_episode,
        compose,
        largescale_conf,
        largescale_episode,
        largescale_report,
        moonyard_section,
        mppi_config,
        render_settings_from_cfg,
        run_sdg,
        run_standalone,
        spawn_points,
        use_full_fp32_matmul,
        world_tree,
    )
    from husky_rover_mppi_isaacsim_torch.core import HeightField, grid_lookup
    from husky_rover_mppi_isaacsim_torch.core.heightfield import (
        corner_cell,
        nearest_height,
        wrap_clamp,
    )
    from husky_rover_mppi_isaacsim_torch.env import frames
    from husky_rover_mppi_isaacsim_torch.env.largescale_loop import (
        LargeScaleClosedLoop,
        run_chunk,
    )
    from husky_rover_mppi_isaacsim_torch.core.graphs import Graphed
    from husky_rover_mppi_isaacsim_torch.mppi import (
        ControllerState,
        CriticWeights,
        MPPIConfig,
        MPPIController,
        RobotState,
        evaluation,
        goal_seek_recorded,
        kinematic_advance,
        masked_steps,
        mppi_step,
    )
    from husky_rover_mppi_isaacsim_torch.mppi.critics import costmap_cells
    from husky_rover_mppi_isaacsim_torch.mppi.evaluation import run_thesis_protocol_experiment
    from husky_rover_mppi_isaacsim_torch.mppi.rollout import rollout_2d, rollout_25d
    from husky_rover_mppi_isaacsim_torch.core.xla_math import f32, pow_f32, sqrt_f32
    from husky_rover_mppi_isaacsim_torch.ops.edt import (
        distance_costmap,
        edt_exact_sq,
        edt_exact_sq_plain,
        minplus_envelope,
        normalize_minmax,
        row_distances_sq,
    )
    from husky_rover_mppi_isaacsim_torch.ops import gather_probe as gp
    from husky_rover_mppi_isaacsim_torch.ops.edt_cuda import edt_minplus_cuda
    from husky_rover_mppi_isaacsim_torch.ops.measure import (
        OpLog,
        cold_ms,
        cuda_ms,
        device_kernels,
        device_time,
        graph_ms,
        launch_calls,
    )
    from husky_rover_mppi_isaacsim_torch.ops import crater_block_cuda as block_module
    from husky_rover_mppi_isaacsim_torch.ops.crater_block_cuda import crater_block_cuda
    from husky_rover_mppi_isaacsim_torch.ops import rollout_2d_cuda as r2_module
    from husky_rover_mppi_isaacsim_torch.ops.rollout_2d_cuda import rollout_2d_cuda
    from husky_rover_mppi_isaacsim_torch.ops.rollout_cuda import rollout_25d_cuda
    from husky_rover_mppi_isaacsim_torch.ops.upsample_cuda import upsample_taps_cuda
    from husky_rover_mppi_isaacsim_torch.ops.jax_normal_cuda import (
        SPLIT_NEXT,
        SPLIT_SUB,
        jax_normal,
    )
    from husky_rover_mppi_isaacsim_torch.mppi import thesis_runs
    from husky_rover_mppi_isaacsim_torch.shell import (
        SimulationManager,
        SimulationManagerConf,
        Topics,
    )
    from husky_rover_mppi_isaacsim_torch.shell.sim_manager import tick as sim_tick
    from husky_rover_mppi_isaacsim_torch.terrain import (
        STANDALONE_CRATER_BUMPS,
        as_costmap,
        costmap_750,
        crater_surface,
        generate_obstacles,
        rasterize_obstacles,
        thesis_statistics_terrain,
    )
    from husky_rover_mppi_isaacsim_torch.env import largescale_loop as tls
    from husky_rover_mppi_isaacsim_torch.terrain import craters as tcr
    from husky_rover_mppi_isaacsim_torch.terrain.orchestrator import LargeScaleTerrainManager
    from husky_rover_mppi_isaacsim_torch.terrain.point_process import BoundingBox, hardcore_poisson
    from husky_rover_mppi_isaacsim_torch.terrain.smallscale import MoonyardConf, MoonyardGenerator
    from shard_ranks import run_ranks
    import bench_torch
    import graft_entry_torch
    from husky_rover_mppi_isaacsim_torch.core import jax_random as jr
    from husky_rover_mppi_isaacsim_torch.ops import rollout_cuda as rollout_cuda_module
    from husky_rover_mppi_isaacsim_torch.terrain.smallscale import (
        BaseTerrainGeneratorConf,
        draw_base_noise,
    )

    cuda, cpu = torch.device("cuda"), torch.device("cpu")

    def xla_math_probes(seed):
        """XLA_MATH_PROBES float32 probes: random bit patterns (every
        exponent, subnormals, infinities and NaNs among them), a dense range,
        magnitudes to 1e30 (sin and cos reduce them in integers), and the
        special values with their neighbours."""
        rng = np.random.default_rng(seed)
        n = XLA_MATH_PROBES // 4
        special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45, 1e-40, -3e-39,
                            1.17549435e-38, 1.0, -1.0, 0.5, 2.0, np.pi / 4, 120.0, -120.0, 88.8,
                            -87.8, 1e30, -1e30, 3.4e38], np.float32)
        near = np.nextafter(np.repeat(special[np.isfinite(special)], 256),
                            np.float32(np.inf)).astype(np.float32)
        parts = [rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32).view(np.float32),
                 rng.uniform(-130.0, 130.0, n).astype(np.float32),
                 (rng.choice([-1.0, 1.0], n) * 10.0 ** rng.uniform(-40, 30, n)).astype(np.float32),
                 special, near]
        rest = XLA_MATH_PROBES - sum(p.size for p in parts)
        parts.append(rng.uniform(-4.0, 4.0, rest).astype(np.float32))
        return torch.from_numpy(np.concatenate(parts))

    def xla_math_phase():
        """Each device function of the crater block kernel (its check entry,
        crater_block_cuda.xla_math) against the plain function of
        core/xla_math.py on the same probes on the card, and the card's
        plain values against the CPU's, computed in this process: both
        torch.equal on the float32 bit patterns (a NaN result is the one
        canonical NaN, so the bits compare as they are)."""
        from husky_rover_mppi_isaacsim_torch.core import xla_math as xm

        plain = {"atan2": xm.atan2_f32, "exp": xm.exp_f32, "cos": xm.cos_f32,
                 "sin": xm.sin_f32, "atan": xm.atan_f32}
        rows, ok = {}, True
        t_all = time.perf_counter()
        for seed, name in enumerate(crater_block_cuda.XLA_MATH_OPS):
            a = xla_math_probes(seed)
            b = xla_math_probes(seed + 100)[torch.randperm(a.numel(),
                                                           generator=torch.Generator().manual_seed(seed))]
            t0 = time.perf_counter()
            dev_equal, card_cpu_equal, nan = True, True, 0
            for lo in range(0, a.numel(), XLA_MATH_CHUNK):
                ac, bc = a[lo:lo + XLA_MATH_CHUNK], b[lo:lo + XLA_MATH_CHUNK]
                args_cpu = (ac, bc) if name == "atan2" else (ac,)
                args_card = tuple(t.to(cuda) for t in args_cpu)
                kernel = crater_block_cuda.xla_math(name, *args_card)
                card = plain[name](*args_card)
                host = plain[name](*args_cpu)
                dev_equal &= torch.equal(kernel.view(torch.int32), card.view(torch.int32))
                card_cpu_equal &= torch.equal(card.cpu().view(torch.int32), host.view(torch.int32))
                nan += int(torch.isnan(host).sum())
            rows[name] = {"probes": a.numel(), "kernel_equals_plain_card": dev_equal,
                          "card_equals_cpu": card_cpu_equal, "nan_results": nan,
                          "seconds": round(time.perf_counter() - t0, 3)}
            ok = ok and dev_equal and card_cpu_equal
        phase("xla_math", functions=rows, seconds=round(time.perf_counter() - t_all, 3), ok=ok)
        if not ok:
            raise RuntimeError("a device function of the crater block kernel differs from its "
                               "plain version, or the plain version on the card from the CPU's")

    # 1. the card, and full-float32 matmuls
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    max_sm_hz = 1e6 * float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits", "-i", "0"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    use_full_fp32_matmul()
    phase("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda,
          matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
          cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
          float32_matmul_precision=torch.get_float32_matmul_precision())

    # 2. build K1, K2, K3, the crater block kernel, the planar rollout
    #    kernel, the jax_normal kernel and the block upsample kernel from
    #    the sources, one nvcc each, and the host runtime
    #    (csrc/husky_native.cpp) with g++, all started together
    t0 = time.perf_counter()
    wrappers = (rollout_25d_cuda, edt_minplus_cuda, gp.gather_probe_cuda, crater_block_cuda,
                rollout_2d_cuda, jax_normal, upsample_taps_cuda)
    with ThreadPoolExecutor(len(wrappers) + 1) as pool:
        host_build = pool.submit(native.available)
        builds = list(pool.map(lambda w: w.load(), wrappers))
        native_ok = host_build.result()
    seconds = round(time.perf_counter() - t0, 3)
    for name, built in zip(("rollout25d_f32", "edt_minplus_f32", "gather_probe_f32",
                            "crater_block_f32", "rollout2d_f32", "jax_normal_f32",
                            "upsample_block_f32"), builds):
        phase("build", kernel=name, seconds=seconds, nvcc_seconds=round(built.seconds, 3),
              library=built.path.name, ptxas=ptxas_lines(built))
    phase("native_build", source="husky_rover_mppi_isaacsim_torch/csrc/husky_native.cpp",
          seconds=seconds, gxx_seconds=round(native.build_seconds, 3),
          library=native.library_path.name if native_ok else None, ok=native_ok)
    if not native_ok:
        raise RuntimeError(f"the native host runtime did not build:\n{native.build_error()}")

    # 2b. the crater block kernel's device functions (csrc/xla_math.cuh:
    #     XLA's exp, glibc's atan2f / atanf, sinf and cosf) against their
    #     plain versions (core/xla_math.py) on the card, and the card's
    #     values against the CPU's, on XLA_MATH_PROBES probes each
    xla_math_phase()

    # 3. K1 against its plain version on the card, every channel bit for bit:
    #    the flagship DEM and shapes, the K=1 optimal rollout, a ragged shape
    #    (K=33, H=37: velocity slices not 16-byte aligned) and a start off the
    #    DEM (wrap-then-clamp reads). Timed back to back (host issue time
    #    included when it is longer) and as a CUDA-graph replay (device time)
    hw = 75.0
    hf = HeightField.create(crater_surface(1500, hw, STANDALONE_CRATER_BUMPS, device=cuda), hw)
    heading = torch.tensor(HEADING, device=cuda)
    heading = heading / torch.linalg.norm(heading)
    gen = torch.Generator(device=cuda).manual_seed(0)

    def jax_normal_phase():
        idx = torch.full((), 7, dtype=torch.int64, device=cuda)
        block_shape, block_off, block_stride = jr.slice_counts((2, K, H), 1, K // 2, K)
        cases = {  # name: (key seed, shape, path, next path, offset, outer stride)
            "goal_seek_k1000_h100": (42, (2, K, H), SPLIT_SUB, SPLIT_NEXT, 0, None),
            "bench_k16384_h64": (50, (2, BENCH_K, BENCH_H), SPLIT_SUB, SPLIT_NEXT, 0, None),
            "closed_loop_2x4000x100": (0, (2, ROVERS * K, H), (("split", 2, 0),), None, 0, None),
            "slip_n4": (0, (ROVERS,), (("split", 2, 1), ("split", 2, 0)), None, 0, None),
            "slip_n4096": (3, (VEC_ROVERS,), (("split", 2, 1), ("split", 2, 1)), None, 0, None),
            "controller_fold_in": (42, (2, K, H), (("fold_in", 517),), None, 0, None),
            "chunk_device_index": (42, (2, K, H), (("fold_in", idx), ("split", 12, 5),
                                                      ("split", 2, 0)), None, 0, None),
            "rank_block_offset": (0, block_shape, (), None, block_off, block_stride),
        }
        rows, equal_all = {}, True
        for name, (seed, shape, path, nxt, off, stride) in cases.items():
            key_d = jr.key(seed, cuda)
            res = jax_normal(key_d, shape, path=path, next_path=nxt, offset=off,
                             outer_stride=stride)
            got, got_key = (res, None) if nxt is None else res
            sub = jr.derive(key_d, path)
            plain = jr.normal(sub, shape, torch.float32, off, stride)
            cpu_path = tuple((s[0], s[1].cpu()) if isinstance(s[1], torch.Tensor) else s
                             for s in path)
            on_cpu = jr.normal(jr.derive(jr.key(seed), cpu_path), shape, torch.float32, off,
                               stride)
            equal = torch.equal(got, plain) and torch.equal(got.cpu(), on_cpu)
            if nxt is not None:
                equal = equal and torch.equal(got_key, jr.derive(key_d, nxt))
            if name == "rank_block_offset":  # the block is the slice of the full draw
                full = jax_normal(key_d, (2, K, H))
                equal = equal and torch.equal(got.reshape(2, K // 2, H), full[:, K // 2:])
            rows[name] = {"shape": list(shape), "n": got.numel(), "equal": equal,
                          "finite": bool(torch.isfinite(got).all()),
                          "mean": got.mean().item(), "std": got.std().item()}
            equal_all = equal_all and equal and rows[name]["finite"]
        phase("jax_normal", cases=rows, ok=equal_all)
        if not equal_all:
            raise RuntimeError("the jax_normal kernel differs from its plain version")
        # the bound: the function's operations a value (JAX_NORMAL_OPS) by
        # pipe, each side weighed by the share of this draw's values that
        # take it; the bytes; the empty kernel of its grid
        timing = {}
        for name in ("goal_seek_k1000_h100", "bench_k16384_h64", "closed_loop_2x4000x100",
                     "slip_n4"):
            seed, shape, path, nxt, off, stride = cases[name]
            key_d = jr.key(seed, cuda)
            buf = torch.empty(shape, device=cuda)
            n = buf.numel()
            t_kernel = graph_ms(lambda: jax_normal(key_d, shape, path=path))
            t_floor = graph_ms(lambda: jax_normal.launch_floor(n))
            t_plain = cuda_ms(lambda: jr.normal(jr.derive(key_d, path), shape))
            t_randn = graph_ms(lambda: buf.normal_())
            u = jr.uniform(jr.derive(key_d, path), (n,), torch.float32,
                           f32(jr.NORMAL_LO_F32), 1.0)
            y = u * -u
            log_share = (y.abs() >= f32(jr.LOG1P_SMALL)).double().mean().item()
            ge5_share = (~(jr.log1p_f32(y) > -5.0)).double().mean().item()
            shares = {"common": 1.0, "rational": 1.0 - log_share, "log": log_share,
                      "w_lt5": 1.0 - ge5_share, "w_ge5": ge5_share}
            per_value = {p_: sum(shares[side] * ops.get(p_, 0)
                                 for side, ops in JAX_NORMAL_OPS.items())
                         for p_ in ("alu", "fma", "xu")}
            per_value["issue"] = sum(per_value.values())
            pipes = {p_: 1e3 * n * c / (SM_LANES[p_] * H100_SMS * max_sm_hz)
                     for p_, c in per_value.items()}
            bytes_ms = 1e3 * (4 * n + 16) / PEAK_BYTES_S
            ops_by = max(pipes, key=pipes.get)
            b_ms = max(bytes_ms, pipes[ops_by])
            b_by = "bytes" if bytes_ms >= pipes[ops_by] else "operations"
            timing[name] = {
                "ms": t_kernel, "plain_ms": t_plain, "randn_ms": t_randn, "n": n,
                "bound_ms": b_ms, "bound_by": b_by, "bytes_ms": bytes_ms,
                "operations_ms_by_pipe": pipes, "operations_set_by_pipe": ops_by,
                "operations_per_value": per_value, "value_shares": shares,
                "empty_kernel_ms": t_floor, "bound_with_floor_ms": max(b_ms, t_floor),
                "bound_with_floor_set_by": (b_by if b_ms >= t_floor
                                            else "launch floor (empty kernel)"),
                "share_of_bound_with_floor": max(b_ms, t_floor) / t_kernel}
        phase("jax_normal_times", per="launch (CUDA-graph replay, median of 7); plain eager",
              sm_clock_hz=max_sm_hz, lanes_per_sm_clock=SM_LANES, **timing)
        main = timing["goal_seek_k1000_h100"]
        return {k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "randn_ms",
                                     "empty_kernel_ms", "bound_with_floor_ms",
                                     "bound_with_floor_set_by", "operations_ms_by_pipe",
                                     "operations_per_value")} | {
            "max_abs_err": 0.0, "shapes": timing, "cases": rows}

    # 2b. jax_normal against its plain version (core/jax_random.py: normal
    #     of derive, torch ops on the card) and against the same plain
    #     version on the CPU (which the CPU tests hold against
    #     jax.random.normal), torch.equal at the shapes of the main paths;
    #     its next key against derive; a count offset's block against the
    #     slice of the full draw. Timed as a CUDA-graph replay beside its
    #     bound, its plain version and torch.randn (for scale: no torch call
    #     draws JAX's stream)
    jax_normal_row = jax_normal_phase()
    draws_by_path = {}  # jax_normal launches of each main path
    taps_by_path = {}  # the block upsample's launches per streamed path

    def dem_cells(hf, got, start):
        """DEM cells a rollout read: the start cell's and every step's quad
        corners, and the wheel tracks' cells."""
        rows, cols = hf.z.shape
        pts = [got.trajectory[..., :2].reshape(-1, 2), start.reshape(-1, 2)]
        flat = []
        for xy, quad in [(torch.cat(pts), True), (got.left_wheel[..., :2].reshape(-1, 2), False),
                         (got.right_wheel[..., :2].reshape(-1, 2), False)]:
            i, j = corner_cell(hf, xy[:, 0], xy[:, 1])
            for di, dj in ((0, 0), (1, 0), (0, 1), (1, 1)) if quad else ((0, 0),):
                flat.append(wrap_clamp(j + dj, rows) * cols + wrap_clamp(i + di, cols))
        return int(torch.unique(torch.cat(flat)).numel())

    def k1_bound(hf, got, start, n, k, h, wheels):
        channels = 12 if wheels else 6
        moved = (2 + channels) * n * k * h * 4 + 4 * dem_cells(hf, got, start) + 4 * n * 5
        return bound(moved, K1_FLOPS_PER_STEP * n * k * h, PEAK_FP32_S)

    def k2_bound(rows, cols):
        # each candidate needs one float32 add, and one three-way min
        # settles two candidates: 1.5 instructions per candidate
        return bound(2 * rows * cols * 4, 1.5 * rows * rows * cols, PEAK_FP32_INSTR_S)

    def _same(a, b):
        """Every tensor of two pytrees equal, in order (None leaves skipped)."""
        import torch.utils._pytree as pytree

        ta = [t for t in pytree.tree_leaves(a) if isinstance(t, torch.Tensor)]
        tb = [t for t in pytree.tree_leaves(b) if isinstance(t, torch.Tensor)]
        return len(ta) == len(tb) and all(torch.equal(x, y) for x, y in zip(ta, tb))

    def on_device(nt, dev):
        """A NamedTuple of tensors (and host fields) with its tensors on ``dev``."""
        return type(nt)(*(on_device(f, dev) if isinstance(f, tuple)
                          else f.to(dev) if isinstance(f, torch.Tensor) else f for f in nt))

    def k1_on_window(loop, case, pos, head):
        """K1 on the loop's live 7000^2 window against the plain rollout,
        every channel bit for bit, timed as on the 1500^2 DEM. Returns the
        K=1000 row."""
        whf, row = loop.hf, {}
        for k, wheels in ((K, True), (1, False)):
            lin = torch.rand((k, H), generator=gen, device=cuda) * 2.0
            ang = torch.rand((k, H), generator=gen, device=cuda) * 2.0 - 1.0
            args = (whf, pos, head, lin, ang, DT)
            got = rollout_25d_cuda(*args, wheels=wheels)
            want = rollout_25d(*args, wheels=wheels)
            torch.cuda.synchronize()
            equal = all(torch.equal(a, b) for a, b in zip(got, want))
            err = max((a - b).abs().max().item() for a, b in zip(got, want))
            out = torch.empty((12 if wheels else 6, H, k), device=cuda)

            def launch():
                rollout_25d_cuda.launch(whf, pos, head, lin, ang, out, DT)

            t_b2b, t_graph = cuda_ms(launch, inner=20), graph_ms(launch)
            t_plain = cuda_ms(lambda: rollout_25d(*args, wheels=wheels), reps=3)
            bound_ms, bound_by = k1_bound(whf, got, pos, 1, k, H, wheels)
            off = int(((got.trajectory[..., :2].abs() > loop.window_half).any(-1)).sum())
            phase("k1_on_window", case=case, dem=list(whf.z.shape), K=k, H=H, wheels=wheels,
                  position=pos.tolist(), bit_equal=equal, max_abs_err=err,
                  points_off_window=off, dem_cells_read=dem_cells(whf, got, pos),
                  k1_ms=t_b2b, k1_graph_ms=t_graph, plain_ms=t_plain, bound_ms=bound_ms,
                  bound_by=bound_by, ok=equal)
            if not equal:
                raise RuntimeError(f"K1 disagrees with its plain version on the 7000^2 "
                                   f"window: {case}, K={k}")
            if wheels:
                row = {"ms": t_graph, "plain_ms": t_plain, "bound_ms": bound_ms,
                       "bound_by": bound_by, "max_abs_err": err}
        return row

    @contextlib.contextmanager
    def plain_block():
        """The crater block's plain version (terrain/craters.py::
        crater_block_plain: every slot rendered as a (P, P) patch, the live
        ones added by the slice-add stamp) in place of its kernel, for the
        builds it is held against."""
        with mock.patch.object(block_module, "crater_block_cuda", tcr.crater_block_plain):
            yield

    def crater_work(field, row0, col0, res, patch_px, side, tables):
        """A tier's work from this run's placements: the (slot, pixel) pairs
        inside the live slots' squares (cut to their patch windows), the
        raster pixels those squares cover (their union), and the bytes the
        function must move: a read and a write of each covered pixel, each
        live slot's nine columns and each table row a live slot uses."""
        live = np.flatnonzero(field.mask.cpu().numpy())
        half = block_module.half_px(field.radius.cpu().numpy()[live], res)
        c = patch_px // 2
        lo, hi = np.maximum(c - half, 0), np.minimum(c + half, patch_px - 1)
        pairs = int(((hi - lo + 1) ** 2).sum())
        r0, c0 = row0.cpu().numpy()[live] + lo, col0.cpu().numpy()[live] + lo
        r1, c1 = row0.cpu().numpy()[live] + hi + 1, col0.cpu().numpy()[live] + hi + 1
        diff = np.zeros((side + 1, side + 1), np.int32)  # 2-D difference array
        for rr, cc, sign in ((r0, c0, 1), (r0, c1, -1), (r1, c0, -1), (r1, c1, 1)):
            np.add.at(diff, (rr, cc), sign)
        covered = int((diff.cumsum(0).cumsum(1) > 0).sum())
        rows = sum(np.unique(ids.cpu().numpy()[live]).size
                   for ids in (field.deformation_id, field.marks_id, field.profile_id))
        moved = 8 * covered + 36 * live.size + rows * tables.shape[-1] * 4
        return pairs, covered, moved

    def crater_block_phase(streamer, blocks=CRATER_BLOCKS):
        """The crater block kernel on the 7000^2 world's first ``blocks``
        blocks, for each radius tier: the kernel against its plain version
        (every slot rendered as a patch by _render_patches, the live ones
        added by stamp_patches) on the same field and placements,
        torch.equal; the kernel timed one launch at a time on a zeroed
        raster out of L2 (cold_ms), the plain version and its padded
        _render_patches alone (the render the kernel replaced) timed beside
        it; the bound from this
        run's placements (covered pixels, (slot, pixel) pairs). Then each
        block's craters through render_crater_block on the kernel and on
        the plain version, torch.equal, both timed on the host clock, with
        the kernel route's launches and the device memory it allocated above
        the raster (no (slots, P, P) patch tensor). Returns the kernel
        table's row."""
        conf = streamer.conf
        res, z_scale = conf.resolution, conf.z_scale
        tiers, blocks_out, equal, max_err = [], [], True, 0.0
        for bx, by in list(streamer.block_cache)[:blocks]:
            origin = np.asarray([bx * conf.block_size, by * conf.block_size], np.float32)
            blk = {"block": [bx, by], "kernel_ms": 0.0, "plain_ms": 0.0, "render_ms": 0.0,
                   "bound_ms": 0.0, "launches": 0, "pairs": 0, "covered_px": 0}
            fields = [(f, p) for f, p in streamer._block_fields(bx, by) if f.mask.any()]
            for field, patch_px in fields:
                n = int(field.mask.sum())
                side = conf.block_px + 2 * conf.pad_px + 2 * patch_px
                row0, col0 = tcr.crater_placement(field, origin, res, conf.block_px,
                                                  conf.pad_px, patch_px)
                bins = block_module.TileBins(*(torch.from_numpy(a).to(cuda) for a in
                                               block_module.tile_bins(
                                                   row0, col0, field.radius.numpy(),
                                                   field.mask.numpy(), res, patch_px, side)))
                sub = tcr.CraterField(*(f.to(cuda) for f in field))
                r0, c0 = torch.from_numpy(row0).to(cuda), torch.from_numpy(col0).to(cuda)
                args = (streamer.profiles, sub, r0, c0, res, z_scale, patch_px)
                got = crater_block_cuda(torch.zeros((side, side), device=cuda), *args,
                                        bins=bins)
                want = tcr.crater_block_plain(torch.zeros((side, side), device=cuda), *args)
                torch.cuda.synchronize()
                eq, err = torch.equal(got, want), (got - want).abs().max().item()
                buf = torch.zeros((side, side), device=cuda)
                k_ms = cold_ms(lambda: crater_block_cuda.launch(buf, *args, bins),
                               reset=buf.zero_)
                p_ms = cuda_ms(lambda: tcr.crater_block_plain(buf, *args), reps=3)
                r_ms = cuda_ms(lambda: tcr._render_patches(streamer.profiles, sub, res, z_scale,
                                                           patch_px), reps=3)
                pairs, covered, moved = crater_work(field, r0, c0, res, patch_px, side,
                                                    streamer.profiles.height)
                b_ms, b_by = bound(moved, CRATER_OPS_PER_PAIR * pairs, PEAK_FP32_INSTR_S)
                tiers.append({"block": [bx, by], "capacity": field.mask.shape[0],
                              "patch_px": patch_px, "live": n, "raster": [side, side],
                              "tiles": int(bins.tile_ids.numel()),
                              "tile_entries": int(bins.slots.numel()), "pairs": pairs,
                              "covered_px": covered, "bytes": moved, "bit_equal": eq,
                              "max_abs_err": err, "kernel_ms": k_ms, "plain_ms": p_ms,
                              "padded_render_ms": r_ms, "bound_ms": b_ms, "bound_by": b_by})
                equal = equal and eq
                max_err = max(max_err, err)
                for key, val in (("kernel_ms", k_ms), ("plain_ms", p_ms), ("render_ms", r_ms),
                                 ("bound_ms", b_ms), ("pairs", pairs), ("covered_px", covered)):
                    blk[key] += val
                if b_ms >= max((t["bound_ms"] for t in tiers[:-1] if t["block"] == [bx, by]),
                               default=0.0):
                    blk["bound_by"] = b_by  # the tier with the largest bound
            # the whole block's craters through render_crater_block, both ways
            times = {}
            for route in ("kernel", "plain"):
                torch.cuda.synchronize()
                crater_block_cuda.launches = 0
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
                t0 = time.perf_counter()
                out = torch.zeros((conf.block_px, conf.block_px), device=cuda)
                with plain_block() if route == "plain" else contextlib.nullcontext():
                    for field, patch_px in fields:
                        out = out + tcr.render_crater_block(
                            streamer.profiles, field, origin, res, z_scale, conf.block_px,
                            conf.pad_px, patch_px=patch_px)
                torch.cuda.synchronize()
                times[route] = (1e3 * (time.perf_counter() - t0), out,
                                torch.cuda.max_memory_allocated() - held,
                                crater_block_cuda.launches)
            blk["block_equal_plain"] = torch.equal(times["kernel"][1], times["plain"][1])
            blk["block_ms_kernel_route"], blk["block_ms_plain_route"] = (times["kernel"][0],
                                                                         times["plain"][0])
            blk["launches"] = times["kernel"][3]
            blk["allocated_bytes_kernel_route"] = times["kernel"][2]
            blk["allocated_bytes_plain_route"] = times["plain"][2]
            # the largest guarded raster a tier allocates, against the
            # smallest patch tensor a tier's render would
            raster = max(4 * (conf.block_px + 2 * conf.pad_px + 2 * p) ** 2 for _, p in fields)
            patches = min(4 * f.mask.shape[0] * p * p for f, p in fields)
            blk["no_patch_tensor"] = times["kernel"][2] < raster + patches
            equal = (equal and blk["block_equal_plain"] and blk["no_patch_tensor"]
                     and blk["launches"] == len(fields) and times["plain"][3] == 0)
            blocks_out.append(blk)
        ok = equal and bool(tiers)
        phase("crater_block", tiers=tiers, blocks=blocks_out, ops_per_pair=CRATER_OPS_PER_PAIR,
              ok=ok)
        if not ok:
            raise RuntimeError("the crater block kernel disagrees with its plain version, or a "
                               "block launched other than once per tier or allocated a patch "
                               "tensor")
        first = blocks_out[0]
        return {"ms": first["kernel_ms"], "plain_ms": first["plain_ms"],
                "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
                "library_ms": None, "max_abs_err": max_err,
                "padded_render_ms": first["render_ms"],
                "per": "block (its radius tiers' launches)", "block": first["block"],
                "launches_per_block": first["launches"]}

    def upsample_taps_phase(streamer):
        """The block upsample kernel at the main path's shape: a streamed
        block's 9 x 9 LR patch by the factor 200, its kept base (the crop
        [400:1400]^2 of the 1800^2 upsample) and the full upsample, each
        ``torch.equal`` to its plain version on the card (both passes of
        ``_tap_sum`` in full, then the slice: the design the kernel
        replaced, as a plain route) and to the CPU's, one launch a call.
        Timed one launch at a time out of L2 (cold_ms) and by graph replay,
        beside the empty kernel of its grid (the launch floor), the plain
        version and the one library call that computes the same crop,
        ``torch.linalg.multi_dot([Wr[r0:r0+R], lr, Wc[c0:c0+C].T])`` on the
        passes' dense matrices (float32, no TF32). The bound from the crop's
        bytes and FMAs. Returns the kernel table's row (the block)."""
        from husky_rover_mppi_isaacsim_torch.terrain import upsample as tup

        conf = streamer.conf
        factor, m, bpx = conf.upscale_factor, 2 * conf.upscale_factor, conf.block_px
        lr = streamer._lr_patch(0, 0).to(cuda, torch.float32)
        tables = [tup.axis_tables(n, factor, torch.float32, lr.device) for n in lr.shape]

        def dense(table, first, count):  # the pass as a matrix: W[h, idx[h, f]] += kw[h, f]
            kw, idx = (t[first:first + count].cpu().numpy() for t in table)
            w = np.zeros((count, int(table[1].max()) + 1), np.float32)
            np.add.at(w, (np.repeat(np.arange(count), 4), idx.ravel()), kw.ravel())
            return torch.from_numpy(w).to(cuda)

        crops = {"block": ((m, m), (bpx, bpx)),
                 "full": ((0, 0), (lr.shape[0] * factor, lr.shape[1] * factor))}
        rows_out, equal, err = {}, True, 0.0
        for name, (start, size) in crops.items():
            before = upsample_taps_cuda.launches
            got = tup.upsample_block(lr, factor, start, size)
            launches = upsample_taps_cuda.launches - before
            want = tup.upsample_block_plain(lr, *tables, start, size)
            on_cpu = tup.upsample_block(lr.cpu(), factor, start, size)
            torch.cuda.synchronize()
            eq = torch.equal(got, want) and torch.equal(got.cpu(), on_cpu) and launches == 1
            e = (got - want).abs().max().item()
            out = torch.empty(size, device=cuda)

            def launch(start=start, out=out):
                upsample_taps_cuda.launch(lr, *tables, start, out)

            k_ms, g_ms = cold_ms(launch), graph_ms(launch)
            floor_ms = graph_ms(lambda size=size: upsample_taps_cuda.launch_floor(size))
            p_ms = cuda_ms(lambda start=start, size=size: tup.upsample_block_plain(
                lr, *tables, start, size), reps=3)
            w_r = dense(tables[0], start[0], size[0])
            w_c = dense(tables[1], start[1], size[1]).T.contiguous()
            lib_ms = cuda_ms(lambda w_r=w_r, w_c=w_c: torch.linalg.multi_dot([w_r, lr, w_c]),
                             reps=7)
            # bytes: the crop written once, the patch and the crop's table
            # rows (weights and indices, 32 B a row or column) read once;
            # FMAs: 4 a row-pass value (the crop's rows by the LR columns its
            # columns read) and 4 an output
            span = (int(tables[1][1][start[1] + size[1] - 1, 3])
                    - int(tables[1][1][start[1], 0]) + 1)
            moved = 4 * size[0] * size[1] + 4 * lr.numel() + 32 * (size[0] + size[1])
            b_ms, b_by = bound(moved, 4 * size[0] * (span + size[1]), PEAK_FP32_INSTR_S)
            rows_out[name] = {
                "start": list(start), "size": list(size), "bit_equal": eq, "max_abs_err": e,
                "launches_per_call": launches, "ms": k_ms, "graph_ms": g_ms,
                "empty_kernel_ms": floor_ms, "plain_ms": p_ms, "library_ms": lib_ms,
                "bound_ms": b_ms, "bound_by": b_by, "bytes": moved,
                "bound_with_floor_ms": max(b_ms, floor_ms),
                "bound_with_floor_set_by": b_by if b_ms >= floor_ms else
                "launch floor (empty kernel)"}
            equal, err = equal and eq, max(err, e)
        phase("upsample_taps", factor=factor, lr=list(lr.shape), crops=rows_out,
              per="launch; ms one at a time out of L2, graph_ms by replay", ok=equal)
        if not equal:
            raise RuntimeError("the block upsample kernel disagrees with its plain version or "
                               "the CPU's, or a call launched it other than once")
        block = rows_out["block"]
        return {"ms": block["ms"], "plain_ms": block["plain_ms"], "bound_ms": block["bound_ms"],
                "bound_by": block["bound_by"], "library_ms": block["library_ms"],
                "library_note": "torch.linalg.multi_dot([Wr[r0:r0+R], lr, Wc[c0:c0+C].T]) "
                                "on the passes' dense float32 matrices, no TF32",
                "max_abs_err": err, "graph_ms": block["graph_ms"],
                "empty_kernel_ms": block["empty_kernel_ms"],
                "bound_with_floor_ms": block["bound_with_floor_ms"],
                "bound_with_floor_set_by": block["bound_with_floor_set_by"],
                "per": "block: (9, 9) by 200, the kept [400:1400]^2 base, one launch",
                "full_1800": rows_out["full"]}

    def largescale_timed():
        """The streamed-terrain slice at the LargeScaleConf defaults (7000^2
        window at 0.025 m/px, 875^2 costmap, K=1000 x H=100), the part that
        is timed: the world, K1 and K2 at these sizes, the traverses, the
        resume, the device rate and the deformed traverse. Returns the loop
        on the first world, K1's and K2's rows and each path's launch
        counts ``{path: (K1, K2)}``."""
        # 11. the world, built three times from the same seeds: on the
        #     crater block kernel, on its plain version (render + slice-add
        #     stamp), on the kernel
        conf = largescale_conf({})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        worlds, seconds, stamps, taps = [], [], [], []
        for route in ("kernel", "plain", "kernel"):
            crater_block_cuda.launches = upsample_taps_cuda.launches = 0
            t0 = time.perf_counter()
            with plain_block() if route == "plain" else contextlib.nullcontext():
                lstm = LargeScaleTerrainManager(conf.terrain, device=cuda)
                lstm.build()
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            stamps.append(crater_block_cuda.launches)
            taps.append(upsample_taps_cuda.launches)
            worlds.append(lstm)
        lstm, plain_world, again = worlds
        streamer = lstm.map_manager.streamer
        window = streamer.window
        equal = (torch.equal(window, again.map_manager.streamer.window)
                 and np.array_equal(lstm.extract_rocks_data(), again.extract_rocks_data()))
        plain_equal = torch.equal(window, plain_world.map_manager.streamer.window)
        craters = sum(len(r) for _, r in streamer.crater_blocks.values())
        phase("largescale_world", window=list(window.shape), window_bytes=window.nbytes,
              resolution_m=conf.terrain.hr_dem_resolution, blocks=len(streamer.block_cache),
              crater_blocks=len(streamer.crater_blocks), craters=craters,
              rocks=int(lstm.extract_rocks_data().shape[0]), routes=["kernel", "plain", "kernel"],
              seconds=seconds, seconds_kernel=[seconds[0], seconds[2]],
              seconds_plain_block=seconds[1], crater_block_launches=stamps,
              upsample_taps_launches=taps,
              build_phases_s=[w.build_phase_acc for w in worlds], second_build_bit_equal=equal,
              plain_block_build_bit_equal=plain_equal,
              finite=bool(torch.isfinite(window).all()), z_min=window.min().item(),
              z_max=window.max().item(),
              peak_memory_bytes_three_worlds=torch.cuda.max_memory_allocated())
        if (not equal or not plain_equal or tuple(window.shape) != (7000, 7000)
                or stamps[1] != 0 or not stamps[0] == stamps[2] > 0
                or not taps[0] == taps[1] == taps[2] == len(streamer.block_cache)):
            raise RuntimeError("two builds of the streamed world differ, the kernel's and the "
                               "plain version's differ, the crater block kernel did not run, "
                               "a block's upsample launched other than once, or the window "
                               "is not 7000 x 7000")
        # the first streamed window built on the CPU (the device route, as
        # on the card): torch.equal to the card's, rocks equal
        t0 = time.perf_counter()
        cpu_world = LargeScaleTerrainManager(
            largescale_conf({"terrain_streamer": {"native_pool": "never"}}).terrain, device=cpu)
        cpu_world.build()
        cpu_s = time.perf_counter() - t0
        window_cpu_equal = torch.equal(window.cpu(), cpu_world.map_manager.streamer.window)
        rocks_cpu_equal = np.array_equal(lstm.extract_rocks_data(), cpu_world.extract_rocks_data())
        phase("largescale_window_card_vs_cpu", window=list(window.shape), cpu_build_s=cpu_s,
              window_equal=window_cpu_equal, rocks_equal=rocks_cpu_equal,
              ok=window_cpu_equal and rocks_cpu_equal)
        if not (window_cpu_equal and rocks_cpu_equal):
            raise RuntimeError("the first streamed window built on the card differs from the "
                               "same window built on the CPU")
        del cpu_world
        stamp_row = crater_block_phase(streamer)
        taps_row = upsample_taps_phase(streamer)
        del worlds, plain_world
        graph_chunk(conf, again)
        del again

        #     the loop on that world; K1 on the live window at the rover's
        #     first pose
        loop0 = loop = LargeScaleClosedLoop(conf, lstm=lstm, device=cuda)
        state0 = loop._initial_state()
        k1_row = k1_on_window(loop, "first_pose", state0.rovers.position[0].clone(),
                              state0.rovers.heading[0].clone())

        #     K2 at the costmap's 875^2, on the occupancy of the streamed rocks
        rocks = lstm.extract_rocks_data()
        raster = rasterize_obstacles(rocks, origin=loop.frame.origin(),
                                     half_width=loop.window_half, size=conf.costmap_size,
                                     robot_radius=conf.costmap_robot_radius)
        occ = torch.from_numpy(raster == 0).to(cuda)
        got, want = edt_exact_sq(occ), edt_exact_sq_plain(occ)
        equal, err = torch.equal(got, want), (got - want).abs().max().item()
        g2 = row_distances_sq(occ)
        out = torch.empty_like(g2)

        def launch():
            edt_minplus_cuda.launch(g2, out)

        t_k2, t_k2_graph = cuda_ms(launch), graph_ms(launch)
        t_plain = cuda_ms(lambda: minplus_envelope(g2))
        bound_ms, bound_by = k2_bound(*g2.shape)
        cost875_equal = torch.equal(distance_costmap(occ).cpu(), distance_costmap(occ.cpu()))
        phase("k2_875", shape=list(occ.shape), rocks=int(rocks.shape[0]),
              occupied_cells=int(occ.sum()), bit_equal=equal, max_abs_err=err, k2_ms=t_k2,
              k2_graph_ms=t_k2_graph, plain_ms=t_plain, bound_ms=bound_ms, bound_by=bound_by,
              costmap_card_equals_cpu=cost875_equal)
        if not equal or tuple(occ.shape) != (875, 875) or not cost875_equal:
            raise RuntimeError("K2 disagrees with its plain version at 875 x 875, or the "
                               "875 x 875 costmap on the card differs from the CPU's")
        k2_row = {"ms": t_k2_graph, "plain_ms": t_plain, "bound_ms": bound_ms,
                  "bound_by": bound_by, "max_abs_err": err}

        #     one chunk's time from the start state (host clock around 12
        #     closed-loop steps, 24 K1 launches, ended by a synchronize)
        goal_ctrl = loop._goal_ctrl()
        chunk_key = jr.key(7, cuda)
        chunk_ms = cuda_ms(lambda: loop.chunk(state0, goal_ctrl, chunk_key, 0), reps=5)
        phase("largescale_chunk_ms", steps=conf.terrain_check_every, K=K, H=H, chunk_ms=chunk_ms,
              ms_per_sim_step=chunk_ms / conf.terrain_check_every)

        #     the traverses (0, 0) -> (65, 65) through the CLI's entry, in
        #     turns in this process (sync, pipelined, sync), each with the
        #     kernels' counts set to 0 just before it and read just after
        sync_s1 = run_traverse("largescale_prestage_verify", {}, dataclasses.replace(
            conf, pipeline_depth=0, verify_prestage=True, checkpoint_path=str(CKPT),
            checkpoint_every_steps=CKPT_EVERY))
        pipe = run_traverse("largescale_pipelined", {})
        sync_s0 = run_traverse("largescale", {}, dataclasses.replace(
            conf, pipeline_depth=0, prestage_shifts=False, max_steps=SYNC_STEPS))
        counts = {name: (t["k1"], t["k2"]) for name, t in
                  (("largescale_prestage_verify", sync_s1), ("largescale_pipelined", pipe),
                   ("largescale", sync_s0))}
        largescale_resume(dataclasses.replace(conf, pipeline_depth=0, verify_prestage=True),
                          sync_s1, counts)
        pipe_stamp, sync_s0_stamp = pipe["stamp"], sync_s0["stamp"]
        rate = pipe["loop"].measure_device_rate(chunks=20)
        res = pipe["run"].result
        phase("largescale_device_rate", chunks=20, steps_per_chunk=conf.terrain_check_every,
              device_sim_steps_per_s=rate, wall_sim_steps_per_s=res.steps / res.wall_s,
              steady_sim_steps_per_s=res.steady_steps / max(res.steady_wall_s, 1e-9),
              sync_prestaged_sim_steps_per_s=sync_s1["steps_per_s"],
              sync_plain_sim_steps_per_s=sync_s0["steps_per_s"])
        del sync_s0
        largescale_deform(conf, counts)

        #     the pipelined traverse again with JAX's pacing: pipeline_depth
        #     chunks in flight and no wait on the terrain worker (the port's
        #     dispatch bound off), for the bound's removal criteria; then the
        #     bounded and the unbounded traverse at bench_torch.py's 48-step
        #     chunks (the bound in sim steps: 6 chunks there, 8 at 12 steps)
        def unbounded_run(name, conf_=None):
            with mock.patch.object(tls._TerrainWorker, "wait_for", lambda self, chunk: False):
                return run_traverse(name, {}, conf_)

        def removal_criteria(bounded, unbounded):
            b, u = bounded["run"].result, unbounded["run"].result
            crit_ = {"reached": u.reached, "block_shifts": [b.block_shifts, u.block_shifts],
                     "prestage_hits": [b.prestage_hits, u.prestage_hits],
                     "costmap_rebuilds_equal_block_shifts": u.costmap_rebuilds == u.block_shifts}
            crit_["met"] = (crit_["reached"] and crit_["costmap_rebuilds_equal_block_shifts"]
                            and u.block_shifts == b.block_shifts
                            and u.prestage_hits >= b.prestage_hits)
            loops = (bounded["loop"], unbounded["loop"])
            return {"removal_criteria": crit_,
                    "worker_wait_s": [lp.chunk_phase_acc["worker_wait_s"] for lp in loops],
                    "worker_blocking_waits": [lp.worker_blocking_waits for lp in loops],
                    "steps": [b.steps, u.steps], "wall_s": [b.wall_s, u.wall_s]}

        unbounded = unbounded_run("largescale_pipelined_unbounded")
        at_12 = removal_criteria(pipe, unbounded)
        counts["largescale_pipelined_unbounded"] = (unbounded["k1"], unbounded["k2"])
        unbounded_stamp = unbounded["stamp"]
        del unbounded
        conf_48 = dataclasses.replace(conf, terrain_check_every=CHUNK_48)
        bounded_48 = run_traverse(f"largescale_pipelined_{CHUNK_48}", {}, conf_48)
        unbounded_48 = unbounded_run(f"largescale_pipelined_unbounded_{CHUNK_48}", conf_48)
        at_48 = removal_criteria(bounded_48, unbounded_48)
        for name_, run_ in ((f"largescale_pipelined_{CHUNK_48}", bounded_48),
                            (f"largescale_pipelined_unbounded_{CHUNK_48}", unbounded_48)):
            counts[name_] = (run_["k1"], run_["k2"])
        phase("dispatch_bound", worker_slack_steps=tls.WORKER_SLACK_STEPS,
              bound_chunks={str(n_): tls.dispatch_bound_chunks(conf.pipeline_depth, n_)
                            for n_ in (conf.terrain_check_every, CHUNK_48)},
              bounded=["largescale_pipelined", f"largescale_pipelined_{CHUNK_48}"],
              unbounded=["largescale_pipelined_unbounded",
                         f"largescale_pipelined_unbounded_{CHUNK_48}"],
              chunk_steps={str(conf.terrain_check_every): at_12, str(CHUNK_48): at_48}, ok=True)
        del pipe, bounded_48, unbounded_48

        #     the tile pool route: the window built on the pool and on the
        #     card, then a synchronous traverse with the CLI's streamer
        #     override terrain_streamer.native_pool=always
        native_pool_builds(conf)
        pool_conf = dataclasses.replace(
            largescale_conf({"terrain_streamer": {"native_pool": "always"}}),
            pipeline_depth=0, max_steps=POOL_STEPS)
        pooled = run_traverse("largescale_native_pool", {}, pool_conf)
        counts["largescale_native_pool"] = (pooled["k1"], pooled["k2"])
        taps_by_path["world_build"] = taps[0]
        stamp_counts = {"world_build": stamps[0], "largescale_prestage_verify": sync_s1["stamp"],
                        "largescale_pipelined": pipe_stamp, "largescale": sync_s0_stamp,
                        "largescale_pipelined_unbounded": unbounded_stamp,
                        "largescale_native_pool": pooled["stamp"]}
        del pooled
        return loop0, k1_row, k2_row, counts, stamp_row, stamp_counts, taps_row

    def graph_chunk(conf, lstm):
        """The streamed chunk at the LargeScaleConf defaults (the 7000^2
        window, K=1000 x H=100, 12 steps) on the second world: GRAPH_CHUNKS
        chunks from the start, each run eagerly (run_chunk), as the loop's
        graph replay (window and costmap read in place) and as a graph that
        copies every argument into its own buffers (the route before this
        slice), from the same state and key, in turns; after
        GRAPH_CHUNKS // 2 chunks the cascade seats the next window, costmap
        and frame origin (a (25, 25) m block shift), so the later replays
        read what the seat wrote into the leaves, not what they captured.
        State and pose torch.equal after every chunk, all three ways."""
        loop = LargeScaleClosedLoop(conf, lstm=lstm, device=cuda)
        graph, copying = loop.chunk_fn, Graphed(run_chunk)
        state, goal_ctrl = loop._initial_state(), loop._goal_ctrl()
        key = jr.key(21, cuda)
        routes = (("eager", run_chunk), ("graph", graph), ("graph_copying", copying))
        times = {name: [] for name, _ in routes}
        equal, shift, origins = True, None, []
        for c in range(GRAPH_CHUNKS):
            if c == GRAPH_CHUNKS // 2:  # one seat: window, costmap, origin, goal
                loop.lstm.update_visual_mesh((26.0, 27.0))
                state, goal_ctrl, shift = loop._on_block_shift(state, goal_ctrl)
            outs = {}
            for name, fn in routes:
                loop.chunk_fn = fn
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                outs[name] = loop.chunk(state, goal_ctrl, key, c)
                torch.cuda.synchronize()
                times[name].append(1e3 * (time.perf_counter() - t0))
            equal = (equal and _same(outs["eager"], outs["graph"])
                     and _same(outs["eager"], outs["graph_copying"]))
            origins.append(loop.origin().tolist())
            state = tenv.clone_state(outs["graph"][0])
        loop.chunk_fn = graph
        pose = outs["graph"][1].tolist()
        streamer = loop.lstm.map_manager.streamer

        def buffer_bytes(g):
            return sum(b.nbytes for b in g._static_in if b is not None)

        # the first graph call is the eager warm-up, the second captures
        ok = (equal and shift == (25.0, 25.0) and graph.replays == GRAPH_CHUNKS - 1
              and copying.replays == GRAPH_CHUNKS - 1 and all(np.isfinite(pose))
              and streamer.window is loop.hf.z is graph._in_place[0]
              and buffer_bytes(copying) - buffer_bytes(graph) >= streamer.window.nbytes)
        phase("graph_chunk", window=list(loop.hf.z.shape), K=K, H=H,
              steps=conf.terrain_check_every, chunks=GRAPH_CHUNKS, seat_after=GRAPH_CHUNKS // 2,
              shift_m=list(shift) if shift else None, origins=[origins[0], origins[-1]],
              graph_equals_eager=equal,
              ms_per_chunk_eager=float(np.median(times["eager"])),
              ms_per_chunk_graph=float(np.median(times["graph"][2:])),
              ms_per_chunk_graph_copying=float(np.median(times["graph_copying"][2:])),
              ms_per_chunk_graph_all=times["graph"],
              ms_per_chunk_graph_copying_all=times["graph_copying"],
              graph_input_buffer_bytes=buffer_bytes(graph),
              graph_copying_input_buffer_bytes=buffer_bytes(copying),
              window_is_the_graph_leaf=streamer.window is graph._in_place[0],
              capture_ms=graph.capture_ms, capture_ms_copying=copying.capture_ms,
              replays=graph.replays, final_world_pose=pose, ok=ok)
        if not ok:
            raise RuntimeError("the graphed streamed chunk differs from the eager one, or its "
                               "window is copied")

    def native_pool_builds(conf):
        """The LargeScaleConf window (7 x 7 blocks of 25 m at 0.025 m/px,
        7000^2, upscale factor 200) built with native_pool="always" on the
        card (8 pool workers; its update under set_sync_debug_mode("error"))
        and with "never" on the card: the two agree within ROUTE_ATOL. The
        pool's bases (craters off) on the card equal the CPU's bit for bit
        (the same C++ on the host; a CPU crater stamp of 49 blocks would
        take minutes). K1 at K=1000 x H=100 on the pool-built window is
        bit-equal to its plain version."""
        from husky_rover_mppi_isaacsim_torch.terrain.map_manager import MapManager
        from husky_rover_mppi_isaacsim_torch.terrain.orchestrator import LargeScaleConf

        def streamer(mode, dev, craters=True):
            terrain = LargeScaleConf(hr_dem_generate_craters=craters)
            terrain.streamer_conf.native_pool = mode
            return MapManager(terrain.map_conf, device=dev).streamer

        def build(s, no_sync=False):
            if s.device.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            if no_sync:
                torch.cuda.set_sync_debug_mode("error")  # a host sync raises
            try:
                s.update(conf.start)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            if s.device.type == "cuda":
                torch.cuda.synchronize()
            return time.perf_counter() - t0

        pooled, devrt = streamer("always", cuda), streamer("never", cuda)
        pool_s = build(pooled, no_sync=True)
        never_s = build(devrt)
        diff = (pooled.window - devrt.window).abs().max().item()
        del devrt
        bases = {dev.type: streamer("always", dev, craters=False) for dev in (cuda, cpu)}
        base_s = {k: build(b) for k, b in bases.items()}
        bases_equal = torch.equal(bases["cuda"].window.cpu(), bases["cpu"].window)
        pool = pooled.tile_pool()
        jobs, collect_s = pool.jobs, pool.collect_s
        for b in bases.values():
            b.close()
        del bases
        #   a shift (+x) on the pool route, also without a host sync
        t0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            shifted = pooled.update((conf.start[0] + pooled.conf.block_size, conf.start[1]))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        build_shift_s = time.perf_counter() - t0
        whf = HeightField.create(pooled.window, pooled.conf.window_size / 2)
        p = torch.zeros(2, device=cuda)
        lin = torch.rand((K, H), generator=gen, device=cuda) * 2.0
        ang = torch.rand((K, H), generator=gen, device=cuda) * 2.0 - 1.0
        got, want = rollout_25d_cuda(whf, p, heading, lin, ang, DT), rollout_25d(
            whf, p, heading, lin, ang, DT)
        k1_equal = all(torch.equal(a, b) for a, b in zip(got, want))
        window = list(pooled.window.shape)
        ok = (diff <= ROUTE_ATOL and bases_equal and k1_equal and shifted
              and window == [7000, 7000] and pool.jobs > jobs)
        phase("native_pool", window=window, blocks=pooled.conf.blocks_per_side ** 2,
              upscale_factor=pooled.conf.upscale_factor, workers=pooled.conf.native_pool_workers,
              build_s_always_card=pool_s, build_s_never_card=never_s,
              build_s_bases_always=base_s,
              shift_s_always_card=build_shift_s, pool_jobs_first_window=jobs,
              pool_collect_all_s_first_window=collect_s, pool_jobs_after_shift=pool.jobs,
              update_without_host_sync=True, bases_card_equal_cpu=bases_equal,
              max_abs_diff_always_vs_never_m=diff, atol=ROUTE_ATOL,
              k1_on_pool_window_bit_equal=k1_equal, K=K, H=H, ok=ok)
        pooled.close()
        if not ok:
            raise RuntimeError("the tile pool route's window is wrong, or K1 on it disagrees "
                               "with its plain version")

    def path_on_cost(loop, res):
        """Path points on a cost above 0.99 of the costmap that was live
        when the rover drove there (in that costmap's frame), and the
        largest such cost."""
        path = torch.tensor(res.path_world, dtype=torch.float32, device=cuda)
        firsts = [entry[0] for entry in loop.costmap_log] + [len(path)]
        on_cost, max_cost = 0, 0.0
        for (first, cm, frame, _), stop in zip(loop.costmap_log, firsts[1:]):
            if stop <= first:
                continue
            cx, cy = frames.world_to_controller(frame, path[first:stop, 0], path[first:stop, 1])
            ix, iy = costmap_cells(torch.stack([cx, cy], dim=-1), cm)
            cost = grid_lookup(cm.cost, ix, iy)
            on_cost += int((cost > 0.99).sum())
            max_cost = max(max_cost, cost.max().item())
        return on_cost, max_cost

    def seated_costmaps_equal(loop):
        """How many costmaps the loop seated, and whether each is
        ``torch.equal`` to the synchronous build for its center block and
        rocks (one K2 launch each, outside the traverse's count)."""
        equal = [torch.equal(cm.cost, loop.costmap_for((fr.block_x, fr.block_y), rp).cost)
                 for _, cm, fr, rp in loop.costmap_log]
        return len(equal), all(equal)

    def run_traverse(name, tree, conf=None):
        """One traverse through ``cli.largescale_episode`` and its phase."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()  # by the earlier phases' objects
        rollout_25d_cuda.launches = edt_minplus_cuda.launches = 0
        gp.gather_probe_cuda.launches = crater_block_cuda.launches = jax_normal.launches = 0
        upsample_taps_cuda.launches = 0
        run = largescale_episode(tree, conf=conf)
        torch.cuda.synchronize()
        draws_by_path[name] = jax_normal.launches
        taps_by_path[name] = upsample_taps_cuda.launches
        k1, k2 = rollout_25d_cuda.launches, edt_minplus_cuda.launches
        stamp, taps = crater_block_cuda.launches, upsample_taps_cuda.launches
        peak = torch.cuda.max_memory_allocated() - held
        report, res, loop = largescale_report(run), run.result, run.loop
        on_cost, max_cost = path_on_cost(loop, res)
        seated, seated_equal = seated_costmaps_equal(loop)
        streamer = loop.lstm.map_manager.streamer
        pool = streamer.tile_pool()  # None on the card unless native_pool="always"
        # one block upsample launch per block the streamer built (none when
        # the pool's threads upsample on the host)
        taps_expected = 0 if pool is not None else streamer.blocks_built
        builds = dict(loop.costmap_builds)
        k2_expected = builds["first"] + builds["staged"] + builds["miss"] + builds["verify"]
        k1_expected = 2 * loop.dispatched_steps
        chunks = res.steps // loop.conf.terrain_check_every
        lat = [(log["hit"], 1e3 * t) for log, t in zip(loop.shift_phase_log,
                                                          res.shift_latencies_s)]
        fields = dict(
            K=K, H=H, window=list(loop.hf.z.shape), costmap=list(loop.costmap.cost.shape),
            dispatched_steps=loop.dispatched_steps, k1_launches=k1, k1_expected=k1_expected,
            k2_launches=k2, k2_expected=k2_expected, crater_block_launches=stamp,
            upsample_taps_launches=taps, upsample_taps_expected=taps_expected,
            blocks_built=streamer.blocks_built,
            worker_blocking_waits=loop.worker_blocking_waits, costmap_builds=builds,
            staged_windows_swapped=streamer.staged_shift_hits,
            staged_windows_verified=streamer.staged_shift_verified,
            seated_costmaps=seated, seated_costmaps_equal_rebuilds=seated_equal,
            path_points=len(res.path_world), path_points_on_cost_above_0_99=on_cost,
            max_path_cost=max_cost, ms_per_sim_step=1e3 * res.wall_s / max(res.steps, 1),
            ms_per_chunk=1e3 * res.wall_s / max(chunks, 1),
            steady_sim_steps_per_s=res.steady_steps / max(res.steady_wall_s, 1e-9),
            shift_latencies_ms=[t for _, t in lat],
            shift_latency_hit_ms=[t for hit, t in lat if hit],
            shift_latency_miss_ms=[t for hit, t in lat if not hit],
            shift_dispatch_gaps_ms=[1e3 * g for g in res.shift_dispatch_gaps_s],
            shift_phases_s=loop.shift_phase_log, chunk_phases_s=loop.chunk_phase_acc,
            worker_s=loop.worker_s, cascade_phases_s=loop.lstm.cascade_phase_acc,
            build_phases_s=loop.lstm.build_phase_acc, peak_memory_bytes=peak,
            memory_held_by_earlier_phases_bytes=held, peak_memory_bytes_absolute=peak + held,
            peak_memory_bytes_unstaged_first=UNSTAGED_TRAVERSE_PEAK_BYTES,
            native_pool=streamer.conf.native_pool, pool_jobs=pool.jobs if pool else 0,
            pool_collect_all_s=pool.collect_s if pool else 0.0,
            costmap_first_path_points=[entry[0] for entry in loop.costmap_log])
        ok = (k1 == k1_expected and k2 == k2_expected and seated_equal and stamp > 0
              and streamer.blocks_built > 0 and taps == taps_expected
              and res.costmap_rebuilds == res.block_shifts
              and streamer.staged_shift_verified == (streamer.staged_shift_hits
                                                     if loop.conf.verify_prestage else 0))
        if name.startswith("largescale_pipelined_unbounded"):
            pass  # an experiment: its reach, shifts, hits and path are reported, not required
        elif name.endswith(f"_{CHUNK_48}"):  # the bounded loop at 48-step chunks
            ok = ok and res.reached
        elif name == "largescale":  # without pre-staging, cut
            ok = ok and res.steps == SYNC_STEPS and res.block_shifts >= 1
        elif name == "largescale_native_pool":  # the tile pool route, cut
            ok = (ok and res.steps == POOL_STEPS and res.block_shifts >= 1 and pool is not None
                  and pool.jobs >= len(streamer.block_cache))
        else:
            ok = ok and res.reached and res.block_shifts >= 2 and res.prestage_hits >= 1
        if not name.startswith("largescale_pipelined_unbounded") and not name.endswith(
                f"_{CHUNK_48}"):
            ok = ok and on_cost == 0
        phase(name, **report, **fields, ok=ok)
        if not ok:
            raise RuntimeError(f"{name}: the traverse is wrong (reached, shifts, pre-stage "
                               "hits, seated costmaps, path cost or kernel counts)")
        if pool is not None:
            streamer.close()
        return {"run": run, "loop": loop, "k1": k1, "k2": k2, "stamp": stamp, "taps": taps,
                "steps_per_s": res.steps / res.wall_s}

    def largescale_resume(conf, full, counts):
        """Resume the prestage-verify traverse from its checkpoint (written
        after its first block shift) and hold the continuation to the
        uninterrupted run: path points and final state ``torch.equal``."""
        import os

        from husky_rover_mppi_isaacsim_torch.aux import checkpoint as ckpt

        path = ckpt._norm_path(CKPT)
        meta = ckpt.load_metadata(path)
        full_res, full_loop = full["run"].result, full["loop"]
        torch.cuda.synchronize()
        rollout_25d_cuda.launches = edt_minplus_cuda.launches = 0
        t0 = time.perf_counter()
        loop, info = LargeScaleClosedLoop.resume(conf, path, device=cuda)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        res = loop.run(_resume=info)
        torch.cuda.synchronize()
        counts["largescale_resume"] = (rollout_25d_cuda.launches, edt_minplus_cuda.launches)
        path_equal = np.array_equal(res.path_world, full_res.path_world)
        state_equal = all(torch.equal(a, b) for a, b in zip(
            (t for t in _leaves(loop.last_state)), (t for t in _leaves(full_loop.last_state))))
        window_equal = torch.equal(loop.lstm.map_manager.streamer.window,
                                   full_loop.lstm.map_manager.streamer.window)
        t0 = time.perf_counter()
        loop.save_checkpoint(BUILD / "smoke_traverse_again.ckpt", loop.last_state,
                             0, res.steps, res.path_world)
        save_s = time.perf_counter() - t0
        shifts_before = meta["prestage_hits"] + meta["prestage_misses"]
        ok = (path_equal and state_equal and window_equal and shifts_before >= 1
              and res.reached == full_res.reached and res.steps == full_res.steps
              and res.final_position == full_res.final_position)
        phase("largescale_resume", checkpoint_steps=meta["steps"],
              shifts_before_checkpoint=shifts_before, file_bytes=os.path.getsize(path),
              save_s=save_s, restore_s=restore_s, steps=res.steps, reached=res.reached,
              final_position=list(res.final_position), path_points=len(res.path_world),
              path_bit_equal=path_equal, final_state_bit_equal=state_equal,
              window_bit_equal=window_equal, k1_launches=counts["largescale_resume"][0],
              k2_launches=counts["largescale_resume"][1], ok=ok)
        if not ok:
            raise RuntimeError("the resumed traverse differs from the uninterrupted one")

    def largescale_deform(conf, counts):
        """A short deformed traverse at the reference window's resolution
        across the x = 25 m block border: the window is lower under the
        track and mostly unchanged, the controller reads the deformed
        window, K1 on it is bit-equal to the plain rollout, one stamp on the
        card agrees with the CPU's, two identical stamps are bit-equal, and
        the rolled pass counts equal a CPU roll."""
        from husky_rover_mppi_isaacsim_torch.env.largescale_loop import _roll_pass_counts

        dconf = dataclasses.replace(
            largescale_conf({"deformation": {"enable": True}}), start=DEFORM_START,
            goal=DEFORM_GOAL, max_steps=DEFORM_STEPS)
        torch.cuda.synchronize()
        rollout_25d_cuda.launches = edt_minplus_cuda.launches = 0
        loop = LargeScaleClosedLoop(dconf, device=cuda)
        streamer = loop.lstm.map_manager.streamer
        before, anchor0 = streamer.window.clone(), streamer.anchor
        res = loop.run()
        torch.cuda.synchronize()
        counts["largescale_deform"] = (rollout_25d_cuda.launches, edt_minplus_cuda.launches)
        bpx = streamer.conf.block_px
        moved = (streamer.anchor[0] - anchor0[0], streamer.anchor[1] - anchor0[1])
        # the window against the one before, over their overlap: the rover
        # crosses the x = 25 m border by design, and the y = 0 border too
        # where its path dips below y = 0 (it starts 0.5 m above it)
        new_sl, old_sl = [], []
        for d in moved:
            n_ = abs(d) * bpx
            new_sl.append(slice(0, -n_ if n_ else None) if d >= 0 else slice(n_, None))
            old_sl.append(slice(n_, None) if d >= 0 else slice(0, -n_))
        diff = (streamer.window[tuple(new_sl)] - before[tuple(old_sl)]
                if moved[0] == 1 and abs(moved[1]) <= 1 else None)
        lowered = diff is not None and diff.min().item() < -1e-4
        unchanged = diff is not None and (diff.abs() < 1e-9).double().mean().item()
        del before
        live = loop.hf.z is streamer.window
        state = loop.last_state
        k1_row = k1_on_window(loop, "deformed_window", state.rovers.position[0].clone(),
                              state.rovers.heading[0].clone())
        # one stamp on the card against the same stamp on the CPU, and two
        # identical stamps on the card
        eng = loop.deform_engine
        pos4, yaws, loads = loop.wheel_stamp_inputs(state)
        wox, woy = streamer.window_origin()
        stamps = []
        for _ in range(2):
            w, c = streamer.window.clone(), loop.pass_counts.clone()
            eng.deform_window(w, c, streamer._res, (wox, woy), pos4, yaws, loads)
            stamps.append((w, c))
        twice_equal = torch.equal(*(s[0] for s in stamps)) and torch.equal(*(s[1] for s in stamps))
        w_cpu, c_cpu = streamer.window.cpu(), loop.pass_counts.cpu()
        eng.deform_window(w_cpu, c_cpu, streamer.conf.resolution, (wox, woy), pos4.cpu(),
                          yaws.cpu(), loads.cpu())
        stamp_err = (stamps[0][0].cpu() - w_cpu).abs().max().item()
        counts_equal = torch.equal(stamps[0][1].cpu(), c_cpu)
        del stamps, w_cpu
        rolled = _roll_pass_counts(loop.pass_counts, bpx, -bpx)
        roll_equal = torch.equal(rolled.cpu(), _roll_pass_counts(loop.pass_counts.cpu(), bpx, -bpx))
        ok = (res.block_shifts >= 1 and diff is not None and lowered and unchanged > 0.9 and live
              and stamp_err <= 1e-6 and counts_equal and twice_equal and roll_equal
              and counts["largescale_deform"][0] == 2 * res.steps)
        phase("largescale_deform", start=list(DEFORM_START), goal=list(DEFORM_GOAL),
              steps=res.steps, reached=res.reached, block_shifts=res.block_shifts,
              anchor_moved=list(moved), window=list(streamer.window.shape),
              resolution_m=streamer.conf.resolution,
              footprint_points_per_wheel=int(eng.profile.shape[0]),
              window_min_change_m=diff.min().item() if diff is not None else None,
              unchanged_share=unchanged, passes=int(loop.pass_counts.sum()),
              hf_is_deformed_window=live, k1_deformed_bit_equal=True,
              k1_deformed_ms=k1_row["ms"], stamp_card_vs_cpu_max_abs_m=stamp_err,
              stamp_counts_equal=counts_equal, two_stamps_bit_equal=twice_equal,
              rolled_counts_equal_cpu=roll_equal, k1_launches=counts["largescale_deform"][0],
              k2_launches=counts["largescale_deform"][1], wall_s=res.wall_s, ok=ok)
        if not ok:
            raise RuntimeError("the deformed traverse or a deformation stamp is wrong")

    def _leaves(state):
        for f in state:
            if isinstance(f, tuple):
                yield from _leaves(f)
            elif isinstance(f, torch.Tensor):
                yield f


    def largescale_profiled(loop):
        """The streamed-terrain slice's phases that use torch.profiler or
        move the first world's window. Returns K1's row near the window's
        edge after a shift."""
        conf, lstm = loop.conf, loop.lstm
        streamer = lstm.map_manager.streamer
        state0 = loop._initial_state()
        # 13. one chunk (12 closed-loop steps, N=1, K=1000 x H=100) from the
        #     start: on the card (24 K1 launches on the window, no host sync)
        #     and on the CPU with the plain rollout, the same key (JAX's
        #     noise drawn by jax_normal on the card, by its plain version
        #     on the CPU: the same bits). Tolerance:
        #     2e-3 on the pose (m; unit heading) and 1e-2 on wheel speeds and
        #     yaw rate (m/s, rad/s): 12 steps of float32 feedback through
        #     the softmax weights, sin/cos/exp rounding differently on the
        #     two devices
        n_chunk = conf.terrain_check_every
        goal_ctrl = loop._goal_ctrl()
        key_d = jr.key(5, cuda)
        torch.cuda.synchronize()
        before = rollout_25d_cuda.launches
        torch.cuda.set_sync_debug_mode("error")  # a host sync inside the chunk raises
        try:
            got_state, got_pose = loop.chunk(state0, goal_ctrl, key_d, 0)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        chunk_k1 = rollout_25d_cuda.launches - before
        t0 = time.perf_counter()
        want_state, want_pose = run_chunk(conf, on_device(loop.hf, cpu),
                                          on_device(loop.costmap, cpu), loop.frame.origin(),
                                          on_device(state0, cpu), goal_ctrl.cpu(), jr.key(5),
                                          torch.zeros((), dtype=torch.int64))
        cpu_s = time.perf_counter() - t0
        diffs = {"pose": (got_pose.cpu() - want_pose).abs().tolist()}
        for f, a, b in zip(got_state.rovers._fields, got_state.rovers, want_state.rovers):
            diffs[f] = (a.cpu() - b).abs().max().item()
        kernels = device_kernels(lambda: loop.chunk(state0, goal_ctrl, key_d, 0))
        chunk_ms = cuda_ms(lambda: loop.chunk(state0, goal_ctrl, key_d, 0), reps=3)
        # the idle share is read under the profiler, whose tracing slows the
        # host: the card's busy time is the firmer number
        on_card = device_time(lambda: loop.chunk(state0, goal_ctrl, key_d, 0))
        ok = (max(diffs["pose"][:4]) <= 2e-3 and diffs["pose"][4] == 0.0
              and max(diffs[f] for f in ("position", "z", "heading")) <= 2e-3
              and max(diffs[f] for f in ("wheel_left", "wheel_right", "yaw_rate")) <= 1e-2
              and chunk_k1 == 2 * n_chunk)
        phase("largescale_chunk_card_vs_cpu", steps=n_chunk, K=K, H=H, k1_launches=chunk_k1,
              device_kernels=kernels, chunk_ms_after_profiling=chunk_ms,
              device_idle_share=1.0 - on_card["busy_ms"] / on_card["wall_ms_profiled"],
              device_time=on_card, cpu_chunk_s=cpu_s, max_abs_diff=diffs,
              world_pose=got_pose.tolist(), ok=ok)
        if not ok:
            raise RuntimeError("one chunk on the card disagrees with the CPU's, or did not "
                               "launch K1 twice per step")

        # 14. one block shift (+x and +y) by the cascade: world heights at
        #     fixed world points, read through the controller's heightfield
        #     in its frame, are the same numbers before and after; then K1
        #     at a pose within one horizon of the shifted window's edge
        pts = torch.tensor(np.random.default_rng(0).uniform(-30.0, 80.0, (4096, 2)),
                           dtype=torch.float32, device=cuda)

        def world_heights():
            cx, cy = frames.world_to_controller(loop.frame, pts[:, 0], pts[:, 1])
            return nearest_height(loop.hf, cx, cy)

        before = world_heights()
        t0 = time.perf_counter()
        updated, _ = lstm.update_visual_mesh((26.0, 27.0))
        torch.cuda.synchronize()
        cascade_s = time.perf_counter() - t0
        frame0 = loop.frame
        _, goal_after, shift = loop._on_block_shift(state0, goal_ctrl)
        after = world_heights()
        kept = torch.equal(before, after)
        rebased = torch.equal(goal_after, frames.rebase_on_shift(goal_ctrl, *shift))
        phase("largescale_reseat", updated=updated, shift_m=list(shift), frame_before=list(frame0),
              frame_after=list(loop.frame), anchor=list(streamer.anchor), points=len(pts),
              world_heights_bit_equal=kept, goal_rebased=rebased, cascade_s=cascade_s,
              cascade_phases_s=dict(lstm.cascade_phase_acc),
              shift_phases_s=loop.shift_phase_log[-1], window_is_live=loop.hf.z is streamer.window)
        if not (updated and kept and rebased and tuple(shift) == (25.0, 25.0)):
            raise RuntimeError("a block shift moved world heights or rebased the goal wrongly")
        edge = torch.tensor([loop.window_half - 6.0, -(loop.window_half - 3.5)], device=cuda)
        return k1_on_window(loop, "edge_after_shift", edge,
                            torch.tensor([1.0, -0.4, 0.0], device=cuda))

    def sdg_graph(rendering):
        """The frames of cfg/mode/sdg.yaml (the camera block on) through the
        eager labeler (rocks as drawn) and the graphed one (rocks padded to
        the conf's capacity, each pass one CUDA graph replay) in turns, on
        the same yards and draws: every modality torch.equal, ms per frame
        by pass both ways (the median from the third frame on: the graph's
        first frame is its warm-up, its second the capture), capture ms. Returns the
        graphed labeler and one frame's inputs, for the profiled counts."""
        tree = compose(SDG_ARGS + [f"rendering={rendering}"])
        sdg, settings = tree["sdg"], render_settings_from_cfg(tree)
        cam_cfg, rock_cfg = sdg["camera"], sdg["rocks"]
        base = MoonyardConf().base
        cap = rock_capacity(float(rock_cfg["density"]), base.x_size * base.y_size)
        labelers = {
            name: AutonomousLabeling(LabelingConf(num_images=SDG_FRAMES,
                                                  data_dir=str(BUILD / f"sdg_{name}")),
                                     settings, rock_capacity=c)
            for name, c in (("eager", None), ("graph", cap))}
        gen = MoonyardGenerator(MoonyardConf(), device=cuda)
        rng = np.random.default_rng(int(tree.get("seed", 42)))
        res = base.resolution
        per = {name: {"top_down": [], "camera": []} for name in labelers}
        equal, rocks = True, []
        for _ in range(SDG_FRAMES):
            dem = gen.randomize()
            yard = BoundingBox(0.0, base.x_size, 0.0, base.y_size)
            xy, r = hardcore_poisson(rng, yard, (float(rock_cfg["density"]),),
                                     ((float(rock_cfg["r_min"]), float(rock_cfg["r_max"])),))
            rocks.append(len(r))
            az, el = rng.uniform(0, 2 * np.pi), rng.uniform(np.deg2rad(10), np.deg2rad(60))
            sun = (float(np.cos(el) * np.cos(az)), float(np.cos(el) * np.sin(az)),
                   float(np.sin(el)))
            h, w = dem.shape
            px, py = rng.uniform(0.15, 0.85) * h * res, rng.uniform(0.15, 0.85) * w * res
            yaw = rng.uniform(0, 2 * np.pi)
            gz = float(dem[int(px / res), int(py / res)])
            frame = {}
            for name, lab in labelers.items():
                before = dict(lab.seconds)
                fid = lab.frame
                top = lab.record(dem, res, sun_direction=sun, rock_xy=xy, rock_radius=r)
                cam = lab.record_camera(
                    dem, res, (0.0, 0.0), (px, py), (float(np.cos(yaw)), float(np.sin(yaw))), gz,
                    intrinsics=CameraIntrinsics(width=int(cam_cfg["width"]),
                                                height=int(cam_cfg["height"])),
                    sun_direction=sun, rock_xy=xy, rock_radius=r,
                    mount_height=float(cam_cfg["mount_height"]),
                    pitch_deg=float(cam_cfg["pitch_deg"]), steps=int(cam_cfg["steps"]),
                    cast_shadows=bool(cam_cfg["cast_shadows"]), frame=fid)
                for k in ("top_down", "camera"):
                    per[name][k].append(1e3 * (lab.seconds[k] - before[k]))
                frame[name] = (top, cam)
            (te, ce), (tg, cg) = frame["eager"], frame["graph"]
            equal = (equal and te.keys() == tg.keys() and ce.keys() == cg.keys()
                     and all(np.array_equal(te[k], tg[k]) for k in te)
                     and all(torch.equal(ce[k], cg[k]) for k in ce))
        graphs = labelers["graph"]
        g_td, g_cam = graphs.top_down_fn, graphs.camera_fn
        ok = (equal and g_td.replays == g_cam.replays == SDG_FRAMES - 1 and max(rocks) <= cap)
        phase("sdg_graph", rendering=rendering, frames=SDG_FRAMES, dem=[500, 500],
              camera=[int(cam_cfg["width"]), int(cam_cfg["height"])], rock_capacity=cap,
              rocks_per_frame=rocks, every_modality_equal=equal,
              ms_per_frame_eager={k: float(np.median(v[2:])) for k, v in per["eager"].items()},
              ms_per_frame_graph={k: float(np.median(v[2:])) for k, v in per["graph"].items()},
              ms_by_frame=per, capture_ms={"top_down": g_td.capture_ms,
                                           "camera": g_cam.capture_ms},
              replays={"top_down": g_td.replays, "camera": g_cam.replays}, ok=ok)
        if not ok:
            raise RuntimeError(f"the graphed SDG frame ({rendering}) differs from the eager one")
        return labelers, (dem, res, sun, xy, r, (px, py), yaw, gz, cam_cfg)

    def cli_timed():
        """The CLI's paths through its composed cfg/ tree, timed: mode=sdg
        (10 frames, top-down and camera) under both rendering files, one
        capture held against the CPU's, then the moonyard worlds: K1 on the
        4000^2 yard DEM, the yard goal-seek and the lab's closed loop.
        Returns each path's launch counts, K1's yard row and the capture
        function."""
        def zero_counts():
            torch.cuda.synchronize()
            rollout_25d_cuda.launches = edt_minplus_cuda.launches = 0
            gp.gather_probe_cuda.launches = crater_block_cuda.launches = 0
            jax_normal.launches = 0

        def counts():
            return {"k1": rollout_25d_cuda.launches, "k2": edt_minplus_cuda.launches,
                    "k3": gp.gather_probe_cuda.launches, "stamp": crater_block_cuda.launches,
                    "draws": jax_normal.launches}

        sdg_shapes = {"rgb": (500, 500, 3), "depth": (500, 500), "semantic": (500, 500),
                      "cam_depth": (480, 640), "cam_rgb": (480, 640), "cam_semantic": (480, 640),
                      "cam_instance": (480, 640)}
        sdg_counts = {}
        for rendering in ("ray_tracing", "path_tracing"):
            tree = compose(SDG_ARGS + [f"rendering={rendering}"])
            zero_counts()
            t0 = time.perf_counter()
            res = run_sdg(tree)
            wall = time.perf_counter() - t0
            sdg_counts[rendering] = counts()
            out = Path(res["output_dir"])
            npy, pngs = sorted(out.glob("*.npy")), sorted(out.glob("*.png"))
            arrays = {f.name: np.load(f) for f in npy}
            shapes_ok = all(a.shape == sdg_shapes[n.rsplit("_", 1)[0]] for n, a in arrays.items())
            finite = all(np.isfinite(a).all() for a in arrays.values())
            rocks_seen = sum(int((a == 2).any()) for n, a in arrays.items()
                             if n.startswith("semantic"))
            ok = (len(npy) == 7 * SDG_FRAMES and shapes_ok and finite and res["device"] == "cuda"
                  and len(list(out.glob("camera_*.json"))) == SDG_FRAMES
                  and sdg_counts[rendering]["stamp"] == SDG_FRAMES)
            phase("sdg_frames", rendering=rendering, frames=SDG_FRAMES, dem=[500, 500],
                  camera=[640, 480], march_steps=128, cast_shadows=True, wall_s=wall,
                  ms_per_frame=1e3 * wall / SDG_FRAMES,
                  ms_per_frame_by_phase={k: 1e3 * v / SDG_FRAMES
                                         for k, v in res["seconds"].items()},
                  npy_files=len(npy), png_files=len(pngs), pngs_written=bool(pngs),
                  frames_with_rocks=rocks_seen, shapes_ok=shapes_ok, finite=finite,
                  kernel_launches=sdg_counts[rendering], device=res["device"], ok=ok)
            if not ok:
                raise RuntimeError(f"mode=sdg ({rendering}) wrote wrong or missing frames")
        sdg_graphed = {rendering: sdg_graph(rendering) for rendering in ("ray_tracing",
                                                                          "path_tracing")}

        # one capture on the card and on the CPU: the same DEM and draws, the
        # path_tracing effects, the camera with rocks and cast shadows
        sdg_settings = render_settings_from_cfg(compose(SDG_ARGS + ["rendering=path_tracing"]))
        sdg_dem = MoonyardGenerator(MoonyardConf(), device=cuda).randomize()
        sdg_res = MoonyardConf().base.resolution
        srng = np.random.default_rng(7)
        rock_xy, rock_r = hardcore_poisson(srng, BoundingBox(0.0, 10.0, 0.0, 10.0), (0.08,),
                                           ((0.08, 0.4),))
        sun = (-0.55, 0.4, 0.35)
        cam_xy, yaw = srng.uniform(1.5, 8.5, 2), srng.uniform(0, 2 * np.pi)

        def sdg_capture(device, name):
            lab = AutonomousLabeling(LabelingConf(num_images=1, data_dir=str(BUILD / name)),
                                     sdg_settings)
            dem = sdg_dem.to(device)
            top = lab.record(dem, sdg_res, sun_direction=sun, rock_xy=rock_xy, rock_radius=rock_r)
            gz = float(dem[int(cam_xy[0] / sdg_res), int(cam_xy[1] / sdg_res)])
            cam = lab.record_camera(dem, sdg_res, (0.0, 0.0), cam_xy, (np.cos(yaw), np.sin(yaw)),
                                    gz, intrinsics=CameraIntrinsics(640, 480), sun_direction=sun,
                                    rock_xy=rock_xy, rock_radius=rock_r, steps=128,
                                    cast_shadows=True, frame=0)
            return top, {k: v.cpu().numpy() for k, v in cam.items()}

        (top_c, cam_c), (top_h, cam_h) = sdg_capture(cuda, "sdg_card"), sdg_capture(cpu, "sdg_cpu")
        same_inst = cam_c["instance"] == cam_h["instance"]
        both = same_inst & np.isfinite(cam_c["depth"]) & np.isfinite(cam_h["depth"])
        terrain, rock = both & (cam_h["instance"] == 0), both & (cam_h["instance"] > 0)
        rel = np.zeros_like(cam_h["depth"])
        rel[both] = np.abs(cam_c["depth"][both] - cam_h["depth"][both]) / cam_h["depth"][both]
        rgb_d = np.abs(cam_c["rgb"] - cam_h["rgb"])
        cmp = {
            "top_rgb_max_abs": float(np.abs(top_c["rgb"] - top_h["rgb"]).max()),
            "top_depth_equal": bool(np.array_equal(top_c["depth"], top_h["depth"])),
            "top_semantic_equal": bool(np.array_equal(top_c["semantic"], top_h["semantic"])),
            "cam_hit_share": float((cam_c["hit"] == cam_h["hit"]).mean()),
            "cam_instance_share": float(same_inst.mean()),
            "cam_semantic_share": float((cam_c["semantic"] == cam_h["semantic"]).mean()),
            "cam_terrain_depth_max_rel": float(rel[terrain].max(initial=0.0)),
            "cam_rock_depth_max_rel": float(rel[rock].max(initial=0.0)),
            "cam_rock_depth_share_within_1e-5": float((rel[rock] <= DEPTH_RTOL).mean()),
            "cam_terrain_rgb_share_within": float((rgb_d[same_inst & (cam_h["instance"] == 0)]
                                                   <= SHADE_ATOL).mean()),
            "cam_rock_rgb_max_abs": float(rgb_d[same_inst & (cam_h["instance"] > 0)].max(
                initial=0.0)),
            "cam_rock_pixels": int(rock.sum()), "cam_hit_pixels": int(cam_h["hit"].sum()),
        }
        ok = (cmp["top_rgb_max_abs"] <= WARP_ATOL and cmp["top_depth_equal"]
              and cmp["top_semantic_equal"] and cmp["cam_hit_share"] >= HIT_SHARE
              and cmp["cam_instance_share"] >= HIT_SHARE and cmp["cam_semantic_share"] >= HIT_SHARE
              and cmp["cam_terrain_depth_max_rel"] <= DEPTH_RTOL
              and cmp["cam_rock_depth_max_rel"] <= ROCK_RTOL
              and cmp["cam_terrain_rgb_share_within"] >= 0.999
              and cmp["cam_rock_rgb_max_abs"] <= ROCK_SHADE_ATOL and cmp["cam_hit_pixels"] > 0)
        phase("sdg_frame_card_vs_cpu", rendering="path_tracing", rocks=len(rock_r), **cmp, ok=ok)
        if not ok:
            raise RuntimeError("an SDG capture on the card disagrees with the CPU's")

        # the yard: its world (a 4000^2 DEM at 0.02 m/px, a free 400^2
        # costmap), K1 on that DEM against its plain version, then the goal-seek
        yard_tree = compose(YARD_ARGS)
        yard_cfg = mppi_config(yard_tree["mppi"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        yhf, ycm, _ = build_standalone_world(world_tree(yard_tree), device=cuda,
                                             moonyard=moonyard_section(yard_tree))
        torch.cuda.synchronize()
        yard_world_s = time.perf_counter() - t0
        ypos = torch.tensor([-30.0, -30.0], device=cuda)
        lin = torch.rand((K, H), generator=gen, device=cuda) * 2.0
        ang = torch.rand((K, H), generator=gen, device=cuda) * 2.0 - 1.0
        yargs = (yhf, ypos, heading, lin, ang, DT)
        got, want = rollout_25d_cuda(*yargs), rollout_25d(*yargs)
        torch.cuda.synchronize()
        yard_equal = all(torch.equal(a, b) for a, b in zip(got, want))
        yard_err = max((a - b).abs().max().item() for a, b in zip(got, want))
        yout = torch.empty((12, H, K), device=cuda)

        def yard_launch():
            rollout_25d_cuda.launch(yhf, ypos, heading, lin, ang, yout, DT)

        y_b2b, y_graph = cuda_ms(yard_launch, inner=20), graph_ms(yard_launch)
        y_plain = cuda_ms(lambda: rollout_25d(*yargs), reps=3)
        y_bound, y_bound_by = k1_bound(yhf, got, ypos, 1, K, H, True)
        yard_k1_row = {"ms": y_graph, "plain_ms": y_plain, "bound_ms": y_bound,
                       "bound_by": y_bound_by, "max_abs_err": yard_err}
        phase("k1_on_moonyard", dem=list(yhf.z.shape), resolution=float(yhf.resolution), K=K, H=H,
              wheels=True, position=ypos.tolist(), bit_equal=yard_equal, max_abs_err=yard_err,
              dem_cells_read=dem_cells(yhf, got, ypos), k1_ms=y_b2b, k1_graph_ms=y_graph,
              plain_ms=y_plain, bound_ms=y_bound, bound_by=y_bound_by, ok=yard_equal)
        if not yard_equal:
            raise RuntimeError("K1 disagrees with its plain version on the 4000^2 yard DEM")
        worldbuilders_rocks(yhf.z)
        free = bool(ycm.cost.max().item() == 0.0)
        zero_counts()
        yard = run_standalone(yard_tree)
        yard_counts = counts()
        yloops = yard["loops"]
        ok = (yard["reached"] and free and yard["device"] == "cuda"
              and yard_counts["k1"] % 2 == 0
              and 2 * yloops <= yard_counts["k1"] <= 2 * (yloops + 3)
              and yard_counts["k2"] == 0 and all(np.isfinite(yard["final_position"])))
        phase("moonyard_standalone", environment="lunaryard_80m", dem=list(yhf.z.shape),
              costmap=list(ycm.cost.shape), free_costmap=free, K=yard_cfg.num_samples,
              H=yard_cfg.horizon, start=[-30.0, -30.0], goal=[30.0, 30.0],
              world_build_s=yard_world_s, reached=yard["reached"], loops=yloops,
              final_position=yard["final_position"], wall_s=yard["wall_s"],
              ms_per_loop=1e3 * yard["wall_s"] / max(yloops, 1), k1_launches=yard_counts["k1"],
              k2_launches=yard_counts["k2"], collisions=0 if free else None, ok=ok)
        if not ok:
            raise RuntimeError("the yard goal-seek did not reach its goal, or ran the wrong "
                               "kernels")
        del yhf, ycm, got, want, yout

        # the lab: 4 rovers, 300 sim steps, K=1000 x H=100 (cfg/mode/closed_loop.yaml
        # and cfg/config.yaml's mppi), spawns and goals inside the 9.6 x 6.4 m lab
        lab_tree = compose(LAB_ARGS)
        zero_counts()
        lab = closed_loop_episode(lab_tree)
        lab_counts = counts()
        lab_steps = int(lab_tree["steps"])
        lab_finite = bool(torch.isfinite(lab.path).all())
        ok = (lab_counts["k1"] == 2 * lab_steps and lab_finite and lab_counts["k2"] == 0
              and len(lab.progress) == int(lab_tree["num_rovers"]))
        phase("moonyard_closed_loop", environment="lunalab", N=len(lab.progress),
              K=lab_tree["mppi"].num_samples, H=lab_tree["mppi"].horizon, steps=lab_steps,
              spawn_limit_m=min(40.0, 0.55 * world_tree(lab_tree)["half_width"]),
              k1_launches=lab_counts["k1"], k2_launches=lab_counts["k2"], finite=lab_finite,
              mean_progress_m=float(lab.progress.mean()), progress_m=lab.progress.tolist(),
              wall_s=lab.wall_s, ms_per_sim_step=1e3 * lab.wall_s / lab_steps, ok=ok)
        if not ok:
            raise RuntimeError("the lab's closed loop ran the wrong kernels or left a non-finite "
                               "path")
        return sdg_counts, yard_k1_row, yard_counts, lab_counts, sdg_capture, sdg_graphed

    def worldbuilders_rocks(dem):
        """A rock scatter in the form of the reference's lab and yard rock
        requests (OmniLRS WorldBuilders + RequestMixer) over the
        lunaryard_80m yard: hard-core Thomas xy on an 80 x 80 m plane, z
        from an image clipper and orientation from a normal-map clipper on
        the yard's 4000^2 float32 DEM, scale uniform in [0.02, 0.2]. Run on
        the card and on the CPU from the same seeds: counts equal,
        positions, heights and scales bit-equal, quaternions within the
        float32 spacing of the largest slope (tests/test_torch_worldbuilders.py)."""
        from husky_rover_mppi_isaacsim_torch import worldbuilders as wb
        from husky_rover_mppi_isaacsim_torch.worldbuilders import samplers as wsamp

        side = dem.shape[0] * WB_MPP

        def requests(data):
            res = tuple(data.shape)
            return (
                wb.UserRequest_T(p_type=wb.Position_T(), sampler=wb.HardCoreThomasClusterSampler_T(
                    randomization_space=2, lambda_parent=0.05, lambda_daughter=50, sigma=0.5,
                    core_radius=0.05, num_repeat=1, seed=WB_SEED),
                    layer=wb.Plane_T(xmin=0.0, xmax=side, ymin=0.0, ymax=side), axes=["x", "y"]),
                wb.UserRequest_T(p_type=wb.Position_T(), sampler=wb.ImageClipper_T(
                    randomization_space=1, resolution=res, mpp_resolution=WB_MPP, data=data),
                    layer=wb.Line_T(xmin=0, xmax=1), axes=["z"]),
                wb.UserRequest_T(p_type=wb.Scale_T(), sampler=wb.UniformSampler_T(
                    randomization_space=1, min=(0.02,), max=(0.2,), seed=WB_SEED + 1),
                    layer=wb.Line_T(xmin=0.02, xmax=0.2), axes=["xyz"]),
                wb.UserRequest_T(p_type=wb.OrientationParam_T(), sampler=wb.NormalMapClipper_T(
                    randomization_space=1, resolution=res, mpp_resolution=WB_MPP, data=data),
                    layer=wb.RollPitchYaw_T(output_space=4), axes=["x", "y", "z", "w"]),
            )

        reject = wsamp._hardcore_reject
        out, secs, thin_s, slopes = {}, {}, {}, {}
        for dev in (cuda, cpu):
            thin_s[dev.type] = 0.0

            def timed_reject(*args, dev=dev):  # the thinning's seconds
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                keep = reject(*args)
                torch.cuda.synchronize()
                thin_s[dev.type] += time.perf_counter() - t0
                return keep

            wsamp._hardcore_reject = timed_reject
            try:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mixer = wb.RequestMixer(requests(dem.to(dev)), device=dev)
                out[dev.type] = {k: v.cpu() for k, v in mixer(num=1).items()}
                torch.cuda.synchronize()
                secs[dev.type] = time.perf_counter() - t0
            finally:
                wsamp._hardcore_reject = reject
            clip = mixer.execution_graph["xformOp:orientation"]["meta_layer"][0].layer
            slopes[dev.type] = max(clip.slope_x.abs().max().item(), clip.slope_y.abs().max().item())
        card, host = out["cuda"], out["cpu"]
        n = card["xformOp:translation"].shape[0]
        same_count = all(card[k].shape == host[k].shape for k in card)
        exact = same_count and all(torch.equal(card[k], host[k])
                                   for k in ("xformOp:translation", "xformOp:scale"))
        q_atol = float(np.spacing(np.float32(max(slopes.values()))))
        q_err = ((card["xformOp:orientation"] - host["xformOp:orientation"]).abs().max().item()
                 if same_count else None)
        finite = all(bool(torch.isfinite(v).all()) for v in card.values())
        ok = exact and q_err is not None and q_err <= q_atol and finite and n > 10000
        phase("worldbuilders", environment="lunaryard_80m", dem=list(dem.shape),
              dem_dtype=str(dem.dtype), plane_m=[side, side], rocks=n,
              rocks_cpu=host["xformOp:translation"].shape[0], counts_equal=same_count,
              positions_heights_scales_bit_equal=exact, quaternion_max_abs_diff=q_err,
              quaternion_atol=q_atol, seconds=secs, thinning_s=thin_s,
              thinning_share={k: thin_s[k] / secs[k] for k in secs}, finite=finite, ok=ok)
        if not ok:
            raise RuntimeError("the worldbuilders' rock request differs between the card and "
                               "the CPU")

    def sdg_profiled(sdg_capture, sdg_graphed):
        """Device kernels of one SDG frame, counted by torch.profiler after
        every timed path: the generator (a fresh one per call, so that
        every call draws alike), then the top-down and the camera capture
        with fixed draws; then one frame's top-down and camera passes
        through the graphed labeler of each rendering file (its graphs
        captured by sdg_graph) and through the eager one under
        path_tracing, device kernels and the host's launch calls."""
        sdg_gens = iter([MoonyardGenerator(MoonyardConf(), device=cuda) for _ in range(8)])
        kernels = {
            "generator": device_kernels(lambda: next(sdg_gens).randomize()),
            "top_down_and_camera": device_kernels(lambda: sdg_capture(cuda, "sdg_profiled")),
        }
        kernels["frame"] = sum(kernels.values())
        by_pass = {}
        for rendering, (labelers, inputs) in sdg_graphed.items():
            dem, res, sun, xy, r, cam_xy, yaw, gz, cam_cfg = inputs
            for name, lab in labelers.items():
                if name == "eager" and rendering != "path_tracing":
                    continue  # ~14,500 kernels a frame: profiled under one file
                def top(lab=lab):
                    lab.record(dem, res, sun_direction=sun, rock_xy=xy, rock_radius=r)

                def cam(lab=lab):
                    lab.record_camera(
                        dem, res, (0.0, 0.0), cam_xy, (float(np.cos(yaw)), float(np.sin(yaw))),
                        gz, intrinsics=CameraIntrinsics(width=int(cam_cfg["width"]),
                                                        height=int(cam_cfg["height"])),
                        sun_direction=sun, rock_xy=xy, rock_radius=r,
                        mount_height=float(cam_cfg["mount_height"]),
                        pitch_deg=float(cam_cfg["pitch_deg"]), steps=int(cam_cfg["steps"]),
                        cast_shadows=bool(cam_cfg["cast_shadows"]), frame=0)

                by_pass[f"{rendering}_{name}"] = {
                    k: {"device_kernels": device_kernels(f), "launch_calls": launch_calls(f)}
                    for k, f in (("top_down", top), ("camera", cam))}
        ok = kernels["frame"] > 0 and all(
            v["camera"]["launch_calls"].get("cudaGraphLaunch", 0) > 0
            for k, v in by_pass.items() if k.endswith("_graph"))
        phase("sdg_launches", **{f"device_kernels_{k}": v for k, v in kernels.items()},
              march_steps=128, shadow_steps=64, per_frame_by_pass=by_pass, ok=ok)
        if not ok:
            raise RuntimeError("the profiler saw no SDG kernel, or no graph launch of the "
                               "graphed camera pass")

    if only == "largescale":
        largescale_profiled(largescale_timed()[0])
        return 0
    if only == "cli":
        sdg_profiled(*cli_timed()[-2:])
        return 0

    max_err, k1_row, k1_bench = 0.0, {}, {}
    cases = [("flagship", K, H, True, START), ("flagship", K, H, False, START),
             ("optimal", 1, H, False, START), ("ragged", 33, 37, True, START),
             ("off_dem", K, H, True, (-78.0, 77.0)),
             ("bench", BENCH_K, BENCH_H, True, BENCH_START),
             ("bench", BENCH_K, BENCH_H, False, BENCH_START),
             ("bench_optimal", 1, BENCH_H, False, BENCH_START)]
    for name, k, h, wheels, start in cases:
        p = torch.tensor(start, device=cuda)
        lin = torch.rand((k, h), generator=gen, device=cuda) * 2.0
        ang = torch.rand((k, h), generator=gen, device=cuda) * 2.0 - 1.0
        args = (hf, p, heading, lin, ang, DT)
        got = rollout_25d_cuda(*args, wheels=wheels)
        want = rollout_25d(*args, wheels=wheels)
        torch.cuda.synchronize()
        equal = all(torch.equal(a, b) for a, b in zip(got, want))
        err = max((a - b).abs().max().item() for a, b in zip(got, want))
        out = torch.empty((12 if wheels else 6, h, k), device=cuda)

        def launch():
            rollout_25d_cuda.launch(hf, p, heading, lin, ang, out, DT)

        t_b2b, t_graph = cuda_ms(launch, inner=20), graph_ms(launch)
        t_call = cuda_ms(lambda: rollout_25d_cuda(*args, wheels=wheels), inner=20)
        t_plain = cuda_ms(lambda: rollout_25d(*args, wheels=wheels))
        bound_ms, bound_by = k1_bound(hf, got, p, 1, k, h, wheels)
        phase("k1_vs_plain", case=name, K=k, H=h, wheels=wheels, start=list(start),
              bit_equal=equal, max_abs_err=err, k1_ms=t_b2b, k1_graph_ms=t_graph,
              k1_call_ms=t_call, plain_ms=t_plain, bound_ms=bound_ms, bound_by=bound_by,
              ok=equal)
        if not equal:
            raise RuntimeError(f"K1 disagrees with its plain version: {name}, K={k}, "
                               f"H={h}, wheels={wheels}")
        max_err = max(max_err, err)
        if name == "flagship" and wheels:
            k1_row = {"ms": t_graph, "plain_ms": t_plain, "bound_ms": bound_ms,
                      "bound_by": bound_by}
        row = {"ms": t_graph, "plain_ms": t_plain, "bound_ms": bound_ms, "bound_by": bound_by}
        if name == "bench":
            k1_bench["wheels" if wheels else "body"] = row
        elif name == "bench_optimal":  # the optimal rollout of every K=16384 x H=64 loop
            k1_bench["optimal"] = row

    # the branch-free divisions and square roots of csrc/hopper_common.cuh
    # (K1's and the planar rollout kernel's) against `/` and sqrtf: 2^36
    # hashed division operand pairs, every float32 square-root operand
    t0 = time.perf_counter()
    arith = rollout_25d_cuda.check_arithmetic(cuda, pairs=1 << 36)
    ok = (arith["divisions_differing"] == 0 and arith["roots_differing"] == 0
          and arith["divisions_fast"] > 2 ** 31 and arith["roots_fast"] > 2 ** 30)
    phase("k1_fast_arithmetic", **arith, seconds=time.perf_counter() - t0, ok=ok)
    if not ok:
        raise RuntimeError("K1's fast arithmetic differs from IEEE division or sqrtf")

    # K1's rover axis: N rovers in one launch against N one-rover launches
    # and against the plain batched rollout, bit for bit (a rover's blocks
    # run the one-rover code)
    pos_n = torch.tensor(spawn_points(42, ROVERS, 75.0)[0], dtype=torch.float32, device=cuda)
    head_n = torch.rand((ROVERS, 3), generator=gen, device=cuda) - 0.5
    head_n[:, 2] = 0.0
    for k, h, wheels in ((K, H, True), (K, H, False), (1, H, False), (33, 37, True)):
        lin = torch.rand((ROVERS, k, h), generator=gen, device=cuda) * 2.0
        ang = torch.rand((ROVERS, k, h), generator=gen, device=cuda) * 2.0 - 1.0
        args = (hf, pos_n, head_n, lin, ang, DT)
        got = rollout_25d_cuda(*args, wheels=wheels)
        ones = [rollout_25d_cuda(hf, pos_n[n], head_n[n], lin[n], ang[n], DT, wheels=wheels)
                for n in range(ROVERS)]
        want = rollout_25d(hf, pos_n[:, None], head_n[:, None], lin, ang, DT, wheels=wheels)
        torch.cuda.synchronize()
        bit_equal = all(torch.equal(a[n], b) for n, one in enumerate(ones)
                        for a, b in zip(got, one))
        plain_equal = all(torch.equal(a, b) for a, b in zip(got, want))
        out = torch.empty((12 if wheels else 6, ROVERS, h, k), device=cuda)
        one_outs = [torch.empty((12 if wheels else 6, h, k), device=cuda)
                    for _ in range(ROVERS)]

        def batched():
            rollout_25d_cuda.launch(hf, pos_n, head_n, lin, ang, out, DT)

        def one_rover_launches():
            for n, o in enumerate(one_outs):
                rollout_25d_cuda.launch(hf, pos_n[n], head_n[n], lin[n], ang[n], o, DT)

        t_batched, t_batched_graph = cuda_ms(batched, inner=20), graph_ms(batched)
        t_ones = cuda_ms(one_rover_launches, inner=5)
        t_plain = cuda_ms(lambda: rollout_25d(hf, pos_n[:, None], head_n[:, None], lin,
                                              ang, DT, wheels=wheels), reps=3)
        ok = bit_equal and plain_equal
        phase("k1_batched", N=ROVERS, K=k, H=h, wheels=wheels, bit_equal_to_one_rover=bit_equal,
              bit_equal_to_plain=plain_equal, k1_batched_ms=t_batched,
              k1_batched_graph_ms=t_batched_graph, k1_one_rover_launches_ms=t_ones,
              plain_batched_ms=t_plain, ok=ok)
        if not ok:
            raise RuntimeError(f"K1's rover axis is wrong at K={k}, H={h}, wheels={wheels}")

    # K1 against the thesis's Warp semantics (compat.warp_oracle, float64,
    # one sample at a time) on the flagship DEM from the flagship start,
    # where the oracle's cells stay on the DEM (it does not wrap negative
    # indices)
    from husky_rover_mppi_isaacsim_torch.compat import warp_oracle

    t0 = time.perf_counter()
    pos_o = torch.tensor(START, device=cuda)
    lin_o = torch.rand((ORACLE_SAMPLES, H), generator=gen, device=cuda) * 2.0
    ang_o = torch.rand((ORACLE_SAMPLES, H), generator=gen, device=cuda) * 2.0 - 1.0
    got = [c.double().cpu().numpy() for c in rollout_25d_cuda(hf, pos_o, heading, lin_o, ang_o, DT)]
    z64 = hf.z.double().cpu().numpy()
    grid = [float(hf.x_min), float(hf.y_min), float(hf.resolution)]
    errs, z_equal = [0.0, 0.0, 0.0, 0.0], []
    for n in range(ORACLE_SAMPLES):
        want = warp_oracle.rollout_25d(z64, *grid, pos_o.double().cpu().numpy(),
                                       heading.double().cpu().numpy(),
                                       lin_o[n].double().cpu().numpy(),
                                       ang_o[n].double().cpu().numpy(), DT)
        for c, (g, w) in enumerate(zip(got, want)):
            xy = slice(0, 2) if c >= 2 else slice(None)
            errs[c] = max(errs[c], float(np.abs(g[n][:, xy] - w[:, xy]).max()))
            if c >= 2:
                z_equal.append(float((g[n][:, 2] == w[:, 2]).mean()))
    z_share = float(np.mean(z_equal))
    ok = max(errs) <= ORACLE_ATOL and z_share >= ORACLE_WHEEL_Z_SHARE
    phase("k1_vs_oracle", samples=ORACLE_SAMPLES, H=H, dem=list(hf.z.shape), start=list(START),
          oracle="husky_rover_mppi_isaacsim_torch/compat/warp_oracle.py::rollout_25d (float64)",
          max_abs_err={"trajectory": errs[0], "headings": errs[1], "left_wheel_xy": errs[2],
                       "right_wheel_xy": errs[3]},
          atol=ORACLE_ATOL, wheel_heights_equal_share=z_share,
          wheel_heights_equal_share_min=ORACLE_WHEEL_Z_SHARE,
          seconds=time.perf_counter() - t0, ok=ok)
    if not ok:
        raise RuntimeError("K1 disagrees with the Warp-semantics oracle")

    # the eager plain 2D rollout of the evaluation's 2D arm, at its shape
    lin = torch.rand((K, H), generator=gen, device=cuda) * 2.0
    ang = torch.rand((K, H), generator=gen, device=cuda) * 2.0 - 1.0
    pos = torch.tensor(START, device=cuda)
    phase("rollout_2d_plain", K=K, H=H,
          ms=cuda_ms(lambda: rollout_2d(hf, pos, heading, lin, ang, DT)))

    # 3b. the planar rollout kernel against the plain rollout_2d on the
    #     card, both outputs bit for bit: the 2D arm's K values x H=100 on
    #     the thesis DEM and on the crater DEM, a ragged shape, a start off
    #     the DEM, and N=4 rovers in one launch against one-rover launches.
    #     Timed as a CUDA-graph replay of 20 launches, beside the byte bound
    #     and the chain floor (H x ROLLOUT_2D_CHAIN_DEPTH dependent
    #     operations). Its cosf and sinf
    #     against torch's on the arguments the plain version passes them
    #     here and in one real 2D control step on the thesis world
    thesis_hf = HeightField.create(thesis_statistics_terrain(device=cuda), 75.0)
    thetas = []

    cos_fn = torch.cos

    def recorded_plain(*args):
        """The plain rollout_2d, the angles it takes cos and sin of (one
        tensor a step, w * dt) kept."""
        def cos(t):
            thetas.append(t.clone())
            return cos_fn(t)

        with mock.patch.object(torch, "cos", cos):
            return rollout_2d(*args)

    def r2_bound(hf_, got, start, n, k, h):
        """Velocities in, both outputs out, 4 B per DEM cell read (the
        corners of every step's cell), the poses; the instructions of
        ROLLOUT_2D_OPS_PER_STEP per sample-step."""
        rows, cols = hf_.z.shape
        xy = got[0][..., :2].reshape(-1, 2)
        i, j = corner_cell(hf_, xy[:, 0], xy[:, 1])
        cells = torch.unique(torch.cat([wrap_clamp(j + dj, rows) * cols + wrap_clamp(i + di, cols)
                                        for di, dj in ((0, 0), (1, 0), (0, 1), (1, 1))]))
        moved = (2 + 6) * n * k * h * 4 + 4 * int(cells.numel()) + 4 * n * 5
        return bound(moved, ROLLOUT_2D_OPS_PER_STEP * n * k * h, PEAK_FP32_INSTR_S)

    def r2_chain_floor(h):
        """A lower bound in ms of one sample's H dependent heading steps."""
        return 1e3 * h * ROLLOUT_2D_CHAIN_DEPTH * DEPENDENT_OP_CYCLES / max_sm_hz

    r2_rows, r2_err, r2_row = [], 0.0, {}
    r2_cases = [(dem, k, h, start) for dem in ("thesis_1500", "crater_1500")
                for k, h, start in ((1000, 100, START), (500, 100, START), (350, 100, START))]
    r2_cases += [("thesis_1500", 33, 37, START), ("thesis_1500", K, H, (-78.0, 77.0))]
    for dem, k, h, start in r2_cases:
        hf_ = thesis_hf if dem == "thesis_1500" else hf
        p = torch.tensor(start, device=cuda)
        lin = torch.rand((k, h), generator=gen, device=cuda) * 2.0
        ang = torch.rand((k, h), generator=gen, device=cuda) * 2.0 - 1.0
        got = rollout_2d_cuda(hf_, p, heading, lin, ang, DT)
        want = recorded_plain(hf_, p[None], heading[None], lin, ang, DT)
        torch.cuda.synchronize()
        equal = [torch.equal(a, b) for a, b in zip(got, want)]
        err = [(a - b).abs().max().item() for a, b in zip(got, want)]
        out = torch.empty((2, k, h, 3), device=cuda)
        t_graph = graph_ms(lambda: rollout_2d_cuda.launch(hf_, p, heading, lin, ang, out, DT))
        t_plain = cuda_ms(lambda: rollout_2d(hf_, p[None], heading[None], lin, ang, DT), reps=3)
        bound_ms, bound_by = r2_bound(hf_, got, p, 1, k, h)
        row = {"dem": dem, "K": k, "H": h, "start": list(start),
               "bit_equal": equal, "max_abs_err": err, "ms": t_graph, "plain_ms": t_plain,
               "bound_ms": bound_ms, "bound_by": bound_by}
        phase("rollout_2d_vs_plain", **row, chain_floor_ms=r2_chain_floor(h),
              max_sm_clock_hz=max_sm_hz, ok=all(equal))
        if not all(equal):
            raise RuntimeError(f"the planar rollout kernel disagrees with rollout_2d: {row}")
        r2_err = max([r2_err] + err)
        r2_rows.append(row)
        if (dem, k, h, start) == ("thesis_1500", K, H, START):
            r2_row = {k_: row[k_] for k_ in ("ms", "plain_ms", "bound_ms", "bound_by")}

    #     N=4 rovers in one launch against four one-rover launches and the
    #     plain batched rollout
    for k, h in ((K, H), (33, 37)):
        lin = torch.rand((ROVERS, k, h), generator=gen, device=cuda) * 2.0
        ang = torch.rand((ROVERS, k, h), generator=gen, device=cuda) * 2.0 - 1.0
        got = rollout_2d_cuda(thesis_hf, pos_n, head_n, lin, ang, DT)
        ones = [rollout_2d_cuda(thesis_hf, pos_n[n], head_n[n], lin[n], ang[n], DT)
                for n in range(ROVERS)]
        want = recorded_plain(thesis_hf, pos_n[:, None], head_n[:, None], lin, ang, DT)
        torch.cuda.synchronize()
        one_equal = all(torch.equal(a[n], b) for n, one in enumerate(ones)
                        for a, b in zip(got, one))
        plain_equal = all(torch.equal(a, b) for a, b in zip(got, want))
        out = torch.empty((2, ROVERS, k, h, 3), device=cuda)
        t_batched = graph_ms(lambda: rollout_2d_cuda.launch(thesis_hf, pos_n, head_n, lin, ang,
                                                             out, DT))
        ok = one_equal and plain_equal
        phase("rollout_2d_batched", N=ROVERS, K=k, H=h, bit_equal_to_one_rover=one_equal,
              bit_equal_to_plain=plain_equal, ms=t_batched, ok=ok)
        if not ok:
            raise RuntimeError(f"the planar rollout kernel's rover axis is wrong at K={k}")

    #     one real 2D control step on the thesis world (its sample rollout
    #     on the plain version), for the angles a control step passes
    cfg2d_step = MPPIConfig(num_samples=K, horizon=H, projection="2d")
    thesis_cm_small = as_costmap(torch.zeros((150, 150)), 75.0, device=cuda)
    with mock.patch.object(r2_module.CudaRollout2d, "__call__",
                           lambda self, hf_, p, h_, lin, ang, dt: recorded_plain(
                               hf_, p[..., None, :], h_[..., None, :], lin, ang, dt)):
        mppi_step(cfg2d_step, thesis_hf, thesis_cm_small, torch.tensor(GOAL, device=cuda),
                  RobotState.create(-60.0, 10.0, HEADING, device=cuda, wheel_speed=1.0),
                  ControllerState.create(cfg2d_step, device=cuda, initial_u=1.0),
                  torch.randn((2, K, H), generator=gen, device=cuda))
    theta = torch.cat([t.flatten() for t in thetas]).contiguous()
    libm = {}
    for name in ("cos", "sin"):
        got, want = rollout_2d_cuda.libm(name, theta), getattr(torch, name)(theta)
        libm[name] = {"values": theta.numel(), "differ": int((got != want).sum())}
    libm_ok = all(v["differ"] == 0 for v in libm.values())
    phase("rollout_2d_libm", build="-fmad=false", theta_min=theta.min().item(),
          theta_max=theta.max().item(), **libm, ok=libm_ok)
    if not libm_ok:
        raise RuntimeError("the planar rollout kernel's cosf / sinf differ from torch's")
    del thetas, theta

    # 4. K2 against its plain version on the card, bit for bit: the
    #    standalone and thesis occupancies, random maps whose sides are not
    #    multiples of K2's 64 x 64 tile (875 columns: rows not 16-byte
    #    aligned; 516: aligned), and an obstacle-free map (the _BIG sentinel)
    def occupancy(size):
        raster = rasterize_obstacles(generate_obstacles(), half_width=75.0, size=size,
                                     robot_radius=0.3)
        return torch.from_numpy(raster == 0)

    maps = {"standalone_750": occupancy(750).to(cuda), "thesis_1500": occupancy(1500).to(cuda),
            "random_187x875": torch.rand((187, 875), generator=gen, device=cuda) < 0.02,
            "random_203x516": torch.rand((203, 516), generator=gen, device=cuda) < 0.02,
            "free_750": torch.zeros((750, 750), dtype=torch.bool, device=cuda)}
    k2_row, k2_err = {}, 0.0
    for name, occ in maps.items():
        got, want = edt_exact_sq(occ), edt_exact_sq_plain(occ)
        equal = torch.equal(got, want)
        err = (got - want).abs().max().item()
        g2 = row_distances_sq(occ)
        out = torch.empty_like(g2)

        def launch():
            edt_minplus_cuda.launch(g2, out)

        t_k2, t_k2_graph = cuda_ms(launch), graph_ms(launch)
        t_plain = cuda_ms(lambda: minplus_envelope(g2))
        rows, cols = g2.shape
        bound_ms, bound_by = k2_bound(rows, cols)
        phase("k2_vs_plain", map=name, shape=list(occ.shape), bit_equal=equal, max_abs_err=err,
              k2_ms=t_k2, k2_graph_ms=t_k2_graph, plain_ms=t_plain, bound_ms=bound_ms,
              bound_by=bound_by)
        if not equal:
            raise RuntimeError(f"K2 disagrees with its plain version on {name}")
        k2_err = max(k2_err, err)
        if name == "thesis_1500":
            k2_row = {"ms": t_k2_graph, "plain_ms": t_plain, "bound_ms": bound_ms,
                      "bound_by": bound_by}

    # K3 against its three plain formulations on the card, bit for bit, at
    # the probe's shapes: the probe's table and a random one. Timed as
    # CUDA-graph replays, so that the gather and not the host's issue time
    # is read; its library call is the one-op formulation table[j, i]
    table, idx_i, idx_j = gp.probe_inputs(cuda)
    rand_table = torch.randn((gp.P, gp.P), generator=gen, device=cuda)
    k3_row, k3_err = {}, 0.0
    for name, tab in (("arange", table), ("random", rand_table)):
        got = gp.gather_probe_cuda(tab, idx_i, idx_j)
        plains = {f: fn(tab, idx_i, idx_j) for f, fn in gp.FORMULATIONS.items()}
        equal = {f: torch.equal(got, want) for f, want in plains.items()}
        k3_err = max([k3_err] + [(got - want).abs().max().item() for want in plains.values()])
        out = torch.empty((gp.K,), device=cuda)

        def launch():
            gp.gather_probe_cuda.launch(tab, idx_i, idx_j, out)

        t_k3, t_k3_graph = cuda_ms(launch, inner=20), graph_ms(launch)
        plain = {f: graph_ms(lambda: fn(tab, idx_i, idx_j)) for f, fn in gp.FORMULATIONS.items()}
        # lanes x (one table element, two int32 indices) in, lanes x float32
        # out; no launch finishes in that time, so the bound is the larger of
        # it and the replay time of an empty kernel of K3's grid and block
        bytes_ms, _ = bound(gp.K * 16, 0, PEAK_FP32_S)
        floor_ms = graph_ms(lambda: gp.gather_probe_cuda.launch_floor(gp.K))
        bound_ms = max(bytes_ms, floor_ms)
        # of the data sheet's two terms bytes is the larger (a gather does no
        # operations); `bound_set_by` says which of bytes and floor sets it
        bound_by = "bytes"
        set_by = "bytes" if bytes_ms >= floor_ms else "launch floor (empty kernel)"
        phase("k3_vs_plain", table=name, shape=[gp.P, gp.P], lanes=gp.K, bit_equal=equal,
              k3_ms=t_k3, k3_graph_ms=t_k3_graph, plain_graph_ms=plain, bytes_bound_ms=bytes_ms,
              empty_kernel_graph_ms=floor_ms, bound_ms=bound_ms, bound_by=bound_by,
              bound_set_by=set_by, k3_over_bound=t_k3_graph / bound_ms)
        if not all(equal.values()):
            raise RuntimeError(f"K3 disagrees with a plain formulation on the {name} table")
        if name == "arange":
            k3_row = {"ms": t_k3_graph, "plain_ms": plain["flat torch.take"],
                      "bound_ms": bound_ms, "bound_by": bound_by, "bound_set_by": set_by,
                      "bytes_bound_ms": bytes_ms,
                      "empty_kernel_ms": floor_ms, "library_ms": plain["advanced getitem"]}

    # 5. the standalone world, built on the card through K2; its EDT against
    #    the CPU's plain one; the costmap builds at 750^2 and 1500^2 with K2
    #    and with the plain envelope on the card
    edt_minplus_cuda.launches = 0
    t0 = time.perf_counter()
    hf, cm, hw = build_standalone_world({}, device=cuda)
    torch.cuda.synchronize()
    world_s = time.perf_counter() - t0
    world_k2 = edt_minplus_cuda.launches
    occupied = occupancy(750)
    edt_equal = torch.equal(edt_exact_sq(occupied.to(cuda)).cpu(), edt_exact_sq(occupied))
    finite = bool(torch.isfinite(hf.z).all() and torch.isfinite(cm.cost).all())
    # the 150 m crater map and the 750^2 costmap on the card against the
    # same builds on the CPU (XLA's float32 arithmetic on both)
    map_equal = torch.equal(hf.z.cpu(), crater_surface(1500, hw, STANDALONE_CRATER_BUMPS,
                                                       device=cpu))
    cost_equal = torch.equal(cm.cost.cpu(), costmap_750(use_exact_edt=True, device=cpu).cost)

    def costmap_seconds(size, plain):
        t0 = time.perf_counter()
        if plain:  # distance_costmap's steps, with the plain envelope
            occ = occupancy(size).to(cuda)
            d = sqrt_f32(edt_exact_sq_plain(occ))
            pow_f32(1.0 - normalize_minmax(d), 20.0)
        else:
            costmap_750(size=size, use_exact_edt=True, device=cuda)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    costmap_s = {f"{size}": {"k2": [], "plain": []} for size in (750, 1500)}
    for size in (750, 1500):
        for kind in ("plain", "k2", "k2", "plain"):
            costmap_s[f"{size}"][kind].append(costmap_seconds(size, kind == "plain"))
    phase("world", dem=list(hf.z.shape), costmap=list(cm.cost.shape), seconds=round(world_s, 3),
          k2_launches=world_k2, edt_card_equals_cpu=edt_equal,
          crater_map_card_equals_cpu=map_equal, costmap_card_equals_cpu=cost_equal,
          finite=finite, cost_min=cm.cost.min().item(), cost_max=cm.cost.max().item(),
          costmap_build_s=costmap_s)
    if not (edt_equal and finite and map_equal and cost_equal):
        raise RuntimeError("world build on the card is wrong, or its crater map or costmap "
                           "differs from the CPU's")
    if world_k2 != 1:
        raise RuntimeError(f"the world build launched K2 {world_k2} times, not once")

    # 6. one control step: on the card (K1, no host sync) and on the CPU
    #    (plain), same noise
    cfg = MPPIConfig(num_samples=K, horizon=H)
    noise = torch.randn((2, K, H), generator=torch.Generator().manual_seed(1))

    def step_on(dev):
        robot = RobotState.create(*START, HEADING, device=dev)
        ctrl = ControllerState.create(cfg, device=dev)
        goal = torch.tensor(GOAL, device=dev)
        args = (cfg, HeightField(*(t.to(dev) for t in hf)), type(cm)(*(t.to(dev) for t in cm)),
                goal, robot, ctrl, noise.to(dev))
        if dev != cuda:
            return mppi_step(*args)[1]
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")  # a host sync inside the step raises
        try:
            return mppi_step(*args)[1]
        finally:
            torch.cuda.set_sync_debug_mode("default")

    got, want = step_on(cuda), step_on(cpu)
    diffs = {
        "weights": (got.weights.cpu() - want.weights).abs().max().item(),
        "v": abs(got.linear_velocity.item() - want.linear_velocity.item()),
        "omega": abs(got.angular_velocity.item() - want.angular_velocity.item()),
        "optimal_trajectory": (got.optimal_trajectory.cpu()
                               - want.optimal_trajectory).abs().max().item(),
    }
    v_ref, w_ref = abs(want.linear_velocity.item()), abs(want.angular_velocity.item())
    ok = (diffs["weights"] <= 1e-3 and diffs["v"] <= 1e-5 + 1e-4 * v_ref
          and diffs["omega"] <= 1e-4 + 1e-4 * w_ref and diffs["optimal_trajectory"] <= 1e-3)
    phase("step_card_vs_cpu", max_abs_diff=diffs, v_cpu=want.linear_velocity.item(), ok=ok)
    if not ok:
        raise RuntimeError("the control step on the card disagrees with the CPU's")

    # 6b. one closed-loop step of the CLI's 4 rovers: on the card (two K1
    #     launches, no host sync) and on the CPU, from the same key; then
    #     rover n of the batched control step against a one-rover step on
    #     the card, on the step's draw
    cl_cfg = closed_loop_config({})
    starts, goals_np = spawn_points(42, ROVERS, hw)
    cl_noise = tenv.step_noise(jr.key(3), cl_cfg.mppi, ROVERS)
    track = cl_cfg.mppi.robot_radius

    def loop_step_on(dev):
        hf_d = HeightField(*(t.to(dev) for t in hf))
        cm_d = type(cm)(*(t.to(dev) for t in cm))
        state = tenv.init_loop_state(cl_cfg, tenv.RoverState.create(starts, [1.0, 0.0, 0.0],
                                                                   hf_d))
        goals = torch.tensor(goals_np, dtype=torch.float32, device=dev)
        key = jr.key(3, dev)
        if dev != cuda:
            return tenv.closed_loop_step(cl_cfg, hf_d, cm_d, goals, state, key)
        torch.cuda.synchronize()
        before = rollout_25d_cuda.launches
        torch.cuda.set_sync_debug_mode("error")  # a host sync inside the step raises
        try:
            out = tenv.closed_loop_step(cl_cfg, hf_d, cm_d, goals, state, key)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        return out, rollout_25d_cuda.launches - before

    (got, step_launches), want = loop_step_on(cuda), loop_step_on(cpu)
    v = lambda s: (s.stored_left + s.stored_right) / 2.0  # noqa: E731
    w = lambda s: (s.stored_right - s.stored_left) / track  # noqa: E731
    diffs = {
        "v": (v(got).cpu() - v(want)).abs().max().item(),
        "omega": (w(got).cpu() - w(want)).abs().max().item(),
        "optimal_u": max((a.cpu() - b).abs().max().item()
                         for a, b in zip(got.ctrl[:2], want.ctrl[:2])),
        "rover_state": max((a.cpu() - b).abs().max().item()
                           for a, b in zip(got.rovers, want.rovers)),
    }
    v_ref, w_ref = v(want).abs().max().item(), w(want).abs().max().item()
    ok = (diffs["v"] <= 1e-5 + 1e-4 * v_ref and diffs["omega"] <= 1e-4 + 1e-4 * w_ref
          and diffs["optimal_u"] <= 1e-3 and diffs["rover_state"] <= 1e-3 and step_launches == 2)

    # rover n of the batched step on the card against a one-rover step
    robot_b = RobotState(got.rovers.position, got.rovers.z, got.rovers.heading,
                         got.stored_left, got.stored_right)
    ctrl_b = got.ctrl
    goals_d = torch.tensor(goals_np, dtype=torch.float32, device=cuda)
    noise_d = cl_noise.to(cuda)
    _, out_b = mppi_step(cl_cfg.mppi, hf, cm, goals_d, robot_b, ctrl_b, noise_d)
    bit_equal, one_diff = {}, {}
    for n in range(ROVERS):
        _, out_1 = mppi_step(cl_cfg.mppi, hf, cm, goals_d[n], RobotState(*(t[n] for t in robot_b)),
                             type(ctrl_b)(*(t[n] for t in ctrl_b)), noise_d[n])
        for f in ("costs", "weights", "linear_velocity", "angular_velocity",
                  "optimal_trajectory"):
            a, b = getattr(out_b, f)[n], getattr(out_1, f)
            bit_equal[f] = bit_equal.get(f, True) and torch.equal(a, b)
            one_diff[f] = max(one_diff.get(f, 0.0), (a - b).abs().max().item())
    ok = ok and (one_diff["weights"] <= 1e-3 and one_diff["optimal_trajectory"] <= 1e-3
                 and one_diff["linear_velocity"] <= 1e-5 + 1e-4 * v_ref
                 and one_diff["angular_velocity"] <= 1e-4 + 1e-4 * w_ref)
    phase("closed_loop_step_card_vs_cpu", N=ROVERS, K=K, H=H, k1_launches=step_launches,
          max_abs_diff=diffs, batched_vs_one_rover_bit_equal=bit_equal,
          batched_vs_one_rover_max_abs_diff=one_diff, ok=ok)
    if not ok:
        raise RuntimeError("the closed-loop step on the card disagrees with the CPU's "
                           "or with one-rover steps")

    # 7. the flagship goal-seek, through K1, its masked steps replayed as
    #    one CUDA graph of 4 steps (the default route on the card)
    robot = RobotState.create(*START, HEADING, device=cuda)
    ctrl = ControllerState.create(cfg, device=cuda)
    goal = torch.tensor(GOAL, device=cuda)
    gs_graph = Graphed(masked_steps)
    gs_key = jr.key(42, cuda)
    torch.cuda.synchronize()
    rollout_25d_cuda.launches = edt_minplus_cuda.launches = jax_normal.launches = 0
    t0 = time.perf_counter()
    res = goal_seek_recorded(cfg, hf, cm, goal, robot, ctrl, gs_key, max_loops=3500,
                             steps_fn=gs_graph)
    loops = int(res.loops)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, gs_draws = rollout_25d_cuda.launches, jax_normal.launches
    path = res.positions[:loops]
    ix, iy = costmap_cells(path, cm)
    path_cost = grid_lookup(cm.cost, ix, iy)
    collisions = int((path_cost > 0.99).sum())
    finite = bool(torch.isfinite(path).all())
    final = res.robot.position.tolist()
    phase("goal_seek", reached=bool(res.reached), loops=loops, steps=res.steps,
          k1_launches=launches, jax_normal_launches=gs_draws, collisions=collisions,
          max_path_cost=path_cost.max().item(),
          final_position=final, wall_s=wall, ms_per_loop=1e3 * wall / max(loops, 1))
    if not (bool(res.reached) and collisions == 0 and finite):
        raise RuntimeError("the flagship goal-seek did not reach its goal cleanly")
    if launches != 2 * res.steps or launches == 0:
        raise RuntimeError(f"K1 ran {launches} times for {res.steps} control steps")
    if gs_draws != res.steps:
        raise RuntimeError(f"jax_normal ran {gs_draws} times for {res.steps} control steps")

    #     graph_goal_seek: the same episode with the masked steps eager, from
    #     the same key: equal loops, path and final state
    torch.cuda.synchronize()
    rollout_25d_cuda.launches = 0
    t0 = time.perf_counter()
    eager = goal_seek_recorded(cfg, hf, cm, goal, RobotState.create(*START, HEADING, device=cuda),
                               ControllerState.create(cfg, device=cuda), jr.key(42, cuda),
                               max_loops=3500, steps_fn=masked_steps)
    e_loops = int(eager.loops)
    torch.cuda.synchronize()
    e_wall = time.perf_counter() - t0
    equal = (e_loops == loops and eager.steps == res.steps and _same(eager, res))
    ok = equal and rollout_25d_cuda.launches == launches and gs_graph.replays > 0
    phase("graph_goal_seek", K=K, H=H, unroll=4, loops_graph=loops, loops_eager=e_loops,
          reached=bool(res.reached), final_position=final, graph_equals_eager=equal,
          ms_per_loop_eager=1e3 * e_wall / max(e_loops, 1),
          ms_per_loop_graph=1e3 * wall / max(loops, 1), capture_ms=gs_graph.capture_ms,
          replays=gs_graph.replays, k1_launches_eager=rollout_25d_cuda.launches,
          k1_launches_graph=launches, ok=ok)
    if not ok:
        raise RuntimeError("the graphed flagship goal-seek differs from the eager one")
    del eager

    # 7b. the CLI's default closed loop (python -m ...cli mode=closed_loop):
    #     4 rovers, K=1000 x H=100, 300 sim steps on its own standalone world,
    #     two K1 launches per step
    torch.cuda.synchronize()
    rollout_25d_cuda.launches = edt_minplus_cuda.launches = gp.gather_probe_cuda.launches = 0
    jax_normal.launches = 0
    run = closed_loop_episode({})
    cl_k1, cl_k2 = rollout_25d_cuda.launches, edt_minplus_cuda.launches
    draws_by_path["closed_loop"] = jax_normal.launches
    cl_finite = bool(torch.isfinite(run.path).all())
    mean_progress = float(run.progress.mean())
    phase("closed_loop", N=len(run.progress), K=K, H=H, steps=SIM_STEPS,
          k1_launches=cl_k1, k1_expected=2 * SIM_STEPS, k2_launches=cl_k2, finite=cl_finite,
          mean_progress_m=mean_progress, progress_m=run.progress.tolist(), wall_s=run.wall_s,
          sim_steps_per_s=SIM_STEPS / run.wall_s, ms_per_sim_step=1e3 * run.wall_s / SIM_STEPS)
    if draws_by_path["closed_loop"] != SIM_STEPS:
        raise RuntimeError(f"jax_normal ran {draws_by_path['closed_loop']} times in "
                           f"{SIM_STEPS} closed-loop steps")
    if len(run.progress) != ROVERS or cl_k1 != 2 * SIM_STEPS:
        raise RuntimeError(f"K1 ran {cl_k1} times in {SIM_STEPS} closed-loop steps "
                           f"of {len(run.progress)} rovers")
    if not (cl_finite and mean_progress > 0.0):
        raise RuntimeError("the closed loop made no progress or left a non-finite path")

    #     graph_closed_loop: the same episode on the standalone world through
    #     run_episode, one step graph replayed a sim step and the steps
    #     eager, from the same key: equal path and final state
    cl_graph = Graphed(tenv.closed_loop_step)
    cl_runs = {}
    for name, step_fn in (("graph", cl_graph), ("eager", tenv.closed_loop_step)):
        state0 = tenv.init_loop_state(cl_cfg, tenv.RoverState.create(starts, [1.0, 0.0, 0.0], hf))
        goals_cl = torch.tensor(goals_np, dtype=torch.float32, device=cuda)
        torch.cuda.synchronize()
        rollout_25d_cuda.launches = 0
        t0 = time.perf_counter()
        out = tenv.run_episode(cl_cfg, hf, cm, goals_cl, state0, jr.key(0, cuda), SIM_STEPS,
                               step_fn=step_fn)
        torch.cuda.synchronize()
        cl_runs[name] = (out, time.perf_counter() - t0, rollout_25d_cuda.launches)
    equal = _same(cl_runs["graph"][0], cl_runs["eager"][0])
    ok = (equal and cl_runs["graph"][2] == cl_runs["eager"][2] == 2 * SIM_STEPS
          and cl_graph.replays == SIM_STEPS - 1)
    phase("graph_closed_loop", N=ROVERS, K=K, H=H, steps=SIM_STEPS, graph_equals_eager=equal,
          ms_per_sim_step_eager=1e3 * cl_runs["eager"][1] / SIM_STEPS,
          ms_per_sim_step_graph=1e3 * cl_runs["graph"][1] / SIM_STEPS,
          capture_ms=cl_graph.capture_ms, replays=cl_graph.replays,
          k1_launches_graph=cl_runs["graph"][2], k1_launches_eager=cl_runs["eager"][2],
          final_positions=cl_runs["graph"][0][0].rovers.position.tolist(), ok=ok)
    if not ok:
        raise RuntimeError("the graphed closed loop differs from the eager one")
    del cl_runs

    # 7c. the vectorized env: 4096 rovers, 400 physics steps (bench.py's
    #     bench_vec_env shapes); first 5 turning steps against the CPU's, the
    #     first with an external force and torque (the divisions by mass and
    #     yaw inertia), every state field held to 8 float32 ulps of its
    #     largest magnitude
    params = tenv.RoverParams()
    vec_pos = np.random.default_rng(0).uniform(-50.0, 50.0, (VEC_ROVERS, 2))
    cmd = torch.full((VEC_ROVERS,), 1.5, device=cuda)
    vec0 = tenv.RoverState.create(vec_pos, [1.0, 0.0, 0.0], hf)
    frng = np.random.default_rng(1)
    turn = [torch.tensor(frng.uniform(0.0, 2.0, VEC_ROVERS), dtype=torch.float32)
            for _ in range(2)]
    push = {"ext_force": torch.tensor(frng.normal(0.0, 40.0, (VEC_ROVERS, 3)),
                                      dtype=torch.float32),
            "ext_torque": torch.tensor(frng.normal(0.0, 5.0, VEC_ROVERS), dtype=torch.float32)}
    hf_cpu = HeightField(*(t.cpu() for t in hf))
    card, host = vec0, tenv.RoverState(*(t.cpu() for t in vec0))
    for s in range(5):
        ext = push if s == 0 else {}
        card = tenv.step(params, hf, card, *(t.to(cuda) for t in turn),
                         **{k: t.to(cuda) for k, t in ext.items()})
        host = tenv.step(params, hf_cpu, host, *turn, **ext)
    vec_diff = {f: (a.cpu() - b).abs().max().item() for f, a, b in zip(card._fields, card, host)}
    vec_tol = {f: 8 * torch.finfo(torch.float32).eps * max(1.0, b.abs().max().item())
               for f, b in zip(host._fields, host)}
    vec_close = all(vec_diff[f] <= vec_tol[f] for f in vec_diff)
    vec_state = vec0
    tenv.step(params, hf, vec_state, cmd, cmd)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(VEC_STEPS):
        vec_state = tenv.step(params, hf, vec_state, cmd, cmd)
    torch.cuda.synchronize()
    vec_wall = time.perf_counter() - t0
    vec_finite = bool(torch.isfinite(vec_state.position).all())
    phase("vec_env", N=VEC_ROVERS, steps=VEC_STEPS, wall_s=vec_wall,
          ms_per_step=1e3 * vec_wall / VEC_STEPS,
          rover_steps_per_s=VEC_ROVERS * VEC_STEPS / vec_wall, finite=vec_finite,
          card_vs_cpu_5_steps_max_abs_diff=vec_diff, card_vs_cpu_tolerance=vec_tol,
          card_vs_cpu_ok=vec_close)
    if not (vec_finite and vec_close):
        raise RuntimeError("the vectorized env on the card disagrees with the CPU's")

    # 7c'. bench_graphs: bench_torch.py's graphs against their eager runs,
    #      bit for bit. Its control loops at K=16384 x H=64 under both slope
    #      critics: BENCH_LOOPS loops as one graph replay against the same
    #      loops eagerly on the same noise (K1 twice a loop either way); its
    #      vec env: the graph of VEC_BLOCK physics steps called until
    #      VEC_STEPS steps (the warm-up, the capture, replays) against
    #      VEC_STEPS eager steps
    bench_goal = torch.tensor([65.0, 60.0], device=cuda)
    bench_graph_rows = {}
    for critic in ("wheels", "body"):
        bcfg = MPPIConfig(num_samples=BENCH_K, horizon=BENCH_H, exact=False, slope_critic=critic)
        brobot = RobotState.create(*BENCH_START, HEADING, device=cuda)
        bctrl = ControllerState.create(bcfg, device=cuda)
        bargs = (bcfg, hf, cm, bench_goal, brobot, bctrl, jr.key(50, cuda), BENCH_LOOPS)
        bgraph = Graphed(bench_torch.control_loops, in_place_args=bench_torch.LOOPS_IN_PLACE)
        bgraph(*bargs)  # the warm-up, eager
        torch.cuda.synchronize()
        rollout_25d_cuda.launches = jax_normal.launches = 0
        got = bgraph(*bargs)  # the capture and one replay
        torch.cuda.synchronize()
        graph_k1, graph_draws = rollout_25d_cuda.launches, jax_normal.launches
        rollout_25d_cuda.launches = jax_normal.launches = 0
        want = bench_torch.control_loops(*bargs)
        torch.cuda.synchronize()
        eager_k1, eager_draws = rollout_25d_cuda.launches, jax_normal.launches
        equal = _same(got, want)
        t_graph = cuda_ms(lambda: bgraph(*bargs)) / BENCH_LOOPS
        t_eager = cuda_ms(lambda: bench_torch.control_loops(*bargs)) / BENCH_LOOPS
        ok = (equal and graph_k1 == eager_k1 == 2 * BENCH_LOOPS
              and graph_draws == eager_draws == BENCH_LOOPS)
        bench_graph_rows[critic] = {"graph_equals_eager": equal, "k1_launches_graph": graph_k1,
                                    "k1_launches_eager": eager_k1,
                                    "jax_normal_launches_graph": graph_draws,
                                    "jax_normal_launches_eager": eager_draws,
                                    "ms_per_loop_graph": t_graph, "ms_per_loop_eager": t_eager,
                                    "capture_ms": bgraph.capture_ms, "ok": ok}
        del got, want, bgraph
    vec_graph = Graphed(bench_torch.vec_env_steps, in_place_args=(1,))
    vec_b0, vec_cmd = bench_torch.vec_env_start(hf, VEC_ROVERS)
    vec_got = vec_b0
    for _ in range(VEC_STEPS // VEC_BLOCK):
        vec_got = vec_graph(params, hf, vec_got, vec_cmd, VEC_BLOCK)
    vec_want = bench_torch.vec_env_steps(params, hf, vec_b0, vec_cmd, VEC_STEPS)
    torch.cuda.synchronize()
    vec_equal, vec_replays = _same(vec_got, vec_want), vec_graph.replays
    vec_graph_ms = cuda_ms(lambda: vec_graph(params, hf, vec_b0, vec_cmd, VEC_BLOCK)) / VEC_BLOCK
    vec_eager_ms = cuda_ms(lambda: bench_torch.vec_env_steps(params, hf, vec_b0, vec_cmd,
                                                             VEC_BLOCK)) / VEC_BLOCK
    vec_ok = vec_equal and vec_replays == VEC_STEPS // VEC_BLOCK - 1
    phase("bench_graphs", K=BENCH_K, H=BENCH_H, loops=BENCH_LOOPS, start=list(BENCH_START),
          control_loops=bench_graph_rows, vec_env={
              "N": VEC_ROVERS, "steps": VEC_STEPS, "block": VEC_BLOCK,
              "graph_equals_eager": vec_equal, "ms_per_step_graph": vec_graph_ms,
              "ms_per_step_eager": vec_eager_ms, "capture_ms": vec_graph.capture_ms,
              "ok": vec_ok})
    if not (vec_ok and all(r["ok"] for r in bench_graph_rows.values())):
        raise RuntimeError("a graph of bench_torch.py differs from its eager run")
    del vec_got, vec_want, vec_graph

    # 7d. the host shell's SimulationManager on the flagship world: 5 robot
    #     slots at ClosedLoopConfig() (K=1000 x H=100). First its first
    #     SIM_CHECK ticks on the card against the same ticks on the CPU,
    #     both from the manager's seed, at the closed-loop step's card-vs-CPU
    #     tolerances (phase 6b): each card tick from the CPU's state before
    #     it, every field; the free-running card ticks' rover states too
    #     (their commands and planned inputs are reported: a slot whose
    #     softmax is one-hot, an idle one at its goal, can pick another
    #     near-tied sample a few ticks on); then SIM_TICKS ticks driven over
    #     its bus (3 spawns before tick 0, a teleport at tick 100, a reset at
    #     tick 200, a POSE_STATE subscriber over the last 10 ticks), timed in
    #     windows of SIM_WINDOW ticks, every tick without a subscriber under
    #     set_sync_debug_mode("error"): 2 K1 launches a tick
    sim_conf = SimulationManagerConf(loop=tenv.ClosedLoopConfig())
    sim_goals = np.array([GOAL, (40.0, -30.0), (-35.0, 40.0), (0.0, 0.0), (0.0, 0.0)])
    hf_cpu, cm_cpu = HeightField(*(t.cpu() for t in hf)), type(cm)(*(t.cpu() for t in cm))

    def sim_manager(dev, hf_, cm_):
        sm = SimulationManager(sim_conf, hf_, cm_, tenv.RobotManager(SIM_SLOTS), sim_goals,
                               device=dev)
        for name, pos in SIM_SPAWNS.items():
            sm.bus.publish(Topics.ROBOT_SPAWN, {"name": name, "position": pos,
                                                "heading": HEADING})
        sm.apply_modifications()
        return sm

    card_states, cpu_states, cpu_before, tick_states = [], [], [], []
    with sim_manager(cuda, hf, cm) as card_sm, sim_manager(cpu, hf_cpu, cm_cpu) as cpu_sm, \
            sim_manager(cuda, hf, cm) as tick_sm:
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")  # a host sync inside a tick raises
        try:
            for _ in range(SIM_CHECK):
                card_states.append(tenv.clone_state(card_sm.step()))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        for _ in range(SIM_CHECK):
            cpu_before.append(tenv.clone_state(cpu_sm.state))
            cpu_states.append(cpu_sm.step())
        for before in cpu_before:  # the card's tick from the CPU's state
            tick_sm.state = on_device(before, cuda)
            tick_states.append(tenv.clone_state(tick_sm.step()))

    def sim_diff(got, want):
        d = {"v": (v(got).cpu() - v(want)).abs().max().item(),
             "omega": (w(got).cpu() - w(want)).abs().max().item(),
             "optimal_u": max((a.cpu() - b).abs().max().item()
                              for a, b in zip(got.ctrl[:2], want.ctrl[:2])),
             "rover_state": max((a.cpu() - b).abs().max().item()
                                for a, b in zip(got.rovers, want.rovers))}
        v_ref, w_ref = v(want).abs().max().item(), w(want).abs().max().item()
        poses = d["rover_state"] <= 1e-3
        return d, poses, (poses and d["v"] <= 1e-5 + 1e-4 * v_ref
                          and d["omega"] <= 1e-4 + 1e-4 * w_ref and d["optimal_u"] <= 1e-3)

    sim_diffs, sim_free_diffs, sim_ok = [], [], True
    for got, free, want in zip(tick_states, card_states, cpu_states):
        d, _, tick_ok = sim_diff(got, want)
        d_free, free_ok, _ = sim_diff(free, want)
        sim_ok = sim_ok and tick_ok and free_ok
        sim_diffs.append(d)
        sim_free_diffs.append(d_free)

    def drive_sim_manager(step_fn=None):
        """SIM_TICKS ticks over the bus, timed in windows; ``step_fn``
        replaces the manager's step graph (the eager reference). Returns the
        manager, the window times, the states flushed after the teleport and
        the reset, the pose messages and the K1 and K2 launches."""
        seen, flushed, windows = [], {}, []
        sm = sim_manager(cuda, hf, cm)
        if step_fn is not None:
            sm.step_fn = step_fn
        try:
            torch.cuda.synchronize()
            rollout_25d_cuda.launches = edt_minplus_cuda.launches = 0
            gp.gather_probe_cuda.launches = jax_normal.launches = 0
            for w0 in range(0, SIM_TICKS, SIM_WINDOW):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for tick in range(w0, w0 + SIM_WINDOW):
                    if tick == 100:
                        sm.bus.publish(Topics.ROBOT_TELEPORT, {"name": "husky_1",
                                                               "position": SIM_TELEPORT,
                                                               "heading": (0.0, 1.0, 0.0)})
                    if tick == 200:
                        sm.bus.publish(Topics.ROBOT_RESET, {"name": "husky_0"})
                    if tick == SIM_TICKS - 10:
                        sm.bus.subscribe(Topics.POSE_STATE, seen.append)
                    quiet = not sm.bus.has_subscribers(Topics.POSE_STATE)
                    if quiet:
                        torch.cuda.set_sync_debug_mode("error")
                    try:
                        state = sm.step()
                    finally:
                        torch.cuda.set_sync_debug_mode("default")
                    if tick in (100, 200):
                        # read back after the timed run; the step graph's
                        # next replay overwrites its outputs
                        flushed[tick] = tenv.clone_state(state)
                torch.cuda.synchronize()
                windows.append(1e3 * (time.perf_counter() - t0) / SIM_WINDOW)
        finally:
            sm.close()
        draws_by_path["sim_manager"] = jax_normal.launches
        return sm, windows, flushed, seen, rollout_25d_cuda.launches, edt_minplus_cuda.launches

    sm, windows, flushed, seen, sim_k1, sim_k2 = drive_sim_manager()
    sim_draws = draws_by_path["sim_manager"]
    teleported = sm.robots.pose(flushed[100].rovers, "husky_1")
    reset = sm.robots.pose(flushed[200].rovers, "husky_0")
    sim_finite = all(bool(torch.isfinite(t).all()) for t in sm.state.rovers + sm.state.ctrl)
    med = float(np.median(windows))
    pose_ok = (np.array_equal(teleported[0], np.float32(SIM_TELEPORT))
               and np.array_equal(reset[0], np.float32(START))
               and len(seen) == 10 and all(m["positions"].shape == (SIM_SLOTS, 2) for m in seen))
    phase("sim_manager", slots=SIM_SLOTS, robots=len(sm.robots.names), K=K, H=H,
          ticks=SIM_TICKS, k1_launches=sim_k1, k1_expected=2 * SIM_TICKS, k2_launches=sim_k2,
          ms_per_sim_step={"min": min(windows), "median": med, "max": max(windows),
                           "spread": (max(windows) - min(windows)) / med,
                           "windows": windows, "window_ticks": SIM_WINDOW},
          teleported_slot_pose={"position": teleported[0].tolist(), "z": teleported[1],
                                "heading": teleported[2].tolist()},
          reset_slot_position=reset[0].tolist(), pose_messages=len(seen),
          final_positions=sm.state.rovers.position.tolist(), finite=sim_finite,
          card_vs_cpu_ticks=SIM_CHECK, card_vs_cpu_max_abs_diff=sim_diffs,
          card_vs_cpu_free_running_max_abs_diff=sim_free_diffs, card_vs_cpu_ok=sim_ok)
    if not (sim_ok and sim_finite and pose_ok):
        raise RuntimeError("the simulation manager on the card disagrees with the CPU's, left a "
                           "non-finite state or did not apply its bus requests")
    #     graph_sim_manager: the same ticks and bus edits with the step eager
    sm_e, windows_e, flushed_e, seen_e, sim_k1_e, _ = drive_sim_manager(sim_tick)
    equal = (_same(sm.state, sm_e.state) and all(_same(flushed[t], flushed_e[t]) for t in flushed)
             and all(np.array_equal(a["positions"], b["positions"]) for a, b in zip(seen, seen_e)))
    ok = equal and sim_k1_e == sim_k1 and sm.step_fn.replays == SIM_TICKS - 1
    phase("graph_sim_manager", slots=SIM_SLOTS, ticks=SIM_TICKS, graph_equals_eager=equal,
          teleport_and_reset_reach_the_graph=pose_ok and equal,
          ms_per_sim_step_eager=float(np.median(windows_e)), ms_per_sim_step_graph=med,
          capture_ms=sm.step_fn.capture_ms, replays=sm.step_fn.replays,
          k1_launches_graph=sim_k1, k1_launches_eager=sim_k1_e, ok=ok)
    if not ok:
        raise RuntimeError("the graphed simulation manager differs from the eager one")
    del sm_e
    if sim_k1 != 2 * SIM_TICKS:
        raise RuntimeError(f"K1 ran {sim_k1} times in {SIM_TICKS} simulation-manager ticks")
    draws_by_path["sim_manager"] = sim_draws  # the graphed run's: a draw and a split a tick
    if sim_draws != 2 * SIM_TICKS:
        raise RuntimeError(f"jax_normal ran {sim_draws} times in {SIM_TICKS} ticks")

    # 7e. MPPIController (the reference controller's surface) on the flagship:
    #     step(noise=) bit-equal to mppi_step, then run() (-45, -40) -> (45,
    #     40), its noise from the controller's seed stream (not goal_seek's:
    #     its loop count is its own), one host sync a loop
    check = MPPIController(cfg, hf, cm, GOAL, seed=42)
    r0 = RobotState.create(*START, HEADING, device=cuda)
    c0 = ControllerState.create(cfg, device=cuda)
    got = check.step(r0, c0, noise.to(cuda))
    want = mppi_step(cfg, hf, cm, goal, r0, c0, noise.to(cuda))
    ctl_step_equal = all(torch.equal(a, b) for a, b in zip(got[0] + got[1][:-1],
                                                           want[0] + want[1][:-1]))
    ctl = MPPIController(cfg, hf, cm, GOAL, seed=42)
    torch.cuda.synchronize()
    rollout_25d_cuda.launches = edt_minplus_cuda.launches = gp.gather_probe_cuda.launches = 0
    jax_normal.launches = 0
    t0 = time.perf_counter()
    final, _, ctl_path = ctl.run(r0, max_loops=3500)
    torch.cuda.synchronize()
    ctl_wall = time.perf_counter() - t0
    ctl_k1 = rollout_25d_cuda.launches
    draws_by_path["mppi_controller"] = jax_normal.launches
    ix, iy = costmap_cells(ctl_path, cm)
    ctl_cost = grid_lookup(cm.cost, ix, iy)
    ctl_reached = bool((torch.abs(final.position - goal) <= 0.5).all())
    ctl_finite = bool(torch.isfinite(ctl_path).all())
    ctl_collisions = int((ctl_cost > 0.99).sum())
    phase("mppi_controller", reached=ctl_reached, loops=ctl.loop, k1_launches=ctl_k1,
          k1_expected=2 * ctl.loop, collisions=ctl_collisions,
          max_path_cost=ctl_cost.max().item(), final_position=final.position.tolist(),
          wall_s=ctl_wall, ms_per_loop=1e3 * ctl_wall / max(ctl.loop, 1),
          step_equals_mppi_step=ctl_step_equal, finite=ctl_finite)
    if not (ctl_step_equal and ctl_finite and ctl_reached and ctl_collisions == 0):
        raise RuntimeError("MPPIController.step differs from mppi_step on the card, or its run "
                           "did not reach the goal cleanly")
    if ctl_k1 != 2 * ctl.loop or ctl_k1 == 0:
        raise RuntimeError(f"K1 ran {ctl_k1} times in {ctl.loop} controller loops")
    if draws_by_path["mppi_controller"] != ctl.loop:
        raise RuntimeError(f"jax_normal ran {draws_by_path['mppi_controller']} times in "
                           f"{ctl.loop} controller loops")
    #     graph_mppi_controller: the same run with step_fn = mppi_step (eager)
    ctl_e = MPPIController(cfg, hf, cm, GOAL, seed=42)
    ctl_e.step_fn = mppi_step
    torch.cuda.synchronize()
    rollout_25d_cuda.launches = 0
    t0 = time.perf_counter()
    final_e, _, path_e = ctl_e.run(r0, max_loops=3500)
    torch.cuda.synchronize()
    ctl_wall_e = time.perf_counter() - t0
    equal = (ctl_e.loop == ctl.loop and torch.equal(path_e, ctl_path) and _same(final_e, final))
    ok = equal and rollout_25d_cuda.launches == ctl_k1 and ctl.step_fn.replays == ctl.loop - 1
    phase("graph_mppi_controller", K=K, H=H, loops_graph=ctl.loop, loops_eager=ctl_e.loop,
          graph_equals_eager=equal, ms_per_loop_eager=1e3 * ctl_wall_e / max(ctl_e.loop, 1),
          ms_per_loop_graph=1e3 * ctl_wall / max(ctl.loop, 1),
          capture_ms=ctl.step_fn.capture_ms, replays=ctl.step_fn.replays,
          k1_launches_graph=ctl_k1, k1_launches_eager=rollout_25d_cuda.launches, ok=ok)
    if not ok:
        raise RuntimeError("the graphed MPPIController run differs from the eager one")

    # 7f. the sharded step on torch.distributed ranks, each its own process
    #     on the card (K=1000 x H=100, the flagship world): one NCCL rank,
    #     bit-equal to mppi_step; two gloo ranks sharing the card (500
    #     samples each; costs and weights equal to mppi_step's rows, the
    #     optimal inputs within SHARD_U_ATOL, the optimal rollout within
    #     1e-3); the multi-rover step of the 4 closed-loop rovers on meshes
    #     (2, 1) and (1, 2) against one-rover mppi_step (costs equal: a
    #     sample's cost does not depend on its shard; the rest at phase 6b's
    #     batched tolerances); and scaling_sweep([1, 2]) with its report (the ranks
    #     share one card: no scaling claim)
    ctrl_rovers = ControllerState(torch.zeros((ROVERS, H)), torch.zeros((ROVERS, H)),
                                  torch.full((ROVERS,), 0.25), torch.full((ROVERS,), 0.25))
    head = torch.tensor(HEADING) / torch.linalg.norm(torch.tensor(HEADING))
    robots_rovers = RobotState(torch.tensor(starts, dtype=torch.float32), torch.zeros(ROVERS),
                               head.repeat(ROVERS, 1), torch.zeros(ROVERS), torch.zeros(ROVERS))
    shard_job = dict(hf=hf_cpu, costmap=cm_cpu, goal=torch.tensor(GOAL),
                     robot=RobotState(*(t.cpu() for t in r0)),
                     ctrl=ControllerState(*(t.cpu() for t in c0)), noise=noise,
                     goals=torch.tensor(goals_np, dtype=torch.float32), robots=robots_rovers,
                     ctrls=ctrl_rovers, rover_noise=cl_noise)
    sample_case = {"kind": "sample", "config": cfg}
    BUILD.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD) as tmp:
        report_path = Path(tmp) / "scaling.json"
        t0 = time.perf_counter()
        (one,), = run_ranks({**shard_job, "cases": [sample_case]}, 1, Path(tmp) / "one",
                            backend="nccl", device="cuda", timeout_s=300)
        one_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        two = run_ranks({**shard_job, "cases": [
            sample_case,
            {"kind": "multi_rover", "config": cfg, "mesh": (2, 1)},
            {"kind": "multi_rover", "config": cfg, "mesh": (1, 2)},
            {"kind": "sweep", "config": cfg, "counts": [1, 2], "iters": 10,
             "report": str(report_path),
             "note": "2 gloo ranks sharing one card: a check that the sweep runs"}]},
            2, Path(tmp) / "two", backend="gloo", device="cuda", timeout_s=400)
        two_s = time.perf_counter() - t0
        report = json.loads(report_path.read_text())
    ref_ctrl, ref_out = (type(part)(*(t.cpu() if t is not None else None for t in part))
                         for part in mppi_step(cfg, hf, cm, goal, r0, c0, noise.to(cuda)))
    one_equal = all(torch.equal(a, b) for a, b in zip(one["ctrl"] + one["out"][:-1],
                                                      ref_ctrl + ref_out[:-1]))
    shards = [r[0] for r in two]
    two_costs_equal = torch.equal(torch.cat([s["out"].costs for s in shards]), ref_out.costs)
    two_weights_equal = torch.equal(torch.cat([s["out"].weights for s in shards]),
                                    ref_out.weights)
    two_diff = {"optimal_u": max((a - b).abs().max().item() for s in shards
                                 for a, b in zip(s["ctrl"][:2], ref_ctrl[:2])),
                "optimal_trajectory": max((s["out"].optimal_trajectory
                                           - ref_out.optimal_trajectory).abs().max().item()
                                          for s in shards)}
    two_ok = (two_costs_equal and two_weights_equal and two_diff["optimal_u"] <= SHARD_U_ATOL
              and two_diff["optimal_trajectory"] <= 1e-3)
    rover_ref = [mppi_step(cfg, hf, cm, goals_d[n],
                           RobotState(*(t[n].to(cuda) for t in robots_rovers)),
                           ControllerState(*(t[n].to(cuda) for t in ctrl_rovers)), noise_d[n])[1]
                 for n in range(ROVERS)]
    multi = {}
    for case, mesh_shape in ((1, (2, 1)), (2, (1, 2))):
        rs, ss = mesh_shape
        diff = {"costs": 0.0, "weights": 0.0, "optimal_trajectory": 0.0, "linear_velocity": 0.0}
        for n in range(ROVERS):
            ranks = [(n // (ROVERS // rs)) * ss + j for j in range(ss)]
            local = n % (ROVERS // rs)
            outs = [two[r][case]["out"] for r in ranks]
            for f in ("costs", "weights"):
                got = torch.cat([getattr(o, f)[local] for o in outs])
                diff[f] = max(diff[f], (got - getattr(rover_ref[n], f).cpu()).abs().max().item())
            for f in ("optimal_trajectory", "linear_velocity"):
                diff[f] = max(diff[f], max((getattr(o, f)[local]
                                            - getattr(rover_ref[n], f).cpu()).abs().max().item()
                                           for o in outs))
        multi[f"{rs}x{ss}"] = diff
    v_ref = max(abs(o.linear_velocity.item()) for o in rover_ref)
    multi_ok = all(d["costs"] == 0.0 and d["weights"] <= 1e-3
                   and d["optimal_trajectory"] <= 1e-3 and d["linear_velocity"] <= 1e-5 + 1e-4 * v_ref for d in multi.values())
    shard_k1 = [one["k1_launches"]] + [s["k1_launches"] for s in shards]
    sweep_ok = (sorted(report["results"]) == ["1", "2"]
                and "no scaling claim" in report["devices"].get("shared_device", ""))
    phase("sharded_step", K=K, H=H, one_rank_nccl_bit_equal=one_equal,
          two_ranks_gloo={"samples_per_rank": K // 2, "costs_equal": two_costs_equal,
                          "weights_equal": two_weights_equal, "max_abs_diff": two_diff,
                          "optimal_u_atol": SHARD_U_ATOL},
          multi_rover_max_abs_diff=multi, k1_launches_per_rank=shard_k1,
          sweep=report["results"], sweep_devices=report["devices"],
          launch_seconds={"one_rank": one_s, "two_ranks": two_s})
    if not (one_equal and two_ok and multi_ok and sweep_ok):
        raise RuntimeError("a sharded step on the card disagrees with mppi_step")
    if shard_k1 != [2, 2, 2]:
        raise RuntimeError(f"the sharded step's ranks launched K1 {shard_k1} times, not twice each")

    # 7g. graft_entry_torch.py, the counterpart of __graft_entry__.py:
    #     entry()'s step (K=1000 x H=100 on its 256^2 crater world) on the
    #     card with K1's launches counted (2: the samples and the optimal
    #     rollout), each K1 call held against the plain rollout on its inputs
    #     bit for bit, as k1_vs_plain holds it; the script itself in its own
    #     process (it prints "entry OK"); and dryrun_multichip(2), the
    #     sharded multi-rover step on a (2, 1) mesh of two gloo ranks sharing
    #     the card, every rover held against mppi_step by the function
    jax_normal.launches = 0
    entry_fn, entry_args = graft_entry_torch.entry()  # draws its noise from key(0)
    draws_by_path["graft_entry"] = jax_normal.launches
    k1_calls = []

    def k1_recorded(hf_, pos, head, lin, ang, dt, wheels=True):
        got = rollout_25d_cuda(hf_, pos, head, lin, ang, dt, wheels=wheels)
        k1_calls.append(((hf_, pos, head, lin, ang, dt), wheels, got))
        return got

    torch.cuda.synchronize()
    rollout_25d_cuda.launches = 0
    with mock.patch.object(rollout_cuda_module, "rollout_25d_cuda", k1_recorded):
        entry_ctrl, entry_out = entry_fn(*entry_args)
    torch.cuda.synchronize()
    entry_k1 = rollout_25d_cuda.launches
    entry_equal, entry_err = True, 0.0
    for (hf_, pos, head, lin, ang, dt), wheels, got in k1_calls:
        want = rollout_25d(hf_, pos[..., None, :], head[..., None, :], lin, ang, dt,
                           wheels=wheels)
        entry_equal = entry_equal and all(torch.equal(a, b) for a, b in zip(got, want))
        entry_err = max([entry_err] + [(a - b).abs().max().item() for a, b in zip(got, want)])
    entry_ms = cuda_ms(lambda: entry_fn(*entry_args), reps=5)
    t0 = time.perf_counter()
    script = subprocess.run([sys.executable, str(Path(__file__).resolve().parent
                                                 / "graft_entry_torch.py")],
                            capture_output=True, text=True, timeout=300)
    script_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dryrun = graft_entry_torch.dryrun_multichip(2, device=cuda)
    dryrun_s = time.perf_counter() - t0
    entry_ok = (entry_equal and entry_k1 == 2 and len(k1_calls) == 2
                and bool(torch.isfinite(entry_out.costs).all())
                and all(bool(torch.isfinite(t).all()) for t in entry_ctrl)
                and script.returncode == 0 and script.stdout.strip().splitlines()[-1:] == [
                    "entry OK"]
                and dryrun["mesh"] == [2, 1] and dryrun["k1_launches_per_rank"] == [2, 2])
    phase("graft_entry", K=K, H=H, k1_launches=entry_k1, k1_calls_bit_equal_to_plain=entry_equal,
          max_abs_err=entry_err, step_ms=entry_ms, script_returncode=script.returncode,
          script_stdout=script.stdout.strip()[-200:], script_seconds=script_s,
          dryrun_multichip=dryrun, dryrun_seconds=dryrun_s, ok=entry_ok)
    if not entry_ok:
        raise RuntimeError("graft_entry_torch.py: the entry step's K1 calls differ from the "
                           f"plain rollout, K1 ran {entry_k1} times, the script failed "
                           f"({script.stderr[-2000:]}), or the dry run is wrong")

    # 8. the thesis statistics DEM, built twice on the card: bit-equal
    t0 = time.perf_counter()
    dems = [thesis_statistics_terrain(device=cuda) for _ in range(2)]
    torch.cuda.synchronize()
    dem_equal = torch.equal(*dems)
    phase("thesis_world", dem=list(dems[0].shape), seconds_two_builds=time.perf_counter() - t0,
          bit_equal=dem_equal, finite=bool(torch.isfinite(dems[0]).all()),
          z_min=dems[0].min().item(), z_max=dems[0].max().item())
    if not dem_equal:
        raise RuntimeError("two builds of the thesis DEM on the card differ")
    del dems

    # 8b. JAX's world draws (core.jax_random) on the card: the thesis DEM's
    #     base-noise grids at z = 0.7 and bench_torch.py's 4096 vec-env
    #     starts drawn on the card, torch.equal to the same draws on the CPU
    #     (float64 grids reported beside them); the seed-42 thesis DEM at
    #     z = 0.7 built on the card and on the CPU, each DEM's statistics
    #     EVAL_r05.json's at its printed digits (the JAX package's terrain),
    #     the two DEMs torch.equal; the default moonyard DEM (the SDG yard)
    #     on the card torch.equal to the CPU's (the render's float32
    #     arithmetic is XLA's on both, core/xla_math.py)
    thesis_conf = BaseTerrainGeneratorConf(x_size=150.0, y_size=150.0, resolution=0.1,
                                           max_elevation=1.2 * DRIVER_Z_SCALE,
                                           min_elevation=-1.2 * DRIVER_Z_SCALE, seed=42)

    def world_draws(dev, dtype=torch.float32):
        k = jr.split(jr.key(42, dev))[1]  # MoonyardGenerator's first randomize
        grids = draw_base_noise(k, thesis_conf, dtype=dtype)
        starts = jr.uniform(jr.key(0, dev), (VEC_ROVERS, 2), dtype, -50.0, 50.0)
        return [t.cpu() for t in (*grids, starts)]

    draws_card, draws_cpu = world_draws(cuda), world_draws(cpu)
    draws_equal = all(torch.equal(a, b) for a, b in zip(draws_card, draws_cpu))
    draws64_equal = all(torch.equal(a, b) for a, b in zip(world_draws(cuda, torch.float64),
                                                         world_draws(cpu, torch.float64)))
    jax_stats = json.loads((Path(__file__).resolve().parent / "EVAL_r05.json").read_text())[
        "terrain_stats"]
    crater_block_cuda.launches = 0
    t0 = time.perf_counter()
    thesis_dems = {dev.type: thesis_statistics_terrain(
        seed=42, z_scale=DRIVER_Z_SCALE, max_elevation=1.2 * DRIVER_Z_SCALE,
        min_elevation=-1.2 * DRIVER_Z_SCALE, device=dev).cpu() for dev in (cuda, cpu)}
    thesis_s = time.perf_counter() - t0
    stats = {d: {"z_scale": DRIVER_Z_SCALE, **thesis_runs.terrain_statistics(z.numpy())}
             for d, z in thesis_dems.items()}
    thesis_err = (thesis_dems["cuda"] - thesis_dems["cpu"]).abs().max().item()
    thesis_equal = torch.equal(thesis_dems["cuda"], thesis_dems["cpu"])
    yard = {dev.type: MoonyardGenerator(MoonyardConf(), device=dev).randomize().cpu()
            for dev in (cuda, cpu)}
    jax_random_stamps = crater_block_cuda.launches
    yard_err = (yard["cuda"] - yard["cpu"]).abs().max().item()
    yard_equal = torch.equal(yard["cuda"], yard["cpu"])
    jax_random_ok = (draws_equal and stats["cuda"] == stats["cpu"] == jax_stats
                     and thesis_equal and yard_equal and jax_random_stamps > 0)
    phase("jax_random", draws=[list(t.shape) for t in draws_card], draws_equal_card_cpu=draws_equal,
          float64_draws_equal_card_cpu=draws64_equal, terrain_stats_card=stats["cuda"],
          terrain_stats_cpu=stats["cpu"], terrain_stats_eval_r05=jax_stats,
          thesis_dem_equal_card_cpu=thesis_equal, thesis_dem_max_abs_diff_card_cpu=thesis_err,
          thesis_dem_builds_seconds=thesis_s, yard_dem=list(yard["cuda"].shape),
          yard_dem_equal_card_cpu=yard_equal, yard_dem_max_abs_diff_card_cpu=yard_err,
          crater_block_launches=jax_random_stamps, ok=jax_random_ok)
    if not jax_random_ok:
        raise RuntimeError("JAX's world draws or DEMs differ between the card and the CPU, or "
                           "the thesis DEM's statistics are not EVAL_r05.json's")
    del thesis_dems, yard

    # 9. the thesis 2D-vs-3D evaluation protocol at full width: K1 for the 3D
    #    arm's samples and both arms' optimal rollouts, the planar rollout
    #    kernel for the 2D arm's samples, K2 for the costmap; each arm
    #    replays its graph of 4 masked steps. Every run's trace is kept for
    #    graph_evaluation
    eval_logs = {"graph": [], "eager": []}
    run_episode_fn = evaluation._run_episode

    def logged(into):
        def run(config, *args, **kw):
            out = run_episode_fn(config, *args, **kw)
            into.append((config.projection,) + out)
            return out
        return run

    torch.cuda.synchronize()
    rollout_25d_cuda.launches = edt_minplus_cuda.launches = rollout_2d_cuda.launches = 0
    jax_normal.launches = 0
    t0 = time.perf_counter()
    with mock.patch.object(evaluation, "_run_episode", logged(eval_logs["graph"])):
        table = run_thesis_protocol_experiment(ks=(K,), runs_per_arm=1, horizon=H,
                                               max_loops=EVAL_MAX_LOOPS, half_width=75.0,
                                               device=cuda)
    eval_s = time.perf_counter() - t0
    eval_k1, eval_k2 = rollout_25d_cuda.launches, edt_minplus_cuda.launches
    draws_by_path["evaluation"] = jax_normal.launches
    eval_r2 = rollout_2d_cuda.launches
    arms = table["per_k"][K]["arms"]
    for proj, arm in arms.items():
        loops = arm["mean_loops"] * table["config"]["runs_per_arm"]
        phase("evaluation", arm=proj, K=K, H=H, dem=[1500, 1500], costmap=[1500, 1500],
              max_loops=EVAL_MAX_LOOPS,
              reached=table["config"]["runs_per_arm"] - arm["failed"],
              completed=arm["completed"], collided=arm["collided"], failed=arm["failed"],
              mean_loops=arm["mean_loops"], steps=arm["steps"], finite=arm["finite"],
              wall_s=arm["wall_s"], episode_s=arm["episode_s"],
              ms_per_loop=1e3 * arm["wall_s"] / max(loops, 1),
              ms_per_step_in_episodes=1e3 * arm["episode_s"] / max(arm["steps"], 1))
    want_k1 = 2 * arms["3d"]["steps"] + arms["2d"]["steps"]
    phase("evaluation_launches", k1_launches=eval_k1, k1_expected=want_k1,
          rollout_2d_launches=eval_r2, rollout_2d_expected=arms["2d"]["steps"],
          k2_launches=eval_k2, seconds=eval_s, critics=table["per_k"][K]["critics"])
    if not all(arm["finite"] for arm in arms.values()):
        raise RuntimeError("the evaluation recorded a non-finite trace")
    if eval_k2 == 0:
        raise RuntimeError("the evaluation's costmap build never launched K2")
    if eval_k1 != want_k1:
        raise RuntimeError(f"K1 ran {eval_k1} times in the evaluation, not {want_k1}")
    if eval_r2 != arms["2d"]["steps"] or eval_r2 == 0:
        raise RuntimeError(f"the planar rollout kernel ran {eval_r2} times in the evaluation, "
                           f"not once per 2D step ({arms['2d']['steps']})")
    #     graph_evaluation: the same protocol with each arm's masked steps
    #     eager: every run's trace (loops, reached, positions, velocities,
    #     steps) equal per arm
    torch.cuda.synchronize()
    rollout_25d_cuda.launches = rollout_2d_cuda.launches = 0
    with mock.patch.object(evaluation, "_run_episode", logged(eval_logs["eager"])), \
            mock.patch.object(evaluation, "Graphed", lambda fn: fn):
        table_e = run_thesis_protocol_experiment(ks=(K,), runs_per_arm=1, horizon=H,
                                                 max_loops=EVAL_MAX_LOOPS, half_width=75.0,
                                                 device=cuda)
    arms_e = table_e["per_k"][K]["arms"]
    per_arm = {}
    for proj in ("3d", "2d"):
        g = [r[1:] for r in eval_logs["graph"] if r[0] == proj]
        e = [r[1:] for r in eval_logs["eager"] if r[0] == proj]
        same = len(g) == len(e) > 0 and all(
            a[:2] == b[:2] and a[4] == b[4] and np.array_equal(a[2], b[2])
            and np.array_equal(a[3], b[3]) for a, b in zip(g, e))
        loops_arm = arms[proj]["mean_loops"] * table["config"]["runs_per_arm"]
        per_arm[proj] = {"graph_equals_eager": same, "loops": loops_arm,
                         "ms_per_loop_graph": 1e3 * arms[proj]["wall_s"] / max(loops_arm, 1),
                         "ms_per_loop_eager": 1e3 * arms_e[proj]["wall_s"] / max(loops_arm, 1)}
    equal = all(a["graph_equals_eager"] for a in per_arm.values())
    ok = (equal and rollout_25d_cuda.launches == eval_k1
          and rollout_2d_cuda.launches == eval_r2)
    phase("graph_evaluation", K=K, H=H, max_loops=EVAL_MAX_LOOPS, arms=per_arm,
          graph_equals_eager=equal, k1_launches_graph=eval_k1,
          k1_launches_eager=rollout_25d_cuda.launches, rollout_2d_launches_graph=eval_r2,
          rollout_2d_launches_eager=rollout_2d_cuda.launches, ok=ok)
    if not ok:
        raise RuntimeError("a graphed evaluation arm differs from the eager one")
    del eval_logs, table_e

    #     the 2D arm's graph on the planar rollout kernel and on the plain
    #     rollout_2d it replaced (the graph then holds its ~2,500 ops a
    #     step), in turns plain, kernel, kernel, plain: ms per loop and
    #     graph nodes per loop, the two traces equal. The thesis world, the
    #     protocol's first 2D run for ARM_2D_LOOPS loops
    thesis_z = thesis_statistics_terrain(device=cuda)
    thesis_world = (HeightField.create(thesis_z, 75.0),
                    costmap_750(half_width=75.0, size=1500, use_exact_edt=True, device=cuda))
    start2d, goal2d, head2d = evaluation.thesis_pairs(1, 75.0, 42)[0]
    cfg2d_arm = MPPIConfig(num_samples=K, horizon=H, projection="2d",
                           critic_weights=CriticWeights(slope_wheels=35.5), sigma_base=0.3,
                           slope_critic="body")

    def plain_2d(self, hf_, p, h_, lin, ang, dt):
        """The wrapper's call on the plain rollout_2d (patched over
        CudaRollout2d.__call__, so that the graphs still count the wrapper's
        launches: none)."""
        return rollout_2d(hf_, p[..., None, :], h_[..., None, :], lin, ang, dt)

    def arm_2d(route):
        """The 2D arm's graph on ``route`` ("kernel" or "plain"): one
        episode to warm up and capture, then the same episode timed (graph
        replays only)."""
        graph = Graphed(masked_steps)
        ctx = (mock.patch.object(r2_module.CudaRollout2d, "__call__", plain_2d)
               if route == "plain" else contextlib.nullcontext())
        with ctx:
            for timed in (False, True):
                rollout_2d_cuda.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trace = goal_seek_recorded(
                    cfg2d_arm, *thesis_world,
                    torch.tensor(goal2d, dtype=torch.float32, device=cuda),
                    RobotState.create(*start2d, head2d, device=cuda, wheel_speed=1.0),
                    ControllerState.create(cfg2d_arm, device=cuda, initial_u=1.0),
                    jr.key(42000, cuda), max_loops=ARM_2D_LOOPS,
                    steps_fn=graph)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        return trace, {"route": route, "ms_per_loop": 1e3 * wall / max(int(trace.loops), 1),
                       "loops": int(trace.loops), "steps": trace.steps,
                       "rollout_2d_launches": rollout_2d_cuda.launches,
                       "capture_ms": graph.capture_ms}

    arm_runs = [arm_2d(route) for route in ("plain", "kernel", "kernel", "plain")]
    arm_equal = all(_same(arm_runs[0][0], r[0]) for r in arm_runs[1:])
    arm_ok = arm_equal and all(
        r["rollout_2d_launches"] == (r["steps"] if r["route"] == "kernel" else 0)
        for _, r in arm_runs)
    phase("evaluation_2d_arm_graph", K=K, H=H, loops=ARM_2D_LOOPS, start=list(start2d),
          runs=[r for _, r in arm_runs], traces_equal=arm_equal, ok=arm_ok)
    if not arm_ok:
        raise RuntimeError("the 2D arm's graph on the planar rollout kernel differs from the "
                           "graph on the plain rollout_2d")
    del arm_runs, thesis_world, thesis_z

    #     the thesis drivers (mppi/thesis_runs.py, the bodies of
    #     scripts/torch_run_*.py) at DRIVER_RUNS runs per arm, one K and
    #     one terrain scale, the full loop cap: each table's summary, its
    #     launches, and its record of the card
    def driver_arms(name, table_d):
        """(every arm's steps and finite flags, the table's summary)."""
        if name == "eval_experiment":
            rows = [{a: {"steps": v["steps"][a], "finite": v["finite"][a]} for a in ("3d", "2d")}
                    for v in table_d["per_k"].values()]
            return rows, {k: v["collisions"] for k, v in table_d["per_k"].items()}
        if name == "eval_r05_calib":
            return ([e["arms"] for e in table_d["sweep"]],
                    [e["collision_free_pct"] for e in table_d["sweep"]])
        rows = [v["arms"] for v in table_d["per_k"].values()]
        rows += [v["arms"] for k_, v in table_d.get("ablation", {}).items() if k_ != "question"]
        return rows, thesis_runs.arm_summary(table_d["per_k"])

    drivers = {
        "thesis_eval": lambda: thesis_runs.thesis_eval(DRIVER_RUNS, ks=(K,), ablation_k=K),
        "eval_r05_calib": lambda: thesis_runs.eval_r05_calib(z_scales=(DRIVER_Z_SCALE,), k=K,
                                                             runs_per_arm=DRIVER_RUNS),
        "eval_r05_full": lambda: thesis_runs.eval_r05_full(DRIVER_Z_SCALE, DRIVER_RUNS,
                                                           ks=(K,)),
        "eval_experiment": lambda: thesis_runs.eval_experiment(DRIVER_RUNS, ks=(K,)),
    }
    driver_counts = {}
    for name, driver in drivers.items():
        torch.cuda.synchronize()
        rollout_25d_cuda.launches = edt_minplus_cuda.launches = rollout_2d_cuda.launches = 0
        jax_normal.launches = 0
        t0 = time.perf_counter()
        table_d = driver()
        wall = time.perf_counter() - t0
        draws_by_path[f"thesis_drivers_{name}"] = jax_normal.launches
        counts = {"k1": rollout_25d_cuda.launches, "rollout_2d": rollout_2d_cuda.launches,
                  "k2": edt_minplus_cuda.launches}
        rows, summary = driver_arms(name, table_d)
        steps = {a: sum(r[a]["steps"] for r in rows) for a in ("3d", "2d")}
        finite = all(r[a]["finite"] for r in rows for a in ("3d", "2d"))
        config = table_d["config"]
        ok = (finite and counts["rollout_2d"] == steps["2d"] > 0
              and counts["k1"] == 2 * steps["3d"] + steps["2d"]
              and config["kernel_routes"] == {"rollout_3d": "cuda", "rollout_2d": "cuda"}
              and "NVIDIA" in config["device"]["name"])
        driver_counts[name] = counts["rollout_2d"]
        phase("thesis_drivers", driver=name, runs_per_arm=DRIVER_RUNS, K=K,
              z_scale=DRIVER_Z_SCALE if name.startswith("eval_r05") else None,
              summary=summary, steps=steps, launches=counts, device=config["device"],
              kernel_routes=config["kernel_routes"], wall_s=wall, finite=finite, ok=ok)
        if not ok:
            raise RuntimeError(f"the thesis driver {name} failed on the card")

    # 10. K3's path: the probe entry point (python -m ...ops.gather_probe)
    gp.gather_probe_cuda.launches = 0
    probe_rc = gp.main(["device=cuda"])
    k3_launches = gp.gather_probe_cuda.launches
    phase("gather_probe", rc=probe_rc, k3_launches=k3_launches)
    if probe_rc != 0 or k3_launches != 1:
        raise RuntimeError(f"the gather probe returned {probe_rc} with {k3_launches} launches")

    # 10b. the CLI as run.py runs it (its composed cfg/ tree): mode=sdg,
    #      the yard goal-seek and the lab's closed loop
    sdg_counts, yard_k1_row, yard_counts, lab_counts, sdg_capture, sdg_graphed = cli_timed()

    # 11. the streamed-terrain slice: the world, K1 and K2 at its sizes, the
    #     traverse
    ls_loop, ls_k1_row, ls_k2_row, ls_counts, stamp_row, stamp_counts, taps_row = (
        largescale_timed())
    # the kernel line's launches: the default streamed path (the CLI's
    # pipelined traverse); every path's count under launches_by_path
    ls_k1, ls_k2 = ls_counts["largescale_pipelined"]

    # 11b. bench: bench_torch.py's measurement in this process (what
    #      `python3 bench_torch.py` prints), its line printed as it is; it
    #      fails on a missing or extra key and on a traverse that did not
    #      reach its goal. Its launches go to the kernel line's
    #      launches_by_path
    torch.cuda.synchronize()
    rollout_25d_cuda.launches = edt_minplus_cuda.launches = crater_block_cuda.launches = 0
    jax_normal.launches = 0
    t0 = time.perf_counter()
    bench_line = bench_torch.measure(cuda)
    torch.cuda.synchronize()
    bench_s = time.perf_counter() - t0
    bench_counts = {"k1": rollout_25d_cuda.launches, "k2": edt_minplus_cuda.launches,
                    "stamp": crater_block_cuda.launches, "draws": jax_normal.launches}
    print(json.dumps(bench_line), flush=True)
    detail = bench_line["detail"]
    keys_ok = (set(detail) == bench_torch.DETAIL_KEYS
               and set(detail["largescale_streamed"]) == bench_torch.LARGESCALE_KEYS)
    reached = detail["largescale_streamed"]["reached"]
    ok = keys_ok and reached and all(bench_counts[k] > 0 for k in ("k1", "k2", "stamp", "draws"))
    phase("bench", seconds=bench_s, keys_ok=keys_ok, reached=reached,
          value=bench_line["value"], launches=bench_counts, ok=ok)
    if not ok:
        raise RuntimeError("bench_torch.py's line lacks a key or has one too many, or its "
                           "traverse did not reach the goal")

    # 12. device kernels of one control step (flagship shapes) and of one
    #     closed-loop step (N=4), counted by torch.profiler (it fails if the
    #     profiler records no kernel), with the torch operators each
    #     dispatches beside them. A K1 call is one kernel and dispatches no
    #     torch operator but the output's empty (views aside)
    #     torch.profiler runs only from here on, so that no timed path runs
    #     in a process it has traced: every timed path is above this line
    robot = RobotState.create(*START, HEADING, device=cuda)
    ctrl = ControllerState.create(cfg, device=cuda)
    goal, noise_d = torch.tensor(GOAL, device=cuda), noise.to(cuda)

    def control_step():
        _, out = mppi_step(cfg, hf, cm, goal, robot, ctrl, noise_d)
        kinematic_advance(cfg, robot, out)

    cl_state = tenv.init_loop_state(cl_cfg, tenv.RoverState.create(starts, [1.0, 0.0, 0.0], hf))
    step_key = jr.key(42, cuda)

    def control_step_drawn():  # the goal-seek's step: the draw and its split, then the step
        noise_k, _ = jax_normal(step_key, (2, K, H), path=SPLIT_SUB, next_path=SPLIT_NEXT)
        _, out = mppi_step(cfg, hf, cm, goal, robot, ctrl, noise_k)
        kinematic_advance(cfg, robot, out)

    def loop_step_keyed():  # run_episode's step: its noise drawn from its key
        tenv.closed_loop_step(cl_cfg, hf, cm, goals_d, cl_state, step_key)

    counts = {}
    for name, fn in (("control_step", control_step),
                     ("control_step_with_draw", control_step_drawn),
                     ("closed_loop_step_with_draw", loop_step_keyed)):
        fn()
        kernels = device_kernels(fn)  # calls fn once per profiler session
        before, draws_before = rollout_25d_cuda.launches, jax_normal.launches
        with OpLog() as log:
            fn()
        k1_launches = rollout_25d_cuda.launches - before
        counts[name] = {"device_kernels": kernels, "torch_ops": len(log.device_ops),
                        "k1_launches": k1_launches,
                        "jax_normal_launches": jax_normal.launches - draws_before}
    lin = torch.rand((K, H), generator=gen, device=cuda)
    k1_call = lambda: rollout_25d_cuda(hf, robot.position, robot.heading, lin, lin, DT)  # noqa: E731
    with OpLog() as log:
        k1_call()
    k1_ops = [str(f) for f in log.device_ops]
    k1_kernels = device_kernels(k1_call)
    ok = (k1_ops == ["aten.empty.memory_format"] and k1_kernels == 1
          and counts["control_step"]["device_kernels"] <= 210
          and all(c["k1_launches"] == 2 for c in counts.values())
          and counts["control_step_with_draw"]["jax_normal_launches"] == 1
          and counts["closed_loop_step_with_draw"]["jax_normal_launches"] == 1)
    phase("step_launches", K=K, H=H, N_closed_loop=ROVERS, k1_call_torch_ops=k1_ops,
          k1_call_device_kernels=k1_kernels, **counts, ok=ok)
    if not ok:
        raise RuntimeError("a control step runs more kernels than it should, or a K1 call "
                           "issues other device operations")

    # 12b. graph_launches: the device kernels and the host's launch calls
    #      of each graphed path, one graph replay against the same work run
    #      eagerly, per control loop, sim step or chunk (torch.profiler;
    #      every timed path is above)
    rec = (torch.zeros((3501, 3), device=cuda), torch.zeros((3501,), device=cuda))

    def seek_args(c, steps):
        return (c, 3500, hf, cm, goal, robot, ControllerState.create(c, device=cuda),
                torch.zeros((), dtype=torch.int64, device=cuda),
                torch.zeros((), dtype=torch.bool, device=cuda), *rec, jr.key(42, cuda), steps)

    cfg2d = MPPIConfig(num_samples=K, horizon=H, projection="2d")
    chunk_state, chunk_goal = ls_loop._initial_state(), ls_loop._goal_ctrl()
    cl_state4 = tenv.init_loop_state(cl_cfg, tenv.RoverState.create(starts, [1.0, 0.0, 0.0], hf))
    def masked_steps_plain_2d(*args):
        """The 2D arm's steps with the plain rollout_2d in place of the
        planar rollout kernel, as before the kernel."""
        with mock.patch.object(r2_module.CudaRollout2d, "__call__", plain_2d):
            return masked_steps(*args)

    paths = {  # name: (eager call, graphed function, its arguments, loops per call)
        "goal_seek": (masked_steps, seek_args(cfg, 4), 4),
        # one step: the profiler drops a few of a 4-step graph's ~47,000
        # device records per session, so no two sessions agree on a count
        "evaluation_2d_arm": (masked_steps, seek_args(cfg2d, 1), 1),
        "evaluation_2d_arm_plain_rollout": (masked_steps_plain_2d, seek_args(cfg2d, 1), 1),
        "mppi_controller": (mppi_step, (cfg, hf, cm, goal, robot, ctrl, noise_d), 1),
        "closed_loop": (tenv.closed_loop_step,
                        (cl_cfg, hf, cm, goals_d, cl_state4, jr.key(0, cuda), ()), 1),
        "chunk": (run_chunk, (ls_loop.conf, ls_loop.hf, ls_loop.costmap, ls_loop.origin(),
                              chunk_state, chunk_goal, jr.key(42, cuda),
                              torch.zeros((), dtype=torch.int64, device=cuda)), 1),
    }
    graph_counts = {}
    for name, (fn, args, per) in paths.items():
        g = Graphed(fn)
        g(*args)
        g(*args)  # the warm-up, then the capture and a replay
        row = {}
        for kind, call in (("eager", lambda: fn(*args)), ("graph", lambda: g(*args))):
            call()
            row[f"device_kernels_{kind}"] = device_kernels(call) / per
            row[f"launch_calls_{kind}"] = {k: v / per for k, v in launch_calls(call).items()}
        graph_counts[name] = row
    ok = all(r["launch_calls_graph"].get("cudaGraphLaunch", 0) > 0
             and r["device_kernels_graph"] > 0 for r in graph_counts.values())
    phase("graph_launches", K=K, H=H, per="control loop, sim step or chunk",
          **graph_counts, ok=ok)
    if not ok:
        raise RuntimeError("a graph replay launched no graph, or the profiler saw none of "
                           "its kernels")

    # 13-14. the streamed slice's chunk under the profiler, and a shift
    ls_k1_edge = largescale_profiled(ls_loop)

    # 15. device kernels of one SDG frame (every timed path is above)
    sdg_profiled(sdg_capture, sdg_graphed)

    # The kernel table. K1's and K2's times, bounds and plain times are at
    # the streamed loop's shapes (the 7000^2 window, the 875^2 costmap), with
    # the earlier paths' shapes beside them; `launches` is the streamed
    # traverse's count, the other paths' counts stand in `launches_by_path`
    ls_k1_err = max(max_err, ls_k1_row.pop("max_abs_err"), ls_k1_edge.pop("max_abs_err"),
                    yard_k1_row.pop("max_abs_err"))
    ls_k2_err = max(k2_err, ls_k2_row.pop("max_abs_err"))
    print(json.dumps({"kernels": [{
        "name": "rollout_25d", "route": "cuda",
        "source": "husky_rover_mppi_isaacsim_torch/csrc/rollout.cu",
        "replaces": "husky_rover_mppi_isaacsim_tpu/ops/rollout_pallas.py:57",
        "launches": ls_k1, "max_abs_err": ls_k1_err, "library_ms": None, **ls_k1_row,
        "shape": "K=1000 x H=100, wheels, DEM 7000 x 7000",
        "edge_after_shift": ls_k1_edge, "dem_1500": k1_row,
        "dem_4000_moonyard": yard_k1_row,
        # "optimal": the bench loops' K=1 x H=64 rollout
        "bench_16384": {"K": BENCH_K, "H": BENCH_H, "dem": [1500, 1500], **k1_bench},
        "launches_by_path": {**{k: v[0] for k, v in ls_counts.items()}, "goal_seek": launches,
                             "closed_loop": cl_k1, "evaluation": eval_k1,
                             "moonyard_standalone": yard_counts["k1"],
                             "moonyard_closed_loop": lab_counts["k1"],
                             "sim_manager": sim_k1, "mppi_controller": ctl_k1,
                             "sharded_step_per_rank": shard_k1, "bench": bench_counts["k1"],
                             "graft_entry": entry_k1,
                             "dryrun_multichip_per_rank": dryrun["k1_launches_per_rank"],
                             **{f"sdg_{r}": c["k1"] for r, c in sdg_counts.items()}},
    }, {
        "name": "edt_minplus", "route": "cuda",
        "source": "husky_rover_mppi_isaacsim_torch/csrc/edt_minplus.cu",
        "replaces": "husky_rover_mppi_isaacsim_tpu/ops/edt_pallas.py:31",
        "launches": ls_k2, "max_abs_err": ls_k2_err, "library_ms": None, **ls_k2_row,
        "shape": "875 x 875", "map_1500": k2_row,
        "launches_by_path": {**{k: v[1] for k, v in ls_counts.items()}, "world": world_k2,
                             "evaluation": eval_k2, "bench": bench_counts["k2"]},
    }, {
        "name": "gather_probe", "route": "cuda",
        "source": "husky_rover_mppi_isaacsim_torch/csrc/gather_probe.cu",
        "replaces": "scripts/probe_pallas_gather.py:21",
        "launches": k3_launches, "max_abs_err": k3_err, **k3_row,
    }, {
        "name": "rollout_2d", "route": "cuda",
        "source": "husky_rover_mppi_isaacsim_torch/csrc/rollout_2d.cu",
        "replaces": None,
        "replaces_note": ("the port's own kernel for the compiled lax.scan of "
                          "husky_rover_mppi_isaacsim_tpu/mppi/rollout.py:254-297 (rollout_2d, "
                          "inside the jitted goal-seek loop); no Pallas kernel there"),
        "launches": eval_r2, "max_abs_err": r2_err, "library_ms": None, **r2_row,
        "shape": "K=1000 x H=100, thesis DEM 1500 x 1500", "cases": r2_rows,
        "launches_by_path": {"evaluation": eval_r2,
                             **{f"thesis_drivers_{k}": v for k, v in driver_counts.items()}},
    }, {
        "name": "crater_block", "route": "cuda",
        "source": "husky_rover_mppi_isaacsim_torch/csrc/crater_block.cu",
        "replaces": None,
        "replaces_note": ("the port's own kernel for the one jitted program of "
                          "husky_rover_mppi_isaacsim_tpu/terrain/craters.py:227-296 "
                          "(render_crater_block: a lax.scan that renders each chunk's patches "
                          "and scans dynamic_update_slice adds); no Pallas kernel there"),
        "launches": stamp_counts["largescale_pipelined"], **stamp_row,
        "launches_by_path": {**stamp_counts,
                             **{f"sdg_{r}": c["stamp"] for r, c in sdg_counts.items()},
                             "moonyard_standalone": yard_counts["stamp"],
                             "moonyard_closed_loop": lab_counts["stamp"],
                             "bench": bench_counts["stamp"], "jax_random": jax_random_stamps},
    }, {
        "name": "upsample_taps", "route": "cuda",
        "source": "husky_rover_mppi_isaacsim_torch/csrc/upsample_taps.cu",
        "replaces": None,
        "replaces_note": ("the port's own kernel for the two dots (einsum nf,nfw->nw) of the "
                          "JAX package's jitted upsample_bicubic, husky_rover_mppi_isaacsim_tpu/"
                          "terrain/upsample.py:36-58, and the block's slice of it "
                          "(terrain/streaming.py build_block), in XLA's CPU order; no Pallas "
                          "kernel there"),
        "launches": taps_by_path["largescale_pipelined"], **taps_row,
        "launches_by_path": taps_by_path,
    }, {
        "name": "jax_normal", "route": "cuda",
        "source": "husky_rover_mppi_isaacsim_torch/csrc/jax_normal.cu",
        "replaces": None,
        "replaces_note": ("the port's own kernel for the jax.random.normal that XLA fuses into "
                          "the JAX package's jitted loops (husky_rover_mppi_isaacsim_tpu/mppi/"
                          "sampling.py:75-78, env/rover_sim.py:99-101): threefry, XLA's "
                          "erf_inv, the key's split or fold-in; no Pallas kernel there"),
        "launches": gs_draws, **jax_normal_row,
        "shape": "(2, 1000, 100) float32, key, sub = split(key)",
        "library_note": "none: no torch call draws JAX's stream; randn_ms (torch.randn at "
                        "the same shape) is for scale only",
        "library_ms": None,
        "launches_by_path": {"goal_seek": gs_draws, **draws_by_path,
                             "moonyard_standalone": yard_counts["draws"],
                             "moonyard_closed_loop": lab_counts["draws"],
                             "bench": bench_counts["draws"]},
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
