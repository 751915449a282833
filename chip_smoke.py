"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds kernels K1 (husky_rover_mppi_isaacsim_torch/csrc/rollout.cu), K2
(csrc/edt_minplus.cu) and K3 (csrc/gather_probe.cu) from the sources, one
nvcc each, started together; holds each against its plain PyTorch version on
the card (K1 within 5e-4, its rover axis bit-equal to one-rover launches;
K2 and K3 bit-equal); builds the standalone world on the card (its costmap
through K2); checks one control step and one N=4 closed-loop step on the
card against the same steps on the CPU; drives the flagship goal-seek
(K=1000 x H=100, (-45, -40) -> (45, 40) on the 150 m crater map with the
750-obstacle costmap), the CLI's default closed loop (4 rovers, 300 sim
steps, the same world and widths) and 4096 simulated rovers for 400 physics
steps; runs the thesis 2D-vs-3D evaluation protocol at full width
(K=1000 x H=100, 1500^2 DEM and 1500^2 costmap, one run per arm, at most
EVAL_MAX_LOOPS loops), with the eager 2D rollout that bounds its 2D arm
timed alone; and runs K3's probe entry point. Each path runs with the
kernels' launch counts set to 0 just before it and read just after. Each
phase prints one line; any failure raises and the exit code is not 0. The
last two lines are the kernel table and the result, as JSON. Needs one
CUDA card; without one it exits with code 1 and prints no result.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

K, H, DT = 1000, 100, 0.045
START, GOAL, HEADING = (-45.0, -40.0), (45.0, 40.0), (1.0, 0.5, 0.0)
REPS = 7
# Control-loop cap of each evaluation run, below the protocol's 3500: the 2D
# arm's eager rollout_2d is host-bound, ~140 ms per loop at K=1000 x H=100
# on an H100 80GB HBM3 at 700 W, so 700 loops keep the phase near 100 s.
EVAL_MAX_LOOPS = 700
ROVERS, SIM_STEPS = 4, 300          # the CLI's closed-loop defaults
VEC_ROVERS, VEC_STEPS = 4096, 400   # bench.py's vec-env shapes


def cuda_ms(torch, fn, reps=REPS, inner=1):
    """Median over ``reps`` of the CUDA-event time of ``inner`` calls, per call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def phase(label, **fields):
    print(json.dumps({"phase": label, **fields}), flush=True)


def ptxas_lines(built):
    return [ln.strip() for ln in built.log.splitlines() if "registers" in ln or "spill" in ln]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only", file=sys.stderr)
        return 1

    from husky_rover_mppi_isaacsim_torch import env as tenv
    from husky_rover_mppi_isaacsim_torch.cli import (
        build_standalone_world,
        closed_loop_config,
        closed_loop_episode,
        spawn_points,
        use_full_fp32_matmul,
    )
    from husky_rover_mppi_isaacsim_torch.core import HeightField, grid_lookup
    from husky_rover_mppi_isaacsim_torch.mppi import (
        ControllerState,
        MPPIConfig,
        RobotState,
        goal_seek_recorded,
        mppi_step,
    )
    from husky_rover_mppi_isaacsim_torch.mppi.critics import costmap_cells
    from husky_rover_mppi_isaacsim_torch.mppi.evaluation import run_thesis_protocol_experiment
    from husky_rover_mppi_isaacsim_torch.mppi.rollout import (
        rollout_2d,
        rollout_25d,
        start_heading,
    )
    from husky_rover_mppi_isaacsim_torch.ops.edt import (
        edt_exact_sq,
        edt_exact_sq_plain,
        minplus_envelope,
        normalize_minmax,
        row_distances_sq,
    )
    from husky_rover_mppi_isaacsim_torch.ops import gather_probe as gp
    from husky_rover_mppi_isaacsim_torch.ops.edt_cuda import edt_minplus_cuda
    from husky_rover_mppi_isaacsim_torch.ops.rollout_cuda import rollout_25d_cuda
    from husky_rover_mppi_isaacsim_torch.terrain import (
        STANDALONE_CRATER_BUMPS,
        costmap_750,
        crater_surface,
        generate_obstacles,
        rasterize_obstacles,
        thesis_statistics_terrain,
    )

    cuda, cpu = torch.device("cuda"), torch.device("cpu")

    # 1. the card, and full-float32 matmuls
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    use_full_fp32_matmul()
    phase("device", name=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
          torch=torch.__version__, cuda=torch.version.cuda,
          matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
          cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
          float32_matmul_precision=torch.get_float32_matmul_precision())

    # 2. build K1, K2 and K3 from the sources, one nvcc each, started together
    t0 = time.perf_counter()
    wrappers = (rollout_25d_cuda, edt_minplus_cuda, gp.gather_probe_cuda)
    with ThreadPoolExecutor(len(wrappers)) as pool:
        builds = list(pool.map(lambda w: w.load(), wrappers))
    seconds = round(time.perf_counter() - t0, 3)
    for name, built in zip(("rollout25d_f32", "edt_minplus_f32", "gather_probe_f32"), builds):
        phase("build", kernel=name, seconds=seconds, nvcc_seconds=round(built.seconds, 3),
              library=built.path.name, ptxas=ptxas_lines(built))

    # 3. K1 against its plain version on the card: the flagship DEM and shapes
    hw = 75.0
    hf = HeightField.create(crater_surface(1500, hw, STANDALONE_CRATER_BUMPS, device=cuda), hw)
    pos = torch.tensor(START, device=cuda)
    heading = torch.tensor(HEADING, device=cuda)
    heading = heading / torch.linalg.norm(heading)
    gen = torch.Generator(device=cuda).manual_seed(0)
    max_err, k1_ms, plain_ms = 0.0, None, None
    for k, wheels in ((K, True), (K, False), (1, False)):
        lin = torch.rand((k, H), generator=gen, device=cuda) * 2.0
        ang = torch.rand((k, H), generator=gen, device=cuda) * 2.0 - 1.0
        args = (hf, pos, heading, lin, ang, DT)
        got = rollout_25d_cuda(*args, wheels=wheels)
        want = rollout_25d(*args, wheels=wheels)
        torch.cuda.synchronize()
        err = max((a - b).abs().max().item() for a, b in zip(got[:2], want[:2]))
        wheel_err, wheel_same = 0.0, 1.0
        if wheels:
            wheel_err = max((a[..., :2] - b[..., :2]).abs().max().item()
                            for a, b in zip(got[2:], want[2:]))
            wheel_same = min((a[..., 2] == b[..., 2]).float().mean().item()
                             for a, b in zip(got[2:], want[2:]))
        ok = err <= 5e-4 and wheel_err <= 5e-4 and wheel_same >= 0.98
        # the kernel alone (prepared inputs, back-to-back launches), the
        # wrapper call with its torch pre-ops, and the plain version
        head0 = start_heading(hf, pos, heading).contiguous()
        lin_t, ang_t = lin.t().contiguous(), ang.t().contiguous()
        out = torch.empty((12 if wheels else 6, H, k), device=cuda)
        t_k1 = cuda_ms(torch, lambda: rollout_25d_cuda.launch(hf, pos, head0, lin_t, ang_t,
                                                              out, DT), inner=20)
        t_call = cuda_ms(torch, lambda: rollout_25d_cuda(*args, wheels=wheels), inner=20)
        t_plain = cuda_ms(torch, lambda: rollout_25d(*args, wheels=wheels))
        phase("k1_vs_plain", K=k, H=H, wheels=wheels, max_abs_err=err,
              wheel_xy_max_abs_err=wheel_err, wheel_z_bit_equal=wheel_same,
              k1_ms=t_k1, k1_call_ms=t_call, plain_ms=t_plain, ok=ok)
        if not ok:
            raise RuntimeError(f"K1 disagrees with its plain version at K={k}, wheels={wheels}")
        max_err = max(max_err, err, wheel_err)
        if k == K and wheels:
            k1_ms, plain_ms = t_k1, t_plain

    # K1's rover axis: N rovers in one launch against N one-rover launches
    # (bit-equal: a rover's threads run the one-rover code) and against the
    # plain batched rollout (5e-4, as above)
    pos_n = torch.tensor(spawn_points(42, ROVERS, 75.0)[0], dtype=torch.float32, device=cuda)
    head_n = torch.rand((ROVERS, 3), generator=gen, device=cuda) - 0.5
    head_n[:, 2] = 0.0
    for k, wheels in ((K, True), (K, False), (1, False)):
        lin = torch.rand((ROVERS, k, H), generator=gen, device=cuda) * 2.0
        ang = torch.rand((ROVERS, k, H), generator=gen, device=cuda) * 2.0 - 1.0
        args = (hf, pos_n, head_n, lin, ang, DT)
        got = rollout_25d_cuda(*args, wheels=wheels)
        ones = [rollout_25d_cuda(hf, pos_n[n], head_n[n], lin[n], ang[n], DT, wheels=wheels)
                for n in range(ROVERS)]
        want = rollout_25d(hf, pos_n[:, None], head_n[:, None], lin, ang, DT, wheels=wheels)
        torch.cuda.synchronize()
        bit_equal = all(torch.equal(a[n], b) for n, one in enumerate(ones)
                        for a, b in zip(got, one))
        err = max((a - b).abs().max().item() for a, b in zip(got[:2], want[:2]))
        head0 = start_heading(hf, pos_n, head_n).contiguous()
        lin_t, ang_t = lin.transpose(1, 2).contiguous(), ang.transpose(1, 2).contiguous()
        out = torch.empty((12 if wheels else 6, ROVERS, H, k), device=cuda)
        t_batched = cuda_ms(torch, lambda: rollout_25d_cuda.launch(hf, pos_n, head0, lin_t,
                                                                   ang_t, out, DT), inner=20)
        one_args = [(pos_n[n].contiguous(), head0[n].contiguous(), lin_t[n], ang_t[n],
                     torch.empty((12 if wheels else 6, H, k), device=cuda))
                    for n in range(ROVERS)]

        def one_rover_launches():
            for p, h0, lt, at, o in one_args:
                rollout_25d_cuda.launch(hf, p, h0, lt, at, o, DT)

        t_ones = cuda_ms(torch, one_rover_launches, inner=5)
        t_plain = cuda_ms(torch, lambda: rollout_25d(hf, pos_n[:, None], head_n[:, None], lin,
                                                     ang, DT, wheels=wheels), reps=3)
        ok = bit_equal and err <= 5e-4
        phase("k1_batched", N=ROVERS, K=k, H=H, wheels=wheels, bit_equal_to_one_rover=bit_equal,
              max_abs_err_vs_plain=err, k1_batched_ms=t_batched,
              k1_one_rover_launches_ms=t_ones, plain_batched_ms=t_plain, ok=ok)
        if not ok:
            raise RuntimeError(f"K1's rover axis is wrong at K={k}, wheels={wheels}")

    # the eager plain 2D rollout of the evaluation's 2D arm, at its shape
    lin = torch.rand((K, H), generator=gen, device=cuda) * 2.0
    ang = torch.rand((K, H), generator=gen, device=cuda) * 2.0 - 1.0
    phase("rollout_2d_plain", K=K, H=H,
          ms=cuda_ms(torch, lambda: rollout_2d(hf, pos, heading, lin, ang, DT)))

    # 4. K2 against its plain version on the card, bit for bit: the
    #    standalone and thesis occupancies, a random non-square map, and an
    #    obstacle-free map (the _BIG sentinel)
    def occupancy(size):
        raster = rasterize_obstacles(generate_obstacles(), half_width=75.0, size=size,
                                     robot_radius=0.3)
        return torch.from_numpy(raster == 0)

    rand_occ = torch.rand((187, 875), generator=gen, device=cuda) < 0.02
    maps = {"standalone_750": occupancy(750).to(cuda), "thesis_1500": occupancy(1500).to(cuda),
            "random_187x875": rand_occ, "free_750": torch.zeros((750, 750), dtype=torch.bool,
                                                                device=cuda)}
    k2_ms, k2_plain_ms, k2_err = None, None, 0.0
    for name, occ in maps.items():
        got, want = edt_exact_sq(occ), edt_exact_sq_plain(occ)
        equal = torch.equal(got, want)
        err = (got - want).abs().max().item()
        g2 = row_distances_sq(occ)
        out = torch.empty_like(g2)
        t_k2 = cuda_ms(torch, lambda: edt_minplus_cuda.launch(g2, out))
        t_plain = cuda_ms(torch, lambda: minplus_envelope(g2))
        phase("k2_vs_plain", map=name, shape=list(occ.shape), bit_equal=equal, max_abs_err=err,
              k2_ms=t_k2, plain_ms=t_plain)
        if not equal:
            raise RuntimeError(f"K2 disagrees with its plain version on {name}")
        k2_err = max(k2_err, err)
        if name == "thesis_1500":
            k2_ms, k2_plain_ms = t_k2, t_plain

    # K3 against its three plain formulations on the card, bit for bit, at
    # the probe's shapes: the probe's table and a random one
    table, idx_i, idx_j = gp.probe_inputs(cuda)
    rand_table = torch.randn((gp.P, gp.P), generator=gen, device=cuda)
    k3_ms, k3_plain_ms, k3_err = None, None, 0.0
    for name, tab in (("arange", table), ("random", rand_table)):
        got = gp.gather_probe_cuda(tab, idx_i, idx_j)
        plains = {f: fn(tab, idx_i, idx_j) for f, fn in gp.FORMULATIONS.items()}
        equal = {f: torch.equal(got, want) for f, want in plains.items()}
        k3_err = max([k3_err] + [(got - want).abs().max().item() for want in plains.values()])
        out = torch.empty((gp.K,), device=cuda)
        t_k3 = cuda_ms(torch, lambda: gp.gather_probe_cuda.launch(tab, idx_i, idx_j, out),
                       inner=20)
        plain = {f: cuda_ms(torch, lambda: fn(tab, idx_i, idx_j), inner=20)
                 for f, fn in gp.FORMULATIONS.items()}
        phase("k3_vs_plain", table=name, shape=[gp.P, gp.P], lanes=gp.K, bit_equal=equal,
              k3_ms=t_k3, plain_ms=plain)
        if not all(equal.values()):
            raise RuntimeError(f"K3 disagrees with a plain formulation on the {name} table")
        if name == "arange":
            k3_ms, k3_plain_ms = t_k3, plain["flat torch.take"]

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

    def costmap_seconds(size, plain):
        t0 = time.perf_counter()
        if plain:  # distance_costmap's steps, with the plain envelope
            occ = occupancy(size).to(cuda)
            d = torch.sqrt(edt_exact_sq_plain(occ))
            (1.0 - normalize_minmax(d)) ** 20.0
        else:
            costmap_750(size=size, device=cuda)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    costmap_s = {f"{size}": {"k2": [], "plain": []} for size in (750, 1500)}
    for size in (750, 1500):
        for kind in ("plain", "k2", "k2", "plain"):
            costmap_s[f"{size}"][kind].append(costmap_seconds(size, kind == "plain"))
    phase("world", dem=list(hf.z.shape), costmap=list(cm.cost.shape), seconds=round(world_s, 3),
          k2_launches=world_k2, edt_card_equals_cpu=edt_equal, finite=finite,
          cost_min=cm.cost.min().item(), cost_max=cm.cost.max().item(),
          costmap_build_s=costmap_s)
    if not (edt_equal and finite):
        raise RuntimeError("world build on the card is wrong")
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
    #     launches, no host sync) and on the CPU, same noise; then rover n of
    #     the batched control step against a one-rover step on the card
    cl_cfg = closed_loop_config({})
    starts, goals_np = spawn_points(42, ROVERS, hw)
    cl_noise = torch.randn((ROVERS, 2, K, H), generator=torch.Generator().manual_seed(3))
    track = cl_cfg.mppi.robot_radius

    def loop_step_on(dev):
        hf_d = HeightField(*(t.to(dev) for t in hf))
        cm_d = type(cm)(*(t.to(dev) for t in cm))
        state = tenv.init_loop_state(cl_cfg, tenv.RoverState.create(starts, [1.0, 0.0, 0.0],
                                                                   hf_d))
        goals = torch.tensor(goals_np, dtype=torch.float32, device=dev)
        noise = cl_noise.to(dev)
        if dev != cuda:
            return tenv.closed_loop_step(cl_cfg, hf_d, cm_d, goals, state, noise=noise)
        torch.cuda.synchronize()
        before = rollout_25d_cuda.launches
        torch.cuda.set_sync_debug_mode("error")  # a host sync inside the step raises
        try:
            out = tenv.closed_loop_step(cl_cfg, hf_d, cm_d, goals, state, noise=noise)
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

    # 7. the flagship goal-seek, through K1
    robot = RobotState.create(*START, HEADING, device=cuda)
    ctrl = ControllerState.create(cfg, device=cuda)
    goal = torch.tensor(GOAL, device=cuda)
    gen = torch.Generator(device=cuda).manual_seed(42)
    torch.cuda.synchronize()
    rollout_25d_cuda.launches = edt_minplus_cuda.launches = 0
    t0 = time.perf_counter()
    res = goal_seek_recorded(cfg, hf, cm, goal, robot, ctrl, gen, max_loops=3500)
    loops = int(res.loops)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = rollout_25d_cuda.launches
    path = res.positions[:loops]
    ix, iy = costmap_cells(path, cm)
    path_cost = grid_lookup(cm.cost, ix, iy)
    collisions = int((path_cost > 0.99).sum())
    finite = bool(torch.isfinite(path).all())
    final = res.robot.position.tolist()
    phase("goal_seek", reached=bool(res.reached), loops=loops, steps=res.steps,
          k1_launches=launches, collisions=collisions, max_path_cost=path_cost.max().item(),
          final_position=final, wall_s=wall, ms_per_loop=1e3 * wall / max(loops, 1))
    if not (bool(res.reached) and collisions == 0 and finite):
        raise RuntimeError("the flagship goal-seek did not reach its goal cleanly")
    if launches != 2 * res.steps or launches == 0:
        raise RuntimeError(f"K1 ran {launches} times for {res.steps} control steps")

    # 7b. the CLI's default closed loop (python -m ...cli mode=closed_loop):
    #     4 rovers, K=1000 x H=100, 300 sim steps on its own standalone world,
    #     two K1 launches per step
    torch.cuda.synchronize()
    rollout_25d_cuda.launches = edt_minplus_cuda.launches = gp.gather_probe_cuda.launches = 0
    run = closed_loop_episode({})
    cl_k1, cl_k2 = rollout_25d_cuda.launches, edt_minplus_cuda.launches
    cl_finite = bool(torch.isfinite(run.path).all())
    mean_progress = float(run.progress.mean())
    phase("closed_loop", N=len(run.progress), K=K, H=H, steps=SIM_STEPS,
          k1_launches=cl_k1, k1_expected=2 * SIM_STEPS, k2_launches=cl_k2, finite=cl_finite,
          mean_progress_m=mean_progress, progress_m=run.progress.tolist(), wall_s=run.wall_s,
          sim_steps_per_s=SIM_STEPS / run.wall_s, ms_per_sim_step=1e3 * run.wall_s / SIM_STEPS)
    if len(run.progress) != ROVERS or cl_k1 != 2 * SIM_STEPS:
        raise RuntimeError(f"K1 ran {cl_k1} times in {SIM_STEPS} closed-loop steps "
                           f"of {len(run.progress)} rovers")
    if not (cl_finite and mean_progress > 0.0):
        raise RuntimeError("the closed loop made no progress or left a non-finite path")

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

    # 9. the thesis 2D-vs-3D evaluation protocol at full width: K1 for the 3D
    #    arm's samples and both arms' optimal rollouts, K2 for the costmap
    torch.cuda.synchronize()
    rollout_25d_cuda.launches = edt_minplus_cuda.launches = 0
    t0 = time.perf_counter()
    table = run_thesis_protocol_experiment(ks=(K,), runs_per_arm=1, horizon=H,
                                           max_loops=EVAL_MAX_LOOPS, half_width=75.0,
                                           device=cuda)
    eval_s = time.perf_counter() - t0
    eval_k1, eval_k2 = rollout_25d_cuda.launches, edt_minplus_cuda.launches
    arms = table["per_k"][K]["arms"]
    for proj, arm in arms.items():
        loops = arm["mean_loops"] * table["config"]["runs_per_arm"]
        phase("evaluation", arm=proj, K=K, H=H, dem=[1500, 1500], costmap=[1500, 1500],
              max_loops=EVAL_MAX_LOOPS,
              reached=table["config"]["runs_per_arm"] - arm["failed"],
              completed=arm["completed"], collided=arm["collided"], failed=arm["failed"],
              mean_loops=arm["mean_loops"], steps=arm["steps"], finite=arm["finite"],
              wall_s=arm["wall_s"], ms_per_loop=1e3 * arm["wall_s"] / max(loops, 1))
    want_k1 = 2 * arms["3d"]["steps"] + arms["2d"]["steps"]
    phase("evaluation_launches", k1_launches=eval_k1, k1_expected=want_k1,
          k2_launches=eval_k2, seconds=eval_s, critics=table["per_k"][K]["critics"])
    if not all(arm["finite"] for arm in arms.values()):
        raise RuntimeError("the evaluation recorded a non-finite trace")
    if eval_k2 == 0:
        raise RuntimeError("the evaluation's costmap build never launched K2")
    if eval_k1 != want_k1:
        raise RuntimeError(f"K1 ran {eval_k1} times in the evaluation, not {want_k1}")

    # 10. K3's path: the probe entry point (python -m ...ops.gather_probe)
    gp.gather_probe_cuda.launches = 0
    probe_rc = gp.main(["device=cuda"])
    k3_launches = gp.gather_probe_cuda.launches
    phase("gather_probe", rc=probe_rc, k3_launches=k3_launches)
    if probe_rc != 0 or k3_launches != 1:
        raise RuntimeError(f"the gather probe returned {probe_rc} with {k3_launches} launches")

    print(json.dumps({"kernels": [{
        "name": "rollout_25d", "route": "cuda",
        "source": "husky_rover_mppi_isaacsim_torch/csrc/rollout.cu",
        "replaces": "husky_rover_mppi_isaacsim_tpu/ops/rollout_pallas.py:57",
        "launches": launches, "max_abs_err": max_err, "ms": k1_ms, "plain_ms": plain_ms,
    }, {
        "name": "edt_minplus", "route": "cuda",
        "source": "husky_rover_mppi_isaacsim_torch/csrc/edt_minplus.cu",
        "replaces": "husky_rover_mppi_isaacsim_tpu/ops/edt_pallas.py:31",
        "launches": eval_k2, "max_abs_err": k2_err, "ms": k2_ms, "plain_ms": k2_plain_ms,
    }, {
        "name": "gather_probe", "route": "cuda",
        "source": "husky_rover_mppi_isaacsim_torch/csrc/gather_probe.cu",
        "replaces": "scripts/probe_pallas_gather.py:21",
        "launches": k3_launches, "max_abs_err": k3_err, "ms": k3_ms, "plain_ms": k3_plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
