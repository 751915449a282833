"""PyTorch port on the card: kernels K1 (csrc/rollout.cu, one rover and N
rovers), K2 (csrc/edt_minplus.cu) and K3 (csrc/gather_probe.cu) bit-equal to
their plain versions, a K1 call as one launch and no other device operator,
the kernels of one control step, the control step and the closed-loop step
on the card against the same steps on the CPU, the thesis DEM's repeatable
build, the evaluation's kernel launches, and the streamed loop's sizes: K1 on
a 7000 x 7000 DEM, K2 at 875 x 875, a small streamed traverse (pipelined,
its worker on a side stream), and the wheel-track deformation stamp; the
CLI's slice: K1 on the 4000 x 4000 yard DEM, an SDG capture on the card
against the CPU's; the simulation manager's ticks on the card against the
CPU's, ``MPPIController.step`` and the one-rank sharded step bit-equal to
``mppi_step`` on the card; the last host libraries: the streamer's tile
pool route on the card (no host sync, its bases equal to the CPU's) and a
worldbuilders request on the card against the CPU; the CUDA graphs of the
loops against their eager runs (bench_torch.py's K=16384 x H=64 control
loops and its 4096-rover vec env among them); the crater block kernel
(csrc/crater_block.cu) bit-equal to its plain version (render, then the
slice-add stamp) at the streamed tiers' shapes, for overlapping craters,
in a streamed window and on an SDG yard field, its device copies of XLA's
and glibc's functions (csrc/xla_math.cuh) against their plain versions on
the card and the CPU, and its wrapper's refusals; the block upsample
kernel (csrc/upsample_taps.cu: both passes, only the crop) against its
plain version at the streamed block's crop, crops inside a GEMV tile and
across its tails, one launch a block, and its refusals; the SDG frame's two graphs
against the eager labeler, and a graph's in-place argument; the planar
rollout kernel (csrc/rollout_2d.cu) bit-equal to the plain ``rollout_2d``
(one rover and N rovers, on and off the thesis DEM, K from 1 to 1000 by
horizons from 1 to 256, start headings at the edges of its fast
arithmetic's range and a zero planar heading), one launch per call
and per 2D control step, its cosf / sinf against torch's, the thesis
drivers (mppi/thesis_runs.py) at a small size on the card, JAX's world
draws (core/jax_random.py) on the card equal to the CPU's,
graft_entry_torch.py's entry step and dry run on the card, and the
jax_normal kernel (csrc/jax_normal.cu) ``torch.equal`` to its plain version
(core/jax_random.py's ``normal`` of ``derive``) at the loops' shapes, with
a split, a fold-in from a device scalar and a count offset, its key
sequence in a graph, and its wrapper's refusals.

Every test here is marked ``gpu`` and skips without a CUDA card. The file
imports no jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

import contextlib

import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch.cli import use_full_fp32_matmul
from husky_rover_mppi_isaacsim_torch.core import HeightField
from husky_rover_mppi_isaacsim_torch import env as tenv
from husky_rover_mppi_isaacsim_torch.dynamics import skid_steer
from husky_rover_mppi_isaacsim_torch.mppi import (
    ControllerState,
    MPPIConfig,
    RobotState,
    kinematic_advance,
    mppi_step,
)
from husky_rover_mppi_isaacsim_torch.mppi import evaluation
from husky_rover_mppi_isaacsim_torch.mppi import rollout as tro
from husky_rover_mppi_isaacsim_torch.ops import edt
from husky_rover_mppi_isaacsim_torch.ops import gather_probe as gp
from husky_rover_mppi_isaacsim_torch.ops import measure
from husky_rover_mppi_isaacsim_torch.core import jax_random as jr
from husky_rover_mppi_isaacsim_torch.ops.edt_cuda import edt_minplus_cuda
from husky_rover_mppi_isaacsim_torch.ops.jax_normal_cuda import (
    SPLIT_NEXT,
    SPLIT_SUB,
    jax_normal,
)
from husky_rover_mppi_isaacsim_torch.ops.rollout_2d_cuda import rollout_2d_cuda
from husky_rover_mppi_isaacsim_torch.ops.rollout_cuda import rollout_25d_cuda
from husky_rover_mppi_isaacsim_torch.terrain import (
    STANDALONE_CRATER_BUMPS,
    as_costmap,
    crater_surface,
    generate_obstacles,
    rasterize_obstacles,
    thesis_statistics_terrain,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: kernels K1, K2 and K3 have no CPU mode")
    use_full_fp32_matmul()
    return torch.device("cuda")


def _crater(device, grid=1500, hw=75.0):
    return HeightField.create(crater_surface(grid, hw, STANDALONE_CRATER_BUMPS,
                                             device=device), hw)


# (rovers, samples, horizon, wheels, start off the DEM): the flagship's and
# the closed loop's launches, ragged shapes whose velocity slices are not
# 16-byte aligned (K = 33, H = 37), and bench_torch.py's large batch (K =
# 16384 x H = 64: 512 blocks, 12 or 6 x 64 x 16384 floats out) with its
# optimal rollout (K = 1 x H = 64)
K1_CASES = [(1, 1000, 100, True, False), (1, 1000, 100, False, False), (1, 1, 100, False, False),
            (4, 1000, 100, True, False), (4, 1, 100, False, False), (1, 33, 37, True, False),
            (4, 33, 37, False, False), (1, 33, 37, True, True), (4, 1000, 100, True, True),
            (1, 16384, 64, True, False), (1, 16384, 64, False, False), (1, 1, 64, False, False)]


@pytest.mark.parametrize("n,k,h,wheels,off_map", K1_CASES)
def test_k1_kernel_matches_plain_on_card(cuda, n, k, h, wheels, off_map):
    """Every channel bit-equal to the plain rollout, in one launch. Off the
    DEM the start cell and the first steps read wrap-then-clamp cells."""
    hf = _crater(cuda)
    g = torch.Generator(device=cuda).manual_seed(k + h)
    lin = torch.rand((n, k, h), generator=g, device=cuda) * 2.0
    ang = torch.rand((n, k, h), generator=g, device=cuda) * 2.0 - 1.0
    pos = torch.rand((n, 2), generator=g, device=cuda) * 80.0 - 40.0
    if off_map:  # beyond the 75 m half width, near the (-75, 75) corner
        pos = pos / 40.0 + torch.tensor([-78.0, 77.0], device=cuda)
    heading = torch.rand((n, 3), generator=g, device=cuda) - 0.5
    if n == 1:
        lin, ang, pos, heading = lin[0], ang[0], pos[0], heading[0]
    before = rollout_25d_cuda.launches
    got = rollout_25d_cuda(hf, pos, heading, lin, ang, 0.045, wheels=wheels)
    torch.cuda.synchronize()
    assert rollout_25d_cuda.launches == before + 1
    want = tro.rollout_25d(hf, pos[..., None, :], heading[..., None, :], lin, ang, 0.045,
                           wheels=wheels)
    for a, b in zip(got, want):
        assert a.shape == lin.shape + (3,)
        assert torch.equal(a, b)
    if not wheels:
        assert got.left_wheel is got.trajectory


def test_k1_fast_arithmetic_is_ieee_on_card(cuda):
    """K1's branch-free divisions and square roots equal `/` and sqrtf bit
    for bit wherever the chain takes them: 2^32 hashed division operand
    pairs and every float32 square-root operand."""
    got = rollout_25d_cuda.check_arithmetic(cuda)
    assert got["divisions_differing"] == 0 and got["roots_differing"] == 0
    assert got["divisions_fast"] > 2 ** 31 and got["roots_fast"] > 2 ** 30


def test_k1_call_is_one_launch_and_no_other_device_op(cuda):
    """A K1 call on the card dispatches no torch operator but the output's
    ``empty`` (and views of it), and runs exactly one kernel, even for a
    strided start pose (a view into an earlier rollout, as kinematic_advance
    passes it)."""
    hf = _crater(cuda)
    g = torch.Generator(device=cuda).manual_seed(7)
    lin = torch.rand((4, 64, 100), generator=g, device=cuda)
    ang = torch.rand((4, 64, 100), generator=g, device=cuda) - 0.5
    prev = rollout_25d_cuda(hf, torch.zeros((4, 2), device=cuda),
                            torch.tensor([[1.0, 0.0, 0.0]] * 4, device=cuda), lin, ang, 0.045)
    pos, heading = prev.trajectory[:, 0, 0, :2], prev.headings[:, 0, 0]
    assert not pos.is_contiguous() and not heading.is_contiguous()
    copies = rollout_25d_cuda.copies
    with measure.OpLog() as log:
        rollout_25d_cuda(hf, pos, heading, lin, ang, 0.045)
    assert [str(f) for f in log.device_ops] == ["aten.empty.memory_format"]
    assert rollout_25d_cuda.copies == copies
    assert measure.device_kernels(
        lambda: rollout_25d_cuda(hf, pos, heading, lin, ang, 0.045)) == 1
    want = tro.rollout_25d(hf, pos[:, None], heading[:, None], lin, ang, 0.045)
    assert all(torch.equal(a, b) for a, b in zip(
        rollout_25d_cuda(hf, pos, heading, lin, ang, 0.045), want))
    # a (K, H) part that is not contiguous is copied, and counted
    rollout_25d_cuda(hf, pos, heading, lin.transpose(1, 2).contiguous().transpose(1, 2), ang,
                     0.045)
    assert rollout_25d_cuda.copies == copies + 1


def test_rollout_2d_call_is_one_launch_and_no_other_device_op(cuda):
    """A call dispatches no torch operator but the output's ``empty``, runs
    one kernel, reads strided poses in place, and copies only velocities
    whose (K, H) part is not contiguous; what K1 refuses it refuses. It runs
    beside K1's test, before the tests that drive threads, side streams and
    rank processes: after those, torch.profiler in the same process read no
    device record of any call (H100 80GB HBM3, torch 2.11)."""
    hf = _thesis_hf(cuda)
    g = torch.Generator(device=cuda).manual_seed(7)
    lin = torch.rand((4, 64, 100), generator=g, device=cuda)
    ang = torch.rand((4, 64, 100), generator=g, device=cuda) - 0.5
    prev = rollout_2d_cuda(hf, torch.zeros((4, 2), device=cuda),
                           torch.tensor([[1.0, 0.0, 0.0]] * 4, device=cuda), lin, ang, 0.045)
    pos, heading = prev[0][:, 0, 0, :2], prev[1][:, 0, 0]
    assert not pos.is_contiguous() and not heading.is_contiguous()
    copies = rollout_2d_cuda.copies
    with measure.OpLog() as log:
        rollout_2d_cuda(hf, pos, heading, lin, ang, 0.045)
    assert [str(f) for f in log.device_ops] == ["aten.empty.memory_format"]
    assert rollout_2d_cuda.copies == copies
    assert measure.device_kernels(lambda: rollout_2d_cuda(hf, pos, heading, lin, ang,
                                                          0.045)) == 1
    rollout_2d_cuda(hf, pos, heading, lin.transpose(1, 2).contiguous().transpose(1, 2), ang,
                    0.045)
    assert rollout_2d_cuda.copies == copies + 1
    with pytest.raises(TypeError, match="float32"):
        rollout_2d_cuda(hf, pos.double(), heading.double(), lin.double(), ang.double(), 0.045)
    long = torch.ones((4, 2, 257), device=cuda)
    with pytest.raises(ValueError, match="horizons up to 256"):
        rollout_2d_cuda(hf, pos, heading, long, long, 0.045)
    with pytest.raises(ValueError, match="devices"):
        rollout_2d_cuda(hf, pos.cpu(), heading, lin, ang, 0.045)


def test_step_runs_about_200_kernels_on_card(cuda):
    """One mppi_step + kinematic_advance at K=1000 x H=100 runs at most 210
    device kernels (392 when K1's start projection and transposes were eager
    torch ops), two of them K1."""
    hf = _crater(cuda)
    cfg = MPPIConfig(num_samples=1000, horizon=100)
    cost = torch.rand((750, 750), generator=torch.Generator().manual_seed(1)) ** 4
    cm = as_costmap(cost, 75.0, device=cuda)
    robot = RobotState.create(-45.0, -40.0, [1.0, 0.5, 0.0], device=cuda)
    ctrl = ControllerState.create(cfg, device=cuda)
    goal = torch.tensor([45.0, 40.0], device=cuda)
    noise = torch.randn((2, 1000, 100), generator=torch.Generator().manual_seed(2)).to(cuda)

    def step():
        _, out = mppi_step(cfg, hf, cm, goal, robot, ctrl, noise)
        kinematic_advance(cfg, robot, out)

    before = rollout_25d_cuda.launches
    step()
    assert rollout_25d_cuda.launches == before + 2
    kernels = measure.device_kernels(step)  # calls step once per profiler session
    assert 2 <= kernels <= 210


# -- the tracer (core/trace.py) on the card; the kernel count reads the
# profiler, so it runs before the tests that drive threads and side streams


def _traced_goal_seek(cuda, traced, k=256, h=40, loops=40):
    """A goal-seek of ``loops`` loops through a graph of 4 masked steps,
    captured and replayed with the tracer on or off; its result, graph and
    the recording (``None`` when off)."""
    from husky_rover_mppi_isaacsim_torch.core import trace
    from husky_rover_mppi_isaacsim_torch.core.graphs import Graphed
    from husky_rover_mppi_isaacsim_torch.mppi import goal_seek_recorded, masked_steps

    hf, cm = _graph_world(cuda)
    cfg = MPPIConfig(num_samples=k, horizon=h)
    goal = torch.tensor([15.0, 12.0], device=cuda)
    robot = RobotState.create(-10.0, -8.0, [1.0, 0.4, 0.0], device=cuda)
    ctrl = ControllerState.create(cfg, device=cuda)
    graph = Graphed(masked_steps)
    if traced:
        trace.enable()
    try:
        res = goal_seek_recorded(cfg, hf, cm, goal, robot, ctrl, jr.key(5, cuda),
                                 max_loops=loops, steps_fn=graph)
    finally:
        trace.disable()
    return res, graph, trace.collect() if traced else None


def test_tracer_leaves_a_graph_s_kernels_as_they_were_on_card(cuda):
    """A replay of a graph captured with the tracer off runs the kernels
    of the eager steps, and so does one captured with it on (its marks are
    event nodes, no kernels)."""
    from husky_rover_mppi_isaacsim_torch.core import trace
    from husky_rover_mppi_isaacsim_torch.core.graphs import Graphed
    from husky_rover_mppi_isaacsim_torch.mppi import masked_steps
    from husky_rover_mppi_isaacsim_torch.mppi.controller import goal_reached

    hf, cm = _graph_world(cuda)
    cfg = MPPIConfig(num_samples=256, horizon=40)
    goal = torch.tensor([15.0, 12.0], device=cuda)
    robot = RobotState.create(-10.0, -8.0, [1.0, 0.4, 0.0], device=cuda)
    args = (cfg, 40, hf, cm, goal, robot, ControllerState.create(cfg, device=cuda),
            torch.zeros((), dtype=torch.int64, device=cuda), goal_reached(robot.position, goal),
            torch.zeros((0, 3), device=cuda), torch.zeros((0,), device=cuda), jr.key(5, cuda), 4)
    eager = measure.device_kernels(lambda: masked_steps(*args))
    counts = []
    for traced in (False, True):
        graph = Graphed(masked_steps)
        if traced:
            trace.enable()
        try:
            graph(*args)  # the warm-up
            graph(*args)  # the capture and a replay
        finally:
            trace.disable()
        counts.append(measure.device_kernels(lambda: graph(*args)))
    assert counts == [eager, eager] and eager > 4 * 150


def test_graph_captured_with_the_tracer_on_equals_the_untraced_on_card(cuda):
    """The same goal-seek through a graph captured and replayed with the
    tracer on and through one with it off: the same trace and state bit for
    bit."""
    got, _, rec = _traced_goal_seek(cuda, True)
    want, _, _ = _traced_goal_seek(cuda, False)
    assert got.steps == want.steps == 40 and _all_equal(got, want)
    assert len(rec.named("phase.rollout")) > 0


def test_in_graph_marks_time_each_replay_on_card(cuda, monkeypatch):
    """At K=1000 x H=100 every replay's phase spans (each replay's read
    here), read from the event nodes of the graph, are positive, 7 a step
    plus the head, in the order of the marks, and sum to the replay's
    device span within 5%; the
    counters count one warm-up, one capture and the replays; a window
    after the capture holds no build, and its replays lie on the host's
    clock inside it."""
    from husky_rover_mppi_isaacsim_torch.core import trace

    monkeypatch.setattr(trace, "MARK_EVERY", 1)
    res, graph, rec = _traced_goal_seek(cuda, True, k=1000, h=100, loops=48)
    order = ["phase.head"] + ["phase." + n for n in (
        "noise", "sampling", "rollout", "critics", "optimal_lag", "optimal_rollout",
        "advance")] * 4
    replays = rec.spans[rec.spans["device"]
                        & (rec.spans["name"] == rec.names.index(trace.REPLAY))]
    assert len(replays) == graph.replays == res.steps // 4 - 1
    for r in replays:
        kids = rec.spans[rec.spans["parent"] == r["id"]]
        kids = kids[np.argsort(kids["start_ns"], kind="stable")]
        assert [rec.names[n] for n in kids["name"]] == order
        dur = kids["end_ns"] - kids["start_ns"]
        assert (dur > 0).all(), dict(zip(order, dur.tolist()))
        whole = int(r["end_ns"] - r["start_ns"])
        assert abs(int(dur.sum()) - whole) <= 0.05 * whole
    c = rec.counters
    assert (c["graphed.eager_calls"], c["graphed.captures"]) == (1, 1)
    assert c["graphed.replays"] == graph.replays and c.get("trace.device_reads_missed", 0) == 0
    t0 = int(rec.named("graphed.capture")["end_ns"][0])
    w = trace.window(rec, t0, int(rec.spans["end_ns"].max()) + 1)
    assert w["builds"] == 0 and w["replays"] == len(replays)
    assert 0 < w["busy_s"] <= w["window_s"] and w["idle_in_program_s"] <= w["idle_s"]


def test_k1_kernel_refuses_what_it_does_not_take(cuda):
    hf = _crater(cuda, grid=64, hw=5.0)
    lin = torch.ones((4, 8), device=cuda)
    pos, heading = torch.zeros(2, device=cuda), torch.tensor([1.0, 0.0, 0.0], device=cuda)
    with pytest.raises(TypeError, match="float32"):
        rollout_25d_cuda(hf, pos.double(), heading.double(), lin.double(), lin.double(), 0.045)
    with pytest.raises(ValueError, match="devices"):
        rollout_25d_cuda(hf, pos.cpu(), heading, lin, lin, 0.045)
    with pytest.raises(ValueError, match=r"\(K, H\)"):
        rollout_25d_cuda(hf, pos, heading, lin, lin[:, :4], 0.045)
    long = torch.ones((4, 257), device=cuda)
    with pytest.raises(ValueError, match="horizons up to 256"):
        rollout_25d_cuda(hf, pos, heading, long, long, 0.045)


@pytest.mark.parametrize("wheels", [True, False])
def test_k1_rover_axis_equals_one_rover_launches(cuda, wheels):
    """N=4 rovers in one launch: rover n bit-equal to a one-rover launch of
    its inputs, and to the plain batched rollout; the K=1 optimal rollouts
    of N rovers are one launch too."""
    hf = _crater(cuda)
    g = torch.Generator(device=cuda).manual_seed(4)
    n = 4
    pos = torch.rand((n, 2), generator=g, device=cuda) * 80.0 - 40.0
    heading = torch.rand((n, 3), generator=g, device=cuda) - 0.5
    for k in (1000, 1):
        lin = torch.rand((n, k, 100), generator=g, device=cuda) * 2.0
        ang = torch.rand((n, k, 100), generator=g, device=cuda) * 2.0 - 1.0
        before = rollout_25d_cuda.launches
        got = rollout_25d_cuda(hf, pos, heading, lin, ang, 0.045, wheels=wheels)
        torch.cuda.synchronize()
        assert rollout_25d_cuda.launches == before + 1
        assert got.trajectory.shape == (n, k, 100, 3)
        for i in range(n):
            one = rollout_25d_cuda(hf, pos[i], heading[i], lin[i], ang[i], 0.045, wheels=wheels)
            for a, b in zip(got, one):
                assert torch.equal(a[i], b)
        want = tro.rollout_25d(hf, pos[:, None], heading[:, None], lin, ang, 0.045,
                               wheels=wheels)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="position"):
        rollout_25d_cuda(hf, pos[:2], heading[:2], lin, ang, 0.045)


def test_k3_kernel_bit_equal_to_plain_on_card(cuda):
    table, i, j = gp.probe_inputs(cuda)
    rand = torch.randn((256, 256), generator=torch.Generator(device=cuda).manual_seed(5),
                       device=cuda)
    for t in (table, rand):
        before = gp.gather_probe_cuda.launches
        got = gp.gather_probe_cuda(t, i, j)
        torch.cuda.synchronize()
        assert gp.gather_probe_cuda.launches == before + 1
        for fn in gp.FORMULATIONS.values():
            assert torch.equal(got, fn(t, i, j))
    bad = i.clone()
    bad[0] = 256  # outside the table: NaN, not a read out of bounds
    assert torch.isnan(gp.gather_probe_cuda(table, bad, j)[0])
    with pytest.raises(TypeError, match="int32"):
        gp.gather_probe_cuda(table, i.long(), j)
    with pytest.raises(ValueError, match="devices"):
        gp.gather_probe_cuda(table, i.cpu(), j)
    assert gp.main(["device=cuda"]) == 0


def test_closed_loop_step_on_card_matches_cpu(cuda):
    """One closed-loop step for N=3 rovers from ``key(2)``: two K1 launches,
    no host sync, and the step-card-vs-CPU tolerances on the commands and
    poses."""
    cfg = tenv.ClosedLoopConfig(mppi=MPPIConfig(num_samples=256, horizon=50))
    cost = torch.rand((64, 64), generator=torch.Generator().manual_seed(1)) ** 4
    starts = [[-10.0, -8.0], [5.0, -12.0], [8.0, 9.0]]
    goals = [[18.0, 15.0], [-15.0, 10.0], [0.0, -18.0]]

    def run(device):
        hf = _crater(device, grid=512, hw=25.0)
        cm = as_costmap(cost, 25.0, device=device)
        state = tenv.init_loop_state(cfg, tenv.RoverState.create(starts, [1.0, 0.3, 0.0], hf))
        g = torch.tensor(goals, device=device)
        key = jr.key(2, device)
        if device.type != "cuda":
            return tenv.closed_loop_step(cfg, hf, cm, g, state, key)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")  # the step never waits for the card
        try:
            return tenv.closed_loop_step(cfg, hf, cm, g, state, key)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    before = rollout_25d_cuda.launches
    got = run(cuda)
    torch.cuda.synchronize()
    assert rollout_25d_cuda.launches == before + 2
    want = run(torch.device("cpu"))
    torch.testing.assert_close(got.stored_left.cpu(), want.stored_left, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.stored_right.cpu(), want.stored_right, rtol=1e-4, atol=1e-4)
    for f, a, b in zip(got.rovers._fields, got.rovers, want.rovers):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-4, msg=f)
    for f, a, b in zip(got.ctrl._fields, got.ctrl, want.ctrl):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-3, msg=f)
    torch.testing.assert_close(got.err_total.cpu(), want.err_total, rtol=1e-4, atol=1e-4)


def test_rover_step_on_card_matches_cpu(cuda):
    """Five turning physics steps of 64 rovers, the first under an external
    force and torque (the divisions by mass and yaw inertia): every state
    field within 8 float32 ulps of its largest magnitude of the CPU's."""
    params = tenv.RoverParams()
    rng = torch.Generator().manual_seed(6)
    n = 64
    pos = torch.rand((n, 2), generator=rng) * 40.0 - 20.0
    turn = [torch.rand(n, generator=rng) * 2.0 for _ in range(2)]
    push = {"ext_force": torch.randn((n, 3), generator=rng) * 40.0,
            "ext_torque": torch.randn(n, generator=rng) * 5.0}

    dem = _crater(torch.device("cpu"), grid=512, hw=25.0)  # one DEM for both devices

    def run(device):
        hf = HeightField(*(t.to(device) for t in dem))
        state = tenv.RoverState.create(pos, [1.0, 0.3, 0.0], hf)
        for s in range(5):
            ext = {k: t.to(device) for k, t in push.items()} if s == 0 else {}
            state = tenv.step(params, hf, state, *(t.to(device) for t in turn), **ext)
        return state

    got, want = run(cuda), run(torch.device("cpu"))
    assert want.yaw_rate.abs().max().item() > 0.1  # the rovers turn
    for f, a, b in zip(got._fields, got, want):
        tol = 8 * torch.finfo(torch.float32).eps * max(1.0, b.abs().max().item())
        assert (a.cpu() - b).abs().max().item() <= tol, f


def test_tf32_matmul_is_refused(cuda):
    u = torch.ones((4, 8), device=cuda)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="full precision"):
            skid_steer.wheel_lag_matmul(u, u, 0.0, 0.0, 1.2, skid_steer.DiffDriveLimits(), 3.5, 0.96)
    finally:
        use_full_fp32_matmul()


def test_mppi_step_on_card_matches_cpu(cuda):
    """One control step through K1 on the card, with no host sync, and
    through the plain version on the CPU, same noise: weights atol 1e-3,
    v rtol 1e-4, optimal trajectory atol 1e-3
    (tests/test_rollout_pallas.py:146-156)."""
    cfg = MPPIConfig(num_samples=256, horizon=50)
    cost = torch.rand((64, 64), generator=torch.Generator().manual_seed(1)) ** 4
    gen = torch.Generator().manual_seed(2)
    noise = torch.randn((2, 256, 50), generator=gen)

    def run(device):
        hf = _crater(device, grid=512, hw=25.0)
        cm = as_costmap(cost, 25.0, device=device)
        goal = torch.tensor([18.0, 15.0], device=device)
        robot = RobotState.create(-10.0, -8.0, [1.0, 0.3, 0.0], device=device)
        ctrl = ControllerState.create(cfg, device=device)
        noise_d = noise.to(device)
        if device.type != "cuda":
            return mppi_step(cfg, hf, cm, goal, robot, ctrl, noise_d)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")  # the step never waits for the card
        try:
            return mppi_step(cfg, hf, cm, goal, robot, ctrl, noise_d)
        finally:
            torch.cuda.set_sync_debug_mode("default")

    before = rollout_25d_cuda.launches
    _, got = run(cuda)
    torch.cuda.synchronize()
    assert rollout_25d_cuda.launches == before + 2
    _, want = run(torch.device("cpu"))
    torch.testing.assert_close(got.weights.cpu(), want.weights, rtol=0, atol=1e-3)
    torch.testing.assert_close(got.linear_velocity.cpu(), want.linear_velocity,
                               rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(got.angular_velocity.cpu(), want.angular_velocity,
                               rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.optimal_trajectory.cpu(), want.optimal_trajectory,
                               rtol=0, atol=1e-3)


def _occupancy(kind, device):
    """The standalone and thesis costmaps' occupancies, and random maps
    whose sides are not multiples of K2's 64 x 64 tile (875 columns: rows
    not 16-byte aligned; 516: aligned)."""
    if kind.startswith("random"):
        g = torch.Generator(device=device).manual_seed(3)
        shape = tuple(int(v) for v in kind.split("_")[1].split("x"))
        return torch.rand(shape, generator=g, device=device) < 0.02
    size = int(kind.split("_")[1])
    raster = rasterize_obstacles(generate_obstacles(), half_width=75.0, size=size,
                                 robot_radius=0.3)
    return torch.from_numpy(raster == 0).to(device)


@pytest.mark.parametrize("kind", ["costmap_750", "costmap_1500", "random_187x875",
                                  "random_203x516"])
def test_k2_kernel_bit_equal_to_plain_on_card(cuda, kind):
    occ = _occupancy(kind, cuda)
    before = edt_minplus_cuda.launches
    got = edt.edt_exact_sq(occ)
    torch.cuda.synchronize()
    assert edt_minplus_cuda.launches == before + 1
    assert torch.equal(got, edt.edt_exact_sq_plain(occ))
    assert torch.equal(got.cpu(), edt.edt_exact_sq(occ.cpu()))
    free = torch.zeros((64, 96), dtype=torch.bool, device=cuda)  # the _BIG sentinel
    assert torch.equal(edt.edt_exact_sq(free), edt.edt_exact_sq_plain(free))


def test_k2_kernel_refuses_what_it_does_not_take(cuda):
    with pytest.raises(TypeError, match="float32"):
        edt_minplus_cuda(torch.zeros((8, 8), dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError, match="4096 rows"):
        edt_minplus_cuda(torch.zeros((4097, 2), device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        edt_minplus_cuda(torch.zeros((8, 16), device=cuda).t())
    with pytest.raises(ValueError, match="device"):
        edt_minplus_cuda.launch(torch.zeros((8, 8), device=cuda), torch.zeros((8, 8)))


def test_thesis_dem_builds_bit_equal_on_card(cuda):
    """The craters are stamped in a fixed order, so two builds agree bit
    for bit (no float atomics)."""
    a = thesis_statistics_terrain(size_m=40.0, device=cuda)
    b = thesis_statistics_terrain(size_m=40.0, device=cuda)
    assert a.shape == (400, 400) and a.is_cuda and torch.isfinite(a).all()
    assert torch.equal(a, b)


def test_jax_random_draws_on_card_equal_the_cpu(cuda):
    """JAX's world stream (``core.jax_random``) gives the same values on
    the card as on the CPU: the thesis DEM's base-noise grids, a batch of
    rock tangents (fold_in over negative block indices) and
    bench_torch.py's 4096 vec-env starts, in float32 and float64."""
    from husky_rover_mppi_isaacsim_torch.core import jax_random as jr
    from husky_rover_mppi_isaacsim_torch.terrain import smallscale

    conf = smallscale.BaseTerrainGeneratorConf(x_size=150.0, y_size=150.0, resolution=0.1,
                                               max_elevation=0.84, min_elevation=-0.84)
    blk = torch.tensor([[3, -2], [3, -2], [-1, 5]])
    for dtype in (torch.float32, torch.float64):
        got = {}
        for dev in (cuda, torch.device("cpu")):
            k = jr.split(jr.key(42, dev))[1]
            rocks = jr.fold_in(jr.fold_in(jr.fold_in(jr.key(67, dev), blk[:, 0].to(dev)),
                                          blk[:, 1].to(dev)), torch.arange(3, device=dev))
            got[dev.type] = [t.cpu() for t in (
                *smallscale.draw_base_noise(k, conf, dtype=dtype),
                jr.uniform(rocks, (3,), dtype, -1.0, 1.0),
                jr.uniform(jr.key(0, dev), (4096, 2), dtype, -50.0, 50.0))]
        assert all(torch.equal(a, b) for a, b in zip(got["cuda"], got["cpu"])), dtype


def test_evaluation_run_on_card_launches_k1_and_k2(cuda):
    """K1 runs twice per 3D-arm step (samples + optimal rollout) and once
    per 2D-arm step (the optimal rollout); K2 once, for the costmap."""
    rollout_25d_cuda.launches = edt_minplus_cuda.launches = rollout_2d_cuda.launches = 0
    table = evaluation.run_2d_vs_3d_experiment(
        ks=(64,), runs_per_arm=1, horizon=20, max_loops=10, half_width=20.0, grid_size=400,
        costmap_size=200, span_fraction=0.3, device=cuda)
    entry = table["per_k"][64]
    assert entry["steps"]["3d"] > 0 and entry["finite"] == {"3d": True, "2d": True}
    assert rollout_25d_cuda.launches == 2 * entry["steps"]["3d"] + entry["steps"]["2d"]
    assert rollout_2d_cuda.launches == entry["steps"]["2d"]  # the 2D arm's samples
    assert edt_minplus_cuda.launches == 1


@pytest.mark.parametrize("k,wheels", [(1000, True), (1, False)])
def test_k1_on_a_7000_square_dem_matches_plain_on_card(cuda, k, wheels):
    """The streamed loop's window size (49 * 10^6 cells, 0.025 m/px): cell
    offsets beyond 2^25, poses in the middle, in the last rows and columns,
    and running off the corner (wrap-then-clamp reads)."""
    gen = torch.Generator(device=cuda).manual_seed(2)
    z = torch.rand((7000, 7000), generator=gen, device=cuda) * 0.05
    z += torch.linspace(0.0, 3.0, 7000, device=cuda)[:, None]
    hf = HeightField.create(z, 87.5)
    lin = torch.rand((k, 100), generator=gen, device=cuda) * 2.0
    ang = torch.rand((k, 100), generator=gen, device=cuda) * 2.0 - 1.0
    for pos, head in (((-12.5, 12.5), (0.0, -1.0, 0.0)), ((81.5, -84.0), (1.0, -0.4, 0.0)),
                      ((86.9, -87.2), (1.0, -1.0, 0.0))):
        p = torch.tensor(pos, device=cuda)
        h = torch.tensor(head, device=cuda)
        got = rollout_25d_cuda(hf, p, h, lin, ang, 0.045, wheels=wheels)
        want = tro.rollout_25d(hf, p, h, lin, ang, 0.045, wheels=wheels)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b), pos


def test_k2_at_the_streamed_costmap_size_on_card(cuda):
    """875 x 875: not a multiple of the 64-wide tile, rows of 3500 bytes (not
    16-byte aligned: the batched-load producer)."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    for density in (0.04, 0.0005):
        occ = torch.rand((875, 875), generator=gen, device=cuda) < density
        before = edt_minplus_cuda.launches
        got = edt.edt_exact_sq(occ)
        assert edt_minplus_cuda.launches == before + 1
        assert torch.equal(got, edt.edt_exact_sq_plain(occ))


def test_small_streamed_traverse_on_card_launches_k1_and_k2(cuda):
    """``mode=largescale`` at a small size on the card: K1 twice per sim
    step on the live window, K2 once per costmap build, no sync in a chunk."""
    from husky_rover_mppi_isaacsim_torch.cli import largescale_episode

    tree = {"largescale": dict(block_size=10.0, hr_dem_resolution=0.1, lr_pixel_size=2.0,
                               hr_dem_num_blocks=1, crater_gen_padding=2.0,
                               update_every_n_meters=0.25, geo_cm_num_texels_per_level=8,
                               geo_cm_num_lods=3, terrain_collider_resolution=0.5,
                               terrain_collider_build_radius=6.0, rock_block_span=1),
            "mppi": {"num_samples": 64, "horizon": 30}, "start": {"x": 9.7, "y": 1.0},
            "goal": {"x": 45.0, "y": 8.0}, "max_steps": 240, "device": "cuda"}
    rollout_25d_cuda.launches = edt_minplus_cuda.launches = 0
    run = largescale_episode(tree)
    res = run.result
    assert res.steps == 240 and rollout_25d_cuda.launches == 2 * res.steps
    # the CLI's default loop is pipelined with pre-staging: K2 runs once
    # per costmap build (the first, staged ones, misses), on the worker's
    # stream; each seated costmap is the synchronous build of its key
    builds = run.loop.costmap_builds
    assert res.block_shifts >= 1 and edt_minplus_cuda.launches == sum(builds.values())
    assert builds["miss"] == res.prestage_misses and res.costmap_rebuilds == res.block_shifts
    for _, cm, frame, rocks in run.loop.costmap_log:
        want = run.loop.costmap_for((frame.block_x, frame.block_y), rocks)
        assert torch.equal(cm.cost, want.cost)
    assert run.loop.hf.z.is_cuda and run.loop.hf.z is run.loop.lstm.map_manager.streamer.window
    state, goal = run.loop.last_state, run.loop._goal_ctrl()
    key = jr.key(0, cuda)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run.loop.chunk(state, goal, key, 3)
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_deformation_stamp_on_card_is_deterministic_and_matches_cpu(cuda):
    """A ``deform_window`` stamp with shared cells on the card: two stamps
    from the same inputs are ``torch.equal``; against the CPU, heights to
    1e-6 m and equal pass counts."""
    from husky_rover_mppi_isaacsim_torch.physics.deformation import (
        DeformationEngine,
        DeformationEngineConf,
    )

    eng = DeformationEngine(DeformationEngineConf(terrain_resolution=0.025))
    gen = torch.Generator().manual_seed(4)
    window = torch.randn((800, 800), generator=gen) * 0.1
    positions = torch.rand((4, 2), generator=gen) * 5.0 + 2.0
    yaws = torch.rand(4, generator=gen) * 6.0 - 3.0
    loads = torch.rand(4, generator=gen) * 120.0
    outs = []
    for dev in (cuda, cuda, torch.device("cpu")):
        w, c = window.to(dev), torch.zeros((800, 800), dtype=torch.int32, device=dev)
        for res in (0.025, 0.05):  # the second stamp shares cells and decays
            eng.deform_window(w, c, res, (0.0, 0.0), positions.to(dev), yaws.to(dev),
                              loads.to(dev))
        outs.append((w.cpu(), c.cpu()))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    assert float((outs[0][0] - outs[2][0]).abs().max()) <= 1e-6
    assert torch.equal(outs[0][1], outs[2][1]) and int(outs[0][1].max()) >= 2


def test_k1_on_the_yard_dem_matches_plain_on_card(cuda):
    """``environment=lunaryard_80m``'s world on the card: a 4000^2 DEM at
    0.02 m/px (64 MB, not resident in L2) and a free costmap; K1 bit-equal
    to its plain version in the middle, at the start of the yard goal-seek
    and running off the yard's corner."""
    from husky_rover_mppi_isaacsim_torch import cli

    tree = cli.compose(["environment=lunaryard_80m"])
    hf, cm, _ = cli.build_standalone_world(cli.world_tree(tree), device=cuda,
                                           moonyard=cli.moonyard_section(tree))
    assert hf.z.shape == (4000, 4000) and hf.z.is_cuda and not cm.cost.any()
    gen = torch.Generator(device=cuda).manual_seed(5)
    for k, wheels in ((1000, True), (1, False)):
        lin = torch.rand((k, 100), generator=gen, device=cuda) * 2.0
        ang = torch.rand((k, 100), generator=gen, device=cuda) * 2.0 - 1.0
        for pos in ((0.0, 0.0), (-30.0, -30.0), (39.6, -39.7)):
            p = torch.tensor(pos, device=cuda)
            h = torch.tensor((1.0, 0.5, 0.0), device=cuda)
            got = rollout_25d_cuda(hf, p, h, lin, ang, 0.045, wheels=wheels)
            want = tro.rollout_25d(hf, p, h, lin, ang, 0.045, wheels=wheels)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                assert torch.equal(a, b), pos


def test_sdg_capture_on_card_matches_cpu(cuda, tmp_path):
    """One SDG capture (top-down with the path-tracing effects, camera with
    rocks and cast shadows) of the same DEM and draws on the card and on the
    CPU, at the tolerances of tests/test_torch_labeling.py: the height map
    and the top-down classes equal, the effected rgb to 1e-4 (the warp's
    coordinates round differently), hits, classes and instances equal on
    >= 99.99% of the pixels, depths to 1e-5 (terrain) / 1e-3 (rocks)."""
    import numpy as np

    from husky_rover_mppi_isaacsim_torch import cli
    from husky_rover_mppi_isaacsim_torch.aux import labeling as lab
    from husky_rover_mppi_isaacsim_torch.terrain.point_process import BoundingBox, hardcore_poisson
    from husky_rover_mppi_isaacsim_torch.terrain.smallscale import MoonyardConf, MoonyardGenerator

    settings = cli.render_settings_from_cfg(cli.compose(["rendering=path_tracing"]))
    dem = MoonyardGenerator(MoonyardConf(), device=cuda).randomize()
    rng = np.random.default_rng(3)
    xy, r = hardcore_poisson(rng, BoundingBox(0.0, 10.0, 0.0, 10.0), (0.08,), ((0.08, 0.4),))
    sun, cam_xy = (-0.55, 0.4, 0.35), (3.0, 4.0)
    outs = {}
    for dev in (cuda, torch.device("cpu")):
        labeler = lab.AutonomousLabeling(lab.LabelingConf(data_dir=str(tmp_path / dev.type)),
                                         settings)
        z = dem.to(dev)
        top = labeler.record(z, 0.02, sun_direction=sun, rock_xy=xy, rock_radius=r)
        cam = labeler.record_camera(z, 0.02, (0.0, 0.0), cam_xy, (0.6, 0.8),
                                    float(z[150, 200]), lab.CameraIntrinsics(160, 120),
                                    sun_direction=sun, rock_xy=xy, rock_radius=r, steps=128,
                                    cast_shadows=True, frame=0)
        outs[dev.type] = top, {k: v.cpu().numpy() for k, v in cam.items()}
    (top_c, cam_c), (top_h, cam_h) = outs["cuda"], outs["cpu"]
    assert np.array_equal(top_c["depth"], top_h["depth"])
    assert np.array_equal(top_c["semantic"], top_h["semantic"]) and (top_h["semantic"] == 2).any()
    assert np.abs(top_c["rgb"] - top_h["rgb"]).max() <= 1e-4
    for k in ("hit", "semantic", "instance"):
        assert (cam_c[k] == cam_h[k]).mean() >= 0.9999, k
    both = (cam_c["instance"] == cam_h["instance"]) & np.isfinite(cam_h["depth"]) \
        & np.isfinite(cam_c["depth"])
    for sel, rtol in ((both & (cam_h["instance"] == 0), 1e-5),
                      (both & (cam_h["instance"] > 0), 1e-3)):
        np.testing.assert_allclose(cam_c["depth"][sel], cam_h["depth"][sel], rtol=rtol)
    assert cam_h["hit"].mean() > 0.3


def test_sim_manager_steps_on_card_match_cpu(cuda):
    """Five SimulationManager ticks of 3 slots (two robots spawned, one
    teleported over the bus after tick 1) on the card and on the CPU, both
    from the manager's seed: two K1 launches a tick, no host sync in a tick
    without a POSE_STATE subscriber, and the closed-loop step's card-vs-CPU
    tolerances."""
    import numpy as np

    from husky_rover_mppi_isaacsim_torch.shell import (
        SimulationManager,
        SimulationManagerConf,
        Topics,
    )

    conf = SimulationManagerConf(loop=tenv.ClosedLoopConfig(
        mppi=MPPIConfig(num_samples=256, horizon=50)))
    cost = torch.rand((64, 64), generator=torch.Generator().manual_seed(1)) ** 4
    goals = np.array([[18.0, 15.0], [-15.0, 10.0], [0.0, -18.0]])
    dem = _crater(torch.device("cpu"), grid=512, hw=25.0)

    def run(device):
        rm = tenv.RobotManager(3)
        rm.spawn("a", (-10.0, -8.0))
        rm.spawn("b", (5.0, -12.0), heading=(0.0, 1.0, 0.0))
        launches = []
        with SimulationManager(conf, dem, as_costmap(cost, 25.0), rm, goals,
                               device=device) as sm:
            for tick in range(5):
                before = rollout_25d_cuda.launches
                if device.type == "cuda":
                    torch.cuda.synchronize()
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    sm.step()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
                launches.append(rollout_25d_cuda.launches - before)
                if tick == 1:
                    sm.bus.publish(Topics.ROBOT_TELEPORT, {"name": "a", "position": (3.0, 4.0)})
            return sm.state, launches

    (got, launches), (want, _) = run(cuda), run(torch.device("cpu"))
    assert launches == [2] * 5
    for f, a, b in zip(got.rovers._fields, got.rovers, want.rovers):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-3, msg=f)
    for f, a, b in zip(got.ctrl._fields, got.ctrl, want.ctrl):
        torch.testing.assert_close(a.cpu(), b, rtol=0, atol=1e-3, msg=f)
    torch.testing.assert_close(got.stored_left.cpu(), want.stored_left, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(got.stored_right.cpu(), want.stored_right, rtol=1e-4, atol=1e-4)


def test_mppi_controller_step_equals_mppi_step_on_card(cuda):
    """``MPPIController.step(noise=)`` is ``mppi_step`` on the card, bit for
    bit, and a drawn step launches K1 twice."""
    from husky_rover_mppi_isaacsim_torch.mppi import MPPIController

    hf = _crater(cuda, grid=512, hw=25.0)
    cm = as_costmap(torch.rand((64, 64), generator=torch.Generator().manual_seed(1)) ** 4, 25.0,
                    device=cuda)
    cfg = MPPIConfig(num_samples=1000, horizon=100)
    ctl = MPPIController(cfg, hf, cm, (15.0, 12.0), seed=42)
    robot = RobotState.create(-10.0, -8.0, [1.0, 0.4, 0.0], device=cuda)
    ctrl = ControllerState.create(cfg, device=cuda)
    noise = torch.randn((2, 1000, 100), generator=torch.Generator().manual_seed(3)).to(cuda)
    got = ctl.step(robot, ctrl, noise)
    want = mppi_step(cfg, hf, cm, ctl.goal, robot, ctrl, noise)
    for a, b in zip(got[0] + got[1][:-1], want[0] + want[1][:-1]):
        assert torch.equal(a, b)
    before = rollout_25d_cuda.launches
    ctl.step(robot, ctrl)
    assert rollout_25d_cuda.launches == before + 2


def test_sharded_step_one_rank_bit_equal_on_card(cuda, tmp_path):
    """One NCCL rank on the card: the sharded step equals ``mppi_step`` bit
    for bit (the all-reduces of one rank change nothing)."""
    from shard_ranks import run_ranks

    hf = _crater(torch.device("cpu"), grid=512, hw=25.0)
    cm = as_costmap(torch.rand((64, 64), generator=torch.Generator().manual_seed(1)) ** 4, 25.0)
    cfg = MPPIConfig(num_samples=1000, horizon=100)
    job = dict(hf=hf, costmap=cm, goal=torch.tensor([15.0, 12.0]),
               robot=RobotState.create(-10.0, -8.0, [1.0, 0.4, 0.0]),
               ctrl=ControllerState.create(cfg),
               noise=torch.randn((2, 1000, 100), generator=torch.Generator().manual_seed(3)),
               cases=[{"kind": "sample", "config": cfg}])
    (res,), = run_ranks(job, 1, tmp_path, backend="nccl", device="cuda", timeout_s=300)
    to = lambda tree: type(tree)(*(t.to(cuda) for t in tree))  # noqa: E731
    want_ctrl, want_out = mppi_step(cfg, HeightField(*(t.to(cuda) for t in hf)), to(cm),
                                    job["goal"].to(cuda), to(job["robot"]), to(job["ctrl"]),
                                    job["noise"].to(cuda))
    assert res["k1_launches"] == 2
    for a, b in zip(res["ctrl"] + res["out"][:-1], want_ctrl + want_out[:-1]):
        assert torch.equal(a, b.cpu())


def test_streamer_pool_route_on_card_without_a_host_sync(cuda):
    """native_pool="always" on the card: the first window and a shift
    raise no host sync; on smooth terrain the window equals the CPU pool
    route's (the same C++ bases, uploaded), with craters it is within 1e-4
    of the card's device route (tests/test_torch_native.py)."""
    import numpy as np

    from husky_rover_mppi_isaacsim_torch.terrain import map_manager as tmap
    from husky_rover_mppi_isaacsim_torch.terrain import streaming as tstream

    lr = tmap.synthetic_lola_dem(256, 2.0, seed=42)

    def make(dev, mode, craters):
        conf = tstream.StreamerConf(block_size=10.0, resolution=0.1, lr_resolution=2.0,
                                    num_blocks=1, pad_size=2.0, seed=57,
                                    generate_craters=craters, native_pool=mode)
        return tstream.TerrainStreamer(conf, lr, device=dev)

    for craters in (False, True):
        card = make(cuda, "always", craters)
        ref = make(cuda, "never", craters) if craters else make("cpu", "always", craters)
        for pos in ((0.0, 0.0), (12.0, 0.0)):
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                card.update(pos)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            ref.update(pos)
            torch.cuda.synchronize()
            if craters:
                assert float((card.window - ref.window).abs().max()) <= 1e-4
            else:
                assert torch.equal(card.window.cpu(), ref.window)
        assert card.tile_pool().jobs == len(card.block_cache)
        card.close()
    assert np.isfinite(card.window.cpu().numpy()).all()


def test_worldbuilders_request_on_card_matches_cpu(cuda):
    """A hard-core Thomas request with both clippers on a float32 DEM, on
    the card and on the CPU from the same seeds: counts, positions, heights
    and scales equal, quaternions within the float32 spacing of the largest
    slope (tests/test_torch_worldbuilders.py)."""
    import numpy as np

    from husky_rover_mppi_isaacsim_torch import worldbuilders as wb

    dem = torch.from_numpy((np.random.default_rng(7).normal(size=(256, 256)) * 0.1)
                           .astype(np.float32))

    def requests(data):
        return (
            wb.UserRequest_T(p_type=wb.Position_T(), sampler=wb.HardCoreThomasClusterSampler_T(
                randomization_space=2, lambda_parent=0.05, lambda_daughter=50, sigma=0.5,
                core_radius=0.05, num_repeat=1, seed=5),
                layer=wb.Plane_T(xmin=0, xmax=25.6, ymin=0, ymax=25.6), axes=["x", "y"]),
            wb.UserRequest_T(p_type=wb.Position_T(), sampler=wb.ImageClipper_T(
                randomization_space=1, resolution=(256, 256), mpp_resolution=0.1, data=data),
                layer=wb.Line_T(xmin=0, xmax=1), axes=["z"]),
            wb.UserRequest_T(p_type=wb.OrientationParam_T(), sampler=wb.NormalMapClipper_T(
                randomization_space=1, resolution=(256, 256), mpp_resolution=0.1, data=data),
                layer=wb.RollPitchYaw_T(output_space=4), axes=["x", "y", "z", "w"]),
        )

    card = wb.RequestMixer(requests(dem.to(cuda)), device=cuda)(num=1)
    host = wb.RequestMixer(requests(dem), device="cpu")(num=1)
    assert card["xformOp:translation"].shape[0] > 500
    assert torch.equal(card["xformOp:translation"].cpu(), host["xformOp:translation"])
    slopes = np.rad2deg(np.arctan2(np.stack(np.gradient(dem.numpy())), 1))
    atol = float(np.spacing(np.abs(slopes).max()))
    diff = (card["xformOp:orientation"].cpu() - host["xformOp:orientation"]).abs().max()
    assert float(diff) <= atol


# -- CUDA graphs (core/graphs.py): each graphed path against its eager self --


def _graph_world(device):
    hf = _crater(device, grid=512, hw=25.0)
    cm = as_costmap(torch.rand((64, 64), generator=torch.Generator().manual_seed(1)) ** 4, 25.0,
                    device=device)
    return hf, cm


def _tensors(tree):
    import torch.utils._pytree as pytree

    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _all_equal(a, b):
    ta, tb = _tensors(a), _tensors(b)
    return len(ta) == len(tb) and all(torch.equal(x, y) for x, y in zip(ta, tb))


@pytest.mark.parametrize("projection", ["3d", "2d"])
def test_graphed_goal_seek_equals_eager_on_card(cuda, projection):
    """``goal_seek_recorded`` through its graph of 4 masked steps and
    through ``masked_steps`` eagerly, from the same key: the same trace and
    state bit for bit, K1 twice (3D) or once (2D) and ``jax_normal`` once
    per step either way, and every call after the warm-up a replay."""
    from husky_rover_mppi_isaacsim_torch.core.graphs import Graphed
    from husky_rover_mppi_isaacsim_torch.mppi import goal_seek_recorded, masked_steps

    hf, cm = _graph_world(cuda)
    cfg = MPPIConfig(num_samples=256, horizon=40, projection=projection)
    goal = torch.tensor([15.0, 12.0], device=cuda)
    runs, counts = [], []
    graph = Graphed(masked_steps)
    for steps_fn in (graph, masked_steps):
        robot = RobotState.create(-10.0, -8.0, [1.0, 0.4, 0.0], device=cuda)
        ctrl = ControllerState.create(cfg, device=cuda)
        before = rollout_25d_cuda.launches, rollout_2d_cuda.launches, jax_normal.launches
        runs.append(goal_seek_recorded(cfg, hf, cm, goal, robot, ctrl, jr.key(5, cuda),
                                       max_loops=40, steps_fn=steps_fn))
        counts.append((rollout_25d_cuda.launches - before[0],
                       rollout_2d_cuda.launches - before[1], jax_normal.launches - before[2]))
    got, want = runs
    assert got.steps == want.steps == 40 and _all_equal(got, want)
    # K1, the planar rollout kernel, jax_normal
    per_step = (2, 0, 1) if projection == "3d" else (1, 1, 1)
    assert counts == [tuple(n * got.steps for n in per_step)] * 2
    assert graph.replays == got.steps // 4 - 1 and graph.capture_ms > 0


def test_graphed_mppi_controller_run_equals_eager_on_card(cuda):
    """``MPPIController.run`` replaying its step graph and run with
    ``step_fn = mppi_step``: the same path, final state and loop count."""
    from husky_rover_mppi_isaacsim_torch.mppi import MPPIController

    hf, cm = _graph_world(cuda)
    cfg = MPPIConfig(num_samples=256, horizon=40)
    runs = []
    for graphed in (True, False):
        ctl = MPPIController(cfg, hf, cm, (15.0, 12.0), seed=42)
        if not graphed:
            ctl.step_fn = mppi_step
        robot = RobotState.create(-10.0, -8.0, [1.0, 0.4, 0.0], device=cuda)
        runs.append((ctl.run(robot, max_loops=30), ctl.loop))
    (got, loops), (want, loops_e) = runs
    assert loops == loops_e == 30 and _all_equal(got, want)


def test_graphed_evaluation_equals_eager_on_card(cuda):
    """Both arms of the 2D-vs-3D experiment with each arm replaying its
    graph, and with the masked steps run eagerly: the same table."""
    from unittest import mock

    kw = dict(ks=(64,), runs_per_arm=2, horizon=20, max_loops=12, half_width=20.0,
              grid_size=400, costmap_size=200, span_fraction=0.3, device=cuda)
    got = evaluation.run_2d_vs_3d_experiment(**kw)
    with mock.patch.object(evaluation, "Graphed", lambda fn: fn):
        want = evaluation.run_2d_vs_3d_experiment(**kw)
    for table in (got, want):
        for arm in ("3d", "2d"):
            table["per_k"][64]["wall_s"][arm] = 0.0
    assert got == want


def test_graphed_closed_loop_equals_eager_on_card(cuda):
    """``run_episode`` of 3 rovers over 12 steps (every latch phase; the
    noise and the wheel slip drawn inside the graph, three ``jax_normal``
    launches a step) replaying one step graph, and with
    ``closed_loop_step`` eagerly: the same path and final state."""
    import numpy as np

    hf, cm = _graph_world(cuda)
    cfg = tenv.ClosedLoopConfig(mppi=MPPIConfig(num_samples=256, horizon=40),
                                rover=tenv.RoverParams(slip_std=0.05))
    starts = np.array([[-10.0, -8.0], [5.0, -12.0], [-12.0, 6.0]])
    goals = torch.tensor([[15.0, 12.0], [-15.0, 10.0], [10.0, -15.0]], device=cuda)
    runs = []
    for step_fn in (None, tenv.closed_loop_step):
        state = tenv.init_loop_state(cfg, tenv.RoverState.create(starts, [1.0, 0.0, 0.0], hf))
        before = rollout_25d_cuda.launches, jax_normal.launches
        runs.append(tenv.run_episode(cfg, hf, cm, goals, state, jr.key(3, cuda), 12,
                                     step_fn=step_fn))
        assert rollout_25d_cuda.launches - before[0] == 24
        assert jax_normal.launches - before[1] == 36
    assert _all_equal(*runs) and int(runs[0][0].step_index) == 12


@pytest.mark.parametrize("slope_critic", ["wheels", "body"])
def test_bench_control_loops_graph_equals_eager_on_card(cuda, slope_critic):
    """bench_torch.py's control loops at its large batch (K=16384 x H=64),
    8 loops replayed as one graph against the same loops run eagerly from
    the same key: bit for bit, K1 twice and jax_normal once a loop either
    way."""
    import bench_torch as bt
    from husky_rover_mppi_isaacsim_torch.core.graphs import Graphed

    hf, cm = bt.build_world(cuda)
    cfg = MPPIConfig(num_samples=16384, horizon=64, exact=False, slope_critic=slope_critic)
    goal = torch.tensor([65.0, 60.0], device=cuda)
    robot = RobotState.create(-60.0, -60.0, [1.0, 0.5, 0.0], device=cuda)
    ctrl = ControllerState.create(cfg, device=cuda)
    key = jr.key(50, cuda)
    graph = Graphed(bt.control_loops, in_place_args=bt.LOOPS_IN_PLACE)
    graph(cfg, hf, cm, goal, robot, ctrl, key, 8)  # the warm-up, eager
    before = rollout_25d_cuda.launches, jax_normal.launches
    got = graph(cfg, hf, cm, goal, robot, ctrl, key, 8)  # the capture and a replay
    replayed = rollout_25d_cuda.launches - before[0], jax_normal.launches - before[1]
    before = rollout_25d_cuda.launches, jax_normal.launches
    want = bt.control_loops(cfg, hf, cm, goal, robot, ctrl, key, 8)
    torch.cuda.synchronize()
    assert replayed == (rollout_25d_cuda.launches - before[0],
                        jax_normal.launches - before[1]) == (16, 8)
    assert graph.replays == 1 and _all_equal(got, want)
    assert not torch.equal(got[0].position, robot.position)


def test_bench_vec_env_graph_equals_eager_on_card(cuda):
    """bench_torch.py's vec env, 4096 rovers: a graph of 100 physics steps
    called 4 times (the warm-up, then the capture and 3 replays) against
    400 eager steps, bit for bit."""
    import bench_torch as bt
    from husky_rover_mppi_isaacsim_torch.core.graphs import Graphed

    hf = _crater(cuda)
    state, cmd = bt.vec_env_start(hf, 4096)
    params = tenv.RoverParams()
    graph = Graphed(bt.vec_env_steps, in_place_args=(1,))
    got = state
    for _ in range(4):
        got = graph(params, hf, got, cmd, 100)
    want = bt.vec_env_steps(params, hf, state, cmd, 400)
    torch.cuda.synchronize()
    assert graph.replays == 3 and _all_equal(got, want)
    assert float((got.position - state.position).abs().max()) > 1.0


def test_graphed_sim_manager_equals_eager_on_card(cuda):
    """SimulationManager ticks replaying the step graph and ticking
    eagerly, with a teleport and a reset over the bus between ticks: the
    same states at every tick (the graph copies the edited slots in), and
    no host sync in a tick."""
    import numpy as np

    from husky_rover_mppi_isaacsim_torch.shell import (
        SimulationManager,
        SimulationManagerConf,
        Topics,
    )
    from husky_rover_mppi_isaacsim_torch.shell.sim_manager import tick as sim_tick

    hf, cm = _graph_world(cuda)
    conf = SimulationManagerConf(loop=tenv.ClosedLoopConfig(
        mppi=MPPIConfig(num_samples=256, horizon=40)))
    goals = np.array([[18.0, 15.0], [-15.0, 10.0], [0.0, -18.0]])
    runs = []
    for graphed in (True, False):
        rm = tenv.RobotManager(3)
        rm.spawn("a", (-10.0, -8.0))
        rm.spawn("b", (5.0, -12.0), heading=(0.0, 1.0, 0.0))
        states = []
        with SimulationManager(conf, hf, cm, rm, goals, device=cuda) as sm:
            if not graphed:
                sm.step_fn = sim_tick
            for tick in range(8):
                if tick == 3:
                    sm.bus.publish(Topics.ROBOT_TELEPORT, {"name": "a", "position": (3.0, 4.0)})
                if tick == 5:
                    sm.bus.publish(Topics.ROBOT_RESET, {"name": "b"})
                torch.cuda.synchronize()
                torch.cuda.set_sync_debug_mode("error")
                try:
                    states.append(tenv.clone_state(sm.step()))
                finally:
                    torch.cuda.set_sync_debug_mode("default")
        runs.append(states)
    assert all(_all_equal(a, b) for a, b in zip(*runs))
    a_after = runs[0][3].rovers.position[0]
    assert torch.equal(a_after, torch.tensor([3.0, 4.0], device=cuda))


@pytest.mark.parametrize("deform", [False, True], ids=["plain", "deformed"])
def test_graphed_chunk_equals_eager_across_a_shift_on_card(cuda, deform):
    """The synchronous streamed loop at a small size with its chunk graph
    and with ``chunk_fn = run_chunk``: across a block shift (a new frame
    origin, window and costmap copied into the graph) and, deformed, with
    the window stamped between replays, the same path, shifts and final
    state."""
    import dataclasses

    from husky_rover_mppi_isaacsim_torch.cli import largescale_conf
    from husky_rover_mppi_isaacsim_torch.env import largescale_loop as tls

    tree = {"largescale": dict(block_size=10.0, hr_dem_resolution=0.1, lr_pixel_size=2.0,
                               hr_dem_num_blocks=1, crater_gen_padding=2.0,
                               update_every_n_meters=0.25, geo_cm_num_texels_per_level=8,
                               geo_cm_num_lods=3, terrain_collider_resolution=0.5,
                               terrain_collider_build_radius=6.0, rock_block_span=1),
            "mppi": {"num_samples": 64, "horizon": 30}, "start": {"x": 9.7, "y": 1.0},
            "goal": {"x": 45.0, "y": 8.0}, "max_steps": 120, "deformation": {"enable": deform}}
    conf = dataclasses.replace(largescale_conf(tree), pipeline_depth=0)
    runs = []
    for graphed in (True, False):
        loop = tls.LargeScaleClosedLoop(conf, device=cuda)
        if not graphed:
            loop.chunk_fn = tls.run_chunk
        res = loop.run()
        runs.append((res, loop))
    (got, gl), (want, wl) = runs
    assert got.block_shifts == want.block_shifts >= 1
    assert got.steps == want.steps and (got.path_world == want.path_world).all()
    assert _all_equal(gl.last_state, wl.last_state)
    assert torch.equal(gl.lstm.map_manager.streamer.window, wl.lstm.map_manager.streamer.window)
    assert gl.chunk_fn.replays == got.steps // conf.terrain_check_every - 1


def test_graphed_capture_failure_raises_on_card(cuda):
    """A function that reads a value back to the host cannot be captured:
    the helper raises with the cause and runs nothing eagerly in its place;
    a call of another shape raises before any capture."""
    from husky_rover_mppi_isaacsim_torch.core.graphs import Graphed

    g = Graphed(lambda t: t * float(t.sum()))
    x = torch.ones(4, device=cuda)
    assert torch.equal(g(x), x * 4.0)  # the warm-up, eager
    with pytest.raises(RuntimeError, match="capture failed"):
        g(x)
    h = Graphed(lambda t: t * 2.0)
    h(x)
    assert torch.equal(h(x + 1.0), (x + 1.0) * 2.0) and h.replays == 1
    with pytest.raises(ValueError, match="built for"):
        h(torch.ones(5, device=cuda))


STAMP_TIERS = [(192, 208, 40), (256, 128, 120), (1600, 48, 1000), (512, 56, 300),
               (256, 104, 100)]


def _crater_tier(device, capacity, patch_px, live, seed, side):
    """A radius tier at a streamed tier's (capacity, patch) shape: radii of
    its range at 0.025 m/px, random placements inside a ``side``-pixel
    raster (the first four on its corners, 36 piled on one spot), masked
    slots between live ones; tables of 100 profiles."""
    import numpy as np

    from husky_rover_mppi_isaacsim_torch.terrain import craters as tcr

    rng = np.random.default_rng(seed)
    r_hi = (patch_px - 4) / 2 * 0.025
    field = tcr.randomize_metadata(rng, rng.uniform(0, 1, (capacity, 2)),
                                   rng.uniform(r_hi / 2, r_hi, capacity), 100, capacity)
    mask = rng.random(capacity) < live / capacity
    mask[:8] = True
    field = field._replace(mask=torch.from_numpy(mask))
    hi = side - patch_px
    row0 = rng.integers(0, hi + 1, capacity).astype(np.int32)
    col0 = rng.integers(0, hi + 1, capacity).astype(np.int32)
    row0[:4], col0[:4] = [0, hi, 0, hi], [0, 0, hi, hi]
    row0[4:40], col0[4:40] = row0[4], col0[4]
    prof = tcr.build_profiles(100, seed=seed, device=device)
    return (prof, type(field)(*(f.to(device) for f in field)),
            torch.from_numpy(row0).to(device), torch.from_numpy(col0).to(device))


@pytest.mark.parametrize("capacity,patch_px,live", STAMP_TIERS,
                         ids=["208", "128", "48", "56", "104"])
def test_crater_stamp_kernel_matches_plain_on_card(cuda, capacity, patch_px, live):
    """The crater block kernel against its plain version (every slot
    rendered as a patch, the live ones added by the slice-add stamp) at the
    streamed tiers' (capacity, patch) shapes, on a guarded 1800 + 2P raster
    that already holds values: overlapping craters, masked slots between
    live ones, placements on the raster's edges; bit-equal, one launch, no
    patch tensor allocated."""
    from husky_rover_mppi_isaacsim_torch.ops.crater_block_cuda import crater_block_cuda
    from husky_rover_mppi_isaacsim_torch.terrain.craters import crater_block_plain

    side = 1800 + 2 * patch_px
    prof, field, row0, col0 = _crater_tier(cuda, capacity, patch_px, live, patch_px, side)
    base = torch.randn((side, side), generator=torch.Generator(device=cuda).manual_seed(1),
                       device=cuda)
    got = base.clone()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    before = crater_block_cuda.launches
    crater_block_cuda(got, prof, field, row0, col0, 0.025, 1.0, patch_px)
    torch.cuda.synchronize()
    assert crater_block_cuda.launches == before + 1
    assert torch.cuda.max_memory_allocated() - held < capacity * patch_px * patch_px * 4 // 4
    want = crater_block_plain(base.clone(), prof, field, row0, col0, 0.025, 1.0, patch_px)
    assert torch.equal(got, want) and not torch.equal(got, base)


def test_crater_block_overlapping_craters_on_card(cuda):
    """Thirty large craters of the 208^2 tier on nearly one spot, with the
    z scale and the resolution of the thesis terrain: every pixel sums up to
    30 heights, in slot order, bit-equal to the plain version."""
    import numpy as np

    from husky_rover_mppi_isaacsim_torch.ops.crater_block_cuda import crater_block_cuda
    from husky_rover_mppi_isaacsim_torch.terrain.craters import crater_block_plain

    prof, field, row0, col0 = _crater_tier(cuda, 64, 208, 64, 3, 600)
    rng = np.random.default_rng(5)
    row0 = torch.from_numpy(rng.integers(190, 200, 64).astype(np.int32)).to(cuda)
    col0 = torch.from_numpy(rng.integers(190, 200, 64).astype(np.int32)).to(cuda)
    base = torch.zeros((600, 600), device=cuda)
    got = crater_block_cuda(base.clone(), prof, field, row0, col0, 0.1, 1.3, 208)
    want = crater_block_plain(base.clone(), prof, field, row0, col0, 0.1, 1.3, 208)
    assert torch.equal(got, want) and float(got.abs().max()) > 0.1


@pytest.mark.parametrize("op", ["atan2", "exp", "cos", "sin", "atan"])
def test_crater_block_xla_math_matches_plain_on_card(cuda, op):
    """Each device function of the crater block kernel (csrc/xla_math.cuh:
    XLA's exp, glibc's atan2f / atanf, sinf and cosf) ``torch.equal`` to
    its plain version (core/xla_math.py) on the card, and that plain
    version on the card to the CPU's, on 2^22 probes: random bit patterns,
    a dense range, magnitudes to 1e30, and +-0, +-inf, NaN and subnormals
    (compared as bit patterns; a NaN result is the canonical NaN)."""
    import numpy as np

    from husky_rover_mppi_isaacsim_torch.core import xla_math as xm
    from husky_rover_mppi_isaacsim_torch.ops.crater_block_cuda import crater_block_cuda

    rng = np.random.default_rng(len(op))
    n = 1 << 20
    special = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-40, 1.17549435e-38,
                        1.0, -1.0, 120.0, 88.8, -87.8, 1e30, -1e30], np.float32)
    a = np.concatenate([rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32)
                        .view(np.float32), rng.uniform(-130, 130, n).astype(np.float32),
                        (rng.choice([-1.0, 1.0], n) * 10.0 ** rng.uniform(-40, 30, n))
                        .astype(np.float32), rng.uniform(-4, 4, n - special.size)
                        .astype(np.float32), special])
    b = rng.permutation(a)
    fn = {"atan2": xm.atan2_f32, "exp": xm.exp_f32, "cos": xm.cos_f32, "sin": xm.sin_f32,
          "atan": xm.atan_f32}[op]
    args_cpu = (torch.from_numpy(a), torch.from_numpy(b))[:2 if op == "atan2" else 1]
    args = tuple(t.to(cuda) for t in args_cpu)
    got, card = crater_block_cuda.xla_math(op, *args), fn(*args)
    assert torch.equal(got.view(torch.int32), card.view(torch.int32))
    assert torch.equal(card.cpu().view(torch.int32), fn(*args_cpu).view(torch.int32))


# (LR shape, factor, crop start, crop size or None for the rest): the crops
# of tests/test_torch_upsample_block.py (the streamed block, crops inside
# a GEMV tile, the tails of one and of several columns in both passes),
# then full upsamples
UPSAMPLE_BLOCK_CASES = [
    ((9, 9), 200, (400, 400), (1000, 1000)), ((9, 9), 20, (3, 5), (45, 91)),
    ((7, 12), 3, (13, 20), (8, 16)), ((5, 9), 5, (17, 30), (8, 15)),
    ((6, 17), 7, (5, 100), (37, 19)), ((9, 12), 3, (1, 2), (25, 33)), ((4, 6), 1, (1, 2), (3, 3)),
    ((9, 9), 200, (1799, 1799), (1, 1)), ((3, 17), 2, (0, 0), None), ((9, 9), 20, (0, 0), None),
    ((9, 9), 200, (0, 0), None), ((7, 12), 3, (0, 0), None), ((5, 5), 8, (0, 0), None),
    ((9, 9), 200, (0, 0), (1800, 1799)), ((9, 9), 200, (1, 0), (1799, 1800)),
]


@pytest.mark.parametrize("shape,factor,start,size", UPSAMPLE_BLOCK_CASES)
def test_upsample_taps_kernel_matches_plain_on_card(cuda, shape, factor, start, size):
    """The block upsample kernel (csrc/upsample_taps.cu) ``torch.equal`` to
    its plain version (``upsample.upsample_block_plain``: both passes of
    ``_tap_sum``, then the slice) on the same tables, one launch a call
    (``upsample_block`` and the full ``upsample_bicubic``), and the card's
    crop ``torch.equal`` to the CPU's."""
    import numpy as np

    from husky_rover_mppi_isaacsim_torch.ops.upsample_cuda import upsample_taps_cuda
    from husky_rover_mppi_isaacsim_torch.terrain import upsample as tup

    lr = torch.from_numpy(np.random.default_rng(factor + shape[1]).normal(0, 50, shape)
                          .astype(np.float32))
    lr_d = lr.to(cuda)
    before = upsample_taps_cuda.launches
    got = tup.upsample_block(lr_d, factor, start, size)
    assert upsample_taps_cuda.launches == before + 1
    assert got.is_contiguous()
    tables = [tup.axis_tables(n, factor, torch.float32, lr_d.device) for n in shape]
    want = tup.upsample_block_plain(lr_d, *tables, start, tuple(got.shape))
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), tup.upsample_block(lr, factor, start, size))
    if size is None:
        full = tup.upsample_bicubic(lr_d, factor)
        assert upsample_taps_cuda.launches == before + 2
        assert torch.equal(full, got)


def test_upsample_block_wrapper_raises_on_card(cuda):
    """On the card the block upsample launches or raises: a float64 patch,
    a patch or a table of another rank, inputs on two devices and a crop
    off the upsample are refused, and nothing launches."""
    from husky_rover_mppi_isaacsim_torch.ops.upsample_cuda import upsample_taps_cuda
    from husky_rover_mppi_isaacsim_torch.terrain import upsample as tup

    lr = torch.ones((9, 9), device=cuda)
    rows = cols = tup.axis_tables(9, 20, torch.float32, lr.device)
    before = upsample_taps_cuda.launches
    with pytest.raises(TypeError, match="float32"):
        upsample_taps_cuda(lr.double(), rows, cols, (0, 0), (10, 10))
    with pytest.raises(ValueError, match="patch"):
        upsample_taps_cuda(lr[None], rows, cols, (0, 0), (10, 10))
    with pytest.raises(ValueError, match="patch"):
        upsample_taps_cuda(lr, (rows[0][:, :2], rows[1][:, :2]), cols, (0, 0), (10, 10))
    with pytest.raises(ValueError, match="devices"):
        upsample_taps_cuda(lr, tuple(t.cpu() for t in rows), cols, (0, 0), (10, 10))
    with pytest.raises(ValueError, match="leaves"):
        upsample_taps_cuda(lr, rows, cols, (175, 0), (10, 10))
    with pytest.raises(ValueError, match="leaves"):
        tup.upsample_block(lr, 20, (0, 0), (181, 10))
    assert upsample_taps_cuda.launches == before


def test_crater_block_wrapper_raises_on_card(cuda):
    """On the card the wrapper launches or raises: a float64 raster, a
    raster that is not square or not contiguous, int64 placements, tile
    lists of another dtype and columns on the CPU are refused."""
    from husky_rover_mppi_isaacsim_torch.ops.crater_block_cuda import TileBins, crater_block_cuda

    prof, field, row0, col0 = _crater_tier(cuda, 64, 48, 32, 7, 200)
    buf = torch.zeros((200, 200), device=cuda)
    args = (0.025, 1.0, 48)
    with pytest.raises(TypeError, match="float32"):
        crater_block_cuda(buf.double(), prof, field, row0, col0, *args)
    with pytest.raises(ValueError, match="square"):
        crater_block_cuda(buf[:, :150], prof, field, row0, col0, *args)
    with pytest.raises(ValueError, match="contiguous"):
        crater_block_cuda(buf.t(), prof, field, row0, col0, *args)
    with pytest.raises(TypeError, match="int32"):
        crater_block_cuda(buf, prof, field, row0.long(), col0, *args)
    with pytest.raises(ValueError, match="devices"):
        crater_block_cuda(buf, prof, type(field)(*(f.cpu() for f in field)), row0, col0, *args)
    bad = TileBins(*(torch.zeros(n, dtype=torch.int64, device=cuda) for n in (1, 2, 1)))
    with pytest.raises(ValueError, match="int32"):
        crater_block_cuda(buf, prof, field, row0, col0, *args, bins=bad)
    assert not bool(buf.any())


def test_crater_block_sdg_field_on_card(cuda):
    """The SDG yard's crater field (cfg/mode/sdg.yaml's 500^2 moonyard at
    0.02 m/px, its whole field in one launch) through ``MoonyardGenerator``
    against the same generator on the plain version: the same DEM."""
    from unittest import mock

    from husky_rover_mppi_isaacsim_torch.ops import crater_block_cuda as block_module
    from husky_rover_mppi_isaacsim_torch.terrain import craters as tcr
    from husky_rover_mppi_isaacsim_torch.terrain.smallscale import MoonyardConf, MoonyardGenerator

    dems, launches = [], []
    for plain in (False, True):
        block_module.crater_block_cuda.launches = 0
        with (mock.patch.object(block_module, "crater_block_cuda", tcr.crater_block_plain)
              if plain else contextlib.nullcontext()):
            dems.append(MoonyardGenerator(MoonyardConf(), device=cuda).randomize())
        launches.append(block_module.crater_block_cuda.launches)
    assert torch.equal(*dems) and launches == [1, 0]


def test_streamed_blocks_on_the_stamp_kernel_equal_the_plain_loop_on_card(cuda):
    """A small streamed window built with the crater block kernel and with
    its plain version (render, then the slice-add stamp) in its place: the
    same window, bit for bit; the kernel launches once per radius tier with
    craters, the plain version never."""
    from unittest import mock

    import numpy as np

    from husky_rover_mppi_isaacsim_torch.ops import crater_block_cuda as block_module
    from husky_rover_mppi_isaacsim_torch.terrain import craters as tcr
    from husky_rover_mppi_isaacsim_torch.terrain import streaming as tstream
    from husky_rover_mppi_isaacsim_torch.terrain.map_manager import synthetic_lola_dem

    conf = tstream.StreamerConf(block_size=10.0, resolution=0.025, lr_resolution=2.0,
                                num_blocks=1, pad_size=2.0, seed=57, native_pool="never")
    lr = synthetic_lola_dem(256, 2.0, seed=42)
    windows, launches = [], []
    for plain in (False, True):
        block_module.crater_block_cuda.launches = 0
        with (mock.patch.object(block_module, "crater_block_cuda", tcr.crater_block_plain)
              if plain else contextlib.nullcontext()):
            s = tstream.TerrainStreamer(conf, lr, device=cuda)
            s.update((5.0, 5.0))
            s.update((16.0, 5.0))  # a shift: entering blocks rendered too
        windows.append(s.window)
        launches.append(block_module.crater_block_cuda.launches)
    assert torch.equal(*windows) and launches[1] == 0
    assert 0 < launches[0] <= len(s._tier_specs) * len(s.block_cache)
    assert np.isfinite(windows[0].cpu().numpy()).all()


@pytest.mark.parametrize("rendering", ["ray_tracing", "path_tracing"])
def test_sdg_frame_graphs_equal_eager_on_card(cuda, tmp_path, rendering):
    """Three SDG frames (the 500^2 yard, a different rock count each, the
    camera with cast shadows) through the eager labeler and through the
    graphed one (rocks padded to the conf's capacity): every modality
    equal; the top-down and camera passes replayed as graphs from the
    second frame on."""
    import numpy as np

    from husky_rover_mppi_isaacsim_torch import cli
    from husky_rover_mppi_isaacsim_torch.aux import labeling as lab
    from husky_rover_mppi_isaacsim_torch.terrain.point_process import BoundingBox, hardcore_poisson
    from husky_rover_mppi_isaacsim_torch.terrain.smallscale import MoonyardConf, MoonyardGenerator

    settings = cli.render_settings_from_cfg(cli.compose([f"rendering={rendering}"]))
    cap = lab.rock_capacity(0.08, 100.0)
    labelers = {name: lab.AutonomousLabeling(
        lab.LabelingConf(data_dir=str(tmp_path / name), save_instances=True), settings,
        rock_capacity=c) for name, c in (("eager", None), ("graph", cap))}
    gen = MoonyardGenerator(MoonyardConf(), device=cuda)
    rng = np.random.default_rng(5)
    counts = set()
    for frame in range(3):
        dem = gen.randomize()
        xy, r = hardcore_poisson(rng, BoundingBox(0.0, 10.0, 0.0, 10.0), (0.08,), ((0.08, 0.4),))
        counts.add(len(r))
        sun = (0.3 * frame - 0.4, 0.4, 0.5)
        outs = {}
        for name, labeler in labelers.items():
            top = labeler.record(dem, 0.02, sun_direction=sun, rock_xy=xy, rock_radius=r)
            cam = labeler.record_camera(dem, 0.02, (0.0, 0.0), (3.0 + frame, 4.0), (0.6, 0.8),
                                        float(dem[150, 200]), lab.CameraIntrinsics(160, 120),
                                        sun_direction=sun, rock_xy=xy, rock_radius=r, steps=128,
                                        cast_shadows=True, frame=frame)
            outs[name] = top, cam
        (te, ce), (tg, cg) = outs["eager"], outs["graph"]
        assert te.keys() == tg.keys() and all(np.array_equal(te[k], tg[k]) for k in te)
        assert ce.keys() == cg.keys() and all(torch.equal(ce[k], cg[k]) for k in ce)
    graphed = labelers["graph"]
    assert graphed.top_down_fn.replays == graphed.camera_fn.replays == 2 and len(counts) > 1


def test_graphed_chunk_reads_its_window_in_place_on_card(cuda):
    """A graph's in-place argument is read where it lies: a write into it
    after the capture reaches the next replay with no copy (the graph holds
    no buffer of it), and another tensor in its place raises."""
    from husky_rover_mppi_isaacsim_torch.core.graphs import Graphed

    g = Graphed(lambda w, s: (w * s).sum(), in_place_args=(0,))
    w, s = torch.ones((64, 64), device=cuda), torch.full((), 2.0, device=cuda)
    g(w, s)
    g(w, s)  # the capture
    w.add_(1.0)
    assert float(g(w, s)) == 2.0 * 2.0 * 64 * 64 and g.replays == 2
    assert all(b is None or b.data_ptr() != w.data_ptr() for b in g._static_in)
    with pytest.raises(ValueError, match="in-place"):
        g(w.clone(), s)


# -- the planar rollout kernel (csrc/rollout_2d.cu) and the thesis drivers --


def _thesis_hf(device, size_m=40.0):
    hw = size_m / 2
    return HeightField.create(thesis_statistics_terrain(size_m=size_m, device=device), hw)


# (rovers, samples, horizon, start off the DEM): the 2D arm's K values, a
# ragged shape and a start beyond the window's corner; then K = 1 and 33
# (most of a block's samples dead) and the horizon's edges: H = 1 is one
# partial ring chunk, H = 37 gives slices that are not 16-byte aligned
# (staged by plain loads, the tables built one step at a time), H = 256 is
# MAX_HORIZON (the most shared memory)
ROLLOUT_2D_CASES = [(1, 1000, 100, False), (1, 500, 100, False), (1, 350, 100, False),
                    (1, 33, 37, False), (1, 1000, 100, True), (4, 1000, 100, False),
                    (4, 33, 37, True)]
ROLLOUT_2D_CASES += [(1, k, h, False) for k in (1, 33, 350, 1000) for h in (1, 37, 100, 256)
                     if (1, k, h, False) not in ROLLOUT_2D_CASES]


@pytest.mark.parametrize("n,k,h,off_map", ROLLOUT_2D_CASES)
def test_rollout_2d_kernel_matches_plain_on_card(cuda, n, k, h, off_map):
    """Both outputs bit-equal to the plain rollout_2d in one launch; N
    rovers in one launch equal N one-rover launches."""
    hf = _thesis_hf(cuda)
    g = torch.Generator(device=cuda).manual_seed(k + h + n)
    lin = torch.rand((n, k, h), generator=g, device=cuda) * 2.0
    ang = torch.rand((n, k, h), generator=g, device=cuda) * 2.0 - 1.0
    pos = torch.rand((n, 2), generator=g, device=cuda) * 30.0 - 15.0
    if off_map:  # beyond the 20 m half width, near the (-20, 20) corner
        pos = pos / 15.0 + torch.tensor([-21.0, 21.0], device=cuda)
    heading = torch.rand((n, 3), generator=g, device=cuda) - 0.5
    if n == 1:
        lin, ang, pos, heading = lin[0], ang[0], pos[0], heading[0]
    before = rollout_2d_cuda.launches
    got = rollout_2d_cuda(hf, pos, heading, lin, ang, 0.045)
    torch.cuda.synchronize()
    assert rollout_2d_cuda.launches == before + 1
    want = tro.rollout_2d(hf, pos[..., None, :], heading[..., None, :], lin, ang, 0.045)
    for a, b in zip(got, want):
        assert a.shape == lin.shape + (3,) and a.is_contiguous()
        assert torch.equal(a, b)
    if n > 1:
        for i in range(n):
            one = rollout_2d_cuda(hf, pos[i], heading[i], lin[i], ang[i], 0.045)
            assert all(torch.equal(a[i], b) for a, b in zip(got, one))


# start headings scaled by 2^e: their norms fall below, inside and beyond
# the fast forms' moderate range [2^-60, 2^60), and e = -66 squares to
# subnormals. The rotation keeps a heading's length, so the start heading
# sets the norms the guard and the divisions see (velocities cannot make
# them tiny); some samples stand still (v = 0) or do not turn (w = 0)
HEADING_SCALE_EXPS = [-66, -62, -61, -60, -59, 58, 59, 60, 61, 63]


@pytest.mark.parametrize("e", HEADING_SCALE_EXPS)
def test_rollout_2d_kernel_at_the_fast_forms_edges_on_card(cuda, e):
    """Chunks whose operands leave the moderate range take the exact
    recompute; both outputs stay bit-equal to the plain rollout_2d."""
    hf = _thesis_hf(cuda)
    g = torch.Generator(device=cuda).manual_seed(e + 100)
    lin = torch.rand((64, 24), generator=g, device=cuda) * 2.0
    ang = torch.rand((64, 24), generator=g, device=cuda) * 2.0 - 1.0
    lin[::4] = 0.0
    ang[1::4] = 0.0
    pos = torch.tensor([3.0, -4.0], device=cuda)
    heading = torch.tensor([0.6, -0.8, 0.3], device=cuda) * 2.0 ** e
    got = rollout_2d_cuda(hf, pos, heading, lin, ang, 0.045)
    want = tro.rollout_2d(hf, pos[None], heading[None], lin, ang, 0.045)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert torch.isfinite(got[0]).all()


def test_rollout_2d_kernel_keeps_a_zero_planar_heading_on_card(cuda):
    """A vertical start heading rotates to a planar norm of exactly 0: the
    guard keeps the zero heading (one step: a second would divide 0 by 0)."""
    hf = _thesis_hf(cuda)
    lin = torch.linspace(0.0, 2.0, 40, device=cuda)[:, None]
    ang = torch.linspace(-1.0, 1.0, 40, device=cuda)[:, None]
    pos = torch.tensor([-2.0, 5.0], device=cuda)
    heading = torch.tensor([0.0, 0.0, 0.5], device=cuda)
    got = rollout_2d_cuda(hf, pos, heading, lin, ang, 0.045)
    want = tro.rollout_2d(hf, pos[None], heading[None], lin, ang, 0.045)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert (got[1] == 0).all() and torch.equal(got[0][..., :2], pos.expand(40, 1, 2))


def test_rollout_2d_libm_matches_torch_on_card(cuda):
    """The kernel's cosf and sinf give torch's bits on w * dt over the
    angular velocities a control step can command, and beyond."""
    w = torch.linspace(-4.0, 4.0, 1 << 20, device=cuda)
    theta = (w * 0.045).contiguous()
    for op in ("cos", "sin"):
        assert torch.equal(rollout_2d_cuda.libm(op, theta), getattr(torch, op)(theta))


def test_thesis_drivers_run_on_card(cuda, monkeypatch):
    """Each driver of mppi/thesis_runs.py at a small size on the card (6
    runs per arm, K=64, H=20, a 40 m map with the protocol's band cut to
    fit): finite traces, the kernel routes, and the card's record."""
    import numpy as np

    from husky_rover_mppi_isaacsim_torch.mppi import thesis_runs as tr

    def pairs(runs_per_arm, half_width, seed):
        rng = np.random.default_rng(seed)
        return [(rng.uniform(-12.0, -8.0, 2), rng.uniform(8.0, 12.0, 2), [1.0, 0.3, 0.0])
                for _ in range(runs_per_arm)]

    monkeypatch.setattr(evaluation, "thesis_pairs", pairs)
    kw = dict(horizon=20, half_width=20.0, device=cuda)
    rollout_2d_cuda.launches = 0
    tables = {
        "r04": tr.thesis_eval(6, ks=(64,), ablation_k=64, max_loops=40, **kw),
        "calib": tr.eval_r05_calib(z_scales=(0.7,), k=64, runs_per_arm=6, max_loops=40, **kw),
        "r05": tr.eval_r05_full(0.7, runs_per_arm=6, ks=(64,), max_loops=40, **kw),
        "eval": tr.eval_experiment(6, ks=(64,), max_loops=40, horizon=20, half_width=20.0,
                                   grid_size=400, costmap_size=200, device=cuda),
    }
    assert rollout_2d_cuda.launches > 0
    for name, table in tables.items():
        config = table["config"]
        assert config["kernel_routes"] == {"rollout_3d": "cuda", "rollout_2d": "cuda"}
        assert "NVIDIA" in config["device"]["name"] and config["device"]["power_limit"]
    for table in (tables["r04"], tables["r05"]):
        assert all(arm["finite"] for arm in table["per_k"][64]["arms"].values())
    assert tables["r05"]["collision_free_pct"] == tr.arm_summary(tables["r05"]["per_k"])


def test_graft_entry_on_card(cuda, tmp_path):
    """``graft_entry_torch.py``: ``entry()``'s step on the card launches K1
    twice (samples and optimal rollout) with finite outputs, and
    ``dryrun_multichip(2)`` holds its two gloo ranks on the card to
    ``mppi_step`` (raises otherwise)."""
    import graft_entry_torch

    fn, args = graft_entry_torch.entry()
    assert args[0].z.is_cuda
    rollout_25d_cuda.launches = 0
    ctrl, out = fn(*args)
    torch.cuda.synchronize()
    assert rollout_25d_cuda.launches == 2
    assert torch.isfinite(out.costs).all() and all(torch.isfinite(t).all() for t in ctrl)
    report = graft_entry_torch.dryrun_multichip(2, device=cuda, workdir=tmp_path)
    assert report["mesh"] == [2, 1] and report["k1_launches_per_rank"] == [2, 2]


JAX_NORMAL_CASES = [  # shape, path, next path, offset, outer stride
    ((2, 1000, 100), SPLIT_SUB, SPLIT_NEXT, 0, None),
    ((2, 16384, 64), SPLIT_SUB, SPLIT_NEXT, 0, None),
    ((2, 4000, 100), (("split", 2, 0),), None, 0, None),
    ((4,), (("split", 2, 1), ("split", 2, 0)), None, 0, None),
    ((4096,), (("split", 2, 1), ("split", 2, 1)), None, 0, None),
    ((2, 1000, 100), (("fold_in", 517),), None, 0, None),
    ((3, 5, 7), (("fold_in", -3), ("split", 12, 11), ("split", 2, 1), ("split", 2, 0)),
     SPLIT_NEXT, 0, None),
    ((2, 250 * 100), (), None, 750 * 100, 1000 * 100),
    ((0,), (), SPLIT_NEXT, 0, None),
]


@pytest.mark.parametrize("seed", [0, 42, 2 ** 33 + 5])
@pytest.mark.parametrize("case", range(len(JAX_NORMAL_CASES)))
def test_jax_normal_kernel_matches_plain_on_card(cuda, seed, case):
    """The jax_normal kernel against its plain version on the same key, at
    the loops' shapes: the control noise with its split, bench.py's batch,
    the closed loop's (2, N*K, H), the two slip draws, a fold-in, a path of
    four steps, the last rows of a (2, 1000, 100) draw by count offset, a
    split alone: ``torch.equal``, the next key too, and the card's plain
    draw equal to the CPU's."""
    shape, path, nxt, offset, stride = JAX_NORMAL_CASES[case]
    key = jr.key(seed, cuda)
    before = jax_normal.launches
    res = jax_normal(key, shape, path=path, next_path=nxt, offset=offset, outer_stride=stride)
    assert jax_normal.launches - before == 1
    got, got_key = (res, None) if nxt is None else res
    want = jr.normal(jr.derive(key, path), shape, torch.float32, offset, stride)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    assert torch.equal(got, want)
    assert torch.equal(got.cpu(), jr.normal(jr.derive(jr.key(seed), path), shape,
                                            torch.float32, offset, stride))
    if nxt is not None:
        assert torch.equal(got_key, jr.derive(key, nxt))


def test_jax_normal_count_offset_is_a_slice_of_the_full_draw_on_card(cuda):
    """A rank's block of samples drawn alone equals the slice of the full
    draw (``sample_noise_block``)."""
    from husky_rover_mppi_isaacsim_torch.mppi.sampling import sample_noise, sample_noise_block

    key = jr.key(0, cuda)
    full = sample_noise(key, 1000, 100)
    for start, stop in ((0, 500), (500, 1000), (250, 750)):
        assert torch.equal(sample_noise_block(key, 1000, 100, start, stop),
                           full[:, start:stop])


def test_jax_normal_device_scalar_in_a_graph_on_card(cuda):
    """A fold-in of a device scalar: a graph captured at index 0 and
    replayed after the scalar changes draws the new index's noise; the key
    a loop carries advances once per replay (``split`` applied n times)."""
    key0 = jr.key(42, cuda)
    idx = torch.zeros((), dtype=torch.int64, device=cuda)
    path = (("fold_in", idx), ("split", 12, 5))
    jax_normal(key0, (2, 64, 30), path=path)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = jax_normal(key0, (2, 64, 30), path=path)
    for i in (3, 7, 11):
        idx.fill_(i)
        graph.replay()
        torch.cuda.synchronize()
        want = jr.normal(jr.split(jr.fold_in(jr.key(42), i), 12)[5], (2, 64, 30))
        assert torch.equal(out.cpu(), want)

    from husky_rover_mppi_isaacsim_torch.core.graphs import Graphed

    def step(key):
        noise, key = jax_normal(key, (2, 64, 30), path=SPLIT_SUB, next_path=SPLIT_NEXT)
        return noise, key

    graphed, key, want_key = Graphed(step), jr.key(9, cuda), jr.key(9)
    for _ in range(6):  # eager, capture and replay, then replays
        noise, key = graphed(key)
        want_key, sub = jr.split(want_key)
        assert torch.equal(noise.cpu(), jr.normal(sub, (2, 64, 30)))
        assert torch.equal(key.cpu(), want_key)
        key = key.clone()
    assert graphed.replays == 5


def test_jax_normal_wrapper_raises_on_card(cuda):
    """float64, a batch of keys, a path of five steps or two device scalars
    are refused on the card, never drawn by the plain version."""
    key = jr.key(0, cuda)
    with pytest.raises(ValueError):
        jax_normal(key, (4,), torch.float64)
    with pytest.raises(ValueError):
        jax_normal(jr.split(key, 3), (4,))
    with pytest.raises(ValueError):
        jax_normal(key, (4,), path=(("split", 2, 0),) * 5)
    one = torch.zeros((), dtype=torch.int64, device=cuda)
    with pytest.raises(ValueError):
        jax_normal(key, (4,), path=(("fold_in", one), ("fold_in", one.clone())))
