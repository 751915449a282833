"""PyTorch port on the card: kernels K1 (csrc/rollout.cu, one rover and N
rovers), K2 (csrc/edt_minplus.cu) and K3 (csrc/gather_probe.cu) against
their plain versions, the control step and the closed-loop step on the card
against the same steps on the CPU, the thesis DEM's repeatable build and the
evaluation's kernel launches.

Every test here is marked ``gpu`` and skips without a CUDA card. The file
imports no jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""

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
    mppi_step,
)
from husky_rover_mppi_isaacsim_torch.mppi import evaluation
from husky_rover_mppi_isaacsim_torch.mppi import rollout as tro
from husky_rover_mppi_isaacsim_torch.ops import edt
from husky_rover_mppi_isaacsim_torch.ops import gather_probe as gp
from husky_rover_mppi_isaacsim_torch.ops.edt_cuda import edt_minplus_cuda
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


@pytest.mark.parametrize("k,wheels", [(1000, True), (1000, False), (1, False)])
def test_k1_kernel_matches_plain_on_card(cuda, k, wheels):
    """Trajectory and headings within 5e-4, >= 98% of wheel heights
    bit-equal (the Pallas tolerances, tests/test_rollout_pallas.py:53-67)."""
    hf = _crater(cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    lin = torch.rand((k, 100), generator=g, device=cuda) * 2.0
    ang = torch.rand((k, 100), generator=g, device=cuda) * 2.0 - 1.0
    pos = torch.tensor([-45.0, -40.0], device=cuda)
    heading = torch.tensor([0.894427, 0.447214, 0.0], device=cuda)
    before = rollout_25d_cuda.launches
    got = rollout_25d_cuda(hf, pos, heading, lin, ang, 0.045, wheels=wheels)
    torch.cuda.synchronize()
    assert rollout_25d_cuda.launches == before + 1
    want = tro.rollout_25d(hf, pos, heading, lin, ang, 0.045, wheels=wheels)
    for a, b in zip(got[:2], want[:2]):
        assert a.shape == (k, 100, 3)
        assert (a - b).abs().max().item() <= 5e-4
    if wheels:
        for a, b in zip(got[2:], want[2:]):
            assert (a[..., :2] - b[..., :2]).abs().max().item() <= 5e-4
            assert (a[..., 2] == b[..., 2]).float().mean().item() >= 0.98
    else:
        assert got.left_wheel is got.trajectory


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


@pytest.mark.parametrize("wheels", [True, False])
def test_k1_rover_axis_equals_one_rover_launches(cuda, wheels):
    """N=4 rovers in one launch: rover n bit-equal to a one-rover launch of
    its inputs, and within the plain tolerances of the plain batched
    rollout; the K=1 optimal rollouts of N rovers are one launch too."""
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
        for a, b in zip(got[:2], want[:2]):
            assert (a - b).abs().max().item() <= 5e-4
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
    """One closed-loop step for N=3 rovers: two K1 launches, no host sync,
    and the step-card-vs-CPU tolerances on the commands and poses."""
    cfg = tenv.ClosedLoopConfig(mppi=MPPIConfig(num_samples=256, horizon=50))
    cost = torch.rand((64, 64), generator=torch.Generator().manual_seed(1)) ** 4
    noise = torch.randn((3, 2, 256, 50), generator=torch.Generator().manual_seed(2))
    starts = [[-10.0, -8.0], [5.0, -12.0], [8.0, 9.0]]
    goals = [[18.0, 15.0], [-15.0, 10.0], [0.0, -18.0]]

    def run(device):
        hf = _crater(device, grid=512, hw=25.0)
        cm = as_costmap(cost, 25.0, device=device)
        state = tenv.init_loop_state(cfg, tenv.RoverState.create(starts, [1.0, 0.3, 0.0], hf))
        g = torch.tensor(goals, device=device)
        noise_d = noise.to(device)
        if device.type != "cuda":
            return tenv.closed_loop_step(cfg, hf, cm, g, state, noise=noise_d)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")  # the step never waits for the card
        try:
            return tenv.closed_loop_step(cfg, hf, cm, g, state, noise=noise_d)
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
    if kind == "random_187x875":
        g = torch.Generator(device=device).manual_seed(3)
        return torch.rand((187, 875), generator=g, device=device) < 0.02
    size = int(kind.split("_")[1])
    raster = rasterize_obstacles(generate_obstacles(), half_width=75.0, size=size,
                                 robot_radius=0.3)
    return torch.from_numpy(raster == 0).to(device)


@pytest.mark.parametrize("kind", ["costmap_750", "costmap_1500", "random_187x875"])
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


def test_evaluation_run_on_card_launches_k1_and_k2(cuda):
    """K1 runs twice per 3D-arm step (samples + optimal rollout) and once
    per 2D-arm step (the optimal rollout); K2 once, for the costmap."""
    rollout_25d_cuda.launches = edt_minplus_cuda.launches = 0
    table = evaluation.run_2d_vs_3d_experiment(
        ks=(64,), runs_per_arm=1, horizon=20, max_loops=10, half_width=20.0, grid_size=400,
        costmap_size=200, span_fraction=0.3, device=cuda)
    entry = table["per_k"][64]
    assert entry["steps"]["3d"] > 0 and entry["finite"] == {"3d": True, "2d": True}
    assert rollout_25d_cuda.launches == 2 * entry["steps"]["3d"] + entry["steps"]["2d"]
    assert edt_minplus_cuda.launches == 1
