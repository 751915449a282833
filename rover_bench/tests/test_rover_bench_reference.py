"""The plain reference against the port at tiny sizes on the CPU: the
same inputs give the same answers (this file imports both; the reference
imports nothing of the port)."""

import pytest
import torch

from rover_bench.harness import port
from rover_bench.harness import registry
from rover_bench.reference import heightfield as rhf
from rover_bench.reference import jax_random as rjr
from rover_bench.reference import loops as ref
from rover_bench.reference import world as rworld

from husky_rover_mppi_isaacsim_torch.cli import build_standalone_world
from husky_rover_mppi_isaacsim_torch.core import jax_random as jr
from husky_rover_mppi_isaacsim_torch.env import closed_loop as pcl
from husky_rover_mppi_isaacsim_torch.env.rover_sim import RoverParams, RoverState
from husky_rover_mppi_isaacsim_torch.mppi import controller as pc

CONFIG = registry.load_json("configs", "thesis_k1000")
MPPI = dict(CONFIG["mppi"], num_samples=24, horizon=12)


@pytest.fixture(scope="module")
def world():
    w = dict(CONFIG["world"], grid_size=150, costmap_size=75)
    hf, cm, _ = build_standalone_world({k: w[k] for k in ("half_width", "grid_size",
                                                          "costmap_size")})
    return w, hf, cm


@pytest.mark.parametrize("path", [(), (("split", 2, 1),), (("fold_in", 7), ("split", 3, 2))])
def test_normals_are_the_ports(path):
    key = jr.key(2 ** 33 + 5)
    want = jr.normal(jr.derive(key, path), (2, 5, 7))
    got = rjr.normal(rjr.derive(key.clone(), path), (2, 5, 7))
    assert torch.equal(got, want)


def test_world_matches_the_float64_formulas(world):
    w, hf, cm = world
    z = rworld.crater_surface(w["grid_size"], w["half_width"], w["bumps"])
    assert port.max_gap(hf.z, z) < 2e-5
    o = w["obstacles"]
    occ = rworld.occupancy(rworld.obstacles(o["num"], o["seed"], o["extent"], o["r_max"]),
                           w["half_width"], w["costmap_size"], w["robot_radius"])
    assert port.max_gap(cm.cost, rworld.costmap(occ, w["falloff"])) < 1e-5


def _gap(got, want) -> float:
    """The widest gap over paired float leaves; integer and boolean leaves
    have to be equal."""
    gap = 0.0
    for a, b in zip(torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(want)):
        if a.is_floating_point():
            gap = max(gap, port.max_gap(a, b))
        else:
            assert torch.equal(a, b)
    return gap


def test_masked_steps_match_the_ports(world):
    """The float64 reference, written from the JAX package's formulas, on
    the port's world: the port's float32 steps lie within float32 rounding
    of it, two replays at once as the check runs them."""
    _, hf, cm = world
    cfg = port.mppi_config(MPPI)
    goal = torch.tensor([60.0, -5.0])
    key = jr.key(99)
    loop = torch.zeros((), dtype=torch.int64)
    e = torch.zeros((0, 3)), torch.zeros((0,))
    inputs, outputs = [], []
    for start, heading in (((-60.0, 10.0), [1.0, 0.3, 0.0]), ((10.0, -60.0), [0.0, 1.0, 0.0])):
        robot = pc.RobotState.create(*start, heading)
        ctrl = pc.ControllerState.create(cfg)
        halt = pc.goal_reached(robot.position, goal)
        r, c, lp, h, _, _, k = pc.masked_steps(cfg, 50, hf, cm, goal, robot, ctrl, loop, halt,
                                               *e, key, 4)
        inputs.append((goal, robot, ctrl, loop, halt, key))
        outputs.append((r, c, lp, h, k))
    goal, robot, ctrl, loop, halt, key = port.cast(port.stack(inputs), torch.float64)
    ref_hf = rhf.HeightField(*port.cast(tuple(hf), torch.float64))
    ref_cm = ref.Costmap(*port.cast(tuple(cm), torch.float64))
    rr, rc, rl, rh, rk, ro = ref.masked_steps(
        port.ref_mppi(MPPI), 50, ref_hf, ref_cm, goal, ref.Robot(*robot), ref.Ctrl(*ctrl), loop,
        halt, key, 4)
    r, c, lp, h, k = port.stack(outputs)
    assert _gap(r, rr) < 1e-4
    assert _gap(c, rc) < 1e-3
    assert torch.equal(lp, rl) and torch.equal(h, rh) and torch.equal(k, rk)
    assert ref.dem_cells(ref_hf, type(ro)(*(t[0] for t in ro)), robot.position[0]) > 0


def test_closed_loop_step_matches_the_ports(world):
    _, hf, cm = world
    cfg = port.mppi_config(MPPI)
    phys = dict(registry.load_json("traffic", "fleet64")["physics"])
    cl = pcl.ClosedLoopConfig(mppi=cfg, rover=RoverParams(**phys))
    rovers = RoverState.create(torch.tensor([[-50.2, 3.3], [10.4, -59.7], [0.1, 0.2]]),
                               torch.tensor([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [1.0, 1.0, 0.0]]),
                               hf)
    state = pcl.init_loop_state(cl, rovers)
    goals = torch.tensor([[60.0, 0.0], [0.0, 60.0], [-40.0, 40.0]])
    key = jr.key(7)
    idx = torch.full((), 3, dtype=torch.int64)
    ref_hf = rhf.HeightField(*port.cast(tuple(hf), torch.float64))
    ref_cm = ref.Costmap(*port.cast(tuple(cm), torch.float64))
    for _ in range(3):  # through a latch and two trims
        got = pcl.closed_loop_step(cl, hf, cm, goals, state, key, (("fold_in", idx),))
        st = port.cast(state, torch.float64)
        want = ref.closed_loop_step(
            port.ref_mppi(MPPI), ref.Physics.from_config(phys), ref.LoopConsts(), ref_hf,
            ref_cm, goals.double(), ref.Loop(ref.Rovers(*st.rovers), ref.Ctrl(*st.ctrl), *st[2:]),
            key, (("fold_in", idx),))
        assert _gap(got.rovers, want.rovers) < 1e-4
        assert _gap(got.ctrl, want.ctrl) < 1e-3
        assert _gap(got[2:], want[2:]) < 1e-4
        state = got
        idx = idx + 1


def test_reference_world_views_read_the_ports_window(world):
    """The reference's own world, read as its loops read it, has the port's
    window: the same resolution and corner, costmap cells alike."""
    from rover_bench.drivers import goal_seek as drv

    w, hf, cm = world
    ctx = type("Ctx", (), {"config": {"world": w}})()
    z = rworld.crater_surface(w["grid_size"], w["half_width"], w["bumps"])
    rhf_, rcm = drv.reference_views(ctx, z, torch.zeros(cm.cost.shape), torch.float64)
    for a, b in ((rhf_.x_min, hf.x_min), (rhf_.y_min, hf.y_min),
                 (rhf_.resolution, hf.resolution), (rcm.half_width, cm.half_width),
                 (rcm.resolution, cm.resolution)):
        assert float(a) == float(b)
