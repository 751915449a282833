"""PyTorch port: ``MPPIController`` against the JAX package's.

``step(noise=)`` replays the same numpy noise through both controllers and
is held at the tolerances of ``tests/test_torch_controller.py`` (float64).
Without ``noise`` both draw each loop's noise from ``loop_key(key(seed),
loop seed)`` (the loop seeds of the reference's ``LoopSeedSequence``, the
same numpy stream in both packages): JAX's draw within a few float64 ulps,
so ``step`` and ``run`` follow JAX's controller at those tolerances and at
``tests/test_torch_controller.py``'s ``SEEK_ATOL`` over a run."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch import convert
from husky_rover_mppi_isaacsim_torch.core import jax_random as jrand
from husky_rover_mppi_isaacsim_torch.mppi import MPPIController
from husky_rover_mppi_isaacsim_torch.mppi import controller as tc
from husky_rover_mppi_isaacsim_torch.mppi.sampling import LoopSeedSequence, loop_key, sample_noise
from husky_rover_mppi_isaacsim_torch.ops.rollout_cuda import rollout_25d_cuda
from husky_rover_mppi_isaacsim_tpu.mppi import controller as jc

from test_torch_controller import SEEK_ATOL, TOL, _close, _states, _world

torch.set_num_threads(1)

GOAL = (15.0, 12.0)


def _controllers(jcfg, seed=42):
    (jhf, jcm), (thf, tcm) = _world()
    tcfg = convert.config_from_jax(jcfg)
    jctl = jc.MPPIController(jcfg, jhf, jcm, GOAL, seed=seed)
    tctl = MPPIController(tcfg, thf, tcm, GOAL, seed=seed, device="cpu")
    return jctl, tctl, tcfg


@pytest.mark.parametrize("variant,n_steps", [(dict(exact=True), 3), (dict(exact=False), 3),
                                             (dict(exact=True, slope_critic="body"), 1)],
                         ids=["exact", "matmul", "body_slope"])
def test_step_with_noise_matches_jax(rng, variant, n_steps):
    """Chained steps with injected noise, each followed by the kinematic
    advance, on both controllers (three steps, and one for the body-slope
    variant, as tests/test_torch_controller.py chains them)."""
    jcfg = jc.MPPIConfig(num_samples=24, horizon=30, **variant)
    jctl, tctl, tcfg = _controllers(jcfg)
    (jr, jctrl), (tr, tctrl) = _states(jcfg, -10.0, -8.0, [1.0, 0.4, 0.0])
    before = rollout_25d_cuda.launches
    for n in range(n_steps):
        noise = rng.normal(size=(2, 24, 30))
        jctrl, jout = jctl.step(jr, jctrl, jnp.asarray(noise))
        tctrl, tout = tctl.step(tr, tctrl, torch.from_numpy(noise))
        for name, (rtol, atol) in TOL.items():
            _close(getattr(tout, name), getattr(jout, name), rtol, atol, name)
        for name in ("optimal_u1", "optimal_u2", "std_u1", "std_u2"):
            _close(getattr(tctrl, name), getattr(jctrl, name), 0, 1e-12, name)
        jr = jc.kinematic_advance(jcfg, jr, jout)
        tr = tc.kinematic_advance(tcfg, tr, tout)
        for a, b in zip(tr, jr):
            _close(a, b, 0, 1e-10, "robot")
        assert tctl.loop == jctl.loop == n + 1
    assert rollout_25d_cuda.launches == before  # CPU tensors: the plain rollout


def test_step_equals_mppi_step():
    """``step(noise=)`` is ``mppi_step`` on the controller's world and goal."""
    jcfg = jc.MPPIConfig(num_samples=16, horizon=12)
    _, tctl, tcfg = _controllers(jcfg)
    robot = tc.RobotState.create(-3.0, 2.0, [1.0, -0.2, 0.0], dtype=torch.float64)
    ctrl = tc.ControllerState.create(tcfg, torch.float64)
    noise = torch.randn((2, 16, 12), generator=torch.Generator().manual_seed(2),
                        dtype=torch.float64)
    got = tctl.step(robot, ctrl, noise)
    want = tc.mppi_step(tcfg, tctl.hf, tctl.costmap, tctl.goal, robot, ctrl, noise)
    for a, b in zip(got[0] + got[1][:-1], want[0] + want[1][:-1]):
        assert torch.equal(a, b)


def test_seed_stream_is_replayable():
    """Loop n draws ``sample_noise(loop_key(key(seed), n-th LoopSeedSequence
    seed))``, the JAX controller's draw: two controllers of one seed step
    identically, another seed differs, and each step is the JAX
    controller's step at the controller tests' tolerances."""
    jcfg = jc.MPPIConfig(num_samples=16, horizon=12)
    jctl, a, tcfg = _controllers(jcfg, seed=7)
    _, b, _ = _controllers(jcfg, seed=7)
    _, c, _ = _controllers(jcfg, seed=8)
    (jrob, jctrl), (robot, ctrl) = _states(jcfg, -3.0, 2.0, [1.0, -0.2, 0.0])
    seeds = LoopSeedSequence(12, 7)
    for _ in range(3):
        noise = sample_noise(loop_key(jrand.key(7), seeds.next_seed()), 16, 12, torch.float64)
        want = tc.mppi_step(tcfg, a.hf, a.costmap, a.goal, robot, ctrl, noise)
        got_a, got_b, got_c = a.step(robot, ctrl), b.step(robot, ctrl), c.step(robot, ctrl)
        assert torch.equal(got_a[1].costs, want[1].costs)
        assert torch.equal(got_b[1].costs, want[1].costs)
        assert not torch.equal(got_c[1].costs, want[1].costs)
        _, jout = jctl.step(jrob, jctrl)
        for name, (rtol, atol) in TOL.items():
            _close(getattr(got_a[1], name), getattr(jout, name), rtol, atol, name)
    # the loop seeds are the JAX controller's: the same numpy stream
    jseeds, tseeds = jc.LoopSeedSequence(12, 7), LoopSeedSequence(12, 7)
    assert [jseeds.next_seed() for _ in range(5)] == [tseeds.next_seed() for _ in range(5)]
    np.testing.assert_array_equal(a.base_key.numpy(), np.asarray(
        jax.random.key_data(jctl.base_key)).astype(np.int64))


def test_run_from_a_seed_matches_jax():
    """``run`` from the controller's seed alone (float64, 25 loops, no noise
    injected): the path and final state of JAX's ``MPPIController.run``
    from the same seed, at ``SEEK_ATOL``."""
    jcfg = jc.MPPIConfig(num_samples=16, horizon=12)
    jctl, tctl, _ = _controllers(jcfg, seed=11)
    (jrob, _), (trob, _) = _states(jcfg, -10.0, -8.0, [1.0, 0.4, 0.0])
    jfinal, _, jpath = jctl.run(jrob, max_loops=25)
    tfinal, _, tpath = tctl.run(trob, max_loops=25)
    assert tctl.loop == jctl.loop == 25
    np.testing.assert_allclose(tpath.numpy(), jpath, rtol=0, atol=SEEK_ATOL)
    for x, y in zip(tfinal, jfinal):
        _close(x, y, 0, SEEK_ATOL, "final robot")


def test_run_reaches_goal_and_honours_the_cap():
    """Float32 run on a small crater map; the trajectory starts at the
    start and holds one position per loop."""
    hw = 25.0
    from husky_rover_mppi_isaacsim_torch.terrain import as_costmap, crater_surface

    hf = tc.HeightField.create(crater_surface(256, hw, [((-12.0, 14.0), 1.5, 8.0)]), hw)
    cm = as_costmap(np.zeros((32, 32), np.float32), hw)
    cfg = tc.MPPIConfig(num_samples=128, horizon=30)
    robot = tc.RobotState.create(-2.0, -1.5, [1.0, 0.2, 0.0])
    ctl = MPPIController(cfg, hf, cm, (2.0, 1.5), seed=3, device="cpu")
    final, ctrl, path = ctl.run(robot, max_loops=300)
    assert ctl.loop < 300, final.position
    assert bool((torch.abs(final.position - torch.tensor([2.0, 1.5])) <= 0.5).all())
    assert path.shape == (ctl.loop + 1, 2) and torch.equal(path[0], robot.position)
    assert torch.equal(path[-1], final.position) and ctrl.optimal_u1.shape == (30,)
    capped = MPPIController(cfg, hf, cm, (20.0, 15.0), seed=3, device="cpu")
    _, _, path = capped.run(robot, max_loops=5)
    assert capped.loop == 5 and path.shape == (6, 2)


def test_controller_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (_, _), (thf, tcm) = _world(grid=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MPPIController(tc.MPPIConfig(), thf, tcm, GOAL)
    assert MPPIController(tc.MPPIConfig(), thf, tcm, GOAL, device="cpu").device.type == "cpu"
