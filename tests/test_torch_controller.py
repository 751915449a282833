"""PyTorch port: the control step and the goal-seek loop against the JAX
package, fed the same world, state and numpy noise (float64, at the
tolerances of tests/test_controller.py:100-107), and the goal-seek from a
key alone against JAX's from the same key (``SEEK_ATOL``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch import convert
from husky_rover_mppi_isaacsim_torch.core import jax_random as jr
from husky_rover_mppi_isaacsim_torch.mppi import controller as tc
from husky_rover_mppi_isaacsim_torch.ops.rollout_cuda import rollout_25d_cuda
from husky_rover_mppi_isaacsim_tpu.core import HeightField as JHeightField
from husky_rover_mppi_isaacsim_tpu.mppi import controller as jc
from husky_rover_mppi_isaacsim_tpu.mppi import sampling as jsamp
from husky_rover_mppi_isaacsim_tpu.terrain import as_costmap, crater_surface

# small tensors: one intra-op thread each, so that the test workers running
# beside these do not lose their cores
torch.set_num_threads(1)

# field -> (rtol, atol), tests/test_controller.py:100-107. The weights'
# atol: the packages reduce in different orders, and a 1e-14 relative cost
# difference moves exp(-(c - min)/T) by 1e-11 relative once (c - min)/T nears
# 150; weights under 1e-20 (the best sample's is 1) carry no mass.
TOL = {
    "costs": (1e-12, 0), "weights": (1e-11, 1e-20),
    "optimal_linear": (0, 1e-12), "optimal_angular": (0, 1e-12),
    "linear_velocity": (0, 1e-12), "angular_velocity": (0, 1e-12),
    "optimal_trajectory": (0, 1e-10), "optimal_headings": (0, 1e-10),
}

_jstep = jax.jit(jc.mppi_step, static_argnums=0)
_jadvance = jax.jit(jc.kinematic_advance, static_argnums=0)


def _world(grid=200, hw=25.0):
    z = np.asarray(crater_surface(grid, hw, [((-5.0, 8.0), 2.0, 6.0),
                                             ((10.0, -6.0), 3.0, 8.0)], dtype=jnp.float64))
    jhf = JHeightField.create(z, hw, dtype=jnp.float64)
    cm_img = np.random.default_rng(7).uniform(0, 0.9, (grid // 8, grid // 8)) ** 4
    jcm = as_costmap(cm_img, hw, dtype=jnp.float64)
    thf = convert.heightfield_from_numpy(*(np.asarray(a) for a in jhf))
    tcm = convert.costmap_from_numpy(*(np.asarray(a) for a in jcm))
    return (jhf, jcm), (thf, tcm)


def _states(jcfg, x, y, heading):
    jr = jc.RobotState.create(x, y, heading, dtype=jnp.float64)
    jctrl = jc.ControllerState.create(jcfg, jnp.float64)
    tr = convert.robot_state_from_numpy(*(np.asarray(a) for a in jr))
    tctrl = convert.controller_state_from_numpy(*(np.asarray(a) for a in jctrl))
    return (jr, jctrl), (tr, tctrl)


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


def _steps_match(rng, variant, n_steps):
    (jhf, jcm), (thf, tcm) = _world()
    jcfg = jc.MPPIConfig(num_samples=24, horizon=30, **variant)
    tcfg = convert.config_from_jax(jcfg)
    (jr, jctrl), (tr, tctrl) = _states(jcfg, -10.0, -8.0, [1.0, 0.4, 0.0])
    goal = np.array([15.0, 12.0])
    before = rollout_25d_cuda.launches
    for _ in range(n_steps):
        noise = rng.normal(size=(2, 24, 30))
        jctrl, jout = _jstep(jcfg, jhf, jcm, jnp.asarray(goal), jr, jctrl, jnp.asarray(noise))
        tctrl, tout = tc.mppi_step(tcfg, thf, tcm, torch.from_numpy(goal), tr, tctrl,
                                   torch.from_numpy(noise))
        for name, (rtol, atol) in TOL.items():
            _close(getattr(tout, name), getattr(jout, name), rtol, atol, name)
        if jcfg.return_rollouts:
            assert tout.rollouts.shape == (24, 30, 3)
            _close(tout.rollouts, jout.rollouts, 0, 1e-10, "rollouts")
        else:
            assert tout.rollouts is None and jout.rollouts is None
        for name in ("optimal_u1", "optimal_u2", "std_u1", "std_u2"):
            _close(getattr(tctrl, name), getattr(jctrl, name), 0, 1e-12, name)
        jr = _jadvance(jcfg, jr, jout)
        tr = tc.kinematic_advance(tcfg, tr, tout)
        for a, b in zip(tr, jr):
            _close(a, b, 0, 1e-10, "robot")
    assert rollout_25d_cuda.launches == before  # CPU tensors: the plain rollout


@pytest.mark.parametrize("exact", [True, False])
def test_mppi_step_chain_matches_jax(rng, exact):
    """Three chained control steps, each followed by the kinematic advance."""
    _steps_match(rng, dict(exact=exact), 3)


@pytest.mark.parametrize("variant", [dict(slope_critic="body", return_rollouts=True),
                                     dict(projection="2d", return_rollouts=True)],
                         ids=["body_slope", "projection_2d"])
def test_mppi_step_variants_match_jax(rng, variant):
    _steps_match(rng, dict(exact=True, **variant), 1)


@pytest.mark.parametrize("wheel_speed", [0.0, 1.0, -0.25])
def test_robot_state_create_matches_jax(wheel_speed):
    """The thesis protocol starts every run rolling at 1 m/s."""
    jr = jc.RobotState.create(2.5, -1.0, [0.3, -0.8, 0.1], dtype=jnp.float64,
                              wheel_speed=wheel_speed)
    tr = tc.RobotState.create(2.5, -1.0, [0.3, -0.8, 0.1], dtype=torch.float64,
                              wheel_speed=wheel_speed)
    want = convert.robot_state_from_numpy(*(np.asarray(a) for a in jr))
    for a, b in zip(tr, want):
        assert a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)
    assert float(tr.left_wheel_speed) == float(tr.right_wheel_speed) == wheel_speed


def test_kinematic_advance_and_std_update(rng):
    (_, _), (thf, tcm) = _world()
    cfg = tc.MPPIConfig(num_samples=8, horizon=12, exact=True)
    robot = tc.RobotState.create(-10.0, -8.0, [1.0, 0.4, 0.0], dtype=torch.float64)
    ctrl = tc.ControllerState.create(cfg, torch.float64)
    new_ctrl, out = tc.mppi_step(cfg, thf, tcm, torch.tensor([15.0, 12.0], dtype=torch.float64),
                                 robot, ctrl, torch.from_numpy(rng.normal(size=(2, 8, 12))))
    nr = tc.kinematic_advance(cfg, robot, out)
    assert torch.equal(nr.position, out.optimal_trajectory[0, :2])
    lin0, ang0 = float(out.linear_velocity), float(out.angular_velocity)
    assert float(nr.left_wheel_speed) == lin0 - ang0 * 1.2 / 2
    assert float(nr.right_wheel_speed) == lin0 + ang0 * 1.2 / 2
    a0 = float(out.optimal_angular[0])
    assert float(new_ctrl.std_u1) == max(0.4, 0.4 - a0 * a0)
    assert float(new_ctrl.std_u2) == max(0.4, 0.4 + a0 * a0)


@pytest.mark.parametrize("start,max_loops", [((-4.0, -3.0), 9), ((3.35, 2.6), 40)],
                         ids=["capped", "reaches"])
def test_goal_seek_recorded_matches_jax_loop(start, max_loops):
    """The masked-unroll loop from ``key(7)`` against a plain loop of JAX
    mppi_step + kinematic_advance, each loop's noise drawn by JAX from
    ``sub`` of ``key, sub = split(key)``."""
    (jhf, jcm), (thf, tcm) = _world()
    jcfg = jc.MPPIConfig(num_samples=16, horizon=12)
    tcfg = convert.config_from_jax(jcfg)
    (jrob, jctrl), (trob, tctrl) = _states(jcfg, *start, [1.0, 0.8, 0.0])
    goal = np.array([4.0, 3.0])

    positions, velocities = [], []
    key = jax.random.key(7)
    for n in range(max_loops):
        if np.all(np.abs(np.asarray(jrob.position) - goal) <= 0.5):
            break
        key, sub = jax.random.split(key)
        noise = jsamp.sample_noise(sub, 16, 12, jnp.float64)
        jctrl, out = _jstep(jcfg, jhf, jcm, jnp.asarray(goal), jrob, jctrl, noise)
        jrob = _jadvance(jcfg, jrob, out)
        positions.append([*np.asarray(jrob.position), float(jrob.z)])
        velocities.append(float(out.linear_velocity))

    res = tc.goal_seek_recorded(tcfg, thf, tcm, torch.from_numpy(goal), trob, tctrl, jr.key(7),
                                max_loops=max_loops, unroll=4)
    loops = int(res.loops)
    assert loops == len(positions)
    assert bool(res.reached) == (loops < max_loops)
    assert res.steps == -(-max(loops, 1) // 4) * 4
    assert res.positions.shape == (max_loops, 3)
    np.testing.assert_allclose(res.positions[:loops].numpy(), np.array(positions), atol=1e-10)
    np.testing.assert_allclose(res.velocities[:loops].numpy(), np.array(velocities), atol=1e-12)
    for a, b in zip(res.robot, jrob):
        _close(a, b, 0, 1e-10, "final robot")
    for a, b in zip(res.ctrl, jctrl):
        _close(a, b, 0, 1e-12, "final controller")
    if bool(res.reached):
        assert loops < max_loops - 4  # the masked steps after the stop froze the state


def test_goal_seek_with_generator_reaches_goal():
    """Float32 goal-seek with noise drawn from ``key(0)``; without a key it
    refuses to run."""
    hw = 25.0
    from husky_rover_mppi_isaacsim_torch.terrain import as_costmap as t_as_costmap
    from husky_rover_mppi_isaacsim_torch.terrain import crater_surface as t_crater

    hf = tc.HeightField.create(t_crater(256, hw, [((-12.0, 14.0), 1.5, 8.0)]), hw)
    cm = t_as_costmap(np.zeros((32, 32), np.float32), hw)
    cfg = tc.MPPIConfig(num_samples=128, horizon=30)
    robot = tc.RobotState.create(-1.0, -0.5, [1.0, 0.2, 0.0])
    res = tc.goal_seek(cfg, hf, cm, torch.tensor([1.0, 0.5]), robot,
                       tc.ControllerState.create(cfg, initial_u=1.0), jr.key(0), max_loops=200)
    assert bool(res.reached), (res.robot.position, int(res.loops))
    assert 0 < int(res.loops) < 200
    with pytest.raises(TypeError, match="key"):
        tc.goal_seek(cfg, hf, cm, torch.tensor([1.0, 0.5]), robot,
                     tc.ControllerState.create(cfg), max_loops=1)


# goal-seek from a key against JAX's from the same key (float64): the port
# draws JAX's normals within a few float64 ulps (tests/test_torch_jax_normal.py)
# and XLA rounds the jitted loop's products otherwise than torch; measured
# <= 1.4e-14 m on the positions and 2.9e-14 m/s on the velocities over 44
# loops. 1e-9 leaves room for a sample whose wheel-track cell flips, as the
# chained-step tests allow
SEEK_ATOL = 1e-9


@pytest.mark.parametrize("seed", [0, 5])
def test_goal_seek_recorded_from_a_key_matches_jax(seed):
    """``goal_seek_recorded`` from ``key(seed)`` alone, no noise injected,
    over 44 loops (every loop splits the key, masked ones too): the loop
    count, the recorded positions and velocities and the final state equal
    JAX's ``goal_seek_recorded`` from the same key at ``SEEK_ATOL``."""
    (jhf, jcm), (thf, tcm) = _world()
    jcfg = jc.MPPIConfig(num_samples=16, horizon=12)
    tcfg = convert.config_from_jax(jcfg)
    (jrob, jctrl), (trob, tctrl) = _states(jcfg, -4.0, -3.0, [1.0, 0.8, 0.0])
    goal = np.array([14.0, 11.0])
    want = jax.jit(jc.goal_seek_recorded, static_argnums=(0, 7, 8))(
        jcfg, jhf, jcm, jnp.asarray(goal), jrob, jctrl, jax.random.key(seed), 44, 4)
    got = tc.goal_seek_recorded(tcfg, thf, tcm, torch.from_numpy(goal), trob, tctrl,
                                jr.key(seed), max_loops=44, unroll=4)
    loops = int(got.loops)
    assert loops == int(want.loops) == 44 and bool(got.reached) == bool(want.reached)
    np.testing.assert_allclose(got.positions.numpy(), np.asarray(want.positions), rtol=0,
                               atol=SEEK_ATOL)
    np.testing.assert_allclose(got.velocities.numpy(), np.asarray(want.velocities), rtol=0,
                               atol=SEEK_ATOL)
    for a, b in zip(got.robot + got.ctrl, tuple(want.robot) + tuple(want.ctrl)):
        _close(a, b, 0, SEEK_ATOL, "final state")


def test_config_from_jax_reads_every_field():
    jcfg = jc.MPPIConfig(num_samples=77, horizon=33, temperature=0.7, sigma_base=0.3,
                         slope_critic="body", exact=True, gather_engine="pallas",
                         limits=jc.DiffDriveLimits(v_max=1.5))
    tcfg = convert.config_from_jax(jcfg)
    for f in dataclasses.fields(tc.MPPIConfig):
        assert tuple(np.ravel(getattr(tcfg, f.name))) == tuple(np.ravel(getattr(jcfg, f.name)))
    assert tcfg.horizon_m == jcfg.horizon_m
    assert not hasattr(tcfg, "gather_engine")
    with pytest.raises(ValueError, match="projection"):
        tc.MPPIConfig(projection="4d")
    with pytest.raises(ValueError, match="slope_critic"):
        tc.MPPIConfig(slope_critic="tires")
