"""PyTorch port: the batched control step against ``jax.vmap`` of the JAX
step, the N-rover closed loop against the JAX one, with JAX's noise
replayed and, from a key alone, with the port's own draws of JAX's stream,
and ``cli mode=closed_loop`` on the CPU (float64 unless stated).

Tolerances: the batched step takes those of tests/test_torch_controller.py
(costs rtol 1e-12; weights rtol 1e-11 above 1e-20; velocities and optimal
inputs 1e-12; trajectories 1e-10). Chained closed-loop steps stay within
1e-9 (positions, headings, wheel and PI state) over 7 steps: each step
feeds the last one's rounding back through the rollouts. From a key alone
the port draws JAX's float64 noise within a few units in the last place
(tests/test_torch_jax_normal.py), far inside those tolerances.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch import cli, convert
from husky_rover_mppi_isaacsim_torch import env as tenv
from husky_rover_mppi_isaacsim_torch.core import jax_random as jr
from husky_rover_mppi_isaacsim_torch.mppi import controller as tc
from husky_rover_mppi_isaacsim_torch.mppi import sampling as tsamp
from husky_rover_mppi_isaacsim_torch.ops.rollout_cuda import rollout_25d_cuda
from husky_rover_mppi_isaacsim_tpu import cli as jcli
from husky_rover_mppi_isaacsim_tpu import env as jenv
from husky_rover_mppi_isaacsim_tpu.core import HeightField as JHeightField
from husky_rover_mppi_isaacsim_tpu.mppi import controller as jc
from husky_rover_mppi_isaacsim_tpu.mppi import sampling as jsamp
from husky_rover_mppi_isaacsim_tpu.terrain import as_costmap, crater_surface

# small tensors: one intra-op thread each, so that the test workers running
# beside these do not lose their cores
torch.set_num_threads(1)

TOL = {
    "costs": (1e-12, 0), "weights": (1e-11, 1e-20),
    "optimal_linear": (0, 1e-12), "optimal_angular": (0, 1e-12),
    "linear_velocity": (0, 1e-12), "angular_velocity": (0, 1e-12),
    "optimal_trajectory": (0, 1e-10), "optimal_headings": (0, 1e-10),
    "rollouts": (0, 1e-10),
}
LOOP_ATOL = 1e-9


def _world(grid=200, hw=25.0):
    z = np.asarray(crater_surface(grid, hw, [((-5.0, 8.0), 2.0, 6.0),
                                             ((10.0, -6.0), 3.0, 8.0)], dtype=jnp.float64))
    jhf = JHeightField.create(z, hw, dtype=jnp.float64)
    cm_img = np.random.default_rng(7).uniform(0, 0.9, (grid // 8, grid // 8)) ** 4
    jcm = as_costmap(cm_img, hw, dtype=jnp.float64)
    thf = convert.heightfield_from_numpy(*(np.asarray(a) for a in jhf))
    tcm = convert.costmap_from_numpy(*(np.asarray(a) for a in jcm))
    return (jhf, jcm), (thf, tcm)


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


def _batched_inputs(rng, n, k, h):
    pos = rng.uniform(-10.0, 10.0, (n, 2))
    head = np.concatenate([rng.uniform(-1, 1, (n, 2)), rng.uniform(-0.1, 0.1, (n, 1))], 1)
    head /= np.linalg.norm(head, axis=-1, keepdims=True)
    robot = (pos, np.zeros(n), head, *rng.uniform(0.0, 1.0, (2, n)))
    ctrl = (*rng.uniform(-1, 1, (2, n, h)), *rng.uniform(0.2, 0.5, (2, n)))
    return robot, ctrl, rng.uniform(-15.0, 15.0, (n, 2)), rng.normal(size=(n, 2, k, h))


VARIANTS = [dict(exact=True), dict(exact=False),
            dict(slope_critic="body", return_rollouts=True),
            dict(projection="2d", return_rollouts=True)]


@pytest.mark.parametrize("variant", VARIANTS, ids=["exact", "matmul", "body_slope", "2d"])
def test_batched_mppi_step_matches_jax_vmap(rng, variant):
    """N=3 rovers, each with its own pose, wheel speeds, optimum, stds, goal
    and noise, in one call: equal to ``jax.vmap(mppi_step)``, and on the CPU
    no K1 launch."""
    (jhf, jcm), (thf, tcm) = _world()
    n, k, h = 3, 24, 30
    jcfg = jc.MPPIConfig(num_samples=k, horizon=h, **variant)
    tcfg = convert.config_from_jax(jcfg)
    robot, ctrl, goal, noise = _batched_inputs(rng, n, k, h)
    jstep = jax.jit(jax.vmap(functools.partial(jc.mppi_step, jcfg, jhf, jcm)))
    jctrl, jout = jstep(jnp.asarray(goal), jc.RobotState(*map(jnp.asarray, robot)),
                        jc.ControllerState(*map(jnp.asarray, ctrl)), jnp.asarray(noise))
    before = rollout_25d_cuda.launches
    tctrl, tout = tc.mppi_step(tcfg, thf, tcm, torch.from_numpy(goal),
                               convert.robot_state_from_numpy(*robot),
                               convert.controller_state_from_numpy(*ctrl),
                               torch.from_numpy(noise))
    assert rollout_25d_cuda.launches == before
    for name, (rtol, atol) in TOL.items():
        got, want = getattr(tout, name), getattr(jout, name)
        if want is None:
            assert got is None
            continue
        assert tuple(got.shape) == want.shape, name
        _close(got, want, rtol, atol, name)
    for name in jctrl._fields:
        _close(getattr(tctrl, name), getattr(jctrl, name), 0, 1e-12, name)
    jadv = jax.vmap(functools.partial(jc.kinematic_advance, jcfg))(
        jc.RobotState(*map(jnp.asarray, robot)), jout)
    tadv = tc.kinematic_advance(tcfg, convert.robot_state_from_numpy(*robot), tout)
    for a, b in zip(tadv, jadv):
        _close(a, b, 0, 1e-10, "kinematic_advance")


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_batched_step_equals_one_rover_steps(rng, dtype):
    """Rover n of a batched step against a one-rover step with rover n's
    inputs, on the CPU: the samples' costs and weights, the commanded
    (v, w) and the new controller state are bit-equal. The optimal
    sequence's Toeplitz lag is one matmul of N rows against one of a single
    row, and BLAS may sum a single row in another order, so the optimal
    trajectory is held to 1e-12 (f64) / 1e-5 (f32) rather than bit for bit."""
    (_, _), (thf, tcm) = _world()
    n, k, h = 3, 24, 30
    cfg = tc.MPPIConfig(num_samples=k, horizon=h)
    robot, ctrl, goal, noise = _batched_inputs(rng, n, k, h)
    cast = lambda t: t.to(dtype)  # noqa: E731
    hf, cm = type(thf)(*map(cast, thf)), type(tcm)(*map(cast, tcm))
    rb = tc.RobotState(*map(cast, convert.robot_state_from_numpy(*robot)))
    cb = tc.ControllerState(*map(cast, convert.controller_state_from_numpy(*ctrl)))
    goal_t, noise_t = cast(torch.from_numpy(goal)), cast(torch.from_numpy(noise))
    nb, ob = tc.mppi_step(cfg, hf, cm, goal_t, rb, cb, noise_t)
    atol = 1e-12 if dtype == torch.float64 else 1e-5
    for i in range(n):
        nu, ou = tc.mppi_step(cfg, hf, cm, goal_t[i], tc.RobotState(*(t[i] for t in rb)),
                              tc.ControllerState(*(t[i] for t in cb)), noise_t[i])
        for name in ("costs", "weights", "linear_velocity", "angular_velocity"):
            assert torch.equal(getattr(ob, name)[i], getattr(ou, name)), name
        for name in nb._fields:
            assert torch.equal(getattr(nb, name)[i], getattr(nu, name)), name
        _close(ob.optimal_trajectory[i], ou.optimal_trajectory, 0, atol, "optimal_trajectory")


def _loop_world_and_config(n, k=16, h=12, **mppi):
    (jhf, jcm), (thf, tcm) = _world()
    jcfg = jenv.ClosedLoopConfig(mppi=jc.MPPIConfig(num_samples=k, horizon=h, **mppi),
                                 rover=jenv.RoverParams(wheel_tau=0.03))
    return (jhf, jcm), (thf, tcm), jcfg, convert.closed_loop_config_from_jax(jcfg)


def _jax_noise(key, cfg, n):
    """The noise JAX's closed_loop_step draws from ``key`` (closed_loop.py:125-128)."""
    k_noise, _ = jax.random.split(key)
    m = cfg.mppi
    draw = jsamp.sample_noise(k_noise, n * m.num_samples, m.horizon, jnp.float64)
    return torch.from_numpy(np.array(
        draw.reshape(2, n, m.num_samples, m.horizon).transpose(1, 0, 2, 3)))


def _tkey(key):
    """A JAX key as the port's key data (``core.jax_random``)."""
    return torch.from_numpy(np.asarray(jax.random.key_data(key)).astype(np.int64))


def _compare_loop_states(ts, js, what):
    for name in ("latched_left", "latched_right", "stored_left", "stored_right", "err_total"):
        _close(getattr(ts, name), getattr(js, name), 0, LOOP_ATOL, f"{what}: {name}")
    for f, a, b in zip(ts.rovers._fields, ts.rovers, js.rovers):
        _close(a, b, 0, LOOP_ATOL, f"{what}: rovers.{f}")
    for f, a, b in zip(ts.ctrl._fields, ts.ctrl, js.ctrl):
        _close(a, b, 0, LOOP_ATOL, f"{what}: ctrl.{f}")
    assert ts.step_index == int(js.step_index)


@pytest.mark.parametrize("exact", [False, True], ids=["matmul", "exact"])
def test_seven_closed_loop_steps_match_jax(exact):
    """Seven chained sim steps (latches at 0, 3, 6) for N=3 rovers, each
    from JAX's step key."""
    n = 3
    (jhf, jcm), (thf, tcm), jcfg, tcfg = _loop_world_and_config(n, exact=exact)
    starts = np.array([[-8.0, -6.0], [-6.0, 6.0], [6.0, -8.0]])
    goals = -0.6 * starts
    js = jenv.init_loop_state(jcfg, jenv.RoverState.create(starts, [1.0, 0.0, 0.0], jhf),
                              jnp.float64)
    ts = tenv.init_loop_state(tcfg, tenv.RoverState.create(starts, [1.0, 0.0, 0.0], thf),
                              torch.float64)
    _compare_loop_states(ts, js, "init")
    assert convert.loop_state_from_jax(js).step_index == 0
    jstep = jax.jit(lambda s, k: jenv.closed_loop_step(jcfg, jhf, jcm, jnp.asarray(goals), s, k))
    key = jax.random.key(1)
    for i in range(7):
        key, sub = jax.random.split(key)
        js = jstep(js, sub)
        ts = tenv.closed_loop_step(tcfg, thf, tcm, torch.from_numpy(goals), ts, _tkey(sub))
        _compare_loop_states(ts, js, f"step {i}")


def test_loop_noise_is_the_jax_layout():
    """One (2, N*K, H) draw from ``k_noise``; rover r's sample s is row r*K
    + s of it, as in ``closed_loop.py:125-128``, and the draw is JAX's; a
    step from a key taken down a path equals the step from the key the
    path derives."""
    n, k, h = 3, 5, 4
    cfg = tc.MPPIConfig(num_samples=k, horizon=h)
    key = jr.key(9)
    flat = tsamp.sample_noise(jr.split(key)[0], n * k, h)
    got = tenv.step_noise(key, cfg, n)
    assert got.shape == (n, 2, k, h)
    for r in range(n):
        assert torch.equal(got[r], flat[:, r * k:(r + 1) * k])
    jcfg = jenv.ClosedLoopConfig(mppi=jc.MPPIConfig(num_samples=k, horizon=h))
    with jax.enable_x64(False):
        want = jax.random.normal(jax.random.split(jax.random.key(9))[0], (2, n * k, h))
    assert torch.equal(flat, torch.from_numpy(np.array(want)))
    np.testing.assert_allclose(tenv.step_noise(key, cfg, n, torch.float64).numpy(),
                               _jax_noise(jax.random.key(9), jcfg, n).numpy(), rtol=0,
                               atol=1e-14)

    (_, _), (thf, tcm), _, tcfg = _loop_world_and_config(n, k=k, h=h)
    starts = np.array([[-3.0, 1.0], [2.0, 2.0], [0.0, -4.0]])
    state = tenv.init_loop_state(tcfg, tenv.RoverState.create(starts, [1.0, 0.0, 0.0], thf),
                                 torch.float64)
    goals = torch.from_numpy(-starts)
    path = (("fold_in", 3), ("split", 2, 1))
    drawn = tenv.closed_loop_step(tcfg, thf, tcm, goals, state, jr.key(4), path)
    derived = tenv.closed_loop_step(tcfg, thf, tcm, goals, state,
                                    jr.split(jr.fold_in(jr.key(4), 3))[1])
    for a, b in zip(drawn.rovers + drawn.ctrl, derived.rovers + derived.ctrl):
        assert torch.equal(a, b)


def test_latch_and_pi_semantics():
    """Commands change only on latch steps (0, 3, 6); the PI integrator
    restarts there and sums the yaw-rate error in between."""
    (_, _), (thf, tcm), _, tcfg = _loop_world_and_config(1, k=16, h=10)
    state = tenv.init_loop_state(tcfg, tenv.RoverState.create(np.zeros((1, 2)), [1.0, 0.0, 0.0],
                                                             thf), torch.float64)
    goals = torch.tensor([[5.0, 0.0]], dtype=torch.float64)
    keys = jr.split(jr.key(1), 7)
    latched = []
    for i in range(7):
        prev = state
        state = tenv.closed_loop_step(tcfg, thf, tcm, goals, state, keys[i])
        latched.append(float(state.latched_left[0]))
        ang_cmd = (state.stored_right - state.stored_left) / tcfg.mppi.robot_radius
        err = prev.rovers.yaw_rate - ang_cmd
        base = torch.zeros_like(err) if i % 3 == 0 else prev.err_total
        _close(state.err_total, base + err, 0, 1e-12, f"integrator at step {i}")
        if i % 3 == 0:
            assert torch.equal(state.latched_left, state.stored_left)
    assert latched[0] == latched[1] == latched[2]
    assert latched[3] == latched[4] == latched[5]
    assert state.step_index == 7
    with pytest.raises(TypeError, match="key"):
        tenv.closed_loop_step(tcfg, thf, tcm, goals, state)


def test_run_episode_matches_jax():
    """A short episode (5 steps, every 2nd position recorded) from JAX's
    episode key."""
    n, steps = 2, 5
    (jhf, jcm), (thf, tcm), jcfg, tcfg = _loop_world_and_config(n)
    starts = np.array([[-4.0, 3.0], [5.0, -2.0]])
    goals = np.array([[4.0, -3.0], [-5.0, 2.0]])
    js = jenv.init_loop_state(jcfg, jenv.RoverState.create(starts, [1.0, 0.0, 0.0], jhf),
                              jnp.float64)
    key = jax.random.key(3)
    js, jpath = jenv.run_episode(jcfg, jhf, jcm, jnp.asarray(goals), js, key, steps,
                                 record_every=2)
    ts = tenv.init_loop_state(tcfg, tenv.RoverState.create(starts, [1.0, 0.0, 0.0], thf),
                              torch.float64)
    ts, tpath = tenv.run_episode(tcfg, thf, tcm, torch.from_numpy(goals), ts, _tkey(key), steps,
                                 record_every=2)
    assert tuple(tpath.shape) == jpath.shape == (3, n, 2)
    _close(tpath, jpath, 0, LOOP_ATOL, "path")
    _compare_loop_states(ts, js, "final")


@pytest.mark.parametrize("slip_std", [0.0, 0.05], ids=["no_slip", "slip"])
def test_run_episode_from_a_key_matches_jax(slip_std):
    """``run_episode`` of N=2 rovers over 6 steps from ``key(3)`` alone, no
    noise injected: the port splits the key per step, draws the noise and
    the wheel slip from each step's key, and follows JAX's episode from the
    same key at the chained steps' 1e-9."""
    n, steps = 2, 6
    (jhf, jcm), (thf, tcm) = _world()
    jcfg = jenv.ClosedLoopConfig(mppi=jc.MPPIConfig(num_samples=16, horizon=12),
                                 rover=jenv.RoverParams(wheel_tau=0.03, slip_std=slip_std))
    tcfg = convert.closed_loop_config_from_jax(jcfg)
    starts = np.array([[-4.0, 3.0], [5.0, -2.0]])
    goals = np.array([[4.0, -3.0], [-5.0, 2.0]])
    js = jenv.init_loop_state(jcfg, jenv.RoverState.create(starts, [1.0, 0.0, 0.0], jhf),
                              jnp.float64)
    js, jpath = jenv.run_episode(jcfg, jhf, jcm, jnp.asarray(goals), js, jax.random.key(3),
                                 steps)
    ts = tenv.init_loop_state(tcfg, tenv.RoverState.create(starts, [1.0, 0.0, 0.0], thf),
                              torch.float64)
    ts, tpath = tenv.run_episode(tcfg, thf, tcm, torch.from_numpy(goals), ts, jr.key(3), steps)
    _close(tpath, jpath, 0, LOOP_ATOL, "path")
    _compare_loop_states(ts, js, "final")


def test_closed_loop_multi_rover_progress():
    """N rovers with individual goals all make progress (tests/test_env.py's
    check, float32, noise from ``key(0)``)."""
    from husky_rover_mppi_isaacsim_torch.core import HeightField
    from husky_rover_mppi_isaacsim_torch.terrain import as_costmap as t_as_costmap
    from husky_rover_mppi_isaacsim_torch.terrain import crater_surface as t_crater

    hw = 25.0
    hf = HeightField.create(t_crater(256, hw, [((-12.0, 14.0), 1.5, 8.0)]), hw)
    cm = t_as_costmap(np.zeros((32, 32), np.float32), hw)
    starts = np.array([[-8.0, -6.0], [-6.0, 6.0], [6.0, -8.0], [8.0, 6.0]])
    goals = torch.tensor(-0.6 * starts, dtype=torch.float32)
    config = tenv.ClosedLoopConfig(mppi=tc.MPPIConfig(num_samples=128, horizon=40),
                                   rover=tenv.RoverParams(wheel_tau=0.03))
    state = tenv.init_loop_state(config, tenv.RoverState.create(starts, [1.0, 0.0, 0.0], hf))
    state, path = tenv.run_episode(config, hf, cm, goals, state, jr.key(0), num_steps=240)
    d0 = np.linalg.norm(starts - goals.numpy(), axis=-1)
    d1 = tenv.goal_distances(state.rovers.position, goals).numpy()
    assert np.all(d1 < d0 - 1.0), (d0, d1)
    assert path.shape == (240, 4, 2) and torch.isfinite(path).all()


TINY = ["world.half_width=20", "world.grid_size=160", "world.costmap_size=80",
        "mppi.num_samples=16", "mppi.horizon=10", "num_rovers=3", "steps=4", "seed=5"]


def test_cli_closed_loop_on_cpu_starts_where_jax_does(monkeypatch, capsys):
    """``mode=closed_loop device=cpu`` at a tiny size: the JAX run's result
    keys plus ``device``, and the same starts and goals (the numpy draw) as
    the JAX CLI, caught at its ``run_episode``."""
    caught = {}

    def fake_episode(cfg, hf, cm, goals, state, key, num_steps, record_every=1):
        caught.update(goals=np.asarray(goals), starts=np.asarray(state.rovers.position),
                      cfg=cfg, steps=num_steps)
        return state, None

    monkeypatch.setattr(jenv, "run_episode", fake_episode)
    tree = {"num_rovers": 3, "steps": 4, "seed": 5, "mppi": {"num_samples": 16, "horizon": 10},
            "world": {"half_width": 20.0, "grid_size": 160, "costmap_size": 80},
            "physics": {"dt": 1.0 / 60, "gravity": [0.0, 0.0, -1.62],
                        "rover": {"track": 1.2, "wheel_tau": 0.05, "mass": 46.0,
                                  "yaw_inertia": 2.6}}}
    jres = jcli.run_closed_loop(tree)
    starts, goals = cli.spawn_points(5, 3, 20.0)
    np.testing.assert_array_equal(np.float32(starts), caught["starts"])
    np.testing.assert_array_equal(np.float32(goals), caught["goals"])
    assert caught["steps"] == 4
    assert cli.rover_params(tree) == convert.rover_params_from_jax(caught["cfg"].rover)
    assert cli.closed_loop_config(tree).mppi == convert.config_from_jax(caught["cfg"].mppi)

    assert cli.main(["mode=closed_loop", "device=cpu", *TINY]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(res) == set(jres) | {"device"}
    assert res["mode"] == "closed_loop" and res["device"] == "cpu"
    assert res["num_rovers"] == 3 and res["steps"] == 4
    assert np.isfinite(res["mean_progress_m"])


def test_cli_closed_loop_defaults_are_the_run_py_ones():
    """K=1000, H=100, dt 0.045, track 1.2, temperature 0.3; the default
    physics; 4 rovers for 300 steps."""
    cfg = cli.closed_loop_config({})
    assert (cfg.mppi.num_samples, cfg.mppi.horizon, cfg.mppi.dt) == (1000, 100, 0.045)
    assert (cfg.mppi.robot_radius, cfg.mppi.temperature) == (1.2, 0.3)
    assert cfg.rover == tenv.RoverParams(track=1.2, wheel_tau=0.05, physics_dt=1.0 / 60,
                                         mass=46.0, yaw_inertia=2.6, gravity=1.62)
    jloop = jenv.ClosedLoopConfig()
    assert (cfg.latch_every, cfg.pi_kp, cfg.pi_ki, cfg.std_base, cfg.std_gain) == (
        jloop.latch_every, jloop.pi_kp, jloop.pi_ki, jloop.std_base, jloop.std_gain)
    assert cli.rover_params({"physics": {"dt": 0.01, "gravity": [0, 0, -9.81]}}) == \
        tenv.RoverParams(physics_dt=0.01, gravity=9.81)
