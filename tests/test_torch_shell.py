"""PyTorch port: the host shell (robot manager, message bus, rate throttle,
thread monitor, simulation manager) against the JAX package's.

The robot manager's states match JAX's at 1e-12 (float64). The bus, rate
and monitor are copies of the JAX modules and run the scenarios of
``tests/test_shell.py`` in both packages. The simulation manager steps with
JAX's noise replayed (``split(key(conf.seed))`` per tick, then the closed
loop's own split), a teleport and a reset over the bus between ticks, and
from its seed alone (the port draws the same stream), and is held to the
closed loop's 1e-9 (tests/test_torch_closed_loop.py)."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch import convert
from husky_rover_mppi_isaacsim_torch import env as tenv
from husky_rover_mppi_isaacsim_torch import shell as tshell
from husky_rover_mppi_isaacsim_tpu import env as jenv
from husky_rover_mppi_isaacsim_tpu import shell as jshell
from husky_rover_mppi_isaacsim_tpu.mppi import controller as jc

from test_torch_closed_loop import LOOP_ATOL, _close, _compare_loop_states, _world

torch.set_num_threads(1)

PACKAGES = {"jax": jshell, "torch": tshell}


def _compare_rovers(ts, js, atol, what):
    for f, a, b in zip(ts._fields, ts, js):
        _close(a, b, 0, atol, f"{what}: {f}")


# -- RobotManager ----------------------------------------------------------


def test_robot_manager_matches_jax():
    """Spawn (deferred), teleport, reset and reset_all through both
    managers: every RoverState field within 1e-12 after each flush."""
    (jhf, _), (thf, _) = _world()
    jrm, trm = jenv.RobotManager(max_robots=3), tenv.RobotManager(max_robots=3)
    for rm in (jrm, trm):
        rm.spawn("husky_0", (1.0, 2.0))
        rm.spawn("husky_1", (-4.0, 3.5), heading=(0.2, 1.0, 0.0), namespace="ns1")
    js, ts = jrm.initial_state(jhf), trm.initial_state(thf)
    _compare_rovers(ts, js, 1e-12, "initial")
    assert ts.position.dtype == torch.float64 and trm.pending == jrm.pending == 2
    script = [
        lambda rm: rm.teleport("husky_0", (-6.0, -5.0), (0.0, -1.0, 0.1)),
        lambda rm: rm.spawn("husky_2", (7.5, -7.5)),
        lambda rm: rm.reset("husky_0"),
        lambda rm: (rm.teleport("husky_1", (3.3, 3.3)), rm.teleport("husky_2", (0.5, 9.0))),
        lambda rm: rm.reset_all(),
    ]
    # wheel and yaw state that a teleport must zero
    spin = lambda s, mk: s._replace(wheel_left=mk(np.full(3, 0.7)),  # noqa: E731
                                    wheel_right=mk(np.full(3, 0.9)), yaw_rate=mk(np.full(3, 0.2)))
    for i, edit in enumerate(script):
        js, ts = spin(js, jnp.asarray), spin(ts, torch.from_numpy)
        edit(jrm)
        edit(trm)
        assert trm.pending == jrm.pending > 0
        js, ts = jrm.apply_modifications(js, jhf), trm.apply_modifications(ts, thf)
        assert trm.pending == jrm.pending == 0
        _compare_rovers(ts, js, 1e-12, f"edit {i}")
    assert trm.names == jrm.names and trm.slot("husky_2") == jrm.slot("husky_2") == 2
    assert np.array_equal(trm.active_mask(), jrm.active_mask())
    assert trm.spec("husky_1").namespace == "ns1"
    for name in trm.names:
        for a, b in zip(trm.pose(ts, name), jrm.pose(js, name)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-12)
        np.testing.assert_allclose(trm.velocities(ts, name), jrm.velocities(js, name),
                                   rtol=0, atol=1e-12)
    params = tenv.RoverParams()
    _close(trm.contact_forces(params, thf, ts), jrm.contact_forces(jenv.RoverParams(), jhf, js),
           0, 1e-10, "contact forces")


def test_robot_manager_capacity_duplicate_and_enqueue():
    (_, _), (thf, _) = _world(grid=64)
    rm = tenv.RobotManager(max_robots=1)
    rm.spawn("a", (0.0, 0.0))
    with pytest.raises(ValueError):
        rm.spawn("a", (0.0, 0.0))
    with pytest.raises(RuntimeError):
        rm.spawn("b", (0.0, 0.0))
    assert "a" in rm and "b" not in rm
    state = rm.apply_modifications(rm.initial_state(thf), thf)
    rm.enqueue(lambda s, hf: s._replace(yaw_rate=s.yaw_rate + 1.0))
    assert rm.pending == 1
    assert float(rm.apply_modifications(state, thf).yaw_rate[0]) == 1.0


def test_robot_manager_from_jax_copies_the_registry():
    jrm = jenv.RobotManager(max_robots=4)
    jrm.spawn("x", (1.0, -1.0), namespace="n")
    jrm.spawn("y", (2.0, 2.0), heading=(0.0, 1.0, 0.0))
    trm = convert.robot_manager_from_jax(jrm)
    assert trm.max_robots == 4 and trm.names == ["x", "y"] and trm.pending == 0
    for name in trm.names:
        assert vars(trm.spec(name)) == vars(jrm.spec(name))


# -- the copies: bus, rate, monitor ----------------------------------------


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_bus_publish_subscribe_and_latch(pkg):
    bus = PACKAGES[pkg].MessageBus()
    got = []
    assert bus.publish("/t", 1) == 0
    bus.subscribe("/t", got.append)
    assert bus.publish("/t", 2) == 1
    bus.publish("/latched", "hello", latch=True)
    late = []
    bus.subscribe("/latched", late.append)
    assert late == ["hello"] and got == [2]
    assert bus.topics() == ["/latched", "/t"] and bus.has_subscribers("/t")
    assert not bus.has_subscribers(PACKAGES[pkg].Topics.POSE_STATE)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_rate_paces_and_counts_overruns(pkg):
    t = {"now": 0.0}
    slept = []

    def sleeper(s):
        slept.append(s)
        t["now"] += s

    r = PACKAGES[pkg].Rate(10.0, clock=lambda: t["now"], sleeper=sleeper)  # period 0.1
    t["now"] += 0.03  # fast tick
    assert r.sleep() == pytest.approx(0.07)
    t["now"] += 0.25  # slow tick: overrun
    assert r.sleep() < 0
    assert r.overruns == 1 and slept == [pytest.approx(0.07)]
    with pytest.raises(ValueError):
        PACKAGES[pkg].Rate(0.0)


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_monitor_fires_shutdowns_once_when_sim_dies(pkg):
    alive = {"ok": True}
    fired = []
    mon = PACKAGES[pkg].ThreadMonitor(poll_s=0.02, sim_alive=lambda: alive["ok"])
    mon.register_shutdown(lambda: fired.append(1))
    mon.start()
    assert mon.is_alive
    alive["ok"] = False
    deadline = time.time() + 2.0
    while mon.is_alive and time.time() < deadline:
        time.sleep(0.01)
    assert not mon.is_alive
    mon.fire()  # idempotent
    mon.stop()
    assert fired == [1] and not mon._thread.is_alive()


def test_topics_are_the_jax_names():
    names = [n for n in vars(jshell.Topics) if n.isupper()]
    assert names and all(getattr(tshell.Topics, n) == getattr(jshell.Topics, n) for n in names)


# -- SimulationManager -----------------------------------------------------


def _managers(n_slots=3, k=16, h=12, seed=5):
    (jhf, jcm), (thf, tcm) = _world()
    jconf = jshell.SimulationManagerConf(
        loop=jenv.ClosedLoopConfig(mppi=jc.MPPIConfig(num_samples=k, horizon=h),
                                   rover=jenv.RoverParams(wheel_tau=0.03)), seed=seed)
    tconf = convert.simulation_manager_conf_from_jax(jconf)
    goals = np.array([[6.0, 6.0], [-8.0, 9.0], [0.0, 0.0]])[:n_slots]
    jrm, trm = jenv.RobotManager(n_slots), tenv.RobotManager(n_slots)
    for rm in (jrm, trm):
        rm.spawn("husky_0", (-6.0, -6.0))
        rm.spawn("husky_1", (4.0, -7.0), heading=(0.0, 1.0, 0.0))
    jsm = jshell.SimulationManager(jconf, jhf, jcm, jrm, goals=goals)
    tsm = tshell.SimulationManager(tconf, thf, tcm, trm, goals=goals, device="cpu")
    return jsm, tsm, jconf


def test_simulation_manager_matches_jax():
    """Eight ticks, each manager from its seed; a bus teleport after tick
    2, a reset after tick 4, a spawn over the bus after tick 5; the loop
    state within 1e-9 of JAX's after every tick."""
    jsm, tsm, _ = _managers()
    bus_events = {2: (jshell.Topics.ROBOT_TELEPORT, {"name": "husky_0", "position": (2.0, -3.0),
                                                     "heading": (0.0, 1.0, 0.0)}),
                  4: (jshell.Topics.ROBOT_RESET, {"name": "husky_1"}),
                  5: (jshell.Topics.ROBOT_SPAWN, {"name": "husky_2", "position": (-2.0, 5.0)})}
    try:
        _compare_loop_states(tsm.state, jsm.state, "initial")
        for tick in range(8):
            jsm.step()
            tsm.step()
            _compare_loop_states(tsm.state, jsm.state, f"tick {tick}")
            assert tsm.step_count == jsm.step_count == tick + 1
            if tick in bus_events:
                topic, msg = bus_events[tick]
                assert jsm.bus.publish(topic, dict(msg)) == tsm.bus.publish(topic, dict(msg)) == 1
        assert tsm.robots.names == jsm.robots.names == ["husky_0", "husky_1", "husky_2"]
        np.testing.assert_allclose(tsm.robots.pose(tsm.state.rovers, "husky_2")[0],
                                   jsm.robots.pose(jsm.state.rovers, "husky_2")[0],
                                   rtol=0, atol=LOOP_ATOL)
    finally:
        jsm.close()
        tsm.close()


def test_simulation_manager_from_its_seed_matches_jax():
    """Eight ticks with no noise injected: the port carries ``key(seed)``
    and splits it each tick, as JAX's manager does, its step drawing the
    noise from the tick's key; the loop state within 1e-9 of JAX's after
    every tick."""
    jsm, tsm, _ = _managers()
    try:
        for tick in range(8):
            jsm.step()
            tsm.step()
            _compare_loop_states(tsm.state, jsm.state, f"tick {tick}")
        np.testing.assert_array_equal(tsm.key.numpy(), np.asarray(
            jax.random.key_data(jsm._key)).astype(np.int64))
    finally:
        jsm.close()
        tsm.close()


def test_simulation_manager_runs_and_applies_bus_requests():
    """The scenario of tests/test_shell.py on the port, its noise drawn from
    its key."""
    jsm, tsm, _ = _managers(n_slots=2)
    jsm.close()
    with tsm as sm:
        sm.run_simulation(6)
        assert sm.step_count == 6
        pos0 = sm.state.rovers.position[0].numpy()
        assert np.linalg.norm(pos0 - [-6.0, -6.0]) > 1e-3  # drove away from the spawn
        sm.bus.publish(tshell.Topics.ROBOT_TELEPORT, {"name": "husky_0", "position": (5.0, 5.0)})
        sm.step()
        np.testing.assert_allclose(sm.state.rovers.position[0].numpy(), [5.0, 5.0], atol=1e-12)
        assert float(sm.state.rovers.wheel_left[0]) == 0.0
        seen = []
        sm.bus.subscribe(tshell.Topics.POSE_STATE, seen.append)
        sm.step()
        assert len(seen) == 1 and seen[0]["positions"].shape == (2, 2)
        assert seen[0]["step"] == 8 and isinstance(seen[0]["headings"], np.ndarray)
    assert not sm.monitor.is_alive  # close() fired the shutdown hooks


def test_simulation_manager_draws_are_replayable_and_hooked():
    """Two managers of one seed step identically from their keys;
    the deformation hook runs after every tick; a dead monitor stops
    ``run_simulation``."""
    runs = []
    for _ in range(2):
        jsm, tsm, _ = _managers(n_slots=2)
        jsm.close()
        calls = []
        tsm.deform_hook = lambda s: calls.append(s.step_index) or s
        with tsm:
            tsm.run_simulation(3)
            runs.append(tsm.state)
            assert calls == [1, 2, 3]
            tsm.monitor.fire()
            tsm.run_simulation(5)
            assert tsm.step_count == 3
    for a, b in zip(runs[0].rovers + runs[0].ctrl, runs[1].rovers + runs[1].ctrl):
        assert torch.equal(a, b)


def test_simulation_manager_conf_from_jax():
    jconf = jshell.SimulationManagerConf(realtime=True, seed=9, monitor_poll_s=0.5)
    tconf = convert.simulation_manager_conf_from_jax(jconf)
    assert (tconf.realtime, tconf.seed, tconf.monitor_poll_s) == (True, 9, 0.5)
    assert tconf.loop == convert.closed_loop_config_from_jax(jconf.loop)


def test_simulation_manager_runs_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    (_, _), (thf, tcm) = _world(grid=64)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tshell.SimulationManager(tshell.SimulationManagerConf(), thf, tcm,
                                 tenv.RobotManager(1), goals=np.zeros((1, 2)))
