"""PyTorch port: offline evaluation and the 2D-vs-3D experiments
(mppi/evaluation.py, cli.py ``mode=evaluation``) against the JAX package.

Both experiment functions run as a whole at small size in float64 (a 20 m
map, K=16, H=12, two runs per arm) with the terrain's base noise injected,
each run drawing its control noise from its key, against the same protocol
assembled here from JAX pieces (and one run of each arm against JAX's
goal-seek from the same key):
the JAX terrain and ``costmap_750``, a loop of jitted JAX ``mppi_step`` +
``kinematic_advance`` per run drawing from the run's key (as in
tests/test_torch_controller.py), and JAX ``thesis_rescore`` /
``rescore_trajectory`` with the aggregation. Integer fields are equal. Float
fields of the episode protocol are held to ``EPISODE_RTOL`` = 1e-10 (its
world is the same in both packages; the sums differ in order only). The
thesis protocol's are held to ``THESIS_RTOL`` = 1e-4: both packages render
its craters in float32, where the libraries' ``atan2`` and ``exp`` differ
in the last bits, so the DEMs differ by up to ~1e-6 m
(tests/test_torch_smallscale.py); a few dozen control loops carry that into
the paths, and the hyperbolic speed critic ``(v_max - v) / (v + 1e-4)``
amplifies it (2e-5 relative, measured)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch import cli, convert
from husky_rover_mppi_isaacsim_torch.aux.config import apply_overrides
from husky_rover_mppi_isaacsim_torch.mppi import controller as tc
from husky_rover_mppi_isaacsim_torch.mppi import evaluation as tev
from husky_rover_mppi_isaacsim_torch.mppi.critics import CriticWeights
from husky_rover_mppi_isaacsim_torch.terrain import as_costmap as t_as_costmap
from husky_rover_mppi_isaacsim_tpu import cli as jcli
from husky_rover_mppi_isaacsim_tpu.core import HeightField as JHeightField
from husky_rover_mppi_isaacsim_tpu.mppi import controller as jc
from husky_rover_mppi_isaacsim_tpu.mppi import critics as jcrit
from husky_rover_mppi_isaacsim_tpu.mppi import evaluation as jev
from husky_rover_mppi_isaacsim_tpu.mppi import sampling as jsamp
from husky_rover_mppi_isaacsim_tpu.terrain import (
    STANDALONE_CRATER_BUMPS,
    as_costmap,
    costmap_750,
    crater_surface,
    thesis_statistics_terrain,
)

# small tensors: one intra-op thread each, so that the test workers running
# beside these do not lose their cores
torch.set_num_threads(1)

EPISODE_RTOL = 1e-10
THESIS_RTOL = 1e-4
K, H, RUNS, HW = 16, 12, 2, 10.0

_jstep = jax.jit(jc.mppi_step, static_argnums=0)
_jadvance = jax.jit(jc.kinematic_advance, static_argnums=0)


def _log(rng, step=1, n=50, dtype=float):
    traj = np.cumsum(rng.normal(size=(n, 3)) * 0.4, axis=0).astype(dtype)
    traj[:, 2] *= 0.1
    return jev.TrajectoryLog(step=step, trajectory=traj,
                             linear_velocities=rng.uniform(0.05, 2, n).astype(dtype),
                             start=(float(traj[0, 0]), float(traj[0, 1])), goal=(4.0, -3.0))


CM_HW = 8.0


def _graded_costmap(rng, size=64):
    """Costmap cells spread over every near-miss bucket, hot cells on the
    last row (a waypoint just above the map wraps there)."""
    img = rng.uniform(0.0, 1.0, (size, size)) ** 2
    img[-1, :] = 1.0
    return as_costmap(img, CM_HW, dtype=jnp.float64)


def _port(log):
    return convert.trajectory_log_from_jax(log)


def test_csv_round_trip_across_packages(tmp_path, rng):
    logs = [_log(rng, 3), _log(rng, 1, n=20)]
    jev.save_trajectory_csv(tmp_path / "jax.csv", logs)
    tev.save_trajectory_csv(tmp_path / "port.csv", [_port(g) for g in logs])
    assert (tmp_path / "jax.csv").read_text() == (tmp_path / "port.csv").read_text()
    got = tev.load_trajectory_csv(tmp_path / "jax.csv")
    want = jev.load_trajectory_csv(tmp_path / "port.csv")
    assert [g.step for g in got] == [w.step for w in want] == [1, 3]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.trajectory, w.trajectory)
        np.testing.assert_array_equal(g.linear_velocities, w.linear_velocities)
        assert g.start == w.start and g.goal == w.goal


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rescore_and_collisions_match_jax(seed):
    rng = np.random.default_rng(seed)
    jcm = _graded_costmap(rng)
    cm = convert.costmap_from_numpy(*(np.asarray(a) for a in jcm))
    log = _log(rng, n=60)
    log.trajectory[5] = [2.0, CM_HW + 0.3, 0.0]        # row -1: wraps to the hot row
    log.trajectory[6] = [-CM_HW - 0.3, 1.0, 0.0]       # column -1: wraps
    log.trajectory[7] = [3 * CM_HW, -3 * CM_HW, 0.0]   # far right and below: clamps
    for horizon_m, weights in ((9.0, jcrit.CriticWeights()),
                               (5.4, jcrit.CriticWeights(slope_wheels=35.5))):
        want = jev.rescore_trajectory(log, jcm, horizon_m=horizon_m, weights=weights)
        got = tev.rescore_trajectory(_port(log), cm, horizon_m=horizon_m,
                                     weights=CriticWeights(*weights))
        assert set(got) == set(want)
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-12, err_msg=key)
    n = tev.count_collisions(_port(log), cm)
    assert n == jev.count_collisions(log, jcm) and n >= 1


@pytest.mark.parametrize("seed", [3, 4])
def test_thesis_rescore_matches_jax(seed):
    rng = np.random.default_rng(seed)
    jcm = _graded_costmap(rng)
    cm = convert.costmap_from_numpy(*(np.asarray(a) for a in jcm))
    for log in (_log(rng, n=80), _log(rng, n=9), _log(rng, n=3)):
        want = jev.thesis_rescore(log, jcm)
        got = tev.thesis_rescore(_port(log), cm)
        assert set(got) == set(want) and got["collided"] == want["collided"]
        for key in ("distance", "speed", "slope", "obstacle"):
            np.testing.assert_allclose(got[key], want[key], rtol=1e-12, err_msg=key)
    assert tev.path_length(log.trajectory) == jev.path_length(log.trajectory)


def test_aggregations_match_jax(rng):
    vals = rng.normal(size=23)
    for n in (0, 5, 22, 30):
        assert tev.trim_greatest(vals, n) == jev.trim_greatest(vals, n)
    for frac in (0.0, 0.1, 0.25):
        assert tev.trimmed_mean(vals, frac) == jev.trimmed_mean(vals, frac)
    a = [{"total": float(v), "slope": float(-v)} for v in rng.uniform(5, 9, 12)]
    b = [{"total": float(v), "slope": 0.0} for v in rng.uniform(5, 9, 12)]
    assert tev.compare_populations(a, b) == jev.compare_populations(a, b)


def test_thesis_pairs_follow_the_jax_draw():
    """The JAX experiment's inline draw (evaluation.py:414-429), written out."""
    rng = np.random.default_rng(42)
    for i, (start, goal, heading) in enumerate(tev.thesis_pairs(9, 75.0, 42)):
        a, b = rng.uniform(55.0, 70.0), rng.uniform(55.0, 70.0)
        off_s, off_g = rng.uniform(-50.0, 50.0), rng.uniform(-50.0, 50.0)
        hr = rng.uniform(0.0, 1.0), rng.uniform(-1.0, 1.0)
        if i % 2 == 0:
            want = ((-a, off_s), (b, off_g), [hr[0], hr[1], 0.0])
        else:
            want = ((off_s, -a), (off_g, b), [hr[1], hr[0], 0.0])
        assert tuple(start) == want[0] and tuple(goal) == want[1] and heading == want[2]


# -- the experiments as a whole ----------------------------------------------

def _jax_episode(jcfg, jhf, jcm, goal, jr, jctrl, key, max_loops):
    """goal_seek_recorded's semantics as a plain loop of JAX steps, each
    loop's noise drawn from ``sub`` of ``key, sub = split(key)``."""
    goal = np.asarray(goal)
    positions, velocities = [], []
    for n in range(max_loops):
        if np.all(np.abs(np.asarray(jr.position) - goal) <= 0.5):
            break
        key, sub = jax.random.split(key)
        noise = jsamp.sample_noise(sub, jcfg.num_samples, jcfg.horizon, jnp.float64)
        jctrl, out = _jstep(jcfg, jhf, jcm, jnp.asarray(goal), jr, jctrl, noise)
        jr = _jadvance(jcfg, jr, out)
        positions.append([*np.asarray(jr.position), float(jr.z)])
        velocities.append(float(out.linear_velocity))
    reached = bool(np.all(np.abs(np.asarray(jr.position) - goal) <= 0.5))
    assert len(positions) >= 2  # rows [:max(loops, 2)] are all driven rows
    return len(positions), reached, np.array(positions), np.array(velocities)


def _close(got, want, rtol, path=""):
    """Nested comparison: ints, bools, None and lists equal, floats at rtol."""
    if isinstance(want, dict):
        assert set(got) >= set(want), path
        for key in want:
            _close(got[key], want[key], rtol, f"{path}.{key}")
    elif isinstance(want, (bool, int, type(None), str, list)):
        assert got == want, (path, got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-12, err_msg=path)


def test_episode_protocol_matches_jax():
    max_loops, seed, span = 45, 1, 0.1
    got = tev.run_2d_vs_3d_experiment(
        ks=(K,), runs_per_arm=RUNS, horizon=H, max_loops=max_loops, half_width=HW,
        grid_size=200, costmap_size=100, seed=seed, span_fraction=span,
        dtype=torch.float64, device="cpu")

    jhf = JHeightField.create(crater_surface(200, HW, STANDALONE_CRATER_BUMPS,
                                             dtype=jnp.float64), HW, dtype=jnp.float64)
    jcm = costmap_750(half_width=HW, size=100, use_exact_edt=True)
    jcm = as_costmap(np.asarray(jcm.cost), HW, dtype=jnp.float64)
    rng = np.random.default_rng(seed)
    pairs = []
    for _ in range(RUNS):  # the JAX experiment's draw (evaluation.py:275-281)
        start = np.array([-span * HW, 0.0]) + rng.uniform(-0.15, 0.15, 2) * HW
        goal = np.array([span * HW, 0.0]) + rng.uniform(-0.15, 0.15, 2) * HW
        pairs.append((start, goal))
    entry = {"collisions": {}, "reached": {}}
    scores = {}
    for proj in ("3d", "2d"):
        jcfg = jc.MPPIConfig(num_samples=K, horizon=H, projection=proj)
        scores[proj], entry["collisions"][proj], entry["reached"][proj] = [], 0, 0
        for run_idx, (start, goal) in enumerate(pairs):
            jr = jc.RobotState.create(start[0], start[1], [1.0, 0.0, 0.0], dtype=jnp.float64)
            jctrl = jc.ControllerState.create(jcfg, jnp.float64)
            loops, reached, pos, vel = _jax_episode(
                jcfg, jhf, jcm, goal, jr, jctrl, jax.random.key(seed * 1000 + run_idx),
                max_loops)
            log = jev.TrajectoryLog(run_idx, pos, vel, tuple(start), tuple(goal))
            scores[proj].append(jev.rescore_trajectory(log, jcm,
                                                       horizon_m=float(jcfg.horizon_m)))
            entry["collisions"][proj] += jev.count_collisions(log, jcm)
            entry["reached"][proj] += int(reached)
    entry["trimmed_means"] = jev.compare_populations(scores["2d"], scores["3d"])

    assert got["config"] == {"ks": [K], "runs_per_arm": RUNS, "horizon": H,
                             "max_loops": max_loops}
    assert 0 < entry["reached"]["3d"] + entry["reached"]["2d"] < 2 * RUNS  # both outcomes
    _close(got["per_k"][K], entry, EPISODE_RTOL)
    assert set(got["per_k"][K]) == set(entry) | {"wall_s", "steps", "finite"}
    assert got["per_k"][K]["finite"] == {"3d": True, "2d": True}


@pytest.mark.parametrize("projection", ["3d", "2d"])
def test_evaluation_run_from_its_seed_matches_jax(projection):
    """One run of each arm with no noise injected (float64, a 45-loop cap):
    the port's run keys its goal-seek ``key(seed * 1000 + run)``, both arms
    alike, as the JAX runner does (evaluation.py:313, :468), and its loop
    count, reach and recorded path are JAX's ``goal_seek_recorded`` from that
    key at tests/test_torch_controller.py's ``SEEK_ATOL``."""
    from test_torch_controller import SEEK_ATOL

    max_loops, seed, run_idx = 45, 3, 1
    jhf = JHeightField.create(crater_surface(200, HW, STANDALONE_CRATER_BUMPS,
                                             dtype=jnp.float64), HW, dtype=jnp.float64)
    jcm = as_costmap(np.asarray(costmap_750(half_width=HW, size=100, use_exact_edt=True).cost),
                     HW, dtype=jnp.float64)
    thf = convert.heightfield_from_numpy(*(np.asarray(a) for a in jhf))
    tcm = convert.costmap_from_numpy(*(np.asarray(a) for a in jcm))
    jcfg = jc.MPPIConfig(num_samples=K, horizon=H, projection=projection)
    tcfg = convert.config_from_jax(jcfg)
    start, goal = (-8.0, -2.0), (5.0, 4.0)
    jrob = jc.RobotState.create(*start, [1.0, 0.0, 0.0], dtype=jnp.float64)
    jctrl = jc.ControllerState.create(jcfg, jnp.float64)
    want = jax.jit(jc.goal_seek_recorded, static_argnums=(0, 7))(
        jcfg, jhf, jcm, jnp.asarray(goal), jrob, jctrl,
        jax.random.key(seed * 1000 + run_idx), max_loops)
    trob = convert.robot_state_from_numpy(*(np.asarray(a) for a in jrob))
    tctrl = convert.controller_state_from_numpy(*(np.asarray(a) for a in jctrl))
    loops, reached, pos, vel, _ = tev._run_episode(tcfg, thf, tcm, goal, trob, tctrl, seed,
                                                   run_idx, max_loops)
    assert loops == int(want.loops) and reached == bool(want.reached)
    np.testing.assert_allclose(pos[:loops], np.asarray(want.positions)[:loops], rtol=0,
                               atol=SEEK_ATOL)
    np.testing.assert_allclose(vel[:loops], np.asarray(want.velocities)[:loops], rtol=0,
                               atol=SEEK_ATOL)


def _small_pairs(runs_per_arm, half_width, seed):
    """Short traverses inside a 20 m map: the protocol's 55-70 m band
    (:func:`thesis_pairs`, tested above) needs a map of at least 114 m."""
    rng = np.random.default_rng(seed)
    return [(rng.uniform(-1.0, -0.5, 2), rng.uniform(0.3, 0.8, 2),
             [rng.uniform(0.2, 1.0), rng.uniform(-1.0, 1.0), 0.0])
            for _ in range(runs_per_arm)]


def test_thesis_protocol_matches_jax(monkeypatch):
    max_loops, seed, terrain_seed = 60, 6, 7
    _, k = jax.random.split(jax.random.key(terrain_seed))
    k1, k2 = jax.random.split(k)
    base_noise = tuple(torch.from_numpy(np.array(a)) for a in (
        jax.random.uniform(k1, (4, 4), minval=-1.2, maxval=1.2),
        jax.random.uniform(k2, (100, 100), minval=-0.012, maxval=0.012)))
    monkeypatch.setattr(tev, "thesis_pairs", _small_pairs)
    got = tev.run_thesis_protocol_experiment(
        ks=(K,), runs_per_arm=RUNS, horizon=H, max_loops=max_loops, half_width=HW,
        seed=seed, terrain_seed=terrain_seed, dtype=torch.float64,
        device="cpu", base_noise=base_noise)

    z = thesis_statistics_terrain(seed=terrain_seed, size_m=2 * HW)
    jhf = JHeightField.create(jnp.asarray(z, jnp.float64), HW, dtype=jnp.float64)
    jcm = costmap_750(half_width=HW, size=200, use_exact_edt=True)
    jcm = as_costmap(np.asarray(jcm.cost), HW, dtype=jnp.float64)
    weights = jcrit.CriticWeights(slope_wheels=35.5)
    arms, scores = {}, {}
    for proj in ("3d", "2d"):
        jcfg = jc.MPPIConfig(num_samples=K, horizon=H, projection=proj, critic_weights=weights,
                             sigma_base=0.3, slope_critic="body")
        scores[proj], fail, collide, loops_l, v_means, v_stalls = [], 0, 0, [], [], []
        for run_idx, (start, goal, heading) in enumerate(_small_pairs(RUNS, HW, seed)):
            jr = jc.RobotState.create(start[0], start[1], heading, dtype=jnp.float64,
                                      wheel_speed=1.0)
            jctrl = jc.ControllerState.create(jcfg, jnp.float64, initial_u=1.0)
            loops, reached, pts, vels = _jax_episode(
                jcfg, jhf, jcm, goal, jr, jctrl, jax.random.key(seed * 1000 + run_idx),
                max_loops)
            # the JAX experiment's log (evaluation.py:472-485)
            pts = np.vstack([[start[0], start[1], pts[0, 2]], pts])
            vels = np.concatenate([vels[:1], vels])
            log = jev.TrajectoryLog(run_idx, pts, vels, tuple(start), tuple(goal))
            loops_l.append(loops)
            v_means.append(float(vels.mean()))
            v_stalls.append(float((vels < 0.1).mean()))
            if not reached:
                fail += 1
                continue
            score = jev.thesis_rescore(log, jcm)
            if score.pop("collided"):
                collide += 1
                continue
            scores[proj].append(score)
        arms[proj] = {"failed": fail, "collided": collide, "completed": len(scores[proj]),
                      "mean_loops": float(np.mean(loops_l)),
                      "mean_velocity": float(np.mean(v_means)),
                      "stall_fraction": float(np.mean(v_stalls))}
    critics = {}
    for critic in ("distance", "speed", "slope", "obstacle"):  # evaluation.py:515-525
        row = {}
        for p in ("2d", "3d"):
            vals = [s[critic] for s in scores[p]]
            row[p] = float(np.mean(jev.trim_greatest(vals))) if vals else None
        if row["2d"] is not None and row["3d"]:
            row["beaten_by_pct"] = 100.0 * (row["2d"] - row["3d"]) / row["3d"]
        critics[critic] = row

    assert sum(a["completed"] for a in arms.values()) > 0  # the rescoring branch ran
    _close(got["per_k"][K], {"arms": arms, "critics": critics}, THESIS_RTOL)
    for arm in got["per_k"][K]["arms"].values():
        assert set(arm) == set(arms["3d"]) | {"wall_s", "episode_s", "steps", "finite"}
        assert arm["finite"] and 0.0 < arm["episode_s"] <= arm["wall_s"]
    assert got["config"]["slope_critic"] == "body" and got["config"]["runs_per_arm"] == RUNS


def test_cli_evaluation_prints_the_jax_keys(capsys):
    args = ["mode=evaluation", "world.half_width=10", "world.grid_size=160",
            "world.costmap_size=80", "evaluation.ks=[8]", "evaluation.horizon=10",
            "evaluation.runs_per_arm=2", "evaluation.max_loops=5", "seed=2"]
    assert cli.main(args + ["device=cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    want = json.loads(json.dumps(jcli.run_evaluation(apply_overrides({}, args))))
    assert set(got) == set(want) | {"device"} and got["device"] == "cpu"
    assert got["mode"] == "evaluation" and got["config"] == want["config"]
    g, w = got["per_k"]["8"], want["per_k"]["8"]
    assert set(g) == set(w) | {"wall_s", "steps", "finite"}
    assert set(g["trimmed_means"]) == set(w["trimmed_means"])
    assert g["steps"] == {"3d": 16, "2d": 16}  # two runs of 5 loops, 8 unrolled steps each


def test_cli_thesis_protocol_refuses_five_runs():
    args = ["mode=evaluation", "evaluation.protocol=thesis", "evaluation.runs_per_arm=5"]
    for main in (cli.main, lambda a: jcli.run_evaluation(apply_overrides({}, a))):
        with pytest.raises(SystemExit, match="drop-5-greatest"):
            main(args + ["device=cpu"])


def test_run_episode_draws_from_a_seeded_generator():
    """A run draws from ``key(seed * 1000 + run)``: the same run twice
    gives the same trace, another run another, on the host as numpy
    arrays."""
    hf = tc.HeightField.create(torch.zeros((64, 64), dtype=torch.float64), 4.0)
    cm = t_as_costmap(np.zeros((16, 16)), 4.0, dtype=torch.float64)
    cfg = tc.MPPIConfig(num_samples=8, horizon=6)

    def run(run_idx):
        robot = tc.RobotState.create(-0.9, 0.0, [1.0, 0.0, 0.0], dtype=torch.float64,
                                     wheel_speed=1.0)
        ctrl = tc.ControllerState.create(cfg, torch.float64, initial_u=1.0)
        return tev._run_episode(cfg, hf, cm, np.array([0.9, 0.0]), robot, ctrl, seed=1,
                                run_idx=run_idx, max_loops=7)

    loops, reached, pos, vel, steps = run(0)
    assert isinstance(pos, np.ndarray) and pos.shape == (7, 3) and vel.shape == (7,)
    assert loops == 7 and not reached and steps == 8
    assert np.all(pos[:, 0] > -0.9)  # it drove towards the goal
    again = run(0)
    assert again[:2] == (loops, reached)
    np.testing.assert_array_equal(again[2], pos)
    assert not np.array_equal(run(1)[2], pos)
