"""PyTorch port: sample and rover sharding over ``torch.distributed`` (gloo,
CPU ranks in their own processes) against the JAX package's ``mppi_step`` on
the same float64 world, state and noise, at the tolerances with which
``tests/test_sharding.py`` and ``tests/test_scaling.py`` hold the JAX
sharded steps to it: costs to rtol 1e-12, the optimal inputs, velocities and
stds to 1e-12, the optimal rollout and the rollouts to 1e-10; the weights at
the cross-package tolerance of ``tests/test_torch_controller.py`` (rtol 1e-11,
atol 1e-20).

Each rank's costs, weights and rollouts are its rows of the reference; the
controller state and the optimum are replicated. Besides, per-sample results
do not depend on the shard, so each rank's per-sample rows are also
``torch.equal`` to the port's own unsharded ``mppi_step``. The ranks start
through ``shard_ranks.run_ranks`` (a fresh interpreter each, rendezvous
through a FileStore under the test's temporary directory, a deadline on
every wait)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from husky_rover_mppi_isaacsim_torch import convert, parallel
from husky_rover_mppi_isaacsim_torch.mppi import ControllerState, MPPIConfig, RobotState, mppi_step
from husky_rover_mppi_isaacsim_tpu.core import HeightField as JHeightField
from husky_rover_mppi_isaacsim_tpu.mppi import MPPIConfig as JMPPIConfig
from husky_rover_mppi_isaacsim_tpu.mppi import controller as jc
from husky_rover_mppi_isaacsim_tpu.parallel import scaling as jscaling
from husky_rover_mppi_isaacsim_tpu.terrain import as_costmap, crater_surface
from shard_ranks import run_ranks

torch.set_num_threads(1)

K, H, N_ROVERS = 64, 20, 4
# the default configuration and the non-default ones of tests/test_sharding.py:67
VARIANTS = {
    "default": {},
    "body_rollouts": dict(sigma_base=0.3, slope_critic="body", return_rollouts=True),
    "projection_2d": dict(projection="2d"),
}
JCONFIGS = {n: JMPPIConfig(num_samples=K, horizon=H, exact=True, **kw)
            for n, kw in VARIANTS.items()}
CONFIGS = {n: convert.config_from_jax(c) for n, c in JCONFIGS.items()}
PER_SAMPLE = ("costs", "weights", "rollouts")
# field -> (rtol, atol): tests/test_sharding.py, but for the weights those
# with which tests/test_torch_controller.py holds the port's unsharded step to
# JAX's: the packages reduce the costs in different orders, and a 1e-14
# relative cost difference moves exp(-(c - min)/T) by ~1e-12 relative once
# (c - min)/T nears 150 (weights under 1e-20 carry no mass)
TOL = {
    "costs": (1e-12, 0), "weights": (1e-11, 1e-20), "rollouts": (0, 1e-10),
    "linear_velocity": (0, 1e-12), "angular_velocity": (0, 1e-12),
    "optimal_linear": (0, 1e-12), "optimal_angular": (0, 1e-12),
    "optimal_trajectory": (0, 1e-10), "optimal_headings": (0, 1e-10),
}
CTRL_ATOL = 1e-12

_jstep = jax.jit(jc.mppi_step, static_argnums=0)


def _jax_inputs():
    """The JAX package's world and states (float64), as tests/test_sharding.py
    builds them, and N_ROVERS rovers for the rover x sample mesh."""
    f64, hw = jnp.float64, 25.0
    hf = JHeightField.create(crater_surface(128, hw, [((-5.0, 8.0), 1.5, 8.0)], dtype=f64),
                             hw, dtype=f64)
    rng = np.random.default_rng(11)
    cm = as_costmap(rng.uniform(0, 0.9, (16, 16)) ** 4, hw, dtype=f64)
    starts = rng.uniform(-10.0, 10.0, (N_ROVERS, 2))
    return dict(
        hf=hf, costmap=cm, goal=jnp.asarray([10.0, 9.0], f64),
        robot=jc.RobotState.create(-9.0, -7.0, [1.0, 0.3, 0.0], dtype=f64),
        ctrl=jc.ControllerState.create(JCONFIGS["default"], f64),
        noise=jnp.asarray(rng.normal(size=(2, K, H))),
        goals=jnp.asarray(rng.uniform(-12.0, 12.0, (N_ROVERS, 2))),
        robots=jc.RobotState(jnp.asarray(starts), jnp.zeros(N_ROVERS, f64),
                             jnp.asarray([[1.0, 0.2, 0.0]] * N_ROVERS, f64),
                             jnp.asarray(rng.uniform(0, 1, N_ROVERS)),
                             jnp.asarray(rng.uniform(0, 1, N_ROVERS))),
        ctrls=jc.ControllerState(*(jnp.asarray(a) for a in (
            rng.uniform(-1, 1, (N_ROVERS, H)), rng.uniform(-1, 1, (N_ROVERS, H)),
            rng.uniform(0.2, 0.5, N_ROVERS), rng.uniform(0.2, 0.5, N_ROVERS)))),
        rover_noise=jnp.asarray(rng.normal(size=(N_ROVERS, 2, K, H))),
    )


def _port_job(j):
    """The same inputs as the port's tensors (copies of the JAX arrays)."""
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return dict(
        hf=convert.heightfield_from_numpy(*j["hf"]),
        costmap=convert.costmap_from_numpy(*j["costmap"]),
        goal=t(j["goal"]), robot=convert.robot_state_from_numpy(*j["robot"]),
        ctrl=convert.controller_state_from_numpy(*j["ctrl"]), noise=t(j["noise"]),
        goals=t(j["goals"]), robots=convert.robot_state_from_numpy(*j["robots"]),
        ctrls=convert.controller_state_from_numpy(*j["ctrls"]),
        rover_noise=t(j["rover_noise"]))


@pytest.fixture(scope="module")
def inputs():
    j = _jax_inputs()
    return j, _port_job(j)


@pytest.fixture(scope="module")
def jax_refs(inputs):
    """The JAX package's unsharded step for each configuration, and for each
    rover of the multi-rover state (the default configuration)."""
    j, _ = inputs
    refs = {n: _jstep(c, j["hf"], j["costmap"], j["goal"], j["robot"], j["ctrl"], j["noise"])
            for n, c in JCONFIGS.items()}
    for r in range(N_ROVERS):
        refs["rover", r] = _jstep(JCONFIGS["default"], j["hf"], j["costmap"], j["goals"][r],
                                  jax.tree.map(lambda a: a[r], j["robots"]),
                                  jax.tree.map(lambda a: a[r], j["ctrls"]),
                                  j["rover_noise"][r])
    return refs


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """One launch of 2 ranks and one of 4, every case of the file in them."""
    job = inputs[1]
    samples = [{"kind": "sample", "config": c} for c in CONFIGS.values()]
    base = tmp_path_factory.mktemp("ranks")
    two = run_ranks({**job, "cases": samples}, 2, base / "two", timeout_s=240)
    report = base / "scaling.json"
    four = run_ranks({**job, "cases": samples + [
        {"kind": "multi_rover", "config": CONFIGS["default"], "mesh": (2, 2)},
        {"kind": "sweep", "config": CONFIGS["default"], "counts": [1, 2, 4, 8], "iters": 2,
         "report": str(report), "note": "4 gloo ranks on one CPU host"}]},
        4, base / "four", timeout_s=240)
    return {2: two, 4: four, "report": report}


def _close(got, want, rtol, atol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


def _check_replicated(got_ctrl, got_out, ref_ctrl, ref_out, what):
    """The replicated controller state and optimum against a reference step
    (the JAX package's or the port's)."""
    for f in ref_ctrl._fields:
        _close(getattr(got_ctrl, f), getattr(ref_ctrl, f), 0, CTRL_ATOL, f"{what}: {f}")
    for f in ("linear_velocity", "angular_velocity", "optimal_linear", "optimal_angular",
              "optimal_trajectory", "optimal_headings"):
        _close(getattr(got_out, f), getattr(ref_out, f), *TOL[f], f"{what}: {f}")


def _check_rows(shards, ref_out, what):
    """Each rank's per-sample rows against its block of the reference."""
    n = len(shards)
    for f in PER_SAMPLE:
        want = getattr(ref_out, f)
        if want is None:
            assert all(getattr(s, f) is None for s in shards), f
            continue
        want = np.asarray(want)
        for r, s in enumerate(shards):
            got = getattr(s, f)
            assert got.shape[0] == K // n, f
            _close(got, want[r * K // n:(r + 1) * K // n], *TOL[f], f"{what}: rank {r} {f}")


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_sharded_step_matches_unsharded(inputs, jax_refs, runs, world, name):
    job = inputs[1]
    cfg = CONFIGS[name]
    case = list(CONFIGS).index(name)
    per_rank = [r[case] for r in runs[world]]
    first = per_rank[0]
    for r in per_rank[1:]:  # the controller state and the optimum are replicated
        for a, b in zip(r["ctrl"] + r["out"][:6], first["ctrl"] + first["out"][:6]):
            assert torch.equal(a, b)
    # against the JAX package
    jref_ctrl, jref_out = jax_refs[name]
    _check_rows([r["out"] for r in per_rank], jref_out, f"{name} vs JAX")
    _check_replicated(first["ctrl"], first["out"], jref_ctrl, jref_out, f"{name} vs JAX")
    # against the port's unsharded step: per-sample rows bit-equal
    ref_ctrl, ref_out = mppi_step(cfg, job["hf"], job["costmap"], job["goal"], job["robot"],
                                  job["ctrl"], job["noise"])
    for f in PER_SAMPLE:
        if getattr(ref_out, f) is not None:
            assert torch.equal(torch.cat([getattr(r["out"], f) for r in per_rank]),
                               getattr(ref_out, f)), f
    _check_replicated(first["ctrl"], first["out"], ref_ctrl, ref_out, name)
    assert all(r["k1_launches"] == 0 for r in per_rank)  # CPU ranks: the plain rollout


def test_multi_rover_step_on_a_2x2_mesh(inputs, jax_refs, runs):
    """Rovers over ``rover``, samples over ``sample``: rank r holds rovers
    2 (r // 2) .. +2 and samples 32 (r % 2) .. +32; each rover against the
    JAX package's one-rover ``mppi_step``, and its costs and weights
    ``torch.equal`` to the port's."""
    job = inputs[1]
    cfg = CONFIGS["default"]
    per_rank = [r[3] for r in runs[4]]
    half = K // 2
    for rover in range(N_ROVERS):
        ranks = [2 * (rover // 2), 2 * (rover // 2) + 1]
        local = rover % 2
        outs = []
        for r in ranks:
            assert per_rank[r]["out"].costs.shape == (2, half)
            ctrl = ControllerState(*(t[local] for t in per_rank[r]["ctrl"]))
            out = type(per_rank[r]["out"])(*(t[local] if t is not None else None
                                             for t in per_rank[r]["out"]))
            _check_replicated(ctrl, out, *jax_refs["rover", rover], f"rover {rover} vs JAX")
            outs.append(out)
        _check_rows(outs, jax_refs["rover", rover][1], f"rover {rover} vs JAX")
        _, ref_out = mppi_step(cfg, job["hf"], job["costmap"], job["goals"][rover],
                               RobotState(*(t[rover] for t in job["robots"])),
                               ControllerState(*(t[rover] for t in job["ctrls"])),
                               job["rover_noise"][rover])
        for f in ("costs", "weights"):
            got = torch.cat([getattr(o, f) for o in outs])
            assert got.shape == (K,) and torch.equal(got, getattr(ref_out, f)), (rover, f)


def test_scaling_sweep_and_report(runs):
    """The sweep runs 1, 2 and 4 shards (8 > world size is skipped) and
    every rank gets rank 0's rows; rank 0 writes the report. No efficiency
    is asserted: the ranks share one host."""
    rows = [r[4]["results"] for r in runs[4]]
    assert all(r == rows[0] for r in rows)
    assert sorted(rows[0]) == [1, 2, 4]
    assert all(v["step_ms"] > 0 for v in rows[0].values()) and rows[0][1]["efficiency"] == 1.0
    report = json.loads(runs["report"].read_text())
    assert report == runs[4][0][4]["report"]
    assert sorted(report["results"]) == ["1", "2", "4"]
    dev = report["devices"]
    assert dev["backend"] == "gloo" and dev["world_size"] == 4 and dev["device_kind"] == "cpu"
    assert "no scaling claim" in dev["shared_device"]
    assert report["note"] == "4 gloo ranks on one CPU host"
    assert report["config"] == {"num_samples": K, "horizon": H}


def _ratchet_sequence(write, path):
    cfg = dict(num_samples=K, horizon=H)
    seq = [({1: {"step_ms": 2.0, "efficiency": 1.0}, 2: {"step_ms": 4.0, "efficiency": 0.5}}, cfg),
           ({1: {"step_ms": 2.0, "efficiency": 1.0}, 2: {"step_ms": 6.0, "efficiency": 0.3}}, cfg),
           ({1: {"step_ms": 2.0, "efficiency": 1.0}, 2: {"step_ms": 3.0, "efficiency": 0.7}}, cfg),
           ({1: {"step_ms": 9.0, "efficiency": 1.0}, 2: {"step_ms": 90.0, "efficiency": 0.1}},
            dict(num_samples=2 * K, horizon=H))]
    path.write_text(json.dumps({"two_process_weak_scaling": {"kept": True}}))
    out = []
    for rows, c in seq:
        report = write(path, rows, c)
        out.append({k: v for k, v in report.items() if k != "devices"})
    lines = (path.parent / (path.name + ".runs.jsonl")).read_text().splitlines()
    return out, lines


def test_write_scaling_report_ratchets_like_jax(tmp_path):
    """The same four sweeps through both writers: a worse comparable sweep
    keeps the stored rows (and records its worst efficiency), a better one
    replaces them as a whole, another config replaces them; keys the writer
    does not own survive; every run lands in ``.runs.jsonl``."""
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    got, got_lines = _ratchet_sequence(
        lambda p, rows, c: parallel.write_scaling_report(p, rows, MPPIConfig(**c), note="n",
                                                         device="cpu"),
        tmp_path / "t" / "scaling.json")
    want, want_lines = _ratchet_sequence(
        lambda p, rows, c: jscaling.write_scaling_report(p, rows, JMPPIConfig(**c), note="n"),
        tmp_path / "j" / "scaling.json")
    assert got == want and got_lines == want_lines and len(got_lines) == 4
    assert got[1]["last_run_worst_efficiency"] == 0.3 and got[1]["results"]["2"]["efficiency"] == 0.5
    assert got[2]["results"]["2"]["efficiency"] == 0.7 and "last_run_worst_efficiency" not in got[2]
    assert got[3]["config"]["num_samples"] == 2 * K
    assert all(r["two_process_weak_scaling"] == {"kept": True} for r in got)
    assert jax.default_backend() == "cpu"


def test_initialize_distributed_is_a_no_op_for_one_process():
    parallel.initialize_distributed("tcp://localhost:1", 1, 0)
    parallel.initialize_distributed()
    assert not dist.is_initialized()


def test_shard_sizes_must_divide(tmp_path):
    """A rank cannot take a share of 64 samples over 3 ranks: the launch
    fails with the rank's error, and every rank process has ended."""
    job = _port_job(_jax_inputs())
    with pytest.raises(RuntimeError, match="do not split"):
        run_ranks({**job, "cases": [{"kind": "sample", "config": CONFIGS["default"]}]}, 3,
                  tmp_path, timeout_s=120)
