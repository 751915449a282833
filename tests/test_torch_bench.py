"""PyTorch port: ``bench_torch.py``, the port of the JAX repo's ``bench.py``,
on the CPU.

The loops the bench replays are held against the JAX package, fed the same
world, state and numpy noise (float64):

* ``control_loops``, 8 dependent loops of ``mppi_step`` +
  ``kinematic_advance`` at K=64 x H=16, against a JAX ``lax.scan`` of
  ``jc.mppi_step`` + ``jc.kinematic_advance`` over the same noise, loop by
  loop, at tests/test_torch_controller.py's ``TOL``: the robot state within
  its optimal trajectory's atol (1e-10; the robot stands on the trajectory's
  first point), the controller's optimal inputs within twice its weights'
  rtol (2e-11: a weighted mean of inputs in [-1, 1] whose weights agree to
  1e-11 relative agrees to 2e-11). The weights' bound is what a chain of
  loops needs: at T = 0.3 the weights are e^(-(c - min)/T) of costs near 1e3
  to 1e4, which the packages sum in other orders (1e-15 relative), so the
  optimal inputs, which both packages feed to the next loop, drift by up to
  1.4e-11 over the 8 body-critic loops (measured; 4e-16 for the wheels);
* ``vec_env_steps``, 100 physics steps of 64 rovers, against JAX's scan of
  ``rover_sim.step``, within 1e-10 (tests/test_torch_env.py's
  ``test_step_matches_jax_over_120_steps``).

The bench traverse's configuration is bench.py's field by field (the TPU-only
fields apart), the line's keys are bench.py's (read with ``ast``) with the
two renames, the dropped keys and the port's additions, and the bench
functions run at tiny shapes on the CPU (their times are not measurements:
a time is the card's only).
"""

import ast
import dataclasses
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_torch as bt
from husky_rover_mppi_isaacsim_torch import convert
from husky_rover_mppi_isaacsim_torch.cli import build_standalone_world
from husky_rover_mppi_isaacsim_torch.mppi.controller import MPPIConfig
from husky_rover_mppi_isaacsim_torch.ops.rollout_cuda import rollout_25d_cuda
from husky_rover_mppi_isaacsim_tpu.core import HeightField as JHeightField
from husky_rover_mppi_isaacsim_tpu.env import largescale_loop as jls
from husky_rover_mppi_isaacsim_tpu.env import rover_sim as jrs
from husky_rover_mppi_isaacsim_tpu.env.closed_loop import ClosedLoopConfig as JLoopConfig
from husky_rover_mppi_isaacsim_tpu.mppi import controller as jc
from husky_rover_mppi_isaacsim_tpu.terrain import crater_surface
from husky_rover_mppi_isaacsim_tpu.terrain.orchestrator import LargeScaleConf as JLargeScaleConf

from test_torch_controller import TOL, _states, _world
from test_torch_largescale_paths import conf as tiny_conf

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
LOOPS, K, H = 8, 64, 16
# tests/test_torch_env.py's bound on 120 chained float64 physics steps
VEC_ATOL = 1e-10
ROBOT_ATOL, CTRL_ATOL = TOL["optimal_trajectory"][1], 2 * TOL["weights"][0]


@pytest.mark.parametrize("slope_critic", ["wheels", "body"])
def test_control_loops_match_a_jax_scan(rng, slope_critic):
    """The loops bench_control_loop replays, one call of 8, against JAX's
    scan of the same 8 loops; a call of 8 loops is bit-equal to 8 calls of
    one, so each loop's state is held against the scan's."""
    (jhf, jcm), (thf, tcm) = _world()
    jcfg = jc.MPPIConfig(num_samples=K, horizon=H, exact=False, slope_critic=slope_critic)
    tcfg = convert.config_from_jax(jcfg)
    (jr, jctrl), (tr, tctrl) = _states(jcfg, -10.0, -8.0, [1.0, 0.5, 0.0])
    goal = np.array([15.0, 12.0])
    noises = rng.normal(size=(LOOPS, 2, K, H))

    def body(carry, noise):
        r, c = carry
        c, out = jc.mppi_step(jcfg, jhf, jcm, jnp.asarray(goal), r, c, noise)
        r = jc.kinematic_advance(jcfg, r, out)
        return (r, c), (r, c)

    _, (jrs_, jcs) = jax.jit(lambda r, c, n: jax.lax.scan(body, (r, c), n))(
        jr, jctrl, jnp.asarray(noises))

    tgoal = torch.from_numpy(goal)
    tnoises = tuple(torch.from_numpy(n) for n in noises)
    before = rollout_25d_cuda.launches
    r_all, c_all = bt.control_loops(tcfg, thf, tcm, tgoal, tr, tctrl, tnoises)
    r, c = tr, tctrl
    for i, noise in enumerate(tnoises):
        r, c = bt.control_loops(tcfg, thf, tcm, tgoal, r, c, (noise,))
        for f, a in zip(r._fields, r):
            np.testing.assert_allclose(a.numpy(), np.asarray(getattr(jrs_, f))[i], rtol=0,
                                       atol=ROBOT_ATOL, err_msg=f"robot {f}, loop {i}")
        for f, a in zip(c._fields, c):
            np.testing.assert_allclose(a.numpy(), np.asarray(getattr(jcs, f))[i], rtol=0,
                                       atol=CTRL_ATOL, err_msg=f"controller {f}, loop {i}")
    assert all(torch.equal(a, b) for a, b in zip(r_all + c_all, r + c))
    assert rollout_25d_cuda.launches == before  # CPU tensors: the plain rollout
    assert float(torch.linalg.norm(r.position - tr.position)) > 0.01  # the robot moved


def test_vec_env_block_matches_a_jax_scan():
    """bench_vec_env's block of physics steps: 64 rovers from the bench's
    start (U(-50, 50)^2, heading +x, command 1.5 m/s on both wheels) over
    100 steps, against JAX's scan of rover_sim.step."""
    hw = 60.0
    z = np.asarray(crater_surface(256, hw, [((-12.0, 14.0), 4.0, 8.0), ((20.0, -30.0), 8.0, 5.0)],
                                  dtype=jnp.float64))
    jhf = JHeightField.create(z, hw, dtype=jnp.float64)
    thf = convert.heightfield_from_numpy(*(np.asarray(a) for a in jhf))
    state, cmd = bt.vec_env_start(thf, 64)
    assert state.position.dtype == cmd.dtype == torch.float64
    js = jrs.RoverState.create(state.position.numpy(), [1.0, 0.0, 0.0], jhf)
    jcmd = jnp.full((64,), 1.5, jnp.float64)
    params = jrs.RoverParams()
    jout, _ = jax.jit(lambda s: jax.lax.scan(
        lambda s, _: (jrs.step(params, jhf, s, jcmd, jcmd), None), s, None, length=100))(js)
    got = bt.vec_env_steps(convert.rover_params_from_jax(params), thf, state, cmd, 100)
    for f, a, b in zip(got._fields, got, jout):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=VEC_ATOL, err_msg=f)
    assert float(torch.abs(got.position - state.position).max()) > 1.0  # the rovers moved


def _call_keywords(fn: ast.FunctionDef, callee: str) -> dict:
    """The keywords of the call of ``callee`` inside ``fn``: literal values
    as values, others as their source."""
    call = next(n for n in ast.walk(fn) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == callee)
    out = {}
    for kw in call.keywords:
        try:
            out[kw.arg] = ast.literal_eval(kw.value)
        except ValueError:
            out[kw.arg] = ast.unparse(kw.value)
    return out


def _function(path: Path, name: str) -> ast.FunctionDef:
    tree = ast.parse(path.read_text())
    return next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == name)


def test_bench_traverse_configuration_is_bench_py_s():
    """bench_largescale_conf against the LargeScaleLoopConf bench.py's
    bench_largescale builds (its keywords read from bench.py), field by
    field, apart from the TPU-only engine switch and MPPI fields."""
    kws = _call_keywords(_function(REPO / "bench.py", "bench_largescale"), "LargeScaleLoopConf")
    assert set(kws) == {"terrain", "loop", "start", "goal", "max_steps", "terrain_check_every"}
    assert kws["terrain"] == "LargeScaleConf()"
    assert kws["goal"] == "(traverse_m, 8.0)"
    want = jls.LargeScaleLoopConf(
        terrain=JLargeScaleConf(),
        loop=JLoopConfig(mppi=jc.MPPIConfig(num_samples=1000, horizon=100),
                         rover=jrs.RoverParams()),
        start=kws["start"], goal=(100.0, 8.0), max_steps=kws["max_steps"],
        terrain_check_every=kws["terrain_check_every"])
    got = bt.bench_largescale_conf(100.0)
    assert (got.start, got.goal, got.max_steps, got.terrain_check_every) == (
        (0.0, 0.0), (100.0, 8.0), 40000, 48)
    for f in dataclasses.fields(jls.LargeScaleLoopConf):
        if f.name == "auto_engine":  # the JAX gather-engine switch
            continue
        if f.name == "terrain":
            assert dataclasses.asdict(got.terrain) == dataclasses.asdict(want.terrain)
        elif f.name == "loop":
            assert got.loop == convert.closed_loop_config_from_jax(want.loop)
        else:
            assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert {f.name for f in dataclasses.fields(got)} == (
        {f.name for f in dataclasses.fields(want)} - {"auto_engine"})


def _dict_keys(path: Path, marker: str) -> set:
    """The string keys of the one dict literal of ``path`` that has the key
    ``marker``."""
    tree = ast.parse(path.read_text())
    found = [n for n in ast.walk(tree) if isinstance(n, ast.Dict)
             and any(isinstance(k, ast.Constant) and k.value == marker for k in n.keys)]
    assert len(found) == 1, (path, marker)
    return {k.value for k in found[0].keys}


def _bench_py_detail_keys() -> tuple[set, set]:
    """bench.py's ``detail`` keys (its dict literal, plus the
    ``largescale_streamed`` key main assigns after it) and the keys of
    bench_largescale's dict."""
    path = REPO / "bench.py"
    detail = _dict_keys(path, "methodology")
    tree = ast.parse(path.read_text())
    assigned = {n.targets[0].slice.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
                and isinstance(n.targets[0], ast.Subscript)
                and isinstance(n.targets[0].slice, ast.Constant)
                and ast.unparse(n.targets[0].value) == "result['detail']"}
    return detail | assigned, _dict_keys(path, "window_px")


def test_line_keys_are_bench_py_s_with_the_renames_and_drops():
    """The key test: bench.py's detail keys (and its largescale keys),
    minus the dropped TPU-only keys, with the two Pallas renames, plus the
    port's additions, are bench_torch.py's: its key sets and the dict
    literals its measure and traverse functions return."""
    jax_detail, jax_ls = _bench_py_detail_keys()
    assert set(bt.RENAMED) <= jax_detail and len(bt.RENAMED) == 2
    assert bt.DROPPED <= jax_detail | jax_ls
    want = {bt.RENAMED.get(k, k) for k in jax_detail - bt.DROPPED} | {"repeats"}
    want_ls = (jax_ls - bt.DROPPED) | {"max_dispatch_gap_ms", "worker_blocking_waits",
                                       "peak_device_memory_gb"}
    assert bt.DETAIL_KEYS == want and bt.LARGESCALE_KEYS == want_ls
    path = REPO / "bench_torch.py"
    assert _dict_keys(path, "methodology") == bt.DETAIL_KEYS
    assert _dict_keys(path, "window_px") == bt.LARGESCALE_KEYS
    assert set(bt.LARGESCALE_TIMED) <= bt.LARGESCALE_KEYS
    assert bt.BASELINE_ROLLOUT_STEPS_PER_S == 3.3e7


@pytest.fixture(scope="module")
def tiny_world():
    hf, cm, _ = build_standalone_world({"half_width": 10.0, "grid_size": 100, "costmap_size": 50},
                                       bt.DTYPE, torch.device("cpu"))
    return hf, cm


def _positive(t):
    return math.isfinite(t) and t > 0.0


@pytest.mark.parametrize("slope_critic", ["wheels", "body"])
def test_bench_control_loop_runs_on_cpu(tiny_world, slope_critic):
    hf, cm = tiny_world
    record = {}
    per_loop, rate = bt.bench_control_loop(
        hf, cm, MPPIConfig(num_samples=16, horizon=8, slope_critic=slope_critic),
        ns=(2, 16), record=record)
    assert _positive(per_loop) and _positive(rate)
    assert rate == pytest.approx(16 * 8 / per_loop)
    assert len(record["samples_s"]) == bt.REPEATS and record["capture_ms"] is None
    assert per_loop == float(np.median(record["samples_s"]))


def test_bench_vec_env_runs_on_cpu(tiny_world):
    hf, _ = tiny_world
    per_step, rate = bt.bench_vec_env(hf, num_rovers=32, ns=(10, 60))
    assert _positive(per_step) and rate == pytest.approx(32 / per_step)


def test_bench_goal_seek_and_closed_loop_run_on_cpu(tiny_world):
    hf, cm = tiny_world
    cfg = MPPIConfig(num_samples=16, horizon=8)
    per_loop, loops = bt.bench_goal_seek(hf, cm, cfg, max_loops=12)
    assert _positive(per_loop) and 0 < loops <= 12
    per_step, rate = bt.bench_closed_loop(hf, cm, cfg, ns=(2, 8))
    assert _positive(per_step) and rate == pytest.approx(1.0 / per_step)


def test_bench_largescale_reports_its_keys_on_cpu(monkeypatch):
    """bench_largescale at the tests' tiny terrain on the CPU (the pipelined
    loop as tests/test_torch_largescale_paths.py runs it, 6-step chunks, one
    block shift): the line's keys, the goal reached in both runs, the median
    run reported."""
    record = {}
    conf = tiny_conf(pipeline_depth=2)
    monkeypatch.setattr(bt, "bench_largescale_conf", lambda traverse_m: conf)
    monkeypatch.setattr(bt, "REPEATS", 2)
    out = bt.bench_largescale(device="cpu", record=record)
    assert set(out) == bt.LARGESCALE_KEYS
    assert out["reached"] and all(r["reached"] for r in record["runs"])
    assert out["block_shifts"] >= 1 and out["chunk_steps"] == conf.terrain_check_every
    assert out["peak_device_memory_gb"] is None  # no card
    assert out["sim_steps_per_s"] in [r["sim_steps_per_s"] for r in record["runs"]]
    assert _positive(out["device_sim_steps_per_s"]) and _positive(out["build_s"])
    assert "worker_wait_s" in out["host_phase_totals_s"]


def test_bench_refuses_to_run_without_a_card(monkeypatch):
    """No card, no run: the world build raises as the CLI does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bt.build_world()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bt.measure()
