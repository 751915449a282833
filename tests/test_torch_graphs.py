"""PyTorch port: the CUDA-graph helper (``core/graphs.py``) on the CPU, and
what graphing the hot loops changed in the eager code, against the JAX
package: the closed-loop latch keyed on a device step counter (seven steps,
every latch phase, noise and wheel slip drawn from the step's key), a streamed chunk
started at a step index that is not a multiple of 3 (as after a resume),
and the step index through a checkpoint.

On CPU tensors a :class:`Graphed` function is the eager function, so these
tests run the code the graphs are held against on the card
(``tests/test_torch_gpu.py``). Tolerances: the closed-loop steps those of
``tests/test_torch_closed_loop.py`` (float64, 1e-9 over 7 chained steps),
the chunk that of ``tests/test_torch_largescale.py`` (float32, 2e-3 after
one chunk).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch import convert
from husky_rover_mppi_isaacsim_torch import env as tenv
from husky_rover_mppi_isaacsim_torch.core import jax_random as jr
from husky_rover_mppi_isaacsim_torch.core.graphs import Graphed
from husky_rover_mppi_isaacsim_torch.env import largescale_loop as tls
from husky_rover_mppi_isaacsim_torch.mppi import controller as tc
from husky_rover_mppi_isaacsim_tpu import env as jenv
from husky_rover_mppi_isaacsim_tpu.env import largescale_loop as jls
from husky_rover_mppi_isaacsim_tpu.mppi import controller as jc
from test_torch_closed_loop import _compare_loop_states, _tkey, _world
from test_torch_largescale import (
    SEED,
    _assert_state_close,
    loop_confs,
)

torch.set_num_threads(1)


def _goal_seek_inputs(k=16, h=10):
    (_, _), (thf, tcm) = _world()
    cfg = tc.MPPIConfig(num_samples=k, horizon=h)
    robot = tc.RobotState.create(-8.0, -6.0, [1.0, 0.3, 0.0], dtype=torch.float64)
    ctrl = tc.ControllerState.create(cfg, torch.float64)
    goal = torch.tensor([6.0, 5.0], dtype=torch.float64)
    return cfg, thf, tcm, goal, robot, ctrl


def test_graphed_on_cpu_returns_what_the_eager_function_returns():
    """A goal-seek through a :class:`Graphed` ``masked_steps`` equals the
    same goal-seek through ``masked_steps`` itself, trace and state, and
    the helper runs nothing on the card (no replay, no capture)."""
    cfg, hf, cm, goal, robot, ctrl = _goal_seek_inputs()
    graph = Graphed(tc.masked_steps)
    runs = []
    for steps_fn in (graph, tc.masked_steps):
        runs.append(tc.goal_seek_recorded(cfg, hf, cm, goal, robot, ctrl, jr.key(11), max_loops=9,
                                          steps_fn=steps_fn))
    got, want = runs
    assert got.steps == want.steps == 12 and int(got.loops) == 9
    for a, b in zip(got.robot + got.ctrl + got[2:4] + got[5:],
                    want.robot + want.ctrl + want[2:4] + want[5:]):
        assert torch.equal(a, b)
    assert graph.replays == 0 and graph.capture_ms is None
    # a second episode through the same helper: the same signature
    again = tc.goal_seek_recorded(cfg, hf, cm, goal, robot, ctrl, jr.key(11),
                                  max_loops=9, steps_fn=graph)
    assert torch.equal(again.positions, got.positions)


def test_graphed_raises_on_a_call_it_was_not_built_for():
    """Another shape, dtype, constant or tree structure than the first
    call's raises ``ValueError``, on the CPU as on the card."""
    cfg, hf, cm, goal, robot, ctrl = _goal_seek_inputs()
    step = Graphed(tc.mppi_step)
    noise = torch.randn((2, cfg.num_samples, cfg.horizon), dtype=torch.float64)
    want = tc.mppi_step(cfg, hf, cm, goal, robot, ctrl, noise)
    got = step(cfg, hf, cm, goal, robot, ctrl, noise)
    for a, b in zip(got[0] + got[1][:-1], want[0] + want[1][:-1]):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="built for"):  # another sample count
        step(cfg, hf, cm, goal, robot, ctrl, noise[:, :8])
    with pytest.raises(ValueError, match="built for"):  # another dtype
        step(cfg, hf, cm, goal, robot, ctrl, noise.float())
    with pytest.raises(ValueError, match="built for"):  # another constant
        step(tc.MPPIConfig(num_samples=cfg.num_samples, horizon=cfg.horizon, temperature=0.5),
             hf, cm, goal, robot, ctrl, noise)
    with pytest.raises(ValueError, match="built for"):  # another structure
        step(cfg, hf, cm, goal, robot, ctrl, (noise,))
    # the signature it was built for still runs
    step(cfg, hf, cm, goal, robot, ctrl, noise)


def test_device_latch_matches_jax_over_seven_steps_with_slip():
    """The latch is a ``torch.where`` on a 0-d int32 step counter, as JAX's
    ``jnp.where`` on its device int32: seven chained steps of N=2 rovers hit
    every latch phase (latches at 0, 3 and 6) and match JAX's jitted step,
    a :class:`Graphed` step (the card's route) drawing the noise and the
    wheel slip from the same step key as JAX's."""
    n = 2
    (jhf, jcm), (thf, tcm) = _world()
    jcfg = jenv.ClosedLoopConfig(mppi=jc.MPPIConfig(num_samples=16, horizon=12),
                                 rover=jenv.RoverParams(wheel_tau=0.03, slip_std=0.05))
    tcfg = convert.closed_loop_config_from_jax(jcfg)
    assert tcfg.rover.slip_std == 0.05
    starts = np.array([[-8.0, -6.0], [6.0, -8.0]])
    goals = -0.6 * starts
    js = jenv.init_loop_state(jcfg, jenv.RoverState.create(starts, [1.0, 0.0, 0.0], jhf),
                              jnp.float64)
    ts = tenv.init_loop_state(tcfg, tenv.RoverState.create(starts, [1.0, 0.0, 0.0], thf),
                              torch.float64)
    assert ts.step_index.dtype == torch.int32 and ts.step_index.shape == ()
    jstep = jax.jit(lambda s, k: jenv.closed_loop_step(jcfg, jhf, jcm, jnp.asarray(goals), s, k))
    step = Graphed(tenv.closed_loop_step)
    key = jax.random.key(2)
    latched = []
    for i in range(7):
        key, sub = jax.random.split(key)
        js = jstep(js, sub)
        ts = step(tcfg, thf, tcm, torch.from_numpy(goals), ts, _tkey(sub))
        _compare_loop_states(ts, js, f"step {i}")
        latched.append(ts.latched_left.clone())
        assert ts.step_index.dtype == torch.int32 and int(ts.step_index) == i + 1
    for a, b in ((0, 1), (1, 2), (3, 4), (4, 5)):
        assert torch.equal(latched[a], latched[b])
    assert not torch.equal(latched[2], latched[3]) and not torch.equal(latched[5], latched[6])
    # one step from one key, eager and through a new Graphed step: the same
    # state; with no slip (slip_std 0) the same key gives another state
    key5 = jr.key(5)
    drawn = tenv.closed_loop_step(tcfg, thf, tcm, torch.from_numpy(goals), ts, key5)
    graphed = Graphed(tenv.closed_loop_step)(tcfg, thf, tcm, torch.from_numpy(goals), ts, key5)
    for a, b in zip(tenv.clone_state(drawn), graphed):
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)
    no_slip = dataclasses.replace(tcfg, rover=tcfg.rover._replace(slip_std=0.0))
    unslipped = tenv.closed_loop_step(no_slip, thf, tcm, torch.from_numpy(goals), ts, key5)
    assert not torch.equal(unslipped.rovers.wheel_left, graphed.rovers.wheel_left)


@pytest.mark.parametrize("start_index", [4, 5])
def test_chunk_from_a_step_index_off_the_latch_matches_jax(start_index):
    """A chunk (6 steps) that starts at a step index that is not a multiple
    of 3, as after a resume: the latches fall inside the chunk at other
    steps, and the port's chunk, through its :class:`Graphed` chunk, agrees
    with JAX's chunk program from the same state and noise."""
    jconf, tconf = loop_confs(False)
    jloop = jls.LargeScaleClosedLoop(jconf)
    tloop = tls.LargeScaleClosedLoop(tconf, device="cpu")
    assert isinstance(tloop.chunk_fn, Graphed)
    jstate = jloop._initial_state()._replace(step_index=jnp.asarray(start_index, jnp.int32))
    ox, oy = (np.float32(v + jloop.half_block) for v in (jloop.block_x, jloop.block_y))
    jstate, *jpose = jloop._chunk_fn(jloop.lstm.map_manager.streamer.window, jloop.costmap,
                                     jloop._goal_ctrl(), jstate, jax.random.key(SEED),
                                     np.int32(0), ox, oy)
    tstate = convert.loop_state_from_jax(jloop._initial_state()._replace(
        step_index=jnp.asarray(start_index, jnp.int32)))
    tstate, tpose = tloop.chunk(tstate, tloop._goal_ctrl(), jr.key(SEED), 0)
    np.testing.assert_allclose(tpose.numpy()[:4], np.asarray(jpose[:4], np.float32), atol=2e-3,
                               rtol=0)
    _assert_state_close(tstate, jstate, 2e-3)
    assert int(tstate.step_index) == int(jstate.step_index) == start_index + 6


def test_step_index_survives_a_checkpoint_round_trip(tmp_path):
    """The device step counter goes to the checkpoint as the JAX package's
    int32 leaf and comes back on the loop's device as a 0-d int32 tensor,
    through ``resume`` and through the JAX-file converter."""
    _, tconf = loop_confs(False)
    loop = tls.LargeScaleClosedLoop(tconf, device="cpu")
    state = loop._initial_state()._replace(step_index=torch.tensor(7, dtype=torch.int32))
    path = tmp_path / "traverse.ckpt"
    loop.save_checkpoint(path, state, chunk_idx=3, steps=18, path_world=[(0.0, 0.0)])
    payload, meta = loop.load_checkpoint(path)
    assert payload["state"].step_index.dtype == torch.int32
    assert int(payload["state"].step_index) == 7 and meta["steps"] == 18
    resumed, info = tls.LargeScaleClosedLoop.resume(tconf, path, device="cpu",
                                                    lstm=loop.lstm)
    got = info["state"].step_index
    assert isinstance(got, torch.Tensor) and got.dtype == torch.int32 and int(got) == 7
    assert convert.largescale_checkpoint_from_jax(resumed, path)["state"].step_index == 7
    # the resumed state steps on from that phase
    nxt, _ = resumed.chunk(info["state"], resumed._goal_ctrl(), jr.key(SEED), 1)
    assert int(nxt.step_index) == 7 + tconf.terrain_check_every


def test_run_episode_state_is_cloned_out_of_the_step():
    """``run_episode`` returns a state of its own: the step function's
    outputs, which a graph overwrites at its next replay, are cloned."""
    (_, _), (thf, tcm) = _world()
    cfg = tenv.ClosedLoopConfig(mppi=tc.MPPIConfig(num_samples=8, horizon=6))
    state = tenv.init_loop_state(cfg, tenv.RoverState.create(np.zeros((2, 2)), [1.0, 0.0, 0.0],
                                                            thf), torch.float64)
    seen = []

    def step(*args):
        seen.append(tenv.closed_loop_step(*args))
        return seen[-1]

    final, path = tenv.run_episode(cfg, thf, tcm, torch.ones((2, 2), dtype=torch.float64), state,
                                   jr.key(3), 3, step_fn=step)
    assert final.rovers.position is not seen[-1].rovers.position
    assert torch.equal(final.rovers.position, seen[-1].rovers.position)
    assert torch.equal(path[-1], final.rovers.position) and int(final.step_index) == 3


def test_pipelined_dispatch_waits_for_a_slow_terrain_worker(monkeypatch):
    """With a terrain worker slower than the chunks (each pose's cascade
    held up 50 ms, as a graphed chunk on the card outruns the cascade), the
    pipelined loop dispatches a chunk only once the worker has taken up the
    pose ``2 * pipeline_depth`` chunks back or has nothing left to do, and
    still runs its steps with the block shift."""
    import dataclasses
    import time

    _, tconf = loop_confs(False)
    conf = dataclasses.replace(tconf, pipeline_depth=2, prestage_shifts=True)
    loop = tls.LargeScaleClosedLoop(conf, device="cpu")
    process, wait_for = tls._TerrainWorker._process, tls._TerrainWorker.wait_for
    seen = []

    def slow(self, pose):
        time.sleep(0.05)
        process(self, pose)

    def checked(self, chunk):
        wait_for(self, chunk)
        with self._cond:
            seen.append((chunk, self._started, self._pending is not None or self._busy))

    monkeypatch.setattr(tls._TerrainWorker, "_process", slow)
    monkeypatch.setattr(tls._TerrainWorker, "wait_for", checked)
    res = loop.run()
    assert len(seen) == res.steps // conf.terrain_check_every
    assert all(started >= chunk or not working for chunk, started, working in seen)
    assert any(started >= 0 for _, started, _ in seen)  # the worker kept pace
    assert loop.chunk_phase_acc["worker_wait_s"] > 0.0
    assert res.block_shifts == 1 and np.isfinite(res.path_world).all()


def test_graphed_in_place_argument_is_read_where_it_lies():
    """An in-place argument reaches the function as the caller's tensor
    itself (never a copy), so a write into it between calls is what the
    next call reads; a call with another tensor there, even an equal one,
    raises ``ValueError``, while the other arguments may be new tensors."""
    seen = []

    def fn(window, scale):
        seen.append(window)
        return window.sum() * scale

    window = torch.arange(12.0).reshape(3, 4)
    step = Graphed(fn, in_place_args=(0,))
    assert float(step(window, torch.tensor(1.0))) == 66.0
    window.add_(1.0)  # a re-seat: the caller writes in place
    assert float(step(window, torch.tensor(2.0))) == 2 * 78.0
    assert all(w is window for w in seen)
    with pytest.raises(ValueError, match="in-place"):
        step(window.clone(), torch.tensor(1.0))
    # an argument that is not in place may be any tensor of the signature
    copying = Graphed(fn)
    copying(window, torch.tensor(1.0))
    assert float(copying(window.clone(), torch.tensor(1.0))) == 78.0


@pytest.mark.parametrize("depth", [0, 2], ids=["sync", "pipelined"])
def test_chunk_reads_the_seated_window_and_costmap_in_place(depth):
    """Every chunk of a traverse across a block shift gets the loop's one
    window leaf and one costmap leaf (the graph's in-place arguments),
    holding exactly the live window and costmap of that chunk; the
    synchronous loop hands the leaf back to the streamer, so that after the
    shift the streamer's window is the leaf (one window lives)."""
    import dataclasses

    _, tconf = loop_confs(False)
    conf = dataclasses.replace(tconf, pipeline_depth=depth, prestage_shifts=True)
    loop = tls.LargeScaleClosedLoop(conf, device="cpu")
    leaves = (loop._leaf_hf, loop._leaf_cm)
    checked = []

    def chunk_fn(conf_, hf, costmap, *rest):
        checked.append(hf is leaves[0] and costmap is leaves[1]
                       and torch.equal(hf.z, loop.hf.z)
                       and all(torch.equal(a, b) for a, b in zip(costmap, loop.costmap)))
        return tls.run_chunk(conf_, hf, costmap, *rest)

    loop.chunk_fn = chunk_fn
    res = loop.run()
    assert res.block_shifts >= 1 and checked and all(checked)
    streamer = loop.lstm.map_manager.streamer
    if depth == 0:
        assert streamer.window is loop._leaf_hf.z
    else:
        assert torch.equal(streamer.window, loop._leaf_hf.z)
    # the leaf-reading graph is the loop's default chunk function
    assert tls.LargeScaleClosedLoop(conf, lstm=loop.lstm, device="cpu").chunk_fn.in_place_args \
        == {1, 2}


def test_pipelined_loop_counts_its_blocking_waits(monkeypatch):
    """``worker_blocking_waits`` counts the dispatches that waited for the
    terrain worker: none is counted by a worker that never holds the loop
    up (its waits return at once), every one by a worker that always does."""
    import dataclasses

    _, tconf = loop_confs(False)
    conf = dataclasses.replace(tconf, pipeline_depth=2, prestage_shifts=True)
    counts = {}
    for blocks in (False, True):
        loop = tls.LargeScaleClosedLoop(conf, device="cpu")
        monkeypatch.setattr(tls._TerrainWorker, "wait_for", lambda self, chunk: blocks)
        loop.run()
        counts[blocks] = (loop.worker_blocking_waits,
                          loop.dispatched_steps // conf.terrain_check_every)
    assert counts[False][0] == 0
    assert counts[True][0] == counts[True][1] > 0
