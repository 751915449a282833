"""PyTorch port: shift pre-staging and the pipelined loop with its terrain
worker (the streamed loop's paths beyond the plain synchronous one), on the CPU
at the JAX tests' tiny terrain (10 m blocks at 0.1 m/px, a 5-block window),
and the shift predictor against the JAX package's.

The port is held against itself where the JAX package's noise cannot be
replayed (a free-running traverse): pre-staging changes no path, and every
costmap a loop seats is equal to the synchronous build for its block and
rocks. The predictor is held EQUAL to the JAX package's on one replayed
path: shift decisions, anchors, predicted keys.
"""

import dataclasses
import math
import threading

import numpy as np
import torch

from husky_rover_mppi_isaacsim_torch.aux import checkpoint as tckpt
from husky_rover_mppi_isaacsim_torch.env import largescale_loop as tls
from husky_rover_mppi_isaacsim_torch.env.closed_loop import ClosedLoopConfig
from husky_rover_mppi_isaacsim_torch.mppi.controller import MPPIConfig
from husky_rover_mppi_isaacsim_torch.terrain.orchestrator import LargeScaleConf
from husky_rover_mppi_isaacsim_torch.terrain.rocks import RockDistConf
from husky_rover_mppi_isaacsim_tpu.env import largescale_loop as jls

from test_torch_largescale import loop_confs, tiny_terrain

torch.set_num_threads(1)

# a start 1.5 m before the x = 10 m border and a 2 m lookahead: the loop
# stages the crossing a few chunks before it; the goal lies 4 m on
# (measured: reached in 210 sim steps, one block shift)
START, GOAL, MAX_STEPS = (8.5, 1.0), (12.5, 1.0), 330


def conf(**kw) -> tls.LargeScaleLoopConf:
    # the port's own paths, held against its synchronous loop, on the
    # device-upsampled window (the route they ran on before the tile pool)
    base = dict(terrain=tiny_terrain(LargeScaleConf, RockDistConf, native_pool="never"),
                loop=ClosedLoopConfig(mppi=MPPIConfig(num_samples=16, horizon=10)),
                start=START, goal=GOAL, max_steps=MAX_STEPS, seed=3, terrain_check_every=6,
                prestage_lookahead_m=2.0, pipeline_depth=0)
    base.update(kw)
    return tls.LargeScaleLoopConf(**base)


def assert_seated_costmaps_equal_rebuilds(loop):
    """Every costmap the loop seated equals the synchronous build for its
    center block and the rocks around its update position."""
    assert loop.costmap_log
    for _first, cm, frame, rocks_pos in loop.costmap_log:
        want = loop.costmap_for((frame.block_x, frame.block_y), rocks_pos)
        assert torch.equal(cm.cost, want.cost)


def test_prestage_hits_verify_and_changes_no_path():
    """A synchronous traverse with pre-staging and ``verify_prestage``: the
    staged crossing hits (the staged costmap is rebuilt and compared inside
    the loop, and the staged window is swapped in), K2's builds add up,
    and the same traverse without pre-staging takes the same path and ends
    in the same state, bit for bit."""
    staged = tls.LargeScaleClosedLoop(conf(verify_prestage=True), device="cpu")
    res = staged.run()
    assert res.reached and res.block_shifts == 1
    assert (res.prestage_hits, res.prestage_misses) == (1, 0)
    streamer = staged.lstm.map_manager.streamer
    assert streamer.staged_shift_hits == streamer.staged_shift_verified == 1
    assert staged.costmap_builds == {"first": 1, "staged": 1, "miss": 0, "verify": 1}
    assert_seated_costmaps_equal_rebuilds(staged)
    plain = tls.LargeScaleClosedLoop(conf(prestage_shifts=False), device="cpu")
    ref = plain.run()
    assert (ref.prestage_hits, ref.prestage_misses) == (0, 1)
    np.testing.assert_array_equal(res.path_world, ref.path_world)
    assert res.final_position == ref.final_position and res.steps == ref.steps
    for (k, a), (_, b) in zip(tckpt.flatten(staged.last_state), tckpt.flatten(plain.last_state)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), k
    assert torch.equal(staged.hf.z, plain.hf.z)


def test_pipelined_loop_reaches_the_goal_with_rebuilt_costmaps():
    """``pipeline_depth=2``: the rover reaches the goal across the shift,
    the terrain worker staged it, and every costmap the main thread seated
    from a worker's event equals its synchronous build."""
    loop = tls.LargeScaleClosedLoop(conf(pipeline_depth=2), device="cpu")
    res = loop.run()
    assert res.reached and res.block_shifts == 1 and res.prestage_hits == 1
    assert len(loop.costmap_log) == 2 and loop.costmap_log[1][1] is loop.costmap
    assert_seated_costmaps_equal_rebuilds(loop)
    assert loop.hf.z is loop.lstm.map_manager.streamer.window
    assert res.path_world.shape == (res.steps // 6, 2)
    assert loop.worker_s["terrain_s"] > 0.0 and res.max_dispatch_gap_s > 0.0
    assert len(res.shift_dispatch_gaps_s) == 1


def test_dispatch_bound_is_counted_in_sim_steps(monkeypatch):
    """The pipelined dispatch waits on the terrain worker while it is more
    than the pipeline's own lag (``pipeline_depth + 1`` chunks) and
    ``WORKER_SLACK_STEPS`` sim steps behind: at 12-step chunks and depth 4
    the bound is the 8 chunks (96 steps) it was when it was counted in
    chunks; at 48-step chunks the slack stays one chunk, not three."""
    assert tls.dispatch_bound_chunks(4, 12) == 8
    assert tls.dispatch_bound_chunks(4, 48) == 6
    for depth in (1, 2, 4):
        for n in (6, 12, 36, 48, 100):
            slack = (tls.dispatch_bound_chunks(depth, n) - depth - 1) * n
            assert tls.WORKER_SLACK_STEPS <= slack < tls.WORKER_SLACK_STEPS + n
    # the loop hands the worker its bound: chunk i waits on chunk i - 9
    # (depth 2 and 6-step chunks: 3 chunks of lag and 36 steps of slack)
    waits = []
    wait_for = tls._TerrainWorker.wait_for
    monkeypatch.setattr(tls._TerrainWorker, "wait_for",
                        lambda self, chunk: waits.append(chunk) or wait_for(self, chunk))
    loop = tls.LargeScaleClosedLoop(conf(pipeline_depth=2, max_steps=120), device="cpu")
    loop.run(record_path=False)
    assert waits == [i - 9 for i in range(120 // 6)]


def test_pipelined_worker_error_surfaces():
    """A failure inside the terrain worker thread surfaces from ``run()``
    (tests/test_largescale_loop.py:391-409), within a bound."""
    loop = tls.LargeScaleClosedLoop(conf(pipeline_depth=2), device="cpu")

    def boom(_local):
        raise RuntimeError("cascade exploded")

    loop.lstm.update_visual_mesh = boom
    out = {}

    def drive():
        try:
            loop.run(record_path=False)
        except BaseException as e:  # noqa: BLE001 - handed to the test thread
            out["error"] = e

    t = threading.Thread(target=drive, daemon=True)
    t.start()
    t.join(timeout=120.0)
    assert not t.is_alive(), "run() hung after a worker failure"
    assert isinstance(out.get("error"), RuntimeError) and "cascade exploded" in str(out["error"])


def _replay_path() -> np.ndarray:
    """A recorded-like world path: a curve from (9.7, 1) through both block
    borders of x and y and back over one, in 0.3 m steps with a wobble."""
    t = np.arange(0.0, 60.0, 0.3)
    x = 9.7 + 0.55 * t + 0.4 * np.sin(0.7 * t)
    y = 1.0 + 0.45 * t - 0.012 * t ** 2 + 0.3 * np.cos(0.5 * t)
    return np.stack([x, y], axis=-1)


def test_shift_prediction_matches_jax():
    """One path replayed through both packages' ``_would_shift``,
    ``_predict_crossing`` and ``update_visual_mesh`` at a reduced
    ``StreamerConf``: at every update the shift decision, the predicted
    crossing (key, anchor, lookahead point) and the streamer's anchor are
    EQUAL, and the decision is what the update then does."""
    jconf, tconf = loop_confs(False)
    jconf = dataclasses.replace(jconf, prestage_lookahead_m=3.0)
    tconf = dataclasses.replace(tconf, prestage_lookahead_m=3.0)
    jloop = jls.LargeScaleClosedLoop(jconf)
    tloop = tls.LargeScaleClosedLoop(tconf, device="cpu")
    path = _replay_path()
    sp = tconf.terrain.starting_position
    shifts = predicted = 0
    for k in range(1, len(path)):
        wx, wy = (float(v) for v in path[k])
        hx, hy = (float(v) for v in path[k] - path[k - 1])
        norm = math.hypot(hx, hy)
        hx, hy = hx / norm, hy / norm
        local = (wx - sp[0], wy - sp[1])
        will = tloop._would_shift(local)
        assert will == jloop._would_shift(local), k
        tp, jp = tloop._predict_crossing(wx, wy, hx, hy), jloop._predict_crossing(wx, wy, hx, hy)
        assert tp == jp, k
        predicted += tp is not None
        anchor = tloop.lstm.map_manager.streamer.anchor
        tout = tloop.lstm.update_visual_mesh(local)
        assert tout == jloop.lstm.update_visual_mesh(local), k
        now = tloop.lstm.map_manager.streamer.anchor
        assert now == jloop.lstm.map_manager.streamer.anchor, k
        assert will == (now != anchor), k
        shifts += now != anchor
    assert shifts >= 3 and predicted > 10
