"""PyTorch port: the streamed-terrain full-stack loop (``mode=largescale``,
synchronous path) against the JAX package, on the CPU with the kernels' plain
versions, at the JAX tests' tiny terrain (10 m blocks at 0.1 m/px, a
5-block window).

Both ``LargeScaleClosedLoop``s step the same chunks across one block
shift, the port drawing JAX's exploration noise from the same key and chunk
index (bit for bit: both float32) or replaying it. Everything
is float32 in both packages. Tolerances: the windows and the costmaps are
equal (the port's float32 terrain is XLA's, ``core/xla_math.py``: the
crater render, glibc's ``powf`` of the falloff); the state after one chunk
from a common state agrees to 2e-3 (measured: <= 5e-5 in m, m/s and
rad/s). That holds for these starts and this seed: where a sample's
wheel-track cell or a costmap cell flips between the packages at a cell
border, one chunk's commands jump by 5e-4 to 0.1 m/s (seen in 2 of ~100
chunks of other starts and seeds), which no tolerance of this kind covers.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch import cli, convert
from husky_rover_mppi_isaacsim_torch.aux.config import apply_overrides
from husky_rover_mppi_isaacsim_torch.core import jax_random as jr
from husky_rover_mppi_isaacsim_torch.env import frames as tframes
from husky_rover_mppi_isaacsim_torch.env import largescale_loop as tls
from husky_rover_mppi_isaacsim_torch.env.closed_loop import ClosedLoopConfig as TLoopConfig
from husky_rover_mppi_isaacsim_torch.env.closed_loop import step_noise
from husky_rover_mppi_isaacsim_torch.mppi.controller import MPPIConfig as TMPPIConfig
from husky_rover_mppi_isaacsim_torch.ops.edt_cuda import edt_minplus_cuda
from husky_rover_mppi_isaacsim_torch.ops.rollout_cuda import rollout_25d_cuda
from husky_rover_mppi_isaacsim_torch.terrain.orchestrator import LargeScaleConf as TLargeScaleConf
from husky_rover_mppi_isaacsim_torch.terrain.orchestrator import (
    LargeScaleTerrainManager as TLargeScaleTerrainManager,
)
from husky_rover_mppi_isaacsim_torch.terrain.rocks import RockDistConf as TRockDistConf
from husky_rover_mppi_isaacsim_tpu.env import largescale_loop as jls
from husky_rover_mppi_isaacsim_tpu.env.closed_loop import ClosedLoopConfig as JLoopConfig
from husky_rover_mppi_isaacsim_tpu.mppi import sampling as jsamp
from husky_rover_mppi_isaacsim_tpu.mppi.controller import MPPIConfig as JMPPIConfig
from husky_rover_mppi_isaacsim_tpu.terrain.orchestrator import LargeScaleConf as JLargeScaleConf
from husky_rover_mppi_isaacsim_tpu.terrain.rocks import RockDistConf as JRockDistConf
from test_torch_rocks import wait_for_jax_native

torch.set_num_threads(1)

K, H, CHUNK, SEED = 32, 20, 6, 3
# a 0.25 m update gate and a start 0.3 m (smooth terrain) or 0.15 m (craters,
# where the rover is slower) before the x = 10 m block border: the rover
# crosses it, and the window shifts, within ten chunks
STARTS, GOAL, MAX_STEPS = {False: (9.7, 1.0), True: (9.85, 1.0)}, (45.0, 8.0), 60
START = STARTS[False]


def tiny_terrain(conf_cls, rock_cls, native_pool="always", **kw):
    """The JAX tests' ``tiny_terrain`` (tests/test_largescale_loop.py) with a
    0.25 m update gate, its blocks upsampled on the route ``native_pool``
    names. The JAX package takes the native tile pool on the CPU ("auto")
    where its library is built, which this waits for; the port-vs-JAX tests
    pin both packages to that route ("always")."""
    defaults = dict(
        block_size=10.0, hr_dem_resolution=0.1, lr_pixel_size=2.0, hr_dem_num_blocks=1,
        hr_dem_generate_craters=False, crater_gen_padding=2.0, update_every_n_meters=0.25,
        geo_cm_num_texels_per_level=8, geo_cm_num_lods=3, terrain_collider_resolution=0.5,
        terrain_collider_build_radius=6.0,
        rock_gen_cfgs=(rock_cls(parent_density=0.005, child_density=3.0, sigma=2.0,
                                scale_min=0.3, scale_max=0.5, block_size=10.0, seed=67),),
        rock_block_span=1)
    defaults.update(kw)
    wait_for_jax_native()
    conf = conf_cls(**defaults)
    conf.streamer_conf.native_pool = native_pool
    return conf


def loop_confs(craters: bool):
    common = dict(start=STARTS[craters], goal=GOAL, max_steps=MAX_STEPS, seed=SEED,
                  terrain_check_every=CHUNK, pipeline_depth=0, prestage_shifts=False)
    jconf = jls.LargeScaleLoopConf(
        terrain=tiny_terrain(JLargeScaleConf, JRockDistConf, hr_dem_generate_craters=craters),
        loop=JLoopConfig(mppi=JMPPIConfig(num_samples=K, horizon=H)), auto_engine=False,
        **common)
    tconf = tls.LargeScaleLoopConf(
        terrain=tiny_terrain(TLargeScaleConf, TRockDistConf, hr_dem_generate_craters=craters),
        loop=TLoopConfig(mppi=TMPPIConfig(num_samples=K, horizon=H)), **common)
    return jconf, tconf


def jax_chunk_noise(chunk_idx: int) -> torch.Tensor:
    """The exploration noise the JAX chunk program draws for chunk
    ``chunk_idx`` (largescale_loop.py:346-347, closed_loop.py:126-128), as
    ``(CHUNK, 1, 2, K, H)`` float32."""
    k = jax.random.fold_in(jax.random.key(SEED), np.int32(chunk_idx))
    out = []
    for kk in jax.random.split(k, CHUNK):
        k_noise, _ = jax.random.split(kk)
        draw = jsamp.sample_noise(k_noise, K, H, np.float32)
        out.append(np.asarray(draw).reshape(2, 1, K, H).transpose(1, 0, 2, 3))
    return torch.from_numpy(np.stack(out))


def _port_chunk_noise(loop, key, chunk_idx: int) -> torch.Tensor:
    """The exploration noise the port's chunk ``chunk_idx`` draws from
    ``key`` (``split(fold_in(key, c), steps)[s]``, then ``k_noise``), as
    ``(CHUNK, 1, 2, K, H)`` float32."""
    idx = torch.tensor(chunk_idx)
    return torch.stack([
        step_noise(key, loop.conf.loop.mppi, 1,
                                   key_path=(("fold_in", idx), ("split", CHUNK, s)))
        for s in range(CHUNK)])


def _paired_loops(craters: bool, share_terrain: bool):
    """A JAX loop and a port loop on the same tiny terrain. With
    ``share_terrain`` the port's streamer continues the JAX-built one
    (window, crater metadata, crater generator state), so both drive on
    bit-equal heights until a shift builds new blocks."""
    jconf, tconf = loop_confs(craters)
    jloop = jls.LargeScaleClosedLoop(jconf)
    lstm = TLargeScaleTerrainManager(tconf.terrain, device="cpu")
    lstm.build()
    if share_terrain:
        js = jloop.lstm.map_manager.streamer
        convert.streamer_state_from_numpy(
            lstm.map_manager.streamer, np.asarray(js.lr_dem), js.anchor, js.crater_blocks,
            js.rng.bit_generator.state, np.asarray(js.window))
    return jloop, tls.LargeScaleClosedLoop(tconf, lstm=lstm, device="cpu")


def _assert_same_craters(ts, js):
    """Crater metadata (blocks, order, values) and the crater generator's
    state equal in both streamers."""
    assert list(ts.crater_blocks) == list(js.crater_blocks)
    for blk, (coords, radii) in js.crater_blocks.items():
        np.testing.assert_array_equal(ts.crater_blocks[blk][0], coords)
        np.testing.assert_array_equal(ts.crater_blocks[blk][1], radii)
    assert ts.rng.bit_generator.state == js.rng.bit_generator.state


def _assert_state_close(tstate, jstate, atol):
    for name in ("position", "z", "heading", "wheel_left", "wheel_right", "yaw_rate"):
        np.testing.assert_allclose(getattr(tstate.rovers, name).numpy(),
                                   np.asarray(getattr(jstate.rovers, name)), atol=atol, rtol=0,
                                   err_msg=name)
    for name in ("latched_left", "latched_right", "stored_left", "stored_right", "err_total"):
        np.testing.assert_allclose(getattr(tstate, name).numpy(),
                                   np.asarray(getattr(jstate, name)), atol=atol, rtol=0,
                                   err_msg=name)


@pytest.mark.parametrize("prestage", [False, True], ids=["rebuilt", "prestaged"])
@pytest.mark.parametrize("craters", [False, True], ids=["smooth", "craters"])
def test_chunks_across_a_block_shift_match_jax(craters, prestage):
    """The slice as a whole, chunk by chunk: both loops step the same chunks
    from the same state (the JAX state, converted, at each chunk's start)
    with the JAX noise, run the terrain cascade on the same pose, and cross
    one block border. After each chunk the poses and states agree to 2e-3
    (six float32 closed-loop steps); at the shift the window, the costmap, the rebased state and goal and the
    world position agree as the module docstring states. With
    ``prestage`` each package pre-stages from the same pose after every
    chunk that did not shift (the synchronous loop's order; the worker's
    inline form), so the window and costmap seated at the shift are the
    staged ones where a package's prediction named them: they agree with
    the JAX package's as a rebuild does, and the crater metadata and
    generator state stay equal."""
    jloop, tloop = _paired_loops(craters, share_terrain=True)
    jstate, jgoal = jloop._initial_state(), jloop._goal_ctrl()
    tgoal = tloop._goal_ctrl()
    key, tkey = jax.random.key(SEED), jr.key(SEED)
    jstream, tstream = jloop.lstm.map_manager.streamer, tloop.lstm.map_manager.streamer
    k1, k2 = rollout_25d_cuda.launches, edt_minplus_cuda.launches
    shifts = 0
    staged_at = []
    for idx in range(12):
        ox, oy = (np.float32(v + jloop.half_block) for v in (jloop.block_x, jloop.block_y))
        tstate = convert.loop_state_from_jax(jstate)
        jstate, *jpose = jloop._chunk_fn(jstream.window, jloop.costmap, jgoal, jstate, key,
                                         np.int32(idx), ox, oy)
        # no noise injected: the port draws chunk idx's noise from its key
        tstate, tpose = tloop.chunk(tstate, tgoal, tkey, idx)
        if idx == 0:  # the noise it draws is JAX's chunk noise, bit for bit
            assert torch.equal(_port_chunk_noise(tloop, tkey, 0), jax_chunk_noise(0))
        np.testing.assert_allclose(tpose.numpy(), np.asarray(jpose, np.float32), atol=2e-3,
                                   rtol=0, err_msg=f"pose after chunk {idx}")
        _assert_state_close(tstate, jstate, 2e-3)
        wx, wy, hx, hy = (float(v) for v in jpose[:4])
        updated = tloop.lstm.update_visual_mesh((wx, wy))
        assert updated == jloop.lstm.update_visual_mesh((wx, wy))
        moved = jloop.lstm.get_hr_map_current_block_coordinates() != (jloop.block_x,
                                                                      jloop.block_y)
        assert moved == (tloop.lstm.get_hr_map_current_block_coordinates()
                         != (tloop.block_x, tloop.block_y))
        if not moved:
            if prestage:
                jloop._prestage_inline(wx, wy, hx, hy)
                tloop._prestage_inline(wx, wy, hx, hy)
                staged_at.append(idx)
                assert (tloop._staged is None) == (jloop._staged is None)
                if craters:
                    _assert_same_craters(tstream, jstream)
            continue
        shifts += 1
        upd = jloop.lstm._to_global(updated[1]) if updated[0] else (wx, wy)
        jstate, jgoal, jshift = jloop._on_block_shift(jstate, jgoal, update_pos=upd)
        tstate, tgoal, tshift = tloop._on_block_shift(convert.loop_state_from_jax(jstate)._replace(
            rovers=tstate.rovers), tgoal, update_pos=upd)
        hits = (tloop.prestage_hits, tloop.prestage_misses, tstream.staged_shift_hits)
        jhits = (jloop.prestage_hits, jloop.prestage_misses, jstream.staged_shift_hits)
        if not prestage:
            assert hits == jhits == (0, 1, 0)
        elif not craters:  # staged from chunk 0 on, for the block and anchor it crossed into
            assert hits == jhits == (1, 0, 1) and staged_at[0] == 0
        else:
            # the rover crosses x = 10 m before the window's update gate
            # does, and its lookahead dips below y = 0: JAX's prediction
            # (the lookahead's block against the rover's) replaces the
            # staged costmap by block (10, -10)'s and misses the shift to
            # (10, 0); the port's costmap prediction (against the window's
            # center block) keeps (10, 0)'s and seats it. The window is
            # staged on JAX's prediction in both, and missed alike (its
            # blocks drew their craters in the same order in both)
            assert hits == (1, 0, 0) and jhits == (0, 1, 0)
        assert tuple(tshift) == tuple(jshift)
        assert (tloop.block_x, tloop.block_y) == (jloop.block_x, jloop.block_y)
        assert tstream.anchor == jstream.anchor and tloop.hf.z is tstream.window
        np.testing.assert_array_equal(tstream.window.numpy(), np.asarray(jstream.window))
        if craters:
            _assert_same_craters(tstream, jstream)
        np.testing.assert_array_equal(tloop.lstm.extract_rocks_data(),
                                      jloop.lstm.extract_rocks_data())
        tcost, jcost = tloop.costmap.cost.numpy(), np.asarray(jloop.costmap.cost)
        np.testing.assert_array_equal(tcost, jcost)
        np.testing.assert_array_equal(tgoal.numpy(), np.asarray(jgoal))
        np.testing.assert_allclose(tstate.rovers.position.numpy(),
                                   np.asarray(jstate.rovers.position), atol=2e-3, rtol=0)
        np.testing.assert_allclose(tloop._world_position(tstate),
                                   jloop._world_position(jstate), atol=2e-3, rtol=0)
    assert shifts == 1, "the traverse must cross one block border"
    assert (rollout_25d_cuda.launches, edt_minplus_cuda.launches) == (k1, k2)  # CPU: plain


def test_free_running_traverse_stays_near_jax():
    """Both ``run()``s, free-running from the same start and the same key,
    each on its own build of the terrain: the two builds are equal bit for
    bit. The closed loop is sensitive: a 1e-5 m change of the window moved
    the path of this 60-step traverse by up to 0.08 m, and the float32
    control step still differs in its last bits (nearest-cell wheel heights
    and K=32 softmax weights amplify it), so the paths are held to 0.5 m,
    which says they are the same traverse; the counts, the shift and the
    frames are equal."""
    jloop, tloop = _paired_loops(False, share_terrain=False)
    np.testing.assert_array_equal(tloop.hf.z.numpy(), np.asarray(jloop.hf.z))
    np.testing.assert_array_equal(tloop.costmap.cost.numpy(), np.asarray(jloop.costmap.cost))
    jres = jloop.run()
    tres = tloop.run()
    assert jres.block_shifts == 1, "the traverse must cross one block border"
    assert (tres.block_shifts, tres.costmap_rebuilds, tres.steps, tres.reached) == (
        jres.block_shifts, jres.costmap_rebuilds, jres.steps, jres.reached)
    assert (tloop.block_x, tloop.block_y) == (jloop.block_x, jloop.block_y) == (10.0, 0.0)
    assert tres.prestage_misses == 1 and len(tres.shift_latencies_s) == 1
    assert len(tloop.costmap_log) == 2 and tloop.costmap_log[1][1] is tloop.costmap
    assert tres.path_world.shape == jres.path_world.shape == (MAX_STEPS // CHUNK, 2)
    np.testing.assert_allclose(tres.path_world, jres.path_world, atol=0.5, rtol=0)
    np.testing.assert_allclose(tres.final_position, jres.final_position, atol=0.5, rtol=0)
    np.testing.assert_allclose(tloop._world_position(tloop.last_state), tres.final_position)
    np.testing.assert_array_equal(tloop.lstm.extract_rocks_data(),
                                  jloop.lstm.extract_rocks_data())


def test_goal_and_state_rebase_on_shift_match_jax():
    """``_initial_state``, ``_goal_ctrl`` and ``_on_block_shift`` against the
    JAX loop's after one forced shift (+x, the cascade called by hand):
    equal, both being float32 sums of the same values."""
    jconf, tconf = loop_confs(False)
    jloop = jls.LargeScaleClosedLoop(jconf)
    tloop = tls.LargeScaleClosedLoop(tconf, device="cpu")
    jstate, tstate = jloop._initial_state(), tloop._initial_state()
    jgoal, tgoal = jloop._goal_ctrl(), tloop._goal_ctrl()
    np.testing.assert_array_equal(tgoal.numpy(), np.asarray(jgoal))
    for a, b in zip(tstate.rovers, jstate.rovers):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tstate.rovers.position.numpy(),
                                  np.asarray(jstate.rovers.position))
    for loop in (jloop, tloop):
        assert loop.lstm.update_visual_mesh((12.0, 1.0))[0]
    jstate, jgoal, jshift = jloop._on_block_shift(jstate, jgoal)
    tstate, tgoal, tshift = tloop._on_block_shift(tstate, tgoal)
    assert tuple(tshift) == tuple(jshift) == (10.0, 0.0)
    np.testing.assert_array_equal(tgoal.numpy(), np.asarray(jgoal))
    np.testing.assert_array_equal(tstate.rovers.position.numpy(),
                                  np.asarray(jstate.rovers.position))
    assert tloop._world_position(tstate) == pytest.approx(jloop._world_position(jstate))
    assert tloop._world_position(tstate) == pytest.approx(START, abs=1e-5)
    # the controller frame of the port is the JAX BlockFrame's numbers
    assert tuple(float(v) for v in jloop.frame) == tuple(tloop.frame)
    cx, cy = tframes.world_to_controller(tloop.frame, 12.0, 1.0)
    assert (cx, cy) == (1.0 - 0.0 - 5.0, -(12.0 - 10.0 - 5.0))


def test_window_reseat_preserves_world_heights():
    """World heights at fixed world points, read through the controller's
    heightfield in the rotated frame, are the same numbers before and after
    a shift (the roll moves pixels, it does not resample them), and agree
    with the streamer's own bilinear query to within a cell's slope."""
    _, tconf = loop_confs(True)
    tloop = tls.LargeScaleClosedLoop(tconf, device="cpu")
    from husky_rover_mppi_isaacsim_torch.core import heightfield as hfield

    pts = np.random.default_rng(0).uniform([-4.0, -14.0], [24.0, 14.0], (64, 2))

    def heights():
        cx, cy = tframes.world_to_controller(tloop.frame, torch.tensor(pts[:, 0]).float(),
                                             torch.tensor(pts[:, 1]).float())
        return hfield.nearest_height(tloop.hf, cx, cy)

    before = heights()
    state, goal = tloop._initial_state(), tloop._goal_ctrl()
    assert tloop.lstm.update_visual_mesh((12.0, 1.0))[0]
    tloop._on_block_shift(state, goal)
    after = heights()
    assert torch.equal(before, after)
    world = tloop.lstm.map_manager.get_height(pts[:, 0], pts[:, 1])
    assert float((after - world).abs().max()) < 0.2


OPTIONS = {
    "pipeline_depth": dict(pipeline_depth=4),
    "prestage_shifts": dict(prestage_shifts=True, pipeline_depth=0),
    "verify_prestage": dict(verify_prestage=True, prestage_shifts=True, pipeline_depth=0),
    "deform": dict(deform="engine"),
    "checkpoint_path": dict(checkpoint_path="traverse.ckpt", checkpoint_every_steps=6),
    "checkpoint_every_steps": dict(checkpoint_every_steps=6, checkpoint_path="traverse.ckpt"),
    "native_pool": dict(native_pool="always"),
}


@pytest.mark.parametrize("option", list(OPTIONS))
def test_unported_options_raise_by_name(option, tmp_path):
    """Every option of the JAX loop's configuration constructs the loop and
    runs two chunks, the streamer's C++ tile pool route included (its blocks
    upsampled on the pool's threads)."""
    from husky_rover_mppi_isaacsim_torch.physics.deformation import DeformationEngineConf

    tconf = loop_confs(False)[1]
    kw = dict(OPTIONS[option])
    if "native_pool" in kw:
        tconf.terrain.streamer_conf.native_pool = kw.pop("native_pool")
    if kw.get("deform") == "engine":
        kw["deform"] = DeformationEngineConf(terrain_resolution=0.1)
    if "checkpoint_path" in kw:
        kw["checkpoint_path"] = str(tmp_path / kw["checkpoint_path"])
    conf = dataclasses.replace(tconf, max_steps=2 * CHUNK, **kw)
    loop = tls.LargeScaleClosedLoop(conf, device="cpu")
    res = loop.run()
    assert res.steps == 2 * CHUNK and np.isfinite(res.path_world).all()
    if "checkpoint_path" in kw:
        assert (tmp_path / "traverse.ckpt.npz").is_file()
    if option == "deform":
        assert int(loop.pass_counts.sum()) == 2 * 4 * loop.deform_engine.profile.shape[0]
    if option == "native_pool":
        pool = loop.lstm.map_manager.streamer.tile_pool()
        assert pool is not None and pool.jobs == len(loop.lstm.map_manager.streamer.block_cache)


# the streamed terrain cut to a tiny size, in the environment group's
# largescale section (a top-level `largescale.*` key loses to that section,
# as in the JAX CLI)
TINY_TERRAIN = dict(block_size=10, hr_dem_resolution=0.1, lr_pixel_size=2, hr_dem_num_blocks=1,
                    crater_gen_padding=2, update_every_n_meters=0.25,
                    geo_cm_num_texels_per_level=8, geo_cm_num_lods=3,
                    terrain_collider_resolution=0.5, terrain_collider_build_radius=6,
                    rock_block_span=1)
TINY_CLI = [
    "mode=largescale", "device=cpu",
    *(f"environment.largescale.{k}={v}" for k, v in TINY_TERRAIN.items()),
    "mppi.num_samples=16", "mppi.horizon=12",
    "start.x=9.7", "start.y=1", "goal.x=45", "goal.y=8", "max_steps=24",
]


def test_cli_largescale_on_the_cpu(capsys):
    """``cli mode=largescale device=cpu`` at the tiny size prints the JAX
    run's result keys, and says which path it ran: the JAX run's, pipelined
    with pre-staging."""
    assert cli.main(TINY_CLI) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(out) >= {"mode", "reached", "steps", "block_shifts", "costmap_rebuilds",
                        "distance_m", "final_position", "wall_s", "sim_steps_per_s",
                        "shift_latency_ms", "prestage"}
    assert out["mode"] == "largescale" and out["device"] == "cpu" and out["steps"] == 24
    assert out["pipeline_depth"] == 4 and out["prestage_shifts"] is True  # the JAX defaults
    assert out["deformation"] is False
    assert out["costmap_rebuilds"] == out["block_shifts"]
    assert np.isfinite(out["final_position"]).all()


def test_converted_jax_state_steps_like_the_port():
    """A JAX-built loop state and costmap, converted, go through the port's
    chunk like the port's own (the converters carry everything a chunk
    reads)."""
    jconf, tconf = loop_confs(False)
    jloop = jls.LargeScaleClosedLoop(jconf)
    tloop = tls.LargeScaleClosedLoop(tconf, device="cpu")
    state = convert.loop_state_from_jax(jloop._initial_state())
    key = jr.key(SEED)
    got, pose = tloop.chunk(state, tloop._goal_ctrl(), key, 0)
    want, pose_w = tloop.chunk(tloop._initial_state(), tloop._goal_ctrl(), key, 0)
    assert got.step_index == want.step_index == CHUNK
    np.testing.assert_allclose(pose.numpy(), pose_w.numpy(), atol=1e-4, rtol=0)


JAX_REPORT_KEYS = {"mode", "reached", "steps", "block_shifts", "costmap_rebuilds", "distance_m",
                   "final_position", "wall_s", "sim_steps_per_s", "shift_latency_ms", "prestage"}


def test_cli_builds_the_jax_configuration():
    """``largescale_conf`` reads the JAX ``run_largescale``'s keys as it
    does: the JAX defaults, a deformation engine at the window's resolution,
    the checkpoint keys."""
    tree = apply_overrides({}, TINY_CLI + ["deformation.enable=true", "checkpoint.path=a.ckpt",
                                           "checkpoint.every_steps=12"])
    conf = cli.largescale_conf(tree)
    jconf = jls.LargeScaleLoopConf()
    assert (conf.pipeline_depth, conf.prestage_shifts, conf.prestage_lookahead_m) == (
        jconf.pipeline_depth, jconf.prestage_shifts, jconf.prestage_lookahead_m) == (4, True, 6.0)
    default = tls.LargeScaleLoopConf()
    for f in dataclasses.fields(jls.LargeScaleLoopConf):
        if f.name in ("terrain", "loop", "deform", "auto_engine"):
            continue  # nested confs; the JAX-only engine switch
        assert getattr(default, f.name) == getattr(jconf, f.name), f.name
    assert conf.deform.terrain_resolution == 0.1 and conf.deform.enable
    assert (conf.checkpoint_path, conf.checkpoint_every_steps) == ("a.ckpt", 12)
    assert cli.largescale_conf({"deformation": {"enable": False}}).deform is None


def test_cli_deformation_checkpoint_and_resume(tmp_path, capsys):
    """``deformation.enable``, ``checkpoint.*`` and ``resume`` at the tiny
    size: a deformed traverse checkpoints every 12 steps, and a second
    process-like call resumes from the file to a longer ``max_steps``; both
    print the JAX run's keys."""
    ck = tmp_path / "traverse.ckpt"
    args = [a for a in TINY_CLI if not a.startswith("max_steps")]
    assert cli.main(args + ["max_steps=24", "deformation.enable=true", f"checkpoint.path={ck}",
                            "checkpoint.every_steps=12"]) == 0
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(first) >= JAX_REPORT_KEYS and first["deformation"] is True
    assert first["pipeline_depth"] == 4 and first["steps"] == 24  # deformation: synchronous
    assert (tmp_path / "traverse.ckpt.npz").is_file()
    assert cli.main(args + ["max_steps=36", "deformation.enable=true", f"resume={ck}"]) == 0
    second = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(second) >= JAX_REPORT_KEYS and second["steps"] == 36
    assert "resume" in second["build_s"]
