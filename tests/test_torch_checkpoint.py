"""PyTorch port: checkpoint files (``aux/checkpoint.py``) and the streamed
loop's traverse checkpoints, against the JAX package's files.

Leaves are stored under the same tree-path keys in both packages, so every
shared leaf comes back EQUAL in either direction (the arrays are written and
read as they are). The port's traverse file holds the JAX package's leaves
and no more: the control noise of a chunk follows from the seed and the
chunk index, in both packages.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch import convert
from husky_rover_mppi_isaacsim_torch.aux import checkpoint as tckpt
from husky_rover_mppi_isaacsim_torch.env import largescale_loop as tls
from husky_rover_mppi_isaacsim_tpu.aux import checkpoint as jckpt
from husky_rover_mppi_isaacsim_tpu.env import largescale_loop as jls

from test_torch_largescale import loop_confs

torch.set_num_threads(1)


def _tree(rng):
    from husky_rover_mppi_isaacsim_torch.mppi.critics import Costmap

    return {
        "costmap": Costmap(torch.from_numpy(rng.random((6, 6)).astype(np.float32)),
                           torch.tensor(3.0), torch.tensor(1.0)),
        "craters": {"0|1": {"c": rng.random((3, 2)), "r": rng.random(3)},
                    "-1|0": {"c": np.zeros((0, 2)), "r": np.zeros(0)}},
        "path": [rng.random((4, 2)), (np.int32(7), 2.5)],
        "steps": 12,
        "generator": torch.Generator().manual_seed(5).get_state(),
        "none": None,
    }


def test_round_trip_in_the_port(tmp_path, rng):
    tree = _tree(rng)
    tckpt.save(tmp_path / "t.ckpt", tree, {"a": [1, 2], "s": "x"})
    assert (tmp_path / "t.ckpt.npz").is_file()  # the path is normalised as in JAX
    assert tckpt.load_metadata(tmp_path / "t.ckpt") == {"a": [1, 2], "s": "x"}
    keys = [k for k, _ in tckpt.flatten(tree)]
    assert set(tckpt.leaf_shapes(tmp_path / "t.ckpt")) == set(keys)
    assert "craters/0|1/c" in keys and "costmap/half_width" in keys and "path/1/0" in keys
    back, meta = tckpt.restore(tmp_path / "t.ckpt", tree)
    assert meta["s"] == "x" and back["none"] is None and back["steps"] == 12
    assert isinstance(back["costmap"], type(tree["costmap"]))
    for (k, a), (_, b) in zip(tckpt.flatten(back), tckpt.flatten(tree)):
        assert type(a) is type(b) or isinstance(b, np.generic), k
        np.testing.assert_array_equal(tckpt._as_array(a), tckpt._as_array(b), err_msg=k)
    with pytest.raises(KeyError, match="missing leaf"):
        tckpt.restore(tmp_path / "t.ckpt", {**tree, "extra": np.zeros(2)})
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore(tmp_path / "t.ckpt", {**tree, "steps": np.zeros(3)})


def test_leaf_keys_and_files_cross_packages(tmp_path, rng):
    """The same tree written by either package: the same keys, and each
    package restores the other's file with every leaf equal."""
    tree = _tree(rng)
    del tree["none"]
    jtree = jax.tree.map(lambda a: np.asarray(a), {
        k: (v if not isinstance(v, torch.Tensor) else v.numpy()) for k, v in tree.items()
        if k != "costmap"})
    jtree["costmap"] = {"cost": tree["costmap"].cost.numpy(), "half_width": np.float32(3.0),
                        "resolution": np.float32(1.0)}
    want_keys = sorted(jckpt._path_key(p) for p, _ in
                       jax.tree_util.tree_flatten_with_path(jtree)[0])
    assert sorted(k for k, _ in tckpt.flatten(tree)) == want_keys
    tckpt.save(tmp_path / "port", tree)
    jckpt.save(tmp_path / "jax", jtree)
    from_port, _ = jckpt.restore(tmp_path / "port", jtree)
    from_jax, _ = tckpt.restore(tmp_path / "jax", tree)
    for (k, a), (_, b) in zip(tckpt.flatten(from_jax), tckpt.flatten(tree)):
        np.testing.assert_array_equal(tckpt._as_array(a), tckpt._as_array(b), err_msg=k)
    for p, leaf in jax.tree_util.tree_flatten_with_path(from_port)[0]:
        key = jckpt._path_key(p)
        np.testing.assert_array_equal(np.asarray(leaf), dict(tckpt.flatten(jtree))[key])


def _loops(tmp_path, **kw):
    jconf, tconf = loop_confs(False)
    jconf = dataclasses.replace(jconf, **kw)
    tconf = dataclasses.replace(tconf, **kw)
    return jls.LargeScaleClosedLoop(jconf), tls.LargeScaleClosedLoop(tconf, device="cpu")


def _shifted_jax_traverse(jloop):
    """A JAX loop state after one forced +x shift (the cascade by hand)."""
    state, goal = jloop._initial_state(), jloop._goal_ctrl()
    assert jloop.lstm.update_visual_mesh((12.0, 1.0))[0]
    state, goal, _ = jloop._on_block_shift(state, goal, update_pos=(12.0, 1.0))
    return state


def test_jax_traverse_file_loads_into_the_port(tmp_path):
    """A traverse checkpoint the JAX package wrote after a shift, through
    ``convert.largescale_checkpoint_from_jax``: loop state, costmap,
    crater metadata, path and cursors equal to what the JAX loop held."""
    jloop, tloop = _loops(tmp_path)
    jstate = _shifted_jax_traverse(jloop)
    path_world = np.array([[9.7, 1.0], [10.1, 1.0]])
    jloop.save_checkpoint(tmp_path / "j.ckpt", jstate, 7, 42, path_world)
    got = convert.largescale_checkpoint_from_jax(tloop, tmp_path / "j.ckpt")
    assert "generator" not in tckpt.leaf_shapes(tmp_path / "j.ckpt")
    want = convert.loop_state_from_jax(jstate)
    for (k, a), (_, b) in zip(tckpt.flatten(got["state"]), tckpt.flatten(want)):
        np.testing.assert_array_equal(tckpt._as_array(a), tckpt._as_array(b), err_msg=k)
    assert got["state"].step_index == int(jstate.step_index)
    for a, b in zip(got["costmap"], jloop.costmap):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    js = jloop.lstm.map_manager.streamer
    assert got["crater_blocks"].keys() == js.crater_blocks.keys()
    np.testing.assert_array_equal(got["path"], path_world)
    meta = got["meta"]
    assert (meta["chunk_idx"], meta["steps"], tuple(meta["anchor"])) == (7, 42, js.anchor)
    assert meta["rng_state"] == js.rng.bit_generator.state


def test_port_traverse_file_restores_in_jax(tmp_path):
    """A traverse checkpoint the port wrote, read by the JAX package's own
    ``resume``: its loop state, costmap, frame and crater generator equal
    the port's."""
    jloop, tloop = _loops(tmp_path)
    tstate, tgoal = tloop._initial_state(), tloop._goal_ctrl()
    assert tloop.lstm.update_visual_mesh((12.0, 1.0))[0]
    tstate, _, _ = tloop._on_block_shift(tstate, tgoal, update_pos=(12.0, 1.0))
    tloop.save_checkpoint(tmp_path / "t.ckpt", tstate, 7, 42, [[9.7, 1.0]])
    assert "generator" not in tckpt.leaf_shapes(tmp_path / "t.ckpt")
    jconf = loop_confs(False)[0]
    jback, info = jls.LargeScaleClosedLoop.resume(jconf, str(tmp_path / "t.ckpt"))
    for (k, a), (_, b) in zip(tckpt.flatten(tstate), tckpt.flatten(info["state"])):
        np.testing.assert_array_equal(tckpt._as_array(a), np.asarray(b), err_msg=k)
    for a, b in zip(tloop.costmap, jback.costmap):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    ts, js = tloop.lstm.map_manager.streamer, jback.lstm.map_manager.streamer
    assert js.anchor == ts.anchor and (jback.block_x, jback.block_y) == (10.0, 0.0)
    assert js.rng.bit_generator.state == ts.rng.bit_generator.state
    assert (info["chunk_idx"], info["steps"]) == (7, 42)
    # and the port resumes its own file from what JAX's file holds
    tback, tinfo = tls.LargeScaleClosedLoop.resume(loop_confs(False)[1], tmp_path / "t.ckpt",
                                                   device="cpu")
    assert set(tinfo) == {"state", "chunk_idx", "steps", "path"}
    assert tback.lstm.map_manager.streamer.anchor == ts.anchor
    assert torch.equal(tback.hf.z, ts.window)
