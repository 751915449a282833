"""PyTorch port: checkpoint / resume and wheel-track deformation of the
streamed loop, on the CPU at the JAX tests' tiny terrain (10 m blocks at
0.1 m/px, a 5-block window), held against the port's own uninterrupted run:
a resumed synchronous traverse is bit-identical to it.
"""

import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch.aux import checkpoint as tckpt
from husky_rover_mppi_isaacsim_torch.env import largescale_loop as tls
from husky_rover_mppi_isaacsim_torch.physics.deformation import DeformationEngineConf

from test_torch_largescale_paths import conf

torch.set_num_threads(1)

CUT = 132  # sim steps: after the traverse's block shift (at ~115), before its end (~210)


def deform_conf() -> DeformationEngineConf:
    return DeformationEngineConf(terrain_resolution=0.1)


@pytest.mark.parametrize("deform", [False, True], ids=["window_recomposed", "deformed"])
def test_synchronous_resume_is_bit_identical(tmp_path, deform):
    """Interrupt a traverse after its block shift and resume it: the
    continuation is bit-identical to the uninterrupted run (path, step
    count, final state; with deformation also the window and the pass
    counts), from the JAX package's checkpoint leaves alone: the control
    noise of a chunk follows from the seed and the chunk index
    (tests/test_largescale_loop.py:302, :330)."""
    kw = dict(deform=deform_conf()) if deform else {}
    full = tls.LargeScaleClosedLoop(conf(**kw), device="cpu")
    res_full = full.run()
    assert res_full.block_shifts == 1 and res_full.steps > CUT
    ck = tmp_path / "ck.ckpt"
    part = tls.LargeScaleClosedLoop(conf(max_steps=CUT, checkpoint_path=str(ck),
                                         checkpoint_every_steps=CUT, **kw), device="cpu")
    res_part = part.run()
    assert res_part.block_shifts == 1, "the checkpoint must come after the shift"
    assert set(tckpt.leaf_shapes(ck)) >= {"state/rovers/position", "costmap/cost"}
    assert "generator" not in tckpt.leaf_shapes(ck)
    assert ("window" in tckpt.leaf_shapes(ck)) == deform
    loop, info = tls.LargeScaleClosedLoop.resume(conf(**kw), ck, device="cpu")
    assert info["steps"] == CUT and len(info["path"]) == CUT // 6
    res = loop.run(_resume=info)
    assert (res.reached, res.steps) == (res_full.reached, res_full.steps)
    np.testing.assert_array_equal(res.path_world, res_full.path_world)
    assert res.final_position == res_full.final_position
    for (k, a), (_, b) in zip(tckpt.flatten(loop.last_state), tckpt.flatten(full.last_state)):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), k
    assert torch.equal(loop.lstm.map_manager.streamer.window,
                       full.lstm.map_manager.streamer.window)
    if deform:
        assert torch.equal(loop.pass_counts, full.pass_counts)


def test_deformed_traverse_lowers_the_terrain_under_the_track():
    """tests/test_largescale_loop.py:185 in the port: the rover's pass
    lowers the window, most of it stays as it was, and the controller's
    heightfield is the deformed window; the pass counts roll with the
    window at the shift."""
    loop = tls.LargeScaleClosedLoop(conf(deform=deform_conf(), pipeline_depth=4), device="cpu")
    streamer = loop.lstm.map_manager.streamer
    before = streamer.window.clone()
    anchor0 = streamer.anchor
    res = loop.run()
    assert res.reached and res.block_shifts == 1  # deformation runs the synchronous loop
    # compare in world terms: the shift moved the window one block along x
    bpx = streamer.conf.block_px
    di = streamer.anchor[0] - anchor0[0]
    assert (di, streamer.anchor[1] - anchor0[1]) == (1, 0)
    diff = streamer.window[:-bpx] - before[bpx:]
    assert float(diff.min()) < -1e-4, "no visible deformation"
    assert float((diff.abs() < 1e-9).double().mean()) > 0.9
    assert loop.hf.z is streamer.window
    stamped = loop.pass_counts > 0
    assert bool(stamped.any()) and not bool(stamped[-bpx:].any())  # the entering band is 0
    assert bool((diff[stamped[:-bpx]] != 0).any())
