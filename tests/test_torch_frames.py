"""PyTorch port: the controller-frame transforms (``env/frames.py``) against
the JAX package, float64: every function is a few sums of the same values in
the same order, so the results are equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch import convert
from husky_rover_mppi_isaacsim_torch.env import frames as tframes
from husky_rover_mppi_isaacsim_tpu.env import frames as jframes

torch.set_num_threads(1)

FRAMES = [(0.0, 0.0, 12.5), (25.0, -50.0, 12.5), (-10.0, 30.0, 5.0)]


def _frames(bx, by, hb):
    jf = jframes.BlockFrame(jnp.asarray(bx), jnp.asarray(by), jnp.asarray(hb))
    return jf, convert.block_frame_from_jax(jf)


@pytest.mark.parametrize("bx,by,hb", FRAMES)
def test_world_controller_round_trip_equals_jax(rng, bx, by, hb):
    jf, tf = _frames(bx, by, hb)
    assert tuple(tf) == (bx, by, hb) and tf.origin() == tuple(float(v) for v in jf.origin())
    xy = rng.uniform(-80.0, 80.0, (2, 64))
    jc = jframes.world_to_controller(jf, jnp.asarray(xy[0]), jnp.asarray(xy[1]))
    tc = tframes.world_to_controller(tf, torch.from_numpy(xy[0]), torch.from_numpy(xy[1]))
    for a, b in zip(tc, jc):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jw = jframes.controller_to_world(jf, *jc)
    tw = tframes.controller_to_world(tf, *tc)
    for a, b, want in zip(tw, jw, xy):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        np.testing.assert_allclose(a.numpy(), want, atol=1e-12)
    # the rotation: world +x is controller -y, world +y is controller +x
    cx, cy = tframes.world_to_controller(tf, bx + hb + 1.0, by + hb)
    assert (cx, cy) == (0.0, -1.0)


@pytest.mark.parametrize("shift", [(25.0, 0.0), (0.0, -25.0), (25.0, 25.0)])
def test_rebase_on_shift_equals_jax(rng, shift):
    pts = rng.uniform(-40.0, 40.0, (3, 5, 2))
    got = tframes.rebase_on_shift(torch.from_numpy(pts), *shift)
    want = jframes.rebase_on_shift(jnp.asarray(pts), *(jnp.asarray(v) for v in shift))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # a world point keeps its world coordinates when frame and point rebase
    jf, tf = _frames(0.0, 0.0, 12.5)
    moved = tframes.BlockFrame(tf.block_x + shift[0], tf.block_y + shift[1], tf.half_block)
    cx, cy = tframes.world_to_controller(tf, torch.tensor(3.0), torch.tensor(-7.0))
    rebased = tframes.rebase_on_shift(torch.stack([cx, cy]), *shift)
    wx, wy = tframes.controller_to_world(moved, rebased[0], rebased[1])
    assert (float(wx), float(wy)) == (3.0, -7.0)


def test_heading_and_ema_quat_equal_jax(rng):
    h = rng.normal(size=(7, 3))
    np.testing.assert_array_equal(
        tframes.heading_world_to_controller(torch.from_numpy(h)).numpy(),
        np.asarray(jframes.heading_world_to_controller(jnp.asarray(h))))
    q1, q2 = rng.normal(size=(2, 9, 4))
    q2[::2] *= -1.0  # both hemispheres
    got = tframes.ema_quat(torch.from_numpy(q1), torch.from_numpy(q2), 0.3)
    want = jframes.ema_quat(jnp.asarray(q1), jnp.asarray(q2), jnp.asarray(0.3))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-15)
