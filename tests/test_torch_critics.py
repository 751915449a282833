"""PyTorch port: the critic stack, softmax weights and weighted update
against the JAX package (float64, rtol 1e-12)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch.convert import costmap_from_numpy
from husky_rover_mppi_isaacsim_torch.mppi import critics as tcr
from husky_rover_mppi_isaacsim_tpu.mppi import critics as jcr
from husky_rover_mppi_isaacsim_tpu.terrain import as_costmap

# small tensors: one intra-op thread each, so that the test workers running
# beside these do not lose their cores
torch.set_num_threads(1)

RTOL = 1e-12


def _world(rng, size=32, hw=10.0):
    cost = rng.uniform(0.0, 1.0, (size, size)) ** 3
    cost[rng.uniform(size=(size, size)) < 0.05] = 1.0  # collision cells
    jcm = as_costmap(cost, hw, dtype=jnp.float64)
    return jcm, costmap_from_numpy(*(np.asarray(a) for a in jcm))


def _trajectories(rng, k=24, h=20, spread=14.0):
    # reaches past the +-10 m window: negative and out-of-range cells
    steps = rng.normal(scale=0.6, size=(k, h, 3))
    steps[..., 2] *= 0.1
    start = np.zeros((k, 1, 3))
    start[..., :2] = rng.uniform(-spread, spread, (k, 1, 2))
    return np.cumsum(steps, axis=1) + start


def _np(t):
    return t.numpy()


def _s(v):
    return torch.tensor(v, dtype=torch.float64)


@pytest.mark.parametrize("goal", [(8.0, 6.0), (0.3, -0.2)])  # far and near branches
def test_path_follow_and_speed_critics_match_jax(rng, goal):
    traj = _trajectories(rng)
    lin = rng.uniform(0.0, 2.0, (24, 20))
    x, y = 0.1, -0.3
    t = torch.from_numpy
    jg, tg = jnp.asarray(goal), _s(goal)
    hm = 9.0 if goal[0] > 1 else 0.2  # dist > horizon (far) vs < (near)
    np.testing.assert_allclose(
        _np(tcr.path_follow_critic(_s(x), _s(y), tg, t(traj), _s(hm))),
        np.asarray(jcr.path_follow_critic(x, y, jg, jnp.asarray(traj), hm)), rtol=RTOL)
    np.testing.assert_allclose(
        _np(tcr.maximise_speed_critic(_s(x), _s(y), tg, t(lin), _s(2.0))),
        np.asarray(jcr.maximise_speed_critic(x, y, jg, jnp.asarray(lin), 2.0)), rtol=RTOL)


def test_slope_critics_match_jax(rng):
    lw, rw = _trajectories(rng), _trajectories(rng)
    t = torch.from_numpy
    np.testing.assert_allclose(_np(tcr.avoid_slope_wheels_critic(t(lw), t(rw))),
                               np.asarray(jcr.avoid_slope_wheels_critic(lw, rw)), rtol=RTOL)
    # the body-slope form (slope_critic="body") passes the body trajectory twice
    np.testing.assert_allclose(_np(tcr.avoid_slope_wheels_critic(t(lw), t(lw))),
                               np.asarray(jcr.avoid_slope_critic(lw)), rtol=RTOL)


def test_obstacle_critic_and_cells_match_jax(rng):
    jcm, tcm = _world(rng)
    traj = _trajectories(rng)
    ix, iy = tcr.costmap_cells(torch.from_numpy(traj), tcm)
    jix, jiy = jcr.costmap_cells(jnp.asarray(traj), jcm)
    np.testing.assert_array_equal(ix.numpy(), np.asarray(jix))
    np.testing.assert_array_equal(iy.numpy(), np.asarray(jiy))
    assert (ix.numpy() < 0).any() and (ix.numpy() >= 32).any()
    got = tcr.avoid_obstacle_critic(torch.from_numpy(traj), tcm)
    want = jcr.avoid_obstacle_critic(jnp.asarray(traj), jcm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)
    assert (got.numpy() >= 1e5).any()  # collisions counted


def test_evaluate_softmax_update_match_jax(rng):
    jcm, tcm = _world(rng)
    traj, lw, rw = (_trajectories(rng, spread=5.0) for _ in range(3))
    lin = rng.uniform(0.0, 2.0, (24, 20))
    goal = np.array([8.0, 6.0])
    t = torch.from_numpy
    got = tcr.evaluate_trajectories(
        _s(0.1), _s(-0.3), t(goal), t(traj), t(lw), t(rw), t(lin), _s(2.0),
        tcm, _s(9.0), tcr.CriticWeights())
    want = jcr.evaluate_trajectories(0.1, -0.3, jnp.asarray(goal), jnp.asarray(traj),
                                     jnp.asarray(lw), jnp.asarray(rw), jnp.asarray(lin),
                                     2.0, jcm, 9.0, jcr.CriticWeights())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL)

    w = tcr.softmax_weights(got, 0.3)
    np.testing.assert_allclose(w.numpy(), np.asarray(jcr.softmax_weights(want, 0.3)),
                               rtol=1e-11)
    u1, u2 = rng.uniform(-1, 1, (2, 24, 20))
    for a, b in zip(tcr.weighted_update(w, t(u1), t(u2)),
                    jcr.weighted_update(jnp.asarray(w.numpy()), jnp.asarray(u1), jnp.asarray(u2))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-12)
    assert tuple(tcr.CriticWeights()) == tuple(jcr.CriticWeights())


@pytest.mark.parametrize("start", [(7.8, 6.1), (0.1, -0.3)])  # inside and outside 0.5 m
def test_goal_angle_critic_matches_jax(rng, start):
    """The unused terminal-orientation critic, the reference's ``atan`` (not
    ``atan2``) kept: within the file's float64 tolerance (a transcendental),
    and 0 outside the 0.5 m goal radius on both sides."""
    traj = _trajectories(rng)
    goal, orientation = np.array([8.0, 6.0]), 0.7
    got = tcr.goal_angle_critic(_s(start[0]), _s(start[1]), torch.from_numpy(goal),
                                _s(orientation), torch.from_numpy(traj))
    want = jcr.goal_angle_critic(jnp.asarray(start[0]), jnp.asarray(start[1]),
                                 jnp.asarray(goal), jnp.asarray(orientation), jnp.asarray(traj))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=RTOL, atol=0)
    near = np.hypot(start[0] - goal[0], start[1] - goal[1]) < 0.5
    assert (_np(got) != 0.0).any() == near
    # atan folds the segment direction into (-pi/2, pi/2): a segment and its
    # reverse cost the same, as in the reference
    rev = traj.copy()
    rev[:, -2:] = traj[:, -2:][:, ::-1]
    again = tcr.goal_angle_critic(_s(start[0]), _s(start[1]), torch.from_numpy(goal),
                                  _s(orientation), torch.from_numpy(rev))
    np.testing.assert_array_equal(_np(again), _np(got))


@pytest.mark.parametrize("goal", [(8.0, 6.0), (-9.0, 0.4)])
def test_path_orientation_critic_equals_jax(rng, goal):
    """The unused progress-direction critic: no transcendental, so equal to
    the JAX package's; segments pointing towards the goal cost 0."""
    traj = _trajectories(rng)
    x, y = 0.1, -0.3
    got = tcr.path_orientation_critic(_s(x), _s(y), torch.tensor(goal, dtype=torch.float64),
                                      torch.from_numpy(traj))
    want = jcr.path_orientation_critic(jnp.asarray(x), jnp.asarray(y), jnp.asarray(goal),
                                       jnp.asarray(traj))
    np.testing.assert_array_equal(_np(got), np.asarray(want))
    assert (_np(got) == 0.0).any() and (_np(got) > 0.0).any()


@pytest.mark.parametrize("size", [32, 75])
def test_costmap_size_matches_jax(rng, size):
    """``Costmap.size`` is the cost grid's side, as JAX's property
    (mppi/critics.py:50-52) gives it (exact: an int)."""
    jcm, tcm = _world(rng, size=size)
    assert type(tcm.size) is int
    assert tcm.size == jcm.size == size
