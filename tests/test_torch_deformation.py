"""PyTorch port: the wheel-track deformation engine (``physics/deformation.py``)
and the pass-count roll of the streamed loop (``_roll_pass_counts``) against
the JAX package, on the CPU, float32 in both.

Tolerances: the depth profile, the footprint in the world frame and both
distributions agree to 1e-6 (the same float32 operations; the tables come
from the same numpy code); a stamp's heights to 1e-6 m with EQUAL pass
counts (the same cells: footprint points and cell indices are computed by
the same float32 operations, and points sharing a cell are summed in
another order); the rolled counts are EQUAL (integers).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch import convert
from husky_rover_mppi_isaacsim_torch.env import largescale_loop as tls
from husky_rover_mppi_isaacsim_torch.physics import deformation as tdef
from husky_rover_mppi_isaacsim_tpu.env import largescale_loop as jls
from husky_rover_mppi_isaacsim_tpu.physics import deformation as jdef

torch.set_num_threads(1)

KINDS = [(d, b) for d in ("uniform", "sinusoidal", "trapezoidal")
         for b in ("uniform", "parabolic", "trapezoidal")]


def _engines(depth="sinusoidal", boundary="trapezoidal", res=0.05, **kw):
    """The JAX test's lab-grid engine (tests/test_physics.py ``_engine``) in
    both packages, through the converter."""
    jconf = jdef.DeformationEngineConf(
        terrain_resolution=res, terrain_width=10.0, terrain_height=10.0,
        depth=jdef.DepthDistributionConf(distribution=depth),
        boundary=jdef.BoundaryDistributionConf(distribution=boundary), **kw)
    tconf = convert.deformation_engine_conf_from_jax(jconf)
    assert isinstance(tconf.footprint, tdef.FootprintConf) and tconf == tdef.DeformationEngineConf(
        terrain_resolution=res, terrain_width=10.0, terrain_height=10.0,
        depth=tdef.DepthDistributionConf(distribution=depth),
        boundary=tdef.BoundaryDistributionConf(distribution=boundary), **kw)
    return jdef.DeformationEngine(jconf), tdef.DeformationEngine(tconf)


@pytest.mark.parametrize("depth,boundary", KINDS)
def test_distributions_and_depth_match_jax(depth, boundary, rng):
    jeng, teng = _engines(depth, boundary)
    np.testing.assert_array_equal(teng.profile, jeng.profile)
    assert (teng.px_width, teng.px_height, teng.sim_height) == (
        jeng.px_width, jeng.px_height, jeng.sim_height)
    np.testing.assert_allclose(teng.depth_dist_np, np.asarray(jeng.depth_dist), rtol=0, atol=1e-6)
    np.testing.assert_allclose(teng.boundary_dist_np, np.asarray(jeng.boundary_dist), rtol=0,
                               atol=1e-6)
    forces = rng.uniform(0.0, 200.0, 4).astype(np.float32)
    got = teng.deformation_depth(torch.from_numpy(forces))
    want = jeng.deformation_depth(jnp.asarray(forces))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_footprint_in_global_matches_jax(rng):
    jeng, teng = _engines()
    pos = rng.uniform(0.0, 9.0, (5, 3)).astype(np.float32)
    half = rng.uniform(-np.pi, np.pi, 5) / 2.0
    quat = np.stack([np.cos(half), 0 * half, 0 * half, np.sin(half)], -1).astype(np.float32)
    got = teng.footprint_in_global(torch.from_numpy(pos), torch.from_numpy(quat))
    want = jeng.footprint_in_global(jnp.asarray(pos), jnp.asarray(quat))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def _lab_inputs():
    """tests/test_physics.py:35 and :52: one footprint at (5, 5), the
    identity quaternion, 100 N, on a 200^2 zero DEM."""
    return (np.zeros((200, 200), np.float32), np.zeros((200, 200), np.int32),
            np.array([[5.0, 5.0, 0.0]], np.float32), np.array([[1.0, 0.0, 0.0, 0.0]], np.float32),
            np.array([100.0], np.float32))


@pytest.mark.parametrize("depth,boundary", [("uniform", "uniform"),
                                            ("sinusoidal", "trapezoidal")])
def test_deform_twice_matches_jax(depth, boundary):
    """Two passes on the lab grid (the second decays by the pass counts
    from before it): heights to 1e-6 m, counts equal."""
    jeng, teng = _engines(depth, boundary)
    dem, counts, pos, quat, forces = _lab_inputs()
    jd, jc = jnp.asarray(dem), jnp.asarray(counts)
    td, tc = torch.from_numpy(dem.copy()), torch.from_numpy(counts.copy())
    for _ in range(2):
        jd, jc = jeng.deform(jd, jc, jnp.asarray(pos), jnp.asarray(quat), jnp.asarray(forces))
        out = teng.deform(td, tc, torch.from_numpy(pos), torch.from_numpy(quat),
                          torch.from_numpy(forces))
        assert out[0] is td and out[1] is tc  # in place
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert float(td.min()) < 0.0 and int(tc.sum()) == 2 * teng.profile.shape[0]


def _window_inputs(rng, n=4):
    """A side-slope track (tests/test_env.py:124) plus random yaws."""
    body, left, track = np.array([5.0, 5.0]), np.array([0.0, 1.0]), 1.2
    positions = np.stack([body + left * track / 2, body - left * track / 2,
                          body + left * track / 2 - [0.5, 0.0],
                          body - left * track / 2 - [0.5, 0.0]]).astype(np.float32)
    yaws = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    loads = np.array([60.0, 120.0, 60.0, 120.0], np.float32)
    window = rng.normal(0.0, 0.2, (200, 200)).astype(np.float32)
    return window, positions, yaws, loads


@pytest.mark.parametrize("res", [0.05, 0.025])
def test_deform_window_matches_jax(rng, res):
    """``deform_window`` on a streamed-window layout, three stamps in turn
    (the later ones decayed): heights to 1e-6 m, counts equal. At 0.025
    m/px (the reference window) the footprint is 11 x 5 points per wheel."""
    jeng, teng = _engines(res=res)
    if res == 0.025:
        assert teng.profile.shape[0] == 55
    window, positions, yaws, loads = _window_inputs(rng)
    origin = (0.5, -0.25)
    jw, jc = jnp.asarray(window), jnp.zeros(window.shape, jnp.int32)
    tw, tc = torch.from_numpy(window.copy()), torch.zeros(window.shape, dtype=torch.int32)
    for k in range(3):
        p = positions + np.float32(0.02 * k)
        jw, jc = jeng.deform_window(jw, jc, res, origin, p, yaws, loads)
        teng.deform_window(tw, tc, res, origin, torch.from_numpy(p), torch.from_numpy(yaws),
                           torch.from_numpy(loads))
        np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert int(tc.max()) >= 2  # the later stamps hit counted cells


def test_deform_window_sinks_the_loaded_track_deeper(rng):
    """tests/test_env.py:124 in the port: the downhill (loaded) track sinks
    deeper than the uphill one."""
    _, teng = _engines(res=0.05)
    _, positions, _, loads = _window_inputs(rng)
    window = torch.zeros((200, 200))
    counts = torch.zeros((200, 200), dtype=torch.int32)
    teng.deform_window(window, counts, 0.05, (0.0, 0.0), torch.from_numpy(positions),
                       torch.zeros(4), torch.from_numpy(loads))
    col_left, col_right = int((5.0 + 0.6) / 0.05), int((5.0 - 0.6) / 0.05)
    left_sink = float(window[:, col_left - 3:col_left + 4].min())
    right_sink = float(window[:, col_right - 3:col_right + 4].min())
    assert right_sink < left_sink < 0.0


def test_stamp_is_deterministic_with_shared_cells(rng):
    """Points that share a cell (a coarse grid under a fine footprint) sum
    in a fixed order: two stamps from the same inputs are ``torch.equal``,
    and each shared cell holds the sum of its points."""
    _, teng = _engines(res=0.05)
    window, positions, yaws, loads = _window_inputs(rng)
    outs = []
    for _ in range(2):
        w, c = torch.from_numpy(window.copy()), torch.zeros(window.shape, dtype=torch.int32)
        teng.deform_window(w, c, 0.2, (0.0, 0.0), torch.from_numpy(positions),
                           torch.from_numpy(yaws), torch.from_numpy(loads))
        outs.append((w, c))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    counts = outs[0][1]
    assert int(counts.max()) > 1 and int(counts.sum()) == 4 * teng.profile.shape[0]
    # the stamp's total is the sum of every point's depth (decay 1 at 0 passes)
    total = float((outs[0][0] - torch.from_numpy(window)).double().sum())
    depth = teng.deformation_depth(torch.from_numpy(loads)).double().sum()
    assert total == pytest.approx(float(depth), abs=1e-5)


@pytest.mark.parametrize("di,dj", [(2, 0), (-2, 0), (0, 3), (0, -3), (2, -1), (-1, -2), (0, 0),
                                   (6, 0), (0, -7), (9, 9), (-6, 1)])
def test_roll_pass_counts_equals_jax(di, dj):
    """Rolled counts EQUAL to the JAX package's for axis, diagonal, zero and
    whole-window jumps (the latter reset every count)."""
    counts = np.arange(36, dtype=np.int32).reshape(6, 6) + 1
    got = tls._roll_pass_counts(torch.from_numpy(counts), di, dj)
    want = np.asarray(jls._roll_pass_counts(jnp.asarray(counts), di, dj))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if abs(di) >= 6 or abs(dj) >= 6:
        assert not got.any()
