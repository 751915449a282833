"""PyTorch port: heightfield and geometry ops against the JAX package
(float64; indices and gathered corners exactly, arithmetic to 1e-12)."""

import jax.numpy as jnp
import numpy as np
import torch

from husky_rover_mppi_isaacsim_torch.convert import heightfield_from_numpy
from husky_rover_mppi_isaacsim_torch.core import geometry as tgeom
from husky_rover_mppi_isaacsim_torch.core import heightfield as thf
from husky_rover_mppi_isaacsim_tpu.core import HeightField as JHeightField
from husky_rover_mppi_isaacsim_tpu.core import geometry as jgeom
from husky_rover_mppi_isaacsim_tpu.core import heightfield as jhf

# small tensors: one intra-op thread each, so that the test workers running
# beside these do not lose their cores
torch.set_num_threads(1)

ATOL = 1e-12


def _fields(grid=64, hw=8.0, seed=0):
    z = np.random.default_rng(seed).normal(size=(grid, grid)) * 0.3
    jf = JHeightField.create(z, hw, dtype=jnp.float64)
    tf = heightfield_from_numpy(*(np.asarray(a) for a in jf))
    return jf, tf


def _points(rng, n, hw):
    # half inside the window, half up to 1.5 windows out: negative and
    # out-of-range cell indices on both axes
    inside = rng.uniform(-hw + 0.5, hw - 0.5, size=(2, n // 2))
    outside = rng.uniform(-1.6 * hw, 1.6 * hw, size=(2, n - n // 2))
    return np.concatenate([inside, outside], axis=1)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def test_corner_cell_and_gathers_match_jax(rng):
    jf, tf = _fields()
    xs, ys = _points(rng, 400, 8.0)
    tx, ty = torch.from_numpy(xs), torch.from_numpy(ys)
    ji, jj = jhf.corner_cell(jf, jnp.asarray(xs), jnp.asarray(ys))
    ti, tj = thf.corner_cell(tf, tx, ty)
    np.testing.assert_array_equal(_np(ti), np.asarray(ji))
    np.testing.assert_array_equal(_np(tj), np.asarray(jj))
    assert (np.asarray(ji) < 0).any() and (np.asarray(ji) >= 63).any()
    assert (np.asarray(jj) < 0).any() and (np.asarray(jj) >= 63).any()
    np.testing.assert_array_equal(_np(thf.corners_at(tf, tx, ty)),
                                  np.asarray(jhf.corners_at(jf, jnp.asarray(xs), jnp.asarray(ys))))
    np.testing.assert_array_equal(_np(thf.nearest_height(tf, tx, ty)),
                                  np.asarray(jhf.nearest_height(jf, jnp.asarray(xs), jnp.asarray(ys))))


def test_wrap_then_clamp_index_semantics():
    """A negative index wraps once, then clamps — for i, i+1, j and j+1
    separately — exactly as the JAX gathers read."""
    jf, tf = _fields(grid=16)
    idx = np.array([-40, -17, -16, -15, -2, -1, 0, 1, 14, 15, 16, 17, 40])
    ii, jj = np.meshgrid(idx, idx[::-1])
    got = thf.gather_corners(tf, torch.from_numpy(ii), torch.from_numpy(jj))
    want = jhf.gather_corners(jf, jnp.asarray(ii), jnp.asarray(jj))
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_bilinear_normal_tangent_height_match_jax(rng):
    jf, tf = _fields()
    xs, ys = _points(rng, 300, 8.0)
    jx, jy = jnp.asarray(xs), jnp.asarray(ys)
    tx, ty = torch.from_numpy(xs), torch.from_numpy(ys)
    jq, tq = jhf.corners_at(jf, jx, jy), thf.corners_at(tf, tx, ty)
    np.testing.assert_allclose(_np(thf.bilinear(tx, ty, tq, tf.resolution)),
                               np.asarray(jhf.bilinear(jx, jy, jq, jf.resolution)), atol=ATOL)
    tn = thf.quad_normal(tq, tf.resolution)
    np.testing.assert_allclose(_np(tn), np.asarray(jhf.quad_normal(jq, jf.resolution)), atol=ATOL)
    heading = rng.normal(size=(300, 3))
    np.testing.assert_allclose(
        _np(thf.tangent_project(tn, torch.from_numpy(heading))),
        np.asarray(jhf.tangent_project(jhf.quad_normal(jq, jf.resolution), jnp.asarray(heading))),
        atol=ATOL)
    np.testing.assert_allclose(_np(thf.height_at(tf, tx, ty)),
                               np.asarray(jhf.height_at(jf, jx, jy)), atol=ATOL)


def test_heightfield_create_matches_jax():
    z = np.random.default_rng(3).normal(size=(40, 40)).astype(np.float32)
    jf = JHeightField.create(z, 12.5, dtype=jnp.float32)
    tf = thf.HeightField.create(z, 12.5)
    for a, b in zip(tf, jf):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    assert tf.grid_size == jf.grid_size == 40


def test_geometry_matches_jax(rng):
    n = 200
    v = rng.normal(size=(n, 3))
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    ang = rng.uniform(-1.0, 1.0, n)
    lin = rng.uniform(0.0, 2.0, n)
    x, y = rng.uniform(-5, 5, (2, n))
    t = torch.from_numpy
    np.testing.assert_allclose(_np(tgeom.normalize(t(v))), np.asarray(jgeom.normalize(v)), atol=ATOL)
    np.testing.assert_allclose(_np(tgeom.cross3(t(axis), t(v))), np.cross(axis, v), atol=ATOL)
    np.testing.assert_allclose(_np(tgeom.rodrigues_rotate(t(v), t(axis), t(ang))),
                               np.asarray(jgeom.rodrigues_rotate(v, axis, ang)), atol=ATOL)
    for a, b in zip(tgeom.update_position(t(x), t(y), t(v), t(lin), 0.045),
                    jgeom.update_position(x, y, v, lin, 0.045)):
        np.testing.assert_allclose(_np(a), np.asarray(b), atol=ATOL)
    np.testing.assert_allclose(_np(tgeom.update_orientation(t(v), t(ang), t(axis), 0.045)),
                               np.asarray(jgeom.update_orientation(v, ang, axis, 0.045)), atol=ATOL)
    flat = v.copy()
    flat[:5, :2] = 0.0  # zero planar norm keeps the heading as is
    np.testing.assert_allclose(_np(tgeom.update_orientation_2d(t(flat), t(ang), 0.045)),
                               np.asarray(jgeom.update_orientation_2d(flat, ang, 0.045)), atol=ATOL)


def test_surface_frame_and_jacobian_slope_match_jax(rng):
    """``surface_frame`` is the fused height, normal and tangent heading;
    ``jacobian_slope`` the normal's tilt. Equal where no transcendental
    enters (the frame is the same gathers and arithmetic as the parts the
    file holds at 1e-12); ``arccos`` within the file's tolerance."""
    jf, tf = _fields()
    xs, ys = _points(rng, 300, 8.0)
    jx, jy = jnp.asarray(xs), jnp.asarray(ys)
    tx, ty = torch.from_numpy(xs), torch.from_numpy(ys)
    heading = rng.normal(size=(300, 3))
    got = thf.surface_frame(tf, tx, ty, torch.from_numpy(heading))
    want = jhf.surface_frame(jf, jx, jy, jnp.asarray(heading))
    for a, b in zip(got, want):
        np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=ATOL)
    # the fused frame is the unfused sequence, bit for bit
    q = thf.corners_at(tf, tx, ty)
    n = thf.quad_normal(q, tf.resolution)
    for a, b in zip(got, (thf.bilinear(tx, ty, q, tf.resolution), n,
                          thf.tangent_project(n, torch.from_numpy(heading)))):
        assert torch.equal(a, b)
    slope = thf.jacobian_slope(tf, tx, ty)
    np.testing.assert_allclose(_np(slope), np.asarray(jhf.jacobian_slope(jf, jx, jy)),
                               rtol=0, atol=ATOL)
    assert (_np(slope) >= 0.0).all() and (_np(slope) < np.pi / 2).all()
    from husky_rover_mppi_isaacsim_torch import core as tcore
    assert tcore.surface_frame is thf.surface_frame and tcore.jacobian_slope is thf.jacobian_slope
