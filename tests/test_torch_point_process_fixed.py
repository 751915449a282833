"""PyTorch port: the fixed-capacity point processes and the clipmap's
rock-placement query against the JAX package.

The port draws from ``torch.Generator``s, so its points are not JAX's; the
draw-free parts are held exactly: the hardcore thinning with JAX's marks
injected keeps the same mask, and the placement query gives JAX's heights
(float64, 1e-12). The draws are held to their laws: shapes, mask layout,
points inside the region, counts within capacity and mean counts near
``area x density`` over seeds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch import convert
from husky_rover_mppi_isaacsim_torch.core import jax_random as jr
from husky_rover_mppi_isaacsim_torch.terrain import point_process as tpp
from husky_rover_mppi_isaacsim_torch.terrain.clipmap import NestedClipmap as TNested
from husky_rover_mppi_isaacsim_tpu.core.heightfield import HeightField as JHeightField
from husky_rover_mppi_isaacsim_tpu.terrain import crater_surface
from husky_rover_mppi_isaacsim_tpu.terrain import point_process as jpp
from husky_rover_mppi_isaacsim_tpu.terrain.clipmap import NestedClipmap as JNested

torch.set_num_threads(1)

REGION = (-10.0, 10.0, -5.0, 15.0)
AREA = 20.0 * 20.0


def _in_region(points, region=REGION):
    x, y = points[:, 0], points[:, 1]
    return (x >= region[0]) & (x <= region[1]) & (y >= region[2]) & (y <= region[3])


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hardcore_thin_masked_with_jax_marks(seed):
    """JAX's candidates and marks through the port's thinning: the same
    keep mask as JAX's ``hardcore_thin_fixed``."""
    k_pts, k_marks = jax.random.split(jax.random.key(seed))
    jpts = jpp.poisson_fixed(k_pts, REGION, 0.4, (0.5, 2.5), 256, dtype=jnp.float64)
    want = jpp.hardcore_thin_fixed(k_marks, jpts)
    marks = np.array(jax.random.uniform(k_marks, (jpts.capacity,), jnp.float64))
    got = tpp.hardcore_thin_masked(convert.masked_points_from_jax(jpts), torch.from_numpy(marks))
    keep = got.mask.numpy()
    assert np.array_equal(keep, np.asarray(want.mask))
    assert 0 < keep.sum() < np.asarray(jpts.mask).sum()  # the thinning removed some
    assert torch.equal(got.points, torch.from_numpy(np.array(jpts.points)))


def test_hardcore_thin_fixed_draws_marks_from_the_generator():
    pts = tpp.poisson_fixed(torch.Generator().manual_seed(3), REGION, 0.4, (0.5, 2.5), 128,
                            dtype=torch.float64)
    got = tpp.hardcore_thin_fixed(torch.Generator().manual_seed(9), pts)
    marks = torch.rand((128,), generator=torch.Generator().manual_seed(9), dtype=torch.float64)
    assert torch.equal(got.mask, tpp.hardcore_thin_masked(pts, marks).mask)
    assert not (got.mask & ~pts.mask).any()
    # a survivor is older than every valid point strictly inside its radius
    diff = pts.points[:, None, :] - pts.points[None, :, :]
    d = torch.sqrt(torch.sum(diff * diff, dim=-1))
    inside = (d < pts.radius[:, None]) & (d > 0) & pts.mask[None, :]
    for i in torch.nonzero(got.mask).flatten().tolist():
        assert bool((marks[i] < marks[inside[i]]).all())
    assert 0 < int(got.mask.sum()) < int(pts.mask.sum())


def test_poisson_fixed_layout_and_law():
    cap = 512
    counts = []
    for seed in range(40):
        pts = tpp.poisson_fixed(torch.Generator().manual_seed(seed), REGION, 0.5, (0.1, 0.9),
                                cap)
        assert pts.points.shape == (cap, 2) and pts.radius.shape == (cap,)
        assert pts.mask.shape == (cap,) and pts.mask.dtype == torch.bool
        assert pts.points.dtype == pts.radius.dtype == torch.float32 and pts.capacity == cap
        n = int(pts.mask.sum())
        assert torch.equal(pts.mask, torch.arange(cap) < n)  # the valid points come first
        assert bool(_in_region(pts.points).all())
        assert bool(((pts.radius >= 0.1) & (pts.radius <= 0.9)).all())
        counts.append(n)
    mean = AREA * 0.5
    assert max(counts) <= cap
    assert abs(np.mean(counts) - mean) < 4 * np.sqrt(mean / len(counts))
    capped = tpp.poisson_fixed(torch.Generator().manual_seed(0), REGION, 0.5, (0.1, 0.9), 16)
    assert bool(capped.mask.all())  # Poisson(200) > 16: the count is capped


def test_thomas_fixed_layout_and_law():
    pd, cd, sigma, pcap, ccap = 0.02, 6.0, 0.8, 64, 24
    counts = []
    for seed in range(50):
        pts = tpp.thomas_fixed(torch.Generator().manual_seed(seed), REGION, pd, cd, sigma,
                               pcap, ccap, dtype=torch.float64)
        assert pts.points.shape == (pcap * ccap, 2) and pts.mask.shape == (pcap * ccap,)
        assert pts.points.dtype == torch.float64 and torch.equal(pts.radius,
                                                                  torch.zeros(pcap * ccap,
                                                                              dtype=torch.float64))
        assert bool(_in_region(pts.points[pts.mask]).all())
        counts.append(int(pts.mask.sum()))
    # a Thomas process has intensity pd * cd; its counts are over-dispersed
    # (variance ~ mean * (1 + cd))
    mean = AREA * pd * cd
    assert max(counts) <= pcap * ccap
    assert abs(np.mean(counts) - mean) < 4 * np.sqrt(mean * (1 + cd) / len(counts))


def test_point_processes_follow_the_generator():
    a = tpp.thomas_fixed(torch.Generator().manual_seed(5), REGION, 0.02, 6.0, 0.8, 32, 8)
    b = tpp.thomas_fixed(torch.Generator().manual_seed(5), REGION, 0.02, 6.0, 0.8, 32, 8)
    c = tpp.thomas_fixed(torch.Generator().manual_seed(6), REGION, 0.02, 6.0, 0.8, 32, 8)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a.points, c.points)


def test_masked_points_from_jax():
    jpts = jpp.poisson_fixed(jax.random.key(1), REGION, 0.1, (0.2, 0.4), 32)
    got = convert.masked_points_from_jax(jpts)
    assert isinstance(got, tpp.MaskedPoints) and got.capacity == 32
    for a, b in zip(got, jpts):
        assert np.array_equal(a.numpy(), np.asarray(b))


def _quat_rotate(q, v):
    """Rotate v (N, 3) by unit quaternions q (N, 4) xyzw."""
    u, w = q[:, :3], q[:, 3:]
    t = 2.0 * np.cross(u, v)
    return v + w * t + np.cross(u, t)


def test_get_height_and_random_orientation_matches_jax():
    hw = 10.0
    z = np.asarray(crater_surface(128, hw, [((2.0, -3.0), 1.5, 3.0), ((-4.0, 4.0), 2.0, 2.0)],
                                  dtype=jnp.float64))
    jhf = JHeightField.create(z, hw, dtype=jnp.float64)
    thf = convert.heightfield_from_numpy(*(np.asarray(a) for a in jhf))
    xy = np.random.default_rng(0).uniform(-8.0, 8.0, (64, 2))
    jh, jq, jn = JNested(None, None).get_height_and_random_orientation(
        jnp.asarray(xy), jax.random.key(0), jhf)
    th, tq, tn = TNested(None, None).get_height_and_random_orientation(
        torch.from_numpy(xy), jr.key(0), thf)
    assert th.shape == (64,) and tq.shape == (64, 4) and tn.shape == (64, 3)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tn.numpy(), np.asarray(jn), rtol=0, atol=1e-12)
    q, n = tq.numpy(), tn.numpy()
    np.testing.assert_allclose(np.linalg.norm(q, axis=-1), 1.0, rtol=0, atol=1e-12)
    # the frame's z axis is the surface normal, its x axis lies in the surface
    ez = np.tile([0.0, 0.0, 1.0], (64, 1))
    ex = np.tile([1.0, 0.0, 0.0], (64, 1))
    np.testing.assert_allclose(_quat_rotate(q, ez), n, rtol=0, atol=1e-9)
    np.testing.assert_allclose(np.sum(_quat_rotate(q, ex) * n, axis=-1), 0.0, rtol=0, atol=1e-9)
    # the tangent draws are JAX's (float64: within one ulp), so the
    # quaternions are JAX's too
    np.testing.assert_allclose(q, np.asarray(jq), rtol=0, atol=1e-12)
    # another key turns the rocks about the same normals
    _, tq2, _ = TNested(None, None).get_height_and_random_orientation(
        torch.from_numpy(xy), jr.key(1), thf)
    assert not torch.allclose(tq, tq2)
