"""PyTorch port: the standalone world build (crater surface, obstacle raster,
exact EDT costmap) against the JAX package."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch.ops import edt as tedt
from husky_rover_mppi_isaacsim_torch.terrain import costmap as tcost
from husky_rover_mppi_isaacsim_torch.terrain import surface as tsurf
from husky_rover_mppi_isaacsim_tpu.compat import numpy_oracle as no
from husky_rover_mppi_isaacsim_tpu.ops import edt as jedt
from husky_rover_mppi_isaacsim_tpu.terrain import costmap as jcost
from husky_rover_mppi_isaacsim_tpu.terrain import surface as jsurf

# small tensors: one intra-op thread each, so that the test workers running
# beside these do not lose their cores
torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", [(torch.float64, jnp.float64), (torch.float32, jnp.float32)],
                         ids=["f64", "f32"])
def test_crater_surface_matches_jax(dtype):
    got = tsurf.crater_surface(300, 75.0, tsurf.STANDALONE_CRATER_BUMPS, dtype=dtype[0])
    want = np.asarray(jsurf.crater_surface(300, 75.0, jsurf.STANDALONE_CRATER_BUMPS,
                                           dtype=dtype[1]))
    assert got.dtype == dtype[0]
    if dtype[0] == torch.float32:  # XLA's linspace, exp and rounding: JAX's bits
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0.0)
    assert tsurf.STANDALONE_CRATER_BUMPS == jsurf.STANDALONE_CRATER_BUMPS


def test_flagship_crater_map_is_jaxs():
    """The main path's 150 m map (``cli.build_standalone_world``, JAX
    ``cli.py:99``): ``crater_surface(1500, 75.0, STANDALONE_CRATER_BUMPS)``
    in float32, bit for bit."""
    got = tsurf.crater_surface(1500, 75.0, tsurf.STANDALONE_CRATER_BUMPS)
    want = np.asarray(jsurf.crater_surface(1500, 75.0, jsurf.STANDALONE_CRATER_BUMPS))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("size", [128, 353, 700])
def test_float32_bump_surface_is_jaxs(size):
    """``bump_surface`` in float32 (XLA's ``exp`` and ``atan2f(x, 1)``) on
    both sides of the grid size where XLA's linspace stops folding its
    constants."""
    got = tsurf.bump_surface(size, 20.0, no.REFERENCE_BUMPS)
    want = np.asarray(jsurf.bump_surface(size, 20.0, no.REFERENCE_BUMPS))
    np.testing.assert_array_equal(got.numpy(), want)


def test_bump_surface_matches_jax():
    got = tsurf.bump_surface(128, 20.0, no.REFERENCE_BUMPS, dtype=torch.float64)
    want = np.asarray(jsurf.bump_surface(128, 20.0, no.REFERENCE_BUMPS, dtype=jnp.float64))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


def test_obstacle_field_and_raster_equal_jax():
    obs = tcost.generate_obstacles()
    np.testing.assert_array_equal(obs, jcost.generate_obstacles())
    for kw in (dict(), dict(size=200, robot_radius=0.3, origin=(3.0, -2.0))):
        np.testing.assert_array_equal(tcost.rasterize_obstacles(obs, **kw),
                                      jcost.rasterize_obstacles(obs, **kw))


def _occupancy(size=200):
    raster = jcost.rasterize_obstacles(jcost.generate_obstacles(), half_width=75.0,
                                       size=size, robot_radius=0.3)
    return raster == 0


def test_edt_exact_sq_equals_jax():
    occ = _occupancy()
    assert occ.any() and not occ.all()
    got = tedt.edt_exact_sq(torch.from_numpy(occ))
    want = np.asarray(jedt.edt_exact_sq(jnp.asarray(occ)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    rows = tedt._row_distances(torch.from_numpy(occ))
    np.testing.assert_array_equal(rows.numpy()[occ.any(axis=1)],
                                  np.asarray(jedt._row_distances(jnp.asarray(occ)))[occ.any(axis=1)])


def test_distance_costmap_matches_jax():
    occ = _occupancy()
    got = tedt.distance_costmap(torch.from_numpy(occ))
    want = np.asarray(jedt.distance_costmap(jnp.asarray(occ)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(tedt.normalize_minmax(torch.arange(5.0)).numpy(),
                               np.asarray(jedt.normalize_minmax(jnp.arange(5.0))))
    empty = tedt.distance_costmap(torch.zeros((40, 40), dtype=torch.bool))
    assert torch.equal(empty, torch.zeros((40, 40)))
    assert torch.equal(tedt.normalize_minmax(torch.full((3, 3), 2.0)), torch.zeros((3, 3)))


def test_costmap_750_matches_jax_at_reduced_size():
    got = tcost.costmap_750(size=150, use_exact_edt=True)
    want = jcost.costmap_750(size=150, use_exact_edt=True)
    np.testing.assert_array_equal(got.cost.numpy(), np.asarray(want.cost))
    chamfer = tcost.costmap_750(size=150)
    np.testing.assert_array_equal(chamfer.cost.numpy(), np.asarray(jcost.costmap_750(size=150).cost))
    assert float(got.half_width) == float(want.half_width) == 75.0
    assert float(got.resolution) == float(want.resolution)
    assert got.cost.dtype == torch.float32


@pytest.mark.parametrize("rows", [40, 24])  # a larger file is cut to the window
def test_imported_surface_and_heightfield_match_jax(tmp_path, rows):
    """``imported_surface`` reads the same window of a DEM ``.npy`` (written
    here from a seed) as the JAX package; ``surface_heightfield`` wraps it in
    the same window, equal field by field."""
    z = np.random.default_rng(rows).normal(size=(rows, rows)).astype(np.float32)
    path = tmp_path / "dem.npy"
    np.save(path, z)
    got = tsurf.imported_surface(path, start=4, end=28)
    want = jsurf.imported_surface(str(path), start=4, end=28)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (24, 24) and got.dtype == np.float32
    thf_ = tsurf.surface_heightfield(got, 12.0)
    jhf_ = jsurf.surface_heightfield(want, 12.0)
    for a, b in zip(thf_, jhf_):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert thf_.z.device.type == "cpu"
    from husky_rover_mppi_isaacsim_torch import terrain as tterrain
    assert tterrain.imported_surface is tsurf.imported_surface
