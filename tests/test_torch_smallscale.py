"""PyTorch port: the small-scale terrain (terrain/upsample.py,
point_process.py, craters.py, smallscale.py) against the JAX package.

The host draws (point process, profile tables, crater metadata) take the
same numpy streams and must give equal arrays. The crater renderer works in
float32 in both packages (``craters.py:274`` of the JAX package) and the
port evaluates it as XLA's CPU code does (``core/xla_math.py``), so a
float32 block is JAX's bit for bit. The float64 base noise of the injected
tests (the port's float64 route, out of that scope) sums with the float32
craters within ``CRATER_ATOL`` = 2e-6 m. The base noise is drawn by JAX as
the JAX package draws it and injected into the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch import convert
from husky_rover_mppi_isaacsim_torch.core import jax_random as jr
from husky_rover_mppi_isaacsim_torch.terrain import craters as tcr
from husky_rover_mppi_isaacsim_torch.terrain import point_process as tpp
from husky_rover_mppi_isaacsim_torch.terrain import smallscale as tss
from husky_rover_mppi_isaacsim_torch.terrain import upsample as tup
from husky_rover_mppi_isaacsim_tpu.terrain import craters as jcr
from husky_rover_mppi_isaacsim_tpu.terrain import point_process as jpp
from husky_rover_mppi_isaacsim_tpu.terrain import smallscale as jss
from husky_rover_mppi_isaacsim_tpu.terrain import upsample as jup

# small tensors: one intra-op thread each, so that the test workers running
# beside these do not lose their cores
torch.set_num_threads(1)

CRATER_ATOL = 2e-6


def test_bicubic_point_sample_matches_jax_float64(rng):
    z = rng.normal(size=(30, 41))
    x = rng.uniform(-3.0, 33.0, (7, 9))   # taps past every edge clamp
    y = rng.uniform(-3.0, 44.0, (7, 9))
    got = tup.bicubic_point_sample(torch.from_numpy(z), torch.from_numpy(x), torch.from_numpy(y))
    want = np.asarray(jup.bicubic_point_sample(jnp.asarray(z), jnp.asarray(x), jnp.asarray(y)))
    assert got.dtype == torch.float64 and got.shape == (7, 9)
    # three-operand contractions, summed in different orders
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)
    t = np.linspace(-2.5, 2.5, 101)
    np.testing.assert_array_equal(tup.cubic_kernel(t), jup.cubic_kernel(t))


@pytest.mark.parametrize("scale,prev", [(1.0, False), (6.0, False), (3.0, True)],
                         ids=["dense", "grid_binned", "with_previous"])
def test_hardcore_poisson_same_stream_same_points(scale, prev):
    """Small draws take the dense thinning, large ones the grid-binned
    path (over 768 points); ``prev`` rejects against earlier disks."""
    region = tpp.BoundingBox(0.0, 10.0 * scale, -5.0 * scale, 5.0 * scale)
    jregion = jpp.BoundingBox(region.x_min, region.x_max, region.y_min, region.y_max)
    assert region.area == jregion.area
    kw = dict(densities=(0.05, 0.2), radius_ranges=((1.0, 2.0), (0.2, 0.5)), num_repeat=1)
    prev_pts = None
    if prev:
        p = np.random.default_rng(8)
        prev_pts = (p.uniform(0, 30, (40, 2)), p.uniform(0.5, 2.0, 40))
    got = tpp.hardcore_poisson(np.random.default_rng(5), region, prev=prev_pts, **kw)
    want = jpp.hardcore_poisson(np.random.default_rng(5), jregion, prev=prev_pts, **kw)
    assert got[0].shape[0] > (768 if scale > 5 else 0)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_profiles_and_metadata_same_stream_same_arrays():
    prof = tcr.build_profiles(12, seed=3)
    jprof = jcr.build_profiles(12, seed=3)
    for a, b in zip(prof, jprof):
        assert a.dtype == torch.float32 and a.shape == (12, tcr.TABLE_SIZE)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    coords = np.random.default_rng(4).uniform(0, 20, (70, 2))
    radius = np.random.default_rng(6).uniform(0.3, 2.0, 70)
    field = tcr.randomize_metadata(np.random.default_rng(9), coords, radius, 12, 96)
    jfield = jcr.randomize_metadata(np.random.default_rng(9), coords, radius, 12, 96)
    for a, b in zip(field, jfield):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(field.mask.sum()) == 70
    with pytest.raises(ValueError, match="capacity"):
        tcr.randomize_metadata(np.random.default_rng(9), coords, radius, 12, 64)


@pytest.mark.parametrize("pad_px", [0, 12])
def test_render_crater_block_matches_jax(pad_px):
    """~200 overlapping craters into a 256^2 block, some overhanging its
    edges, with JAX's metadata converted into the port's objects."""
    rng = np.random.default_rng(11)
    coords = rng.uniform(-1.0, 26.6, (200, 2))
    radius = rng.uniform(0.25, 2.5, 200)
    jprof = jcr.build_profiles(16, seed=2)
    jfield = jcr.randomize_metadata(np.random.default_rng(7), coords, radius, 16, 256)
    prof = convert.crater_profiles_from_numpy(*(np.asarray(a) for a in jprof))
    field = convert.crater_field_from_numpy(*(np.asarray(a) for a in jfield))
    origin = (0.8, -0.4)
    want = np.asarray(jcr.render_crater_block(jprof, jfield, jnp.asarray(origin, jnp.float32),
                                              0.1, 1.3, block_px=256, pad_px=pad_px,
                                              patch_px=56))
    got = tcr.render_crater_block(prof, field, origin, 0.1, 1.3, block_px=256, pad_px=pad_px,
                                  patch_px=56)
    assert got.dtype == torch.float32 and got.shape == (256, 256)
    assert np.abs(want).max() > 0.5  # real craters, with overlaps
    np.testing.assert_array_equal(got.numpy(), want)


def _jax_base_noise(seed, low_shape, lo, hi):
    """The two base-noise grids JAX's MoonyardGenerator draws on its first
    randomize (smallscale.py:73-93, 119, 135)."""
    _, k = jax.random.split(jax.random.key(seed))
    k1, k2 = jax.random.split(k)
    low = jax.random.uniform(k1, low_shape, minval=lo, maxval=hi)
    high = jax.random.uniform(k2, (100, 100), minval=lo * 0.01, maxval=hi * 0.01)
    return tuple(torch.from_numpy(np.array(a)) for a in (low, high))


def test_thesis_statistics_terrain_matches_jax_with_injected_noise():
    noise = _jax_base_noise(42, (4, 4), -1.2, 1.2)
    assert [tuple(t.shape) for t in noise] == list(tss.base_noise_shapes())
    got = tss.thesis_statistics_terrain(seed=42, size_m=20.0, base_noise=noise,
                                        dtype=torch.float64, device="cpu")
    want = np.asarray(jss.thesis_statistics_terrain(seed=42, size_m=20.0))
    assert got.dtype == torch.float64 and got.shape == want.shape == (200, 200)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=CRATER_ATOL)


@pytest.mark.parametrize("kind", ["yard", "lab"])
def test_moonyard_generator_matches_jax_with_injected_noise(kind):
    """The masked low-resolution grids of the yard and the lab on a
    non-square field (cropped from the square render)."""
    base = dict(x_size=4.0, y_size=3.0, resolution=0.02, seed=5)
    conf = tss.MoonyardConf(base=tss.BaseTerrainGeneratorConf(**base),
                            is_lab=kind == "lab", is_yard=kind == "yard")
    jconf = jss.MoonyardConf(base=jss.BaseTerrainGeneratorConf(**base),
                             is_lab=kind == "lab", is_yard=kind == "yard")
    low_shape = tss.base_noise_shapes(conf.is_lab, conf.is_yard)[0]
    noise = _jax_base_noise(5, low_shape, conf.base.min_elevation, conf.base.max_elevation)
    got = tss.MoonyardGenerator(conf, dtype=torch.float64, device="cpu").randomize(noise)
    want = np.asarray(jss.MoonyardGenerator(jconf).randomize())
    assert got.shape == want.shape == (200, 150)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=CRATER_ATOL)


def test_base_noise_from_a_generator():
    """The base noise drawn from a key (``core.jax_random``, JAX's stream):
    the same key gives the same DEM, another key another."""
    conf = tss.BaseTerrainGeneratorConf(x_size=2.0, y_size=2.0, resolution=0.05)
    a = tss.random_base_terrain(jr.key(1), conf, device="cpu")
    b = tss.random_base_terrain(jr.key(1), conf, device="cpu")
    assert a.shape == (40, 40) and a.dtype == torch.float32 and torch.equal(a, b)
    assert not torch.equal(a, tss.random_base_terrain(jr.key(2), conf, device="cpu"))
    # bicubic overshoot stays within a fraction of the elevation span
    assert float(a.max()) < 1.5 * conf.max_elevation - 0.5 * conf.min_elevation
    with pytest.raises(ValueError, match="key or base_noise"):
        tss.random_base_terrain(None, conf)
