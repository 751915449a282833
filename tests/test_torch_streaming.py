"""PyTorch port: the terrain streamer (``terrain/streaming.py``), the bicubic
upsample and the point samplers against the JAX package, float32, on the JAX
tests' tiny geometry (10 m blocks at 0.1 m/px, a 5-block window).

Crater metadata must be EQUAL after the same visit sequence: it comes from one
numpy generator consumed in build order. Heights are EQUAL too: the port's
float32 upsample and crater render evaluate each operation as XLA's CPU code
does (``core/xla_math.py``; both streamers take the device route here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch import convert
from husky_rover_mppi_isaacsim_torch.terrain import map_manager as tmap
from husky_rover_mppi_isaacsim_torch.terrain import streaming as tstream
from husky_rover_mppi_isaacsim_torch.terrain import upsample as tup
from husky_rover_mppi_isaacsim_torch.terrain.craters import CraterSamplerConf as TCraterConf
from husky_rover_mppi_isaacsim_tpu.terrain import map_manager as jmap
from husky_rover_mppi_isaacsim_tpu.terrain import streaming as jstream
from husky_rover_mppi_isaacsim_tpu.terrain import upsample as jup
from husky_rover_mppi_isaacsim_tpu.terrain.craters import CraterSamplerConf as JCraterConf

torch.set_num_threads(1)



def _confs(craters=True, prefetch=True):
    kw = dict(block_size=10.0, resolution=0.1, lr_resolution=2.0, num_blocks=1, pad_size=2.0,
              seed=57, generate_craters=craters, prefetch=prefetch)
    return (jstream.StreamerConf(crater=JCraterConf(seed=57), native_pool="never", **kw),
            tstream.StreamerConf(crater=TCraterConf(seed=57), native_pool="never", **kw))


def _streamers(craters=True, prefetch=True):
    lr = jmap.synthetic_lola_dem(256, 2.0, seed=42)
    np.testing.assert_array_equal(lr, tmap.synthetic_lola_dem(256, 2.0, seed=42))
    jconf, tconf = _confs(craters, prefetch)
    return jstream.TerrainStreamer(jconf, lr), tstream.TerrainStreamer(tconf, lr, device="cpu")


def _assert_same_craters(ts, js):
    assert list(ts.crater_blocks) == list(js.crater_blocks)  # same blocks, same order
    for key, (coords, radii) in js.crater_blocks.items():
        np.testing.assert_array_equal(ts.crater_blocks[key][0], coords)
        np.testing.assert_array_equal(ts.crater_blocks[key][1], radii)
    assert ts.rng.bit_generator.state == js.rng.bit_generator.state


@pytest.mark.parametrize("factor,shape", [(20, (9, 9)), (3, (7, 12)), (8, (5, 5))])
def test_upsample_bicubic_matches_jax(rng, factor, shape):
    lr = rng.normal(0.0, 50.0, shape).astype(np.float32)
    got = tup.upsample_bicubic(torch.from_numpy(lr), factor)
    want = np.asarray(jup.upsample_bicubic(jnp.asarray(lr), factor))
    assert tuple(got.shape) == want.shape == (shape[0] * factor, shape[1] * factor)
    np.testing.assert_array_equal(got.numpy(), want)  # XLA's dot: JAX's bits
    # float64: the same weights, so only the order of four sums differs
    got64 = tup.upsample_bicubic(torch.from_numpy(lr.astype(np.float64)), factor)
    want64 = np.asarray(jup.upsample_bicubic(jnp.asarray(lr, jnp.float64), factor))
    np.testing.assert_allclose(got64.numpy(), want64, rtol=0, atol=1e-12)


@pytest.mark.parametrize("sampler", ["bilinear_point_sample", "bicubic_point_sample"])
def test_point_samplers_match_jax(rng, sampler):
    z = rng.normal(size=(40, 30))
    x, y = rng.uniform(-3.0, 43.0, 200), rng.uniform(-3.0, 33.0, 200)  # off the grid too
    got = getattr(tup, sampler)(torch.from_numpy(z), torch.from_numpy(x), torch.from_numpy(y))
    want = getattr(jup, sampler)(jnp.asarray(z), jnp.asarray(x), jnp.asarray(y))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)


def test_streamer_conf_geometry_and_refusals():
    jconf, tconf = _confs()
    for name in ("blocks_per_side", "block_px", "window_px", "window_size", "upscale_factor",
                 "pad_px"):
        assert getattr(tconf, name) == getattr(jconf, name), name
    # the tile pool route takes JAX's three modes, "auto" by default
    assert tstream.StreamerConf().native_pool == jstream.StreamerConf().native_pool == "auto"
    for mode in ("auto", "always", "never"):
        assert tstream.StreamerConf(native_pool=mode).native_pool == mode
    with pytest.raises(ValueError, match="native_pool"):
        tstream.StreamerConf(native_pool="sometimes")
    with pytest.raises(ValueError, match="integer multiple"):
        tstream.StreamerConf(resolution=0.3, lr_resolution=5.0)
    assert callable(tstream.TerrainStreamer.prestage_shift)


@pytest.mark.parametrize("craters", [False, True], ids=["smooth", "craters"])
def test_built_block_matches_jax(craters):
    js, ts = _streamers(craters)
    for key in ((0, 0), (-2, 3)):
        want = np.asarray(js.build_block(*key))
        got = ts.build_block(*key)
        assert got.is_contiguous() and tuple(got.shape) == want.shape == (100, 100)
        np.testing.assert_array_equal(got.numpy(), want)
        assert ts.build_block(*key) is got  # cached
    _assert_same_craters(ts, js)
    if craters:
        tiers_t, tiers_j = ts._block_fields(0, 0), js._block_fields(0, 0)
        assert ts._tier_specs == js._tier_specs
        n_j = [int(np.asarray(f.mask).sum()) for f, _ in tiers_j]
        # one tier each, padded to JAX's capacity, the live rows first
        assert [(f.mask.shape[0], p) for f, p in tiers_t] == [
            (f.mask.shape[0], p) for f, p in tiers_j] == [(c, p) for _, c, p in ts._tier_specs]
        assert [int(f.mask.sum()) for f, _ in tiers_t] == n_j
        for (ft, _), (fj, _), n in zip(tiers_t, tiers_j, n_j):
            assert bool(ft.mask[:n].all()) and not bool(ft.mask[n:].any())
            for a, b in zip(ft, fj):
                np.testing.assert_array_equal(a.numpy()[:n], np.asarray(b)[:n])
        assert sum(n_j) > 20


# the visit sequence: the first window, then +x, -y and a diagonal shift, a
# move inside the center block (no shift) and a jump of more than a window
VISITS = [(5.0, 5.0), (12.0, 5.0), (12.0, -3.0), (27.0, -12.0), (28.0, -13.0), (95.0, 95.0)]


@pytest.mark.parametrize("prefetch", [True, False], ids=["prefetch", "no_prefetch"])
def test_windows_and_crater_metadata_after_the_same_visits(prefetch):
    js, ts = _streamers(True, prefetch)
    for pos in VISITS:
        assert ts.update(pos) == js.update(pos), pos
        assert ts.anchor == js.anchor and ts.window_origin() == js.window_origin()
        _assert_same_craters(ts, js)
        assert list(ts.block_cache) == list(js.block_cache)
        np.testing.assert_array_equal(ts.window.numpy(), np.asarray(js.window), err_msg=str(pos))
    assert ts.shift_count == js.shift_count == 5
    # a rolled window is the window a full rebuild at the same anchor gives
    fresh = tstream.TerrainStreamer(ts.conf, ts.lr_dem.numpy(), device="cpu")
    fresh.crater_blocks = dict(ts.crater_blocks)
    fresh.update(VISITS[-1])
    assert torch.equal(fresh.window, ts.window)


def test_window_queries_match_jax(rng):
    js, ts = _streamers(True)
    js.update((5.0, 5.0))
    ts.update((5.0, 5.0))
    x, y = rng.uniform(-19.0, 29.0, (2, 300))
    np.testing.assert_allclose(ts.get_height(x, y).numpy(), np.asarray(js.get_height(x, y)),
                               rtol=0, atol=2e-4)
    np.testing.assert_allclose(ts.get_normal(x, y).numpy(), np.asarray(js.get_normal(x, y)),
                               rtol=0, atol=2e-3)  # differences of 1e-4 m over 0.1 m cells
    assert ts.get_height(x, y).dtype == torch.float32
    assert ts.block_index((-0.5, 10.0)) == js.block_index((-0.5, 10.0)) == (-1, 1)


def test_jax_streamer_continues_in_the_port():
    """``convert.streamer_state_from_numpy``: a JAX-built streamer's state,
    loaded into the port's, draws the same craters at the next shift and
    composes the same window."""
    js, ts = _streamers(True)
    js.update((5.0, 5.0))
    convert.streamer_state_from_numpy(
        ts, np.asarray(js.lr_dem), js.anchor, js.crater_blocks, js.rng.bit_generator.state,
        np.asarray(js.window), {k: np.asarray(b) for k, b in js.block_cache.items()})
    assert ts.anchor == js.anchor and list(ts.block_cache) == list(js.block_cache)
    np.testing.assert_array_equal(ts.window.numpy(), np.asarray(js.window))
    for pos in ((15.0, 5.0), (25.0, 15.0)):
        assert ts.update(pos) and js.update(pos)
        _assert_same_craters(ts, js)
        np.testing.assert_array_equal(ts.window.numpy(), np.asarray(js.window))
    # what was carried over was not rebuilt: the kept part of the window is
    # the JAX package's bits
    kept = np.asarray(js.window)[:300, :400]
    np.testing.assert_array_equal(ts.window.numpy()[:300, :400], kept)


def test_crater_db_round_trip_and_region_sampling(tmp_path):
    js, ts = _streamers(True)
    assert ts.sample_craters_by_region(-2, 2, -1, 3) == js.sample_craters_by_region(-2, 2, -1, 3)
    ts._sample_block_craters(5, 5)
    js._sample_block_craters(5, 5)
    assert ts.sample_craters_by_region(3, 7, 3, 7) == js.sample_craters_by_region(3, 7, 3, 7)
    _assert_same_craters(ts, js)
    ts.save_crater_db(str(tmp_path / "db"))
    other = _streamers(True)[1]
    other.load_crater_db(str(tmp_path / "db"))
    assert other.crater_blocks.keys() == ts.crater_blocks.keys()
    for key, (coords, radii) in ts.crater_blocks.items():
        np.testing.assert_array_equal(other.crater_blocks[key][0], coords)
        np.testing.assert_array_equal(other.crater_blocks[key][1], radii)


@pytest.mark.parametrize("stage,move", [((1, 0), (1, 0)), ((0, -1), (0, -1)), ((1, 1), (1, 1)),
                                        ((1, 0), (1, 1)), ((-1, 0), (0, 1))],
                         ids=["x_hit", "minus_y_hit", "diagonal_hit", "diagonal_miss", "miss"])
def test_prestaged_shift_matches_jax(stage, move):
    """``prestage_shift`` then the shift, in both packages: the stage draws
    the entering blocks' craters when it is made, in the shift's order, so
    crater metadata and the generator's state stay EQUAL after the stage
    and after the shift; the staged window is swapped in where the anchor
    is the one staged (a hit in both), and the window is JAX's."""
    js, ts = _streamers(True)
    start = (5.0, 5.0)
    js.update(start)
    ts.update(start)
    a = ts.anchor
    new = (a[0] + stage[0], a[1] + stage[1])
    js.prestage_shift(new)
    ts.prestage_shift(new)
    _assert_same_craters(ts, js)
    assert list(ts.block_cache) == list(js.block_cache)
    ts.prestage_shift(new)  # already staged from this window: nothing more is drawn
    _assert_same_craters(ts, js)
    target = (start[0] + 10.0 * move[0], start[1] + 10.0 * move[1])
    assert ts.update(target) and js.update(target)
    assert ts.staged_shift_hits == js.staged_shift_hits == int(stage == move)
    _assert_same_craters(ts, js)
    np.testing.assert_array_equal(ts.window.numpy(), np.asarray(js.window))
    # the swapped-in window is the one the shift composes
    fresh = tstream.TerrainStreamer(ts.conf, ts.lr_dem.numpy(), device="cpu")
    fresh.crater_blocks = dict(ts.crater_blocks)
    fresh.update(target)
    assert torch.equal(fresh.window, ts.window)


def test_stage_of_a_window_written_in_place_is_never_swapped_in():
    """The stage is keyed on the source window's identity AND its version:
    after an in-place write (a deformation stamp) the shift composes from
    the written window instead of swapping the stale stage in; a stage made
    after the write is swapped in."""
    _, ts = _streamers(False)
    ts.update((5.0, 5.0))
    a = ts.anchor
    new = (a[0] + 1, a[1])
    ts.prestage_shift(new)
    stale = ts._staged_shift[1]
    ts.window[150:160] += 1.0  # rows that the +x shift keeps
    assert ts.update((15.0, 5.0)) and ts.staged_shift_hits == 0
    assert not torch.equal(ts.window, stale)
    assert torch.equal(ts.window[50:60], stale[50:60] + 1.0)
    ts.prestage_shift((new[0] + 1, new[1]))
    ts.window[0:10] -= 1.0  # rows that the next shift drops
    ts.prestage_shift((new[0] + 1, new[1]))  # re-staged from the written window
    staged = ts._staged_shift[1]
    assert ts.update((25.0, 5.0)) and ts.staged_shift_hits == 1 and ts.window is staged
