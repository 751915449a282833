"""PyTorch port: the native host runtime (``husky_rover_mppi_isaacsim_torch/
native`` over ``csrc/husky_native.cpp``), its block-store codec and the
streamer's tile pool route, against the JAX package's runtime.

The two libraries are the same C++ built with the same flags: every
function is EQUAL to the JAX one's (distance transforms, the bicubic
upsample, the codec's bytes), and so is the pool route's window on smooth
terrain. With craters, the two packages' crater stamps differ in the last
bits of float32 ``atan2`` / ``exp`` (<= 1e-6 m, tests/test_torch_streaming.py)
and their sum with a ~100 m base rounds to the base's float32 spacing
(7.6e-6 m between 64 and 128 m): the windows agree to 1e-6 m plus one such
spacing. The library is held against the port's plain versions at the
tolerances of the JAX package's tests/test_native.py, and the pool route
against the device route to 2e-5 on that file's streamer (JAX's own
pool-vs-device bound).
"""

import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch import native as tnative
from husky_rover_mppi_isaacsim_torch.ops import cuda_build
from husky_rover_mppi_isaacsim_torch.ops import edt as tedt
from husky_rover_mppi_isaacsim_torch.terrain import database as tdb
from husky_rover_mppi_isaacsim_torch.terrain import map_manager as tmap
from husky_rover_mppi_isaacsim_torch.terrain import rocks as trocks
from husky_rover_mppi_isaacsim_torch.terrain import streaming as tstream
from husky_rover_mppi_isaacsim_torch.terrain import upsample as tup
from husky_rover_mppi_isaacsim_torch.terrain.craters import CraterSamplerConf as TCraterConf
from husky_rover_mppi_isaacsim_tpu import native as jnative
from husky_rover_mppi_isaacsim_tpu.terrain import database as jdb
from husky_rover_mppi_isaacsim_tpu.terrain import map_manager as jmap
from husky_rover_mppi_isaacsim_tpu.terrain import rocks as jrocks
from husky_rover_mppi_isaacsim_tpu.terrain import streaming as jstream
from husky_rover_mppi_isaacsim_tpu.terrain.craters import CraterSamplerConf as JCraterConf

from test_torch_rocks import wait_for_jax_native

torch.set_num_threads(1)

# crater stamps: the packages' float32 renderers, <= 1e-6 m apart per stamp
CRATER_ATOL = 1e-6


def crater_atol(window) -> float:
    """CRATER_ATOL plus the float32 spacing of the window's largest height."""
    return CRATER_ATOL + float(np.spacing(np.float32(np.abs(window).max())))


# the pool route against the device route (tests/test_native.py)
ROUTE_ATOL = 2e-5


@pytest.fixture(autouse=True)
def jax_native():
    wait_for_jax_native()


def _occupancy(rng, shape, share):
    occ = rng.random(shape) < share
    occ[shape[0] // 3, shape[1] // 2] = True  # at least one obstacle
    return occ


@pytest.mark.parametrize("shape", [(40, 56), (96, 64), (1, 9), (33, 1)])
def test_distance_transforms_equal_jax(rng, shape):
    occ = _occupancy(rng, shape, 0.03)
    np.testing.assert_array_equal(tnative.edt_l2(occ), jnative.edt_l2(occ))
    np.testing.assert_array_equal(tnative.edt_l2(occ, squared=True),
                                  jnative.edt_l2(occ, squared=True))
    free = (~occ).astype(np.uint8)
    np.testing.assert_array_equal(tnative.chamfer5(free), jnative.chamfer5(free))
    # a CPU tensor is read as its numpy array
    np.testing.assert_array_equal(tnative.edt_l2(torch.from_numpy(occ)), jnative.edt_l2(occ))


@pytest.mark.parametrize("factor,shape", [(2, (12, 17)), (5, (9, 9)), (200, (9, 9))])
def test_bicubic_upsample_equals_jax(rng, factor, shape):
    src = rng.normal(0.0, 50.0, shape).astype(np.float32)
    got = tnative.bicubic_upsample(src, factor)
    assert got.shape == (shape[0] * factor, shape[1] * factor) and got.dtype == np.float32
    np.testing.assert_array_equal(got, jnative.bicubic_upsample(src, factor))


@pytest.mark.parametrize("tol", [1e-2, 1e-3, 1e-4])
def test_codec_bytes_equal_jax(rng, tol):
    x = np.concatenate([np.cumsum(rng.normal(size=5000)) * 0.01,
                        [0.0, tol / 2, -tol / 2, 1.5 * tol, -2.5 * tol, 123.4565]])
    x = x.astype(np.float32).reshape(-1, 2)
    buf = tnative.compress(x, tol)
    assert buf == jnative.compress(x, tol)
    np.testing.assert_array_equal(tnative.decompress(buf, x.shape, tol),
                                  jnative.decompress(buf, x.shape, tol))
    with pytest.raises(ValueError):
        tnative.compress(np.zeros(4, np.float32), 0.0)


def test_native_holds_against_the_plain_versions(rng):
    """The library against the port's plain versions, at the JAX tests'
    tolerances: the exact EDT (1e-3, and 1e-4 against brute force), the
    numpy chamfer scan (1e-5), the bicubic upsample in torch (1e-5), the
    codec's numpy quantization (equal)."""
    occ = _occupancy(rng, (40, 56), 0.03)
    ys, xs = np.nonzero(occ)
    grid = np.stack(np.meshgrid(np.arange(40), np.arange(56), indexing="ij"), -1).reshape(-1, 2)
    brute = np.sqrt(((grid[:, None, :] - np.stack([ys, xs], -1)[None]) ** 2).sum(-1).min(1))
    np.testing.assert_allclose(tnative.edt_l2(occ), brute.reshape(40, 56), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tnative.edt_l2(occ), tedt.edt_exact(torch.from_numpy(occ)).numpy(),
                               rtol=0, atol=1e-3)
    free = (rng.random((24, 30)) >= 0.05).astype(np.uint8)
    free[10, 12] = 0
    np.testing.assert_allclose(tnative.chamfer5(free), tedt.chamfer5(free), rtol=0, atol=1e-5)
    src = rng.normal(size=(12, 17)).astype(np.float32)
    for factor in (2, 4, 5):
        np.testing.assert_allclose(tnative.bicubic_upsample(src, factor),
                                   tup.upsample_bicubic(torch.from_numpy(src), factor).numpy(),
                                   rtol=0, atol=1e-5)
    x = rng.normal(0.0, 60.0, 999).astype(np.float32)
    np.testing.assert_array_equal(tnative.decompress(tnative.compress(x), x.shape),
                                  tdb.unpack_array(tdb.pack_array(x, 1e-3), 1e-3))


@pytest.mark.parametrize("kind", ["bicubic", "edt", "chamfer"])
def test_tile_pool_jobs_equal_direct_calls(rng, kind):
    srcs = [rng.normal(size=(10, 12)).astype(np.float32) for _ in range(9)]
    if kind == "bicubic":
        code, p0, direct = tnative.BICUBIC, 3, lambda s: tnative.bicubic_upsample(s, 3)
    elif kind == "edt":
        srcs = [(s > 1.2).astype(np.float32) for s in srcs]
        code, p0, direct = tnative.EDT, 1, lambda s: tnative.edt_l2(s > 0.5)
    else:
        srcs = [(s > -1.2).astype(np.float32) for s in srcs]
        code, p0, direct = tnative.CHAMFER, 1, lambda s: tnative.chamfer5(s > 0.5)
    with tnative.TilePool(3) as pool:
        ids = [pool.submit(code, s, p0) for s in srcs]
        results = pool.collect_all(timeout_s=30)
        assert pool.pending() == 0 and pool.jobs == len(srcs)
    assert sorted(results) == sorted(ids)
    for jid, s in zip(ids, srcs):
        np.testing.assert_array_equal(results[jid], direct(s))
    with pytest.raises(RuntimeError, match="closed"):
        pool.submit(code, srcs[0], p0)


def test_tile_pool_shuts_down_with_results_pending(rng):
    pool = tnative.TilePool(2)
    for _ in range(6):
        pool.submit(tnative.BICUBIC, rng.normal(size=(16, 16)).astype(np.float32), 4)
    got = pool.collect(wait_ms=5000)  # one collected, the rest left in the pool
    assert got is not None and got[1].shape == (64, 64)
    pool.close()
    pool.close()  # idempotent
    with pytest.raises(RuntimeError, match="closed"):
        pool.pending()


def test_failed_build_raises_where_the_library_is_used(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(cuda_build, "HOST_CXX", "no-such-cxx")
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "_build_error", None)
    assert not tnative.available()
    assert "no-such-cxx not found" in tnative.build_error()
    for call in (lambda: tnative.edt_l2(np.ones((2, 2), bool)),
                 lambda: tnative.compress(np.zeros(3, np.float32)),
                 lambda: tnative.TilePool(1)):
        with pytest.raises(RuntimeError, match="did not build"):
            call()
    # and the stores, which go through the codec, raise too
    with pytest.raises(RuntimeError, match="did not build"):
        trocks.RockDB().add((0, 0), trocks.RockBlock(*(np.zeros((2, k), np.float32)
                                                       for k in (2, 1, 4, 3)),
                                                     np.zeros(2, np.int32)))
    assert not (tmp_path / "kernels").exists()


def _rock_block(module, seed):
    rng = np.random.default_rng(seed)
    return module.RockBlock(
        coordinates=rng.uniform(-10, 10, (100, 2)).astype(np.float32),
        height=rng.normal(size=100).astype(np.float32),
        quaternion=rng.normal(size=(100, 4)).astype(np.float32),
        scale=rng.uniform(0.05, 0.2, (100, 3)).astype(np.float32),
        ids=rng.integers(0, 16, 100).astype(np.int32))


def test_stores_pack_as_jax_byte_for_byte(tmp_path):
    """A RockDB's and a BlockDB's packed payloads are the JAX stores' bytes
    (the codec's kind "n"); both read back equal; the numpy kind "q" that
    earlier versions of the port packed still reads back."""
    tdbr, jdbr = trocks.RockDB(), jrocks.RockDB(compress=True)
    assert jdbr._native
    tdbr.add((0, 0), _rock_block(trocks, 3))
    jdbr.add((0, 0), _rock_block(jrocks, 3))
    assert tdbr._blocks[(0, 0)] == jdbr._blocks[(0, 0)]
    got, want = tdbr.get((0, 0)), jdbr.get((0, 0))
    for name in ("coordinates", "height", "quaternion", "scale", "ids"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    payload = {"coordinates": np.random.default_rng(1).normal(size=(50, 2)),
               "ids": np.arange(7)}
    tb, jb = tdb.BlockDB(), jdb.BlockDB()
    tb.add((2, -1), payload)
    jb.add((2, -1), payload)
    assert tb._blocks[(2, -1)] == jb._blocks[(2, -1)]
    assert tb._blocks[(2, -1)]["coordinates"][0] == "n"
    for name in payload:
        np.testing.assert_array_equal(tb.get((2, -1))[name], jb.get((2, -1))[name])
    tb._blocks[(5, 5)] = {"coordinates": tdb.pack_array(payload["coordinates"], 1e-3)}
    np.testing.assert_array_equal(tb.get((5, 5))["coordinates"],
                                  tb.get((2, -1))["coordinates"])
    tb.save_to_disk(str(tmp_path / "db"))
    back = jdb.BlockDB()
    back.load_from_disk(str(tmp_path / "db"))
    np.testing.assert_array_equal(back.get((2, -1))["coordinates"],
                                  tb.get((2, -1))["coordinates"])


def _streamer_pair(native_pool, craters):
    kw = dict(block_size=10.0, resolution=0.1, lr_resolution=2.0, num_blocks=1, pad_size=2.0,
              seed=57, generate_craters=craters)
    lr = jmap.synthetic_lola_dem(256, 2.0, seed=42)
    np.testing.assert_array_equal(lr, tmap.synthetic_lola_dem(256, 2.0, seed=42))
    js = jstream.TerrainStreamer(jstream.StreamerConf(
        crater=JCraterConf(seed=57), native_pool=native_pool, **kw), lr)
    ts = tstream.TerrainStreamer(tstream.StreamerConf(
        crater=TCraterConf(seed=57), native_pool=native_pool, **kw), lr, device="cpu")
    return js, ts


@pytest.mark.parametrize("craters", [False, True], ids=["smooth", "craters"])
def test_pool_route_equals_jax_pool_route(craters):
    """On the CPU ("auto") both streamers upsample on their tile pools:
    equal windows on smooth terrain at the first update and after a shift
    (the entering band and the prefetch through the pool), equal crater
    metadata; with craters within :func:`crater_atol`."""
    js, ts = _streamer_pair("auto", craters)
    assert js._get_pool() is not None
    atol = 0.0
    for pos in ((0.0, 0.0), (12.0, 0.0), (12.0, -11.0)):
        assert ts.update(pos) == js.update(pos)
        assert ts.anchor == js.anchor
        atol = crater_atol(js.window) if craters else 0.0
        np.testing.assert_allclose(ts.window.numpy(), np.asarray(js.window), rtol=0, atol=atol)
    assert sorted(ts.block_cache) == sorted(js.block_cache)
    for key, blk in js.block_cache.items():
        np.testing.assert_allclose(ts.block_cache[key].numpy(), np.asarray(blk), rtol=0,
                                   atol=atol)
    assert list(ts.crater_blocks) == list(js.crater_blocks)
    assert ts.rng.bit_generator.state == js.rng.bit_generator.state
    pool = ts.tile_pool()
    assert pool.jobs == len(ts.block_cache) and pool.collect_s > 0.0
    ts.close()
    assert ts._pool is None


# the LR DEMs of the pool-vs-device comparison: the JAX test's unit-normal
# 64^2 DEM at its bound, and the streamed loop's synthetic LOLA stand-in
# (heights of ~100 m) at tests/test_torch_streaming.py's HEIGHT_ATOL, whose
# float32 upsample sums round in another order on the two routes (the bound
# chip_smoke.py holds the 7000^2 window's two routes to)
ROUTE_DEMS = {"unit_normal": ROUTE_ATOL, "synthetic_lola": 1e-4}


@pytest.mark.parametrize("dem", sorted(ROUTE_DEMS))
def test_pool_route_agrees_with_the_device_route(rng, dem):
    """The port's two routes on the JAX test's streamer
    (tests/test_native.py::test_streamer_consumes_tile_pool: 10 m blocks at
    0.5 m/px, craters): within ``ROUTE_DEMS[dem]`` at the first update and
    after a shift, crater metadata equal. "auto" takes the pool on the CPU,
    "never" does not."""
    if dem == "unit_normal":
        lr = rng.normal(size=(64, 64)).astype(np.float32)
    else:
        lr = tmap.synthetic_lola_dem(64, 2.0, seed=42)

    def make(native_pool):
        conf = tstream.StreamerConf(block_size=10.0, resolution=0.5, lr_resolution=2.0,
                                    num_blocks=1, pad_size=2.0, generate_craters=True,
                                    native_pool=native_pool)
        return tstream.TerrainStreamer(conf, lr, device="cpu")

    pool, dev = make("always"), make("never")
    for pos in ((0.0, 0.0), (12.0, 0.0)):
        pool.update(pos)
        dev.update(pos)
        np.testing.assert_allclose(pool.window.numpy(), dev.window.numpy(), rtol=0,
                                   atol=ROUTE_DEMS[dem])
    assert list(pool.crater_blocks) == list(dev.crater_blocks)
    assert dev.tile_pool() is None and pool.tile_pool() is not None
    assert make("auto").tile_pool() is not None
    # the host copy the pool reads follows a new LR DEM
    pool.lr_dem = np.zeros((64, 64))
    assert pool._lr_patch_host(0, 0).shape == (9, 9) and not pool._lr_patch_host(0, 0).any()
    pool.close()


def test_prestage_takes_the_pool_route():
    """A staged shift builds its entering blocks through the pool, and the
    swapped-in stage equals the shift's own compose."""
    _, ts = _streamer_pair("always", False)
    ts.update((0.0, 0.0))
    before = ts.tile_pool().jobs
    ts.prestage_shift((ts.anchor[0] + 1, ts.anchor[1]))
    assert ts.tile_pool().jobs == before + ts.conf.blocks_per_side
    ts.verify_stage = True
    assert ts.update((12.0, 0.0))
    assert ts.staged_shift_hits == ts.staged_shift_verified == 1
    ts.close()


def test_cli_streamer_override_reaches_the_loop():
    """``terrain_streamer.native_pool`` / ``native_pool_workers`` of the
    composed tree reach the streamed loop's streamer (the JAX CLI reads
    that section nowhere); without them the JAX default "auto" stands."""
    from husky_rover_mppi_isaacsim_torch import cli

    tree = cli.compose(["mode=largescale", "terrain_streamer.native_pool=always",
                        "terrain_streamer.native_pool_workers=3"])
    sconf = cli.largescale_conf(tree).terrain.streamer_conf
    assert (sconf.native_pool, sconf.native_pool_workers) == ("always", 3)
    assert cli.largescale_conf(cli.compose(["mode=largescale"])).terrain.streamer_conf \
        .native_pool == "auto"
    sconf = cli.largescale_conf({"terrain_streamer": {"native_pool": "never"}}).terrain \
        .streamer_conf
    assert (sconf.native_pool, sconf.native_pool_workers) == ("never", 8)
    with pytest.raises(ValueError, match="native_pool"):
        cli.compose(["mode=largescale", "terrain_streamer.native_pool=sometimes"])
