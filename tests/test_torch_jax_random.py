"""PyTorch port: JAX's counter-based stream (``core.jax_random``) against
``jax.random`` (partitionable threefry2x32, jax's default), and the worlds
drawn from it against the JAX package's, with nothing injected.

Key data (``key``, ``split``, ``fold_in``) and the 32- and 64-bit words are
equal. ``uniform`` is bit-equal in float32. In float64 a draw may differ by
one unit in the last place of the product ``floats * (max - min)``: XLA
fuses ``floats * (max - min) + min`` into one rounding, torch rounds the
product and the sum apart, and no float64 intermediate holds the product
exactly (in float32 one does, and the port rounds once from it).

The worlds: the thesis statistics DEM, the moonyard's yard and lab DEMs
(two ``randomize`` calls: the generator's key is split at each) and the
rocks' tangent quaternions, against JAX's at the tolerances of
tests/test_torch_smallscale.py and tests/test_torch_rocks.py. JAX's float32
worlds are built with x64 off (``jax.enable_x64(False)``, a context), as
the JAX package builds them outside the tests; the float64 ones with the
tests' x64 on. The thesis DEM's statistics at z = 0.7 are
``EVAL_r05.json``'s at their printed digits."""

import ast
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bench_torch
from husky_rover_mppi_isaacsim_torch.core import jax_random as jr
from husky_rover_mppi_isaacsim_torch.core.heightfield import HeightField as THeightField
from husky_rover_mppi_isaacsim_torch.mppi import thesis_runs
from husky_rover_mppi_isaacsim_torch.terrain import rocks as trocks
from husky_rover_mppi_isaacsim_torch.terrain import smallscale as tss
from husky_rover_mppi_isaacsim_tpu.core.heightfield import HeightField as JHeightField
from husky_rover_mppi_isaacsim_tpu.terrain import rocks as jrocks
from husky_rover_mppi_isaacsim_tpu.terrain import smallscale as jss

from test_torch_rocks import CONF as ROCK_CONF
from test_torch_smallscale import CRATER_ATOL
from test_torch_streaming import _streamers

REPO = Path(__file__).resolve().parents[1]
SEEDS = (0, 7, 42, 99, 123456)
SHAPES = ((4, 4), (100, 100), (4096, 2), (3,), (5, 5))
# fold_in data: negative (a block index; JAX wraps int32 data to uint32)
# and at or above 2^31
FOLD_DATA = (0, 1, 12345, -1, -7, -(2 ** 31), 2 ** 31, 2 ** 32 - 1)
# the stored rocks' floats are multiples of the codec's 1e-3: a quaternion
# component within 1e-6 of JAX's may round to the neighbouring step
CODEC_ATOL = 1.1e-3


def _data(k):
    return np.asarray(jax.random.key_data(k)).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS + (2 ** 33 + 5,))
def test_key_split_and_fold_in_match_jax(seed):
    k, t = jax.random.key(seed), jr.key(seed)
    np.testing.assert_array_equal(t.numpy(), _data(k))
    for n in (2, 3, 5):
        np.testing.assert_array_equal(jr.split(t, n).numpy(), _data(jax.random.split(k, n)))
    for d in FOLD_DATA:
        jd = np.int32(d) if d < 0 else np.uint32(d)
        np.testing.assert_array_equal(jr.fold_in(t, d).numpy(),
                                      _data(jax.random.fold_in(k, jd)), err_msg=str(d))
    # a batch of data folds in row by row, as jax.vmap does
    data = np.array([3, -2, 0, 7], np.int32)
    want = np.stack([_data(jax.random.fold_in(k, d)) for d in data])
    np.testing.assert_array_equal(jr.fold_in(t, torch.from_numpy(data)).numpy(), want)


@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits_match_jax(seed):
    k, t = jax.random.key(seed), jr.key(seed)
    for shape in SHAPES:
        np.testing.assert_array_equal(jr.random_bits(t, 32, shape).numpy(),
                                      np.asarray(jax.random.bits(k, shape, jnp.uint32)))
        np.testing.assert_array_equal(
            jr.random_bits(t, 64, shape).numpy(),
            np.asarray(jax.random.bits(k, shape, jnp.uint64)).view(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-1.2, 1.2), (-50.0, 50.0), (-0.012, 0.0084)])
def test_uniform_matches_jax(seed, lo, hi):
    k, t = jax.random.key(seed), jr.key(seed)
    for shape in SHAPES:
        want = np.asarray(jax.random.uniform(k, shape, jnp.float32, lo, hi))
        got = jr.uniform(t, shape, torch.float32, lo, hi)
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), want)
        # float64: within one unit in the last place of the product (see
        # the module's note); most draws are equal
        want = np.asarray(jax.random.uniform(k, shape, jnp.float64, lo, hi))
        got = jr.uniform(t, shape, torch.float64, lo, hi).numpy()
        assert np.abs(got - want).max() <= np.spacing(np.float64(hi - lo))
        assert got.min() >= lo and got.max() < hi


def test_uniform_on_a_batch_of_keys_is_jax_vmap():
    keys = jax.random.split(jax.random.key(11), 6)
    want = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (3,), jnp.float32, -1, 1))(keys))
    got = jr.uniform(torch.from_numpy(_data(keys)), (3,), torch.float32, -1.0, 1.0)
    assert tuple(got.shape) == (6, 3)
    np.testing.assert_array_equal(got.numpy(), want)


def test_thesis_terrain_matches_jax():
    """The seed-42 thesis DEM (a 20 m cut) from its seed alone: float32 as
    the JAX package builds it (x64 off), and float64."""
    with jax.enable_x64(False):
        want = np.asarray(jss.thesis_statistics_terrain(seed=42, size_m=20.0))
    got = tss.thesis_statistics_terrain(seed=42, size_m=20.0, device="cpu")
    assert want.dtype == np.float32 and got.dtype == torch.float32
    assert got.shape == want.shape == (200, 200)
    np.testing.assert_array_equal(got.numpy(), want)
    want = np.asarray(jss.thesis_statistics_terrain(seed=42, size_m=20.0))
    got = tss.thesis_statistics_terrain(seed=42, size_m=20.0, dtype=torch.float64, device="cpu")
    assert want.dtype == np.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=CRATER_ATOL)


@pytest.mark.parametrize("kind", ["yard", "lab", "moonyard"])
def test_moonyard_generator_matches_jax(kind):
    """Two frames of each generator from its seed: the key is split at
    every ``randomize``, as JAX's is."""
    base = dict(x_size=4.0, y_size=3.0, resolution=0.02, seed=5)
    flags = dict(is_lab=kind == "lab", is_yard=kind == "yard")
    conf = tss.MoonyardConf(base=tss.BaseTerrainGeneratorConf(**base), **flags)
    jconf = jss.MoonyardConf(base=jss.BaseTerrainGeneratorConf(**base), **flags)
    with jax.enable_x64(False):
        jgen = jss.MoonyardGenerator(jconf)
        want = [np.asarray(jgen.randomize()) for _ in range(2)]
    gen = tss.MoonyardGenerator(conf, device="cpu")
    got = [gen.randomize() for _ in range(2)]
    assert not np.array_equal(want[0], want[1])
    for a, b in zip(got, want):
        assert a.dtype == torch.float32 and a.shape == b.shape == (200, 150)
        np.testing.assert_array_equal(a.numpy(), b)


def test_thesis_terrain_statistics_are_eval_r05s():
    """The seed-42 thesis DEM at z = 0.7 (150 m at 0.1 m/px) on the CPU:
    its statistics are ``EVAL_r05.json``'s, digit for digit."""
    want = json.loads((REPO / "EVAL_r05.json").read_text())["terrain_stats"]
    assert thesis_runs.terrain_stats(0.7, device="cpu") == want


def test_orientation_from_normal_draws_match_jax(rng):
    normal = np.abs(rng.normal(size=(40, 3))) * [0.2, 0.2, 1.0] * [1.0, -1.0, 1.0]
    normal = (normal / np.linalg.norm(normal, axis=-1, keepdims=True)).astype(np.float32)
    key = jax.random.key(5)
    draws = np.asarray(jax.random.uniform(key, (40, 3), jnp.float32, -1.0, 1.0))
    np.testing.assert_array_equal(trocks.tangent_draws((40,), jr.key(5)).numpy(), draws)
    got = trocks.orientation_from_normal(torch.from_numpy(normal), jr.key(5))
    want = jrocks.orientation_from_normal(jnp.asarray(normal), key)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


def test_rock_tangent_draws_are_jax_per_rock_draws():
    blk = np.array([[3, -2]] * 4 + [[-1, 5]] * 3 + [[0, 0]], np.int32)
    idx = np.array([0, 1, 2, 3, 0, 1, 2, 0], np.int32)
    for dtype, jdtype in ((torch.float32, jnp.float32), (torch.float64, jnp.float64)):
        want = np.asarray(jrocks._per_rock_rand(jax.random.key(67), jnp.asarray(blk),
                                                jnp.asarray(idx), jdtype))
        got = trocks.rock_tangent_draws(67, blk, idx, dtype).numpy()
        if dtype == torch.float32:
            np.testing.assert_array_equal(got, want)
        else:
            assert np.abs(got - want).max() <= np.spacing(2.0)


def test_rock_quaternions_on_a_fixed_heightfield_match_jax(rng):
    z = rng.normal(0.0, 0.3, (120, 120)).astype(np.float32)
    jhf = JHeightField.create(jnp.asarray(z), 30.0)
    thf = THeightField.create(torch.from_numpy(z), 30.0)
    jsamp = jrocks.RockSampler(jrocks.RockDistConf(**ROCK_CONF), jhf)
    tsamp = trocks.RockSampler(trocks.RockDistConf(**ROCK_CONF), thf)
    want = jsamp.sample_region((2.0, -3.0), 1)
    got = tsamp.sample_region((2.0, -3.0), 1)
    assert got.quaternion.shape == want.quaternion.shape and got.quaternion.shape[0] > 10
    np.testing.assert_allclose(got.quaternion, want.quaternion, rtol=0, atol=CODEC_ATOL)
    # before the store: the query's quaternions at the math's float32 bound
    blk = np.array([[0, -1]] * 5 + [[1, 0]] * 3, np.int32)
    idx = np.array([0, 1, 2, 3, 4, 0, 1, 2], np.int32)
    xy = rng.uniform(-20.0, 20.0, (8, 2)).astype(np.float32)
    _, jq = jsamp._batched_query(xy, blk, idx)
    _, tq = tsamp._surface_query(xy, trocks.rock_tangent_draws(67, blk, idx))
    np.testing.assert_allclose(tq, np.asarray(jq), rtol=0, atol=1e-6)


def test_rock_quaternions_on_a_stream_match_jax():
    js, ts = _streamers(craters=False)
    js.update((5.0, 5.0))
    ts.update((5.0, 5.0))
    want = jrocks.RockSampler(jrocks.RockDistConf(**ROCK_CONF), js).sample_region((4.0, 6.0), 1)
    got = trocks.RockSampler(trocks.RockDistConf(**ROCK_CONF), ts).sample_region((4.0, 6.0), 1)
    assert got.quaternion.shape == want.quaternion.shape and got.quaternion.shape[0] > 10
    # the streamers' normals agree to 1e-3 (tests/test_torch_rocks.py), then
    # the codec's step
    np.testing.assert_allclose(got.quaternion, want.quaternion, rtol=0, atol=2e-3 + CODEC_ATOL)


def test_vec_env_start_is_bench_pys():
    """bench_torch's vec-env starts are bench.py's draw (bench.py:128-129);
    its closed loop's start and goal are bench.py's numpy draw."""
    z = np.zeros((64, 64), np.float32)
    state, _ = bench_torch.vec_env_start(THeightField.create(torch.from_numpy(z), 60.0), 4096)
    want = np.asarray(jax.random.uniform(jax.random.key(0), (4096, 2), jnp.float32, -50.0, 50.0))
    np.testing.assert_array_equal(state.position.numpy(), want)

    def draws(path):
        fn = next(n for n in ast.walk(ast.parse((REPO / path).read_text()))
                  if isinstance(n, ast.FunctionDef) and n.name == "bench_closed_loop")
        return [ast.unparse(n.value) for n in ast.walk(fn) if isinstance(n, ast.Assign)
                and ast.unparse(n.targets[0]) in ("rng", "starts")]

    assert draws("bench_torch.py") == draws("bench.py") == [
        "np.random.default_rng(0)", "rng.uniform(-40, 40, (1, 2))"]
