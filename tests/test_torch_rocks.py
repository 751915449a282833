"""PyTorch port: rock sampling (``terrain/rocks.py``), the Thomas process and
the block stores against the JAX package.

Rock positions, scales and ids are numpy draws from generators keyed by
(seed, block): EQUAL in both packages, also after the store's fixed-accuracy
codec (multiples of 1e-3; each package's C++ runtime, with the port's
numpy quantization held against it as its plain version). Heights agree to
1.1e-3 m: both are stored as multiples of 1e-3, and a height within 1e-4 m
of a rounding boundary may land on either side. Quaternions come from ``jax.random`` there and a
``torch.Generator`` here: the math is compared on injected draws, 1e-6 in
float32.
"""

import ctypes
import fcntl
import os
import tempfile
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch import convert
from husky_rover_mppi_isaacsim_torch.core import jax_random as jr
from husky_rover_mppi_isaacsim_torch.core.heightfield import HeightField as THeightField
from husky_rover_mppi_isaacsim_torch.terrain import database as tdb
from husky_rover_mppi_isaacsim_torch.terrain import point_process as tpp
from husky_rover_mppi_isaacsim_torch.terrain import rocks as trocks
from husky_rover_mppi_isaacsim_tpu import native as jnative
from husky_rover_mppi_isaacsim_tpu.core.heightfield import HeightField as JHeightField
from husky_rover_mppi_isaacsim_tpu.terrain import database as jdb
from husky_rover_mppi_isaacsim_tpu.terrain import point_process as jpp
from husky_rover_mppi_isaacsim_tpu.terrain import rocks as jrocks

from test_torch_streaming import _streamers

torch.set_num_threads(1)

CONF = dict(parent_density=0.005, child_density=3.0, sigma=2.0, scale_min=0.3, scale_max=0.5,
            block_size=10.0, seed=67)


NATIVE_WAIT_S = 300.0


def _native_library_stale() -> bool:
    """The JAX package's shared library is missing or older than its source."""
    try:
        return os.path.getmtime(jnative._LIB_PATH) < os.path.getmtime(jnative._SRC)
    except OSError:
        return True


def _native_library_ready() -> bool:
    """The library is newer than its source and loads in a fresh
    ``ctypes.CDLL`` (a half-written file does not)."""
    if _native_library_stale():
        return False
    try:
        ctypes.CDLL(jnative._LIB_PATH)
        return True
    except OSError:
        return False


def wait_for_jax_native() -> None:
    """Make the JAX package's C++ runtime available in this process. Test
    processes that start together all build the library at once, each
    writing the same file, and a process that loaded a half-written one
    keeps that failure for its life. So: take a lock shared by the
    processes of this machine, wait (at most ``NATIVE_WAIT_S``) until the
    library is complete, building it when nobody else has, then forget the
    cached failure and load it again. Fails with the build error only after
    the wait."""
    if jnative.available():
        return
    deadline = time.monotonic() + NATIVE_WAIT_S
    lock = os.path.join(tempfile.gettempdir(), "husky_native_build.lock")
    with open(lock, "a") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            while True:
                if _native_library_stale():
                    try:
                        jnative._compile()
                    except Exception:  # noqa: BLE001 - another process may be writing it
                        pass
                if _native_library_ready() or time.monotonic() > deadline:
                    break
                time.sleep(0.5)
            jnative._lib, jnative._build_error = None, None
            assert jnative.available(), (
                f"the JAX package's C++ runtime is not built: {jnative._build_error}")
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


@pytest.fixture(autouse=True)
def needs_native_codec():
    """The JAX stores go through the C++ codec when it is built (else
    float16, which the port does not imitate): wait for it."""
    wait_for_jax_native()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_thomas_point_process_equals_jax(seed):
    region = (-5.0, 20.0, 3.0, 28.0)
    got = tpp.thomas_point_process(np.random.default_rng(seed), tpp.BoundingBox(*region),
                                   0.01, 4.0, 3.0)
    want = jpp.thomas_point_process(np.random.default_rng(seed), jpp.BoundingBox(*region),
                                    0.01, 4.0, 3.0)
    assert got.shape[0] > 5
    np.testing.assert_array_equal(got, want)


def test_fixed_accuracy_codec_equals_the_native_one(rng):
    x = np.concatenate([rng.normal(0.0, 60.0, 500), [0.0, 0.0005, -0.0005, 0.0015, -2.5e-3,
                                                     1e-9, 123.4565]]).astype(np.float32)
    want = jnative.decompress(jnative.compress(x, 1e-3), x.shape, 1e-3)
    got = tdb.unpack_array(tdb.pack_array(x, 1e-3), 1e-3)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and np.abs(got - x).max() <= 5.1e-4
    ids = rng.integers(0, 16, 40).astype(np.int32)
    np.testing.assert_array_equal(tdb.unpack_array(tdb.pack_array(ids, 1e-3), 1e-3), ids)


def test_quaternion_math_matches_jax_on_injected_draws(rng):
    normal = rng.normal(size=(50, 3)) * [0.2, 0.2, 1.0]
    normal = (normal / np.linalg.norm(normal, axis=-1, keepdims=True)).astype(np.float32)
    rand = rng.uniform(-1.0, 1.0, (50, 3)).astype(np.float32)
    got = trocks.quat_from_normal_and_rand(torch.from_numpy(normal), torch.from_numpy(rand))
    want = jrocks._quat_from_normal_and_rand(jnp.asarray(normal), jnp.asarray(rand))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, atol=1e-6)


def test_tangent_draws_do_not_depend_on_the_batch():
    """A rock's tangent draw is keyed by (seed, block, index in the block):
    its row is the same alone and inside a batch of other blocks."""
    blk = [[3, -2]] * 9
    a = trocks.rock_tangent_draws(67, blk, range(9))
    both = trocks.rock_tangent_draws(67, [[-2, 3]] * 4 + blk, list(range(4)) + list(range(9)))
    assert torch.equal(a, both[4:])
    assert not torch.equal(a[:4], both[:4])
    assert a.dtype == torch.float32 and float(a.abs().max()) <= 1.0


def _samplers():
    js, ts = _streamers(craters=True)
    js.update((5.0, 5.0))
    ts.update((5.0, 5.0))
    return (jrocks.RockSampler(jrocks.RockDistConf(**CONF), js),
            trocks.RockSampler(trocks.RockDistConf(**CONF), ts))


def test_sampled_region_against_jax():
    jsamp, tsamp = _samplers()
    want = jsamp.sample_region((4.0, 6.0), block_span=1)
    got = tsamp.sample_region((4.0, 6.0), block_span=1)
    assert got.coordinates.shape[0] == want.coordinates.shape[0] > 10
    for name in ("coordinates", "scale", "ids"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_allclose(got.height, want.height, rtol=0, atol=1.1e-3)
    np.testing.assert_allclose(np.linalg.norm(got.quaternion, axis=-1), 1.0, atol=2e-3)
    np.testing.assert_array_equal(trocks.rocks_to_obstacles(got, 0.35),
                                  jrocks.rocks_to_obstacles(want, 0.35))
    # one block at a time gives the blocks of the batched query, quaternions too
    one = trocks.RockSampler(trocks.RockDistConf(**CONF), tsamp.hf)
    for key in ((0, 0), (1, -1)):
        a, b = one.sample_block(*key), tsamp.sample_block(*key)
        for name in ("coordinates", "height", "quaternion", "scale", "ids"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
    # the converter carries a JAX block over as it is
    conv = convert.rock_block_from_numpy(want.coordinates, want.height, want.quaternion,
                                         want.scale, want.ids)
    np.testing.assert_array_equal(conv.coordinates, got.coordinates)


def test_sampler_on_a_fixed_heightfield_matches_jax(rng):
    z = rng.normal(0.0, 0.3, (120, 120)).astype(np.float32)
    jhf = JHeightField.create(jnp.asarray(z), 30.0)
    thf = THeightField.create(torch.from_numpy(z), 30.0)
    want = jrocks.RockSampler(jrocks.RockDistConf(**CONF), jhf).sample_region((2.0, -3.0), 1)
    got = trocks.RockSampler(trocks.RockDistConf(**CONF), thf).sample_region((2.0, -3.0), 1)
    np.testing.assert_array_equal(got.coordinates, want.coordinates)
    np.testing.assert_array_equal(got.scale, want.scale)
    np.testing.assert_allclose(got.height, want.height, rtol=0, atol=1.1e-3)


def test_block_db_matches_jax(tmp_path, rng):
    """``BlockDB``: the same payloads come back from both packages' stores,
    with the same occupancy, missing blocks and rectangles."""
    dbs = [jdb.BlockDB(jdb.BlockDBConf(block_size=10.0)), tdb.BlockDB(tdb.BlockDBConf(
        block_size=10.0))]
    keys = [(0, 0), (0, 1), (2, 2), (3, 0)]
    for key in keys:
        payload = {"coordinates": rng.uniform(0, 40, (6, 2)), "radius": rng.uniform(0.2, 2, 6),
                   "ids": np.arange(6)}
        for db in dbs:
            db.add(key, payload)
    region = (-1, 4, -1, 4)
    np.testing.assert_array_equal(dbs[1].occupancy(region), dbs[0].occupancy(region))
    assert dbs[1].missing_blocks(region) == dbs[0].missing_blocks(region)
    assert dbs[1].missing_rectangles(region) == dbs[0].missing_rectangles(region)
    occ = rng.uniform(size=(9, 7)) < 0.4
    assert tdb.largest_empty_rectangle(occ) == jdb.largest_empty_rectangle(occ)
    assert tdb.decompose_empty_rectangles(occ) == jdb.decompose_empty_rectangles(occ)
    for key in keys:
        got, want = dbs[1].get(key), dbs[0].get(key)
        for name in want:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert len(dbs[1].get_with_neighbors((0, 0))) == len(dbs[0].get_with_neighbors((0, 0))) == 2
    dbs[1].save_to_disk(str(tmp_path / "db"))
    back = jdb.BlockDB(jdb.BlockDBConf(block_size=10.0))  # the JAX package reads the port's files
    back.load_from_disk(str(tmp_path / "db"))
    assert sorted(back.keys()) == sorted(keys)
    np.testing.assert_array_equal(back.get((2, 2))["radius"], dbs[1].get((2, 2))["radius"])


def test_orientation_functions_match_jax_on_injected_draws(rng):
    """``orientation_from_normal``, ``surface_orientation`` and
    ``provider_orientation`` draw their tangents from a key (JAX's stream,
    held against JAX's draws in tests/test_torch_jax_random.py); given
    JAX's draws through ``rand=`` they
    give JAX's quaternions (within the quaternion math's float32 bound
    above), and heights and normals equal to JAX's where no transcendental
    enters."""
    import jax

    key = jax.random.key(5)
    # upward normals, as a DEM's are: for a normal pointing down the
    # rotation is near 180 degrees, w = sqrt(1 + trace) / 2 near 0, and both
    # packages' float32 quaternions stray ~1e-5 from the float64 one
    normal = np.abs(rng.normal(size=(40, 3))) * [0.2, 0.2, 1.0] * [1.0, -1.0, 1.0]
    normal = (normal / np.linalg.norm(normal, axis=-1, keepdims=True)).astype(np.float32)
    draws = np.asarray(jax.random.uniform(key, (40, 3), jnp.float32, -1.0, 1.0))
    got = trocks.orientation_from_normal(torch.from_numpy(normal),
                                         rand=torch.from_numpy(draws.copy()))
    want = jrocks.orientation_from_normal(jnp.asarray(normal), key)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)

    z = rng.normal(0.0, 0.3, (120, 120)).astype(np.float32)
    jhf, thf = JHeightField.create(jnp.asarray(z), 30.0), THeightField.create(torch.from_numpy(z), 30.0)
    xy = rng.uniform(-25.0, 25.0, (40, 2)).astype(np.float32)
    for got, want in ((trocks.surface_orientation(thf, torch.from_numpy(xy),
                                                  rand=torch.from_numpy(draws.copy())),
                       jrocks.surface_orientation(jhf, jnp.asarray(xy), key)),):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=1e-6)

    js, ts = _streamers(craters=False)
    js.update((5.0, 5.0))
    ts.update((5.0, 5.0))
    pxy = rng.uniform(-5.0, 15.0, (40, 2))
    got = trocks.provider_orientation(ts, pxy, rand=torch.from_numpy(draws.copy()))
    want = jrocks.provider_orientation(js, pxy, key)
    # the streamers' windows agree to the streaming tests' bound, not bit for bit
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=0, atol=1e-3)
    np.testing.assert_allclose(np.linalg.norm(got[1].numpy(), axis=-1), 1.0, atol=1e-6)
    # the same inputs through the port's math: the provider's normal and draws
    np.testing.assert_array_equal(
        got[1].numpy(),
        trocks.quat_from_normal_and_rand(got[2], torch.from_numpy(draws.copy())).numpy())


def test_orientation_draws_come_from_the_generator():
    """Without ``rand`` the tangents are drawn from the key (JAX's stream,
    ``core.jax_random``): the same key gives the same quaternions, another
    key others."""
    normal = torch.nn.functional.normalize(torch.randn((30, 3), generator=torch.Generator()
                                                       .manual_seed(1)), dim=-1)
    a = trocks.orientation_from_normal(normal, jr.key(7))
    b = trocks.orientation_from_normal(normal, jr.key(7))
    c = trocks.orientation_from_normal(normal, jr.key(8))
    assert torch.equal(a, b) and not torch.equal(a, c)
    draws = trocks.tangent_draws((30,), jr.key(7))
    assert torch.equal(a, trocks.quat_from_normal_and_rand(normal, draws))
    assert float(draws.abs().max()) <= 1.0
