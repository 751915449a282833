"""PyTorch port: wheel-lag dynamics and input sampling against the JAX
package (float64, 1e-12) and the numpy seed stream (equal)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch.core import jax_random as jr
from husky_rover_mppi_isaacsim_torch.dynamics import skid_steer as tss
from husky_rover_mppi_isaacsim_torch.mppi import sampling as tsamp
from husky_rover_mppi_isaacsim_tpu.dynamics import skid_steer as jss
from husky_rover_mppi_isaacsim_tpu.mppi import sampling as jsamp

# small tensors: one intra-op thread each, so that the test workers running
# beside these do not lose their cores
torch.set_num_threads(1)

ATOL = 1e-12
LIMITS = (0.0, 2.0, -1.0, 1.0)


def _inputs(rng, k=12, h=30):
    return rng.uniform(-1, 1, (k, h)), rng.uniform(-1, 1, (k, h))


@pytest.mark.parametrize("form", ["scan", "matmul"])
@pytest.mark.parametrize("lag", [(3.5, 0.96), (3.0, 0.92)])
def test_wheel_lag_matches_jax(rng, form, lag):
    u1, u2 = _inputs(rng)
    k, a = lag
    tfn = getattr(tss, f"wheel_lag_{form}")
    jfn = getattr(jss, f"wheel_lag_{form}")
    got = tfn(torch.from_numpy(u1), torch.from_numpy(u2), torch.tensor(0.3, dtype=torch.float64),
              torch.tensor(-0.2, dtype=torch.float64), torch.tensor(1.2, dtype=torch.float64),
              tss.DiffDriveLimits(*LIMITS), k, a)
    want = jfn(jnp.asarray(u1), jnp.asarray(u2), 0.3, -0.2, jnp.asarray(1.2),
               jss.DiffDriveLimits(*LIMITS), k, a)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=ATOL)


def test_wheel_lag_matmul_float32_close_to_scan(rng):
    u1, u2 = (torch.from_numpy(u.astype(np.float32)) for u in _inputs(rng, 64, 100))
    args = (torch.tensor(0.5), torch.tensor(0.4), torch.tensor(1.2),
            tss.DiffDriveLimits(), 3.5, 0.96)
    for a, b in zip(tss.wheel_lag_matmul(u1, u2, *args), tss.wheel_lag_scan(u1, u2, *args)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=2e-5)


def test_inverse_diff_drive_matches_jax(rng):
    lin, ang = rng.uniform(-2, 2, (2, 50))
    got = tss.inverse_diff_drive(torch.from_numpy(lin), torch.from_numpy(ang), 1.2)
    want = jss.inverse_diff_drive(jnp.asarray(lin), jnp.asarray(ang), 1.2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_perturb_and_shift_match_jax(rng):
    h, k = 20, 16
    o1, o2 = rng.uniform(-1, 1, (2, h))
    noise = rng.normal(size=(2, k, h)) * 3.0  # wide enough to hit the clamps
    got = tsamp.perturb(torch.from_numpy(o1), torch.from_numpy(o2), torch.from_numpy(noise),
                        torch.tensor(0.4, dtype=torch.float64),
                        torch.tensor(0.6, dtype=torch.float64), tsamp.InputLimits())
    want = jsamp.perturb(jnp.asarray(o1), jnp.asarray(o2), jnp.asarray(noise),
                         jnp.asarray(0.4), jnp.asarray(0.6), jsamp.InputLimits())
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_array_equal(tsamp.shift_receding(torch.from_numpy(o1)).numpy(),
                                  np.asarray(jsamp.shift_receding(jnp.asarray(o1))))


@pytest.mark.parametrize("horizon,seed", [(100, 42), (30, 7)])
def test_loop_seed_sequence_equals_jax(horizon, seed):
    a, b = tsamp.LoopSeedSequence(horizon, seed), jsamp.LoopSeedSequence(horizon, seed)
    assert [a.next_seed() for _ in range(64)] == [b.next_seed() for _ in range(64)]


def test_sample_noise_generator_stream():
    """``sample_noise`` is ``jax.random.normal(key, (2, K, H))``: float32
    bit for bit, float64 within 1e-14; ``loop_key`` is JAX's; a key repeats
    its draw and another key draws otherwise."""
    draw = lambda s: tsamp.sample_noise(jr.key(s), 500, 40)  # noqa: E731
    n = draw(3)
    assert n.shape == (2, 500, 40) and n.dtype == torch.float32
    assert torch.equal(n, draw(3)) and not torch.equal(n, draw(4))
    np.testing.assert_array_equal(
        n.numpy(), np.asarray(jsamp.sample_noise(jax.random.key(3), 500, 40, jnp.float32)))
    n64 = tsamp.sample_noise(jr.key(3), 4, 5, dtype=torch.float64)
    assert n64.dtype == torch.float64
    np.testing.assert_allclose(n64.numpy(), np.asarray(
        jsamp.sample_noise(jax.random.key(3), 4, 5, jnp.float64)), rtol=0, atol=1e-14)
    for seed in (43, 517, 999):
        k = tsamp.loop_key(jr.key(42), seed)
        np.testing.assert_array_equal(k.numpy(), np.asarray(jax.random.key_data(
            jsamp.loop_key(jax.random.key(42), seed))).astype(np.int64))


def test_input_limits_and_drive_limits_defaults_match_jax():
    assert tuple(tsamp.InputLimits()) == tuple(jsamp.InputLimits())
    assert tuple(tss.DiffDriveLimits()) == tuple(jss.DiffDriveLimits())
