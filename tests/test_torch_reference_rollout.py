"""PyTorch port: the thesis-convention 2.5D rollout (``rollout_25d_reference``)
against the JAX package's and against the thesis numpy oracle
(``compat.numpy_oracle.generate_trajectory_25d``), in float64: 1e-12 against
JAX (the same operations in another summation order), 1e-9 against the
oracle (the tolerance JAX's own test holds it to: scipy's rotation-vector
update is the Rodrigues formula only up to round-off)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch.mppi import reference_rollout as tref
from husky_rover_mppi_isaacsim_torch.mppi import rollout_25d_reference
from husky_rover_mppi_isaacsim_tpu.compat import numpy_oracle as no
from husky_rover_mppi_isaacsim_tpu.mppi import reference_rollout as jref
from husky_rover_mppi_isaacsim_tpu.terrain import bump_surface

torch.set_num_threads(1)

GRID, HW = 400, 20.0
RES = 2 * HW / GRID


@pytest.fixture(scope="module")
def surface():
    return np.array(bump_surface(GRID, HW, no.REFERENCE_BUMPS, dtype=jnp.float64))


def _velocities(seed, iterations):
    rng = np.random.RandomState(seed)
    lin = no.generate_velocities(rng, iterations, 1.5, 0.1, 1.5, 2.5)
    ang = no.generate_velocities(rng, iterations, 0.0, 0.05, -0.4, 0.4)
    return lin, ang


def _scalars(dtype=torch.float64):
    return torch.tensor(HW, dtype=dtype), torch.tensor(RES, dtype=dtype)


def test_matches_thesis_oracle(surface):
    iterations = 200
    lin, ang = _velocities(42, iterations)
    want = no.generate_trajectory_25d(6.0, -6.0, [-0.5, 4.0, 0.0], lin, ang, 0.05, iterations,
                                      RES, surface, HW)
    assert want is not None
    got = rollout_25d_reference(torch.from_numpy(surface), *_scalars(),
                                torch.tensor([6.0, -6.0], dtype=torch.float64),
                                torch.tensor([-0.5, 4.0, 0.0], dtype=torch.float64),
                                torch.from_numpy(lin)[None], torch.from_numpy(ang)[None], 0.05)
    assert got.shape == (1, iterations, 3) and got.dtype == torch.float64
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0, atol=1e-9)


@pytest.mark.parametrize("batch", [(), (5,), (2, 3)], ids=["unbatched", "K5", "N2xK3"])
def test_matches_jax_batched(surface, batch):
    """Batches of sample rollouts from several starts, against JAX at 1e-12."""
    h = 60
    rng = np.random.default_rng(sum(batch) + 7)
    lin = rng.uniform(1.0, 2.5, batch + (h,))
    ang = rng.uniform(-0.5, 0.5, batch + (h,))
    pos = np.array([3.0, -4.5])
    head = np.array([0.3, 1.0, 0.05])
    want = np.asarray(jref.rollout_25d_reference(
        jnp.asarray(surface), jnp.asarray(HW), jnp.asarray(RES), jnp.asarray(pos),
        jnp.asarray(head), jnp.asarray(lin), jnp.asarray(ang), 0.045))
    got = rollout_25d_reference(torch.from_numpy(surface), *_scalars(), torch.from_numpy(pos),
                                torch.from_numpy(head), torch.from_numpy(lin),
                                torch.from_numpy(ang), 0.045)
    assert got.shape == want.shape == batch + (h, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_helpers_match_jax(surface):
    """Corners (with the -2 offset, off the grid too: wrap once, then
    clamp), floor-fraction bilinear, normal and tangent."""
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(-HW + 0.5, HW - 0.5, 40), [-HW - 0.3, HW + 0.7, -HW + 0.01]])
    y = np.concatenate([rng.uniform(-HW + 0.5, HW - 0.5, 40), [HW + 0.2, -HW - 0.9, -HW + 0.05]])
    hw, res = _scalars()
    tz, tx, ty = torch.from_numpy(surface), torch.from_numpy(x), torch.from_numpy(y)
    jz, jx, jy = jnp.asarray(surface), jnp.asarray(x), jnp.asarray(y)
    q = tref.reference_corners(tz, tx, ty, res, hw)
    jq = jref.reference_corners(jz, jx, jy, jnp.asarray(RES), jnp.asarray(HW))
    assert np.array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_allclose(tref.reference_bilinear(tx, ty, q, res).numpy(),
                               np.asarray(jref.reference_bilinear(jx, jy, jq, jnp.asarray(RES))),
                               rtol=0, atol=1e-12)
    n = tref._normal(q, res)
    np.testing.assert_allclose(n.numpy(), np.asarray(jref._normal(jq, jnp.asarray(RES))),
                               rtol=0, atol=1e-15)
    head = rng.normal(size=(x.size, 3))
    np.testing.assert_allclose(tref._tangent(n, torch.from_numpy(head)).numpy(),
                               np.asarray(jref._tangent(jnp.asarray(n.numpy()),
                                                        jnp.asarray(head))),
                               rtol=0, atol=1e-15)


def test_float32_close_to_float64(surface):
    """The float32 rollout (the card's dtype) stays within a few
    millimetres of float64 over a 3 s horizon."""
    lin, ang = _velocities(5, 60)
    args = ([6.0, -6.0], [-0.5, 4.0, 0.0])
    f64 = rollout_25d_reference(torch.from_numpy(surface), *_scalars(), *args,
                                torch.from_numpy(lin), torch.from_numpy(ang), 0.05)
    f32 = rollout_25d_reference(torch.from_numpy(surface).float(), *_scalars(torch.float32),
                                *args, torch.from_numpy(lin).float(),
                                torch.from_numpy(ang).float(), 0.05)
    assert f32.dtype == torch.float32
    np.testing.assert_allclose(f32.numpy(), f64.numpy(), rtol=0, atol=5e-3)
