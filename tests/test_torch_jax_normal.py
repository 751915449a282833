"""PyTorch port: JAX's normal and Poisson streams (``core/jax_random.py``:
``normal``, ``poisson``, ``derive``) and the ``jax_normal`` wrapper's CPU
route, against ``jax.random`` on the CPU.

Tolerances:

* float32 normals are JAX's bit for bit: the plain version evaluates XLA's
  CPU code for ``erf_inv`` and ``log1p`` operation for operation, each fused
  multiply-add formed exactly. The acceptance bar is a bit-equal share of at
  least 97.6% and at most 3 ulp (what XLA's polynomial alone reaches); the
  test prints the share and the largest gap it found (1.0 and 0 on the
  machine the port was written on);
* float64 normals within 1e-14 absolute (measured 3.3e-15 over 2 x 10^5
  draws, ~89% bit-equal): torch has no float64 fused multiply-add and the
  plain version takes torch's ``log1p``, where XLA fuses and uses its own;
* Poisson counts equal, at rates on both sides of Knuth's limit of 10: the
  rejection sampler takes XLA's ``lgamma`` (Lanczos) and fuses the products
  XLA contracts. With torch's ``lgamma`` and unfused products 47 of 60,000
  counts flipped (rates 160 to 10^4); now none of the tested keys' do.
  XLA's ``lgamma`` itself is matched on all but 17 of 50,000 arguments
  (an ulp apart), none of which moves a tested count.
"""

import math
from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch.core import jax_random as jr
from husky_rover_mppi_isaacsim_torch.mppi import sampling as tsamp
from husky_rover_mppi_isaacsim_torch.ops.jax_normal_cuda import (
    SPLIT_NEXT,
    SPLIT_SUB,
    jax_normal,
    key_path,
)

# the acceptance bar for float32 normals against jax.random.normal
MIN_EQUAL_SHARE, MAX_ULP = 0.976, 3
F64_ATOL = 1e-14


def _jnormal32(seed, shape):
    return np.asarray(jax.random.normal(jax.random.key(seed), shape, jnp.float32))


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 33 + 5])
def test_float32_normals_are_jax_draws(seed):
    shape = (2, 1000, 100)
    want = _jnormal32(seed, shape)
    got = jr.normal(jr.key(seed), shape, torch.float32).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    ulps = _ulps(got, want)
    share = float((ulps == 0).mean())
    print(f"seed {seed}: bit-equal share {share}, largest gap {int(ulps.max())} ulp")
    assert share >= MIN_EQUAL_SHARE and int(ulps.max()) <= MAX_ULP


@pytest.mark.parametrize("shape", [(16384, 64), (2, 4000, 100), (4,), (4096,), (3, 5, 7), ()])
def test_float32_normals_at_the_loops_shapes(shape):
    """bench.py's batch, the closed loop's (2, N*K, H), the slip's (N,),
    a ragged shape and a scalar."""
    want = _jnormal32(7, shape)
    got = jr.normal(jr.key(7), shape).numpy()
    assert got.shape == want.shape
    ulps = _ulps(np.atleast_1d(got), np.atleast_1d(want))
    assert float((ulps == 0).mean()) >= MIN_EQUAL_SHARE and int(ulps.max()) <= MAX_ULP


@pytest.mark.parametrize("seed", [0, 9, 123])
def test_float64_normals_are_within_their_bound(seed):
    shape = (2, 1000, 100)
    want = np.asarray(jax.random.normal(jax.random.key(seed), shape, jnp.float64))
    got = jr.normal(jr.key(seed), shape, torch.float64).numpy()
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=0, atol=F64_ATOL)
    assert float((got == want).mean()) > 0.5


def test_log_and_log1p_are_xlas():
    """The two pieces of erf_inv that are not a polynomial: XLA's float32
    ``log`` (over the uniforms' range and its edges) and ``log1p`` (both
    branches), bit for bit."""
    rng = np.random.default_rng(3)
    t = np.concatenate([rng.uniform(1e-7, 1.0, 4000), rng.uniform(1.0, 1e6, 1000),
                        [1.0, 0.5, 2.0 ** -23, np.float32(np.sqrt(0.5)), 0.0]]).astype(np.float32)
    with jax.enable_x64(False):
        want_log = np.asarray(jnp.log(jnp.asarray(t)))
        y = -rng.uniform(0.0, 0.99999994, 5000).astype(np.float32) ** 2
        want_log1p = np.asarray(jnp.log1p(jnp.asarray(y)))
    np.testing.assert_array_equal(jr.log_f32(torch.from_numpy(t)).numpy(), want_log)
    np.testing.assert_array_equal(jr.log1p_f32(torch.from_numpy(y)).numpy(), want_log1p)


def test_fma_f32_rounds_once():
    """``fma_f32`` against exact rational arithmetic: ``a * b + c`` rounded
    once to float32 (ties to even), on random operands and on sums that
    land on a float32 midpoint or next to one."""
    rng = np.random.default_rng(5)
    a = rng.standard_normal(3000).astype(np.float32)
    b = rng.standard_normal(3000).astype(np.float32)
    c = (rng.standard_normal(3000) * 10.0 ** rng.integers(-8, 3, 3000)).astype(np.float32)
    # midpoint cases: c = -(a*b rounded) + a half ulp of it
    p32 = (a[:500] * b[:500]).astype(np.float32)
    c[:500] = (-p32.astype(np.float64) + np.spacing(p32) * 0.5).astype(np.float32)
    got = jr.fma_f32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    for i in range(len(a)):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        lo = np.float32(float(exact))  # one rounding from the nearest double
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo, np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.array(v).view(np.int32)) & 1))
        assert got[i] == best, (i, a[i], b[i], c[i])


def test_sqrt_f32_is_correctly_rounded():
    rng = np.random.default_rng(8)
    x = np.concatenate([rng.uniform(0.0, 40.0, 200000), 10.0 ** rng.uniform(-38, 38, 2000),
                        [0.0, 1.0, 4.0, 2.0, np.float32(3.4e38)]]).astype(np.float32)
    np.testing.assert_array_equal(jr.sqrt_f32(torch.from_numpy(x)).numpy(), np.sqrt(x))


@pytest.mark.parametrize("lam", [0.0, 0.5, 3.0, 9.99, 10.0, 25.0, 160.0, 1e4])
def test_poisson_counts_are_jaxs(lam):
    for seed in (0, 1, 2):
        want = np.asarray(jax.random.poisson(jax.random.key(seed), lam, (300,)))
        got = jr.poisson(jr.key(seed), lam, (300,))
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), want)
    if lam > 0:
        assert abs(float(got.double().mean()) - lam) < 5 * math.sqrt(lam / 300) + 0.05


def test_poisson_mixed_rates_in_one_draw():
    """Knuth's and the rejection lanes drawn together from one key, as
    ``_poisson`` selects them."""
    lam = np.array([0.2, 12.0, 5.0, 80.0, 9.5, 10.5] * 20, np.float32)
    want = np.asarray(jax.random.poisson(jax.random.key(4), lam))
    np.testing.assert_array_equal(jr.poisson(jr.key(4), torch.from_numpy(lam)).numpy(), want)


def test_derive_and_the_wrappers_cpu_route():
    """A path of split and fold-in steps (a fold-in from a 0-d tensor too)
    is JAX's key; the wrapper on CPU tensors is the plain version, with the
    next key of ``key, sub = split(key)``, a count offset's block equal to
    the slice of the full draw, and a key path the kernel's struct takes."""
    key, jkey = jr.key(11), jax.random.key(11)
    path = (("fold_in", torch.tensor(6)), ("split", 12, 5), ("split", 2, 1))
    want = jax.random.split(jax.random.split(jax.random.fold_in(jkey, 6), 12)[5])[1]
    np.testing.assert_array_equal(jr.derive(key, path).numpy(),
                                  np.asarray(jax.random.key_data(want)).astype(np.int64))
    noise, nxt = jax_normal(key, (2, 30, 20), path=SPLIT_SUB, next_path=SPLIT_NEXT)
    jnext, jsub = jax.random.split(jkey)
    np.testing.assert_array_equal(nxt.numpy(),
                                  np.asarray(jax.random.key_data(jnext)).astype(np.int64))
    assert torch.equal(noise, jr.normal(jr.derive(key, SPLIT_SUB), (2, 30, 20)))
    np.testing.assert_array_equal(noise.numpy(), _jnormal32_from(jsub, (2, 30, 20)))
    full = tsamp.sample_noise(key, 30, 20)
    for start, stop in ((0, 10), (10, 30), (7, 19)):
        assert torch.equal(tsamp.sample_noise_block(key, 30, 20, start, stop),
                           full[:, start:stop])
    kp, scalar = key_path(path, torch.device("cpu"))
    assert (kp.len, kp.device_step, kp.v[1:3]) == (3, 0, (5, 1)) and scalar is path[0][1]
    with pytest.raises(ValueError):
        key_path((("split", 2, 0),) * 5, torch.device("cpu"))


def _jnormal32_from(jkey, shape):
    return np.asarray(jax.random.normal(jkey, shape, jnp.float32))
