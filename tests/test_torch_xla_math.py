"""PyTorch port: ``core/xla_math.py``, the float32 functions of the JAX
package's CPU build, against ``jnp`` on the CPU, bit for bit.

Each function is held to ``jnp``'s float32 result on 2^22 probes or more:
random bit patterns (every exponent, subnormals, infinities and NaNs among
them), dense ranges where the functions change branch, magnitudes up to
3e38, and the special values (+-0, +-inf, NaN, subnormals, the branch
limits). NaN is compared as NaN. XLA calls the C library for ``atan2``,
``sin``, ``cos`` and ``arctan`` (``atan2f(x, 1)``) and ``power``, so a few
hundred normal probes are also held to ``ctypes``'s ``libm.so.6``: on a
machine whose libm is not glibc 2.36's (or whose CPU takes another ifunc
variant) that check fails with a message naming the library, before the
``jnp`` check does. ``exp`` is XLA's own polynomial, and ``linspace``
XLA's compiled ``jnp.linspace``.
"""

import ctypes
import ctypes.util
import math
from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch.core import xla_math as xm

torch.set_num_threads(1)

N_PROBES = 1 << 22
SPECIAL = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45, 1e-40, -3e-39,
                    1.1754942e-38, 1.17549435e-38, 1.0, -1.0, 0.5, 2.0, np.pi / 4, -np.pi / 4,
                    0.4375, 0.6875, 1.1875, 2.4375, 2.0 ** -29, 2.0 ** 25, 2.0 ** -12, 120.0,
                    -120.0, 119.99999, 88.8, 88.7, -87.8, -87.3, -88.0, 3.4e38, -3.4e38, 1e30,
                    -1e30, 1e10], np.float32)


def _probes(seed: int, lo: float, hi: float) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n = N_PROBES // 4
    bits = rng.integers(0, 2 ** 32, n, dtype=np.uint64).astype(np.uint32).view(np.float32)
    dense = rng.uniform(lo, hi, n).astype(np.float32)
    wide = (rng.standard_normal(n) * 10.0 ** rng.uniform(-40, 37.5, n)).astype(np.float32)
    near = np.nextafter(np.repeat(SPECIAL[np.isfinite(SPECIAL)], 64),
                        np.float32(np.inf)).astype(np.float32)
    rest = rng.uniform(-4.0, 4.0, N_PROBES - 3 * n - SPECIAL.size - near.size)
    return np.concatenate([bits, dense, wide, SPECIAL, near, rest.astype(np.float32)])


def _assert_bits_equal(got: np.ndarray, want: np.ndarray, x, name: str):
    same = (got.view(np.uint32) == want.view(np.uint32)) | (np.isnan(got) & np.isnan(want))
    bad = np.flatnonzero(~same)[:4]
    args = [tuple(a[i] for a in x) if isinstance(x, tuple) else x[i] for i in bad]
    assert bad.size == 0, f"{name}: differs at {args}: {got[bad]} != {want[bad]}"


@pytest.mark.parametrize("name,lo,hi,seed", [("exp", -90.0, 90.0, 11), ("sin", -130.0, 130.0, 12),
                                             ("cos", -130.0, 130.0, 13), ("atan", -40.0, 40.0, 14)])
def test_unary_functions_are_jnps(name, lo, hi, seed):
    x = _probes(seed, lo, hi)
    assert x.size >= N_PROBES
    got = getattr(xm, f"{name}_f32")(torch.from_numpy(x)).numpy()
    jfn = {"exp": jnp.exp, "sin": jnp.sin, "cos": jnp.cos, "atan": jnp.arctan}[name]
    want = np.asarray(jfn(jnp.asarray(x)))
    assert got.dtype == want.dtype == np.float32
    _assert_bits_equal(got, want, x, name)
    # NaN is the canonical quiet NaN
    assert np.all(got.view(np.uint32)[np.isnan(got)] == xm.NAN_BITS)


def test_atan2_is_jnps():
    """Every pair of the special values (signed zeros, infinities, NaN, x ==
    1, subnormals that XLA flushes), then random pairs, some with |y/x|
    beyond 2^60 either way."""
    a, b = np.meshgrid(SPECIAL, SPECIAL)
    y = np.concatenate([a.ravel(), _probes(1, -10.0, 10.0)])
    x = np.concatenate([b.ravel(), np.random.default_rng(2).permutation(_probes(2, -10.0, 10.0))])
    got = xm.atan2_f32(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    want = np.asarray(jnp.arctan2(jnp.asarray(y), jnp.asarray(x)))
    _assert_bits_equal(got, want, (y, x), "atan2")


def _libm():
    path = ctypes.util.find_library("m") or "libm.so.6"
    lib = ctypes.CDLL(path)
    for fn, nargs in (("sinf", 1), ("cosf", 1), ("atanf", 1), ("atan2f", 2), ("powf", 2)):
        f = getattr(lib, fn)
        f.restype = ctypes.c_float
        f.argtypes = [ctypes.c_float] * nargs
    libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6")
    libc.gnu_get_libc_version.restype = ctypes.c_char_p
    return lib, f"{path} (glibc {libc.gnu_get_libc_version().decode()})"


def test_copies_are_this_libms_functions():
    """A few hundred normal probes through the C library itself: the copies
    are glibc 2.36's (sinf / cosf in their FMA + AVX2 variant)."""
    lib, name = _libm()
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.uniform(-130, 130, 200), 10.0 ** rng.uniform(-3, 30, 100),
                        -(10.0 ** rng.uniform(-3, 30, 100))]).astype(np.float32)
    y = rng.uniform(-50, 50, x.size).astype(np.float32)
    p = rng.uniform(0.0, 1.0, x.size).astype(np.float32)
    tx, ty, tp = (torch.from_numpy(a) for a in (x, y, p))
    checks = [("sinf", xm.sin_f32(tx), [lib.sinf(v) for v in x]),
              ("cosf", xm.cos_f32(tx), [lib.cosf(v) for v in x]),
              ("atanf", xm.atan_f32(tx), [lib.atanf(v) for v in x]),
              ("atan2f", xm.atan2_f32(ty, tx), [lib.atan2f(a, b) for a, b in zip(y, x)]),
              ("powf", xm.pow_f32(tp, 20.0), [lib.powf(v, 20.0) for v in p])]
    for fn, got, want in checks:
        want = np.asarray(want, np.float32)
        assert np.array_equal(got.numpy(), want), (
            f"{fn} of {name} is not the glibc 2.36 copy in core/xla_math.py "
            f"({int((got.numpy() != want).sum())} of {want.size} probes differ): the JAX "
            f"package's float32 terrain calls this library, so the port's bits would differ")


@pytest.mark.parametrize("power", [20.0, 10.0, 2.5])
def test_pow_is_jnps(power):
    """``x ** p`` for the costmap's falloff (x in [0, 1]) and beyond; XLA
    calls ``powf``. Results below 2^-126 are flushed."""
    rng = np.random.default_rng(int(power))
    x = np.concatenate([rng.uniform(0, 1, N_PROBES // 2), 10.0 ** rng.uniform(-9, 0, N_PROBES // 4),
                        rng.uniform(0, 60, N_PROBES // 4),
                        [0.0, 1.0, 2.0 ** -24, 1.0 - 2.0 ** -24, 0.0055, 0.0127]])
    x = x.astype(np.float32)
    got = xm.pow_f32(torch.from_numpy(x), power).numpy()
    want = np.asarray(jnp.power(jnp.asarray(x), power))
    _assert_bits_equal(got, want, x, f"pow {power}")


@pytest.mark.parametrize("start,stop", [(-75.0, 75.0), (-3.3, 12.7), (0.0, 1.0)])
def test_linspace_is_jnps(start, stop):
    """Sizes on both sides of where XLA stops folding the constants of a
    short array and loops over a long one, 32 elements at a time (352 /
    353), and of where element 1 changes form (34 / 35), then sizes to 4096:
    the main path's 1500 among them."""
    sizes = list(range(1, 100)) + list(range(100, 700, 7)) + list(range(340, 366))
    for num in sorted(set(sizes + list(range(700, 4097, 97)) + [750, 875, 1500, 4096])):
        got = xm.linspace_f32(start, stop, num).numpy()
        want = np.asarray(jnp.linspace(start, stop, num, dtype=jnp.float32))
        assert np.array_equal(got, want), (num, np.flatnonzero(got != want)[:8])


def test_fma_f64_rounds_once():
    """``fma_f64`` against exact rational arithmetic on the sine and cosine
    polynomials' operand ranges."""
    rng = np.random.default_rng(9)
    n = 4000
    a, b, c = (rng.standard_normal(n) * 10.0 ** rng.uniform(-9, 2, n) for _ in range(3))
    got = xm.fma_f64(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    for i in range(n):
        assert got[i] == float(Fraction(a[i]) * Fraction(b[i]) + Fraction(c[i])), i


def test_fma_f32_cpu_route_is_the_branch_free_one():
    """``fma_f32``'s CPU route (the float64 sum, midpoints rounded to odd)
    equals the branch-free rounding to odd the card takes, on sums that
    land on a float32 midpoint and in the subnormal range."""
    rng = np.random.default_rng(10)
    a = rng.standard_normal(20000).astype(np.float32)
    b = rng.standard_normal(20000).astype(np.float32)
    c = (rng.standard_normal(20000) * 10.0 ** rng.integers(-40, 3, 20000)).astype(np.float32)
    p32 = (a[:5000] * b[:5000]).astype(np.float32)
    c[:5000] = (-p32.astype(np.float64) + np.spacing(p32) * 0.5).astype(np.float32)
    ta, tb, tc = (torch.from_numpy(v) for v in (a, b, c))
    got = xm.fma_f32(ta, tb, tc)
    want = xm._round_odd_sum(ta.double() * tb.double(), tc.double()).float()
    assert torch.equal(got, want)
    assert math.isclose(float(got[0]), float(a[0]) * float(b[0]) + float(c[0]), rel_tol=1e-6,
                        abs_tol=1e-30)
