"""float32 functions evaluated as the JAX package's CPU build evaluates them,
on tensors of any device, so that the port's float32 terrain is JAX's bit
for bit.

What XLA's CPU backend does with a float32 elementwise op (jax 0.9.0, the
machine code dumped with ``XLA_FLAGS=--xla_dump_to=DIR``):

* ``exp`` is XLA's own inlined polynomial (Cephes ``expf``: a clamp, the
  split of ``x`` by ln 2 and a degree-5 polynomial), with LLVM's contracted
  fused multiply-adds: :func:`exp_f32`;
* ``atan2``, ``sin`` and ``cos`` call the C library: ``atan2f``, ``sinf`` and
  ``cosf``, and ``arctan(x)`` calls ``atan2f(x, 1)``. The copies here are
  glibc 2.36's (x86_64): ``atan2f`` / ``atanf`` are fdlibm's float code, no
  fused multiply-adds (:func:`atan2_f32`, :func:`atan_f32`); ``sinf`` /
  ``cosf`` are the ifunc variant an FMA + AVX2 CPU gets, which evaluates in
  double with double fused multiply-adds (:func:`sin_f32`,
  :func:`cos_f32`);
* every float32 op runs with denormals flushed (MXCSR FTZ and DAZ): a
  subnormal result is a signed zero, a subnormal operand reads as zero
  (:func:`ftz`). The C library's functions keep their integer tests, so a
  subnormal argument still takes their tiny-argument branch;
* ``jnp.linspace`` divides by ``num - 1`` as a multiply by its float32
  reciprocal and contracts the interpolation: :func:`linspace_f32`.

torch has no fused multiply-add. :func:`fma_f32` forms one exactly (the
float32 product exact in float64, the float64 sum rounded to odd, then one
rounding to float32), and :func:`fma_f64` forms a double one from Dekker's
exact product and a sum rounded to odd (Boldo and Melquiond's emulation).
A true FMA on the card (``__fmaf_rn`` / ``__fma_rn``) gives the same bits,
which is what the crater block kernel's device copies of these functions
use (``csrc/crater_block.cu``).

NaN results are the canonical quiet NaN (``0x7fc00000``), so that two
devices' results compare equal bit for bit.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import Tensor

FLT_MIN = 2.0 ** -126
NAN_BITS = 0x7FC00000


def f32(bits: int) -> float:
    """The float32 of the bit pattern ``bits``, as a Python float."""
    return float(np.array(bits, np.uint32).view(np.float32))


def f64(bits: int) -> float:
    """The float64 of the bit pattern ``bits``, as a Python float."""
    return float(np.array(bits, np.uint64).view(np.float64))


def ftz(x: Tensor) -> Tensor:
    """``x`` with its subnormal values flushed to zero of the same sign, as
    XLA's CPU code runs (FTZ and DAZ)."""
    return torch.where(torch.abs(x) < FLT_MIN, x * 0.0, x)


def _nan_like(x: Tensor) -> Tensor:
    return torch.full_like(x, math.nan)


def fma_f32(a: Tensor, b, c) -> Tensor:
    """``a * b + c`` rounded once to float32, as a fused multiply-add does
    (module note): float32 operands, the product exact in float64, the sum
    rounded to odd there, then to float32. ``b`` and ``c`` may be Python
    floats that are float32 values."""
    p = a.to(torch.float64) * (b.to(torch.float64) if isinstance(b, Tensor) else b)
    c = c.to(torch.float64) if isinstance(c, Tensor) else torch.full_like(p, c)
    if p.is_cuda:  # branch-free: no host read on the card
        return _round_odd_sum(p, c).to(torch.float32)
    # the float64 sum rounds once; rounding it to float32 can only go wrong
    # where it lies on a float32 midpoint (or in float32's subnormal range):
    # those few are rounded to odd first
    p, c = torch.broadcast_tensors(p, c)
    s = p + c
    bits = s.view(torch.int64)
    suspect = ((bits & 0x1FFFFFFF) == 0x10000000) | (torch.abs(s) < FLT_MIN)
    out = s.to(torch.float32)
    idx = torch.nonzero(suspect.reshape(-1)).flatten()
    if idx.numel():
        flat = out.reshape(-1)
        pi, ci = p.reshape(-1)[idx], c.reshape(-1)[idx]
        flat[idx] = _round_odd_sum(pi, ci).to(torch.float32)
        out = flat.reshape(out.shape)
    return out


def _two_sum(a: Tensor, b: Tensor) -> tuple[Tensor, Tensor]:
    """``s + err == a + b`` exactly, ``s`` the rounded sum (Knuth's TwoSum)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _round_odd_sum(a: Tensor, b: Tensor) -> Tensor:
    """``a + b`` (float64) rounded to odd: the rounded sum, moved one unit
    away from it toward the exact sum where it was inexact and even."""
    s, err = _two_sum(a, b)
    bits = s.view(torch.int64)
    odd = (err != 0) & ((bits & 1) == 0) & (s != 0)
    away = (err > 0) == (s > 0)  # the exact sum lies beyond s, away from zero
    bits = torch.where(odd, bits + torch.where(away, 1, -1), bits)
    return bits.view(torch.float64)


_SPLIT = 134217729.0  # 2^27 + 1, Veltkamp's splitter for float64


def _two_prod(a: Tensor, b: Tensor) -> tuple[Tensor, Tensor]:
    """``p + err == a * b`` exactly (Dekker's product; moderate exponents)."""
    p = a * b
    ca, cb = _SPLIT * a, _SPLIT * b
    ah = ca - (ca - a)
    bh = cb - (cb - b)
    al, bl = a - ah, b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def fma_f64(a: Tensor, b, c) -> Tensor:
    """``a * b + c`` rounded once in float64 (Boldo and Melquiond's
    emulation: the exact product ``uh + ul``, ``th + tl = c + uh`` exactly,
    then ``th + RO(tl + ul)`` rounded to nearest). Operands of moderate
    exponent, as the sine and cosine polynomials give it; ``b`` and ``c``
    may be Python floats."""
    b = b if isinstance(b, Tensor) else torch.full_like(a, b)
    c = c if isinstance(c, Tensor) else torch.full_like(a, c)
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    return th + _round_odd_sum(tl, ul)


def sqrt_f32(a: Tensor) -> Tensor:
    """The correctly rounded float32 square root of float32 ``a`` >= 0, as
    XLA's ``sqrt`` and CUDA's ``__fsqrt_rn`` give it. ``torch.sqrt`` on the
    CPU is not that: it may be one unit in the last place off, and a
    parallel chunk of it has been seen to come out of a ~1e-4 approximation.
    So a float64 root is polished by two Newton steps and rounded to
    float32, and the neighbour on the far side of an exact float64 midpoint
    test replaces it where the rounding went the wrong way."""
    a64 = a.to(torch.float64)
    s = torch.sqrt(a64)
    for _ in range(2):
        s = 0.5 * (s + a64 / s)
    r = torch.where(a > 0, s.to(torch.float32), a)
    up = torch.nextafter(r, torch.full_like(r, math.inf))
    mid = (r.to(torch.float64) + up.to(torch.float64)) * 0.5  # exact; so is its square
    r = torch.where((a > 0) & (a64 > mid * mid), up, r)
    down = torch.nextafter(r, torch.zeros_like(r))
    mid = (r.to(torch.float64) + down.to(torch.float64)) * 0.5
    return torch.where((a > 0) & (a64 < mid * mid), down, r)


# XLA CPU's float32 exp: the clamp, log2(e), ln 2 split in two, the
# polynomial's coefficients (highest power first), as float32 bit patterns
EXP_LO, EXP_HI = 0xC2AF999A, 0x42B1999A
EXP_LOG2E = 0x3FB8AA3B
EXP_LN2_HI, EXP_LN2_LO = 0x3F318000, 0xB95E8083
EXP_P = (0x39506967, 0x3AB743CE, 0x3C088908, 0x3D2AA9C1, 0x3E2AAAAA, 0x3F000000)


def exp_f32(x: Tensor) -> Tensor:
    """XLA CPU's float32 ``exp`` of float32 ``x``, operation for operation:
    ``x`` clamped to [-87.8, 88.8] (a NaN passes), ``n = floor(x log2(e) +
    1/2)`` clamped to [-127, 127], ``r = x - n ln2_hi - n ln2_lo``, ``y = 1 +
    r + r^2 P(r)`` and ``y * 2^n`` built from the exponent bits (``2^-127``
    is built as 0); each ``a * b + c`` of the code a fused multiply-add;
    the result flushed to zero where subnormal."""
    x = ftz(x)
    x = torch.where(x < f32(EXP_LO), f32(EXP_LO), x)
    x = torch.where(x > f32(EXP_HI), f32(EXP_HI), x)
    n = torch.floor(fma_f32(x, f32(EXP_LOG2E), 0.5))
    n = torch.clamp(n, -127.0, 127.0)
    r = fma_f32(-n, f32(EXP_LN2_HI), x)
    r = fma_f32(-n, f32(EXP_LN2_LO), r)
    p = fma_f32(r, f32(EXP_P[0]), f32(EXP_P[1]))
    for c in EXP_P[2:]:
        p = fma_f32(r, p, f32(c))
    y = fma_f32(p, r * r, r) + 1.0
    nan = torch.isnan(x)
    k = torch.where(nan, torch.zeros_like(n), n).to(torch.int32)
    scale = ((k + 127) << 23).view(torch.float32)
    return torch.where(nan, _nan_like(y), ftz(y * scale))


# glibc 2.36 fdlibm atanf: atan(0.5), atan(1), atan(1.5), atan(inf) in a high
# and a low part; the polynomial aT[0..10]
ATANHI = (0x3EED6338, 0x3F490FDA, 0x3F7B985E, 0x3FC90FDA)
ATANLO = (0x31AC3769, 0x33222168, 0x33140FB4, 0x33A22168)
ATAN_T = (0x3EAAAAAB, 0xBE4CCCCD, 0x3E124925, 0xBDE38E38, 0x3DBA2E6E, 0xBD9D8795,
          0x3D886B35, 0xBD6EF16B, 0x3D4BDA59, 0xBD15A221, 0x3C8569D7)
# __ieee754_atan2f's constants: pi, pi/2, pi/4, -pi_lo, tiny, and the |y/x| >
# 2^60 result's 0.5 * |pi_lo|
PI_F, PI_O_2, PI_O_4 = 0x40490FDB, 0x3FC90FDB, 0x3F490FDB
PI_LO_NEG, TINY, HALF_PI_LO = 0x33BBBD2E, 0x0DA24260, 0x333BBD2E


def _bits(x: Tensor) -> Tensor:
    """float32 bits as uint32 values in int64."""
    return x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def _sbits(x: Tensor) -> Tensor:
    """float32 bits as int32 (the sign bit is the sign)."""
    return x.view(torch.int32)


def _atanf(x: Tensor) -> Tensor:
    """glibc's ``atanf`` (fdlibm) of float32 ``x`` not NaN, in its order."""
    hx = _sbits(x)
    ix = hx & 0x7FFFFFFF
    neg = hx < 0
    a = torch.abs(x)
    # argument reduction: id -1 (|x| < 7/16, x itself), 0, 1, 2, 3, one
    # division of the branch's numerator and denominator
    ident = torch.full_like(hx, -1)
    ident = torch.where(ix >= 0x3EE00000, 0, ident)
    ident = torch.where(ix >= 0x3F300000, 1, ident)
    ident = torch.where(ix >= 0x3F980000, 2, ident)
    ident = torch.where(ix >= 0x401C0000, 3, ident)
    num = torch.where(ident == 0, (a + a) - 1.0, a - 1.0)
    num = torch.where(ident == 2, a - 1.5, num)
    num = torch.where(ident == 3, torch.full_like(a, -1.0), num)
    den = torch.where(ident == 0, a + 2.0, a + 1.0)
    den = torch.where(ident == 2, a * 1.5 + 1.0, den)
    den = torch.where(ident == 3, a, den)
    r = torch.where(ident < 0, x, num / den)
    z = r * r
    w = z * z
    t = [f32(c) for c in ATAN_T]
    s1 = t[10] * w
    for c in (t[8], t[6], t[4], t[2]):
        s1 = (s1 + c) * w
    s1 = (s1 + t[0]) * z
    s2 = t[9] * w
    for c in (t[7], t[5], t[3]):
        s2 = (s2 + c) * w
    s2 = (s2 + t[1]) * w
    q = (s1 + s2) * r
    small = r - q
    idc = torch.clamp(ident, min=0)
    hi = torch.tensor([f32(c) for c in ATANHI], dtype=torch.float32, device=x.device)[idc]
    lo = torch.tensor([f32(c) for c in ATANLO], dtype=torch.float32, device=x.device)[idc]
    big = hi - ((q - lo) - r)
    big = torch.where(neg, -big, big)
    out = torch.where(ident < 0, small, big)
    out = torch.where(ix < 0x31000000, x, out)  # |x| < 2^-29: x itself
    hi3, lo3 = np.float32(f32(ATANHI[3])), np.float32(f32(ATANLO[3]))
    inf_val = torch.where(neg, torch.full_like(x, float(-hi3 - lo3)),
                          torch.full_like(x, float(lo3 + hi3)))
    out = torch.where(ix >= 0x4C000000, inf_val, out)
    return torch.where(ix > 0x7F800000, x, out)  # NaN: x + x


def atan2_f32(y: Tensor, x: Tensor) -> Tensor:
    """glibc 2.36's ``atan2f(y, x)`` (``__ieee754_atan2f``, fdlibm) on
    float32 tensors that broadcast together, every branch kept (signed
    zeros, infinities, NaN, ``x == 1``, ``|y/x|`` beyond 2^60), with XLA's
    flushed division ``y / x``."""
    y, x = torch.broadcast_tensors(y, x)
    hx, hy = _sbits(x), _sbits(y)
    ix, iy = hx & 0x7FFFFFFF, hy & 0x7FFFFFFF
    m = ((hx >> 30) & 2) | ((hy >> 31) & 1)  # 2 * sign(x) + sign(y)
    pi, pi_o_2, pi_o_4 = (np.float32(f32(b)) for b in (PI_F, PI_O_2, PI_O_4))
    tiny, pi_lo_neg = np.float32(f32(TINY)), f32(PI_LO_NEG)
    zero = torch.zeros_like(x)

    def const(v):  # a float32 constant the C code folds, as a tensor
        return torch.full_like(x, float(v))

    def by_m(v0, v1, v2, v3):
        return torch.where(m == 0, v0, torch.where(m == 1, v1, torch.where(m == 2, v2, v3)))

    # the general case: z = atan(|y / x|), then placed by quadrant
    k = (iy - ix) >> 23
    z = _atanf(ftz(torch.abs(ftz(y) / ftz(x))))
    z = torch.where(k > 60, const(pi_o_2 - np.float32(f32(HALF_PI_LO))), z)
    z = torch.where((k <= 60) & (hx < 0) & (k < -60), zero, z)
    out = by_m(z, -z, float(pi) - (pi_lo_neg + z), (z + pi_lo_neg) - float(pi))
    # y infinite (x finite, nonzero); x == 0 (y nonzero)
    y_inf = torch.where(hy < 0, const(-pi_o_2 - tiny), const(tiny + pi_o_2))
    out = torch.where(iy == 0x7F800000, y_inf, out)
    # x infinite
    x_inf = torch.where(iy == 0x7F800000,
                        by_m(const(tiny + pi_o_4), const(-pi_o_4 - tiny),
                             const(np.float32(3.0) * pi_o_4 + tiny),
                             const(np.float32(-3.0) * pi_o_4 - tiny)),
                        by_m(zero, -zero, const(tiny + pi), const(-pi - tiny)))
    out = torch.where(ix == 0x7F800000, x_inf, out)
    out = torch.where(ix == 0, y_inf, out)
    # y == 0
    out = torch.where(iy == 0, by_m(y, y, const(tiny + pi), const(-pi - tiny)), out)
    # x == 1 (computed only where it occurs, but always on the card: no host read)
    one = hx == 0x3F800000
    if x.is_cuda or bool(one.any()):
        out = torch.where(one, _atanf(torch.where(iy > 0x7F800000, zero, y)), out)
    # a NaN argument, or 0 / 0 from two flushed subnormals
    return torch.where(torch.isnan(out) | (ix > 0x7F800000) | (iy > 0x7F800000),
                       _nan_like(out), out)


def atan_f32(x: Tensor) -> Tensor:
    """``jnp.arctan`` in float32: XLA calls ``atan2f(x, 1)``."""
    return atan2_f32(x, torch.ones_like(x))


# glibc 2.36's __sincosf_table (sysdeps/ieee754/flt-32/sincosf_data.c) as
# float64 bit patterns: 2/pi * 2^24, pi/2, then the cosine (c0..c4) and sine
# (s1..s3) polynomials; the second table negates the cosine's; pi * 2^-62
SINCOS_HPI_INV, SINCOS_HPI = 0x41645F306DC9C883, 0x3FF921FB54442D18
SINCOS_C = (0x3FF0000000000000, 0xBFDFFFFFFD0C621C, 0x3FA55553E1068F19, 0xBF56C087E89A359D,
            0x3EF99343027BF8C3)
SINCOS_S = (0xBFC555545995A603, 0x3F81107605230BC4, 0xBF2994EB3774CF24)
SINCOS_PI63 = 0x3C1921FB54442D18
# __inv_pio4: 4/pi in 32-bit words at every 8-bit offset
INV_PIO4 = (0xA2, 0xA2F9, 0xA2F983, 0xA2F9836E, 0xF9836E4E, 0x836E4E44, 0x6E4E4415, 0x4E441529,
            0x441529FC, 0x1529FC27, 0x29FC2757, 0xFC2757D1, 0x2757D1F5, 0x57D1F534, 0xD1F534DD,
            0xF534DDC0, 0x34DDC0DB, 0xDDC0DB62, 0xC0DB6295, 0xDB629599, 0x6295993C, 0x95993C43,
            0x993C4390, 0x3C439041)
_M32 = 0xFFFFFFFF


def _mul_u32(a: Tensor, b: Tensor) -> tuple[Tensor, Tensor]:
    """The 64-bit product of two uint32 (in int64) as its high and low
    words, with no intermediate above 2^49."""
    b_lo, b_hi = b & 0xFFFF, b >> 16
    t0, t1 = a * b_lo, a * b_hi
    lo = (t0 & _M32) + ((t1 & 0xFFFF) << 16)
    hi = (t0 >> 32) + (t1 >> 16) + (lo >> 32)
    return hi & _M32, lo & _M32


def _reduce_large(bits: Tensor) -> tuple[Tensor, Tensor]:
    """glibc's ``reduce_large``: ``|x|`` (float32 bits, >= 120) reduced by
    pi/2 with 4/pi's 192-bit table, exactly in integers; returns the double
    remainder and the quadrant ``n``."""
    table = torch.tensor(INV_PIO4, dtype=torch.int64, device=bits.device)
    idx = (bits >> 26) & 15
    shift = (bits >> 23) & 7
    xi = (((bits & 0x7FFFFF) | 0x800000) << shift) & _M32
    _, res0 = _mul_u32(xi, table[idx])            # xi * arr[0], 32 bits
    r1_hi, r1_lo = _mul_u32(xi, table[idx + 4])   # xi * arr[4], 64 bits
    r2_hi, _ = _mul_u32(xi, table[idx + 8])       # xi * arr[8] >> 32
    lo = r2_hi + r1_lo
    hi = (res0 + r1_hi + (lo >> 32)) & _M32
    lo = lo & _M32
    n = (((hi + (1 << 29)) & _M32) >> 30) & 3     # (res0 + 2^61) >> 62
    hi = (hi - (n << 30)) & _M32
    signed = torch.where(hi >= 1 << 31, hi - (1 << 32), hi) * (1 << 32) + lo
    return signed.to(torch.float64) * f64(SINCOS_PI63), n


def _sin_poly(x: Tensor, x2: Tensor) -> Tensor:
    s1, s2, s3 = (f64(c) for c in SINCOS_S)
    s1p = fma_f64(x2, s3, s2)
    x3 = x2 * x
    x5 = x2 * x3
    return fma_f64(s1p, x5, fma_f64(x3, s1, x))


def _cos_poly(x2: Tensor, negate: Tensor | None) -> Tensor:
    c = [f64(b) for b in SINCOS_C]
    cs = [torch.full_like(x2, v) for v in c]
    if negate is not None:
        cs = [torch.where(negate, -v, v) for v in cs]
    x4 = x2 * x2
    c1p = fma_f64(x2, cs[1], cs[0])
    c2p = fma_f64(x2, cs[4], cs[3])
    x6 = x2 * x4
    return fma_f64(c2p, x6, fma_f64(x4, cs[2], c1p))


def _sincos_f32(y: Tensor, cosine: bool) -> Tensor:
    """glibc 2.36's FMA variant of ``sinf`` (``cosine`` False) or ``cosf``
    of float32 ``y``, evaluated in double: three ranges (below pi/4, fast
    reduction below 120, the integer reduction above), the quadrant choosing
    the polynomial and its signs."""
    bits = _bits(y)
    top = (bits >> 20) & 0x7FF
    x = y.to(torch.float64)
    sign = torch.tensor([1.0, -1.0, -1.0, 1.0], dtype=torch.float64, device=y.device)
    # |y| < pi/4
    x2 = x * x
    small = _cos_poly(x2, None) if cosine else _sin_poly(x, x2)
    # |y| < 120: r = x - n pi/2 with n from 2/pi * 2^24 rounded by the shift
    t = x * f64(SINCOS_HPI_INV)
    n_fast = ((t.to(torch.int64) + 0x800000) >> 24)
    r_fast = fma_f64(-n_fast.to(torch.float64), f64(SINCOS_HPI), x)
    # |y| >= 120
    r_large, n_large = _reduce_large(bits)
    fast = top <= 0x42E
    r = torch.where(fast, r_fast, r_large)
    n = torch.where(fast, n_fast, n_large)
    quad = torch.where(fast, n, n + (bits >> 31))  # the large range folds in y's sign
    r2 = r * r
    use_cos = ((n & 1) == 0) if cosine else ((n & 1) == 1)
    poly = torch.where(use_cos, _cos_poly(r2, (quad & 2) != 0),
                       _sin_poly(r * sign[quad & 3], r2))
    out = torch.where(top <= 0x3F3, small, poly).to(torch.float32)
    tiny = top <= 0x397
    out = torch.where(tiny, torch.ones_like(y) if cosine else y, out)
    return torch.where(top > 0x7F7, _nan_like(out), out)


def sin_f32(y: Tensor) -> Tensor:
    """glibc 2.36's ``sinf`` (the FMA + AVX2 variant) of float32 ``y``."""
    return _sincos_f32(y, cosine=False)


def cos_f32(y: Tensor) -> Tensor:
    """glibc 2.36's ``cosf`` (the FMA + AVX2 variant) of float32 ``y``."""
    return _sincos_f32(y, cosine=True)


def linspace_f32(start: float, stop: float, num: int, device=None) -> Tensor:
    """``jnp.linspace(start, stop, num, dtype=float32)`` as XLA's CPU code
    computes it, for ``num`` up to 4096. With ``c`` the float32 reciprocal
    of ``num - 1``, ``s_i = 1 - i c`` and ``t = stop * c``, element ``i <
    num - 1`` is ``fma(t, i, start * s_i)`` and the last is ``stop``. Where
    LLVM's loop runs (32 elements an iteration, ``num > 352``) ``s_i`` is
    the fused ``fma(-i, c, 1)``; the elements it leaves over, and all of a
    shorter array, are constants folded at compile time, ``s_i`` rounded
    twice; below 35 elements element 1 is ``fma(s_1, start, t)``."""
    lo, hi = np.float32(start), np.float32(stop)
    if num == 1:
        return torch.tensor([float(lo)], dtype=torch.float32, device=device)
    c = np.float32(1.0) / np.float32(num - 1)
    t = float(hi * c)
    i = torch.arange(num - 1, dtype=torch.float32, device=device)
    looped = 32 * ((num - 1) // 32) if num > 352 else 0
    s = torch.where(torch.arange(num - 1, device=device) < looped,
                    fma_f32(-i, float(c), 1.0), 1.0 - i * float(c))
    out = fma_f32(i, t, s * float(lo))
    if num <= 34:
        out[1:2] = fma_f32(s[1:2], float(lo), t)
    return torch.cat([out, torch.full((1,), float(hi), dtype=torch.float32, device=device)])


# glibc 2.36's powf (sysdeps/ieee754/flt-32/e_powf.c, the FMA variant):
# log2 in double from a 16-entry table of (1/c, log2 c) and a degree-5
# polynomial, then exp2 from a 32-entry table of 2^(i/32) and a cubic, all as
# float64 bit patterns
POWF_OFF = 0x3F330000
POWF_LOG2_T = (
    (0x3FF661EC79F8F3BE, 0xBFDEFEC65B963019), (0x3FF571ED4AAF883D, 0xBFDB0B6832D4FCA4),
    (0x3FF49539F0F010B0, 0xBFD7418B0A1FB77B), (0x3FF3C995B0B80385, 0xBFD39DE91A6DCF7B),
    (0x3FF30D190C8864A5, 0xBFD01D9BF3F2B631), (0x3FF25E227B0B8EA0, 0xBFC97C1D1B3B7AF0),
    (0x3FF1BB4A4A1A343F, 0xBFC2F9E393AF3C9F), (0x3FF12358F08AE5BA, 0xBFB960CBBF788D5C),
    (0x3FF0953F419900A7, 0xBFAA6F9DB6475FCE), (0x3FF0000000000000, 0x0000000000000000),
    (0x3FEE608CFD9A47AC, 0x3FB338CA9F24F53D), (0x3FECA4B31F026AA0, 0x3FC476A9543891BA),
    (0x3FEB2036576AFCE6, 0x3FCE840B4AC4E4D2), (0x3FE9C2D163A1AA2D, 0x3FD40645F0C6651C),
    (0x3FE886E6037841ED, 0x3FD88E9C2C1B9FF8), (0x3FE767DCF5534862, 0x3FDCE0A44EB17BCC))
POWF_LOG2_A = (0x3FD27616C9496E0B, 0xBFD71969A075C67A, 0x3FDEC70A6CA7BADD, 0xBFE7154748BEF6C8,
               0x3FF71547652AB82B)
EXP2F_SHIFT = 0x42E8000000000000  # 1.5 * 2^47: rounds to a multiple of 1/32
EXP2F_C = (0x3FAC6AF84B912394, 0x3FCEBFCE50FAC4F3, 0x3FE62E42FF0C52D6)
EXP2F_T = (
    0x3FF0000000000000, 0x3FEFD9B0D3158574, 0x3FEFB5586CF9890F, 0x3FEF9301D0125B51,
    0x3FEF72B83C7D517B, 0x3FEF54873168B9AA, 0x3FEF387A6E756238, 0x3FEF1E9DF51FDEE1,
    0x3FEF06FE0A31B715, 0x3FEEF1A7373AA9CB, 0x3FEEDEA64C123422, 0x3FEECE086061892D,
    0x3FEEBFDAD5362A27, 0x3FEEB42B569D4F82, 0x3FEEAB07DD485429, 0x3FEEA47EB03A5585,
    0x3FEEA09E667F3BCD, 0x3FEE9F75E8EC5F74, 0x3FEEA11473EB0187, 0x3FEEA589994CCE13,
    0x3FEEACE5422AA0DB, 0x3FEEB737B0CDC5E5, 0x3FEEC49182A3F090, 0x3FEED503B23E255D,
    0x3FEEE89F995AD3AD, 0x3FEEFF76F2FB5E47, 0x3FEF199BDD85529C, 0x3FEF3720DCEF9069,
    0x3FEF5818DCFBA487, 0x3FEF7C97337B9B5F, 0x3FEFA4AFA2A490DA, 0x3FEFD0765B6E4540)


def pow_f32(x: Tensor, y: float) -> Tensor:
    """``jnp.power(x, y)`` in float32 for finite ``x >= 0`` and a finite,
    nonzero Python float ``y``: XLA calls ``powf``, here glibc 2.36's (the
    FMA + AVX2 variant): ``log2(x)`` and ``2^(y log2 x)`` in double with
    double fused multiply-adds. ``0^y`` is 0 for ``y > 0``; a result below
    2^-126 is 0 (XLA's flushed conversion, and glibc's underflow below
    2^-150)."""
    dev = x.device
    ix = _bits(x)
    tmp = (ix - POWF_OFF) & _M32
    i = (tmp >> 19) & 15
    top = tmp & 0xFF800000
    iz = (ix - top) & _M32
    k = torch.where(top >= 1 << 31, top - (1 << 32), top) >> 23
    z = torch.where(iz >= 1 << 31, iz - (1 << 32), iz).to(torch.int32).view(torch.float32)
    table = torch.tensor([[f64(a), f64(b)] for a, b in POWF_LOG2_T], dtype=torch.float64,
                         device=dev)
    invc, logc = table[i, 0], table[i, 1]
    a = [f64(c) for c in POWF_LOG2_A]
    r = fma_f64(z.to(torch.float64), invc, -1.0)
    y0 = k.to(torch.float64) + logc
    poly_y = fma_f64(r, a[0], a[1])
    p = fma_f64(r, a[2], a[3])
    r2 = r * r
    q = fma_f64(r, a[4], y0)
    r4 = r2 * r2
    logx = fma_f64(poly_y, r4, fma_f64(r2, p, q))
    ylogx = float(np.float32(y)) * logx
    # exp2 of ylogx: k / 32 the nearest multiple of 1/32, s = 2^(k/32) exact
    xd = torch.clamp(ylogx, min=-160.0)
    shift = f64(EXP2F_SHIFT)
    kd = xd + shift
    kk = kd.view(torch.int64) - EXP2F_SHIFT
    rr = xd - (kd - shift)
    # EXP2F_T[i] holds the bits of 2^(i/32) less i << 47 (glibc's layout)
    tab = torch.tensor([t + (j << 47) for j, t in enumerate(EXP2F_T)], dtype=torch.int64,
                       device=dev)
    s = (tab[kk & 31] + ((kk >> 5) << 52)).view(torch.float64)
    c = [f64(v) for v in EXP2F_C]
    zz = fma_f64(rr, c[0], c[1])
    out = fma_f64(zz, rr * rr, fma_f64(rr, c[2], 1.0)) * s
    out = ftz(out.to(torch.float32))
    return torch.where((ylogx <= -150.0) | (x == 0), torch.zeros_like(out), out)


# Either dtype: the float32 route takes the functions above, JAX's bits; the
# float64 route (held to the JAX package's x64 results at a tolerance) rounds
# each operation on its own and takes torch's functions.

def xla_fma(a: Tensor, b, c) -> Tensor:
    """``a * b + c``: fused (:func:`fma_f32`) where ``a`` is float32, as
    XLA contracts it; rounded twice otherwise."""
    return fma_f32(a, b, c) if a.dtype == torch.float32 else a * b + c


def xla_exp(x: Tensor) -> Tensor:
    """:func:`exp_f32` of float32 ``x``, else ``torch.exp``."""
    return exp_f32(x) if x.dtype == torch.float32 else torch.exp(x)


def xla_atan(x: Tensor) -> Tensor:
    """:func:`atan_f32` of float32 ``x``, else ``torch.arctan``."""
    return atan_f32(x) if x.dtype == torch.float32 else torch.arctan(x)


def xla_linspace(start: float, stop: float, num: int, dtype, device=None) -> Tensor:
    """:func:`linspace_f32` in float32, else ``torch.linspace``."""
    if dtype == torch.float32:
        return linspace_f32(start, stop, num, device=device)
    return torch.linspace(start, stop, num, dtype=dtype, device=device)
