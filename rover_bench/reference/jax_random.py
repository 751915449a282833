"""Frozen copy of ``husky_rover_mppi_isaacsim_torch/core/jax_random.py`` (commit c6c4900), the plain version
the benchmark's reference is built from; it imports nothing of the port.
Its own docstring follows.

JAX's default counter-based random stream (``threefry2x32``, the
partitionable form), as plain torch on any device.

Every draw of the port comes from it, so that a seed names the same
experiment in both packages: the worlds (the base-noise grids of the
thesis, moonyard, lab and yard DEMs, :mod:`..terrain.smallscale`; the
rocks' tangent directions, :mod:`..terrain.rocks`; ``bench_torch.py``'s
vec-env starts), the control and wheel-slip noise of every loop
(:func:`normal`) and the fixed-capacity point processes' counts. The
benchmark keeps the keys, :func:`uniform` and :func:`normal`. On the card the loops' normals are drawn by the
``jax_normal`` kernel (:mod:`..ops.jax_normal_cuda`), which this module's
:func:`normal` is the plain version of, bit for bit.

What is reproduced (jax 0.9.0, ``jax_threefry_partitionable=True``, its
default):

* :func:`key` is ``threefry_seed`` (``jax/_src/prng.py:802``): the seed's
  two 32-bit halves;
* :func:`split` is ``_threefry_split_foldlike`` (``prng.py:1156``): the
  hash of the 64-bit iota of the output shape (``iota_2x32_shape``,
  ``prng.py:989``);
* :func:`fold_in` is ``threefry_fold_in`` (``prng.py:1163``): the hash of
  ``threefry_seed(uint32(data))``; negative data wrap modulo 2^32 as
  ``jnp.asarray(data, "uint32")`` does;
* :func:`uniform` is ``_uniform`` (``jax/_src/random.py:435``) for float32
  and float64;
* :func:`normal` is ``_normal_real`` (``random.py:867``): ``sqrt(2) *
  erf_inv(uniform(key, shape, dtype, nextafter(-1, 0), 1))``.

A key is a ``(..., 2)`` int64 tensor whose entries hold uint32 words (int64
so that every operation exists on the CPU and on the card); leading axes
are a batch of keys, as ``jax.vmap`` over keys gives.

Float rounding. In float32 every operation is done the way XLA's CPU
backend does it, so ``uniform`` and ``normal`` match ``jax.random`` on the
CPU bit for bit. XLA lowers ``erf_inv`` to Giles' polynomial in ``w =
-log1p(-x^2)``, its ``log1p`` to a rational form for ``|x| < sqrt(2) - 1``
and ``log(1 + x)`` (a Cephes polynomial on the mantissa) above, and lets
LLVM contract ``a * b + c`` into fused multiply-adds wherever the product
has no other use; :func:`_erf_inv_f32` follows that code operation for
operation. torch has no fused multiply-add, so ``fma_f32`` (of
:mod:`.xla_math`, with ``sqrt_f32``) forms one exactly: the float32
product is exact in float64, the float64 sum is rounded to odd (its error
found by TwoSum), and the one rounding to float32 is then the correctly
rounded ``a * b + c``. A true FMA on the card gives the same bits. In float64 no wider type holds a product
exactly: ``uniform`` may then differ from JAX's by one unit in the last
place, and ``normal`` evaluates XLA's float64 polynomial with torch's
``log1p`` and unfused products, within a few units in the last place of
JAX's (``tests/test_torch_jax_normal.py`` states the bound).
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import Tensor

from .xla_math import f32, fma_f32, sqrt_f32

MASK32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_KS_PARITY = 0x1BD11BDA


def key(seed: int, device=None) -> Tensor:
    """``jax.random.key(seed)``'s data: ``[seed >> 32, seed & 0xFFFFFFFF]``
    of the seed as a 64-bit integer (``threefry_seed``)."""
    s = int(seed) & (2 ** 64 - 1)
    return torch.tensor([s >> 32, s & MASK32], dtype=torch.int64, device=device)


def _rotl(x: Tensor, r: int) -> Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK32


def threefry2x32(k1: Tensor, k2: Tensor, x1: Tensor, x2: Tensor) -> tuple[Tensor, Tensor]:
    """The Threefry-2x32 hash, 20 rounds (``_threefry2x32_lowering``,
    ``prng.py:883``), of the count pairs ``(x1, x2)`` under the key
    ``(k1, k2)``; every argument holds uint32 words in int64 and they
    broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ _KS_PARITY)
    x1 = (x1 + ks[0]) & MASK32
    x2 = (x2 + ks[1]) & MASK32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & MASK32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & MASK32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & MASK32
    return x1, x2


def hash_counts(key: Tensor, counts: Tensor) -> tuple[Tensor, Tensor]:
    """The hash of the 64-bit counts ``counts`` (int64, their high and low
    words as the two counts) under each key of the batch: ``key.shape[:-1]
    + counts.shape`` each."""
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,) * counts.ndim)
    k2 = key[..., 1].reshape(lead + (1,) * counts.ndim)
    return threefry2x32(k1, k2, counts >> 32, counts & MASK32)


def _hash_iota(key: Tensor, shape: tuple) -> tuple[Tensor, Tensor]:
    """The hash of the 64-bit iota of ``shape`` under each key of the
    batch: ``key.shape[:-1] + shape`` each."""
    n = math.prod(shape)
    counts = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    return hash_counts(key, counts)


def split(key: Tensor, num: int = 2) -> Tensor:
    """``jax.random.split(key, num)``'s data: ``key.shape[:-1] + (num, 2)``."""
    b1, b2 = _hash_iota(key, (num,))
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: Tensor, data) -> Tensor:
    """``jax.random.fold_in(key, data)``'s data. ``data`` is an integer or
    an integer tensor that broadcasts against the key batch; it is taken
    modulo 2^32 (a negative block index wraps, as in JAX)."""
    data = torch.as_tensor(data, device=key.device).to(torch.int64) & MASK32
    b1, b2 = threefry2x32(key[..., 0], key[..., 1], torch.zeros_like(data), data)
    return torch.stack([b1, b2], dim=-1)


def derive(key: Tensor, path: tuple) -> Tensor:
    """``key`` taken down ``path``, a tuple of steps applied in order:
    ``("split", num, index)`` is ``split(key, num)[index]``, ``("fold_in",
    data)`` is ``fold_in(key, data)`` (``data`` an integer or a 0-d integer
    tensor). The one description of a key's derivation that the
    ``jax_normal`` kernel also takes (:mod:`..ops.jax_normal_cuda`)."""
    for step in path:
        if step[0] == "split":
            _, num, index = step
            b1, b2 = hash_counts(key, torch.tensor([index], dtype=torch.int64,
                                                   device=key.device))
            key = torch.stack([b1[..., 0], b2[..., 0]], dim=-1)
        elif step[0] == "fold_in":
            key = fold_in(key, step[1])
        else:
            raise ValueError(f"a key's path has split and fold_in steps, not {step[0]!r}")
    return key


def draw_counts(shape: tuple, offset: int = 0, outer_stride: int | None = None,
                device=None) -> Tensor:
    """The iota counts of a draw of ``shape`` that is a part of a larger
    draw: ``offset + arange(n)`` laid out as ``shape``, or, with
    ``outer_stride``, ``offset + o * outer_stride + j`` for ``o`` along the
    first axis and ``j`` the flat index of the rest."""
    shape = tuple(shape)
    if outer_stride is None:
        return offset + torch.arange(math.prod(shape), dtype=torch.int64,
                                     device=device).reshape(shape)
    inner = math.prod(shape[1:])
    o = torch.arange(shape[0], dtype=torch.int64, device=device)[:, None]
    j = torch.arange(inner, dtype=torch.int64, device=device)[None, :]
    return (offset + o * outer_stride + j).reshape(shape)


def _uniform_f32(bits: Tensor, minval: float, maxval: float) -> Tensor:
    floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo, hi = np.float32(minval), np.float32(maxval)
    span = float(hi - lo)  # rounded to float32, as XLA subtracts
    return torch.clamp_min(fma_f32(floats, span, float(lo)), float(lo))


def _uniform_f64(b1: Tensor, b2: Tensor, minval: float, maxval: float) -> Tensor:
    mantissa = (b1 << 20) | (b2 >> 12)  # the 64-bit word's top 52 bits
    floats = (mantissa | 0x3FF0000000000000).view(torch.float64) - 1.0
    lo, hi = float(minval), float(maxval)
    return torch.clamp_min(floats * (hi - lo) + lo, lo)


def _uniform_counts(key: Tensor, counts: Tensor, dtype, minval: float,
                    maxval: float) -> Tensor:
    b1, b2 = hash_counts(key, counts)
    if dtype == torch.float32:
        return _uniform_f32(b1 ^ b2, minval, maxval)
    if dtype == torch.float64:
        return _uniform_f64(b1, b2, minval, maxval)
    raise ValueError(f"JAX's draws are float32 or float64, not {dtype}")


def uniform(key: Tensor, shape: tuple, dtype=torch.float32, minval: float = 0.0,
            maxval: float = 1.0) -> Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)``: values in
    ``[minval, maxval)`` of ``key.shape[:-1] + shape`` on the key's device;
    bit-equal to JAX's in float32, within one unit in the last place in
    float64 (see the module's note)."""
    shape = tuple(shape)
    counts = torch.arange(math.prod(shape), dtype=torch.int64, device=key.device)
    return _uniform_counts(key, counts.reshape(shape), dtype, minval, maxval)


# XLA's float32 erf_inv (Giles' single-precision polynomial), its
# coefficients as float32 bit patterns, highest power first: w < 5, w >= 5
ERFINV_F32_LT5 = (0x32F16588, 0x34B84B36, 0xB66C7357, 0xB6935AC1, 0x396532DB, 0xBAA45408,
                  0xBB88E4EF, 0x3E7C8F63, 0x3FC02E2F)
ERFINV_F32_GE5 = (0xB951F09B, 0x38D3B56B, 0x3AB0DC72, 0xBB70BDE7, 0x3BBC127B, 0xBBF9C5D7,
                  0x3C1AA57E, 0x3F8036DB, 0x40354F7E)
# XLA CPU's float32 log (Cephes logf): the polynomial's coefficients, the
# split ln 2 = 0.693359375 - 2.12194440e-4, sqrt(1/2)
LOGF_P = (0x3D9021BB, 0xBDEBD1B8, 0xBDFE5D4F, 0x3E11E9BF, 0x3DEF251A, 0xBE2AAE50,
          0x3E4CCEAC, 0xBE7FFFFC, 0x3EAAAAAA)
LOGF_LN2_HI, LOGF_LN2_LO, LOGF_SQRTHF = 0x3F318000, 0xB95E8083, 0x3F3504F3
# XLA's log1p for |x| < sqrt(2) - 1 (0x3ED413CD): x - x^2/2 + x^3 P(x)/Q(x)
LOG1P_SMALL = 0x3ED413CD
LOG1P_Q = (0x417101AD, 0x42A6185B, 0x435DC32D, 0x439A8CA3, 0x43586D8A, 0x42707982)
LOG1P_P = (0x383DE04B, 0x3EFF40C5, 0x40D284FA, 0x41EF4B9C, 0x4273CC76, 0x426473AD,
           0x41A05101)
SQRT2_F32 = 0x3FB504F3
NORMAL_LO_F32 = 0xBF7FFFFF  # nextafter(-1, 0)


def log_f32(t: Tensor) -> Tensor:
    """XLA CPU's float32 natural log of ``t`` > 0, operation for operation
    (module note): ``t == 0`` gives ``-inf``; a negative or NaN ``t`` gives
    NaN, ``inf`` gives ``inf``."""
    m = torch.clamp_min(t, f32(0x00800000))  # the smallest normal
    bits = m.view(torch.int32)
    e = ((bits >> 23) - 127).to(torch.float32) + 1.0
    f = ((bits & 0x7FFFFF) | 0x3F000000).view(torch.float32)  # in [0.5, 1)
    low = f < f32(LOGF_SQRTHF)
    x = (f - 1.0) + torch.where(low, f, torch.zeros_like(f))
    e = torch.where(low, e - 1.0, e)
    z = x * x
    x3 = z * x
    c = [f32(b) for b in LOGF_P]
    p1 = fma_f32(fma_f32(x, c[0], c[1]), x, c[4])
    p2 = fma_f32(fma_f32(x, c[2], c[3]), x, c[5])
    p3 = fma_f32(fma_f32(x, c[6], c[7]), x, c[8])
    q = fma_f32(x3, fma_f32(x3, p1, p2), p3)
    r = fma_f32(x3, q, e * f32(LOGF_LN2_LO))
    s = fma_f32(z, -0.5, x) + r
    out = fma_f32(e, f32(LOGF_LN2_HI), s)
    out = torch.where(t <= 0, torch.full_like(out, math.nan), out)
    out = torch.where(t == 0, torch.full_like(out, -math.inf), out)
    return torch.where(t == math.inf, t, out)


def log1p_f32(y: Tensor) -> Tensor:
    """XLA CPU's float32 ``log1p(y)``, operation for operation."""
    y2 = y * y
    base = y * 0.0
    q = base + 1.0
    for c in LOG1P_Q:
        q = fma_f32(q, y, f32(c))
    p = base + f32(LOG1P_P[0])
    for c in LOG1P_P[1:]:
        p = fma_f32(p, y, f32(c))
    t = fma_f32(y2, -0.5, (y * y2) * (p / q))
    small = y + t
    return torch.where(torch.abs(y) < f32(LOG1P_SMALL), small, log_f32(y + 1.0))


def _erf_inv_f32(x: Tensor) -> Tensor:
    l = log1p_f32(x * -x)  # noqa: E741
    lt5 = l > -5.0
    w = torch.where(lt5, -2.5 - l, sqrt_f32(-l) + -3.0)
    c = [torch.where(lt5, f32(a), f32(b)) for a, b in zip(ERFINV_F32_LT5, ERFINV_F32_GE5)]
    p = fma_f32(w, c[0], c[1])
    for ci in c[2:]:
        p = fma_f32(w, p, ci)
    p = torch.where(torch.abs(x) == 1.0, torch.full_like(p, math.inf), p)
    return x * p


# XLA's float64 erf_inv (Giles' double-precision polynomials), highest power
# first: w < 6.25 (23 terms), w < 16 (19), w >= 16 (17)
ERFINV_F64_LT625 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19, 1.2858480715256400167e-18,
    1.115787767802518096e-17, -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14, -8.1519341976054721522e-14,
    2.6335093153082322977e-12, -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09, -2.9070369957882005086e-08,
    4.2347877827932403518e-07, -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512, -0.0060336708714301490533,
    0.24015818242558961693, 1.6536545626831027356)
ERFINV_F64_LT16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08, -2.7517406297064545428e-07,
    1.8239629214389227755e-08, 1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05, -4.7318229009055733981e-05,
    6.8284851459573175448e-05, 2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313, 0.0024914420961078508066,
    -0.0037512085075692412107, 0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635)
ERFINV_F64_GE16 = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10, 1.5076572693500548083e-09,
    -3.7894654401267369937e-09, 7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08, 2.2900482228026654717e-07,
    -9.9298272942317002539e-07, 4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347, -0.00013871931833623122026,
    1.0103004648645343977, 4.8499064014085844221)


def _erf_inv_f64(x: Tensor) -> Tensor:
    w = -torch.log1p(-x * x)
    lt625, lt16 = w < 6.25, w < 16.0
    w = torch.where(lt625, w - 3.125, torch.sqrt(w) - torch.where(lt16, 3.25, 5.0))

    def coef(i):
        c = torch.full_like(x, ERFINV_F64_LT625[i])
        if i < 19:
            c = torch.where(lt625, c, ERFINV_F64_LT16[i])
        if i < 17:
            c = torch.where(lt16, c, ERFINV_F64_GE16[i])
        return c

    p = coef(0)
    for i in range(1, 17):
        p = coef(i) + p * w
    for i in range(17, 19):
        p = torch.where(lt16, coef(i) + p * w, p)
    for i in range(19, 23):
        p = torch.where(lt625, coef(i) + p * w, p)
    p = torch.where(torch.abs(x) == 1.0, torch.full_like(p, math.inf), p)
    return x * p


def normal_counts(key: Tensor, counts: Tensor, dtype=torch.float32) -> Tensor:
    """JAX's standard normals at the iota counts ``counts`` (int64) of a
    draw from ``key`` (one key, ``(2,)``): ``normal(key, shape)`` is
    ``normal_counts(key, arange(n).reshape(shape))``."""
    if dtype == torch.float32:
        u = _uniform_counts(key, counts, dtype, f32(NORMAL_LO_F32), 1.0)
        return _erf_inv_f32(u) * f32(SQRT2_F32)
    if dtype == torch.float64:
        u = _uniform_counts(key, counts, dtype, float(np.nextafter(-1.0, 0.0)), 1.0)
        return _erf_inv_f64(u) * math.sqrt(2.0)
    raise ValueError(f"JAX's normals are float32 or float64, not {dtype}")


def normal(key: Tensor, shape: tuple, dtype=torch.float32, offset: int = 0,
           outer_stride: int | None = None) -> Tensor:
    """``jax.random.normal(key, shape, dtype)`` for one key ``(2,)``, on
    the key's device: bit-equal to JAX's on the CPU in float32, within the
    module note's bound in float64. ``offset`` and ``outer_stride`` draw a
    part of a larger draw instead (:func:`draw_counts`)."""
    return normal_counts(key, draw_counts(shape, offset, outer_stride, key.device), dtype)
