"""JAX's default counter-based random stream (``threefry2x32``, the
partitionable form), as plain torch on any device.

The port's worlds are drawn from it: the base-noise grids of the thesis,
moonyard, lab and yard DEMs (:mod:`..terrain.smallscale`), the rocks'
tangent directions (:mod:`..terrain.rocks`) and ``bench_torch.py``'s vec-env
starts. With it a seed gives the JAX package's DEM, on the CPU and on the
card alike: every step is integer arithmetic, and the one float rounding is
done the way XLA does it. The control and slip noise stay on the port's
``torch.Generator``s (drawn inside the CUDA graphs).

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
* :func:`random_bits` is ``_threefry_random_bits_partitionable``
  (``prng.py:1184``): 32-bit ``b1 ^ b2``, 64-bit ``b1 << 32 | b2``;
* :func:`uniform` is ``_uniform`` (``jax/_src/random.py:435``) for float32
  and float64.

A key is a ``(..., 2)`` int64 tensor whose entries hold uint32 words (int64
so that every operation exists on the CPU and on the card); leading axes
are a batch of keys, as ``jax.vmap`` over keys gives. In float32 ``uniform``
matches ``jax.random.uniform`` bit for bit: XLA rounds
``floats * (max - min) + min`` once (a fused multiply-add), and the product
of two float32 values is exact in float64, so the sum is formed there and
rounded to float32 once. In float64 there is no such exact intermediate and
torch has no fused multiply-add of its own, so a draw may differ from
JAX's by one unit in the last place.

No kernel: a world build draws at most ~10^4 values, once; the hash is
~100 elementwise integer operations on tensors of that size.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import Tensor

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


def _hash_iota(key: Tensor, shape: tuple) -> tuple[Tensor, Tensor]:
    """The hash of the 64-bit iota of ``shape`` (its high and low words as
    the two counts) under each key of the batch: ``key.shape[:-1] +
    shape`` each."""
    n = math.prod(shape)
    counts = torch.arange(n, dtype=torch.int64, device=key.device).reshape(shape)
    lead = key.shape[:-1]
    k1 = key[..., 0].reshape(lead + (1,) * len(shape))
    k2 = key[..., 1].reshape(lead + (1,) * len(shape))
    return threefry2x32(k1, k2, counts >> 32, counts & MASK32)


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


def random_bits(key: Tensor, bit_width: int, shape: tuple) -> Tensor:
    """``key.shape[:-1] + shape`` random words of ``bit_width`` in int64:
    32-bit words ``b1 ^ b2`` (each < 2^32); 64-bit words ``b1 << 32 | b2``,
    the uint64's bits (its top bit is int64's sign)."""
    b1, b2 = _hash_iota(key, tuple(shape))
    if bit_width == 32:
        return b1 ^ b2
    if bit_width == 64:
        return (b1 << 32) | b2
    raise ValueError(f"bit_width must be 32 or 64, not {bit_width}")


def uniform(key: Tensor, shape: tuple, dtype=torch.float32, minval: float = 0.0,
            maxval: float = 1.0) -> Tensor:
    """``jax.random.uniform(key, shape, dtype, minval, maxval)``: values in
    ``[minval, maxval)`` of ``key.shape[:-1] + shape`` on the key's device;
    bit-equal to JAX's in float32, within one unit in the last place in
    float64 (see the module's note)."""
    shape = tuple(shape)
    if dtype == torch.float32:
        bits = random_bits(key, 32, shape)
        floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
        lo, hi = np.float32(minval), np.float32(maxval)
        span = float(hi - lo)  # rounded to float32, as XLA subtracts
        # the float32 product is exact in float64: one rounding, an FMA's
        out = (floats.to(torch.float64) * span + float(lo)).to(torch.float32)
        return torch.clamp_min(out, float(lo))
    if dtype == torch.float64:
        b1, b2 = _hash_iota(key, shape)
        mantissa = (b1 << 20) | (b2 >> 12)  # the 64-bit word's top 52 bits
        floats = (mantissa | 0x3FF0000000000000).view(torch.float64) - 1.0
        lo, hi = float(minval), float(maxval)
        return torch.clamp_min(floats * (hi - lo) + lo, lo)
    raise ValueError(f"uniform draws float32 or float64, not {dtype}")
