"""Wrapper of the ``jax_normal`` kernel (csrc/jax_normal.cu): JAX's standard
normals from a key on the card, the key's derivation included.

No Pallas kernel stands behind it: it replaces the ``jax.random.normal``
that XLA fuses into the JAX package's jitted loops (the control noise,
``mppi/sampling.py:75-78``; the wheel slip, ``env/rover_sim.py:99-101``).
Its plain version is :func:`..core.jax_random.normal` of
:func:`..core.jax_random.derive`.

A draw ``jax_normal(key, shape, dtype, path=..., next_path=..., offset=...,
outer_stride=...)`` is ``jax_random.normal(derive(key, path), shape, dtype,
offset, outer_stride)``; with ``next_path`` it also returns
``derive(key, next_path)``, the key a loop carries on (:data:`SPLIT_SUB`
and :data:`SPLIT_NEXT` are JAX's ``key, sub = split(key)``); an empty
shape derives that key alone. A path is a
tuple of ``("split", num, index)`` and ``("fold_in", data)`` steps, ``data``
an integer or a 0-d integer tensor on the key's device (at most one such
tensor a call: a graph replays with the index it holds then).

On CPU tensors the call runs the plain version. On CUDA tensors it is one
launch and no other device op but the outputs' ``torch.empty``: float32
only, a ``(2,)`` int64 key, at most four steps a path, and it raises on
anything else; nothing falls back to the plain version.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch import Tensor

from ..core import jax_random as jr
from . import cuda_build

MAX_PATH = 4
SPLIT_SUB = (("split", 2, 1),)   # `sub` of `key, sub = split(key)`
SPLIT_NEXT = (("split", 2, 0),)  # the `key` it carries on


class KeyPath(NamedTuple):
    """A path as the kernel takes it: ``len`` hashes of ``(0, v[i])``; step
    ``device_step`` (-1: none) reads its value from the device scalar."""

    len: int
    device_step: int
    v: tuple


_P = ctypes.c_void_p
_L = ctypes.c_longlong
_PATH = [ctypes.c_int, ctypes.c_int] + [ctypes.c_uint32] * MAX_PATH
ARGTYPES = [_P, *_PATH, *_PATH, _P, _L, _L, _L, _L, _P, _P, _P]


def key_path(path: tuple, device) -> tuple[KeyPath, Tensor | None]:
    """``path`` as the kernel takes it and its device scalar (or ``None``):
    a split step hashes its index, a fold-in step its data modulo 2^32."""
    if len(path) > MAX_PATH:
        raise ValueError(f"a key path of the kernel has at most {MAX_PATH} steps, not {len(path)}")
    device_step, scalar, v = -1, None, [0] * MAX_PATH
    for i, step in enumerate(path):
        value = step[2] if step[0] == "split" else step[1] if step[0] == "fold_in" else None
        if value is None:
            raise ValueError(f"a key's path has split and fold_in steps, not {step[0]!r}")
        if isinstance(value, Tensor):
            if scalar is not None or value.numel() != 1 or value.device != device:
                raise ValueError("a path takes at most one device scalar, on the key's device")
            device_step, scalar = i, value
        else:
            v[i] = int(value) & jr.MASK32
    return KeyPath(len(path), device_step, tuple(v)), scalar


class CudaJaxNormal:
    """Callable draw wrapper (module docstring). ``launches`` counts kernel
    launches and nothing else; a launch issued while the current stream
    captures a CUDA graph counts in ``captured`` instead (each replay of
    the graph adds its launches, :mod:`..core.graphs`). The library is
    built at the first CUDA call."""

    source = "jax_normal.cu"

    def __init__(self):
        self.launches = 0
        self.captured = 0
        self.built: cuda_build.BuiltLibrary | None = None

    def load(self) -> cuda_build.BuiltLibrary:
        if self.built is None:
            built = cuda_build.build(self.source)
            built.lib.jax_normal_f32.argtypes = ARGTYPES
            built.lib.jax_normal_f32.restype = ctypes.c_int
            built.lib.jax_normal_floor.argtypes = [_L, _P]
            built.lib.jax_normal_floor.restype = ctypes.c_int
            self.built = built
        return self.built

    def __call__(self, key: Tensor, shape: tuple, dtype=torch.float32, *, path: tuple = (),
                 next_path: tuple | None = None, offset: int = 0,
                 outer_stride: int | None = None):
        shape = tuple(shape)
        if not key.is_cuda:
            noise = jr.normal(jr.derive(key, path), shape, dtype, offset, outer_stride)
            return noise if next_path is None else (noise, jr.derive(key, next_path))
        if dtype != torch.float32:
            raise ValueError(f"the jax_normal kernel draws float32, not {dtype}")
        if key.dtype != torch.int64 or tuple(key.shape) != (2,) or not key.is_contiguous():
            raise ValueError("the jax_normal kernel takes one contiguous (2,) int64 key")
        kp, scalar = key_path(path, key.device)
        np_, scalar_n = key_path(next_path or (), key.device)
        if scalar is not None and scalar_n is not None and scalar is not scalar_n:
            raise ValueError("both paths of a call read the same device scalar")
        scalar = scalar if scalar is not None else scalar_n
        if scalar is not None and (scalar.dtype != torch.int64 or not scalar.is_contiguous()):
            raise ValueError("a path's device scalar is a contiguous int64 tensor")
        outer, inner = (1, 1) if not shape else (shape[0], 1)
        for d in shape[1:]:
            inner *= d
        if outer_stride is None:  # one run of counts: the whole shape is the inner axis
            outer, inner, outer_stride = 1, outer * inner, 0
        with torch.cuda.device(key.device):
            out = torch.empty(shape, dtype=torch.float32, device=key.device)
            nxt = (torch.empty((2,), dtype=torch.int64, device=key.device)
                   if next_path is not None else None)
            rc = self.load().lib.jax_normal_f32(
                key.data_ptr(), kp.len, kp.device_step, *kp.v, np_.len, np_.device_step,
                *np_.v, scalar.data_ptr() if scalar is not None else None,
                int(offset), outer, int(outer_stride), inner, out.data_ptr(),
                nxt.data_ptr() if nxt is not None else None,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"jax_normal_f32 launch failed: cudaError {rc}")
        if torch.cuda.is_current_stream_capturing():
            self.captured += 1
        else:
            self.launches += 1
        return out if nxt is None else (out, nxt)

    def launch_floor(self, n: int) -> None:
        """Launch the empty kernel of the grid and block of an ``n``-value
        draw on the current stream: the launch floor the kernel's time is
        held against. Not a draw: it is not counted."""
        rc = self.load().lib.jax_normal_floor(int(n), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"jax_normal_floor launch failed: cudaError {rc}")


jax_normal = CudaJaxNormal()
