"""Wrapper of kernel K1, the hand-written CUDA 2.5D rollout (csrc/rollout.cu).

Replaces the Pallas TPU kernel ``husky_rover_mppi_isaacsim_tpu/ops/
rollout_pallas.py::_kernel`` (reached through ``rollout_25d_pallas``). Same
contract as the plain :func:`..mppi.rollout.rollout_25d`: a shared start
position ``(2,)`` and raw heading ``(3,)``, velocities ``(K, H)``, and a
:class:`Rollout` of ``(K, H, 3)`` views back; ``wheels=False`` skips the
wheel lookups and returns ``left_wheel = right_wheel = trajectory``.

N rovers take one launch: positions ``(N, 2)``, headings ``(N, 3)`` and
velocities ``(N, K, H)`` give ``(N, K, H, 3)`` views, rover ``n``'s K
samples starting from its own pose (what the JAX package gets by
``jax.vmap`` over rovers).

On CPU tensors :data:`rollout_25d_cuda` runs the plain version. On CUDA
tensors one call is one launch and no other device op: the kernel projects
the start heading itself, reads the poses at their strides and the
velocities in the ``([N,] K, H)`` layout the wheel lag produces, and the
wrapper only allocates the output with ``torch.empty``. Velocities whose
``(K, H)`` part is not contiguous are copied first, and :attr:`copies`
counts it. Float32 only, one device, ``H <= MAX_HORIZON``; anything else
raises.
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from ..core.heightfield import HeightField
from ..mppi.rollout import Rollout, rollout_25d
from . import cuda_build

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
MAX_ROVERS = 65535   # gridDim.y
MAX_HORIZON = 256    # the step tables and the ring fit in a block's shared memory
ARGTYPES = [_P, _I, _I, _P, _P, _P, _P, _L, _L, _P, _L, _L, _P, _L, _P, _L, _P,
            _I, _I, _I, ctypes.c_float, _I, _P]


class CudaRollout:
    """Callable K1 wrapper. ``launches`` counts kernel launches and nothing
    else; a launch issued while the current stream captures a CUDA graph is
    recorded, not run, and counts in ``captured`` instead (each replay of
    the graph adds its launches, :mod:`..core.graphs`). ``copies`` counts
    velocity tensors that had to be made contiguous. The library is built
    at the first CUDA call."""

    source = "rollout.cu"

    def __init__(self):
        self.launches = 0
        self.captured = 0
        self.copies = 0
        self.built: cuda_build.BuiltLibrary | None = None

    def load(self) -> cuda_build.BuiltLibrary:
        if self.built is None:
            built = cuda_build.build(self.source)
            built.lib.rollout25d_f32.argtypes = ARGTYPES
            built.lib.rollout25d_check_arith.argtypes = [ctypes.c_ulonglong,
                                                         ctypes.c_ulonglong, _P, _P]
            for fn in (built.lib.rollout25d_f32, built.lib.rollout25d_check_arith):
                fn.restype = _I
            self.built = built
        return self.built

    def __call__(self, hf: HeightField, position: Tensor, heading: Tensor,
                 linear_velocities: Tensor, angular_velocities: Tensor,
                 dt: float, wheels: bool = True) -> Rollout:
        lin, ang = linear_velocities, angular_velocities
        if not lin.is_cuda:
            if any(t.is_cuda for t in (hf.z, hf.x_min, hf.y_min, hf.resolution,
                                       position, heading, ang)):
                raise ValueError("rollout inputs lie on different devices")
            # the sample axis is the rovers' last: start poses broadcast over it
            return rollout_25d(hf, position[..., None, :], heading[..., None, :], lin, ang,
                               dt, wheels=wheels)
        check_inputs(hf, position, heading, lin, ang)
        lin, ang = self.packed(lin), self.packed(ang)

        K, H = lin.shape[-2:]
        lead = lin.shape[:-2]  # () or (N,)
        with torch.cuda.device(lin.device):
            out = torch.empty((12 if wheels else 6, *lead, H, K), dtype=torch.float32,
                              device=lin.device)
            self.launch(hf, position, heading, lin, ang, out, dt)

        # (C, [N,] H, K) -> ([N,] K, H, C), then 3 channels per field
        perm = out.permute(*range(1, len(lead) + 1), -1, -2, 0)
        traj = perm[..., 0:3]
        if not wheels:
            return Rollout(traj, perm[..., 3:6], traj, traj)
        return Rollout(traj, perm[..., 3:6], perm[..., 6:9], perm[..., 9:12])

    def check_arithmetic(self, device, pairs: int = 1 << 32, seed: int = 1) -> dict:
        """Hold the chain's branch-free divisions and square roots against
        `/` and sqrtf on the card (csrc/rollout.cu, check_arith_kernel):
        ``pairs`` hashed division operand pairs and, for ``pairs >= 2**32``,
        every float32 square-root operand. Returns the operations taken in
        the fast form and the fast results that differ."""
        counts = torch.zeros(4, dtype=torch.int64, device=device)
        with torch.cuda.device(counts.device):
            rc = self.load().lib.rollout25d_check_arith(
                seed, pairs, counts.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"rollout25d_check_arith launch failed: cudaError {rc}")
        names = ("divisions_fast", "divisions_differing", "roots_fast", "roots_differing")
        return dict(zip(names, counts.tolist()))

    def packed(self, v: Tensor) -> Tensor:
        """``v`` itself when its ``(K, H)`` part is contiguous (any rover
        stride), else a contiguous copy, counted in :attr:`copies`."""
        K, H = v.shape[-2:]
        if v.stride(-1) == 1 and (K == 1 or v.stride(-2) == H):
            return v
        self.copies += 1
        return v.contiguous()

    def launch(self, hf: HeightField, position: Tensor, heading: Tensor, lin: Tensor,
               ang: Tensor, out: Tensor, dt: float) -> None:
        """Launch K1 on the current stream for inputs that passed
        :func:`check_inputs` and :meth:`packed`, into ``out`` (12 or 6, [N,]
        H, K) contiguous: 6 channels skip the wheel tracks."""
        if not out.is_contiguous() or out.shape[0] not in (6, 12):
            raise ValueError("out must be a contiguous (12 or 6, [N,] H, K) tensor")
        K, H = lin.shape[-2:]
        rovers = lin.ndim == 3
        rover_stride = lambda t: t.stride(0) if rovers else 0  # noqa: E731
        rc = self.load().lib.rollout25d_f32(
            hf.z.data_ptr(), hf.z.shape[0], hf.z.shape[1], hf.resolution.data_ptr(),
            hf.x_min.data_ptr(), hf.y_min.data_ptr(),
            position.data_ptr(), rover_stride(position), position.stride(-1),
            heading.data_ptr(), rover_stride(heading), heading.stride(-1),
            lin.data_ptr(), rover_stride(lin), ang.data_ptr(), rover_stride(ang),
            out.data_ptr(), lin.shape[0] if rovers else 1, K, H, float(dt),
            int(out.shape[0] == 12), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"rollout25d_f32 launch failed: cudaError {rc}")
        if torch.cuda.is_current_stream_capturing():
            self.captured += 1
        else:
            self.launches += 1


def check_inputs(hf: HeightField, position: Tensor, heading: Tensor, lin: Tensor,
                 ang: Tensor) -> None:
    """Raise unless K1 takes these inputs: one device, float32, velocities
    both ``(K, H)`` or ``(N, K, H)`` with ``H <= MAX_HORIZON`` and
    ``N <= MAX_ROVERS``, a ``([N,] 2)`` position and a ``([N,] 3)`` heading,
    a contiguous 2-D DEM and 0-d window scalars. Reads no data, so it also
    runs on the CPU."""
    tensors = (hf.z, hf.x_min, hf.y_min, hf.resolution, position, heading, lin, ang)
    dev = lin.device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"rollout inputs lie on different devices: {t.device}, {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"the CUDA rollout takes float32 only, got {t.dtype}")
    if lin.ndim not in (2, 3) or ang.shape != lin.shape:
        raise ValueError(f"velocities must both be (K, H) or (N, K, H), got "
                         f"{tuple(lin.shape)} and {tuple(ang.shape)}")
    lead = tuple(lin.shape[:-2])
    if position.shape != lead + (2,) or heading.shape != lead + (3,):
        raise ValueError(f"the CUDA rollout takes a {lead + (2,)} position and a "
                         f"{lead + (3,)} heading for velocities {tuple(lin.shape)}, got "
                         f"{tuple(position.shape)} and {tuple(heading.shape)}")
    if lead and not 0 < lead[0] <= MAX_ROVERS:
        raise ValueError(f"the CUDA rollout takes 1 to {MAX_ROVERS} rovers, got {lead[0]}")
    if lin.shape[-1] > MAX_HORIZON:
        raise ValueError(f"the CUDA rollout takes horizons up to {MAX_HORIZON} steps, "
                         f"got {lin.shape[-1]}")
    if hf.z.ndim != 2 or not hf.z.is_contiguous():
        raise ValueError("the DEM must be a contiguous (rows, cols) tensor")
    if any(s.ndim != 0 for s in (hf.x_min, hf.y_min, hf.resolution)):
        raise ValueError("the heightfield's window scalars must be 0-d tensors")


rollout_25d_cuda = CudaRollout()
