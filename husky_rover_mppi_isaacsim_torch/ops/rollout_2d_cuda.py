"""Wrapper of the planar rollout kernel (csrc/rollout_2d.cu), the 2D
projection arm's sample rollout.

No Pallas kernel stands behind it: it replaces the compiled ``lax.scan`` of
``husky_rover_mppi_isaacsim_tpu/mppi/rollout.py:254-297`` (``rollout_2d``),
which runs inside the JAX package's jitted goal-seek loop. Same contract as
the plain :func:`..mppi.rollout.rollout_2d`, with K1's pose and velocity
layout (:mod:`.rollout_cuda`): a start position ``(2,)`` and raw heading
``(3,)`` shared by velocities ``(K, H)``, or for N rovers positions
``(N, 2)``, headings ``(N, 3)`` and velocities ``(N, K, H)``; a pose may
also carry the unit sample axis the plain version broadcasts over (``(N,
1, 2)``). Returns ``(trajectory, headings)``, each ``([N,] K, H, 3)``
contiguous.

On CPU tensors :data:`rollout_2d_cuda` runs the plain version. On CUDA
tensors one call is one launch and no other device op but the output's
``torch.empty``: the poses are read at their strides, velocities whose
``(K, H)`` part is not contiguous are copied first and counted in
:attr:`CudaRollout2d.copies`. It takes what K1 takes (float32 only, one
device, ``H <= MAX_HORIZON``, :func:`.rollout_cuda.check_inputs`) and raises
on anything else.
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from ..core.heightfield import HeightField
from ..mppi.rollout import rollout_2d
from . import cuda_build
from .rollout_cuda import MAX_HORIZON, CudaRollout, check_inputs  # noqa: F401

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
ARGTYPES = [_P, _I, _I, _P, _P, _P, _P, _L, _L, _P, _L, _L, _P, _L, _P, _L, _P,
            _I, _I, _I, ctypes.c_float, _P]
LIBM_OPS = ("cos", "sin")


class CudaRollout2d:
    """Callable planar rollout wrapper. ``launches`` counts kernel launches
    and nothing else; a launch issued while the current stream captures a
    CUDA graph counts in ``captured`` instead (each replay of the graph adds
    its launches, :mod:`..core.graphs`). ``copies`` counts velocity tensors
    that had to be made contiguous. The library is built at the first CUDA
    call."""

    source = "rollout_2d.cu"

    def __init__(self):
        self.launches = 0
        self.captured = 0
        self.copies = 0
        self.built: cuda_build.BuiltLibrary | None = None

    def load(self) -> cuda_build.BuiltLibrary:
        if self.built is None:
            built = cuda_build.build(self.source)
            built.lib.rollout2d_f32.argtypes = ARGTYPES
            built.lib.rollout2d_libm_f32.argtypes = [_P, _P, _I, _I, _P]
            for fn in (built.lib.rollout2d_f32, built.lib.rollout2d_libm_f32):
                fn.restype = _I
            self.built = built
        return self.built

    def __call__(self, hf: HeightField, position: Tensor, heading: Tensor,
                 linear_velocities: Tensor, angular_velocities: Tensor,
                 dt: float) -> tuple[Tensor, Tensor]:
        lin, ang = linear_velocities, angular_velocities
        position, heading = rover_poses(position, lin), rover_poses(heading, lin)
        if not lin.is_cuda:
            if any(t.is_cuda for t in (hf.z, hf.x_min, hf.y_min, hf.resolution,
                                       position, heading, ang)):
                raise ValueError("rollout inputs lie on different devices")
            # the sample axis is the rovers' last: start poses broadcast over it
            return rollout_2d(hf, position[..., None, :], heading[..., None, :], lin, ang, dt)
        check_inputs(hf, position, heading, lin, ang)
        lin, ang = self.packed(lin), self.packed(ang)
        with torch.cuda.device(lin.device):
            out = torch.empty((2,) + tuple(lin.shape) + (3,), dtype=torch.float32,
                              device=lin.device)
            self.launch(hf, position, heading, lin, ang, out, dt)
        return out[0], out[1]

    packed = CudaRollout.packed  # K1's velocity layout, copies counted alike

    def launch(self, hf: HeightField, position: Tensor, heading: Tensor, lin: Tensor,
               ang: Tensor, out: Tensor, dt: float) -> None:
        """Launch the kernel on the current stream for inputs that passed
        :func:`check_inputs` and :meth:`packed`, into ``out`` (2, [N,] K, H,
        3) contiguous: the trajectory, then the headings."""
        if not out.is_contiguous() or tuple(out.shape) != (2,) + tuple(lin.shape) + (3,):
            raise ValueError("out must be a contiguous (2, [N,] K, H, 3) tensor")
        K, H = lin.shape[-2:]
        rovers = lin.ndim == 3
        rover_stride = lambda t: t.stride(0) if rovers else 0  # noqa: E731
        rc = self.load().lib.rollout2d_f32(
            hf.z.data_ptr(), hf.z.shape[0], hf.z.shape[1], hf.resolution.data_ptr(),
            hf.x_min.data_ptr(), hf.y_min.data_ptr(),
            position.data_ptr(), rover_stride(position), position.stride(-1),
            heading.data_ptr(), rover_stride(heading), heading.stride(-1),
            lin.data_ptr(), rover_stride(lin), ang.data_ptr(), rover_stride(ang),
            out.data_ptr(), lin.shape[0] if rovers else 1, K, H, float(dt),
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"rollout2d_f32 launch failed: cudaError {rc}")
        if torch.cuda.is_current_stream_capturing():
            self.captured += 1
        else:
            self.launches += 1

    def libm(self, op: str, a: Tensor) -> Tensor:
        """The kernel's libdevice ``cosf`` or ``sinf`` (``op`` ``"cos"`` or
        ``"sin"``) elementwise on contiguous float32 ``a`` on the card: the
        check of this build against torch's."""
        code = LIBM_OPS.index(op)
        out = torch.empty_like(a)
        with torch.cuda.device(a.device):
            rc = self.load().lib.rollout2d_libm_f32(
                a.data_ptr(), out.data_ptr(), a.numel(), code,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"rollout2d_libm_f32 launch failed: cudaError {rc}")
        return out


def rover_poses(pose: Tensor, lin: Tensor) -> Tensor:
    """A start pose without the unit sample axis that the plain version
    broadcasts over: ``([N,] 1, C)`` for velocities ``([N,] K, H)`` becomes
    the view ``([N,] C)``; any other shape is returned as it is."""
    if pose.ndim == lin.ndim and pose.shape[-2] == 1:
        return pose.squeeze(-2)
    return pose


rollout_2d_cuda = CudaRollout2d()
