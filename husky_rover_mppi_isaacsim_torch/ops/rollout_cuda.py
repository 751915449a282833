"""Wrapper of kernel K1, the hand-written CUDA 2.5D rollout (csrc/rollout.cu).

Replaces the Pallas TPU kernel ``husky_rover_mppi_isaacsim_tpu/ops/
rollout_pallas.py::_kernel`` (reached through ``rollout_25d_pallas``). Same
contract as the plain :func:`..mppi.rollout.rollout_25d`: a shared start
position ``(2,)`` and heading ``(3,)``, velocities ``(K, H)``, and a
:class:`Rollout` of ``(K, H, 3)`` views back; ``wheels=False`` skips the
wheel lookups and returns ``left_wheel = right_wheel = trajectory``.

N rovers take one launch: positions ``(N, 2)``, headings ``(N, 3)`` and
velocities ``(N, K, H)`` give ``(N, K, H, 3)`` views, rover ``n``'s K
samples starting from its own pose (what the JAX package gets by
``jax.vmap`` over rovers).

On CPU tensors :data:`rollout_25d_cuda` runs the plain version. On CUDA
tensors it launches the kernel, or raises: float32 only, one device.
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from ..core.heightfield import HeightField
from ..mppi.rollout import Rollout, rollout_25d, start_heading
from . import cuda_build

_P = ctypes.c_void_p
_I = ctypes.c_int
MAX_ROVERS = 65535  # gridDim.y


class CudaRollout:
    """Callable K1 wrapper. ``launches`` counts kernel launches and nothing
    else; the library is built at the first CUDA call."""

    source = "rollout.cu"

    def __init__(self):
        self.launches = 0
        self.built: cuda_build.BuiltLibrary | None = None

    def load(self) -> cuda_build.BuiltLibrary:
        if self.built is None:
            built = cuda_build.build(self.source)
            fn = built.lib.rollout25d_f32
            fn.argtypes = [_P, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P,
                           _I, _I, _I, ctypes.c_float, _I, _P]
            fn.restype = _I
            self.built = built
        return self.built

    def __call__(self, hf: HeightField, position: Tensor, heading: Tensor,
                 linear_velocities: Tensor, angular_velocities: Tensor,
                 dt: float, wheels: bool = True) -> Rollout:
        lin, ang = linear_velocities, angular_velocities
        tensors = (hf.z, hf.x_min, hf.y_min, hf.resolution, position, heading, lin, ang)
        if not lin.is_cuda:
            if any(t.is_cuda for t in tensors):
                raise ValueError("rollout inputs lie on different devices")
            # the sample axis is the rovers' last: start poses broadcast over it
            return rollout_25d(hf, position[..., None, :], heading[..., None, :], lin, ang,
                               dt, wheels=wheels)
        _check(tensors, lin, ang, position, heading, hf)

        K, H = lin.shape[-2:]
        lead = lin.shape[:-2]  # () or (N,)
        with torch.cuda.device(lin.device):
            out = torch.empty((12 if wheels else 6, *lead, H, K), dtype=torch.float32,
                              device=lin.device)
            self.launch(hf, position.contiguous(),
                        start_heading(hf, position, heading).contiguous(),
                        lin.transpose(-1, -2).contiguous(),
                        ang.transpose(-1, -2).contiguous(), out, dt)

        # (3, [N,] H, K) -> ([N,] K, H, 3)
        view = lambda c: out[c:c + 3].permute(*range(1, len(lead) + 1), -1, -2, 0)  # noqa: E731
        traj = view(0)
        if not wheels:
            return Rollout(traj, view(3), traj, traj)
        return Rollout(traj, view(3), view(6), view(9))

    def launch(self, hf: HeightField, pos: Tensor, head0: Tensor, lin_t: Tensor,
               ang_t: Tensor, out: Tensor, dt: float) -> None:
        """Launch K1 on the current stream for N rovers (N = 1 where the
        rover axis is absent): ``pos`` ([N,] 2), ``head0`` ([N,] 3) the start
        headings projected on the start cells, ``lin_t``/``ang_t``
        ([N,] H, K), all contiguous float32 on the card; writes ``out``
        (12 or 6, [N,] H, K), 6 channels skipping the wheel tracks."""
        H, K = lin_t.shape[-2:]
        n = lin_t.shape[0] if lin_t.ndim == 3 else 1
        rc = self.load().lib.rollout25d_f32(
            hf.z.data_ptr(), hf.z.shape[0], hf.z.shape[1], hf.resolution.data_ptr(),
            hf.x_min.data_ptr(), hf.y_min.data_ptr(), pos.data_ptr(), head0.data_ptr(),
            lin_t.data_ptr(), ang_t.data_ptr(), out.data_ptr(), n, K, H, float(dt),
            int(out.shape[0] == 12), torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"rollout25d_f32 launch failed: cudaError {rc}")
        self.launches += 1


def _check(tensors, lin, ang, position, heading, hf) -> None:
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
    if hf.z.ndim != 2 or not hf.z.is_contiguous():
        raise ValueError("the DEM must be a contiguous (rows, cols) tensor")
    if any(s.ndim != 0 for s in (hf.x_min, hf.y_min, hf.resolution)):
        raise ValueError("the heightfield's window scalars must be 0-d tensors")


rollout_25d_cuda = CudaRollout()
