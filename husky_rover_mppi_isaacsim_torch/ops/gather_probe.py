"""Kernel K3, the per-lane gather probe (csrc/gather_probe.cu), its plain
formulations and its entry point.

Counterpart of ``scripts/probe_pallas_gather.py``, which asks whether the
Pallas toolchain gathers per lane from a VMEM-resident table,
``out[k] = table[j[k], i[k]]`` with a (256, 256) float32 table and (1024,)
int32 indices, in three formulations (``k_flat_take``, ``k_getitem``,
``k_take_along``). Here the three are plain torch (:data:`FORMULATIONS`) and
the gather itself is a hand-written CUDA kernel (:data:`gather_probe_cuda`).

    python -m husky_rover_mppi_isaacsim_torch.ops.gather_probe [device=cuda|cpu]

prints one ``<name>: COMPILED, correct=<bool>`` line per formulation and one
for the CUDA kernel, and exits 0 only if every one that ran is correct.
``device`` is ``cuda`` by default and raises without a card. The table is
``arange(P*P)`` as in the script, but the indices come from
``numpy.random.default_rng(0)``, not ``jax.random``: the two packages probe
different lanes.

On CPU tensors :data:`gather_probe_cuda` runs the flat ``torch.take``
formulation. On CUDA tensors it launches the kernel, or raises: a float32
table, int32 indices, one device.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch
from torch import Tensor

from . import cuda_build

P = 256   # table side (the script's P)
K = 1024  # lanes (the script's K)


def gather_flat_take(table: Tensor, i: Tensor, j: Tensor) -> Tensor:
    """``k_flat_take``: ``take`` on the flat table at ``j * cols + i``
    (the index formed in int32, as the JAX kernel does)."""
    return torch.take(table, (j * table.shape[1] + i).long())


def gather_getitem(table: Tensor, i: Tensor, j: Tensor) -> Tensor:
    """``k_getitem``: the 2-D advanced index ``table[j, i]``."""
    return table[j, i]


def gather_take_along(table: Tensor, i: Tensor, j: Tensor) -> Tensor:
    """``k_take_along``: the rows ``table[j]`` (``index_select``), then one
    element of each row (``gather``)."""
    rows = torch.index_select(table, 0, j)
    return torch.gather(rows, 1, i.long()[:, None])[:, 0]


# the script's formulations, in its order, under names that say what runs
FORMULATIONS = {
    "flat torch.take": gather_flat_take,
    "advanced getitem": gather_getitem,
    "index_select rows + gather": gather_take_along,
}


class CudaGatherProbe:
    """Callable K3 wrapper. ``launches`` counts kernel launches and nothing
    else; the library is built at the first CUDA call."""

    source = "gather_probe.cu"

    def __init__(self):
        self.launches = 0
        self.built: cuda_build.BuiltLibrary | None = None

    def load(self) -> cuda_build.BuiltLibrary:
        if self.built is None:
            built = cuda_build.build(self.source)
            fn = built.lib.gather_probe_f32
            p, n = ctypes.c_void_p, ctypes.c_int
            fn.argtypes = [p, n, n, p, p, p, n, p]
            fn.restype = n
            built.lib.gather_probe_floor.argtypes = [n, p]
            built.lib.gather_probe_floor.restype = n
            self.built = built
        return self.built

    def __call__(self, table: Tensor, i: Tensor, j: Tensor) -> Tensor:
        """``table[j[k], i[k]]`` for every lane k; indices in range (a lane
        outside the table gives NaN on the card)."""
        if table.dtype != torch.float32:
            raise TypeError(f"the gather probe takes a float32 table, got {table.dtype}")
        if i.dtype != torch.int32 or j.dtype != torch.int32:
            raise TypeError(f"the gather probe takes int32 indices, got {i.dtype}, {j.dtype}")
        if not (table.device == i.device == j.device):
            raise ValueError(f"gather inputs lie on different devices: {table.device}, "
                             f"{i.device}, {j.device}")
        if table.ndim != 2 or i.ndim != 1 or i.shape != j.shape:
            raise ValueError(f"the gather probe takes a (rows, cols) table and two equal "
                             f"(n,) index vectors, got {tuple(table.shape)}, "
                             f"{tuple(i.shape)}, {tuple(j.shape)}")
        if not table.is_cuda:
            return gather_flat_take(table, i, j)
        out = torch.empty(i.shape, dtype=torch.float32, device=table.device)
        with torch.cuda.device(table.device):
            self.launch(table.contiguous(), i.contiguous(), j.contiguous(), out)
        return out

    def launch(self, table: Tensor, i: Tensor, j: Tensor, out: Tensor) -> None:
        """Launch K3 on the current stream: contiguous ``table`` (rows, cols)
        float32, ``i``/``j`` (n,) int32, ``out`` (n,) float32, all on the
        card."""
        rc = self.load().lib.gather_probe_f32(
            table.data_ptr(), table.shape[0], table.shape[1], i.data_ptr(), j.data_ptr(),
            out.data_ptr(), i.shape[0], torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"gather_probe_f32 launch failed: cudaError {rc}")
        self.launches += 1


    def launch_floor(self, lanes: int) -> None:
        """Launch the empty kernel of K3's grid and block for ``lanes`` lanes
        on the current stream: the launch floor K3's time is held against.
        Not a launch of K3: it is not counted."""
        rc = self.load().lib.gather_probe_floor(lanes,
                                                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"gather_probe_floor launch failed: cudaError {rc}")


gather_probe_cuda = CudaGatherProbe()


def probe_inputs(device=None, seed: int = 0) -> tuple[Tensor, Tensor, Tensor]:
    """The probe's table ``arange(P*P)`` as (P, P) float32 and its int32 lane
    indices ``i``, ``j`` (K,), drawn with ``numpy.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    i = torch.from_numpy(rng.integers(0, P, K, dtype=np.int32))
    j = torch.from_numpy(rng.integers(0, P, K, dtype=np.int32))
    table = torch.arange(P * P, dtype=torch.float32).reshape(P, P)
    return table.to(device), i.to(device), j.to(device)


def main(argv=None) -> int:
    args = dict(a.split("=", 1) for a in (sys.argv[1:] if argv is None else argv))
    device = torch.device(args.get("device", "cuda"))
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={device} asked for, but no CUDA device is present; "
                           "pass device=cpu to probe the plain formulations on the CPU")
    table, i, j = probe_inputs(device)
    want = table.cpu().numpy()[j.cpu().numpy(), i.cpu().numpy()]
    all_ok = True
    runs = dict(FORMULATIONS)
    if device.type == "cuda":
        runs["cuda kernel gather_probe_f32"] = gather_probe_cuda
    for name, fn in runs.items():
        try:
            got = fn(table, i, j).cpu().numpy()
        except Exception as e:  # noqa: BLE001 — the probe reports, as the script does
            print(f"{name}: FAILED — {str(e).splitlines()[0][:140]}")
            all_ok = False
            continue
        ok = bool(np.array_equal(got, want))
        all_ok &= ok
        print(f"{name}: COMPILED, correct={ok}")
    if device.type != "cuda":
        print("cuda kernel gather_probe_f32: NOT RUN — CPU tensors take the plain version")
    return 0 if all_ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
