"""Measurements of the kernels' paths on the card, for ``chip_smoke.py``,
``scripts/torch_kernel_variants.py`` and the tests marked ``gpu``.

:func:`cuda_ms` times back-to-back calls between two CUDA events, which
includes the host's issue time when a call is shorter than it.
:func:`graph_ms` captures ``launches`` calls into one CUDA graph and times
its replay, so that only the device's time per launch remains.
:class:`OpLog` records the torch operators a call dispatches, and
:func:`device_kernels` counts the kernels a call runs on the card.
"""

from __future__ import annotations

import statistics
from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode


def cuda_ms(fn: Callable[[], object], reps: int = 7, inner: int = 1) -> float:
    """Median over ``reps`` of the CUDA-event time of ``inner`` back-to-back
    calls, per call (one warm-up call first)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def graph_ms(fn: Callable[[], object], launches: int = 20, reps: int = 7) -> float:
    """Median over ``reps`` of one replay of a CUDA graph of ``launches``
    calls, per call. ``fn`` must launch on the current stream and allocate
    nothing (one warm-up call runs before the capture)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return statistics.median(times)


class OpLog(TorchDispatchMode):
    """Within ``with OpLog() as log:``, ``log.ops`` lists every torch
    operator dispatched, in order; :attr:`device_ops` drops the views, which
    only make new tensor metadata."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(func)
        return func(*args, **(kwargs or {}))

    @property
    def device_ops(self) -> list:
        return [f for f in self.ops if not f.is_view]


def device_kernels(fn: Callable[[], object]) -> int:
    """Kernels that one call of ``fn`` runs on the card, counted by
    ``torch.profiler`` (memory copies and sets excluded). Raises where the
    profiler records no kernel: a count of 0 would pass for "no device
    work" when the profiler saw nothing."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = sum(1 for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and not e.name.startswith(("Memcpy", "Memset")))
    if kernels == 0:
        raise RuntimeError("torch.profiler recorded no kernel on the card")
    return kernels
