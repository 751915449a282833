"""Measurements of the kernels' paths on the card, for ``chip_smoke.py``,
``scripts/torch_kernel_variants.py`` and the tests marked ``gpu``.

:func:`cuda_ms` times back-to-back calls between two CUDA events, which
includes the host's issue time when a call is shorter than it.
:func:`graph_ms` captures ``launches`` calls into one CUDA graph and times
its replay, so that only the device's time per launch remains.
:func:`cold_ms` times one call at a time after evicting the card's L2
cache, as a call meets inputs that were written long before it.
:class:`OpLog` records the torch operators a call dispatches,
:func:`device_kernels` counts the kernels a call runs on the card, and
:func:`device_time` sums their time there by name, :func:`launch_calls`
counts the host's kernel launches and copies (a CUDA graph replay is one),
and :func:`issue_ms` times calls issued back to back with one synchronize
at the end.
"""

from __future__ import annotations

import statistics
import time
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
    calls, per call. ``fn`` must launch on the current stream; what it
    allocates comes from the graph's pool, as inside the loops' graphs (one
    warm-up call runs before the capture)."""
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


def cold_ms(fn: Callable[[], object], reps: int = 7, reset: Callable[[], object] | None = None,
            evict_bytes: int = 256 << 20) -> float:
    """Median over ``reps`` of the CUDA-event time of one call of ``fn``,
    each after ``reset`` (where given: to restore what ``fn`` writes) and
    after writing ``evict_bytes`` elsewhere, which evicts the inputs from
    the L2 cache (50 MB on an H100). One warm-up call first."""
    scratch = torch.empty(evict_bytes, dtype=torch.uint8, device="cuda")
    fn()
    times = []
    for _ in range(reps):
        if reset is not None:
            reset()
        scratch.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def issue_ms(fn: Callable[[], object], calls: int, device) -> float:
    """Host wall time per call, in ms, of ``calls`` calls of ``fn`` issued
    back to back with no host read between them and one synchronize at the
    end (after one synchronized warm-up call). On the card that is the
    device's time where the device is the slower side, else the host's
    issue time."""
    device = torch.device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    sync()
    return 1e3 * (time.perf_counter() - t0) / calls


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


def _profiled_events(fn: Callable[[], object]):
    """The device events of one call of ``fn`` under ``torch.profiler`` and
    the host's wall time of the call (ended by a synchronize), in ms."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA], wall_ms


def device_kernels(fn: Callable[[], object], sessions: int = 6) -> int:
    """Kernels that one call of ``fn`` runs on the card, counted by
    ``torch.profiler`` (memory copies and sets excluded). ``fn`` must run the
    same kernels at every call, because it is called once per profiler
    session and there are at least two: now and then a session drops device
    records, a one-kernel call's only one included
    (``scripts/torch_profiler_drops.py`` counts how often), and what it drops
    only lowers the count. So the count returned is the largest one read,
    once two sessions have read it, or else the largest of ``sessions``
    sessions: a call of ~14,500 kernels loses a few records in most
    sessions, so that its largest count may not come twice. Raises where
    no count is above 0: a count of 0 would pass for "no device work" when
    the profiler saw nothing."""
    counts = []
    for _ in range(sessions):
        events, _ = _profiled_events(fn)
        counts.append(sum(1 for e in events if not e.name.startswith(("Memcpy", "Memset"))))
        top = max(counts)
        if top > 0 and counts.count(top) >= 2:
            return top
    if max(counts) > 0:
        return max(counts)
    raise RuntimeError(f"torch.profiler read no kernel count above 0: {counts}")


# the CUDA API calls (runtime and `cu*`) that put work on a stream: a kernel
# launch, a graph replay, an asynchronous copy or set
LAUNCH_CALLS = frozenset(("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                          "cuLaunchKernelEx", "cudaGraphLaunch", "cudaMemcpyAsync",
                          "cudaMemsetAsync"))


def launch_calls(fn: Callable[[], object], sessions: int = 2) -> dict:
    """The host's calls that put work on a stream during one call of
    ``fn``, by name (:data:`LAUNCH_CALLS`), from ``torch.profiler``'s
    record of the runtime API; the largest total of ``sessions``
    sessions."""
    from torch.profiler import ProfilerActivity, profile

    best: dict = {}
    for _ in range(sessions):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        counts: dict = {}
        for e in prof.events():
            if e.name in LAUNCH_CALLS:
                counts[e.name] = counts.get(e.name, 0) + 1
        if sum(counts.values()) > sum(best.values()):
            best = counts
    return best


def device_time(fn: Callable[[], object], top: int = 8, sessions: int = 3) -> dict:
    """Time on the card of one call of ``fn``, from ``torch.profiler``: the
    host's wall time of the call (ended by a synchronize), the summed
    duration of its kernels and memory operations (``busy_ms``: what the
    card is not idle for), their count, and the ``top`` names by summed
    time as ``[name, ms, count]``. A session that recorded no device time
    (see :func:`device_kernels`) is made again; raises after ``sessions``
    of them."""
    for _ in range(sessions):
        events, wall_ms = _profiled_events(fn)
        by_name: dict = {}
        for e in events:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + (e.time_range.end - e.time_range.start) / 1e3, n + 1)
        busy_ms = sum(ms for ms, _ in by_name.values())
        if busy_ms > 0.0:
            break
    else:
        raise RuntimeError("torch.profiler recorded no device time")
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"wall_ms_profiled": wall_ms, "busy_ms": busy_ms,
            "events": sum(n for _, n in by_name.values()),
            "top": [[name[:60], ms, n] for name, (ms, n) in ranked]}
