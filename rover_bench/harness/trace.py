"""The traced slice of a ``--trace 1`` run and its reduction.

The driver reports its cumulative counters (control steps, ...) after
every unit of work it dispatches; the tracer opens ``torch.profiler`` (CUDA
activity and the host's operations) at a unit's boundary, after a
synchronize, once only the last ``last_s`` seconds of the window remain,
and closes it after the window has been timed, after another synchronize.
So the profiler's own stop and the reduction fall outside the window. The
slice's counters are the difference of the two readings, so the kernels in
the trace and the work counted belong to the same span.
The reduction keeps each device operation's name, start and length, and
each host operation's, in memory.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch


class Op(NamedTuple):
    name: str
    start_ns: int
    dur_ns: int


class Trace(NamedTuple):
    """A reduced traced slice."""

    window_s: float          # host seconds between the two synchronizes
    device_ops: list         # Op of every kernel, copy and fill on the card
    host_ops: list           # Op of every host operation and runtime call
    counters: dict           # the cell driver's counters over the slice
    busy_s: float            # union of the device operations' intervals

    def kernel_s(self, symbols) -> float:
        """Seconds of the device operations whose name holds one of
        ``symbols``."""
        return sum(op.dur_ns for op in self.device_ops
                   if any(s in op.name for s in symbols)) * 1e-9

    def kernels(self) -> list:
        """The kernels alone (no copies or fills)."""
        return [op for op in self.device_ops if not _is_transfer(op.name)]

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the longest idle
        gaps named by the host operation that overlapped them most."""
        by_name: dict = {}
        for op in self.device_ops:
            by_name[op.name] = by_name.get(op.name, 0) + op.dur_ns
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps = []
        merged = _merge(self.device_ops)
        for (_, e0), (s1, _) in zip(merged, merged[1:]):
            if s1 > e0:
                gaps.append((e0, s1))
        gaps.sort(key=lambda g: g[0] - g[1])
        host = sorted(self.host_ops, key=lambda o: o.start_ns)
        named = []
        for g0, g1 in gaps[:top]:
            best, overlap = "none", 0
            for op in host:
                if op.start_ns >= g1:
                    break
                o = min(g1, op.start_ns + op.dur_ns) - max(g0, op.start_ns)
                if o > overlap:
                    best, overlap = op.name, o
            named.append([best, (g1 - g0) * 1e-9])
        return {"device_ops": [[n, t * 1e-9] for n, t in ops], "idle_gaps": named}


def _is_transfer(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


def _merge(ops: list) -> list:
    spans = sorted((op.start_ns, op.start_ns + op.dur_ns) for op in ops)
    out: list = []
    for s, e in spans:
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


class Tracer:
    """Opens and closes the profiler at unit boundaries of the window
    (module docstring). ``result`` is the reduced :class:`Trace` once the
    slice has closed."""

    def __init__(self, last_s: float, device: torch.device):
        self.last_s, self.device = last_s, device
        self.open_at: float | None = None
        self._prof = None
        self._t0 = 0.0
        self._c0: dict = {}
        self.result: Trace | None = None

    def open_window(self, seconds: float) -> None:
        self.open_at = time.perf_counter() + max(0.0, seconds - self.last_s)

    def tick(self, counters: dict) -> None:
        """The driver's cumulative counters after one unit of work."""
        if self._prof is not None or self.result is not None or self.open_at is None:
            return
        if time.perf_counter() >= self.open_at:
            self._sync()
            self._prof = self._profiler()
            self._prof.__enter__()
            self._c0 = dict(counters)
            self._t0 = time.perf_counter()

    def close(self, counters: dict) -> None:
        """Close the slice once the window has been timed."""
        if self._prof is None or self.result is not None:
            return
        self._sync()
        window_s = time.perf_counter() - self._t0
        self._prof.__exit__(None, None, None)
        delta = {k: counters[k] - self._c0.get(k, 0) for k in counters}
        self.result = reduce(self._prof, window_s, delta)
        self._prof = None

    def _profiler(self):
        from torch.profiler import ProfilerActivity, profile

        return profile(activities=[ProfilerActivity.CUDA, ProfilerActivity.CPU])

    def warm_up(self) -> None:
        """Open and close the profiler once on a tiny op, so that its
        first start (CUPTI's set-up, seconds) falls into the run's set-up
        and not into the window."""
        x = torch.ones(8, device=self.device)
        with self._profiler():
            (x + 1).sum().item()
        self._sync()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def reduce(prof, window_s: float, counters: dict) -> Trace:
    """Device and host operations of a closed profiler, as :class:`Op`."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        op = Op(e.name(), int(e.start_ns()), int(e.duration_ns()))
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append(op)
        else:
            host.append(op)
    busy = sum(e - s for s, e in _merge(dev)) * 1e-9
    return Trace(window_s, dev, host, counters, busy)
