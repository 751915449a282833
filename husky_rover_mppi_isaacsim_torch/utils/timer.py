"""Nested scoped wall-clock profiler (counterpart of the JAX
``utils/timer.py``).

Keeps the ergonomics of the reference's ``ScopedTimer``
(src/terrain_management/large_scale_terrain/utils.py:103-158): a nestable
context manager with thread-local indentation around ``time.perf_counter``,
with optional ``torch.profiler`` annotations, and device-aware timing of
callables. A wait for the device synchronizes only the CUDA devices of the
tensors it is handed, not every device of the process.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

import torch

_local = threading.local()


class ScopedTimer:
    """``with ScopedTimer("phase", active=True): ...`` prints nested,
    indented wall-clock timings; ``.elapsed`` holds the seconds."""

    def __init__(self, name: str, active: bool = True, print_fn=print, trace: bool = False):
        self.name = name
        self.active = active
        self.print_fn = print_fn
        self.trace = trace
        self.elapsed = 0.0
        self._trace_ctx = None

    def __enter__(self):
        if not hasattr(_local, "depth"):
            _local.depth = 0
        self._depth = _local.depth
        _local.depth += 1
        if self.trace:
            self._trace_ctx = torch.profiler.record_function(self.name)
            self._trace_ctx.__enter__()
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.elapsed = time.perf_counter() - self._start
        if self._trace_ctx is not None:
            self._trace_ctx.__exit__(*exc)
        _local.depth -= 1
        if self.active:
            indent = "  " * self._depth
            self.print_fn(f"{indent}[{self.name}] {self.elapsed * 1e3:.3f} ms")
        return False


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def wait_for(tree):
    """Wait until the CUDA devices that hold ``tree``'s tensors have
    finished their queued work; returns ``tree``."""
    for device in {t.device for t in _tensors(tree) if t.is_cuda}:
        torch.cuda.synchronize(device)
    return tree


@contextmanager
def block_until_ready(tree):
    """Time a block including the device's completion of ``tree``'s
    tensors."""
    yield
    wait_for(tree)


def timed(fn, *args, iters: int = 10, warmup: int = 2):
    """Median wall-clock seconds of ``fn(*args)``, waiting for its result's
    devices each time."""
    for _ in range(warmup):
        wait_for(fn(*args))
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        wait_for(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
