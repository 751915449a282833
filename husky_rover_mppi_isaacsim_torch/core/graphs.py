"""CUDA-graph replay of the port's fixed-shape hot loops.

The JAX package never runs its hot path op by op: ``jax.jit``,
``lax.while_loop`` and ``lax.scan`` compile each loop body into one
program. The PyTorch counterpart of such a program is a captured
``torch.cuda.CUDAGraph``: :class:`Graphed` wraps a function of tensors and,
on the card, replays one graph per call.

A call of a :class:`Graphed` function:

* takes a pytree of arguments (tuples, lists, dicts and NamedTuples of
  tensors); every other leaf (a config, an int, ``None``) is a constant of
  the graph;
* on CUDA tensors, copies each tensor into the graph's static input buffer,
  replays the graph on the current stream, and returns the graph's static
  outputs. The first call runs the function eagerly (its warm-up: kernel
  builds, cuBLAS handles and the caching allocator's first blocks happen
  there, outside any capture); the second call captures the graph on a
  side stream and every later call only copies and replays. A failed
  capture raises with its cause; nothing falls back to eager on the card;
* on CPU tensors, calls the function itself, so the CPU tests run the eager
  code the graph is held against.

Either way a call whose tree structure, constants, shapes, dtypes or device
differ from the first call's raises ``ValueError``: a graph is built for
one signature. The device alone decides whether a graph runs; there is no
switch.

``in_place_args`` names positional arguments whose tensors the graph reads
where they lie: no static buffer, no copy on replay. The caller keeps them
and updates them in place (the streamed chunk's 7000^2 window and its
costmap, re-seated by a copy at a block shift, not at every chunk). Every
call must pass the very tensors of the first call there, on the CPU as on
the card; another tensor raises ``ValueError``, since the graph would go on
reading the first one.

Two traps follow from replaying. The outputs are the graph's own buffers:
the next replay overwrites them, so a caller that keeps an output across
calls clones it. And whatever the function reads from Python (a float, a
frame origin, the shape of a tensor) is frozen at capture: a value that
changes between calls must come in as a tensor.

With the tracer on (:mod:`.trace`), a call records the spans
``graphed.copy_in``, ``graphed.eager``, ``graphed.capture`` and
``graphed.replay``, times the warm-up call and each replay on the card, and
a capture turns the traced function's phase marks into event nodes of the
graph. While it is off a call checks :data:`.trace.ON` and nothing else.

Kernel launch counts: a kernel wrapper counts only the launches it issues
outside a capture (``ops/rollout_cuda.py``, ``ops/rollout_2d_cuda.py``,
``ops/jax_normal_cuda.py``; the
``captured`` counter for those recorded into a graph); every replay adds the
launches its graph holds to the wrapper's ``launches``, since a replay
launches them.
"""

from __future__ import annotations

import gc
import time
from typing import Any, Callable

import torch
import torch.utils._pytree as pytree

from . import trace


def _counted() -> tuple:
    """The kernel wrappers whose launches a captured function may hold
    (imported here: the wrappers' modules import ``core``)."""
    from ..ops import jax_normal_cuda, rollout_2d_cuda, rollout_cuda

    return (rollout_cuda.rollout_25d_cuda, rollout_2d_cuda.rollout_2d_cuda,
            jax_normal_cuda.jax_normal)


def _signature(leaves: list) -> tuple:
    """What a graph is built for: each tensor's shape, dtype and device,
    and every other leaf by value."""
    return tuple(("tensor", tuple(t.shape), t.dtype, t.device) if isinstance(t, torch.Tensor)
                 else ("const", t) for t in leaves)


class Graphed:
    """``fn`` replayed as one CUDA graph per call on the card, called as it
    is on the CPU (module docstring). ``replays`` counts replays,
    ``capture_ms`` is the host time of the capture (``None`` before it);
    the tensors of the positional arguments ``in_place_args`` are read in
    place and never copied."""

    def __init__(self, fn: Callable[..., Any], in_place_args: tuple[int, ...] = ()):
        self.fn = fn
        self.in_place_args = frozenset(in_place_args)
        self._in_place: list | None = None  # the in-place arguments' tensors, by identity
        self.replays = 0
        self.capture_ms: float | None = None
        self._spec = None          # (tree structure, signature) of the first call
        self._warm = False         # the warm-up call ran
        self._graph: torch.cuda.CUDAGraph | None = None
        self._static_in: list = []
        self._static_out = None
        self._launches: dict = {}  # wrapper -> launches one replay holds
        self._marks: tuple = ()    # the trace's phase marks the graph records

    def __call__(self, *args):
        if trace.ON:
            return self._call_traced(args)
        leaves, tree, on_card = self._take(args)
        if not on_card:
            return self.fn(*args)
        if not self._warm:  # the warm-up, eager on the caller's stream
            self._warm = True
            return self.fn(*args)
        if self._graph is None:
            self._capture(leaves, tree)
        self._copy_in(leaves)
        self._graph.replay()
        self._replayed()
        return self._static_out

    def _call_traced(self, args):
        """:meth:`__call__` while the tracer is on (:mod:`.trace`): the
        spans ``graphed.copy_in`` (the arguments checked and copied into the
        static inputs), ``graphed.eager``, ``graphed.capture`` and
        ``graphed.replay`` of one request, the warm-up call and each replay
        timed on the card as well."""
        trace.watch(self)
        rid = trace.request()
        with trace.span("graphed.copy_in", rid):
            leaves, tree, on_card = self._take(args)
            ready = on_card and self._graph is not None
            if ready:
                self._copy_in(leaves)
        if not on_card:
            return self.fn(*args)
        if not self._warm:
            self._warm = True
            trace.count("graphed.eager_calls")
            with trace.span(trace.EAGER, rid) as s, trace.device_run(s, trace.EAGER, None):
                return self.fn(*args)
        if not ready:
            self._capture(leaves, tree)
            with trace.span("graphed.copy_in", rid):
                self._copy_in(leaves)
        with trace.span(trace.REPLAY, rid) as s, trace.device_run(s, trace.REPLAY, self._marks):
            self._graph.replay()
        self._replayed()
        return self._static_out

    def _take(self, args) -> tuple:
        """The call's leaves and tree structure, checked against the graph's
        signature, and whether its tensors are on the card."""
        leaves, tree = pytree.tree_flatten(args)
        spec = (tree, _signature(leaves))
        in_place = [t for i, a in enumerate(args) if i in self.in_place_args
                    for t in pytree.tree_leaves(a) if isinstance(t, torch.Tensor)]
        if self._spec is None:
            self._spec, self._in_place = spec, in_place
        elif spec != self._spec:
            raise ValueError(f"{self.name}: called with another structure, constant, shape, "
                             f"dtype or device than the graph is built for:\n{spec}\n"
                             f"against\n{self._spec}")
        elif any(a is not b for a, b in zip(in_place, self._in_place)):
            raise ValueError(f"{self.name}: an in-place argument {sorted(self.in_place_args)} "
                             "is another tensor than the first call's; update it in place")
        tensors = [t for t in leaves if isinstance(t, torch.Tensor)]
        if not any(t.is_cuda for t in tensors):
            return leaves, tree, False
        if not all(t.is_cuda for t in tensors):
            raise ValueError(f"{self.name}: tensors on the card and on the CPU in one call")
        return leaves, tree, True

    def _copy_in(self, leaves: list) -> None:
        for buf, t in zip(self._static_in, leaves):
            if buf is not None and t is not buf:
                buf.copy_(t)

    def _replayed(self) -> None:
        self.replays += 1
        for wrapper, n in self._launches.items():
            wrapper.launches += n

    @property
    def name(self) -> str:
        return getattr(self.fn, "__qualname__", repr(self.fn))

    def _capture(self, leaves: list, tree) -> None:
        """Allocate the static inputs (each in its first argument's layout;
        the in-place arguments' tensors are used as they are) and capture one
        call of ``fn`` on them on a side stream (with the tracer on, its
        phase marks become event nodes of the graph)."""
        t0 = time.perf_counter_ns()
        device = next(t.device for t in leaves if isinstance(t, torch.Tensor))
        in_place = {id(t) for t in self._in_place}
        self._static_in = [torch.empty_like(t)
                           if isinstance(t, torch.Tensor) and id(t) not in in_place else None
                           for t in leaves]
        args = pytree.tree_unflatten([b if b is not None else t
                                      for b, t in zip(self._static_in, leaves)], tree)
        current = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device=device)
        side.wait_stream(current)  # the static buffers were allocated on `current`
        graph = torch.cuda.CUDAGraph()
        counted = _counted()
        before = {w: w.captured for w in counted}
        traced = trace.ON
        # no cyclic garbage collection while capturing: a collected graph
        # frees its memory pool, a call that invalidates the capture
        collecting = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.device(device), torch.cuda.stream(side):
                # thread_local: another thread's CUDA calls (the streamed
                # loop's terrain worker) stay legal while this one captures
                graph.capture_begin(capture_error_mode="thread_local")
                try:
                    if traced:
                        with trace.capturing() as marks:
                            out = self.fn(*args)
                        self._marks = tuple(marks)
                    else:
                        out = self.fn(*args)
                except BaseException as exc:
                    _abandon(graph)
                    raise RuntimeError(f"{self.name}: CUDA graph capture failed: {exc!r}") from exc
                try:
                    graph.capture_end()
                except RuntimeError as exc:
                    raise RuntimeError(f"{self.name}: CUDA graph capture failed: {exc!r}") from exc
        finally:
            if collecting:
                gc.enable()
        current.wait_stream(side)
        self._launches = {w: w.captured - before[w] for w in counted}
        self._graph, self._static_out = graph, out
        t1 = time.perf_counter_ns()
        self.capture_ms = 1e-6 * (t1 - t0)
        trace.add("graphed.capture", t0, t1)
        trace.count("graphed.captures")


def _abandon(graph: torch.cuda.CUDAGraph) -> None:
    """End a capture whose function raised, so that the stream leaves
    capture mode; the error that ending it gives is the first one's
    consequence and is not raised over it."""
    try:
        graph.capture_end()
    except RuntimeError:
        pass
