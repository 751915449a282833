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
* on CUDA tensors, copies each tensor into the graph's static input buffer
  (one launch of the batched copy kernel, ``ops/batched_copy_cuda.py``, on
  the current stream), replays the graph on the current stream, and
  returns the graph's static outputs. The first call runs the function eagerly (its warm-up: kernel
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

Between replays the host does as little as that check allows. A
positional argument that is the last call's very object, and whose tree
cannot change in place (a tensor, a constant, a tuple or NamedTuple of
such: no list or dict), keeps the leaves it had, only its tensors' shapes,
dtypes and devices checked again; every other argument is flattened and
checked. A loop that feeds the graph's outputs back in passes the same
objects at every call. The static inputs are filled as :func:`copy_plan`
says: a leaf that is its own static input is skipped, a source that
overlaps a static input (an output that is a view of an input) or that
the kernel does not take (more than four dims, a complex or quantized
dtype) is copied by ``copy_``, in leaf order around the launches, and the
rest by the batched copy. The plan is kept while the sources keep their
strides; a batched source that only moved has its record's address
rewritten. The last call's arguments stay referenced until the next call.

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
``ops/jax_normal_cuda.py``; the batched copy's launches are never
captured; the
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

from ..ops import batched_copy_cuda
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


# constants that stay equal to what they once equalled
_IMMUTABLE = (int, float, complex, bool, str, bytes, type(None), torch.dtype, torch.device)


def _frozen(a) -> bool:
    """Whether ``a`` holds the same leaves for as long as it is the same
    object: a leaf, or a tuple or NamedTuple of such (no list, dict or
    other pytree node, whose contents can change in place)."""
    t = type(a)
    if t is tuple or (issubclass(t, tuple) and hasattr(t, "_fields")):
        return all(_frozen(x) for x in a)
    return not isinstance(a, (tuple, list, dict)) and t not in pytree.SUPPORTED_NODES


SKIP, BATCH, COPY = "skip", "batch", "copy"


def _overlaps(t: torch.Tensor, extents: list) -> bool:
    """Whether ``t``'s bytes meet any of ``extents`` (``[start, end)``)."""
    e = batched_copy_cuda.extent(t)
    return e is not None and any(e[0] < hi and lo < e[1] for lo, hi in extents)


def _copy_kind(buf: torch.Tensor, t: torch.Tensor, extents: list) -> tuple[str, bytes | None]:
    """How the copy-in fills the static input ``buf`` from ``t``: not at
    all where ``t`` is ``buf`` (:data:`SKIP`); by ``copy_`` (:data:`COPY`)
    where the batched copy cannot take ``t`` or ``t`` overlaps a static
    input (``extents``: their bytes), so that a copy would read what
    another writes; else by the batched copy (:data:`BATCH`), with its
    record."""
    if t is buf:
        return SKIP, None
    if not batched_copy_cuda.takes(t) or _overlaps(t, extents):
        return COPY, None
    r = batched_copy_cuda.row(buf, t)
    return (COPY, None) if r is None else (BATCH, r)


def _extents(static_in: list) -> list:
    """The static inputs' bytes, ``[start, end)`` each."""
    return [e for b in static_in if b is not None
            for e in (batched_copy_cuda.extent(b),) if e is not None]


def _steps(kinds: list) -> list:
    """Leaves ``(j, kind)`` in leaf order as the copy-in's steps: each run
    of batched leaves one ``(BATCH, [j, ...])``, each other copied leaf
    ``(COPY, [j])``. In this order every copy reads what ``copy_`` in leaf
    order would: only a copied leaf may read a static input."""
    steps: list = []
    for j, kind in kinds:
        if kind == BATCH and steps and steps[-1][0] == BATCH:
            steps[-1][1].append(j)
        elif kind != SKIP:
            steps.append((kind, [j]))
    return steps


def copy_plan(static_in: list, leaves: list) -> list:
    """The copy-in of a call's ``leaves`` into the static inputs
    ``static_in`` (``None`` where a leaf has none) as :func:`_steps`, in
    leaf order: ``(BATCH, [j, ...], records)`` for the leaves one launch
    of the batched copy fills (their records packed in a ``bytearray``),
    ``(COPY, [j], None)`` for a leaf ``copy_`` fills; a leaf that is its
    own static input is skipped."""
    extents = _extents(static_in)
    kinds, rows = [], {}
    for j, b in enumerate(static_in):
        if b is not None:
            kind, rows[j] = _copy_kind(b, leaves[j], extents)
            kinds.append((j, kind))
    return [(kind, js, bytearray(b"".join(rows[j] for j in js)) if kind == BATCH else None)
            for kind, js in _steps(kinds)]


class _Slot:
    """A static input and its source at the last copy-in: the tensor, its
    address and strides, and for a batched one its record (``at`` in the
    plan's ``packed`` records)."""

    __slots__ = ("j", "buf", "src", "ptr", "stride", "packed", "at")

    def __init__(self, j: int, buf: torch.Tensor):
        self.j, self.buf, self.src = j, buf, None
        self.ptr = self.stride = self.packed = self.at = None


class _Arg:
    """A positional argument of the last call: the object, its leaves and,
    once it came again, its tensors with the shape, dtype and device to
    check again and whether it may be reused (:meth:`Graphed._reuse`)."""

    __slots__ = ("obj", "leaves", "tensors", "reusable")

    def __init__(self, obj, leaves: list):
        self.obj, self.leaves, self.tensors, self.reusable = obj, leaves, None, False


def _whole(specs: list) -> tuple:
    """The tree structure and signature of a whole call from its
    arguments' ``(tree structure, signature)``."""
    tree = pytree.tree_structure(tuple(pytree.tree_unflatten([0] * t.num_leaves, t)
                                       for t, _ in specs))
    return tree, tuple(x for _, sig in specs for x in sig)


class Graphed:
    """``fn`` replayed as one CUDA graph per call on the card, called as it
    is on the CPU (module docstring). ``replays`` counts replays,
    ``capture_ms`` is the host time of the capture (``None`` before it);
    the tensors of the positional arguments ``in_place_args`` are read in
    place and never copied. ``args_reused`` and ``args_checked`` count the
    positional arguments taken from the last call by identity and those
    checked; ``batched_copies`` and ``copy_fallbacks`` the static inputs
    filled by the batched copy kernel and by ``copy_``."""

    def __init__(self, fn: Callable[..., Any], in_place_args: tuple[int, ...] = ()):
        self.fn = fn
        self.in_place_args = frozenset(in_place_args)
        self.replays = 0
        self.capture_ms: float | None = None
        self.args_reused = 0
        self.args_checked = 0
        self.batched_copies = 0
        self.copy_fallbacks = 0
        self._specs: list | None = None  # each positional argument's (tree, signature), first call
        self._in_place_of: dict = {}  # in-place argument -> its tensors at the first call
        self._last: list = []      # an _Arg a positional argument of the last call
        self._on_card = False
        self._warm = False         # the warm-up call ran
        self._graph: torch.cuda.CUDAGraph | None = None
        self._static_in: list = []
        self._static_out = None
        self._slots: list = []     # a _Slot a static input
        self._extents: list = []   # the static inputs' bytes (_extents)
        self._device = None        # the card's index
        self._plan: list = []      # the copy-in's steps (copy_plan)
        self._launches: dict = {}  # wrapper -> launches one replay holds
        self._marks: tuple = ()    # the trace's phase marks the graph records

    def __call__(self, *args):
        if trace.ON:
            return self._call_traced(args)
        leaves, on_card = self._take(args)
        if not on_card:
            return self.fn(*args)
        if not self._warm:  # the warm-up, eager on the caller's stream
            self._warm = True
            return self.fn(*args)
        if self._graph is None:
            self._capture(leaves)
        self._copy_in(leaves)
        self._graph.replay()
        self._replayed()
        return self._static_out

    def _call_traced(self, args):
        """:meth:`__call__` while the tracer is on (:mod:`.trace`): the
        spans ``graphed.copy_in`` (the arguments checked and copied into the
        static inputs), ``graphed.eager``, ``graphed.capture`` and
        ``graphed.replay`` of one request, the warm-up call and each replay
        timed on the card as well, and the counters ``graphed.args_reused``,
        ``graphed.args_checked``, ``graphed.batched_copies`` and
        ``graphed.copy_fallbacks``."""
        trace.watch(self)
        rid = trace.request()
        before = self._counts()
        with trace.span("graphed.copy_in", rid):
            leaves, on_card = self._take(args)
            ready = on_card and self._graph is not None
            if ready:
                self._copy_in(leaves)
        if not on_card:
            self._count_since(before)
            return self.fn(*args)
        if not self._warm:
            self._warm = True
            self._count_since(before)
            trace.count("graphed.eager_calls")
            with trace.span(trace.EAGER, rid) as s, trace.device_run(s, trace.EAGER, None):
                return self.fn(*args)
        if not ready:
            self._capture(leaves)
            with trace.span("graphed.copy_in", rid):
                self._copy_in(leaves)
        self._count_since(before)
        with trace.span(trace.REPLAY, rid) as s, trace.device_run(s, trace.REPLAY, self._marks):
            self._graph.replay()
        self._replayed()
        return self._static_out

    def _counts(self) -> tuple:
        return self.args_reused, self.args_checked, self.batched_copies, self.copy_fallbacks

    def _count_since(self, before: tuple) -> None:
        for name, now, then in zip(("args_reused", "args_checked", "batched_copies",
                                    "copy_fallbacks"), self._counts(), before):
            trace.count("graphed." + name, now - then)

    def _take(self, args) -> tuple:
        """The call's leaves, checked against the graph's signature, and
        whether its tensors are on the card. An argument that is the last
        call's object and may be reused (:meth:`_reuse`) keeps its leaves,
        its tensors' shapes, dtypes and devices checked again (``resize_``
        or ``set_`` change them in place); every other argument is
        flattened and checked alone. A call that either finds wrong is
        checked whole (:meth:`_check`), which raises."""
        last = self._last
        if len(args) != len(last):
            return self._check(args)
        leaves: list = []
        reused = 0
        for i, a in enumerate(args):
            arg = last[i]
            same = a is arg.obj
            if same:
                if arg.tensors is None:
                    arg.tensors, arg.reusable = self._reuse(i, a, arg.leaves)
                if arg.reusable:
                    for t, shape, dtype, device in arg.tensors:
                        if t.shape != shape or t.dtype != dtype or t.device != device:
                            return self._check(args)
                    reused += 1
                    leaves += arg.leaves
                    continue
            got = self._checked(i, a)
            if got is None:
                return self._check(args)
            if same:  # an object that may not be reused never may
                arg.leaves = got
            else:
                last[i] = _Arg(a, got)
            leaves += got
        self.args_reused += reused
        self.args_checked += len(args) - reused
        return leaves, self._on_card

    def _checked(self, i: int, a) -> list | None:
        """Argument ``i``'s leaves, flattened and checked against the first
        call's (its tree, its signature, an in-place argument's tensors by
        identity), or ``None`` where it differs."""
        leaves, tree = pytree.tree_flatten(a)
        if (tree, _signature(leaves)) != self._specs[i]:
            return None
        first = self._in_place_of.get(i)
        if first is not None and any(
                x is not y for x, y in zip((t for t in leaves if isinstance(t, torch.Tensor)),
                                           first)):
            return None
        return leaves

    def _reuse(self, i: int, a, leaves: list) -> tuple:
        """What a call that passes argument ``i``'s last object again
        reuses: its tensors with the shape, dtype and device to check again,
        and whether it may be reused at all: its tree cannot change in
        place (:func:`_frozen`) and each constant is the first call's object
        or immutable, so that it still equals the first call's
        (``ValueError`` for the same calls as a check)."""
        sig = self._specs[i][1]
        tensors = tuple((t, s[1], s[2], s[3]) for t, s in zip(leaves, sig) if s[0] == "tensor")
        reusable = _frozen(a) and all(s[0] == "tensor" or x is s[1] or type(x) in _IMMUTABLE
                                      for x, s in zip(leaves, sig))
        return tensors, reusable

    def _check(self, args) -> tuple:
        """The whole call flattened and checked against the first call's
        signature (its structure, constants, shapes, dtypes and devices,
        the in-place arguments' tensors, one device), raising
        ``ValueError`` where it differs; the first call sets the signature.
        A call that passes is the next call's to reuse."""
        flat = [pytree.tree_flatten(a) for a in args]
        specs = [(tree, _signature(lv)) for lv, tree in flat]
        in_place = {i: [t for t in flat[i][0] if isinstance(t, torch.Tensor)]
                    for i in range(len(args)) if i in self.in_place_args}
        if self._specs is None:
            self._specs, self._in_place_of = specs, in_place
        elif specs != self._specs:
            raise ValueError(f"{self.name}: called with another structure, constant, shape, "
                             f"dtype or device than the graph is built for:\n{_whole(specs)}\n"
                             f"against\n{_whole(self._specs)}")
        elif any(a is not b for i in sorted(in_place)
                 for a, b in zip(in_place[i], self._in_place_of[i])):
            raise ValueError(f"{self.name}: an in-place argument {sorted(self.in_place_args)} "
                             "is another tensor than the first call's; update it in place")
        leaves = [t for lv, _ in flat for t in lv]
        tensors = [t for t in leaves if isinstance(t, torch.Tensor)]
        on_card = any(t.is_cuda for t in tensors)
        if on_card and not all(t.is_cuda for t in tensors):
            raise ValueError(f"{self.name}: tensors on the card and on the CPU in one call")
        self._on_card = on_card
        self._last = [_Arg(a, lv) for a, (lv, _) in zip(args, flat)]
        self.args_checked += len(args)
        return leaves, on_card

    def _copy_in(self, leaves: list) -> None:
        """Fill the static inputs from ``leaves`` by the plan
        (:func:`copy_plan`), each run of batched leaves one launch of the
        batched copy, the rest ``copy_``. The plan is kept while every
        source is the last one at the same address, or only moved: a batched
        source of the same strides, still clear of the static inputs, gets
        its new address written into its record. Any other change plans
        the copy-in again."""
        replan = False
        for s in self._slots:
            t = leaves[s.j]
            if t is s.src and t.data_ptr() == s.ptr and t.stride() == s.stride:
                continue
            if (s.packed is not None and t is not s.buf and t.stride() == s.stride
                    and not _overlaps(t, self._extents)):
                batched_copy_cuda.set_source(s.packed, s.at, t)
                s.src, s.ptr = t, t.data_ptr()
                continue
            replan = True
            break
        if replan:
            self._replan(leaves)
        for kind, js, packed in self._plan:
            if kind == BATCH:
                batched_copy_cuda.batched_copy.launch(bytes(packed), len(js), self._device)
                self.batched_copies += len(js)
            else:
                j, = js
                self._static_in[j].copy_(leaves[j])
                self.copy_fallbacks += 1

    def _replan(self, leaves: list) -> None:
        """Plan the copy-in from ``leaves`` (:func:`copy_plan`) and note each
        slot's source and, for a batched one, where its record lies."""
        self._plan = copy_plan(self._static_in, leaves)
        by_j = {s.j: s for s in self._slots}
        for s in self._slots:
            s.packed = s.at = None
        for kind, js, packed in self._plan:
            if kind == BATCH:
                for k, j in enumerate(js):
                    by_j[j].packed, by_j[j].at = packed, k * batched_copy_cuda.RECORD.size
        for s in self._slots:
            t = leaves[s.j]
            s.src, s.ptr, s.stride = t, t.data_ptr(), t.stride()

    def _seat(self, static_in: list, device: int | None) -> None:
        """Take ``static_in`` as the static inputs on card ``device``: no
        copy-in planned yet."""
        self._static_in = static_in
        self._slots = [_Slot(j, b) for j, b in enumerate(static_in) if b is not None]
        self._extents, self._device, self._plan = _extents(static_in), device, []

    def _replayed(self) -> None:
        self.replays += 1
        for wrapper, n in self._launches.items():
            wrapper.launches += n

    @property
    def name(self) -> str:
        return getattr(self.fn, "__qualname__", repr(self.fn))

    def _capture(self, leaves: list) -> None:
        """Allocate the static inputs (each in its first argument's layout;
        the in-place arguments' tensors are used as they are) and capture one
        call of ``fn`` on them on a side stream (with the tracer on, its
        phase marks become event nodes of the graph)."""
        t0 = time.perf_counter_ns()
        device = next(t.device for t in leaves if isinstance(t, torch.Tensor))
        in_place = {id(t) for ts in self._in_place_of.values() for t in ts}
        self._static_in = [torch.empty_like(t)
                           if isinstance(t, torch.Tensor) and id(t) not in in_place else None
                           for t in leaves]
        self._seat(self._static_in, device.index)
        args = pytree.tree_unflatten([b if b is not None else t
                                      for b, t in zip(self._static_in, leaves)],
                                     _whole(self._specs)[0])
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
