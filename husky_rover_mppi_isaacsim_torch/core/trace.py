"""The port's tracer: spans and counters recorded where the work happens.

Off by default. While it is off, a :class:`.graphs.Graphed` call and a
goal-seek replay pay one check of :data:`ON` and record nothing, a graph
captured is node for node what it is without this module, and
:func:`mark` returns at once.

While it is on (:func:`enable`):

* a host span is a name, a start and an end on ``time.perf_counter_ns()``,
  the span open on the same thread when it began (its parent) and a
  request id (the goal-seek episode, or the ``Graphed`` call), written into
  storage sized by :func:`enable`;
* a replay (and the warm-up call) of a ``Graphed`` function is timed on the
  card by two timing events recorded around it on the replaying stream,
  outside the graph, taken from a pool that :func:`enable` makes. They are
  read without forcing a sync, at a later call once ``query()`` says they
  are done, and placed on the host's clock through an anchor: an event
  recorded on an idle stream (at the program's own sync, :func:`synced`,
  or at a call that finds the stream idle) with its ``perf_counter_ns``;
* :func:`mark` inside a function that a ``Graphed`` captures records an
  event node into the graph (``external=True``), which every replay
  records again; the intervals between the replay's start, its marks and
  its end are its phase spans, device spans whose parent is the replay's,
  read for one replay in :data:`MARK_EVERY`;
* :func:`count` keeps counters at the same boundaries.

Spans leave the storage only through :func:`collect` and :func:`dump`
(Chrome trace JSON, read back by :func:`load`). While ``torch.profiler``
records, each host span that holds no other also enters
``torch.profiler.record_function`` under its own name, so the profiler's
host operations include the program's spans (a span that holds others,
the goal-seek episode, would overlap every idle gap under it).

The tracer serves one card: its events live on the device current when
they are first recorded. Spans of other threads nest on their own thread.
"""

from __future__ import annotations

import itertools
import json
import threading
import time
import weakref
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

ON = False
NEW = -2             # the request of a span that starts a request of its own
CAPACITY = 1 << 20   # spans
POOL = 256           # pairs of timing events: device spans awaiting their read
MARK_EVERY = 8       # one replay in this many has its phases read
ANCHOR_NS = 50_000_000  # a new anchor at an idle stream once the last try is this old
ANCHOR_CALL_NS = 20_000  # the longest record call an anchor may take
ANCHORS_KEPT = 4096

SPAN = np.dtype([("id", np.int64), ("name", np.int32), ("device", np.bool_),
                 ("start_ns", np.int64), ("end_ns", np.int64), ("parent", np.int64),
                 ("request", np.int64)])

# names of the spans this module makes itself
REPLAY, EAGER, HEAD = "graphed.replay", "graphed.eager", "phase.head"
BUILDS = ("graphed.capture", "graphed.eager", "cuda_build.build")


class Recording(NamedTuple):
    """What :func:`collect` returns: the span names, one row of
    :data:`SPAN` per span (``name`` indexes ``names``; ``parent`` and
    ``request`` are -1 where there is none; device spans on the host's
    clock), the counters, and the host and device clocks' agreement."""

    names: tuple
    spans: np.ndarray
    counters: dict
    clock: dict

    def named(self, name: str) -> np.ndarray:
        """The rows of the spans called ``name``."""
        if name not in self.names:
            return self.spans[:0]
        return self.spans[self.spans["name"] == self.names.index(name)]


class _Anchor:
    __slots__ = ("event", "host_ns")

    def __init__(self, event, host_ns: int):
        self.event, self.host_ns = event, host_ns


class _Run:
    """A device span awaiting its read: the events around it, the graph's
    marks (or the warm-up call's), the anchor, the host span that launched
    it."""

    __slots__ = ("name", "start", "end", "marks", "anchor", "parent", "request")


_names: list = []
_ids: dict = {}
_spans: list = []
_slots = itertools.count()
_requests = itertools.count()
_replays = itertools.count()
_counters: dict = {}
_local = threading.local()
_pool: list = []
_pending: list = []
_anchors: list = []
_graphs: weakref.WeakSet = weakref.WeakSet()
_cuda = False
_anchor_due = 0  # perf_counter_ns at which the next anchor is due


def _id(name: str) -> int:
    i = _ids.get(name)
    if i is None:
        i = _ids[name] = len(_names)
        _names.append(name)
    return i


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


def _put(slot: int, name: int, device: bool, t0: int, t1: int, parent: int,
         request: int) -> None:
    if 0 <= slot < len(_spans):
        _spans[slot] = (slot, name, device, t0, t1, parent, request)
    else:
        _counters["trace.spans_dropped"] = _counters.get("trace.spans_dropped", 0) + 1


def enable(capacity: int = CAPACITY) -> None:
    """Start a fresh recording of up to ``capacity`` spans (more are
    dropped and counted as ``trace.spans_dropped``). On a machine with a
    card, also make the pool of timing events, synchronize and anchor the
    card's clock to the host's."""
    global ON, _spans, _slots, _requests, _replays, _pool, _cuda, _graphs
    _names.clear()
    _ids.clear()
    _counters.clear()
    _pending.clear()
    _anchors.clear()
    _spans = [None] * int(capacity)
    _slots, _requests, _replays = itertools.count(), itertools.count(), itertools.count()
    _graphs = weakref.WeakSet()
    _local.__dict__.clear()
    _cuda = torch.cuda.is_available()
    _pool = ([(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(POOL)] if _cuda else [])
    if _cuda:
        torch.cuda.synchronize()
        _anchor()
    ON = True


def disable() -> None:
    """Stop recording; the device spans still awaiting their read are read
    (after a synchronize) and the recording stays for :func:`collect`."""
    global ON
    if ON and _pending:
        torch.cuda.synchronize()
        _drain()
    ON = False


def collect() -> Recording:
    """The recording so far (the device spans awaiting their read are read
    first, after a synchronize). Spans still open are left out."""
    if ON and _pending:
        torch.cuda.synchronize()
        _drain()
    rows = [s for s in _spans if s is not None]
    spans = np.array(rows, dtype=SPAN) if rows else np.zeros(0, SPAN)
    counters = dict(_counters)
    if _graphs:
        counters["graphed.replays"] = sum(g.replays for g in list(_graphs))
    return Recording(tuple(_names), spans, counters, _clock())


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (nothing while the tracer is off)."""
    if ON:
        _counters[name] = _counters.get(name, 0) + n


def request() -> int:
    """The request of the span open on this thread, or a new one."""
    st = _stack()
    return st[-1].request if st else next(_requests)


class _Span:
    __slots__ = ("name", "request", "profiled", "slot", "parent", "t0", "rf")

    def __init__(self, name: str, request: int | None, profiled: bool):
        self.name, self.request, self.profiled, self.rf = name, request, profiled, None

    def __enter__(self):
        st = _stack()
        top = st[-1] if st else None
        self.parent = top.slot if top is not None else -1
        if self.request is None:
            self.request = top.request if top is not None else next(_requests)
        elif self.request == NEW:
            self.request = next(_requests)
        self.slot = next(_slots)
        st.append(self)
        if self.profiled and torch.autograd._profiler_enabled():
            self.rf = torch.autograd.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _stack().pop()
        _put(self.slot, _id(self.name), False, self.t0, t1, self.parent, self.request)
        return False


class _Off:
    slot, request = -1, -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


def span(name: str, request: int | None = None, profiled: bool = True):
    """A host span (a context manager): ``request`` by default that of the
    span open on this thread, or a new one (:data:`NEW`: a new one in any
    case); ``profiled=False`` keeps it out
    of ``torch.profiler`` (a span that holds others). Records nothing while
    the tracer is off."""
    return _Span(name, request, profiled) if ON else _OFF


def add(name: str, t0_ns: int, t1_ns: int, request: int | None = None) -> None:
    """A host span timed by its caller, a child of the span open on this
    thread (nothing while the tracer is off)."""
    if not ON:
        return
    st = _stack()
    top = st[-1] if st else None
    if request is None:
        request = top.request if top is not None else next(_requests)
    _put(next(_slots), _id(name), False, t0_ns, t1_ns,
         top.slot if top is not None else -1, request)


def mark(name: str) -> None:
    """The start of phase ``name`` on the card: an event node of the graph
    being captured by a ``Graphed`` (a plain event in its warm-up call).
    Nothing on the CPU, outside a ``Graphed`` call, or while the tracer is
    off (a graph captured then holds no marks)."""
    if not ON:
        return
    marks = getattr(_local, "marks", None)
    if marks is None:
        return
    ev = torch.cuda.Event(enable_timing=True, external=_local.capturing)
    ev.record()
    marks.append(("phase." + name, ev))


class capturing:
    """While a ``Graphed`` captures: the marks its function records become
    event nodes of the graph, collected in the list ``as`` gives."""

    def __enter__(self) -> list:
        self.saved = getattr(_local, "marks", None), getattr(_local, "capturing", False)
        _local.marks, _local.capturing = [], True
        return _local.marks

    def __exit__(self, *exc):
        _local.marks, _local.capturing = self.saved
        return False


class device_run:
    """Time what runs on the current stream inside the block, on the card,
    as the device span ``name`` under the host span ``host``: a replay
    (``marks``: the graph's marks, which the replay records again) or a
    warm-up call (``marks=None``: the block's own :func:`mark` calls are
    recorded as plain events).

    The events of a replay are read after the next launch (the card is
    busy then). Its phases are read for one replay in :data:`MARK_EVERY`,
    before the graph's next replay records its marks again: where that
    replay is not done by then, they are dropped and counted as
    ``trace.device_reads_missed``, as is a replay that finds the pool of
    events empty."""

    __slots__ = ("run", "saved")

    def __init__(self, host, name: str, marks: tuple | None):
        self.run = self.saved = None
        if not _cuda or host.slot < 0:
            return
        if marks:
            for r in [r for r in _pending if r.marks is marks]:
                if r.end.query():
                    _pending.remove(r)
                    _read(r)
                else:
                    r.marks = ()
                    count("trace.device_reads_missed")
            if next(_replays) % MARK_EVERY:
                marks = ()
        if not _pool:
            _drain()
            if not _pool:
                count("trace.device_reads_missed")
                return
        if _anchor_due <= time.perf_counter_ns() and torch.cuda.current_stream().query():
            _anchor()
        run = self.run = _Run()
        run.name, run.marks = name, marks
        run.start, run.end = _pool.pop()
        run.anchor, run.parent, run.request = _anchors[-1], host.slot, host.request

    def __enter__(self):
        run = self.run
        if run is not None:
            if run.marks is None:
                self.saved = getattr(_local, "marks", None), getattr(_local, "capturing", False)
                run.marks = _local.marks = []
                _local.capturing = False
            run.start.record()
        return self

    def __exit__(self, *exc):
        run = self.run
        if run is not None:
            run.end.record()
            if self.saved is not None:
                _local.marks, _local.capturing = self.saved
            _drain()
            _pending.append(run)
        return False


def synced() -> None:
    """The program has just synchronized with the card (the goal-seek stop
    flag): anchor the clocks anew if due."""
    if _cuda and _anchor_due <= time.perf_counter_ns():
        _anchor()


def _anchor() -> None:
    """An event recorded on an idle stream, paired with the host's clock
    halfway through the record call; one whose call took longer than
    :data:`ANCHOR_CALL_NS` (the thread was held up) is discarded and
    counted, the last anchor staying (the first is taken in any case). The
    next is due :data:`ANCHOR_NS` later either way."""
    global _anchor_due
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()  # the first record creates the event: not timed
    t0 = time.perf_counter_ns()
    ev.record()
    t1 = time.perf_counter_ns()
    _anchor_due = t1 + ANCHOR_NS
    if t1 - t0 > ANCHOR_CALL_NS and _anchors:
        count("trace.anchors_discarded")
        return
    _anchors.append(_Anchor(ev, (t0 + t1) // 2))
    del _anchors[:-ANCHORS_KEPT]


def _drain() -> None:
    """Read the device spans whose end event is done."""
    if not _pending:
        return
    keep = []
    for run in _pending:
        if run.end.query():
            _read(run)
        else:
            keep.append(run)
    _pending[:] = keep


def _read(run: _Run) -> None:
    anchor = run.anchor
    t0 = anchor.host_ns + round(anchor.event.elapsed_time(run.start) * 1e6)
    t1 = anchor.host_ns + round(anchor.event.elapsed_time(run.end) * 1e6)
    slot = next(_slots)
    _put(slot, _id(run.name), True, t0, t1, run.parent, run.request)
    if run.marks:
        name, at = _id(HEAD), t0
        for mark_name, ev in run.marks:
            t = t0 + round(run.start.elapsed_time(ev) * 1e6)
            _put(next(_slots), name, True, at, t, slot, run.request)
            name, at = _id(mark_name), t
        _put(next(_slots), name, True, at, t1, slot, run.request)
    _pool.append((run.start, run.end))


def _clock() -> dict:
    """Each anchor's host time against the one the previous anchor and the
    card's elapsed time predict (ns): the drift of the card's clock from the
    host's plus the jitter of recording an anchor."""
    done = [a for a in _anchors if a.event.query()] if _cuda else []
    drift = [b.host_ns - a.host_ns - round(a.event.elapsed_time(b.event) * 1e6)
             for a, b in zip(done, done[1:])]
    span_ns = done[-1].host_ns - done[0].host_ns if len(done) > 1 else 0
    return {"anchors": len(done), "drift_ns": drift,
            "drift_ppm": 1e6 * sum(drift) / span_ns if span_ns else 0.0,
            "drift_ns_max": max((abs(d) for d in drift), default=0)}


def watch(graphed) -> None:
    """A ``Graphed`` called while tracing: its own ``replays`` counter is
    read into ``graphed.replays`` by :func:`collect`."""
    _graphs.add(graphed)


# -- reading a recording -----------------------------------------------------


def _union(starts: np.ndarray, ends: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The union of intervals, as sorted disjoint intervals."""
    if len(starts) == 0:
        return starts, ends
    order = np.argsort(starts, kind="stable")
    s, e = starts[order], ends[order]
    reach = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > reach[:-1]
    first = np.flatnonzero(new)
    last = np.append(first[1:] - 1, len(s) - 1)
    return s[first], reach[last]


def _measure(starts: np.ndarray, ends: np.ndarray) -> int:
    s, e = _union(starts, ends)
    return int((e - s).sum())


def _overlap(a: tuple, b: tuple) -> int:
    """The measure of the intersection of two unions of intervals."""
    (sa, ea), (sb, eb) = _union(*a), _union(*b)
    t = np.concatenate([sa, ea, sb, eb])
    da = np.concatenate([np.ones_like(sa), -np.ones_like(ea), 0 * sb, 0 * eb])
    db = np.concatenate([0 * sa, 0 * ea, np.ones_like(sb), -np.ones_like(eb)])
    order = np.argsort(t, kind="stable")
    t, ca, cb = t[order], np.cumsum(da[order]), np.cumsum(db[order])
    both = (ca[:-1] > 0) & (cb[:-1] > 0)
    return int((np.diff(t) * both).sum())


def self_ns(rec: Recording, name: str) -> int:
    """The self time of the spans called ``name``: each one's duration less
    the part of it that its children cover."""
    rows = rec.named(name)
    total = 0
    for row in rows:
        kids = rec.spans[rec.spans["parent"] == row["id"]]
        s = np.clip(kids["start_ns"], row["start_ns"], row["end_ns"])
        e = np.clip(kids["end_ns"], row["start_ns"], row["end_ns"])
        total += int(row["end_ns"] - row["start_ns"]) - _measure(s, e)
    return total


def window(rec: Recording, t0_ns: int, t1_ns: int) -> dict:
    """What a recording shows of the host-clock interval ``[t0_ns, t1_ns)``:

    * ``replays`` and ``replay_device_s``: the device spans of whole graph
      replays that lie inside it, and the sum of their durations;
    * ``busy_s``: the union of those replays, and ``idle_s`` the rest of
      the interval (``window_s``);
    * ``idle_in_program_s``: the part of the idle time during which the
      host was inside some host span of the program, and ``idle_in_s`` the
      part inside the spans of each name;
    * ``phase_s``: the sum of each phase span of those replays, by name
      (``phase.head``: the replay's start to its first mark), and
      ``phased_replays``: how many of them have their phases read;
    * ``builds``: the captures, warm-up calls and kernel builds that began
      inside it."""
    sp = rec.spans
    inside = (sp["start_ns"] >= t0_ns) & (sp["end_ns"] <= t1_ns)
    dev = sp["device"]
    replay_id = rec.names.index(REPLAY) if REPLAY in rec.names else -1
    replays = sp[inside & dev & (sp["name"] == replay_id)]
    busy = _measure(replays["start_ns"], replays["end_ns"])
    host = sp[~dev]
    hs = np.clip(host["start_ns"], t0_ns, t1_ns)
    he = np.clip(host["end_ns"], t0_ns, t1_ns)
    idle_s, idle_e = _gaps(replays["start_ns"], replays["end_ns"], t0_ns, t1_ns)
    phases = sp[dev & np.isin(sp["parent"], replays["id"])]
    phased = len(np.unique(phases["parent"]))
    phase_s = {}
    for n in np.unique(phases["name"]):
        rows = phases[phases["name"] == n]
        phase_s[rec.names[n]] = int((rows["end_ns"] - rows["start_ns"]).sum()) * 1e-9
    build_ids = [rec.names.index(n) for n in BUILDS if n in rec.names]
    started = (sp["start_ns"] >= t0_ns) & (sp["start_ns"] < t1_ns) & ~dev
    window_ns = t1_ns - t0_ns
    idle = (idle_s, idle_e)
    idle_in = {rec.names[n]: _overlap(idle, (hs[host["name"] == n], he[host["name"] == n])) * 1e-9
               for n in np.unique(host["name"])}
    return {"window_s": window_ns * 1e-9, "replays": len(replays),
            "replay_device_s": int((replays["end_ns"] - replays["start_ns"]).sum()) * 1e-9,
            "busy_s": busy * 1e-9, "idle_s": (window_ns - busy) * 1e-9,
            "idle_in_program_s": _overlap(idle, (hs, he)) * 1e-9, "idle_in_s": idle_in,
            "phase_s": phase_s, "phased_replays": phased,
            "builds": int((started & np.isin(sp["name"], build_ids)).sum())}


def _gaps(starts, ends, t0: int, t1: int) -> tuple[np.ndarray, np.ndarray]:
    """``[t0, t1)`` less the union of the intervals."""
    s, e = _union(np.clip(starts, t0, t1), np.clip(ends, t0, t1))
    gs = np.concatenate([[t0], e]).astype(np.int64)
    ge = np.concatenate([s, [t1]]).astype(np.int64)
    keep = ge > gs
    return gs[keep], ge[keep]


# -- Chrome trace JSON -------------------------------------------------------


def dump(path) -> Path:
    """Write the recording (:func:`collect`) as Chrome trace JSON: one
    complete event a span, host spans on thread 0, device spans on thread
    1, times in microseconds of ``perf_counter``, each span's exact
    nanoseconds, id, parent and request under ``args``; the counters and
    the clocks' agreement under ``otherData``. Opens in Perfetto or
    ``chrome://tracing``."""
    rec = collect()
    events = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
               "args": {"name": label}} for tid, label in ((0, "host"), (1, "device"))]
    for row in rec.spans:
        t0, t1 = int(row["start_ns"]), int(row["end_ns"])
        events.append({"name": rec.names[row["name"]], "ph": "X", "pid": 0,
                       "tid": int(row["device"]), "ts": t0 / 1e3, "dur": (t1 - t0) / 1e3,
                       "args": {"id": int(row["id"]), "parent": int(row["parent"]),
                                "request": int(row["request"]), "start_ns": t0,
                                "end_ns": t1}})
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps({"traceEvents": events, "displayTimeUnit": "ns",
                                "otherData": {"counters": rec.counters,
                                              "clock": rec.clock}}))
    return path


def load(path) -> Recording:
    """A recording written by :func:`dump`."""
    doc = json.loads(Path(path).read_text())
    names: list = []
    rows = []
    for ev in doc["traceEvents"]:
        if ev.get("ph") != "X":
            continue
        if ev["name"] not in names:
            names.append(ev["name"])
        a = ev["args"]
        rows.append((a["id"], names.index(ev["name"]), bool(ev["tid"]), a["start_ns"],
                     a["end_ns"], a["parent"], a["request"]))
    other = doc.get("otherData", {})
    return Recording(tuple(names), np.array(rows, dtype=SPAN) if rows else np.zeros(0, SPAN),
                     dict(other.get("counters", {})), dict(other.get("clock", {})))
