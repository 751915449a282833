"""PyTorch port: the tracer (``core/trace.py``) on the CPU.

Tracing on and off gives the same outputs of ``mppi_step``,
``masked_steps`` and ``closed_loop_step`` and no phase span on the CPU;
spans nest with their parents and requests, a layer's self time is its
span less its children; the counters count (kernel builds through a stub
compiler, the goal-seek's host syncs, dropped spans); device spans are
read from their events and placed on the host's clock (fake events stand
in for the card's); ``dump`` writes Chrome trace JSON that ``load`` reads
back; :func:`trace.window` reads the idle split, the replays and their
phases from synthetic spans and leaves out what lies past the window; and
the CLI's ``trace.out=PATH``. The card's side is in
``tests/test_torch_gpu.py``.
"""

import json
import time

import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch import cli
from husky_rover_mppi_isaacsim_torch import env as tenv
from husky_rover_mppi_isaacsim_torch.core import HeightField
from husky_rover_mppi_isaacsim_torch.core import jax_random as jr
from husky_rover_mppi_isaacsim_torch.core import trace
from husky_rover_mppi_isaacsim_torch.core.graphs import Graphed
from husky_rover_mppi_isaacsim_torch.mppi import controller as tc
from husky_rover_mppi_isaacsim_torch.ops import cuda_build
from husky_rover_mppi_isaacsim_torch.terrain import as_costmap, crater_surface

torch.set_num_threads(1)


@pytest.fixture
def tracer():
    trace.enable()
    try:
        yield trace
    finally:
        trace.disable()


def _world():
    z = crater_surface(96, 12.0, [((-3.0, 4.0), 2.0, 5.0)], dtype=torch.float64)
    hf = HeightField.create(z, 12.0)
    cost = torch.as_tensor(np.random.default_rng(7).uniform(0, 0.9, (24, 24)) ** 4)
    return hf, as_costmap(cost, 12.0)


def _step_inputs():
    cfg = tc.MPPIConfig(num_samples=16, horizon=8)
    hf, cm = _world()
    robot = tc.RobotState.create(-4.0, -3.0, [1.0, 0.3, 0.0], dtype=torch.float64)
    ctrl = tc.ControllerState.create(cfg, torch.float64)
    goal = torch.tensor([5.0, 4.0], dtype=torch.float64)
    return cfg, hf, cm, goal, robot, ctrl


def _run(which):
    cfg, hf, cm, goal, robot, ctrl = _step_inputs()
    if which == "mppi_step":
        noise = torch.randn((2, 16, 8), generator=torch.Generator().manual_seed(3),
                            dtype=torch.float64)
        return tc.mppi_step(cfg, hf, cm, goal, robot, ctrl, noise)
    if which == "masked_steps":
        loop = torch.zeros((), dtype=torch.int64)
        halt = tc.goal_reached(robot.position, goal)
        empty = torch.zeros((0,), dtype=torch.float64)
        return tc.masked_steps(cfg, 10, hf, cm, goal, robot, ctrl, loop, halt,
                               torch.zeros((0, 3), dtype=torch.float64), empty, jr.key(4), 3)
    lcfg = tenv.ClosedLoopConfig(mppi=cfg, rover=tenv.RoverParams(slip_std=0.05))
    starts = np.array([[-4.0, -3.0], [3.0, -2.0]])
    state = tenv.init_loop_state(lcfg, tenv.RoverState.create(starts, [1.0, 0.0, 0.0], hf))
    goals = torch.tensor([[5.0, 4.0], [-5.0, 3.0]], dtype=torch.float64)
    for i in range(4):  # every latch phase
        state = tenv.closed_loop_step(lcfg, hf, cm, goals, state, jr.key(5),
                                      (("fold_in", torch.tensor(i)),))
    return state


def _leaves(tree):
    import torch.utils._pytree as pytree

    return [t for t in pytree.tree_leaves(tree) if isinstance(t, torch.Tensor)]


@pytest.mark.parametrize("which", ["mppi_step", "masked_steps", "closed_loop_step"])
def test_tracing_leaves_the_cpu_outputs_equal_and_marks_nothing(which):
    """Each step with the tracer off, then on: ``torch.equal`` outputs, and
    no span on the CPU (a mark records only on the card)."""
    want = _run(which)
    trace.enable()
    try:
        got = _run(which)
    finally:
        trace.disable()
    rec = trace.collect()
    a, b = _leaves(got), _leaves(want)
    assert len(a) == len(b) > 0 and all(torch.equal(x, y) for x, y in zip(a, b))
    assert len(rec.spans) == 0 and not any(n.startswith("phase.") for n in rec.names)


def test_tracer_off_records_nothing():
    trace.enable()
    trace.disable()
    with trace.span("x"):
        trace.count("c")
        trace.mark("noise")
    trace.add("y", 1, 2)
    rec = trace.collect()
    assert len(rec.spans) == 0 and rec.counters == {}
    assert trace.span("x") is trace.span("y")  # one shared no-op


def test_spans_nest_with_parents_requests_and_self_time(tracer):
    """Nested spans take their parent's id and request; a span opened with
    no parent starts a request; :data:`trace.NEW` starts one in any case;
    a span's self time is its duration less what its children cover."""
    with trace.span("outer") as outer:
        with trace.span("inner") as inner:
            time.sleep(0.002)
        t0 = time.perf_counter_ns()
        time.sleep(0.001)
        trace.add("timed", t0, time.perf_counter_ns())
        with trace.span("own", trace.NEW) as own:
            pass
    with trace.span("next") as nxt:
        pass
    rec = trace.collect()
    rows = {rec.names[r["name"]]: r for r in rec.spans}
    assert rows["outer"]["parent"] == -1
    assert rows["inner"]["parent"] == rows["timed"]["parent"] == rows["outer"]["id"]
    assert rows["own"]["parent"] == rows["outer"]["id"]
    assert inner.request == outer.request == rows["timed"]["request"]
    assert own.request != outer.request and nxt.request not in (outer.request, own.request)
    o, i, t, w = (rows[k] for k in ("outer", "inner", "timed", "own"))
    assert o["start_ns"] <= i["start_ns"] <= i["end_ns"] <= t["start_ns"] <= o["end_ns"]
    kids = sum(int(r["end_ns"] - r["start_ns"]) for r in (i, t, w))
    assert trace.self_ns(rec, "outer") == int(o["end_ns"] - o["start_ns"]) - kids
    assert trace.self_ns(rec, "inner") == int(i["end_ns"] - i["start_ns"])


def test_self_time_counts_overlapping_children_once():
    rows = np.array([(0, 0, False, 0, 100, -1, 0), (1, 1, False, 10, 40, 0, 0),
                     (2, 1, False, 30, 60, 0, 0), (3, 2, False, 90, 130, 0, 0),
                     (4, 2, False, 15, 20, 1, 0)], dtype=trace.SPAN)
    rec = trace.Recording(("a", "b", "c"), rows, {}, {})
    assert trace.self_ns(rec, "a") == 100 - 50 - 10
    assert trace.self_ns(rec, "b") == (30 - 5) + 30


def test_full_storage_drops_and_counts(tracer):
    trace.enable(capacity=2)
    for name in "abc":
        with trace.span(name):
            pass
    rec = trace.collect()
    assert [rec.names[n] for n in rec.spans["name"]] == ["a", "b"]
    assert rec.counters["trace.spans_dropped"] == 1


def test_kernel_builds_are_counted_through_a_stub_compiler(tracer, tmp_path, monkeypatch):
    """A build runs the compiler once (``cuda_build.builds``, the span
    ``cuda_build.build``); the cached library's load counts nothing."""
    src = tmp_path / "k.cu"
    src.write_text("// a kernel\n")
    stub = tmp_path / "cc"
    stub.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\ntouch "$2"\n')
    stub.chmod(0o755)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build.ctypes, "CDLL", lambda path: path)
    for _ in range(2):
        built = cuda_build._build_cached(src, lambda: str(stub), ("-O3",))
    assert built.path.is_file()
    rec = trace.collect()
    assert rec.counters["cuda_build.builds"] == 1 and len(rec.named("cuda_build.build")) == 1


def test_goal_seek_counts_its_host_syncs_under_its_episode(tracer):
    """A CPU goal-seek of 8 loops in replays of 4: three stop-flag reads,
    each a child of the episode in the episode's request, and every
    ``Graphed`` call's ``graphed.copy_in`` in it too; on the CPU nothing
    is captured, warmed up or replayed."""
    cfg, hf, cm, goal, robot, ctrl = _step_inputs()
    graph = Graphed(tc.masked_steps)
    res = tc.goal_seek(cfg, hf, cm, goal, robot, ctrl, jr.key(6), max_loops=8, steps_fn=graph)
    rec = trace.collect()
    ep, = rec.named("goal_seek.episode")
    flags, copies = rec.named("goal_seek.stop_flag"), rec.named("graphed.copy_in")
    assert int(res.loops) == 8 and len(flags) == 3 and len(copies) == 2
    for rows in (flags, copies):
        assert (rows["parent"] == ep["id"]).all() and (rows["request"] == ep["request"]).all()
    assert rec.counters["goal_seek.host_syncs"] == 3
    assert rec.counters["graphed.replays"] == 0
    assert "graphed.captures" not in rec.counters and "graphed.eager_calls" not in rec.counters


@pytest.mark.parametrize("on", [True, False], ids=["on", "off"])
def test_graphed_counts_its_arguments_and_copies_only_with_the_tracer_on(on):
    """With the tracer on, the four ``graphed.*`` counters of the copy-in
    appear in ``collect()``, the arguments counted as ``Graphed`` counts
    them (nothing is copied on the CPU); with it off nothing is counted,
    while ``Graphed``'s own counters count either way."""
    cfg, hf, cm, goal, robot, ctrl = _step_inputs()
    graph = Graphed(tc.mppi_step)
    noise = torch.zeros((2, cfg.num_samples, cfg.horizon), dtype=torch.float64)
    trace.enable()
    if not on:
        trace.disable()
    try:
        for _ in range(3):
            graph(cfg, hf, cm, goal, robot, ctrl, noise)
        rec = trace.collect()
    finally:
        trace.disable()
    assert (graph.args_reused, graph.args_checked) == (14, 7)
    assert graph.batched_copies == graph.copy_fallbacks == 0
    names = ("args_reused", "args_checked", "batched_copies", "copy_fallbacks")
    got = {n: rec.counters.get("graphed." + n) for n in names}
    assert got == (dict(zip(names, (14, 7, 0, 0))) if on else dict.fromkeys(names))


class _FakeEvent:
    """A timing event on a fake card clock: recorded at the card time the
    test sets, done once the test says so."""

    clock = 0  # ns
    done = True

    def __init__(self, enable_timing=True, external=False):
        self.t = None
        self.external = external

    def record(self, stream=None):
        self.t = _FakeEvent.clock

    def query(self):
        return _FakeEvent.done

    def elapsed_time(self, other):
        assert _FakeEvent.done, "read before it was done"
        return (other.t - self.t) / 1e6

    def synchronize(self):
        pass


class _FakeStream:
    def query(self):
        return _FakeEvent.done


@pytest.fixture
def fake_card(monkeypatch):
    """The tracer's CUDA calls on a fake card whose clock runs 1 ms ahead
    of the host's."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "Event", _FakeEvent)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda *a: _FakeStream())
    monkeypatch.setattr(trace.time, "perf_counter_ns", lambda: _FakeEvent.clock - 1_000_000)
    _FakeEvent.clock, _FakeEvent.done = 5_000_000, True
    trace.enable()
    try:
        yield
    finally:
        trace.disable()


def test_device_spans_are_read_at_the_next_replay_on_the_host_clock(fake_card):
    """A replay's events, read before the graph's next replay records its
    marks again, become its device span and its phase spans on the host's
    clock (the anchor takes the card's 1 ms lead off), children of the
    replay's span in its request; the next replay (one of
    :data:`trace.MARK_EVERY`) has no phases read; the pool's events go
    back."""
    marks = tuple(("phase." + n, _FakeEvent(external=True)) for n in ("noise", "rollout"))
    pool = len(trace._pool)
    hosts = []
    for at in (7_000_000, 8_000_000):
        _FakeEvent.clock = at
        with trace.span(trace.REPLAY) as host, trace.device_run(host, trace.REPLAY, marks):
            for i, (_, ev) in enumerate(marks):  # the replay records its marks again
                ev.t = at + (i + 1) * 100_000
            _FakeEvent.clock = at + 300_000
        hosts.append(host)
        if at == 7_000_000:
            assert len(trace._pending) == 1 and len(trace._pool) == pool - 1
    assert len(trace._pending) == 1  # the second replay, read at the next launch or collect
    rec = trace.collect()
    assert not trace._pending and len(trace._pool) == pool
    devs = rec.named(trace.REPLAY)
    devs = devs[devs["device"]]
    assert [(d["start_ns"], d["end_ns"]) for d in devs] == [(6_000_000, 6_300_000),
                                                            (7_000_000, 7_300_000)]
    assert [d["parent"] for d in devs] == [h.slot for h in hosts]
    assert [d["request"] for d in devs] == [h.request for h in hosts]
    got = {rec.names[r["name"]]: (r["start_ns"], r["end_ns"], r["parent"])
           for r in rec.spans if rec.names[r["name"]].startswith("phase.")}
    assert got == {"phase.head": (6_000_000, 6_100_000, devs[0]["id"]),
                   "phase.noise": (6_100_000, 6_200_000, devs[0]["id"]),
                   "phase.rollout": (6_200_000, 6_300_000, devs[0]["id"])}


def test_a_graph_captured_in_one_recording_is_read_in_the_next(fake_card):
    """Marks captured while one recording ran, replayed in a fresh one
    (``enable`` again): the phases keep their names."""
    marks = (("phase.rollout", _FakeEvent(external=True)),)
    trace.enable()
    trace.enable()
    _FakeEvent.clock = 7_000_000
    with trace.span(trace.REPLAY) as host, trace.device_run(host, trace.REPLAY, marks):
        marks[0][1].t = 7_100_000
        _FakeEvent.clock = 7_300_000
    rec = trace.collect()
    assert [rec.names[n] for n in rec.spans["name"]] == [
        "graphed.replay", "graphed.replay", "phase.head", "phase.rollout"]


def test_a_replay_over_an_unread_one_drops_its_marks_and_counts_the_miss(fake_card,
                                                                          monkeypatch):
    """The graph replayed again before its last replay was done: that
    replay keeps its whole span but loses its phases (its marks are
    recorded again), and ``trace.device_reads_missed`` counts it."""
    monkeypatch.setattr(trace, "MARK_EVERY", 1)
    marks = (("phase.noise", _FakeEvent(external=True)),)
    for at in (7_000_000, 8_000_000):
        _FakeEvent.done = False
        _FakeEvent.clock = at
        with trace.span(trace.REPLAY) as host, trace.device_run(host, trace.REPLAY, marks):
            marks[0][1].t = at + 10_000
            _FakeEvent.clock = at + 20_000
    _FakeEvent.done = True
    rec = trace.collect()
    assert rec.counters["trace.device_reads_missed"] == 1
    assert len(rec.named(trace.REPLAY)) == 4  # two host spans, two device spans
    assert len(rec.named("phase.noise")) == 1 and len(rec.named("phase.head")) == 1


def test_warm_up_marks_are_plain_events_of_its_own_run(fake_card):
    """In a warm-up call the marks are fresh events of that call (not
    graph nodes), read as its phases."""
    _FakeEvent.clock = 9_000_000
    with trace.span(trace.EAGER) as host, trace.device_run(host, trace.EAGER, None) as d:
        _FakeEvent.clock = 9_050_000
        trace.mark("noise")
        (_, ev), = d.run.marks
        assert not ev.external
        _FakeEvent.clock = 9_080_000
    trace.mark("noise")  # outside a Graphed call: nothing
    rec = trace.collect()
    assert [tuple(r) for r in rec.named("phase.noise")[["start_ns", "end_ns"]]] == \
        [(8_050_000, 8_080_000)]


def test_anchors_measure_the_clock_drift(fake_card):
    """Anchors taken at program syncs once due: a card clock that runs 2 us
    slow between two anchors reads a drift of 2 us."""
    host0 = trace._anchors[-1].host_ns
    _FakeEvent.clock += trace.ANCHOR_NS
    trace.synced()
    trace._anchors[-1].event.t -= 2_000  # the card's clock ran 2 us slow
    clock = trace.collect().clock
    assert clock["anchors"] == 2 and trace._anchors[-1].host_ns - host0 == trace.ANCHOR_NS
    assert clock["drift_ns"] == [2_000] and clock["drift_ns_max"] == 2_000


def test_an_anchor_whose_record_call_was_held_up_is_discarded(fake_card, monkeypatch):
    """A record call that took 30 us (the thread held up) would put the
    anchor off by half of it: it is discarded, the last anchor stays."""
    anchors = list(trace._anchors)

    def slow_record(self, stream=None):
        self.t = _FakeEvent.clock
        _FakeEvent.clock += 30_000

    monkeypatch.setattr(_FakeEvent, "record", slow_record)
    _FakeEvent.clock += trace.ANCHOR_NS
    trace.synced()
    trace.synced()  # the next try is due ANCHOR_NS later
    assert trace._anchors == anchors
    assert trace.collect().counters["trace.anchors_discarded"] == 1


def test_dump_writes_chrome_trace_json_that_loads_back(tracer, tmp_path):
    with trace.span("a"):
        with trace.span("b"):
            pass
    trace.count("graphed.captures", 2)
    path = trace.dump(tmp_path / "t" / "trace.json")
    doc = json.loads(path.read_text())
    assert {e["ph"] for e in doc["traceEvents"]} == {"M", "X"}
    x = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert all(e["dur"] >= 0 and e["tid"] == 0 for e in x)
    got, want = trace.load(path), trace.collect()
    assert got.counters == want.counters == {"graphed.captures": 2}
    key = lambda r: (r["id"],)  # noqa: E731
    for g, w in zip(sorted(got.spans, key=key), sorted(want.spans, key=key)):
        assert got.names[g["name"]] == want.names[w["name"]]
        assert [g[f] for f in trace.SPAN.names if f != "name"] == \
            [w[f] for f in trace.SPAN.names if f != "name"]


def _synthetic():
    """A window 0..10,000 ns: three replays on the card (the last past the
    window's end, inside a traced slice), host spans, phases, builds."""
    names = ("graphed.replay", "graphed.copy_in", "goal_seek.stop_flag", "phase.head",
             "phase.rollout", "phase.critics", "graphed.capture", "cuda_build.build")
    R, C, S, H, RO, CR, CAP, B = range(8)
    rows = [
        # id, name, device, start, end, parent, request
        (0, C, False, 0, 1_000, -1, 0),
        (1, R, False, 1_000, 1_200, -1, 0),
        (2, R, True, 1_500, 4_000, 1, 0),
        (3, H, True, 1_500, 1_600, 2, 0),
        (4, RO, True, 1_600, 3_000, 2, 0),
        (5, CR, True, 3_000, 4_000, 2, 0),
        (6, S, False, 1_200, 4_500, -1, 0),
        (7, C, False, 5_000, 5_500, -1, 1),
        (8, R, False, 5_500, 5_600, -1, 1),
        (9, R, True, 6_000, 9_000, 8, 1),
        (10, H, True, 6_000, 6_200, 9, 1),
        (11, RO, True, 6_200, 8_000, 9, 1),
        (12, CR, True, 8_000, 9_000, 9, 1),
        (13, CAP, False, 9_500, 9_700, -1, 2),
        (14, R, True, 10_500, 12_000, -1, 3),
        (15, RO, True, 10_500, 12_000, 14, 3),
        (16, B, False, 10_200, 10_400, -1, 4),
    ]
    return trace.Recording(names, np.array(rows, dtype=trace.SPAN), {}, {})


def test_window_reads_the_idle_split_replays_and_phases():
    """Of 0..10,000 ns: replays 2,500 + 3,000 ns busy, both with phases; idle 0-1,500,
    4,000-6,000 and 9,000-10,000; the program's host spans cover 0-4,500,
    5,000-5,600 and 9,500-9,700 of it; phases by name; one capture."""
    w = trace.window(_synthetic(), 0, 10_000)
    assert w["replays"] == 2 and w["replay_device_s"] == pytest.approx(5_500e-9)
    assert w["busy_s"] == pytest.approx(5_500e-9) and w["idle_s"] == pytest.approx(4_500e-9)
    assert w["idle_in_program_s"] == pytest.approx((1_500 + 500 + 600 + 200) * 1e-9)
    assert w["phase_s"] == pytest.approx({"phase.head": 300e-9, "phase.rollout": 3_200e-9,
                                          "phase.critics": 2_000e-9})
    assert w["idle_in_s"] == pytest.approx({"graphed.copy_in": 1_500e-9, "graphed.replay": 300e-9,
                                            "goal_seek.stop_flag": 800e-9,
                                            "graphed.capture": 200e-9, "cuda_build.build": 0.0})
    assert w["phased_replays"] == 2
    assert w["builds"] == 1 and w["window_s"] == pytest.approx(10_000e-9)


def test_window_leaves_out_what_lies_past_its_end():
    """The replay, its phase and the build after 10,000 ns (a traced
    slice) count in a window that holds them and in no other."""
    rec = _synthetic()
    early, late = trace.window(rec, 0, 10_000), trace.window(rec, 10_000, 12_000)
    assert late["replays"] == 1 and late["phase_s"] == pytest.approx({"phase.rollout": 1.5e-6})
    assert late["builds"] == 1 and early["builds"] == 1
    assert "phase.rollout" in early["phase_s"]
    assert early["phase_s"]["phase.rollout"] == pytest.approx(3_200e-9)
    overlap = trace.window(rec, 3_000, 7_000)  # replays cut by the window count as busy
    assert overlap["replays"] == 0 and overlap["busy_s"] == pytest.approx(0.0)


def test_cli_trace_out_writes_the_run_s_spans(tmp_path, capsys):
    """``trace.out=PATH`` on a CPU standalone run: the result line as
    without it, and PATH holds the episode, its stop flags and counters."""
    out = tmp_path / "trace.json"
    args = ["mode=standalone", "world.half_width=20", "world.grid_size=160",
            "world.costmap_size=80", "start.x=-3", "start.y=-2", "goal.x=3", "goal.y=2",
            "mppi.num_samples=32", "mppi.horizon=15", "max_loops=6", "seed=3", "device=cpu"]
    assert cli.main(args + [f"trace.out={out}"]) == 0
    res = json.loads(capsys.readouterr().out)
    assert res["loops"] == 6 and not trace.ON
    rec = trace.load(out)
    assert len(rec.named("goal_seek.episode")) == 1
    assert len(rec.named("goal_seek.stop_flag")) == rec.counters["goal_seek.host_syncs"] == 3


def test_cli_trace_out_refuses_the_other_modes(tmp_path, capsys):
    assert cli.main(["mode=largescale", f"trace.out={tmp_path / 't.json'}"]) == 2
    assert "trace.out" in capsys.readouterr().err and not (tmp_path / "t.json").exists()
