"""The port's tracer (``core/trace.py``) in the benchmark's cells, on the card.

    python3 scripts/torch_trace_split.py [--cells thesis_k1000.goal_seek,thesis_k1000.fleet64]
        [--seconds 51] [--seed 4100000021] [--rounds 3] [--out build/trace_split.json]

For each cell, in one process, two sessions of the cell's driver
(``rover_bench/drivers``): one whose graph was captured with the tracer
off, one with it on (its graph holds the phase marks). First ``--rounds``
windows of each of three sides in turns: "off" (the first session, the
tracer off), "bare" (the first session, the tracer on: spans and replay
events, no marks) and "on" (the second session, the tracer on), which give
``rover_loops_per_s`` for each and so the tracer's cost, and for the two
traced sides the program's view of the whole window (``trace.window``):
the replays' device time a control step, the card's idle share of the
host's time, the idle time a replay by the program's span the host was in
and the caller's rest, ``mppi_step``'s phases a step, the builds. Then, as
a ``--trace 1`` run of ``rover_bench/run.py`` does, the profiler is opened
once (and one more "off" window shows what that alone costs), and one more
window of the second session runs its last part under ``torch.profiler``:
the same view of its part before the slice, and the slice's own readings
(kernel time and kernels a step, K1's time, the named idle gaps). One JSON
line a cell on standard output, and all of them in ``--out``. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path
from types import SimpleNamespace

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from husky_rover_mppi_isaacsim_torch.core import trace  # noqa: E402
from rover_bench.harness import registry  # noqa: E402
from rover_bench.harness.runner import Ctx, card, set_precision  # noqa: E402

CELLS = ("thesis_k1000.goal_seek", "thesis_k1000.fleet64")
# mppi_step's phases as the metrics group them; the rest of a replay is
# the graph's head, the optimal inputs' wheel lag and the step's end
PHASES = {"sampling": ("phase.noise", "phase.sampling"),
          "rollout": ("phase.rollout", "phase.optimal_rollout"),
          "critics": ("phase.critics",)}


class StampedCtx(Ctx):
    """A run's context that also stamps on ``perf_counter_ns`` the window's
    opening and the profiler slice's opening, with the steps done then."""

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        self.stamps: dict = {}

    def open_window(self) -> None:
        self.stamps["window"] = time.perf_counter_ns()
        super().open_window()

    def tick(self, counters: dict) -> None:
        t = time.perf_counter_ns()
        opened = self.tracer is not None and self.tracer._prof is not None
        super().tick(counters)
        if self.tracer is not None and not opened and self.tracer._prof is not None:
            self.stamps["slice"] = t
            self.stamps["slice_steps"] = counters["steps"]


def per_step(split: dict, steps: int) -> dict:
    """Each phase group's device ms a step, over the ``steps`` steps of the
    replays whose phases were read."""
    ms = {name: 1e3 * sum(split["phase_s"].get(p, 0.0) for p in parts) / steps
          for name, parts in PHASES.items()}
    ms["all_phases"] = 1e3 * sum(split["phase_s"].values()) / steps
    return ms


def ratio(a: float, b: float) -> float | None:
    return a / b if b else None


def summary(rec, t0: int, t1: int, steps: int) -> dict:
    """The seven metrics of ``[t0, t1)`` (``steps`` control steps), the
    idle time a replay by the program's span the host was in (``caller``:
    in none), and the phases a step."""
    split = trace.window(rec, t0, t1)
    replays = rec.named(trace.REPLAY)
    replays = replays[replays["device"]]
    inside = replays[(replays["start_ns"] >= t0) & (replays["end_ns"] <= t1)]["id"]
    # a step begins at each noise mark: the steps of the replays with phases
    phase_steps = int(np.isin(rec.named("phase.noise")["parent"], inside).sum())
    phase_ms = per_step(split, phase_steps) if phase_steps else {}
    n = max(split["replays"], 1)
    idle_ms = {k: 1e3 * v / n for k, v in split["idle_in_s"].items()}
    idle_ms["caller"] = 1e3 * (split["idle_s"] - split["idle_in_program_s"]) / n
    return {
        "metrics": {
            "replay_device_ms.loops": 1e3 * split["replay_device_s"] / steps,
            "device_idle_pct.loops": 100.0 * split["idle_s"] / split["window_s"],
            "idle_in_program_pct.loops": ratio(100.0 * split["idle_in_program_s"],
                                               split["idle_s"]),
            **{f"{k}_device_ms.loops": v for k, v in phase_ms.items()},
            "captures_in_window.loops": split["builds"]},
        "steps": steps, "replays": split["replays"], "phase_steps": phase_steps,
        "window_s": split["window_s"], "idle_ms_per_replay": idle_ms,
        "phase_ms_per_step": {k: 1e3 * v / phase_steps for k, v in split["phase_s"].items()
                              if phase_steps},
        "counters": rec.counters,
        "clock": {k: v for k, v in rec.clock.items() if k != "drift_ns"},
        "drift_ns_quartiles": (np.quantile(rec.clock["drift_ns"], [0, .25, .5, .75, 1]).tolist()
                               if rec.clock["drift_ns"] else [])}


def window(session, traced: bool) -> dict:
    """One window of ``session``, with the tracer on or off: loops and
    control steps a second, and with the tracer on the window's summary."""
    steps0 = session.steps
    if traced:
        trace.enable()
    record = session.window()
    t1 = time.perf_counter_ns()
    steps = session.steps - steps0
    out = {"loops_per_s": record["loops"] / record["window_s"],
           "steps_per_s": steps / record["window_s"]}
    if traced:
        rec = trace.collect()
        trace.disable()
        out["summary"] = summary(rec, session.ctx.stamps["window"], t1, steps)
    return out


def run_cell(name: str, seed: int, seconds: float, rounds: int,
             device: torch.device = torch.device("cuda", 0),
             overrides: dict | None = None) -> dict:
    """The tracer's cost, its view of whole windows and of a ``--trace 1``
    window in cell ``name`` (module docstring); ``device`` and ``overrides``
    (``rover_bench``'s tiny sizes) let the CPU rehearse it."""
    cell = registry.Cell(name)
    set_precision()
    trace.disable()
    bare = cell.driver.Session(StampedCtx(cell, seed, seconds, False, device,
                                          overrides=overrides))
    ctx = StampedCtx(cell, seed, seconds, True, device, overrides=overrides)
    trace.enable()
    marked = cell.driver.Session(ctx)
    trace.disable()
    ctx.sync()
    # windows in turns, before any profiler: "off" (the tracer off), "bare"
    # (on, a graph captured with it off: no marks), "on" (on, the marks)
    profiler, ctx.tracer = ctx.tracer, None
    sides = {"off": (bare, False), "bare": (bare, True), "on": (marked, True)}
    order = (["off", "on", "bare", "bare", "on", "off"] * rounds)[:3 * rounds]
    runs: dict = {k: [] for k in sides}
    for side in order:
        runs[side].append(window(*sides[side]))
        print(json.dumps({"cell": name, side: runs[side][-1]["loops_per_s"]}), file=sys.stderr,
              flush=True)
    rate = {k: statistics.median(r["loops_per_s"] for r in v) for k, v in runs.items()}
    off_steps_per_s = statistics.median(r["steps_per_s"] for r in runs["off"])
    # as a --trace 1 run does: the profiler opened once, then a window whose
    # last part runs under it; the program's spans before that slice
    ctx.tracer = profiler
    ctx.tracer.warm_up()
    off_after_profiler = window(bare, False)["loops_per_s"]
    trace.enable()
    steps0 = marked.steps
    record = marked.window()
    rec = trace.collect()
    trace.disable()
    st = ctx.stamps
    traced = summary(rec, st["window"], st["slice"], st["slice_steps"] - steps0)
    # the profiler records the program's spans on the device's timeline too
    # (user annotations around the work launched inside them): not kernels
    tr = ctx.tracer.result
    tr = tr._replace(device_ops=[op for op in tr.device_ops if op.name not in rec.names])
    ns = SimpleNamespace(record=record, setup_s=0.0, trace=tr, card=card(), cell=cell,
                         count=lambda n: registry.load_module("counts", n, cell.bench))
    slice_metrics = {m: registry.load_module("metrics", m).read(ns)
                     for m in ("step_device_ms.loops", "kernels_per_step.loops")}
    k1_ms = ratio(1e3 * tr.kernel_s(["rollout25d_kernel"]), tr.counters["steps"])
    m = traced["metrics"]
    out = {
        "cell": name, "seed": seed, "seconds": seconds, "card": card(),
        "traced_window": traced,
        "slice": {**slice_metrics, "k1_ms_per_step": k1_ms, "window_s": tr.window_s,
                  "breakdown": tr.breakdown()},
        "checks": {
            "phases_over_replay": ratio(m.get("all_phases_device_ms.loops", 0.0),
                                        m["replay_device_ms.loops"]),
            "replay_over_step_device": ratio(m["replay_device_ms.loops"],
                                             slice_metrics["step_device_ms.loops"]),
            "rollout_over_k1": ratio(m.get("rollout_device_ms.loops", 0.0), k1_ms),
            "busy_pct_traced": 100.0 - m["device_idle_pct.loops"],
            "busy_pct_from_untraced_rate":
                100.0 * m["replay_device_ms.loops"] * off_steps_per_s / 1e3},
        "cost": {"order": order, "loops_per_s": {k: [r["loops_per_s"] for r in v]
                                                 for k, v in runs.items()},
                 "median": rate,
                 "cost_pct": {k: 100.0 * (rate["off"] - rate[k]) / rate["off"]
                              for k in ("bare", "on")},
                 "off_steps_per_s": off_steps_per_s,
                 "off_after_profiler_warm_up": off_after_profiler},
        "windows": {k: [r["summary"] for r in v] for k, v in runs.items() if k != "off"},
    }
    marked.free()
    bare.free()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cells", default=",".join(CELLS))
    p.add_argument("--seconds", type=float, default=None,
                   help="a window's length (default: BENCHMARK.json's run_seconds)")
    p.add_argument("--seed", type=int, default=4100000021)
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--out", default="build/trace_split.json")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_trace_split: needs a CUDA card", file=sys.stderr)
        return 3
    seconds = args.seconds or float(registry.benchmark()["run_seconds"])
    results = []
    for i, name in enumerate(args.cells.split(",")):
        results.append(run_cell(name, args.seed + i, seconds, args.rounds))
        print(json.dumps(results[-1], default=float), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
