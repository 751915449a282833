"""The copy-in between CUDA-graph replays on the card, in the benchmark's cells:
the batched copy kernel (csrc/batched_copy.cu) against the per-leaf
``copy_`` it replaced, at each cell's own copy plan.

    python3 scripts/torch_copy_in_times.py [--cells thesis_k1000.goal_seek,thesis_k1000.fleet64]
        [--seconds 3] [--seed 4100000031] [--calls 2000] [--out build/copy_in_times.json]

For each cell, a session of the cell's driver (``rover_bench/drivers``) runs
one short window, so that its graph's last call holds the loop's steady
arguments (the graph's own outputs fed back). The graph's counters over that
window (arguments reused and checked, static inputs batched and copied by
``copy_``, launches of the batched copy a replay) are read, with the host
time the loop spends in ``Graphed._take`` and ``_copy_in`` a call
(``in_loop_us``, tracer off). Then, from the last call's arguments:

* ``host_us``: the host time of a call's argument check and copy-in
  (``Graphed._take`` then ``_copy_in``: what the span ``graphed.copy_in``
  times), of the same check followed by one ``copy_`` a leaf, and followed
  by one ``torch._foreach_copy_`` of the leaves; and, where the loop passes
  an argument as a new object at every call (fleet64's fold-in index), the
  check and copy-in with a new copy of each such argument a call
  (``fresh``; ``fresh_take`` the check alone), as in the loop; ``--calls``
  calls each, in turns, three rounds;
* ``device_ms``: one launch of the batched copy at the cell's plan, the
  empty kernel of its grid (its bound: the launch floor), the per-leaf
  ``copy_`` of the same leaves and, as a yardstick, one
  ``torch._foreach_copy_`` of them, each timed by replaying a CUDA graph of
  100 of them, median of 7.

One JSON line a cell on standard output, and all of them in ``--out``. Needs
a card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402
import torch.utils._pytree as pytree  # noqa: E402

from husky_rover_mppi_isaacsim_torch.core.graphs import BATCH  # noqa: E402
from husky_rover_mppi_isaacsim_torch.ops.batched_copy_cuda import batched_copy  # noqa: E402
from rover_bench.harness import registry  # noqa: E402
from rover_bench.harness.runner import Ctx, card, set_precision  # noqa: E402

CELLS = ("thesis_k1000.goal_seek", "thesis_k1000.fleet64")
COUNTERS = ("replays", "args_reused", "args_checked", "batched_copies", "copy_fallbacks")


def replay_ms(fn, n: int = 100, reps: int = 7) -> float:
    """ms a call of ``fn`` on the card: a CUDA graph of ``n`` calls
    replayed ``reps`` times, the median."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def foreach_ms(g, leaves) -> float | None:
    """``torch._foreach_copy_`` of the copied leaves, one call, as
    :func:`replay_ms` times it (the library's multi-tensor copy, a
    yardstick; the port does not call it), or ``None`` where it refuses
    them."""
    pairs = [(s.buf, leaves[s.j]) for s in g._slots if leaves[s.j] is not s.buf]
    try:
        return replay_ms(lambda: torch._foreach_copy_([d for d, _ in pairs],
                                                      [t for _, t in pairs]))
    except RuntimeError as exc:
        print(f"_foreach_copy_: {exc}", file=sys.stderr)
        return None


def host_us(fn, calls: int) -> float:
    """µs of host time a call of ``fn``, ``calls`` back to back."""
    torch.cuda.synchronize()
    t0 = time.perf_counter_ns()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter_ns()
    torch.cuda.synchronize()
    return (t1 - t0) / calls / 1e3


def run_cell(name: str, seed: int, seconds: float, calls: int) -> dict:
    cell = registry.Cell(name)
    set_precision()
    device = torch.device("cuda", 0)
    session = cell.driver.Session(Ctx(cell, seed, seconds, False, device))
    g = session.rec.fn
    before = {k: getattr(g, k) for k in COUNTERS}
    launches0 = batched_copy.launches
    spent = {"take": 0, "copy_in": 0}

    def timed(name, fn):
        def call(*a):
            t0 = time.perf_counter_ns()
            try:
                return fn(*a)
            finally:
                spent[name] += time.perf_counter_ns() - t0
        return call

    g._take, g._copy_in = timed("take", g._take), timed("copy_in", g._copy_in)
    try:
        session.window()
    finally:
        del g._take, g._copy_in
    torch.cuda.synchronize()
    window = {k: getattr(g, k) - before[k] for k in COUNTERS}
    window["batched_launches"] = batched_copy.launches - launches0
    args = tuple(a.obj for a in g._last)
    fresh_at = [i for i, a in enumerate(g._last) if a.tensors is None]  # new at every call
    leaves, _ = g._take(args)

    def per_leaf(leaves):
        for s in g._slots:
            t = leaves[s.j]
            if t is not s.buf:
                s.buf.copy_(t)

    def foreach(leaves):
        slots = [s for s in g._slots if leaves[s.j] is not s.buf]
        torch._foreach_copy_([s.buf for s in slots], [leaves[s.j] for s in slots])

    def fresh_calls():
        clone = lambda x: x.clone() if isinstance(x, torch.Tensor) else x  # noqa: E731
        return iter([tuple(pytree.tree_map(clone, a) if i in fresh_at else a
                           for i, a in enumerate(args)) for _ in range(calls)])

    kinds = {"batched": lambda: g._copy_in(g._take(args)[0]),
             "per_leaf": lambda: per_leaf(g._take(args)[0]),
             "foreach": lambda: foreach(g._take(args)[0])}
    host = {k: [] for k in kinds}
    if fresh_at:
        host["fresh"], host["fresh_take"] = [], []
    for _ in range(3):
        for k, fn in kinds.items():
            host[k].append(host_us(fn, calls))
        if fresh_at:
            pool = fresh_calls()
            host["fresh"].append(host_us(lambda: g._copy_in(g._take(next(pool))[0]), calls))
            pool = fresh_calls()
            host["fresh_take"].append(host_us(lambda: g._take(next(pool)), calls))
    g._copy_in(g._take(args)[0])
    leaves, _ = g._take(args)
    batches = [(len(js), bytes(packed)) for kind, js, packed in g._plan if kind == BATCH]
    blocks = [batched_copy.blocks(packed, n) for n, packed in batches]
    dev = g._device
    device_ms = {
        "batched": replay_ms(lambda: [batched_copy.launch(p, n, dev) for n, p in batches]),
        "floor": replay_ms(lambda: [batched_copy.launch_floor(b, dev) for b in blocks]),
        "per_leaf": replay_ms(lambda: per_leaf(leaves)),
        "foreach_copy": foreach_ms(g, leaves)}
    out = {
        "cell": name, "seed": seed, "seconds": seconds, "card": card(),
        "window": window,
        "per_replay": {k: window[k] / window["replays"] for k in window if window["replays"]},
        "fresh_args": fresh_at,
        "in_loop_us": {k: v / 1e3 / max(window["replays"], 1) for k, v in spent.items()},
        "plan": {"static_inputs": len(g._slots),
                 "batched": sum(n for n, _ in batches),
                 "copied": sum(1 for kind, _, _ in g._plan if kind != BATCH),
                 "launches": len(batches), "blocks": blocks,
                 "bytes": sum(leaves[s.j].numel() * leaves[s.j].element_size()
                              for s in g._slots if leaves[s.j] is not s.buf)},
        "host_us": {k: {"rounds": v, "median": statistics.median(v)} for k, v in host.items()},
        "device_ms": device_ms,
    }
    session.free()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cells", default=",".join(CELLS))
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seed", type=int, default=4100000031)
    p.add_argument("--calls", type=int, default=2000)
    p.add_argument("--out", default="build/copy_in_times.json")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_copy_in_times: needs a CUDA card", file=sys.stderr)
        return 3
    results = []
    for i, name in enumerate(args.cells.split(",")):
        results.append(run_cell(name, args.seed + i, args.seconds, args.calls))
        print(json.dumps(results[-1]), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
