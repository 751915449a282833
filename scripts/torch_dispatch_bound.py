"""Decide the PyTorch port's dispatch bound by runs, on one NVIDIA GPU.

    python3 scripts/torch_dispatch_bound.py [--runs N] [--chunk-steps S ...]
                                            [--out FILE]

The pipelined streamed-terrain traverse (``cli.largescale_episode`` at the
``LargeScaleConf`` defaults, (0, 0) -> (65, 65), pipeline depth 4, the
port's worker order) waits while its terrain worker is behind by more than
``dispatch_bound_chunks`` chunks (``env/largescale_loop.py``); the JAX
package's loop does not wait (``husky_rover_mppi_isaacsim_tpu/env/
largescale_loop.py:1064``). For each chunk size S, ``N`` rounds each drive
the bounded traverse and then the same traverse with the wait off
(``_TerrainWorker.wait_for`` returning at once), and hold the unbounded run
to the bound's removal criteria: it reached the goal, made the bounded
run's block shifts and at least its pre-stage hits, and rebuilt one
costmap per shift. The bound may go only if every run meets them.

Prints one JSON line per run and a summary line (runs, runs that met the
criteria, by chunk size); everything also goes to ``FILE`` (default
``build/dispatch_bound.json``).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import subprocess
import sys
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--chunk-steps", type=int, nargs="+", default=[12, 48])
    ap.add_argument("--out", default=str(ROOT / "build" / "dispatch_bound.json"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("torch_dispatch_bound: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from husky_rover_mppi_isaacsim_torch.cli import largescale_conf, largescale_episode
    from husky_rover_mppi_isaacsim_torch.env import largescale_loop as tls

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(card, flush=True)

    def traverse(conf, bounded):
        waits = (contextlib.nullcontext() if bounded else
                 mock.patch.object(tls._TerrainWorker, "wait_for", lambda self, chunk: False))
        with waits:
            run = largescale_episode({}, conf=conf)
        torch.cuda.synchronize()
        res, loop = run.result, run.loop
        return {"reached": bool(res.reached), "steps": res.steps,
                "block_shifts": res.block_shifts, "prestage_hits": res.prestage_hits,
                "costmap_rebuilds": res.costmap_rebuilds, "wall_s": res.wall_s,
                "worker_wait_s": loop.chunk_phase_acc["worker_wait_s"],
                "worker_blocking_waits": loop.worker_blocking_waits,
                "shift_latencies_ms": [1e3 * t for t in res.shift_latencies_s]}

    rows, summary = [], {}
    for steps in args.chunk_steps:
        conf = dataclasses.replace(largescale_conf({}), terrain_check_every=steps)
        met_count = 0
        for r in range(args.runs):
            b, u = traverse(conf, True), traverse(conf, False)
            met = (u["reached"] and u["costmap_rebuilds"] == u["block_shifts"]
                   and u["block_shifts"] == b["block_shifts"]
                   and u["prestage_hits"] >= b["prestage_hits"])
            met_count += met
            row = {"card": card, "chunk_steps": steps, "run": r,
                   "bound_chunks": tls.dispatch_bound_chunks(conf.pipeline_depth, steps),
                   "bounded": b, "unbounded": u, "criteria_met": met}
            rows.append(row)
            print(json.dumps(row), flush=True)
        summary[str(steps)] = {"runs": args.runs, "criteria_met": met_count}
    line = {"card": card, "summary": summary,
            "remove_bound": all(v["criteria_met"] == v["runs"] for v in summary.values())}
    print(json.dumps(line), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"runs": rows, **line}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
