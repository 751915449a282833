"""Count the pre-stage hits of the PyTorch port's pipelined streamed-terrain
traverse over repeated runs, and why each block shift hit or missed, on one
NVIDIA GPU.

    python3 scripts/torch_prestage_hits.py [--runs N] [--chunk-steps S ...]
                                           [--jax-order] [--out FILE]

Each run drives ``cli.largescale_episode`` at the ``LargeScaleConf``
defaults ((0, 0) -> (65, 65), pipeline depth 4) with ``terrain_check_every``
= S sim steps, once per S in turn, ``N`` rounds. For every block shift it
logs the costmap the worker had staged (its block and rock-region keys)
beside the shift's (block, update position, rock keys), and whether it hit.
With ``--jax-order`` the terrain worker pre-stages from a pose before that
pose's cascade update, as the JAX package's worker does
(``husky_rover_mppi_isaacsim_tpu/env/largescale_loop.py:234-246``); without
it, the port's order (the update, then the pre-stage).

Prints one JSON line per run and a summary line (hits and shifts per run,
by chunk size); everything also goes to ``FILE`` (default
``build/prestage_hits.json``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=5)
    ap.add_argument("--chunk-steps", type=int, nargs="+", default=[12])
    ap.add_argument("--jax-order", action="store_true")
    ap.add_argument("--out", default=str(ROOT / "build" / "prestage_hits.json"))
    args = ap.parse_args(argv)

    import dataclasses

    import torch

    if not torch.cuda.is_available():
        print("torch_prestage_hits: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from husky_rover_mppi_isaacsim_torch.cli import largescale_conf, largescale_episode
    from husky_rover_mppi_isaacsim_torch.env import largescale_loop as tls

    seats = []
    seat_costmap = tls.LargeScaleClosedLoop._seat_costmap

    def logged_seat(self, bx, by, update_pos):
        staged = self._staged
        cm, hit = seat_costmap(self, bx, by, update_pos)
        seats.append({"block": [bx, by], "update_pos": list(update_pos or ()),
                      "rock_keys": self._rock_keys(update_pos) if update_pos else None,
                      "staged_block": None if staged is None else list(staged[0]),
                      "staged_rock_keys": None if staged is None else staged[1], "hit": hit})
        return cm, hit

    def jax_order(self, pose):
        """The JAX worker's ``_process``: pre-stage, then the cascade."""
        loop = self.loop
        wx, wy, hx, hy = pose
        t0 = time.perf_counter()
        if loop.conf.prestage_shifts:
            loop._prestage_inline(wx, wy, hx, hy)
        t1 = time.perf_counter()
        self.prestage_s += t1 - t0
        sp = loop.conf.terrain.starting_position
        updated, corrected = loop.lstm.update_visual_mesh((wx - sp[0], wy - sp[1]))
        bx, by = loop.lstm.get_hr_map_current_block_coordinates()
        if (bx, by) != self._last_block:
            self._last_block = (bx, by)
            upd_pos = loop.lstm._to_global(corrected) if updated else (wx, wy)
            ev = loop._prepare_shift_event(bx, by, upd_pos)
            if self.stream is not None:
                ev["event"] = torch.cuda.Event()
                ev["event"].record(self.stream)
            with self._cond:
                self._events.append(ev)
        self.terrain_s += time.perf_counter() - t1

    base = largescale_conf({})
    rows = []
    for r in range(args.runs):
        for steps in args.chunk_steps:
            seats.clear()
            conf = dataclasses.replace(base, terrain_check_every=steps)
            with contextlib.ExitStack() as stack:
                stack.enter_context(mock.patch.object(tls.LargeScaleClosedLoop,
                                                      "_seat_costmap", logged_seat))
                if args.jax_order:
                    stack.enter_context(mock.patch.object(tls._TerrainWorker, "_process",
                                                          jax_order))
                run = largescale_episode({}, conf=conf)
            res = run.result
            row = {"round": r, "chunk_steps": steps, "jax_order": args.jax_order,
                   "reached": bool(res.reached), "steps": res.steps,
                   "block_shifts": res.block_shifts, "prestage_hits": res.prestage_hits,
                   "staged_builds": run.loop.costmap_builds["staged"],
                   "wall_s": res.wall_s, "seats": [dict(s) for s in seats]}
            print(json.dumps(row), flush=True)
            rows.append(row)
            del run
            torch.cuda.empty_cache()
    summary = {str(s): {"hits": [r["prestage_hits"] for r in rows if r["chunk_steps"] == s],
                        "shifts": [r["block_shifts"] for r in rows if r["chunk_steps"] == s]}
               for s in args.chunk_steps}
    print(json.dumps({"summary": summary, "jax_order": args.jax_order,
                      "device": torch.cuda.get_device_name(0)}))
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps({"runs": rows, "summary": summary}, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
