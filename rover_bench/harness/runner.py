"""One run of one cell: set-up, the measured window, the check, the line.

:func:`main` is the command line (``rover_bench/run.py``); :func:`run` is
the run itself, which the CPU tests also call at tiny sizes with
``allow_cpu``. A run on the CPU reports no metric at all: every metric of
this benchmark is a time, a rate or a share of the card's, and a CPU run
measures none of them.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

from . import registry
from .trace import Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "husky_rover_mppi_isaacsim_tpu")


def deep_merge(base: dict, over: dict) -> dict:
    out = dict(base)
    for k, v in (over or {}).items():
        out[k] = deep_merge(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


class Ctx:
    """What a driver gets: the cell's configuration and traffic (dicts),
    the seed, the window's length, the device, whether to trace, whether to
    put the control in the program's place, and :meth:`tick`."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool, device: torch.device,
                 control: bool = False, overrides: dict | None = None):
        overrides = overrides or {}
        self.cell = cell
        self.config = deep_merge(cell.config, overrides.get("config"))
        self.traffic = deep_merge(cell.traffic, overrides.get("traffic"))
        self.seed = int(seed)
        self.seconds = float(seconds)
        self.device = device
        self.control = control
        tr = self.traffic.get("trace", {})
        self.tracer = Tracer(float(tr.get("last_s", 1.0)), device) if trace else None

    def open_window(self) -> None:
        """The window starts (and, with ``--trace 1``, the wait for its
        traced slice)."""
        if self.tracer is not None:
            self.tracer.open_window(self.seconds)

    def tick(self, counters: dict) -> None:
        if self.tracer is not None:
            self.tracer.tick(counters)

    def close_window(self, counters: dict) -> None:
        if self.tracer is not None:
            self.tracer.close(counters)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def card() -> dict:
    """The card's name, power limit and highest SM clock, as nvidia-smi
    reads them (``{}`` where it cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True).stdout.splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return {}
    name, limit, clock = (s.strip() for s in out.split(","))
    return {"name": name, "power_limit_w": float(limit), "max_sm_hz": float(clock) * 1e6}


def set_precision() -> None:
    """float32 matmuls in full float32, TF32 off: the precision every
    configuration states and the only one the port takes on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def loaded_forbidden() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def run(workload: str, seed: int, seconds: float, trace: bool, t_start: float,
        control: bool = False, allow_cpu: bool = False, overrides: dict | None = None,
        spec: dict | None = None) -> dict:
    """One run (module docstring). Returns ``{"result": <the line>,
    "checks": [(name, value, limit)], "error": <str or None>}``."""
    t_entry = time.perf_counter()
    cell = registry.Cell(workload, spec)
    chips = int(cell.entry.get("chips", 1))
    if torch.cuda.is_available() and torch.cuda.device_count() >= chips:
        device = torch.device("cuda", 0)
    elif allow_cpu:
        device = torch.device("cpu")
    else:
        return {"result": None, "checks": [], "error":
                f"needs {chips} CUDA card(s); torch.cuda.is_available()="
                f"{torch.cuda.is_available()}, device_count={torch.cuda.device_count()}"}
    ctx = Ctx(cell, seed, seconds, trace, device, control, overrides)
    set_precision()
    if ctx.tracer is not None:
        ctx.tracer.warm_up()
    session = cell.driver.Session(ctx)
    ctx.sync()
    t_ready = time.perf_counter()
    setup_s = t_ready - t_start
    record = session.window()
    record["setup_phases_s"] = {"imports": t_entry - t_start, "cell": t_ready - t_entry,
                                **getattr(session, "setup_phases_s", {})}
    ctx.sync()
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    info = card() if cuda else {}
    session.free()
    checks = session.check()
    correct = bool(checks) and all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    tr = ctx.tracer.result if ctx.tracer is not None else None
    ns = SimpleNamespace(record=record, setup_s=setup_s, trace=tr, card=info, cell=cell,
                         count=lambda name: registry.load_module("counts", name, cell.bench))
    metrics = {}
    if cuda:
        for entry in (cell.per_layer if trace else cell.end_to_end):
            value = cell.metric(entry).read(ns)
            if value is not None:
                metrics[entry["name"]] = {"value": float(value), "unit": entry["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": chips if cuda else 0, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": int(record["attempted"]),
              "failed": int(record["failed"]), "metrics": metrics, "device": dev}
    if trace and tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checked"] = {name: {"value": value, "limit": limit} for name, value, limit in checks}
    return {"result": result, "checks": checks, "error": None, "card": info,
            "record": record}


def summary(record: dict) -> dict:
    """The record with each long list cut to its quantiles (min, quartiles,
    90th, max), for standard error."""
    def cut(v):
        if isinstance(v, dict):
            return {k: cut(x) for k, x in v.items()}
        if isinstance(v, list) and len(v) > 16 and all(isinstance(x, (int, float)) for x in v):
            q = np.quantile(np.asarray(v, np.float64), [0, 0.25, 0.5, 0.75, 0.9, 1])
            return {"n": len(v), "quantiles": q.tolist()}
        return v
    return cut(record)


def parse(argv):
    p = argparse.ArgumentParser(description="the port's benchmark: one run of one cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0,
                   help="put the reference at the next lower precision in the program's "
                        "place (the control; never part of the benchmark's runs)")
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    args = parse(argv)
    out = run(args.workload, args.seed, args.seconds, bool(args.trace), t_start,
              control=bool(args.control))
    if out["error"] is not None:
        print(f"rover_bench: {out['error']}", file=sys.stderr)
        return 3
    found = loaded_forbidden()
    if found:
        print(f"rover_bench: modules loaded that the port must not use: {found}",
              file=sys.stderr)
        return 4
    info = out["card"]
    print(f"card: {info.get('name')}, power limit {info.get('power_limit_w')} W, "
          f"max SM clock {info.get('max_sm_hz')} Hz", file=sys.stderr)
    print(f"record: {json.dumps(summary(out['record']), default=str)}", file=sys.stderr)
    for name, value, limit in out["checks"]:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(out["result"]), flush=True)
    return 0
