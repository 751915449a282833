"""Find a cell's files by the names ``BENCHMARK.json`` gives them.

A cell ``<config>.<mix>`` is ``configs/<config>.json`` under
``traffic/<mix>.json``; the mix names its driver, ``drivers/<driver>.py``;
a metric ``<name>`` is ``metrics/<name>.py``; a kernel count ``<kernel>``
is ``counts/<kernel>.py``. Nothing is listed in code: a file added under
its name is found.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
_MODULES: dict = {}


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"not a benchmark name: {name!r}")
    return name


def benchmark(root: Path | None = None) -> dict:
    """``BENCHMARK.json`` at the repository's root."""
    return json.loads(((root or ROOT) / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str, bench: Path | None = None) -> dict:
    """``<kind>/<name>.json`` of the benchmark's folder."""
    return json.loads(((bench or BENCH) / kind / f"{check_name(name)}.json").read_text())


def load_module(kind: str, name: str, bench: Path | None = None) -> ModuleType:
    """``<kind>/<name>.py`` of the benchmark's folder, loaded once by path
    (a metric's name may hold dots, so it is no import name)."""
    path = (bench or BENCH) / kind / f"{check_name(name)}.py"
    key = str(path)
    mod = _MODULES.get(key)
    if mod is None:
        if not path.is_file():
            raise FileNotFoundError(f"no {kind[:-1]} named {name!r}: {path} is missing")
        spec = importlib.util.spec_from_file_location(
            f"rover_bench_{kind}_{re.sub(r'[^A-Za-z0-9_]', '_', name)}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[key] = mod
    return mod


def names(kind: str, suffix: str, bench: Path | None = None) -> list[str]:
    """Every name the folder ``kind`` holds a ``suffix`` file for."""
    return sorted(p.name[:-len(suffix)] for p in ((bench or BENCH) / kind).glob(f"*{suffix}")
                  if NAME.match(p.name[:-len(suffix)]))


class Cell:
    """One workload of ``BENCHMARK.json``: its entry, configuration, traffic
    mix, driver and the metrics it reports."""

    def __init__(self, workload: str, spec: dict | None = None, bench: Path | None = None):
        spec = spec if spec is not None else benchmark()
        self.bench = bench or BENCH
        matches = [w for w in spec["workloads"] if w["name"] == workload]
        if not matches:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.entry = matches[0]
        self.name = workload
        self.config = load_json("configs", self.entry["config"], self.bench)
        self.traffic = load_json("traffic", self.entry["traffic"], self.bench)
        self.driver = load_module("drivers", self.traffic["driver"], self.bench)
        self.end_to_end = [m for m in spec["end_to_end"] if self._reports(m)]
        self.per_layer = [m for m in spec["per_layer"] if self._reports(m)]

    def _reports(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def metric(self, entry: dict) -> ModuleType:
        return load_module("metrics", entry["name"], self.bench)
