"""The harness: cells, mixes, metrics and counts are files found by name;
``BENCHMARK.json`` keeps to the contract's names and units; every per-layer
metric's end-to-end metric is reported in each of its cells; a CPU run
reports no device metric; a goal-seek episode that runs to its loop cap
is counted apart from one that failed."""

import contextlib
import json
import shutil
from unittest import mock

import pytest

from rover_bench.harness import registry
from rover_bench.tests.tiny import run_tiny

SPEC = registry.benchmark()
ALL_METRICS = SPEC["end_to_end"] + SPEC["per_layer"]


def reported(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def test_names_and_units_keep_to_the_contract():
    names = [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
    names += [m["name"] for m in ALL_METRICS]
    names += [w["config"] for w in SPEC["workloads"]] + [w["traffic"] for w in SPEC["workloads"]]
    names += [k for c in SPEC["configs"] for k in c["reduced"]]
    for n in names:
        assert registry.NAME.match(n), n
    for m in ALL_METRICS:
        assert registry.UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    assert len({m["name"] for m in ALL_METRICS}) == len(ALL_METRICS)
    assert len({w["name"] for w in SPEC["workloads"]}) == len(SPEC["workloads"])
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_each_per_layer_metrics_moves_is_reported_by_its_cells():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for w in SPEC["workloads"]:
            if reported(m, w["name"]):
                assert reported(e2e[m["moves"]], w["name"]), (m["name"], w["name"])


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in SPEC["workloads"]:
        e2e = [m["name"] for m in SPEC["end_to_end"] if reported(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(reported(m, w["name"]) for m in SPEC["per_layer"])
        assert w["chips"] == 1


def test_files_are_found_by_name(tmp_path):
    """A configuration, a mix, a metric and a count added as files are
    found with no other edit of the harness."""
    bench = tmp_path / "rover_bench"
    shutil.copytree(registry.BENCH, bench, ignore=shutil.ignore_patterns("__pycache__"))
    config = registry.load_json("configs", "thesis_k1000")
    (bench / "configs" / "thesis_k500.json").write_text(
        json.dumps(dict(config, mppi=dict(config["mppi"], num_samples=500))))
    traffic = registry.load_json("traffic", "goal_seek")
    (bench / "traffic" / "goal_seek_short.json").write_text(
        json.dumps(dict(traffic, max_loops=500)))
    (bench / "metrics" / "episodes_per_s.py").write_text(
        "def read(run):\n    return run.record['episodes'] / run.record['window_s']\n")
    (bench / "counts" / "planar.py").write_text('SYMBOLS = ("rollout2d_kernel",)\n')
    spec = dict(SPEC, workloads=[{"name": "thesis_k500.goal_seek_short", "config": "thesis_k500",
                                  "traffic": "goal_seek_short", "chips": 1, "why": "test"}],
                end_to_end=[{"name": "episodes_per_s", "unit": "1/s", "better": "higher",
                             "bound": 0.1, "source": "host_clock"}], per_layer=[])
    cell = registry.Cell("thesis_k500.goal_seek_short", spec, bench)
    assert cell.config["mppi"]["num_samples"] == 500 and cell.traffic["max_loops"] == 500
    assert cell.driver.__file__.endswith("drivers/goal_seek.py")
    mod = cell.metric(cell.end_to_end[0])
    assert mod.read(type("R", (), {"record": {"episodes": 3, "window_s": 1.5}})()) == 2.0
    assert registry.load_module("counts", "planar", bench).SYMBOLS == ("rollout2d_kernel",)
    assert "planar" in registry.names("counts", ".py", bench)


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_a_cpu_run_reports_no_device_metric(workload):
    out = run_tiny(workload)
    res = out["result"]
    assert res["metrics"] == {}
    assert res["device"]["platform"] == "cpu" and res["device"]["count"] == 0
    assert "busy_s" not in res["device"]
    assert res["correct"] is True, res["checked"]
    assert list(res)[-1] == "checked"


@pytest.mark.parametrize("broken", [False, True], ids=["sound", "non_finite"])
def test_goal_seek_counts_capped_episodes_apart_from_failed(broken):
    """At the tiny size's 40-loop cap no episode reaches its goal: each is
    counted in ``episodes_capped``, and in ``failed`` only where its end
    state is not finite."""
    drv = registry.load_module("drivers", "goal_seek")
    plain = drv.goal_seek

    def nan_end(*a, **k):
        r = plain(*a, **k)
        return r._replace(robot=r.robot._replace(position=r.robot.position * float("nan")))
    with mock.patch.object(drv, "goal_seek", nan_end) if broken else contextlib.nullcontext():
        out = run_tiny("thesis_k1000.goal_seek", seconds=0.4)
    res = out["result"]
    assert out["record"]["episodes_capped"] == res["attempted"] >= 1
    assert res["failed"] == (res["attempted"] if broken else 0)


def test_the_benchmark_alone_exits_nonzero_and_prints_no_result(tmp_path):
    """In a directory that holds only ``BENCHMARK.json`` and the files under
    ``paths`` (no port to measure) the command fails and prints no line."""
    import subprocess
    import sys

    shutil.copy(registry.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for p in SPEC["paths"]:
        shutil.copytree(registry.ROOT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    w = SPEC["workloads"][0]["name"]
    proc = subprocess.run([sys.executable, *SPEC["command"][1:], "--workload", w, "--seed",
                           "2147483650", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, timeout=300, cwd=tmp_path,
                          env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0
    assert '"correct"' not in proc.stdout
