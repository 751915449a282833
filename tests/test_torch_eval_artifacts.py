"""PyTorch port: the committed thesis tables of the card,
``EVAL_torch_r05.json`` (``python scripts/torch_run_eval_r05.py full 0.7`` on
one CUDA card), ``EVAL_torch_R05_CALIB.json`` (``... calib``) and
``EVAL_torch_r04.json`` (``scripts/torch_run_thesis_eval.py``) and
``EVAL_torch.json`` (``scripts/torch_run_eval_experiment.py``). The checks
are of consistency, not of direction: each table is its protocol's, every
run is counted once, the summary is the one ``thesis_runs.arm_summary``
gives, every recorded trace was finite; the r05 and calibration tables'
terrain is the JAX package's (its statistics equal to ``EVAL_r05.json``'s
and ``EVAL_R05_CALIB.json``'s), and each run drew JAX's control noise
from its key. Which arm wins is not asserted."""

import json
import re
from pathlib import Path

import pytest

from husky_rover_mppi_isaacsim_torch.mppi import thesis_runs

REPO = Path(__file__).resolve().parents[1]
RUNS = 64


@pytest.fixture(scope="module")
def r05():
    return json.loads((REPO / "EVAL_torch_r05.json").read_text())


def test_r05_config_is_the_protocol(r05):
    config = r05["config"]
    assert config["ks"] == [350, 500, 1000] and config["runs_per_arm"] == RUNS
    assert config["max_loops"] == 3500 and config["horizon"] == 100
    assert config["terrain_z_scale"] == 0.7 and config["slope_weight"] == 35.5
    assert config["slope_critic"] == "body" and config["sigma_base"] == 0.3
    assert config["kernel_routes"] == {"rollout_3d": "cuda", "rollout_2d": "cuda"}
    assert r05["terrain_stats"]["z_scale"] == 0.7


def test_r05_names_an_nvidia_card_and_its_power_limit(r05):
    device = r05["config"]["device"]
    assert "NVIDIA" in device["name"]
    assert re.fullmatch(r"\d+(\.\d+)? W", device["power_limit"]), device


@pytest.mark.parametrize("name", ["EVAL_torch_r05.json", "EVAL_torch_R05_CALIB.json",
                                  "EVAL_torch_r04.json", "EVAL_torch.json"])
def test_tables_draw_jax_control_noise(name):
    """The four thesis tables were run with JAX's noise streams: each run's
    control noise drawn from ``key(seed * 1000 + run)``."""
    config = json.loads((REPO / name).read_text())["config"]
    assert config["control_noise"] == "jax"


def test_r05_counts_every_run_once(r05):
    assert set(r05["per_k"]) == {"350", "500", "1000"}
    for row in r05["per_k"].values():
        assert set(row["arms"]) == {"3d", "2d"}
        for arm in row["arms"].values():
            assert arm["completed"] + arm["collided"] + arm["failed"] == RUNS
            assert arm["finite"] and arm["steps"] > 0
            assert 0.0 < arm["episode_s"] <= arm["wall_s"]


def test_r05_terrain_is_the_jax_packages(r05):
    """The card's run drove on the JAX package's terrain: the seed-42 DEM
    at z = 0.7 has ``EVAL_r05.json``'s statistics, digit for digit."""
    want = json.loads((REPO / "EVAL_r05.json").read_text())["terrain_stats"]
    assert r05["terrain_stats"] == want


def test_r05_summary_is_arm_summary(r05):
    assert r05["collision_free_pct"] == thesis_runs.arm_summary(r05["per_k"])


@pytest.fixture(scope="module")
def calib():
    return json.loads((REPO / "EVAL_torch_R05_CALIB.json").read_text())


def test_calib_is_the_calibration_sweep(calib):
    """``scripts/torch_run_eval_r05.py calib``: z_scale 0.5, 0.7, 1.0 at
    K=350 and 16 runs per arm, each entry's runs counted once and its
    summary ``arm_summary``'s, on a named NVIDIA card."""
    assert calib["anchor"] == thesis_runs.CALIB_ANCHOR
    assert "NVIDIA" in calib["config"]["device"]["name"]
    assert calib["config"]["kernel_routes"] == {"rollout_3d": "cuda", "rollout_2d": "cuda"}
    assert [e["z_scale"] for e in calib["sweep"]] == [0.5, 0.7, 1.0]
    for entry in calib["sweep"]:
        assert set(entry["arms"]) == {"3d", "2d"} and set(entry["k350"]) == {
            "distance", "speed", "slope", "obstacle"}
        for arm in entry["arms"].values():
            assert arm["completed"] + arm["collided"] + arm["failed"] == 16 and arm["finite"]
        assert entry["collision_free_pct"] == thesis_runs.arm_summary(
            {"350": {"arms": entry["arms"]}})


def test_calib_terrain_is_the_jax_packages(calib):
    """Each z_scale's thesis DEM of the calibration sweep has the
    statistics of ``EVAL_R05_CALIB.json``'s, digit for digit."""
    keys = ("z_scale", "rms_slope_deg", "slope_p50_deg", "slope_p90_deg", "slope_p99_deg",
            "rms_height_m", "height_span_m")
    want = json.loads((REPO / "EVAL_R05_CALIB.json").read_text())["sweep"]
    assert [{k: e[k] for k in keys} for e in calib["sweep"]] == [
        {k: e[k] for k in keys} for e in want]


@pytest.fixture(scope="module")
def r04():
    return json.loads((REPO / "EVAL_torch_r04.json").read_text())


def test_r04_is_the_protocol_with_its_ablation(r04):
    """``scripts/torch_run_thesis_eval.py``: the uncalibrated protocol
    (z_scale 1.0, body critic) at 64 runs per arm and K ∈ {350, 500,
    1000}, and the K=500 wheel-critic ablation at 16 runs per arm, each
    run counted once, on a named NVIDIA card."""
    config = r04["config"]
    assert config["ks"] == [350, 500, 1000] and config["runs_per_arm"] == RUNS
    assert config["max_loops"] == 3500 and config["terrain_z_scale"] == 1.0
    assert config["slope_critic"] == "body" and "NVIDIA" in config["device"]["name"]
    assert config["kernel_routes"] == {"rollout_3d": "cuda", "rollout_2d": "cuda"}
    ablation = r04["ablation"]
    assert ablation["question"] == thesis_runs.ABLATION_QUESTION
    rows = [(RUNS, row) for row in r04["per_k"].values()]
    rows.append((16, ablation["wheels_critic_K500"]))
    for runs, row in rows:
        for arm in row["arms"].values():
            assert arm["completed"] + arm["collided"] + arm["failed"] == runs and arm["finite"]


def test_episode_experiment_is_its_protocol():
    """``scripts/torch_run_eval_experiment.py`` (``EVAL_torch.json``): K ∈
    {350, 500, 1000} at 64 runs per arm under a 2000-loop cap, every run's
    trace finite, no arm reaching more goals than it ran, on a named
    NVIDIA card."""
    table = json.loads((REPO / "EVAL_torch.json").read_text())
    config = table["config"]
    assert config["ks"] == [350, 500, 1000] and config["runs_per_arm"] == RUNS
    assert config["max_loops"] == 2000 and "NVIDIA" in config["device"]["name"]
    for row in table["per_k"].values():
        assert row["finite"] == {"3d": True, "2d": True}
        assert all(0 <= row["reached"][a] <= RUNS and row["steps"][a] > 0 for a in ("3d", "2d"))


def test_compare_eval_counts_and_fisher_p():
    """``scripts/torch_compare_eval.py``: one row per K and arm with both
    tables' counts, and Fisher's two-sided exact p equal to scipy's."""
    import importlib.util

    from scipy.stats import fisher_exact

    spec = importlib.util.spec_from_file_location(
        "torch_compare_eval", REPO / "scripts" / "torch_compare_eval.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for table in ([8, 56], [3, 61]), ([0, 64], [5, 59]), ([6, 58], [6, 58]), ([1, 15], [9, 7]):
        assert abs(mod.fisher_exact_p(*table[0], *table[1])
                   - fisher_exact(list(table))[1]) < 1e-12
    rows = mod.compare(json.loads((REPO / "EVAL_torch_r05.json").read_text()),
                       json.loads((REPO / "EVAL_r05.json").read_text()))
    assert sorted((r["K"], r["arm"]) for r in rows) == sorted(
        (k, a) for k in (350, 500, 1000) for a in ("3d", "2d"))
    assert all(r["runs"] == [RUNS, RUNS] and 0.0 < r["fisher_p"] <= 1.0 for r in rows)


def test_compare_eval_episode_experiment_on_reached_runs():
    """The episode experiment's table (``EVAL_torch.json`` against the JAX
    package's ``EVAL.json``): one row per K and arm with both tables'
    collision points and reached runs, Fisher's p on the reached runs."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_compare_eval", REPO / "scripts" / "torch_compare_eval.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    port = json.loads((REPO / "EVAL_torch.json").read_text())
    rows = mod.compare(port, json.loads((REPO / "EVAL.json").read_text()))
    assert sorted((r["K"], r["arm"]) for r in rows) == sorted(
        (k, a) for k in (350, 500, 1000) for a in ("3d", "2d"))
    for r in rows:
        assert r["runs"] == [RUNS, RUNS] and 0.0 < r["fisher_p_reached"] <= 1.0
        assert r["reached"][0] == port["per_k"][str(r["K"])]["reached"][r["arm"]]
