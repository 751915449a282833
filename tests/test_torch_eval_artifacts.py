"""PyTorch port: the committed thesis tables of the card,
``EVAL_torch_r05.json`` (``python scripts/torch_run_eval_r05.py full 0.7`` on
one CUDA card), ``EVAL_torch_R05_CALIB.json`` (``... calib``) and
``EVAL_torch_r04.json`` (``scripts/torch_run_thesis_eval.py``) and
``EVAL_torch.json`` (``scripts/torch_run_eval_experiment.py``). The checks
are of consistency, not of direction: each table is its protocol's, every
run is counted once, the summary is the one ``thesis_runs.arm_summary``
gives, every recorded trace was finite. Which arm wins is not asserted."""

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


def test_r05_counts_every_run_once(r05):
    assert set(r05["per_k"]) == {"350", "500", "1000"}
    for row in r05["per_k"].values():
        assert set(row["arms"]) == {"3d", "2d"}
        for arm in row["arms"].values():
            assert arm["completed"] + arm["collided"] + arm["failed"] == RUNS
            assert arm["finite"] and arm["steps"] > 0
            assert 0.0 < arm["episode_s"] <= arm["wall_s"]


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
