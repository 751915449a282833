"""PyTorch port: the thesis drivers (mppi/thesis_runs.py and the thin
``scripts/torch_run_*.py`` mains) against the JAX package's driver scripts.

The scripts ``scripts/run_thesis_eval.py``, ``run_eval_r05.py`` and
``run_eval_experiment.py`` are loaded with ``importlib`` (``run_eval_r05.py``
sets two ``jax.config`` values when it is imported; they are restored at
once). ``terrain_statistics`` and ``arm_summary`` equal the JAX script's
functions on the same inputs, exactly: the same numpy and scipy calls on the
same array. Each driver runs at a tiny size on the CPU (K=8, H=8, a 20 m
map, the start/goal pairs of tests/test_torch_evaluation.py, 6 runs per
arm); the JAX script then runs its ``main`` with its experiment function
replaced by one that hands back the tables the port's driver got from the
port's experiment function, so that the two tables differ only in what the
drivers add. Both must carry the same keys, the port's ``config`` with
``kernel_routes`` and a ``device`` record in place of the TPU-only
``gather_engine``. The experiment functions themselves are held against
JAX's in tests/test_torch_evaluation.py."""

import builtins
import copy
import importlib.util
import json
import os
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch.mppi import evaluation as tev
from husky_rover_mppi_isaacsim_torch.mppi import thesis_runs as tr
from husky_rover_mppi_isaacsim_tpu import terrain as jterrain
from husky_rover_mppi_isaacsim_tpu.mppi import evaluation as jev
from test_torch_evaluation import _small_pairs

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
# the tiny protocol: K, horizon, loop cap, map half width, runs per arm
K, H, LOOPS, HW, RUNS = 8, 8, 8, 10.0, 6
TINY = dict(horizon=H, half_width=HW, device="cpu")


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_script(name: str):
    """A JAX driver script as a module, the ``jax.config`` values that
    ``run_eval_r05.py`` sets at import restored."""
    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    try:
        return _load(REPO / "scripts" / f"{name}.py", f"jax_driver_{name}")
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)


def _torch_script(name: str):
    return _load(REPO / "scripts" / f"{name}.py", f"torch_driver_{name}")


def _z(seed=3, n=120):
    """A seeded 120^2 height field with slopes and craters' scale of relief."""
    rng = np.random.default_rng(seed)
    base = np.cumsum(np.cumsum(rng.normal(0, 0.004, (n, n)), axis=0), axis=1)
    return (base + rng.normal(0, 0.02, (n, n))).astype(np.float32)


def test_terrain_statistics_equals_the_jax_script(monkeypatch):
    z = _z()
    script = _jax_script("run_eval_r05")
    monkeypatch.setattr(jterrain, "thesis_statistics_terrain", lambda **kw: z)
    want = script.terrain_stats(0.7)
    assert tr.terrain_statistics(z) == {k: v for k, v in want.items() if k != "z_scale"}
    from husky_rover_mppi_isaacsim_torch import terrain as tterrain

    seen = {}

    def port_terrain(**kw):
        seen.update(kw)
        return torch.from_numpy(z)

    monkeypatch.setattr(tterrain, "thesis_statistics_terrain", port_terrain)
    assert tr.terrain_stats(0.7, device="cpu") == want
    assert seen["seed"] == 42 and seen["size_m"] == 150.0 and seen["z_scale"] == 0.7
    assert seen["max_elevation"] == pytest.approx(0.84)
    assert seen["min_elevation"] == pytest.approx(-0.84)


def test_arm_summary_equals_the_jax_script():
    script = _jax_script("run_eval_r05")
    rng = np.random.default_rng(5)
    per_k = {}
    for k in (350, 500, 1000):
        arms = {}
        for a in ("3d", "2d"):
            completed, collided = (int(v) for v in rng.integers(0, 40, 2))
            arms[a] = {"completed": completed, "collided": collided,
                       "failed": int(rng.integers(0, 3)), "mean_loops": 1.0}
        per_k[k] = {"arms": arms, "critics": {}}
    per_k[500]["arms"]["2d"].update(completed=0, collided=0)  # the max(.., 1) guard
    assert tr.arm_summary(per_k) == script.arm_summary(per_k)


@pytest.fixture
def recorded(monkeypatch):
    """The tiny protocol's pairs, and every table the port's experiment
    functions hand the drivers, kept as they were returned."""
    monkeypatch.setattr(tev, "thesis_pairs", _small_pairs)
    tables = []
    for name in ("run_thesis_protocol_experiment", "run_2d_vs_3d_experiment"):
        fn = getattr(tr, name)

        def keep(*a, _fn=fn, **kw):
            out = _fn(*a, **kw)
            tables.append(copy.deepcopy(out))
            return out

        monkeypatch.setattr(tr, name, keep)
    return tables


def _replay(tables):
    """An experiment function for a JAX script: the next recorded table,
    its ``per_k`` keyed by the K values the script asks for."""
    queue = list(tables)

    def experiment(ks=(350, 500, 1000), **kw):
        table = copy.deepcopy(queue.pop(0))
        table["per_k"] = dict(zip(ks, table["per_k"].values()))
        table["config"]["ks"] = list(ks)
        return table

    return experiment


def _jax_main(monkeypatch, tmp_path, script, argv):
    """Run a JAX script's ``main`` with ``argv``; return the JSON it wrote,
    by file name (every write is sent to ``tmp_path``)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["script"] + argv)
    monkeypatch.setattr(script, "open", lambda path, mode="r": builtins.open(
        tmp_path / os.path.basename(path), mode), raising=False)
    script.main()
    return {p.name: json.loads(p.read_text()) for p in tmp_path.glob("*.json")}


def _port_config(got_config, want_config):
    assert set(got_config) == set(want_config) - {"gather_engine"} | {"kernel_routes", "device"}
    assert got_config["kernel_routes"] == {"rollout_3d": "plain", "rollout_2d": "plain"}
    assert got_config["device"] == {"name": "cpu", "power_limit": None}


def test_thesis_eval_has_the_jax_tables_keys(recorded, monkeypatch, tmp_path):
    got = tr.thesis_eval(runs_per_arm=RUNS, ks=(K,), ablation_k=K, max_loops=LOOPS, **TINY)
    assert [t["config"]["runs_per_arm"] for t in recorded] == [RUNS, 16]
    assert [t["config"]["slope_critic"] for t in recorded] == ["body", "wheels"]
    script = _jax_script("run_thesis_eval")
    monkeypatch.setattr(script, "run_thesis_protocol_experiment", _replay(recorded))
    want = _jax_main(monkeypatch, tmp_path, script, [str(RUNS)])["EVAL_r04.json"]
    got = json.loads(json.dumps(got))
    assert set(got) == set(want) == {"config", "per_k", "ablation"}
    _port_config(got["config"], want["config"])
    assert got["per_k"] == {str(K) if k == "350" else k: v for k, v in want["per_k"].items()}
    assert set(got["ablation"]) == {"question", f"wheels_critic_K{K}"}
    assert set(want["ablation"]) == {"question", "wheels_critic_K500"}
    assert got["ablation"]["question"] == want["ablation"]["question"]
    assert got["ablation"][f"wheels_critic_K{K}"] == want["ablation"]["wheels_critic_K500"]
    for arm in got["per_k"][str(K)]["arms"].values():
        assert arm["finite"] and arm["steps"] > 0


def test_eval_r05_calib_has_the_jax_tables_keys(recorded, monkeypatch, tmp_path):
    got = tr.eval_r05_calib(k=K, runs_per_arm=RUNS, max_loops=LOOPS, **TINY)
    assert [t["config"]["terrain_z_scale"] for t in recorded] == list(tr.CALIB_Z_SCALES)
    monkeypatch.setattr(jev, "run_thesis_protocol_experiment", _replay(recorded))
    monkeypatch.setattr(jterrain, "thesis_statistics_terrain", lambda **kw: _z())
    script = _jax_script("run_eval_r05")
    want = _jax_main(monkeypatch, tmp_path, script, ["calib"])["EVAL_R05_CALIB.json"]
    got = json.loads(json.dumps(got))
    assert set(got) == set(want) | {"config"} and got["anchor"] == want["anchor"]
    _port_config(got["config"], {})
    assert [e["z_scale"] for e in got["sweep"]] == [e["z_scale"] for e in want["sweep"]]
    for g, w in zip(got["sweep"], want["sweep"]):
        assert set(g) == set(w) - {"k350"} | {f"k{K}"}
        assert g[f"k{K}"] == w["k350"] and g["arms"] == w["arms"]
        assert g["collision_free_pct"] == {str(K) if k == "350" else k: v
                                           for k, v in w["collision_free_pct"].items()}


def test_eval_r05_full_has_the_jax_tables_keys(recorded, monkeypatch, tmp_path):
    got = tr.eval_r05_full(0.7, runs_per_arm=RUNS, ks=(K,), max_loops=LOOPS, **TINY)
    monkeypatch.setattr(jev, "run_thesis_protocol_experiment", _replay(recorded))
    monkeypatch.setattr(jterrain, "thesis_statistics_terrain", lambda **kw: _z())
    script = _jax_script("run_eval_r05")
    want = _jax_main(monkeypatch, tmp_path, script, ["full", "0.7"])["EVAL_r05.json"]
    got = json.loads(json.dumps(got))
    assert set(got) == set(want)
    _port_config(got["config"], {**want["config"], "gather_engine": None})
    assert set(got["terrain_stats"]) == set(want["terrain_stats"])
    assert got["terrain_stats"]["z_scale"] == 0.7
    assert got["collision_free_pct"] == tr.arm_summary(got["per_k"])
    assert got["collision_free_pct"][str(K)] == want["collision_free_pct"]["350"]


def test_eval_experiment_has_the_jax_tables_keys(recorded, monkeypatch, tmp_path):
    got = tr.eval_experiment(runs_per_arm=RUNS, ks=(K,), max_loops=LOOPS, horizon=H,
                             half_width=HW, grid_size=200, costmap_size=100, device="cpu")
    assert recorded[0]["config"]["max_loops"] == LOOPS
    script = _jax_script("run_eval_experiment")
    monkeypatch.setattr(script, "run_2d_vs_3d_experiment", _replay(recorded))
    want = _jax_main(monkeypatch, tmp_path, script, [str(RUNS)])["EVAL.json"]
    got = json.loads(json.dumps(got))
    assert set(got) == set(want) == {"config", "per_k"}
    _port_config(got["config"], want["config"])
    assert got["per_k"][str(K)] == want["per_k"]["350"]


@pytest.mark.parametrize("script,argv", [
    ("torch_run_thesis_eval", ["6"]), ("torch_run_eval_r05", ["calib"]),
    ("torch_run_eval_r05", ["full", "0.7"]), ("torch_run_eval_experiment", ["6"])])
@pytest.mark.parametrize("name", sorted(tr.JAX_ARTIFACTS))
def test_driver_scripts_refuse_the_jax_artifacts_names(tmp_path, capsys, script, argv, name):
    mod = _torch_script(script)
    with pytest.raises(SystemExit) as exc:
        mod.main(argv + ["--out", str(tmp_path / name), "--device", "cpu"])
    assert exc.value.code == 2 and "JAX package's artifact" in capsys.readouterr().err
    assert not (tmp_path / name).exists()


@pytest.mark.parametrize("script,argv,default", [
    ("torch_run_thesis_eval", [], "EVAL_torch_r04.json"),
    ("torch_run_eval_r05", ["calib"], "EVAL_torch_R05_CALIB.json"),
    ("torch_run_eval_r05", ["full", "0.7"], "EVAL_torch_r05.json"),
    ("torch_run_eval_experiment", [], "EVAL_torch.json")])
def test_driver_scripts_write_their_table(tmp_path, monkeypatch, script, argv, default):
    """Each ``main`` calls its driver with the JAX script's arguments and
    writes the table as JSON: to ``--out``, else to its own name at the
    repository root (asked of ``output_path`` here, not written)."""
    mod = _torch_script(script)
    calls = []

    def driver(*a, **kw):
        calls.append((a, kw))
        return {"config": {"wall_s": 1.0}, "per_k": {}, "wall_s": 1.0, "sweep": []}

    for name in ("thesis_eval", "eval_r05_calib", "eval_r05_full", "eval_experiment"):
        monkeypatch.setattr(tr, name, driver)
    out = tmp_path / "table.json"
    assert mod.main(argv + ["--out", str(out), "--device", "cpu"]) == 0
    assert json.loads(out.read_text())["per_k"] == {}
    args, kw = calls[0]
    assert kw == {"device": "cpu"}
    assert args == ((0.7,) if argv[:1] == ["full"] else () if argv else (64,))
    assert tr.output_path(None, default, REPO) == REPO / default


def test_drivers_run_on_the_card_unless_told(monkeypatch):
    """No card here: each driver raises before any work unless ``device``
    names the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn, args in ((tr.thesis_eval, ()), (tr.eval_r05_calib, ()), (tr.eval_r05_full, (0.7,)),
                     (tr.eval_experiment, ())):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(*args)
