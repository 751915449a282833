"""PyTorch port: the package never imports jax (nor PyYAML, which the card's
machine lacks), the CLI's standalone run and the device rule of every entry
point, the JAX-state converters and the kernel build's refusal without
nvcc."""

import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch import cli, convert
from husky_rover_mppi_isaacsim_torch import worldbuilders as wb
from husky_rover_mppi_isaacsim_torch.aux.config import apply_overrides
from husky_rover_mppi_isaacsim_torch.core import HeightField
from husky_rover_mppi_isaacsim_torch.core.device import run_device
from husky_rover_mppi_isaacsim_torch.env import RobotManager
from husky_rover_mppi_isaacsim_torch.env.largescale_loop import (
    LargeScaleClosedLoop,
    LargeScaleLoopConf,
)
from husky_rover_mppi_isaacsim_torch.mppi import MPPIConfig, MPPIController, evaluation
from husky_rover_mppi_isaacsim_torch.ops import cuda_build
from husky_rover_mppi_isaacsim_torch.parallel import make_mesh, scaling_sweep
from husky_rover_mppi_isaacsim_torch.shell import SimulationManager, SimulationManagerConf
from husky_rover_mppi_isaacsim_torch.terrain import as_costmap
from husky_rover_mppi_isaacsim_torch.terrain.smallscale import MoonyardConf, MoonyardGenerator
from husky_rover_mppi_isaacsim_torch.terrain.streaming import StreamerConf, TerrainStreamer
from husky_rover_mppi_isaacsim_tpu import cli as jcli

# small tensors: one intra-op thread each, so that the test workers running
# beside these do not lose their cores
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]

_IMPORT_ALL = """
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any `import jax` now raises
sys.modules["yaml"] = None  # and any `import yaml`
import husky_rover_mppi_isaacsim_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
from husky_rover_mppi_isaacsim_torch import cli
tree = cli.compose(["mode=sdg", "environment=lunalab4SDG", "rendering=path_tracing"])
assert type(tree["mppi"]).__name__ == "MPPIConfig" and tree["sdg"]["num_images"] == 10
leaked = [m for m in sys.modules if m.startswith(("jax", "yaml", "husky_rover_mppi_isaacsim_tpu"))
          and sys.modules[m] is not None]
print(len(names), leaked, ",".join(names))
"""

# modules of the evaluation slice and of the closed-loop slice, each
# imported by the walk above
SLICE_2 = ("ops.edt_cuda", "terrain.upsample", "terrain.point_process", "terrain.craters",
           "terrain.smallscale", "mppi.evaluation")
SLICE_3 = ("env", "env.rover_sim", "env.metrics", "env.closed_loop", "ops.gather_probe")
# the streamed-terrain slice
SLICE_5 = ("env.frames", "env.largescale_loop", "terrain.database", "terrain.streaming",
           "terrain.map_manager", "terrain.rocks", "terrain.clipmap", "terrain.collider",
           "terrain.orchestrator")
# the rest of the streamed-terrain loop: deformation and checkpoints
SLICE_6 = ("physics", "physics.deformation", "aux", "aux.checkpoint")
# the CLI as run.py runs it: the configuration tree, SDG, terramechanics
SLICE_7 = ("core.device", "utils", "utils.timer", "aux.stellar", "aux.yaml_reader", "aux.config",
           "aux.render_fx", "aux.labeling", "physics.terramechanics")
# the host shell, the controller wrapper, sharding and the library leftovers
SLICE_8 = ("env.robot_manager", "shell", "shell.pubsub", "shell.rate", "shell.monitor",
           "shell.sim_manager", "parallel", "parallel.mesh", "parallel.scaling",
           "mppi.reference_rollout", "aux.visualize")
# the last host libraries: the native runtime, the worldbuilders, the oracles
SLICE_9 = ("native", "worldbuilders", "worldbuilders.types", "worldbuilders.samplers",
           "worldbuilders.layers", "worldbuilders.clippers", "worldbuilders.mixer",
           "compat", "compat.numpy_oracle", "compat.warp_oracle")
# the loops' CUDA graphs
SLICE_11 = ("core.graphs",)
# the crater block kernel's wrapper
SLICE_12 = ("ops.crater_block_cuda",)


def test_package_imports_without_jax():
    out = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
                         text=True, timeout=120, check=True).stdout.split()
    assert int(out[0]) >= 60 and out[1] == "[]", out
    names = out[2].split(",")
    assert all(f"husky_rover_mppi_isaacsim_torch.{m}" in names
               for m in SLICE_2 + SLICE_3 + SLICE_5 + SLICE_6 + SLICE_7 + SLICE_8 + SLICE_9
               + SLICE_11 + SLICE_12), names


def test_chip_smoke_imports_neither_jax_nor_yaml():
    """Every import statement of chip_smoke.py (most sit inside ``main``,
    after the card check) names neither jax, PyYAML nor the JAX package:
    the card's machine has none of them."""
    import ast

    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert "husky_rover_mppi_isaacsim_torch.cli" in names
    assert not [m for m in names if m.split(".")[0] in ("jax", "yaml",
                                                          "husky_rover_mppi_isaacsim_tpu")]


def test_shard_ranks_imports_neither_jax_nor_yaml():
    """``shard_ranks.py``, the rank harness that chip_smoke.py starts on the
    card, imports only torch and the port, also when run as a rank."""
    out = subprocess.run([sys.executable, "-c", (
        "import sys; sys.modules['jax'] = None; sys.modules['yaml'] = None\n"
        "import shard_ranks\n"
        "print([m for m in sys.modules if m.startswith(('jax', 'yaml', "
        "'husky_rover_mppi_isaacsim_tpu')) and sys.modules[m] is not None])")],
        cwd=REPO, capture_output=True, text=True, timeout=120, check=True).stdout.split()
    assert out == ["[]"], out
    import ast

    tree = ast.parse((REPO / "shard_ranks.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names]
    names += [n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module]
    assert "husky_rover_mppi_isaacsim_torch" in names
    assert not [m for m in names if m.split(".")[0] in ("jax", "yaml",
                                                          "husky_rover_mppi_isaacsim_tpu")]


def test_parse_overrides_and_config():
    tree = apply_overrides({}, ["mode=standalone", "mppi.num_samples=64", "mppi.exact=true",
                                "goal.x=4.5", "mppi.limits.v_max=1.5"])
    assert tree == {"mode": "standalone", "goal": {"x": 4.5},
                    "mppi": {"num_samples": 64, "exact": True, "limits": {"v_max": 1.5}}}
    cfg = cli.mppi_config(tree["mppi"])
    assert cfg.num_samples == 64 and cfg.exact and cfg.limits.v_max == 1.5
    assert cli.mppi_config(cfg) is cfg
    assert cli.main(["mode=no_such_mode"]) == 2
    with pytest.raises(ValueError, match="key=value"):
        apply_overrides({}, ["mode"])


def test_standalone_world_matches_jax_at_reduced_size():
    world = {"half_width": 20.0, "grid_size": 160, "costmap_size": 80}
    hf, cm, hw = cli.build_standalone_world(world)
    jhf, jcm, jhw = jcli._build_standalone_world(world, jnp.float32)
    assert hw == jhw == 20.0
    np.testing.assert_allclose(hf.z.numpy(), np.asarray(jhf.z), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(cm.cost.numpy(), np.asarray(jcm.cost), rtol=0, atol=1e-6)
    for a, b in ((hf.resolution, jhf.resolution), (hf.x_min, jhf.x_min),
                 (cm.resolution, jcm.resolution), (cm.half_width, jcm.half_width)):
        assert float(a) == float(b)


def test_run_standalone_cli_small(capsys):
    args = ["mode=standalone", "world.half_width=20", "world.grid_size=160",
            "world.costmap_size=80", "start.x=-3", "start.y=-2", "goal.x=3", "goal.y=2",
            "mppi.num_samples=32", "mppi.horizon=15", "max_loops=6", "seed=3", "device=cpu"]
    assert cli.main(args) == 0
    res = json.loads(capsys.readouterr().out)
    assert set(res) == {"mode", "reached", "loops", "final_position", "wall_s", "device"}
    assert res["mode"] == "standalone" and res["device"] == "cpu"
    assert res["loops"] == 6 and res["reached"] is False
    assert len(res["final_position"]) == 2 and np.all(np.isfinite(res["final_position"]))
    assert res["final_position"] != [-3.0, -2.0]


@pytest.mark.parametrize("mode", ["standalone", "evaluation", "closed_loop", "largescale", "sdg"])
def test_missing_card_raises_instead_of_running_on_the_cpu(monkeypatch, mode):
    """With no ``device`` key the CLI asks for the card; where there is
    none it raises, and only ``device=cpu`` runs on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for extra in ([], ["device=cuda"], ["device=cuda:0"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main([f"mode={mode}", *extra])
    assert run_device("cpu") == torch.device("cpu")


def _tiny_world():
    return HeightField.create(torch.zeros((8, 8)), 2.0), as_costmap(np.zeros((4, 4)), 2.0)


ENTRY_POINTS = {
    "LargeScaleClosedLoop": lambda: LargeScaleClosedLoop(LargeScaleLoopConf()),
    "LargeScaleClosedLoop.resume": lambda: LargeScaleClosedLoop.resume(LargeScaleLoopConf(),
                                                                        "none.ckpt"),
    "run_2d_vs_3d_experiment": lambda: evaluation.run_2d_vs_3d_experiment(ks=(8,)),
    "run_thesis_protocol_experiment": lambda: evaluation.run_thesis_protocol_experiment(
        ks=(8,)),
    "TerrainStreamer": lambda: TerrainStreamer(StreamerConf(), np.zeros((4, 4))),
    "TerrainStreamer(native_pool=always)": lambda: TerrainStreamer(
        StreamerConf(native_pool="always"), np.zeros((4, 4))),
    "RequestMixer": lambda: wb.RequestMixer(()),
    "Layer_Factory.get": lambda: wb.Layer_Factory.get(
        wb.Plane_T(), wb.UniformSampler_T(randomization_space=2, min=(0, 0), max=(1, 1))),
    "MoonyardGenerator": lambda: MoonyardGenerator(MoonyardConf()),
    "MPPIController": lambda: MPPIController(MPPIConfig(), *_tiny_world(), (1.0, 1.0)),
    "SimulationManager": lambda: SimulationManager(SimulationManagerConf(), *_tiny_world(),
                                                   RobotManager(1), np.zeros((1, 2))),
    "make_mesh": lambda: make_mesh((1,), ("sample",)),
    "scaling_sweep": lambda: scaling_sweep(MPPIConfig(), *_tiny_world(), [1]),
}


@pytest.mark.parametrize("entry", sorted(ENTRY_POINTS))
def test_entry_points_run_on_the_card_by_default(monkeypatch, entry):
    """Given no device, each library entry point asks for the card and
    raises where there is none, before any work; the CPU runs only when
    named (tests pass ``device="cpu"``)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ENTRY_POINTS[entry]()
    assert MoonyardGenerator(MoonyardConf(), device="cpu").device == torch.device("cpu")


def test_converters_keep_values_and_dtypes():
    z = np.arange(12.0).reshape(3, 4)
    hf = convert.heightfield_from_numpy(z, np.float64(-2.0), np.float64(-2.0), 0.5)
    assert hf.z.dtype == torch.float64 and hf.resolution.ndim == 0
    assert float(hf.resolution) == 0.5 and torch.equal(hf.z, torch.from_numpy(z))
    z[0, 0] = 99.0  # no shared buffer
    assert float(hf.z[0, 0]) == 0.0
    cm = convert.costmap_from_numpy(np.zeros((2, 2), np.float32), 5.0, 5.0)
    assert cm.cost.dtype == torch.float32 and cm.half_width.dtype == torch.float32
    r = convert.robot_state_from_numpy(np.array([1.0, 2.0]), np.float64(0.5),
                                       np.array([1.0, 0.0, 0.0]), 0.1, 0.2)
    assert r.position.tolist() == [1.0, 2.0] and float(r.right_wheel_speed) == 0.2
    c = convert.controller_state_from_numpy(np.ones(4), np.zeros(4), 0.4, 0.5)
    assert c.optimal_u1.shape == (4,) and float(c.std_u2) == 0.5
    rs = convert.rover_state_from_numpy(np.zeros((3, 2), np.float32), *np.ones((5, 3)))
    assert rs.position.dtype == torch.float32 and rs.yaw_rate.dtype == torch.float64
    assert rs.heading.shape == (3,) and float(rs.z[0]) == 1.0


def test_kernel_build_refuses_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.build("rollout.cu")
    assert not (tmp_path / "kernels").exists()
    assert (cuda_build.CSRC / "rollout.cu").is_file()
