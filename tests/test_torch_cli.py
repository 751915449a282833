"""PyTorch port: the CLI as ``run.py`` runs it, the whole slice against the
JAX package's CLI on the CPU.

- ``mode=sdg`` with the camera pass on (64 x 48, 64 steps, cast shadows),
  under both rendering files: every ``.npy`` the two runs write must match
  by name (at the tolerances of tests/test_torch_labeling.py, the post
  effects at those of tests/test_torch_render_fx.py), the PNGs must have
  the same names and the camera JSON must be equal. Under path_tracing the
  chromatic warp samples the hillshade at coordinates XLA rounds
  differently (it multiplies by the reciprocal of the image centre: up to
  ~2e-5 px), and the hillshade changes by up to ~1 per pixel at crater
  rims: the post-effected rgb is held to WARP_ATOL = 1e-4, and to the
  effects' own tolerances on >= 99.8% of its values. The port draws its
  base noise with a ``torch.Generator`` (a documented divergence), so both
  generators are handed the same DEMs (the JAX generator's).
- the moonyard world of ``mode=standalone`` / ``closed_loop`` (lab and
  yard, one DEM injected into both): the same heightfield and free
  costmap; ``environment=lunaryard_20m mode=closed_loop`` at a small K and
  H, both from the same key, free-running: paths held to the streamed
  loop's free-running bound, FREE_RUN_M = 0.5 m
  (tests/test_torch_largescale.py).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch import cli
from husky_rover_mppi_isaacsim_torch import env as tenv
from husky_rover_mppi_isaacsim_torch.terrain import smallscale as tss
from husky_rover_mppi_isaacsim_tpu import cli as jcli
from husky_rover_mppi_isaacsim_tpu import env as jenv
from husky_rover_mppi_isaacsim_tpu.terrain import smallscale as jss

from test_torch_labeling import HIT_SHARE, SHADE_ATOL, _assert_depths, _assert_rgb
from test_torch_render_fx import EFFECT_ATOL, FLARE_ATOL

# small tensors: one intra-op thread each, so that the test workers running
# beside these do not lose their cores
torch.set_num_threads(1)

FREE_RUN_M = 0.5
WARP_ATOL = 1e-4
FRAMES = 2
SDG_ARGS = ["mode=sdg", f"sdg.num_images={FRAMES}",
            "sdg.camera={width: 64, height: 48, steps: 64, cast_shadows: true}"]


@pytest.fixture(scope="module")
def jax_dems():
    """The DEMs of JAX's default MoonyardGenerator's first frames, float32."""
    gen = jss.MoonyardGenerator(jss.MoonyardConf())
    return [np.asarray(gen.randomize(), np.float32) for _ in range(FRAMES)]


def _inject(monkeypatch, dems):
    """Both generators' ``randomize`` return ``dems`` in turn (the port's on
    its generator's device)."""
    queues = {"j": list(dems), "t": list(dems)}
    monkeypatch.setattr(jss.MoonyardGenerator, "randomize",
                        lambda self: jnp.asarray(queues["j"].pop(0)))
    monkeypatch.setattr(tss.MoonyardGenerator, "randomize",
                        lambda self, base_noise=None: torch.from_numpy(
                            queues["t"].pop(0)).to(self.device))


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("rendering", ["ray_tracing", "path_tracing"])
def test_sdg_writes_what_jax_writes(monkeypatch, capsys, tmp_path, jax_dems, rendering):
    _inject(monkeypatch, jax_dems)
    args = SDG_ARGS + [f"rendering={rendering}"]
    assert jcli.main(args + [f"sdg.data_dir={tmp_path / 'j'}"]) == 0
    want = _last_json(capsys)
    assert cli.main(args + [f"sdg.data_dir={tmp_path / 't'}", "device=cpu"]) == 0
    got = _last_json(capsys)
    assert set(got) == set(want) | {"seconds", "device"} and got["device"] == "cpu"
    assert (got["num_images"], got["camera"]) == (want["num_images"], want["camera"]) == (
        FRAMES, True)
    assert set(got["seconds"]) == {"generator", "top_down", "camera", "write"}
    runs = {"t": tmp_path / "t", "j": tmp_path / "j"}
    runs = {k: next(v.iterdir()) for k, v in runs.items()}  # the hashed run directory
    names = sorted(p.name for p in runs["j"].iterdir())
    assert sorted(p.name for p in runs["t"].iterdir()) == names
    assert len([n for n in names if n.endswith(".npy")]) == 7 * FRAMES
    rgb_atol = SHADE_ATOL + (EFFECT_ATOL + FLARE_ATOL if rendering == "path_tracing" else 0.0)
    for n in names:
        if n.endswith(".npy"):
            a, b = np.load(runs["t"] / n), np.load(runs["j"] / n)
            assert a.dtype == b.dtype and a.shape == b.shape, n
            if n.startswith(("cam_depth", "cam_rgb")):
                inst = [np.load(runs[k] / n.replace(n.split("_")[1], "instance")) for k in "tj"]
                (_assert_depths if "depth" in n else _assert_rgb)(a, b, *inst)
            elif n.startswith("cam_"):
                assert (a == b).mean() >= HIT_SHARE, n
            elif n.startswith("semantic"):
                np.testing.assert_array_equal(a, b, err_msg=n)
                assert (a == 2).any()  # rocks in the frame
            elif n.startswith("rgb") and rendering == "path_tracing":
                np.testing.assert_allclose(a, b, rtol=0, atol=WARP_ATOL, err_msg=n)
                assert (np.abs(a - b) <= rgb_atol).mean() >= 0.998, n
            elif n.startswith("rgb"):
                np.testing.assert_allclose(a, b, rtol=0, atol=rgb_atol, err_msg=n)
            else:  # the height map: the injected DEM
                np.testing.assert_array_equal(a, b, err_msg=n)
        elif n.endswith(".json"):
            assert (runs["t"] / n).read_text() == (runs["j"] / n).read_text()


def test_sdg_without_rocks_or_camera(monkeypatch, capsys, tmp_path, jax_dems):
    """``sdg.rocks=false`` and no camera: top-down frames only, ground
    everywhere."""
    _inject(monkeypatch, jax_dems)
    assert cli.main(["mode=sdg", f"sdg.num_images={FRAMES}", "sdg.rocks=false", "device=cpu",
                     f"sdg.data_dir={tmp_path}"]) == 0
    got = _last_json(capsys)
    assert got["camera"] is False
    run = next(tmp_path.iterdir())
    assert sorted(p.name for p in run.glob("*.npy")) == sorted(
        f"{m}_{i:05d}.npy" for m in ("rgb", "depth", "semantic") for i in range(FRAMES))
    assert (np.load(run / "semantic_00001.npy") == 1).all()


def _section(environment):
    return cli.compose([f"environment={environment}"])["environment"]


@pytest.mark.parametrize("environment", ["lunalab", "lunaryard_20m"])
def test_moonyard_world_matches_jax(monkeypatch, environment):
    """The lab's 480 x 320 DEM padded to the 480^2 window, the yard's
    1000^2 DEM as it is; both with a free costmap."""
    env = _section(environment)
    dem = tss.MoonyardGenerator(cli.moonyard_conf(env["moonyard"]), device="cpu").randomize()
    assert dem.shape == ((480, 320) if environment == "lunalab" else (1000, 1000))
    _inject(monkeypatch, [dem.numpy()] * 2)
    hf, cm, hw = cli.build_standalone_world(env["world"], device="cpu",
                                            moonyard=env["moonyard"])
    jhf, jcm, jhw = jcli._build_standalone_world(env["world"], jnp.float32, env["moonyard"])
    assert hw == jhw == env["world"]["half_width"]
    np.testing.assert_array_equal(hf.z.numpy(), np.asarray(jhf.z))
    np.testing.assert_array_equal(cm.cost.numpy(), np.asarray(jcm.cost))
    for a, b in ((hf.resolution, jhf.resolution), (hf.x_min, jhf.x_min),
                 (cm.resolution, jcm.resolution), (cm.half_width, jcm.half_width)):
        assert float(a) == float(b)
    assert not cm.cost.any() and hf.z.shape == (env["world"]["grid_size"],) * 2


def test_moonyard_conf_reads_the_section_as_jax_does():
    env = _section("lunalab")["moonyard"]
    conf = cli.moonyard_conf(env)
    assert conf.is_lab and not conf.is_yard and conf.base.x_size == 9.6
    assert conf.crater.densities == (0.2,) and conf.crater.radius_ranges == ((0.2, 0.6),)


SMALL_LOOP = ["mode=closed_loop", "environment=lunaryard_20m", "mppi.num_samples=32",
              "mppi.horizon=16", "num_rovers=2", "steps=40", "seed=4"]


def test_yard_closed_loop_follows_jax(monkeypatch, capsys):
    """``environment=lunaryard_20m mode=closed_loop`` through both CLIs on
    one injected DEM, both drawing their noise from ``key(0)``, split per
    step: the free-running paths stay within FREE_RUN_M."""
    env = _section("lunaryard_20m")
    dem = tss.MoonyardGenerator(cli.moonyard_conf(env["moonyard"]), device="cpu").randomize()
    _inject(monkeypatch, [dem.numpy()] * 2)
    caught = {}
    j_episode, t_episode = jenv.run_episode, tenv.run_episode

    def jax_episode(cfg, hf, cm, goals, state, key, num_steps, record_every=1):
        caught["j"] = out = j_episode(cfg, hf, cm, goals, state, key, num_steps, record_every)
        caught.update(key=key)
        return out

    monkeypatch.setattr(jenv, "run_episode", jax_episode)
    assert jcli.main(SMALL_LOOP) == 0
    want = _last_json(capsys)

    def port_episode(cfg, hf, cm, goals, state, key, num_steps, record_every=1):
        caught["t"] = out = t_episode(cfg, hf, cm, goals, state, key, num_steps, record_every)
        caught.update(tkey=key)
        return out

    monkeypatch.setattr(cli, "run_episode", port_episode)
    assert cli.main(SMALL_LOOP + ["device=cpu"]) == 0
    got = _last_json(capsys)
    assert set(got) == set(want) | {"device"}
    np.testing.assert_array_equal(caught["tkey"].numpy(),
                                  np.asarray(jax.random.key_data(caught["key"])))
    jpath, tpath = np.asarray(caught["j"][1]), caught["t"][1].numpy()
    assert tpath.shape == jpath.shape == (40, 2, 2) and np.isfinite(tpath).all()
    assert np.abs(tpath - jpath).max() <= FREE_RUN_M
    assert abs(got["mean_progress_m"] - want["mean_progress_m"]) <= FREE_RUN_M
    assert np.abs(tpath[-1] - tpath[0]).max() > 0.1  # the rovers moved


def test_yard_standalone_on_the_cpu(capsys):
    """``mode=standalone environment=lunalab`` at a small size: the JAX
    run's keys and ``device``, a finite position that moved."""
    assert cli.main(["mode=standalone", "environment=lunalab", "device=cpu", "start.x=-1",
                     "start.y=-1", "goal.x=1", "goal.y=1", "mppi.num_samples=16",
                     "mppi.horizon=10", "max_loops=5"]) == 0
    res = _last_json(capsys)
    assert set(res) == {"mode", "reached", "loops", "final_position", "wall_s", "device"}
    assert res["loops"] == 5 and np.isfinite(res["final_position"]).all()
    assert res["final_position"] != [-1.0, -1.0]
