"""PyTorch port: the large-scale terrain orchestrator, the map manager, the
clipmaps, the collider window and the streamed costmap rebuild against the
JAX package, on the JAX tests' ``tiny_terrain``, once without craters and once
with them.

Equal, not close: crater metadata, rock positions / scales / ids,
``extract_rocks_data``, the obstacle raster, the collider's triangles.
Heights (window, clipmap and collider vertices) agree to 2e-4 m (float32
upsample sums, see tests/test_torch_streaming.py); the costmap agrees to 1e-5
and is equal where it is saturated.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch.terrain import clipmap as tclip
from husky_rover_mppi_isaacsim_torch.terrain import collider as tcoll
from husky_rover_mppi_isaacsim_torch.terrain import costmap as tcost
from husky_rover_mppi_isaacsim_torch.terrain import map_manager as tmap
from husky_rover_mppi_isaacsim_torch.terrain import orchestrator as torch_orch
from husky_rover_mppi_isaacsim_torch.terrain.rocks import RockDistConf as TRockDistConf
from husky_rover_mppi_isaacsim_tpu.terrain import clipmap as jclip
from husky_rover_mppi_isaacsim_tpu.terrain import collider as jcoll
from husky_rover_mppi_isaacsim_tpu.terrain import costmap as jcost
from husky_rover_mppi_isaacsim_tpu.terrain import map_manager as jmap
from husky_rover_mppi_isaacsim_tpu.terrain import orchestrator as jax_orch
from husky_rover_mppi_isaacsim_tpu.terrain.rocks import RockDistConf as JRockDistConf

from test_torch_largescale import tiny_terrain

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[False, True], ids=["smooth", "craters"])
def managers(request):
    kw = dict(hr_dem_generate_craters=request.param, update_every_n_meters=2.0)
    jm = jax_orch.LargeScaleTerrainManager(tiny_terrain(jax_orch.LargeScaleConf, JRockDistConf,
                                                        **kw))
    tm = torch_orch.LargeScaleTerrainManager(tiny_terrain(torch_orch.LargeScaleConf,
                                                          TRockDistConf, **kw), device="cpu")
    jm.build()
    tm.build()
    return jm, tm


def _assert_same_world(jm, tm):
    js, ts = jm.map_manager.streamer, tm.map_manager.streamer
    assert ts.anchor == js.anchor
    assert (tm.get_hr_map_current_block_coordinates()
            == jm.get_hr_map_current_block_coordinates())
    np.testing.assert_allclose(ts.window.numpy(), np.asarray(js.window), rtol=0, atol=2e-4)
    assert list(ts.crater_blocks) == list(js.crater_blocks)
    for key, (coords, radii) in js.crater_blocks.items():
        np.testing.assert_array_equal(ts.crater_blocks[key][0], coords)
        np.testing.assert_array_equal(ts.crater_blocks[key][1], radii)
    assert len(tm.rocks_data) == len(jm.rocks_data) == 2
    for a, b in zip(tm.rocks_data, jm.rocks_data):
        np.testing.assert_array_equal(a, b)
    got, want = tm.extract_rocks_data(), jm.extract_rocks_data()
    assert got.shape == want.shape and got.shape[0] > 5
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tm.extract_rocks_data(0.4), jm.extract_rocks_data(0.4))


def test_conf_expands_like_jax():
    jc = tiny_terrain(jax_orch.LargeScaleConf, JRockDistConf)
    tc = tiny_terrain(torch_orch.LargeScaleConf, TRockDistConf)
    for name in ("block_size", "resolution", "lr_resolution", "num_blocks", "pad_size", "seed",
                 "generate_craters", "window_px", "block_px"):
        assert getattr(tc.streamer_conf, name) == getattr(jc.streamer_conf, name), name
    assert tc.streamer_conf.crater.densities == jc.streamer_conf.crater.densities
    assert tc.collider_conf == tcoll.ColliderConf(**{
        f: getattr(jc.collider_conf, f) for f in ("block_size", "resolution", "build_radius",
                                                  "drop_radius", "cache_size")})
    # the defaults are the reference scale: 7 x 7 blocks of 1000^2 px, two rock classes
    dj, dt = jax_orch.LargeScaleConf(), torch_orch.LargeScaleConf()
    assert dt.streamer_conf.window_px == dj.streamer_conf.window_px == 7000
    assert [vars(c) for c in dt.rock_gen_cfgs] == [vars(c) for c in dj.rock_gen_cfgs]
    assert torch_orch.LargeScaleConf(rock_gen_cfgs=({"seed": 3},)).rock_gen_cfgs[0].seed == 3
    with pytest.raises(ValueError):
        torch_orch.LargeScaleConf(update_every_n_meters=0.0)


def test_build_and_update_cascade_match_jax(managers):
    jm, tm = managers
    assert set(tm.build_phase_acc) == set(jm.build_phase_acc)
    _assert_same_world(jm, tm)
    # inside the 2 m gate: no update; else +x, -y and diagonal shifts
    for pos, updated in [((1.0, 1.0), False), ((11.0, 1.0), True), ((11.5, -3.0), True),
                         ((12.0, -4.5), False), ((22.0, -12.0), True)]:
        got, want = tm.update_visual_mesh(pos), jm.update_visual_mesh(pos)
        assert got == want, pos
        assert got[0] == updated
        _assert_same_world(jm, tm)
    assert tm.cascade_phase_acc["updates"] == jm.cascade_phase_acc["updates"] == 4
    for local in ((3.0, -2.0), (20.5, -11.25)):
        assert tm.get_height_local(local) == pytest.approx(jm.get_height_local(local), abs=2e-4)
        np.testing.assert_allclose(tm.get_normal_global(local), jm.get_normal_global(local),
                                   atol=2e-3)


def test_clipmap_sample_matches_jax(managers):
    jm, tm = managers
    for center in ((20.0, -10.0), (23.7, -14.2)):
        for got, want in zip(tm.nested_clipmap.sample(center), jm.nested_clipmap.sample(center)):
            assert tuple(got.shape) == want.shape
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=2e-4)
    spec = tclip.ClipmapSpec(num_lods=3, ring_size=6, resolution=0.5, interpolation="bicubic")
    jspec = jclip.ClipmapSpec(num_lods=3, ring_size=6, resolution=0.5, interpolation="bicubic")
    for a, b in zip(tclip.build_ring_layout(spec), jclip.build_ring_layout(jspec)):
        np.testing.assert_array_equal(a, b)
    z = np.random.default_rng(3).normal(size=(64, 64)).astype(np.float32)
    got = tclip.Clipmap(spec, z, origin=(-16.0, -16.0)).sample((1.0, 2.0))
    want = jclip.Clipmap(jspec, jnp.asarray(z), origin=(-16.0, -16.0)).sample((1.0, 2.0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


def test_collider_merged_mesh_matches_jax(managers):
    jm, tm = managers
    assert tm.collider_manager.meshes == {} == jm.collider_manager.meshes  # lazy by default
    tcm, jcm = tm.ensure_colliders(), jm.ensure_colliders()
    assert list(tcm.meshes) == list(jcm.meshes) and len(tcm.meshes) > 0
    got, want = tcm.merged_mesh(), jcm.merged_mesh()
    np.testing.assert_array_equal(got.triangles, want.triangles)
    np.testing.assert_array_equal(got.points[:, :2], want.points[:, :2])
    np.testing.assert_allclose(got.points[:, 2], want.points[:, 2], rtol=0, atol=2e-4)
    assert tcm.update((60.0, 60.0))[1] == jcm.update((60.0, 60.0))[1]  # dropped
    assert tcoll.ColliderManager(tcoll.ColliderConf(), None).merged_mesh() is None
    assert jcoll.ColliderConf().cells == tcoll.ColliderConf().cells


def test_update_costmap_with_obstacles_matches_jax(managers):
    jm, tm = managers
    obstacles = tm.extract_rocks_data()
    bx, by = tm.get_hr_map_current_block_coordinates()
    args = (62, 25.0, obstacles[:, :2], obstacles[:, 2], 0.3)
    kw = dict(falloff_power=20.0, origin=(bx + 5.0, by + 5.0))
    got = tcost.update_costmap_with_obstacles(*args, **kw)
    want = jcost.update_costmap_with_obstacles(*args, **kw)  # its plain-reference EDT on the CPU
    gc, wc = got.cost.numpy(), np.asarray(want.cost)
    assert gc.shape == wc.shape == (62, 62) and (gc == 1.0).sum() > 10
    np.testing.assert_array_equal(gc == 1.0, wc == 1.0)
    np.testing.assert_allclose(gc, wc, rtol=0, atol=1e-5)
    assert float(got.half_width) == float(want.half_width) == 25.0
    assert float(got.resolution) == pytest.approx(float(want.resolution))


def test_map_manager_ingestion_matches_jax(tmp_path):
    dem = tmap.synthetic_lola_dem(64, 5.0, seed=7)
    np.testing.assert_array_equal(dem, jmap.synthetic_lola_dem(64, 5.0, seed=7))
    tmap.save_dem_folder(str(tmp_path / "dem"), dem, 5.0, center=(10.0, -5.0))
    got, info = tmap.load_dem_folder(str(tmp_path / "dem"))
    want, jinfo = jmap.load_dem_folder(str(tmp_path / "dem"))
    np.testing.assert_array_equal(got, want)
    assert info.to_dict() == jinfo.to_dict()
    dem.tofile(str(tmp_path / "raw.bin"))
    assert tmap.preprocess_dem(str(tmp_path / "raw.bin"), str(tmp_path / "out")).size == (
        320.0, 320.0)
    conf = tmap.MapManagerConf(folder_path=str(tmp_path / "dem"), lr_pixel_size=5.0,
                               streamer=torch_orch.StreamerConf(
                                   block_size=10.0, resolution=0.5, generate_craters=False))
    jconf = jmap.MapManagerConf(folder_path=str(tmp_path / "dem"), lr_pixel_size=5.0,
                                streamer=jax_orch.StreamerConf(
                                    block_size=10.0, resolution=0.5, generate_craters=False,
                                    native_pool="never"))
    tmm, jmm = tmap.MapManager(conf, device="cpu"), jmap.MapManager(jconf)
    assert not tmm.is_map_done()
    tmm.initialize_hr_dem((3.0, 4.0))
    jmm.initialize_hr_dem((3.0, 4.0))
    assert tmm.is_map_done()
    assert tmm.lr_meters_to_pixels((7.0, -3.0)) == jmm.lr_meters_to_pixels((7.0, -3.0))
    assert tmm.hr_meters_to_pixels((7.0, -3.0)) == jmm.hr_meters_to_pixels((7.0, -3.0))
    assert tmm.get_lr_height(12.0, -8.0) == jmm.get_lr_height(12.0, -8.0)
    thf, jhf = tmm.hr_window_heightfield(), jmm.hr_window_heightfield()
    np.testing.assert_allclose(thf.z.numpy(), np.asarray(jhf.z), rtol=0, atol=2e-4)
    assert float(thf.resolution) == float(jhf.resolution)
