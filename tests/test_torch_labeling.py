"""PyTorch port: the SDG labeling (aux/labeling.py) against the JAX
package's, on the same seeded float32 DEM with a crater, the same rocks and
the same camera poses.

Tolerances, each from the arithmetic both sides do:
- normals and hillshade: float32 central differences and a 3-term dot
  product, summed in other orders: SHADE_ATOL = 1e-6;
- cast shadows: a cell's verdict flips where the marched ray grazes the
  terrain within a rounding error; the share of differing cells is held to
  SHADOW_SHARE = 1e-4 and no cell of the crater may differ;
- semantic and instance masks: float64 distance tests on both sides
  (the JAX package with 64-bit floats, as its tests run): exact;
- camera depth: float32 marches whose bracketing samples differ in the last
  bits: DEPTH_RTOL = 1e-5 where both rays hit, hit masks equal on
  >= HIT_SHARE = 99.99% of the pixels;
- rock intersections on the same rays: exact ids; a ray that grazes a
  rock's silhouette takes the square root of a near-zero discriminant
  b^2 - 4ac, and a last-bit change of b (1.2e-7 of it) moves that root by
  up to sqrt(2.4e-7) ~ 5e-4 of |b|: depths on rocks are held to
  ROCK_RTOL = 1e-3 (seen: 1.2e-5 here, 1.3e-4 between the card and the
  CPU in chip_smoke.py); a rock pixel's shade
  is the dot of the normal at that hit, (p_hit - centre) / radius, and
  moved by up to 1.5e-4 in the cases here: ROCK_SHADE_ATOL = 1e-3. A
  terrain pixel's shade is read at the hit's cell, which a last-bit move
  of the hit can change: SHADE_ATOL on >= 99.9% of them.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch.aux import labeling as tlab
from husky_rover_mppi_isaacsim_torch.terrain import smallscale as tss
from husky_rover_mppi_isaacsim_tpu.aux import labeling as jlab
from husky_rover_mppi_isaacsim_tpu.terrain import smallscale as jss

# small tensors: one intra-op thread each, so that the test workers running
# beside these do not lose their cores
torch.set_num_threads(1)

SHADE_ATOL = 1e-6
SHADOW_SHARE = 1e-4
DEPTH_RTOL = 1e-5
ROCK_RTOL = 1e-3
ROCK_SHADE_ATOL = 1e-3
HIT_SHARE = 0.9999
RES = 0.05
CRATER = (6.0, 4.5, 1.6)  # centre x, y [m] and radius of the test's crater


def _dem(h=240, w=180, seed=2):
    """Undulating ground with a rim-and-bowl crater at CRATER, float32,
    row = x at RES m/px."""
    rng = np.random.default_rng(seed)
    x = np.arange(h)[:, None] * RES
    y = np.arange(w)[None, :] * RES
    z = 0.15 * np.sin(x / 1.7 + rng.uniform(0, 6)) * np.cos(y / 2.3 + rng.uniform(0, 6))
    r = np.hypot(x - CRATER[0], y - CRATER[1]) / CRATER[2]
    z = z - 0.6 * np.clip(1.0 - r ** 2, 0.0, None) + 0.12 * np.exp(-((r - 1.0) / 0.15) ** 2)
    return z.astype(np.float32)


def _crater_cells(shape):
    x = np.arange(shape[0])[:, None] * RES
    y = np.arange(shape[1])[None, :] * RES
    return np.hypot(x - CRATER[0], y - CRATER[1]) < CRATER[2]


def _rocks(seed=4, n=12):
    rng = np.random.default_rng(seed)
    return (np.stack([rng.uniform(0.5, 11.5, n), rng.uniform(0.5, 8.5, n)], axis=1),
            rng.uniform(0.08, 0.4, n))


SUNS = [(0.4, 0.2, 0.9), (-0.8, 0.35, 0.25)]


@pytest.mark.parametrize("sun", SUNS)
def test_normals_and_hillshade_match_jax(sun):
    z = _dem()
    got_n = tlab.surface_normals(torch.from_numpy(z), RES)
    want_n = np.asarray(jlab.surface_normals(jnp.asarray(z), RES))
    np.testing.assert_allclose(got_n.numpy(), want_n, rtol=0, atol=SHADE_ATOL)
    got = tlab.hillshade(torch.from_numpy(z), RES, sun)
    want = np.asarray(jlab.hillshade(jnp.asarray(z), RES, jnp.asarray(sun, jnp.float32)))
    assert got.dtype == torch.float32 and got.shape == want.shape == z.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=SHADE_ATOL)


@pytest.mark.parametrize("sun", SUNS)
def test_cast_shadows_match_jax(sun):
    """A low sun shadows part of the crater floor; the verdicts agree on all
    but a share SHADOW_SHARE of the cells, and on every crater cell."""
    z = _dem()
    got = tlab.cast_shadow_mask(torch.from_numpy(z), RES, sun, steps=48).numpy()
    want = np.asarray(jlab.cast_shadow_mask(jnp.asarray(z), RES,
                                            jnp.asarray(sun, jnp.float32), steps=48))
    differ = got != want
    assert differ.mean() <= SHADOW_SHARE and not differ[_crater_cells(z.shape)].any()
    if sun[2] < 0.5:
        assert want[_crater_cells(z.shape)].mean() > 0.1  # the crater is partly shadowed
    shaded = tlab.hillshade_shadowed(torch.from_numpy(z), RES, sun, shadow_steps=48).numpy()
    want_shaded = np.asarray(jlab.hillshade_shadowed(jnp.asarray(z), RES,
                                                     jnp.asarray(sun, jnp.float32), 48))
    same = ~differ
    np.testing.assert_allclose(shaded[same], want_shaded[same], rtol=0, atol=SHADE_ATOL)


@pytest.mark.parametrize("origin", [(0.0, 0.0), (-3.2, 1.7)])
def test_semantic_and_instance_masks_equal_jax(origin):
    """Overlapping rocks (later ones win) and rocks past the raster's edge."""
    xy, r = _rocks()
    xy = np.concatenate([xy, xy[:3] + 0.1, [[-0.2, 2.0], [12.1, 9.3]]])
    r = np.concatenate([r, r[:3], [0.5, 0.6]])
    shape = (240, 180)
    for t_fn, j_fn in ((tlab.semantic_mask, jlab.semantic_mask),
                       (tlab.instance_mask, jlab.instance_mask)):
        got = t_fn(shape, RES, origin, xy, r).numpy()
        want = np.asarray(j_fn(shape, RES, origin, xy, r))
        assert got.dtype == np.int32 and want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > 5
    for t_fn, j_fn in ((tlab.semantic_mask, jlab.semantic_mask),
                       (tlab.instance_mask, jlab.instance_mask)):
        np.testing.assert_array_equal(t_fn(shape, RES, origin, np.zeros((0, 2)),
                                           np.zeros(0)).numpy(),
                                      np.asarray(j_fn(shape, RES, origin, np.zeros((0, 2)),
                                                      np.zeros(0))))


POSES = [((3.0, 2.0), (1.0, 0.6), 0.8, 15.0), ((10.5, 7.5), (-1.0, -0.9), 1.2, 25.0),
         ((6.0, 1.0), (0.0, 1.0), 0.6, 5.0)]


def _pose(i):
    xy, heading, mount, pitch = POSES[i]
    z = _dem()
    gz = float(z[int(xy[0] / RES), int(xy[1] / RES)])
    want = jlab.camera_pose_from_rover(xy, heading, gz, mount, pitch)
    got = tlab.camera_pose_from_rover(xy, heading, gz, mount, pitch)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    return got


@pytest.mark.parametrize("pose", range(len(POSES)))
def test_camera_raycast_matches_jax(pose):
    z = _dem()
    cam_pos, cam_R = _pose(pose)
    intr = tlab.CameraIntrinsics(width=80, height=60)
    origin = (-0.5, 0.25)
    args = (RES, origin, cam_pos, cam_R, intr.fx, intr.fy, intr.cx, intr.cy)
    got = tlab.camera_raycast(torch.from_numpy(z), *args, width=80, height=60, steps=96)
    want = jlab.camera_raycast(jnp.asarray(z), *args, width=80, height=60, steps=96)
    depth, hx, hy, hit = (t.numpy() for t in got)
    wdepth, whx, why, whit = (np.asarray(a) for a in want)
    assert (hit == whit).mean() >= HIT_SHARE and hit.mean() > 0.3
    both = hit & whit & np.isfinite(depth) & np.isfinite(wdepth)
    np.testing.assert_allclose(depth[both], wdepth[both], rtol=DEPTH_RTOL, atol=0)
    np.testing.assert_allclose(hx[both], whx[both], rtol=DEPTH_RTOL, atol=1e-5)
    np.testing.assert_allclose(hy[both], why[both], rtol=DEPTH_RTOL, atol=1e-5)
    assert np.array_equal(np.isinf(depth), np.isinf(wdepth)) or (hit != whit).any()


def test_rock_intersections_match_jax():
    """The same rays and rock spheres: exact ids, depths to ROCK_RTOL."""
    cam_pos, cam_R = _pose(0)
    intr = tlab.CameraIntrinsics(width=80, height=60)
    d_world = tlab._ray_directions(torch.tensor(cam_R, dtype=torch.float32), intr.fx, intr.fy,
                                   intr.cx, intr.cy, 80, 60)
    xy, r = _rocks()
    centers = np.concatenate([xy, np.full((len(r), 1), 0.05)], axis=1).astype(np.float32)
    cam = np.float32(cam_pos)
    got_s, got_id = tlab._rock_intersections(torch.from_numpy(cam), d_world,
                                             torch.from_numpy(centers),
                                             torch.from_numpy(np.float32(r)),
                                             torch.tensor(40.0))
    want_s, want_id = jlab._rock_intersections(jnp.asarray(cam), jnp.asarray(d_world.numpy()),
                                               jnp.asarray(centers), jnp.asarray(np.float32(r)),
                                               jnp.float32(40.0))
    np.testing.assert_array_equal(got_id.numpy(), np.asarray(want_id))
    assert len(np.unique(np.asarray(want_id))) > 2
    fin = np.isfinite(np.asarray(want_s))
    np.testing.assert_array_equal(np.isfinite(got_s.numpy()), fin)
    np.testing.assert_allclose(got_s.numpy()[fin], np.asarray(want_s)[fin], rtol=ROCK_RTOL)


def _assert_depths(got, want, got_inst, want_inst):
    """Depths on the terrain to DEPTH_RTOL, on rocks to ROCK_RTOL, where
    both renders see the same thing."""
    same = (got_inst == want_inst) & (np.isfinite(got) == np.isfinite(want))
    assert same.mean() >= HIT_SHARE
    same &= np.isfinite(want)
    terrain, rock = same & (want_inst == 0), same & (want_inst > 0)
    np.testing.assert_allclose(got[terrain], want[terrain], rtol=DEPTH_RTOL)
    np.testing.assert_allclose(got[rock], want[rock], rtol=ROCK_RTOL)


def _assert_rgb(got, want, got_inst, want_inst):
    """Terrain shades to SHADE_ATOL on >= 99.9% of the pixels, rock shades
    to ROCK_SHADE_ATOL, where both renders see the same thing."""
    same = got_inst == want_inst
    terrain, rock = same & (want_inst == 0), same & (want_inst > 0)
    assert (np.abs(got - want)[terrain] <= SHADE_ATOL).mean() >= 0.999
    np.testing.assert_allclose(got[rock], want[rock], rtol=0, atol=ROCK_SHADE_ATOL)


@pytest.mark.parametrize("shadows", [False, True])
def test_render_camera_frame_matches_jax(shadows):
    """Depth, rgb, semantic and instance of a frame with rocks in view."""
    z = _dem()
    cam_pos, cam_R = _pose(0)
    intr_t = tlab.CameraIntrinsics(width=64, height=48)
    intr_j = jlab.CameraIntrinsics(width=64, height=48)
    xy, r = _rocks()
    kw = dict(sun_direction=SUNS[1], rock_xy=xy, rock_radius=r, steps=64,
              cast_shadows=shadows)
    got = {k: v.numpy() for k, v in tlab.render_camera_frame(
        torch.from_numpy(z), RES, (0.0, 0.0), cam_pos, cam_R, intr_t, **kw).items()}
    want = {k: np.asarray(v) for k, v in jlab.render_camera_frame(
        z, RES, (0.0, 0.0), cam_pos, cam_R, intr_j, **kw).items()}
    assert set(got) == set(want)
    same = got["hit"] == want["hit"]
    assert same.mean() >= HIT_SHARE and (want["instance"] > 0).any()
    for k in ("semantic", "instance"):
        assert got[k].dtype == want[k].dtype == np.int32
        assert (got[k] == want[k]).mean() >= HIT_SHARE
    _assert_depths(got["depth"], want["depth"], got["instance"], want["instance"])
    _assert_rgb(got["rgb"], want["rgb"], got["instance"], want["instance"])


def test_autonomous_labeling_writes_what_jax_writes(tmp_path):
    """One top-down and one joined camera capture: the same files, the same
    arrays (at the tolerances above), the same camera JSON."""
    z = _dem()
    xy, r = _rocks()
    conf = dict(num_images=1, save_instances=True, save_normals=True)
    runs = {}
    for name, lab, zz in (("t", tlab, torch.from_numpy(z)), ("j", jlab, jnp.asarray(z))):
        labeler = lab.AutonomousLabeling(lab.LabelingConf(data_dir=str(tmp_path / name), **conf))
        labeler.record(zz, RES, sun_direction=SUNS[0], rock_xy=xy, rock_radius=r)
        labeler.record_camera(z if name == "j" else zz, RES, (0.0, 0.0), (3.0, 2.0), (1.0, 0.6),
                              float(z[60, 40]),
                              intrinsics=lab.CameraIntrinsics(width=32, height=24),
                              sun_direction=SUNS[0], rock_xy=xy, rock_radius=r, steps=48,
                              frame=0)
        assert labeler.frame == 1
        runs[name] = labeler.run_dir
    names = sorted(p.name for p in runs["j"].iterdir())
    assert sorted(p.name for p in runs["t"].iterdir()) == names
    assert "camera_00000.json" in names and "instance_00000.npy" in names
    for n in names:
        if n.endswith(".npy"):
            a, b = np.load(runs["t"] / n), np.load(runs["j"] / n)
            assert a.dtype == b.dtype and a.shape == b.shape, n
            if a.dtype == np.int32:
                assert (a == b).mean() >= HIT_SHARE, n
            elif n.startswith(("cam_depth", "cam_rgb")):
                inst = [np.load(runs[k] / n.replace(n.split("_")[1], "instance")) for k in "tj"]
                (_assert_depths if "depth" in n else _assert_rgb)(a, b, *inst)
            else:
                np.testing.assert_allclose(a, b, rtol=0, atol=SHADE_ATOL, err_msg=n)
        elif n.endswith(".json"):
            assert (runs["t"] / n).read_text() == (runs["j"] / n).read_text()


def test_dem_to_mesh_grid_equals_jax():
    z = _dem(h=7, w=5)
    for a, b in zip(tss.dem_to_mesh_grid(torch.from_numpy(z), 0.1),
                    jss.dem_to_mesh_grid(z, 0.1)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _centred_rocks(capacity=32):
    """The test's rocks plus one centred exactly on a raster cell at
    (2.0, 3.0) m (the trap a zero-radius padded slot would hit: ``d2 <= 0``
    is true under its centre), and the padded set of ``capacity`` slots."""
    xy, r = _rocks()
    xy = np.concatenate([xy, [[40 * RES, 60 * RES]]])
    r = np.concatenate([r, [0.3]])
    return xy, r, tlab.pad_rocks(xy, r, capacity)


@pytest.mark.parametrize("origin", [(0.0, 0.0), (-3.2, 1.7)])
def test_padded_rocks_leave_the_masks_equal(origin):
    """Rocks padded to a capacity with masked zero slots (one at the
    origin's cell) give the semantic and instance rasters of the unpadded
    call, ids 1-based in the live order, and still JAX's; without the mask
    a padded slot would claim the cell under it."""
    xy, r, padded = _centred_rocks()
    assert padded.xy.shape == (32, 2) and int(padded.valid.sum()) == len(r)
    shape = (240, 180)
    rows, cols = tlab._raster_axes(shape, RES, origin, None)
    got = tlab._stamp_rocks(rows, cols, padded.xy, padded.radius, padded.valid)
    want = tlab._stamp_rocks(rows, cols, xy, r)
    assert torch.equal(got, want) and int(want.max()) == len(r)
    for t_fn, j_fn in ((tlab.semantic_mask, jlab.semantic_mask),
                       (tlab.instance_mask, jlab.instance_mask)):
        got = t_fn(shape, RES, origin, padded.xy, padded.radius, valid=padded.valid)
        assert torch.equal(got, t_fn(shape, RES, origin, xy, r))
        np.testing.assert_array_equal(got.numpy(), np.asarray(j_fn(shape, RES, origin, xy, r)))
    if origin == (0.0, 0.0):  # a padded slot at (0, 0) sits on cell (0, 0)
        unmasked = tlab._stamp_rocks(rows, cols, padded.xy, padded.radius)
        assert int(unmasked[0, 0]) == 32 and int(want[0, 0]) == 0


def test_padded_rocks_leave_the_camera_frame_equal():
    """``_rock_intersections`` and ``render_camera_frame`` with padded,
    masked rock slots are ``torch.equal`` to the unpadded calls (with and
    without cast shadows, and with no live rock at all), and the frame
    still matches JAX's as in ``test_render_camera_frame_matches_jax``."""
    z = _dem()
    cam_pos, cam_R = _pose(0)
    xy, r, padded = _centred_rocks()
    intr = tlab.CameraIntrinsics(width=64, height=48)
    d_world = tlab._ray_directions(torch.tensor(cam_R, dtype=torch.float32), intr.fx, intr.fy,
                                   intr.cx, intr.cy, 64, 48)
    centers = torch.from_numpy(np.concatenate([padded.xy.numpy(), np.full((32, 1), 0.05)],
                                              axis=1).astype(np.float32))
    cam = torch.from_numpy(np.float32(cam_pos))
    radii = padded.radius.float()
    got = tlab._rock_intersections(cam, d_world, centers, radii, torch.tensor(40.0),
                                   padded.valid)
    want = tlab._rock_intersections(cam, d_world, centers[:len(r)], radii[:len(r)],
                                    torch.tensor(40.0))
    assert all(torch.equal(a, b) for a, b in zip(got, want)) and int(want[1].max()) > 0
    for shadows in (False, True):
        kw = dict(sun_direction=SUNS[1], steps=64, cast_shadows=shadows)
        got = tlab.render_camera_frame(torch.from_numpy(z), RES, (0.0, 0.0), cam_pos, cam_R,
                                       intr, rock_xy=padded.xy, rock_radius=padded.radius,
                                       rock_valid=padded.valid, **kw)
        want = tlab.render_camera_frame(torch.from_numpy(z), RES, (0.0, 0.0), cam_pos, cam_R,
                                        intr, rock_xy=xy, rock_radius=r, **kw)
        assert set(got) == set(want) and all(torch.equal(got[k], want[k]) for k in want)
        jwant = {k: np.asarray(v) for k, v in jlab.render_camera_frame(
            z, RES, (0.0, 0.0), cam_pos, cam_R, jlab.CameraIntrinsics(width=64, height=48),
            rock_xy=xy, rock_radius=r, **kw).items()}
        got = {k: v.numpy() for k, v in got.items()}
        assert (got["hit"] == jwant["hit"]).mean() >= HIT_SHARE and (jwant["instance"] > 0).any()
        _assert_depths(got["depth"], jwant["depth"], got["instance"], jwant["instance"])
        _assert_rgb(got["rgb"], jwant["rgb"], got["instance"], jwant["instance"])
    none = tlab.pad_rocks(None, None, 32)
    got = tlab.render_camera_frame(torch.from_numpy(z), RES, (0.0, 0.0), cam_pos, cam_R, intr,
                                   rock_xy=none.xy, rock_radius=none.radius,
                                   rock_valid=none.valid, steps=64)
    want = tlab.render_camera_frame(torch.from_numpy(z), RES, (0.0, 0.0), cam_pos, cam_R, intr,
                                    steps=64)
    assert all(torch.equal(got[k], want[k]) for k in want)


def test_a_frame_over_the_rock_capacity_raises(tmp_path):
    """A frame never drops rocks: more than the capacity raise, in
    ``pad_rocks`` and in a recorder built with that capacity; the capacity
    rule gives the SDG conf's 10 m yard at 0.08 rocks/m^2 32 slots."""
    xy, r = _rocks(n=12)
    assert tlab.pad_rocks(xy, r, 12).valid.all()
    with pytest.raises(ValueError, match="capacity"):
        tlab.pad_rocks(xy, r, 11)
    assert tlab.rock_capacity(0.08, 100.0) == 32
    labeler = tlab.AutonomousLabeling(tlab.LabelingConf(data_dir=str(tmp_path)),
                                      rock_capacity=8)
    with pytest.raises(ValueError, match="capacity"):
        labeler.record(torch.from_numpy(_dem()), RES, rock_xy=xy, rock_radius=r)


@pytest.mark.parametrize("fx", [False, True], ids=["ray_tracing", "path_tracing"])
def test_recorder_with_a_rock_capacity_writes_what_the_eager_one_writes(tmp_path, fx):
    """Two frames (different rock counts) through the recorder's passes
    with padded rocks (the card's CUDA graphs; here the same functions
    eagerly) and through the eager recorder: every array equal, under
    render settings without and with post effects."""
    from husky_rover_mppi_isaacsim_torch.aux import render_fx

    settings = render_fx.RenderSettings()
    for key in ("/rtx/post/chromaticAberration/enabled", "/rtx/post/lensFlares/enabled",
                "/rtx/post/motionblur/enabled"):
        settings.set(key, fx)
    z = torch.from_numpy(_dem())
    runs = {}
    for name, capacity in (("eager", None), ("padded", 32)):
        conf = tlab.LabelingConf(data_dir=str(tmp_path / name), save_instances=True,
                                 save_normals=True)
        labeler = tlab.AutonomousLabeling(conf, settings, rock_capacity=capacity)
        for i, n in enumerate((12, 5)):
            xy, r = _rocks(seed=i, n=n)
            labeler.record(z, RES, sun_direction=SUNS[i], rock_xy=xy, rock_radius=r)
            labeler.record_camera(z, RES, (0.0, 0.0), (3.0, 2.0), (1.0, 0.6), float(z[60, 40]),
                                  intrinsics=tlab.CameraIntrinsics(width=32, height=24),
                                  sun_direction=SUNS[i], rock_xy=xy, rock_radius=r, steps=48,
                                  cast_shadows=True, frame=i)
        runs[name] = labeler.run_dir
    names = sorted(p.name for p in runs["eager"].iterdir())
    assert sorted(p.name for p in runs["padded"].iterdir()) == names and len(names) > 10
    for n in names:
        if n.endswith(".npy"):
            np.testing.assert_array_equal(np.load(runs["padded"] / n), np.load(runs["eager"] / n),
                                          err_msg=n)
