"""PyTorch port: the worldbuilders (``husky_rover_mppi_isaacsim_torch/
worldbuilders``) against the JAX package's, scenario by scenario: the 15
scenarios of tests/test_worldbuilders.py, each run through both packages
from the same seeds and the same numpy inputs.

Counts are EQUAL (both draw from ``np.random.default_rng`` in the same
order). Coordinates are equal where the arithmetic after the draws is
additions, products, square roots, comparisons and the floor division of
the clippers; where it takes ``sin`` / ``cos`` / ``atan2`` / ``pow`` or a
4-term matrix product (torch's and numpy's differ in the last bit) they
agree to 1e-12 in float64. Quaternions from a float32 DEM's slopes agree to
the spacing of the largest slope (numpy's float32 ``arctan2`` is not
correctly rounded; each slope enters the quaternion's half-angle terms with
a derivative below 1).
"""

import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch import worldbuilders as tw
from husky_rover_mppi_isaacsim_tpu import worldbuilders as jw

torch.set_num_threads(1)

TRIG_ATOL = 1e-12


def _kw(wb):
    return {"device": "cpu"} if wb is tw else {}


def _layer(wb, layer, sampler):
    return wb.Layer_Factory.get(layer, sampler, **_kw(wb))


SCENARIOS = {}


def scenario(atol=0.0):
    def register(fn):
        SCENARIOS[fn.__name__] = (fn, atol)
        return fn
    return register


@scenario()
def uniform_plane(wb, rng):
    return {"pts": _layer(wb, wb.Plane_T(xmin=-2, xmax=3, ymin=1, ymax=4), wb.UniformSampler_T(
        randomization_space=2, min=(-2, 1), max=(3, 4), seed=0))(1000)}


@scenario(TRIG_ATOL)
def disk_layer_annulus(wb, rng):
    return {"pts": _layer(wb, wb.Disk_T(center=(1.0, -1.0), radius_min=0.5, radius_max=2.0),
                          wb.UniformSampler_T(randomization_space=2, min=(0, 0), max=(1, 1),
                                              seed=1))(2000)}


@scenario(TRIG_ATOL)
def circle_layer_on_ring(wb, rng):
    return {"pts": _layer(wb, wb.Circle_T(center=(0, 0), radius=2.0, alpha=1.0, beta=0.5),
                          wb.UniformSampler_T(randomization_space=1, min=(0,),
                                              max=(2 * np.pi,), seed=2))(500)}


@scenario(TRIG_ATOL)
def sphere_cylinder_cone_torus_within_bounds(wb, rng):
    def sampler(seed):
        return wb.UniformSampler_T(randomization_space=3, min=(0, 0, 0), max=(1, 1, 1),
                                   seed=seed)

    return {
        "sphere": _layer(wb, wb.Sphere_T(center=(0, 0, 0), radius_min=1.0, radius_max=2.0),
                         sampler(3))(800),
        "cylinder": _layer(wb, wb.Cylinder_T(radius_max=1.5, height_min=-1, height_max=1),
                           sampler(4))(800),
        "cone": _layer(wb, wb.Cone_T(radius_max=2.0, height_min=0, height_max=1),
                       sampler(5))(800),
        "torus": _layer(wb, wb.Torus_T(ring_radius=3.0, tube_radius_max=0.5), sampler(6))(800),
    }


@scenario()
def polygon_layer(wb, rng):
    return {"pts": _layer(wb, wb.Polygon_T(vertices=((0, 0), (4, 0), (0, 4))), wb.UniformSampler_T(
        randomization_space=2, min=(0, 0), max=(4, 4), seed=7))(500)}


@scenario(TRIG_ATOL)
def transform_2d(wb, rng):
    tr = wb.Transformation2D_T(translation=wb.Translation2D_T(x=10.0, y=-5.0),
                               orientation=wb.Rot2D_T(theta=np.pi / 2))
    return {"pts": _layer(wb, wb.Plane_T(xmin=0, xmax=1, ymin=0, ymax=0, transform=tr),
                          wb.UniformSampler_T(randomization_space=2, min=(0, 0), max=(1, 0),
                                              seed=8))(100)}


@scenario()
def hardcore_uniform_min_distance(wb, rng):
    return {"pts": _layer(wb, wb.Plane_T(xmin=0, xmax=10, ymin=0, ymax=10),
                          wb.HardCoreUniformSampler_T(randomization_space=2, min=(0, 0),
                                                      max=(10, 10), seed=9, core_radius=1.0,
                                                      num_repeat=1))(200)}


@scenario(TRIG_ATOL)
def matern_and_thomas_cluster(wb, rng):
    plane = wb.Plane_T(xmin=0, xmax=20, ymin=0, ymax=20)
    return {
        "matern": _layer(wb, plane, wb.MaternClusterPointSampler_T(
            randomization_space=2, lambda_parent=0.05, lambda_daughter=20, cluster_radius=1.0,
            seed=10))(1),
        "thomas": _layer(wb, plane, wb.ThomasClusterSampler_T(
            randomization_space=2, lambda_parent=0.05, lambda_daughter=20, sigma=0.5,
            seed=11))(1),
    }


@scenario()
def poisson_point_sampler_density(wb, rng):
    return {"pts": _layer(wb, wb.Plane_T(xmin=0, xmax=10, ymin=0, ymax=10),
                          wb.PoissonPointSampler_T(randomization_space=2, lambda_poisson=2,
                                                   seed=12))(1)}


@scenario()
def linear_and_deterministic(wb, rng):
    return {
        "linear": _layer(wb, wb.Line_T(xmin=0, xmax=1), wb.LinearInterpolationSampler_T(
            randomization_space=1, min=(0,), max=(1,), seed=0))(5),
        "deterministic": _layer(wb, wb.Plane_T(xmin=0, xmax=1, ymin=0, ymax=1),
                                wb.DeterministicSampler_T(
                                    randomization_space=2,
                                    data=np.array([[0.1, 0.2], [0.3, 0.4]])))(2),
    }


@scenario()
def image_layer_mask_weighting(wb, rng):
    mask = np.zeros((20, 20))
    mask[:, 10:] = 1.0
    return {"pts": _layer(wb, wb.Image_T(data=mask, mpp_resolution=1.0), wb.UniformSampler_T(
        randomization_space=2, min=(0, 0), max=(20, 20), seed=13,
        use_image_sampling=True))(300)}


@scenario()
def height_clipper_origin_modes(wb, rng):
    img = rng.normal(size=(16, 16))
    q = np.array([[3.2, 4.7], [8.1, 1.3]])
    return {origin: wb.HeightClipper(wb.ImageClipper_T(
        randomization_space=1, resolution=(16, 16), mpp_resolution=1.0, data=img,
        loc_origin=origin), **_kw(wb))(query_point=q) for origin in ("lower", "upper", "center")}


@scenario(TRIG_ATOL)
def normal_map_clipper_unit_quats(wb, rng):
    img = rng.normal(size=(16, 16)) * 0.1
    clip = wb.NormalMapClipper(wb.NormalMapClipper_T(
        randomization_space=1, resolution=(16, 16), mpp_resolution=1.0, data=img), **_kw(wb))
    return {"quat": clip(query_point=np.array([[5.0, 5.0], [2.0, 9.0]]))}


def _full_pipeline_requests(wb, dem, origin="upper", mpp=1.0, seeds=(3, 4), hardcore=False):
    res = dem.shape
    if hardcore:
        pp = wb.HardCoreThomasClusterSampler_T(
            randomization_space=2, lambda_parent=0.05, lambda_daughter=10, sigma=0.5,
            core_radius=0.3, num_repeat=1, seed=seeds[0])
    else:
        pp = wb.ThomasClusterSampler_T(randomization_space=2, lambda_parent=0.05,
                                       lambda_daughter=10, sigma=0.5, seed=seeds[0])
    side = res[0] * mpp
    return (
        wb.UserRequest_T(p_type=wb.Position_T(), sampler=pp,
                         layer=wb.Plane_T(xmin=0, xmax=side - 2, ymin=0, ymax=side - 2),
                         axes=["x", "y"]),
        wb.UserRequest_T(p_type=wb.Position_T(), sampler=wb.ImageClipper_T(
            randomization_space=1, resolution=res, mpp_resolution=mpp, data=dem,
            loc_origin=origin), layer=wb.Line_T(xmin=0, xmax=1), axes=["z"]),
        wb.UserRequest_T(p_type=wb.Scale_T(), sampler=wb.UniformSampler_T(
            randomization_space=1, min=(0.5,), max=(1.5,), seed=seeds[1]),
            layer=wb.Line_T(xmin=0.5, xmax=1.5), axes=["xyz"]),
        wb.UserRequest_T(p_type=wb.OrientationParam_T(), sampler=wb.NormalMapClipper_T(
            randomization_space=1, resolution=res, mpp_resolution=mpp, data=dem,
            loc_origin=origin), layer=wb.RollPitchYaw_T(output_space=4),
            axes=["x", "y", "z", "w"]),
    )


@scenario(TRIG_ATOL)
def request_mixer_full_pipeline(wb, rng):
    dem = rng.normal(size=(32, 32)) * 0.1
    return wb.RequestMixer(_full_pipeline_requests(wb, dem), **_kw(wb))(num=1)


@scenario()
def mixer_default_fill(wb, rng):
    reqs = (wb.UserRequest_T(p_type=wb.Position_T(), sampler=wb.UniformSampler_T(
        randomization_space=2, min=(0, 0), max=(1, 1), seed=5),
        layer=wb.Plane_T(xmin=0, xmax=1, ymin=0, ymax=1), axes=["x", "y"]),)
    return wb.RequestMixer(reqs, **_kw(wb))(num=7)


def _numpy(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_same(got: dict, want: dict, atol: float):
    assert list(got) == list(want)
    for key in want:
        g, w = _numpy(got[key]), _numpy(want[key])
        assert g.shape == w.shape, (key, g.shape, w.shape)
        if atol == 0.0:
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=key)


def test_every_jax_scenario_is_here():
    import test_worldbuilders

    names = sorted(n[len("test_"):] for n in dir(test_worldbuilders) if n.startswith("test_"))
    assert names == sorted(SCENARIOS) and len(names) == 15


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_scenario_equals_jax(name):
    fn, atol = SCENARIOS[name]
    got = fn(tw, np.random.default_rng(1234))
    want = fn(jw, np.random.default_rng(1234))
    for v in got.values():
        assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
    _assert_same(got, want, atol)


@pytest.mark.parametrize("mpp", [1.0, 0.1, 0.3, 0.025])
def test_cell_borders_land_in_jax_cells(mpp):
    """Points exactly on cell borders, just beside them, negative and past
    the far edge: every origin mode reads the JAX package's cell (numpy's
    fmod-based ``//``, e.g. ``1.0 // 0.1 == 9``)."""
    img = np.arange(24 * 20, dtype=np.float64).reshape(24, 20)
    k = np.arange(-3, 26)
    xs = np.concatenate([k * mpp, np.nextafter(k * mpp, -np.inf), np.nextafter(k * mpp, np.inf),
                         [1.0, 0.7, 2.1, -0.1, 1e-300, -1e-300]])
    q = np.stack([xs, xs[::-1]], axis=1)
    for origin in ("lower", "upper", "center"):
        cfgs = [wb.ImageClipper_T(randomization_space=1, resolution=(24, 20),
                                  mpp_resolution=mpp, data=img, loc_origin=origin)
                for wb in (tw, jw)]
        got = tw.HeightClipper(cfgs[0], device="cpu")(query_point=q)
        want = jw.HeightClipper(cfgs[1])(query_point=q)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=origin)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_mixer_with_both_clippers_on_a_lower_origin_dem(dtype):
    """A rock request in the form of the reference's yard requests, cut to a
    64^2 DEM at 0.25 m/px: hard-core Thomas xy, z from an image clipper,
    orientation from a normal-map clipper, both with the lower origin, on a
    float64 and a float32 DEM."""
    dem = (np.random.default_rng(7).normal(size=(64, 64)) * 0.1).astype(dtype)
    got = tw.RequestMixer(_full_pipeline_requests(tw, dem, "lower", 0.25, (21, 22), True),
                          device="cpu")(num=1)
    want = jw.RequestMixer(_full_pipeline_requests(jw, dem, "lower", 0.25, (21, 22), True))(num=1)
    assert got["xformOp:translation"].shape[0] > 20
    for key in ("xformOp:translation", "xformOp:scale"):
        np.testing.assert_array_equal(got[key].numpy(), want[key], err_msg=key)
    if dtype == np.float64:
        atol = TRIG_ATOL
    else:
        slopes = np.rad2deg(np.arctan2(np.stack(np.gradient(dem)), 1))
        atol = float(np.spacing(np.abs(slopes).max()))
    np.testing.assert_allclose(got["xformOp:orientation"].numpy(), want["xformOp:orientation"],
                               rtol=0, atol=atol)


def test_hardcore_thinning_in_chunks_equals_one_block(monkeypatch):
    """The thinning's row chunks change nothing: a chunk of a few rows keeps
    the same points as one block of all pairs (and as the JAX package)."""
    from husky_rover_mppi_isaacsim_torch.worldbuilders import samplers as tsamp
    from husky_rover_mppi_isaacsim_tpu.worldbuilders import samplers as jsamp

    pts = np.random.default_rng(3).uniform(0, 4, (500, 2))
    want = jsamp._hardcore_reject(np.random.default_rng(5), pts, 0.2)
    for chunk in (1 << 25, 3 * 500, 7):
        monkeypatch.setattr(tsamp, "PAIR_CHUNK", chunk)
        got = tsamp._hardcore_reject(np.random.default_rng(5), torch.from_numpy(pts), 0.2)
        np.testing.assert_array_equal(got.numpy(), want)
    assert 0 < want.sum() < 500


def test_factories_run_on_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tw.Layer_Factory.get(tw.Plane_T(), tw.UniformSampler_T(randomization_space=2,
                                                               min=(0, 0), max=(1, 1)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tw.Clipper_Factory.get(tw.ImageClipper_T(randomization_space=1, data=np.zeros((2, 2))))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tw.RequestMixer(())
    assert tw.RequestMixer((), device="cpu").device == torch.device("cpu")
