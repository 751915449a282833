"""PyTorch port: the cv2-compatible chamfer costmap against the JAX package.

``chamfer5`` is held bit for bit (``np.array_equal``) to the JAX package's
pure-numpy raster scan ``_chamfer5_numpy``, and to 1e-3 px of cv2 (the
tolerance the JAX package holds its own fallback to). ``costmap_750()``
with no arguments is the chamfer costmap in both packages (the JAX one
through cv2 where it imports, its native library or its numpy scan
otherwise); ``use_exact_edt=True`` keeps the exact-EDT costmap the port's
world builds ask for."""

import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch.ops import edt as tedt
from husky_rover_mppi_isaacsim_torch.terrain import costmap as tcost
from husky_rover_mppi_isaacsim_tpu.ops.edt import _chamfer5_numpy
from husky_rover_mppi_isaacsim_tpu.terrain import costmap as jcost

torch.set_num_threads(1)

# the chamfer's distance bound against cv2, in pixels
CV2_ATOL = 1e-3


def _images():
    rng = np.random.default_rng(4)
    rand = (rng.random((64, 64)) > 0.05).astype(np.uint8) * 255
    rand[10, 10] = 0
    ragged = (rng.random((37, 53)) > 0.02).astype(np.uint8) * 255
    border = np.full((30, 41), 255, np.uint8)
    border[0, :] = 0
    border[:, -1] = 0
    corner = np.full((25, 25), 255, np.uint8)
    corner[-1, 0] = 0
    return {"random_64": rand, "random_37x53": ragged, "border": border, "corner": corner,
            "all_free": np.full((20, 23), 255, np.uint8),
            "all_obstacle": np.zeros((19, 17), np.uint8)}


IMAGES = _images()


@pytest.mark.parametrize("name", sorted(IMAGES))
def test_chamfer5_bit_equal_to_jax_numpy_scan(name):
    img = IMAGES[name]
    got = tedt.chamfer5(img)
    want = _chamfer5_numpy(img)
    assert got.dtype == want.dtype == np.float32 and got.shape == img.shape
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", ["random_64", "random_37x53", "border", "corner"])
def test_chamfer5_close_to_cv2(name):
    cv2 = pytest.importorskip("cv2")
    img = IMAGES[name]
    np.testing.assert_allclose(tedt.chamfer5(img), cv2.distanceTransform(img, cv2.DIST_L2, 5),
                               rtol=0, atol=CV2_ATOL)


def test_chamfer5_bit_equal_on_the_750_obstacle_field():
    """The rasterized obstacle field at a reduced size, where the sequential
    scan is still quick."""
    img = tcost.rasterize_obstacles(tcost.generate_obstacles(), size=120, robot_radius=0.3)
    assert (img == 0).any() and (img != 0).any()
    assert np.array_equal(tedt.chamfer5(img), _chamfer5_numpy(img))


def test_reference_costmap_equal_to_jax_on_the_numpy_scan(monkeypatch):
    """With the JAX package held to its numpy scan, the two reference
    costmaps are the same float32 numbers."""
    import husky_rover_mppi_isaacsim_tpu.terrain.costmap as jc

    monkeypatch.setattr(jc, "chamfer5", _chamfer5_numpy)
    img = tcost.rasterize_obstacles(tcost.generate_obstacles(num=60, seed=5, extent=20.0),
                                    half_width=30.0, size=90, robot_radius=1.0)
    got = tcost.reference_costmap(img, falloff_power=10.0)
    want = jc.reference_costmap(img, falloff_power=10.0)
    assert got.dtype == np.float32 and np.array_equal(got, want)


def test_costmap_750_default_is_the_chamfer_costmap():
    """Both packages' defaults at size 188. The distances agree to
    ``CV2_ATOL`` px (d); min-max normalizing over a range R moves a
    normalized distance by at most 2 d / R, and ``(1 - x)^p`` moves by at
    most p times that, plus float32 rounding."""
    p = 20.0
    got = tcost.costmap_750(size=188)
    want = jcost.costmap_750(size=188)
    img = tcost.rasterize_obstacles(tcost.generate_obstacles(), size=188, robot_radius=0.3)
    dist = tedt.chamfer5(img)
    tol = p * 2 * CV2_ATOL / float(dist.max() - dist.min()) + 1e-6
    assert got.cost.dtype == torch.float32 and got.cost.shape == (188, 188)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost), rtol=0, atol=tol)
    assert float(got.half_width) == float(want.half_width)
    assert float(got.resolution) == float(want.resolution)
    # the chamfer costmap is not the exact-EDT one
    exact = tcost.costmap_750(size=188, use_exact_edt=True)
    assert not torch.equal(got.cost, exact.cost)


def test_costmap_750_exact_edt_unchanged():
    """``use_exact_edt=True`` is the exact-EDT costmap the port built before
    the chamfer route existed: ``distance_costmap`` of the same raster."""
    got = tcost.costmap_750(size=188, use_exact_edt=True)
    img = tcost.rasterize_obstacles(tcost.generate_obstacles(), size=188, robot_radius=0.3)
    want = tedt.distance_costmap(torch.as_tensor(img == 0))
    assert torch.equal(got.cost, want)
    jwant = jcost.costmap_750(size=188, use_exact_edt=True)
    np.testing.assert_allclose(got.cost.numpy(), np.asarray(jwant.cost), rtol=0, atol=1e-6)


@pytest.mark.parametrize("use_exact_edt", [True, False], ids=["exact", "chamfer"])
def test_update_costmap_with_obstacles_both_routes(use_exact_edt, monkeypatch):
    import husky_rover_mppi_isaacsim_tpu.terrain.costmap as jc

    monkeypatch.setattr(jc, "chamfer5", _chamfer5_numpy)
    rng = np.random.default_rng(2)
    xy, radii = rng.uniform(-8.0, 8.0, (12, 2)), rng.uniform(0.1, 0.5, 12)
    args = (48, 10.0, xy, radii, 0.3)
    kw = dict(falloff_power=20.0, use_exact_edt=use_exact_edt, origin=(1.0, -0.5))
    got = tcost.update_costmap_with_obstacles(*args, **kw)
    want = jc.update_costmap_with_obstacles(*args, **kw)
    if use_exact_edt:
        np.testing.assert_allclose(got.cost.numpy(), np.asarray(want.cost), rtol=0, atol=1e-6)
    else:
        assert np.array_equal(got.cost.numpy(), np.asarray(want.cost))
    default = tcost.update_costmap_with_obstacles(*args, falloff_power=20.0, origin=(1.0, -0.5))
    assert torch.equal(default.cost, got.cost) == use_exact_edt
