"""PyTorch port: the render post-effects (aux/render_fx.py) against the JAX
package's, on the same seeded float32 image.

Each effect is float32 arithmetic in the JAX package's order: op by op
(``jax.disable_jit``) the warps equal JAX's bit for bit. Compiled, XLA
multiplies by the reciprocal of a constant divisor and fuses multiply-adds,
which moves the warped images by up to 3.2e-6 on [0, 1]: EFFECT_ATOL =
4e-6. The lens flare's glow is a 61 x 61 convolution whose 3721 taps XLA
and ``F.conv2d`` sum in different orders: FLARE_ATOL = 2e-6. The starburst
PSF goes through ``exp(-d^2 / 0.002)`` of an ``atan2``, which turns the
last bit of the angle into ~1e-5 of the value: STARBURST_RTOL = 1e-4."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch.aux import render_fx as tfx
from husky_rover_mppi_isaacsim_tpu.aux import render_fx as jfx

# small tensors: one intra-op thread each, so that the test workers running
# beside these do not lose their cores
torch.set_num_threads(1)

EFFECT_ATOL = 4e-6
FLARE_ATOL = 2e-6
STARBURST_RTOL = 1e-4


def _image(seed=3, h=72, w=96):
    """A smooth image in [0, 1] with a few bright spots over the flare's
    threshold."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = 0.4 + 0.3 * np.sin(xx / 7.0)[..., None] * np.cos(yy / 5.0)[..., None] \
        + 0.05 * rng.uniform(size=(h, w, 3))
    for y, x in rng.integers(8, min(h, w) - 8, (4, 2)):
        img[y - 2:y + 3, x - 2:x + 3] = 0.97
    return np.clip(img, 0.0, 1.0).astype(np.float32)


@pytest.mark.parametrize("models", [("Radial", "Radial", "Radial"),
                                    ("Barrel", "Radial", "Barrel")])
def test_chromatic_aberration_matches_jax(models):
    strength = np.array([-0.055, -0.075, 0.015], np.float32)
    got = tfx.chromatic_aberration(torch.from_numpy(_image()), strength, models)
    want = np.asarray(jfx.chromatic_aberration(jnp.asarray(_image()), jnp.asarray(strength),
                                               models))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=EFFECT_ATOL)
    assert np.abs(want - _image()).max() > 1e-2  # the warp moved pixels
    with jax.disable_jit():
        op_by_op = np.asarray(jfx.chromatic_aberration(jnp.asarray(_image()),
                                                       jnp.asarray(strength), models))
    np.testing.assert_array_equal(got.numpy(), op_by_op)


@pytest.mark.parametrize("blades,rotation", [(9, 0.0), (6, 17.5)])
def test_starburst_kernel_matches_jax(blades, rotation):
    got = tfx.starburst_kernel(blades, rotation, 12, 1.5)
    want = np.asarray(jfx.starburst_kernel(blades, jnp.float32(rotation), 12, 1.5))
    assert got.shape == want.shape == (25, 25)
    np.testing.assert_allclose(got.numpy(), want, rtol=STARBURST_RTOL, atol=1e-9)
    assert abs(float(got.sum()) - 1.0) < 1e-5


def test_lens_flare_matches_jax():
    img = _image()
    got = tfx.lens_flare(torch.from_numpy(img), torch.tensor(0.4), 9, torch.tensor(0.0), 30, 1.5)
    want = np.asarray(jfx.lens_flare(jnp.asarray(img), jnp.float32(0.4), 9, jnp.float32(0.0),
                                     30, 1.5))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FLARE_ATOL)
    assert np.abs(want - img).max() > 1e-3  # the glow is there


@pytest.mark.parametrize("velocity,samples", [((6.0, -3.5), 8), ((0.0, 0.0), 8), ((5.0, 5.0), 1)])
def test_motion_blur_matches_jax(velocity, samples):
    img = _image()
    got = tfx.motion_blur(torch.from_numpy(img), velocity, 1.0, 0.02, samples)
    want = np.asarray(jfx.motion_blur(jnp.asarray(img), jnp.asarray(velocity, jnp.float32),
                                      jnp.float32(1.0), jnp.float32(0.02), samples))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=EFFECT_ATOL)


def _settings(pkg, enable):
    s = pkg.RenderSettings()
    for apply, conf in ((pkg.apply_lens_flare, pkg.FlaresConf),
                        (pkg.apply_chromatic_aberrations, pkg.ChromaticAberrationsConf),
                        (pkg.apply_motion_blur, pkg.MotionBlurConf)):
        apply(conf(enable=enable), s)
    return s


@pytest.mark.parametrize("enable", [False, True])
def test_apply_post_fx_matches_jax(enable):
    """All three effects in the RTX order, or none (then only the clip)."""
    img = _image(seed=5)
    got = tfx.apply_post_fx(torch.from_numpy(img), _settings(tfx, enable), (4.0, 2.0))
    want = np.asarray(jfx.apply_post_fx(jnp.asarray(img), _settings(jfx, enable), (4.0, 2.0)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FLARE_ATOL)


def test_settings_surface_matches_jax():
    """The same keys and values after the defaults, the setters and the
    render-mode switches."""
    t, j = tfx.RenderSettings(), jfx.RenderSettings()
    assert t._kv == j._kv
    for pkg, s in ((tfx, t), (jfx, j)):
        pkg.set_flare_scale(0.7, s)
        pkg.set_chromatic_aberrations_strength((0.1, 0.2, 0.3), s)
        pkg.set_chromatic_aberrations_model(("Barrel", "Radial", "Barrel"), s)
        pkg.set_motion_blur_num_samples(4.0, s)
        pkg.enable_RTX_interactive(s)
    assert t._kv == j._kv and t.get("/rtx/post/motionblur/numSamples") == 4
    assert set(tfx._KNOBS) == set(jfx._KNOBS) and set(tfx._RGB_KNOBS) == set(jfx._RGB_KNOBS)
    for cls in ("FlaresConf", "ChromaticAberrationsConf", "MotionBlurConf"):
        assert dataclasses.asdict(getattr(tfx, cls)()) == dataclasses.asdict(getattr(jfx, cls)())
