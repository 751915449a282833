"""Camera post-processing effects (counterpart of the JAX
``aux/render_fx.py``): the replacement for the RTX post pipeline the
reference drives through carb settings (``src/environments/rendering.py``).

The reference only sets knobs on Isaac's renderer (``/rtx/post/lensFlares/*``,
``/rtx/post/chromaticAberration/*``, ``/rtx/post/motionblur/*``). Here the
renderer is the SDG hillshade pass (:mod:`.labeling`), so the effects are
image ops on the image's device with the same parameter surface:

* **lens flare**: bright-pass, then a convolution with an N-bladed
  starburst PSF built from the aperture parameters;
* **chromatic aberration**: a per-channel radial or barrel warp, bilinear
  resampling;
* **motion blur**: ``num_samples`` taps along the image-space velocity,
  scaled by ``exposure_fraction`` and capped at
  ``max_blur_diameter_fraction`` of the image diagonal.

:class:`RenderSettings` mirrors ``carb.settings``, so the setters keep the
reference's names (``set_flare_scale``, ``enable_chromatic_aberrations``,
...). The glow convolution is ``F.conv2d`` (cross-correlation, as XLA's
``conv_general_dilated``); on the card it needs TF32 off, which the CLI sets.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

# -- configuration dataclasses (src/configurations/rendering_confs.py) ------


@dataclasses.dataclass
class FlaresConf:
    """Lens-flare knobs (rendering.py:64-177)."""

    enable: bool = False
    scale: float = 0.4
    blades: int = 9
    aperture_rotation: float = 0.0   # degrees
    sensor_diagonal: float = 28.0    # mm
    sensor_aspect_ratio: float = 1.5
    fstop: float = 2.8
    focal_length: float = 12.0       # mm


@dataclasses.dataclass
class ChromaticAberrationsConf:
    """Chromatic-aberration knobs (rendering.py:195-262)."""

    enable: bool = False
    strength: Tuple[float, float, float] = (-0.055, -0.075, 0.015)
    model: Tuple[str, str, str] = ("Radial", "Radial", "Radial")
    enable_lanczos: bool = False


@dataclasses.dataclass
class MotionBlurConf:
    """Motion-blur knobs (rendering.py:280-340)."""

    enable: bool = False
    max_blur_diameter_fraction: float = 0.02
    exposure_fraction: float = 1.0
    num_samples: int = 8


# -- carb.settings analogue --------------------------------------------------


class RenderSettings:
    """Flat key-value store with the reference's ``/rtx/post`` keys."""

    def __init__(self):
        self._kv: Dict[str, object] = {}
        apply_lens_flare(FlaresConf(), self)
        apply_chromatic_aberrations(ChromaticAberrationsConf(), self)
        apply_motion_blur(MotionBlurConf(), self)
        self._kv["/rtx/rendermode"] = "RayTracedLighting"

    def set(self, key: str, value) -> None:
        self._kv[key] = value

    def get(self, key: str):
        return self._kv[key]


_GLOBAL_SETTINGS: RenderSettings | None = None


def get_settings() -> RenderSettings:
    """The process-wide settings the setters write when given none (the
    reference's ``carb.settings`` singleton)."""
    global _GLOBAL_SETTINGS
    if _GLOBAL_SETTINGS is None:
        _GLOBAL_SETTINGS = RenderSettings()
    return _GLOBAL_SETTINGS


# -- setter surface (same names as rendering.py) -----------------------------
#
# One knob -> settings-path table; the reference-named setters are generated
# from it.

# setter name -> (conf field, settings path, cast)
_KNOBS: Dict[str, Tuple[str, str, type]] = {
    "enable_lens_flare": ("enable", "/rtx/post/lensFlares/enabled", bool),
    "set_flare_scale": ("scale", "/rtx/post/lensFlares/flareScale", float),
    "set_flare_num_blades": ("blades", "/rtx/post/lensFlares/blades", int),
    "set_flare_aperture_rotation":
        ("aperture_rotation", "/rtx/post/lensFlares/apertureRotation", float),
    "set_flare_sensor_diagonal":
        ("sensor_diagonal", "/rtx/post/lensFlares/sensorDiagonal", float),
    "set_flare_sensor_aspect_ratio":
        ("sensor_aspect_ratio", "/rtx/post/lensFlares/sensorAspectRatio", float),
    "set_flare_fstop": ("fstop", "/rtx/post/lensFlares/fNumber", float),
    "set_flare_focal_length": ("focal_length", "/rtx/post/lensFlares/focalLength", float),
    "enable_chromatic_aberrations": ("enable", "/rtx/post/chromaticAberration/enabled", bool),
    "set_chromatic_aberrations_lanczos":
        ("enable_lanczos", "/rtx/post/chromaticAberration/enableLanczos", bool),
    "enable_motion_blur": ("enable", "/rtx/post/motionblur/enabled", bool),
    "set_motion_blur_diameter_fraction":
        ("max_blur_diameter_fraction", "/rtx/post/motionblur/maxBlurDiameterFraction", float),
    "set_motion_blur_exposure_fraction":
        ("exposure_fraction", "/rtx/post/motionblur/exposureFraction", float),
    "set_motion_blur_num_samples": ("num_samples", "/rtx/post/motionblur/numSamples", int),
}

# per-channel fan-out knobs (strengthR/G/B, modelR/G/B)
_RGB_KNOBS: Dict[str, Tuple[str, str]] = {
    "set_chromatic_aberrations_strength":
        ("strength", "/rtx/post/chromaticAberration/strength"),
    "set_chromatic_aberrations_model": ("model", "/rtx/post/chromaticAberration/model"),
}


def _make_setter(path: str, cast):
    def setter(value, settings=None):
        (settings or get_settings()).set(path, cast(value))
    return setter


def _make_rgb_setter(prefix: str):
    def setter(value, settings=None):
        s = settings or get_settings()
        for ch, v in zip("RGB", value):
            s.set(prefix + ch, v)
    return setter


for _name, (_field, _path, _cast) in _KNOBS.items():
    globals()[_name] = _make_setter(_path, _cast)
for _name, (_field, _prefix) in _RGB_KNOBS.items():
    globals()[_name] = _make_rgb_setter(_prefix)


def _apply_conf(conf, prefix: str, settings=None) -> None:
    """Push every knob of ``conf`` whose settings path is under ``prefix``
    (the reference's apply_* functions, rendering.py:64-80)."""
    for name, (field, path, _) in _KNOBS.items():
        if path.startswith(prefix) and hasattr(conf, field):
            globals()[name](getattr(conf, field), settings)
    for name, (field, pfx) in _RGB_KNOBS.items():
        if pfx.startswith(prefix) and hasattr(conf, field):
            globals()[name](getattr(conf, field), settings)


def enable_RTX_real_time(settings: RenderSettings | None = None, **kwargs) -> None:
    (settings or get_settings()).set("/rtx/rendermode", "RayTracedLighting")


def enable_RTX_interactive(settings: RenderSettings | None = None, **kwargs) -> None:
    (settings or get_settings()).set("/rtx/rendermode", "PathTracing")


def apply_lens_flare(conf: FlaresConf, settings=None) -> None:
    _apply_conf(conf, "/rtx/post/lensFlares/", settings)


def apply_chromatic_aberrations(conf: ChromaticAberrationsConf, settings=None) -> None:
    _apply_conf(conf, "/rtx/post/chromaticAberration/", settings)


def apply_motion_blur(conf: MotionBlurConf, settings=None) -> None:
    _apply_conf(conf, "/rtx/post/motionblur/", settings)


# -- the effects themselves --------------------------------------------------


def _pixel_grid(h: int, w: int, like: Tensor) -> tuple[Tensor, Tensor]:
    """Row and column index planes ``(h, w)`` in ``like``'s dtype."""
    rows = torch.arange(h, dtype=like.dtype, device=like.device)
    cols = torch.arange(w, dtype=like.dtype, device=like.device)
    return torch.meshgrid(rows, cols, indexing="ij")


def _resample_bilinear(img: Tensor, xs: Tensor, ys: Tensor) -> Tensor:
    """Gather ``img[ys, xs]`` with bilinear weights, edge-clamped."""
    h, w = img.shape
    x0 = torch.clamp(torch.floor(xs).to(torch.int64), 0, w - 2)
    y0 = torch.clamp(torch.floor(ys).to(torch.int64), 0, h - 2)
    fx = torch.clamp(xs - x0, 0.0, 1.0)
    fy = torch.clamp(ys - y0, 0.0, 1.0)
    return (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x0 + 1] * fx * (1 - fy)
            + img[y0 + 1, x0] * (1 - fx) * fy + img[y0 + 1, x0 + 1] * fx * fy)


def chromatic_aberration(image: Tensor, strength, models=("Radial", "Radial", "Radial")
                         ) -> Tensor:
    """Per-channel radial/barrel warp (the RTX chromaticAberration model).

    ``Radial``: sample channel c at r' = r * (1 + k_c); ``Barrel``:
    r' = r * (1 + k_c * r_hat^2)."""
    h, w, _ = image.shape
    strength = torch.as_tensor(strength, dtype=image.dtype, device=image.device)
    yy, xx = _pixel_grid(h, w, image)
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    dx, dy = xx - cx, yy - cy
    r2 = (dx / cx) ** 2 + (dy / cy) ** 2  # normalized radius^2
    chans = []
    for c in range(3):
        scale = 1.0 + strength[c] * r2 if models[c] == "Barrel" else 1.0 + strength[c]
        chans.append(_resample_bilinear(image[..., c], cx + dx * scale, cy + dy * scale))
    return torch.stack(chans, dim=-1)


def starburst_kernel(blades: int, rotation_deg, length_px: int, aspect: float = 1.5,
                     dtype=torch.float32, device=None) -> Tensor:
    """N-bladed diffraction-spike PSF: ``blades`` exponentially decaying
    streaks at equal angles, normalized to unit mass; odd blade counts
    spread over 2 * blades rays (odd apertures)."""
    ar = torch.arange(-length_px, length_px + 1, device=device)
    yy, xx = torch.meshgrid(ar, ar, indexing="ij")
    xx = xx.to(dtype)
    yy = yy.to(dtype) * aspect
    r = torch.sqrt(xx ** 2 + yy ** 2)
    theta = torch.atan2(yy, xx)
    rot = torch.deg2rad(torch.as_tensor(rotation_deg, dtype=dtype, device=device))
    n_rays = blades if blades % 2 == 0 else 2 * blades
    k = torch.zeros_like(r)
    for i in range(n_rays):
        ang = rot + 2.0 * math.pi * i / n_rays
        # angular falloff around the ray, radial exponential decay
        d_ang = torch.atan2(torch.sin(theta - ang), torch.cos(theta - ang))
        k = k + torch.exp(-(d_ang ** 2) / 0.002) * torch.exp(-3.0 * r / length_px)
    k[length_px, length_px] = k.max()
    return k / torch.sum(k)


def lens_flare(image: Tensor, scale, blades: int, rotation_deg, length_px: int,
               aspect: float = 1.5, threshold: float = 0.85) -> Tensor:
    """Bright-pass + starburst convolution, added scaled by ``scale``."""
    lum = torch.mean(image, dim=-1)
    bright = torch.where(lum > threshold, lum - threshold, 0.0)
    kern = starburst_kernel(blades, rotation_deg, length_px, aspect, image.dtype, image.device)
    glow = F.conv2d(bright[None, None], kern[None, None], padding=length_px)[0, 0]
    return image + scale * glow[..., None]


def motion_blur(image: Tensor, velocity_px, exposure_fraction, max_diameter_fraction,
                num_samples: int = 8) -> Tensor:
    """Average ``num_samples`` taps along the (global) image-space velocity,
    the per-frame image translation in pixels: the camera-motion blur of
    the RTX post pass."""
    h, w, _ = image.shape
    as_t = lambda v: torch.as_tensor(v, dtype=image.dtype, device=image.device)  # noqa: E731
    diag = torch.sqrt(as_t(h * h + w * w))
    v = as_t(velocity_px) * as_t(exposure_fraction)
    norm = torch.linalg.norm(v) + 1e-8
    v = v * torch.clamp(as_t(max_diameter_fraction) * diag / norm, max=1.0)
    if num_samples < 2:
        return image  # a single tap is the identity (and 0/0 otherwise)
    yy, xx = _pixel_grid(h, w, image)
    taps = []
    for i in range(num_samples):
        t = (as_t(i) / (num_samples - 1)) - 0.5
        xs, ys = xx + t * v[0], yy + t * v[1]
        taps.append(torch.stack([_resample_bilinear(image[..., c], xs, ys)
                                 for c in range(3)], dim=-1))
    return torch.mean(torch.stack(taps), dim=0)


def apply_post_fx(image: Tensor, settings: RenderSettings | None = None,
                  velocity_px=(0.0, 0.0)) -> Tensor:
    """Run the enabled effects in the RTX order: chromatic aberration ->
    lens flare -> motion blur. ``image`` is (H, W, 3) in [0, 1]."""
    s = settings or get_settings()
    if s.get("/rtx/post/chromaticAberration/enabled"):
        strength = [s.get(f"/rtx/post/chromaticAberration/strength{c}") for c in "RGB"]
        models = tuple(s.get(f"/rtx/post/chromaticAberration/model{c}") for c in "RGB")
        image = chromatic_aberration(image, strength, models)
    if s.get("/rtx/post/lensFlares/enabled"):
        # streak length from the optics: focal length over fstop, scaled by
        # the sensor diagonal
        f = s.get("/rtx/post/lensFlares/focalLength")
        n = s.get("/rtx/post/lensFlares/fNumber")
        diag = s.get("/rtx/post/lensFlares/sensorDiagonal")
        length_px = max(4, int(round((f / max(n, 0.1)) * diag / 4.0)))
        image = lens_flare(
            image, torch.as_tensor(s.get("/rtx/post/lensFlares/flareScale"),
                                   dtype=image.dtype, device=image.device),
            int(s.get("/rtx/post/lensFlares/blades")),
            s.get("/rtx/post/lensFlares/apertureRotation"), length_px,
            float(s.get("/rtx/post/lensFlares/sensorAspectRatio")))
    if s.get("/rtx/post/motionblur/enabled"):
        image = motion_blur(image, velocity_px, s.get("/rtx/post/motionblur/exposureFraction"),
                            s.get("/rtx/post/motionblur/maxBlurDiameterFraction"),
                            int(s.get("/rtx/post/motionblur/numSamples")))
    return torch.clamp(image, 0.0, 1.0)
