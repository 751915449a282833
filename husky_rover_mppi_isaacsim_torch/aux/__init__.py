"""Auxiliary subsystems (counterpart of the JAX ``aux`` package): the
configuration tree, stellar lighting, SDG labeling, profiling, rendering
post-effects, checkpoint / resume."""

from ..utils.timer import ScopedTimer, timed
from . import checkpoint
from .config import (
    ConfigFactory,
    apply_overrides,
    default_factory,
    instantiate_configs,
    load_config,
)
from .labeling import (
    AutonomousLabeling,
    LabelingConf,
    hillshade,
    instance_mask,
    semantic_mask,
    surface_normals,
)
from .render_fx import (
    ChromaticAberrationsConf,
    FlaresConf,
    MotionBlurConf,
    RenderSettings,
    apply_chromatic_aberrations,
    apply_lens_flare,
    apply_motion_blur,
    apply_post_fx,
    chromatic_aberration,
    enable_RTX_interactive,
    enable_RTX_real_time,
    lens_flare,
    motion_blur,
)
from .stellar import Date, StellarEngine, StellarEngineConf

__all__ = [
    "ScopedTimer",
    "timed",
    "ConfigFactory",
    "apply_overrides",
    "default_factory",
    "instantiate_configs",
    "load_config",
    "AutonomousLabeling",
    "LabelingConf",
    "hillshade",
    "instance_mask",
    "semantic_mask",
    "surface_normals",
    "Date",
    "StellarEngine",
    "StellarEngineConf",
    "checkpoint",
    "ChromaticAberrationsConf",
    "FlaresConf",
    "MotionBlurConf",
    "RenderSettings",
    "apply_chromatic_aberrations",
    "apply_lens_flare",
    "apply_motion_blur",
    "apply_post_fx",
    "chromatic_aberration",
    "enable_RTX_interactive",
    "enable_RTX_real_time",
    "lens_flare",
    "motion_blur",
]
