"""WorldBuilders: typed procedural scene-randomization library.

Counterpart of ``husky_rover_mppi_isaacsim_tpu/worldbuilders`` (the
re-design of the reference's ``WorldBuilders/`` package: Types, Samplers,
Layers, Clippers, Mixer), with its public names. Typed requests describing
*what* to randomize (positions / scales / orientations over geometric
layers with stochastic samplers) execute into float64 tensors on a device.
Random draws are ``np.random.default_rng(seed)`` draws made in the JAX
package's order, so counts and coordinates equal its; everything computed
from them runs in torch on the device each factory and the mixer take
(``device=``, default: the card). The fixed-capacity point processes for
in-loop randomization live in ``terrain.point_process``.
"""

from . import clippers, layers, mixer, samplers, types
from .clippers import Clipper_Factory, HeightClipper, NormalMapClipper
from .layers import Layer_Factory
from .mixer import MetaLayer, RequestMixer
from .samplers import Sampler_Factory
from .types import (
    Circle_T,
    Clipper_T,
    Cone_T,
    Cube_T,
    Cylinder_T,
    DeterministicSampler_T,
    Disk_T,
    Euler_T,
    HardCoreMaternClusterPointSampler_T,
    HardCoreThomasClusterSampler_T,
    HardCoreUniformSampler_T,
    Image_T,
    ImageClipper_T,
    Layer_T,
    Line_T,
    LinearInterpolationSampler_T,
    MaternClusterPointSampler_T,
    NormalMap_T,
    NormalMapClipper_T,
    NormalSampler_T,
    OrientationParam_T,
    Plane_T,
    PoissonPointSampler_T,
    Polygon_T,
    Position_T,
    Quaternion_T,
    RollPitchYaw_T,
    Rot2D_T,
    Sampler_T,
    Scale_T,
    Sphere_T,
    ThomasClusterSampler_T,
    Torus_T,
    Transformation2D_T,
    Transformation3D_T,
    Translation2D_T,
    Translation3D_T,
    UniformSampler_T,
    UserRequest_T,
)

__all__ = [
    "clippers", "layers", "mixer", "samplers", "types",
    "Clipper_Factory", "HeightClipper", "NormalMapClipper", "Layer_Factory",
    "MetaLayer", "RequestMixer", "Sampler_Factory",
    "Circle_T", "Clipper_T", "Cone_T", "Cube_T", "Cylinder_T",
    "DeterministicSampler_T", "Disk_T", "Euler_T",
    "HardCoreMaternClusterPointSampler_T", "HardCoreThomasClusterSampler_T",
    "HardCoreUniformSampler_T", "Image_T", "ImageClipper_T", "Layer_T",
    "Line_T", "LinearInterpolationSampler_T", "MaternClusterPointSampler_T",
    "NormalMap_T", "NormalMapClipper_T", "NormalSampler_T",
    "OrientationParam_T", "Plane_T", "PoissonPointSampler_T", "Polygon_T",
    "Position_T", "Quaternion_T", "RollPitchYaw_T", "Rot2D_T", "Sampler_T",
    "Scale_T", "Sphere_T", "ThomasClusterSampler_T", "Torus_T",
    "Transformation2D_T", "Transformation3D_T", "Translation2D_T",
    "Translation3D_T", "UniformSampler_T", "UserRequest_T",
]
