"""Typed request grammar for procedural scene randomization.

A copy of ``husky_rover_mppi_isaacsim_tpu/worldbuilders/types.py`` (this
package imports nothing of that one), the re-derivation of
``WorldBuilders/Types.py`` (reference :1-607): dataclass configs for
samplers, geometric layers, clippers, and USD-attribute parameter types,
composed into :class:`UserRequest_T` bundles consumed by the mixer.
Validation keeps the reference's assert-in-__post_init__ style.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# --- transformations (Types.py:10-77) ---------------------------------------


@dataclasses.dataclass
class Orientation_T:
    pass


@dataclasses.dataclass
class Rot2D_T(Orientation_T):
    theta: float = 0.0


@dataclasses.dataclass
class Quaternion_T(Orientation_T):
    x: float = 0.0
    y: float = 0.0
    z: float = 0.0
    w: float = 1.0


@dataclasses.dataclass
class Euler_T(Orientation_T):
    x: float = 0.0
    y: float = 0.0
    z: float = 0.0


@dataclasses.dataclass
class Translation2D_T:
    x: float = 0.0
    y: float = 0.0


@dataclasses.dataclass
class Translation3D_T:
    x: float = 0.0
    y: float = 0.0
    z: float = 0.0


@dataclasses.dataclass
class Transformation2D_T:
    translation: Translation2D_T = dataclasses.field(default_factory=Translation2D_T)
    orientation: Rot2D_T = dataclasses.field(default_factory=Rot2D_T)


@dataclasses.dataclass
class Transformation3D_T:
    translation: Translation3D_T = dataclasses.field(default_factory=Translation3D_T)
    orientation: Orientation_T = dataclasses.field(default_factory=Quaternion_T)


# --- layers (Types.py:80-357) ------------------------------------------------


@dataclasses.dataclass
class Layer_T:
    output_space: int = 0
    transform: object = None

    def __post_init__(self):
        assert self.output_space > 0, "output_space must be larger than 0."


@dataclasses.dataclass
class Line_T(Layer_T):
    xmin: float = -0.5
    xmax: float = 0.5
    output_space: int = 1

    def __post_init__(self):
        super().__post_init__()
        assert self.xmin <= self.xmax


@dataclasses.dataclass
class Circle_T(Layer_T):
    center: tuple = (0.0, 0.0)
    radius: float = 0.5
    theta_min: float = 0.0
    theta_max: float = 2 * np.pi
    alpha: float = 1.0
    beta: float = 1.0
    output_space: int = 2

    def __post_init__(self):
        super().__post_init__()
        assert self.alpha > 0 and self.beta > 0 and self.radius >= 0
        assert 0 <= self.theta_min <= self.theta_max <= 2 * np.pi + 1e-9


@dataclasses.dataclass
class Plane_T(Layer_T):
    xmin: float = -0.5
    xmax: float = 0.5
    ymin: float = -0.5
    ymax: float = 0.5
    output_space: int = 2

    def __post_init__(self):
        super().__post_init__()
        assert self.xmin <= self.xmax and self.ymin <= self.ymax


@dataclasses.dataclass
class Disk_T(Layer_T):
    center: tuple = (0.0, 0.0)
    radius_min: float = 0.0
    radius_max: float = 0.5
    theta_min: float = 0.0
    theta_max: float = 2 * np.pi
    alpha: float = 1.0
    beta: float = 1.0
    output_space: int = 2

    def __post_init__(self):
        super().__post_init__()
        assert 0 <= self.radius_min <= self.radius_max
        assert 0 <= self.theta_min <= self.theta_max <= 2 * np.pi + 1e-9


@dataclasses.dataclass
class Polygon_T(Layer_T):
    vertices: tuple = ()
    output_space: int = 2

    def __post_init__(self):
        super().__post_init__()
        assert len(self.vertices) >= 3, "A polygon needs at least 3 vertices."


@dataclasses.dataclass
class Cube_T(Layer_T):
    xmin: float = -0.5
    xmax: float = 0.5
    ymin: float = -0.5
    ymax: float = 0.5
    zmin: float = -0.5
    zmax: float = 0.5
    output_space: int = 3

    def __post_init__(self):
        super().__post_init__()
        assert self.xmin <= self.xmax and self.ymin <= self.ymax and self.zmin <= self.zmax


@dataclasses.dataclass
class Sphere_T(Layer_T):
    center: tuple = (0.0, 0.0, 0.0)
    radius_min: float = 0.0
    radius_max: float = 0.5
    theta_min: float = 0.0
    theta_max: float = 2 * np.pi
    phi_min: float = 0.0
    phi_max: float = np.pi
    output_space: int = 3

    def __post_init__(self):
        super().__post_init__()
        assert 0 <= self.radius_min <= self.radius_max


@dataclasses.dataclass
class Cylinder_T(Layer_T):
    center: tuple = (0.0, 0.0, 0.0)
    radius_min: float = 0.0
    radius_max: float = 0.5
    height_min: float = -0.5
    height_max: float = 0.5
    theta_min: float = 0.0
    theta_max: float = 2 * np.pi
    output_space: int = 3

    def __post_init__(self):
        super().__post_init__()
        assert 0 <= self.radius_min <= self.radius_max
        assert self.height_min <= self.height_max


@dataclasses.dataclass
class Cone_T(Layer_T):
    center: tuple = (0.0, 0.0, 0.0)
    radius_min: float = 0.0
    radius_max: float = 0.5
    height_min: float = 0.0
    height_max: float = 1.0
    theta_min: float = 0.0
    theta_max: float = 2 * np.pi
    output_space: int = 3

    def __post_init__(self):
        super().__post_init__()
        assert 0 <= self.radius_min <= self.radius_max
        assert self.height_min <= self.height_max


@dataclasses.dataclass
class Torus_T(Layer_T):
    center: tuple = (0.0, 0.0, 0.0)
    ring_radius: float = 0.5
    tube_radius_min: float = 0.0
    tube_radius_max: float = 0.1
    theta_min: float = 0.0
    theta_max: float = 2 * np.pi
    phi_min: float = 0.0
    phi_max: float = 2 * np.pi
    output_space: int = 3

    def __post_init__(self):
        super().__post_init__()
        assert 0 <= self.tube_radius_min <= self.tube_radius_max


@dataclasses.dataclass
class Image_T(Layer_T):
    """Image-mask domain (Types.py:330-337): sampling weighted by a mask."""

    data: object = None
    mpp_resolution: float = 1.0
    output_space: int = 2


@dataclasses.dataclass
class NormalMap_T(Layer_T):
    data: object = None
    mpp_resolution: float = 1.0
    output_space: int = 4


@dataclasses.dataclass
class RollPitchYaw_T(Layer_T):
    rmin: float = 0.0
    rmax: float = 0.0
    pmin: float = 0.0
    pmax: float = 0.0
    ymin: float = 0.0
    ymax: float = 2 * np.pi
    output_space: int = 4


# --- samplers (Types.py:365-510) ---------------------------------------------


@dataclasses.dataclass
class Sampler_T:
    randomization_space: int = 0
    use_rejection_sampling: bool = False
    use_image_sampling: bool = False
    seed: int = -1
    max_rejection_sampling_loop: int = 5
    is_point_process = False

    def __post_init__(self):
        assert self.randomization_space > 0


@dataclasses.dataclass
class PointProcess_T(Sampler_T):
    is_point_process = True


@dataclasses.dataclass
class InterativePointProcess_T(PointProcess_T):
    """(sic — the reference's spelling is kept for API parity)"""

    inherit_parents: bool = False


@dataclasses.dataclass
class UniformSampler_T(Sampler_T):
    min: tuple = ()
    max: tuple = ()


@dataclasses.dataclass
class HardCoreUniformSampler_T(PointProcess_T):
    min: tuple = ()
    max: tuple = ()
    core_radius: float = 0.02
    num_repeat: int = 0


@dataclasses.dataclass
class NormalSampler_T(Sampler_T):
    mean: tuple = ()
    std: tuple = ()

    def __post_init__(self):
        super().__post_init__()
        std = np.asarray(self.std, dtype=float)
        if std.size == 1:
            self.std = np.eye(self.randomization_space) * float(std.reshape(-1)[0])
        elif std.ndim == 1 and std.shape[0] == len(self.mean):
            self.std = np.eye(self.randomization_space) * std
        else:
            self.std = std.reshape(self.randomization_space, self.randomization_space)


@dataclasses.dataclass
class MaternClusterPointSampler_T(InterativePointProcess_T):
    lambda_parent: float = 10
    lambda_daughter: float = 100
    cluster_radius: float = 0.1
    warp: tuple = None


@dataclasses.dataclass
class HardCoreMaternClusterPointSampler_T(InterativePointProcess_T):
    lambda_parent: float = 10
    lambda_daughter: float = 100
    cluster_radius: float = 0.1
    core_radius: float = 0.02
    num_repeat: int = 0
    warp: tuple = None


@dataclasses.dataclass
class ThomasClusterSampler_T(InterativePointProcess_T):
    lambda_parent: float = 10
    lambda_daughter: float = 100
    sigma: float = 0.05
    warp: tuple = None


@dataclasses.dataclass
class HardCoreThomasClusterSampler_T(InterativePointProcess_T):
    lambda_parent: float = 10
    lambda_daughter: float = 100
    sigma: float = 0.05
    core_radius: float = 0.02
    num_repeat: int = 0
    warp: tuple = None


@dataclasses.dataclass
class PoissonPointSampler_T(PointProcess_T):
    lambda_poisson: float = 100


@dataclasses.dataclass
class LinearInterpolationSampler_T(Sampler_T):
    min: tuple = ()
    max: tuple = ()


@dataclasses.dataclass
class DeterministicSampler_T(Sampler_T):
    data: object = None


# --- clippers (Types.py:513-547) ---------------------------------------------


@dataclasses.dataclass
class Clipper_T:
    randomization_space: int = 0
    seed: int = -1
    loc_origin: str = "lower"
    is_point_process = False

    def __post_init__(self):
        assert self.randomization_space > 0
        assert self.loc_origin in ("lower", "upper", "center")


@dataclasses.dataclass
class ImageClipper_T(Clipper_T):
    resolution: tuple = (1, 1)
    mpp_resolution: float = 1.0
    data: object = None


@dataclasses.dataclass
class NormalMapClipper_T(Clipper_T):
    resolution: tuple = (1, 1)
    mpp_resolution: float = 1.0
    data: object = None


# --- parameters + request (Types.py:555-607) ---------------------------------


@dataclasses.dataclass
class Parameter_T:
    name: str = "base_parameter"
    components: tuple = ()
    index_mapping: dict = None
    attribute_name: str = ""
    default_value: tuple = ()


@dataclasses.dataclass
class Position_T(Parameter_T):
    name: str = "position"
    components: tuple = ("x", "y", "z")
    attribute_name: str = "xformOp:translation"
    default_value: tuple = (0.0, 0.0, 0.0)

    def __post_init__(self):
        self.index_mapping = {"x": 0, "y": 1, "z": 2}


@dataclasses.dataclass
class Scale_T(Parameter_T):
    name: str = "scale"
    components: tuple = ("x", "y", "z")
    attribute_name: str = "xformOp:scale"
    default_value: tuple = (1.0, 1.0, 1.0)

    def __post_init__(self):
        self.index_mapping = {"x": 0, "y": 1, "z": 2}


@dataclasses.dataclass
class OrientationParam_T(Parameter_T):
    name: str = "orientation"
    components: tuple = ("x", "y", "z", "w")
    attribute_name: str = "xformOp:orientation"
    # (0,0,0,0) like the reference: quaternion axes are randomized together
    default_value: tuple = (0.0, 0.0, 0.0, 0.0)

    def __post_init__(self):
        self.index_mapping = {"x": 0, "y": 1, "z": 2, "w": 3}


@dataclasses.dataclass
class UserRequest_T:
    p_type: Parameter_T = dataclasses.field(default_factory=Parameter_T)
    sampler: object = None
    layer: Layer_T = None
    axes: list = None
