"""Physics add-ons: the wheel-track terrain deformation engine, the wheel
terramechanics solver and the scene configuration (counterpart of the JAX
``physics`` package)."""

import dataclasses

from .deformation import (
    BoundaryDistributionConf,
    DeformationEngine,
    DeformationEngineConf,
    DeformConstrainConf,
    DepthDistributionConf,
    FootprintConf,
    ForceDepthRegressionConf,
)
from .terramechanics import (
    RobotParameter,
    TerrainMechanicalParameter,
    TerramechanicsSolver,
)


@dataclasses.dataclass
class PhysicsSceneConf:
    """Scene-level physics settings (src/physics/physics_scene.py:14-23 +
    cfg/physics/*.yaml)."""

    dt: float = 1.0 / 60.0
    gravity: tuple = (0.0, 0.0, -1.62)  # lunar gravity
    enable_ccd: bool = False
    enable_stabilization: bool = True


__all__ = [
    "BoundaryDistributionConf",
    "DeformationEngine",
    "DeformationEngineConf",
    "DeformConstrainConf",
    "DepthDistributionConf",
    "FootprintConf",
    "ForceDepthRegressionConf",
    "RobotParameter",
    "TerrainMechanicalParameter",
    "TerramechanicsSolver",
    "PhysicsSceneConf",
]
