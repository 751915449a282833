"""Physics add-ons: the wheel-track terrain deformation engine (counterpart
of the JAX ``physics`` package; its terramechanics solver and scene config
are not ported yet)."""

from .deformation import (
    BoundaryDistributionConf,
    DeformationEngine,
    DeformationEngineConf,
    DeformConstrainConf,
    DepthDistributionConf,
    FootprintConf,
    ForceDepthRegressionConf,
)

__all__ = [
    "BoundaryDistributionConf",
    "DeformationEngine",
    "DeformationEngineConf",
    "DeformConstrainConf",
    "DepthDistributionConf",
    "FootprintConf",
    "ForceDepthRegressionConf",
]
