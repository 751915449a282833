"""Sample and rover sharding over ``torch.distributed`` ranks (counterpart
of the JAX ``parallel``)."""

from .mesh import (
    make_mesh,
    replicate,
    shard_rovers,
    shard_sample_noise,
    shard_samples,
    sharded_mppi_step,
)
from .scaling import (
    initialize_distributed,
    rover_sample_mesh,
    scaling_sweep,
    sharded_multi_rover_step,
    write_scaling_report,
)

__all__ = [
    "make_mesh",
    "replicate",
    "shard_rovers",
    "shard_sample_noise",
    "shard_samples",
    "sharded_mppi_step",
    "initialize_distributed",
    "rover_sample_mesh",
    "scaling_sweep",
    "sharded_multi_rover_step",
    "write_scaling_report",
]
