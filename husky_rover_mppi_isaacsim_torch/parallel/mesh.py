"""Sample sharding of the MPPI step over ``torch.distributed`` ranks.

Counterpart of ``husky_rover_mppi_isaacsim_tpu/parallel/mesh.py``. The JAX
package shards the sample batch over a device mesh with ``shard_map``; here
the model is SPMD over processes: every rank runs the same program, holds
the replicated world and controller state and its own K/n slice of the
(2, K, H) noise (drawn alone from the JAX key, :func:`shard_sample_noise`),
runs the local rollouts (one K1 launch on the card) and
critics, and the ranks of the mesh axis meet in the reductions JAX's
``_local_step`` makes, in the same order:

1. one all-reduce MIN of the per-rover cost minimum;
2. one SUM of the total weight ``sum_k w_k``;
3. one SUM each of the two weighted input sums ``sum_k w_k u_k``.

Costs and weights come back as the rank's shard (JAX's ``out_specs
P(axis)``); the controller state and the optimal rollout come back
replicated. The step is :func:`..mppi.controller.mppi_step` itself, with
the all-reduces as its ``reduce`` hook, so one rank's step equals
``mppi_step`` bit for bit. The collectives are all-reduce and broadcast
only: gloo has no ``all_gather`` for CUDA tensors.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist
from torch import Tensor
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..core.device import run_device
from ..core.heightfield import HeightField
from ..mppi.controller import ControllerState, MPPIConfig, RobotState, StepOutput, mppi_step
from ..mppi.critics import Costmap
from ..mppi.sampling import sample_noise_block


def make_mesh(axis_sizes: Sequence[int], axis_names: Sequence[str], device=None) -> DeviceMesh:
    """A mesh over the ranks of the initialized default process group
    (e.g. ``((rovers, samples), ("rover", "sample"))``), for tensors on
    ``device`` (the card unless named)."""
    return init_device_mesh(run_device(device).type, tuple(axis_sizes),
                            mesh_dim_names=tuple(axis_names))


def _tree_map(fn, tree):
    """``fn`` on every tensor of a tree of NamedTuples, tuples and lists."""
    if tree is None:
        return None
    if isinstance(tree, Tensor):
        return fn(tree)
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, t) for t in tree)
    raise TypeError(f"no tensor tree: {type(tree).__name__}")


def replicate(mesh: DeviceMesh, tree):
    """Every tensor of ``tree`` as the mesh's first rank holds it, on every
    rank (a broadcast over the default group; the input is not written)."""
    src = int(mesh.mesh.flatten()[0])

    def bcast(t: Tensor) -> Tensor:
        out = t.clone()
        dist.broadcast(out, src=src)
        return out

    return _tree_map(bcast, tree)


def _axis_block(mesh: DeviceMesh, axis: str, size: int) -> slice:
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    if size % n:
        raise ValueError(f"{size} rows do not split over the {n} ranks of mesh axis {axis!r}")
    r = mesh.get_local_rank(axis)
    return slice(r * (size // n), (r + 1) * (size // n))


def shard_samples(mesh: DeviceMesh, noise: Tensor, axis: str = "sample") -> Tensor:
    """This rank's block of the noise along its K axis (dim -2): of
    (2, K, H) or (N, 2, K, H), the K/n samples of its coordinate on
    ``axis``."""
    return noise[..., _axis_block(mesh, axis, noise.shape[-2]), :].contiguous()


def shard_sample_noise(mesh: DeviceMesh, key: Tensor, num_samples: int, horizon: int,
                       dtype=None, axis: str = "sample") -> Tensor:
    """This rank's block of JAX's ``normal(key, (2, K, H))`` along K, drawn
    alone (:func:`..mppi.sampling.sample_noise_block`): equal to
    ``shard_samples(mesh, sample_noise(key, K, H))``."""
    block = _axis_block(mesh, axis, num_samples)
    return sample_noise_block(key, num_samples, horizon, block.start, block.stop,
                              dtype if dtype is not None else torch.float32)


def shard_rovers(mesh: DeviceMesh, tree, axis: str = "rover"):
    """This rank's block of the leading (rover) axis of every tensor in
    ``tree``: N/n rovers for its coordinate on ``axis``."""
    return _tree_map(lambda t: t[_axis_block(mesh, axis, t.shape[0])].contiguous(), tree)


_OPS = {"min": dist.ReduceOp.MIN, "sum": dist.ReduceOp.SUM}


def _local_step(config: MPPIConfig, hf: HeightField, costmap: Costmap, goal: Tensor,
                robot: RobotState, ctrl: ControllerState, noise: Tensor,
                group) -> tuple[ControllerState, StepOutput]:
    """Per-rank MPPI body: local rollouts and critics on the rank's sample
    block ``noise`` (``...``, 2, K/n, H), the global two-pass softmax and
    weighted sums by all-reduce over ``group``. Every state field may lead
    with a rover axis (the port's ``mppi_step`` rover axis); the reductions
    are then per rover."""
    def all_reduce(t: Tensor, op: str) -> None:
        dist.all_reduce(t, op=_OPS[op], group=group)

    return mppi_step(config, hf, costmap, goal, robot, ctrl, noise, reduce=all_reduce)


def sharded_mppi_step(config: MPPIConfig, mesh: DeviceMesh, hf: HeightField,
                      costmap: Costmap, goal: Tensor, robot: RobotState,
                      ctrl: ControllerState, noise: Tensor, axis: str = "sample"
                      ) -> tuple[ControllerState, StepOutput]:
    """MPPI step with the sample batch sharded over ``axis``: ``noise`` is
    this rank's block (:func:`shard_samples`), everything else replicated.
    The math of :func:`..mppi.controller.mppi_step`; only the summation
    order of the weighted sums differs across shard boundaries."""
    return _local_step(config, hf, costmap, goal, robot, ctrl, noise, mesh.get_group(axis))
