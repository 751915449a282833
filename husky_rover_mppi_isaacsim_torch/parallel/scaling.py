"""Rover and sample sharding over ``torch.distributed``, and the scaling sweep.

Counterpart of ``husky_rover_mppi_isaacsim_tpu/parallel/scaling.py``. The
mesh axes:

* ``rover``  — data parallel: each rank owns a block of rovers (no
  collective on this axis);
* ``sample`` — the MPPI sample batch; the weighted update is an all-reduce
  over the ranks of the axis (see :mod:`.mesh`).

Ranks are processes. :func:`initialize_distributed` joins them
(``init_process_group`` with an explicit address, world size and rank:
nothing on the machine announces a cluster). Several ranks may share one
card over gloo, which stages CUDA tensors through the host; NCCL refuses two
ranks on one device.
"""

from __future__ import annotations

import datetime
import json
import multiprocessing
import time
from pathlib import Path
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..core import jax_random as jr
from ..core.device import run_device
from ..core.heightfield import HeightField
from ..mppi.controller import ControllerState, MPPIConfig, RobotState, StepOutput
from ..mppi.critics import Costmap
from ..mppi.sampling import sample_noise_block
from .mesh import _local_step, make_mesh


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None, process_id: int | None = None,
                           backend: str = "gloo", timeout_s: float = 300.0) -> None:
    """Join the default process group: ``init_process_group(backend,
    init_method=coordinator_address, world_size=num_processes,
    rank=process_id)`` (``tcp://host:port`` or ``file:///path``). A no-op
    for one process."""
    if num_processes is None or num_processes <= 1:
        return
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id,
                            timeout=datetime.timedelta(seconds=timeout_s))


def rover_sample_mesh(num_rover_shards: int, num_sample_shards: int, device=None) -> DeviceMesh:
    """2-D ``("rover", "sample")`` mesh over the ranks."""
    return make_mesh((num_rover_shards, num_sample_shards), ("rover", "sample"), device)


def sharded_multi_rover_step(config: MPPIConfig, mesh: DeviceMesh, hf: HeightField,
                             costmap: Costmap, goals, robots: RobotState,
                             ctrls: ControllerState, noise
                             ) -> tuple[ControllerState, StepOutput]:
    """N rovers x K samples, rovers sharded over ``rover`` and samples over
    ``sample``: each rank passes its block, ``goals``, ``robots`` and
    ``ctrls`` with its N/r rovers (:func:`.mesh.shard_rovers`) and ``noise``
    (N/r, 2, K/s, H) (:func:`.mesh.shard_samples` of that), and gets its
    rovers' controller states and outputs back, costs and weights as
    (N/r, K/s). The rover axis goes through ``mppi_step``'s own rover axis
    (one K1 launch for all of the rank's rovers); the reductions run per
    rover over the ``sample`` sub-group."""
    return _local_step(config, hf, costmap, goals, robots, ctrls, noise,
                       mesh.get_group("sample"))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def scaling_sweep(config: MPPIConfig, hf: HeightField, costmap: Costmap,
                  shard_counts: Sequence[int], iters: int = 20, dtype=torch.float32,
                  device=None) -> dict:
    """Sample-axis strong-scaling sweep: the same global K on 1..n shards,
    each count n on the sub-group of the first n ranks (the others wait);
    counts above the world size are skipped. ``efficiency = t_1 / t_n``.
    Every rank calls it and gets rank 0's times: ``{n: {"step_ms",
    "efficiency"}}``. Ranks that share one card make no scaling claim."""
    device = run_device(device)
    hf = HeightField(*(t.to(device) for t in hf))
    costmap = Costmap(*(t.to(device) for t in costmap))
    rank, world = dist.get_rank(), dist.get_world_size()
    goal = torch.tensor([10.0, 8.0], dtype=dtype, device=device)
    robot = RobotState.create(-9.0, -7.0, [1.0, 0.3, 0.0], dtype=dtype, device=device)
    ctrl = ControllerState.create(config, dtype, device)
    key = jr.key(0, device)  # JAX scaling.py:123
    results, base_time = {}, None
    for n in shard_counts:
        if n > world:
            continue
        group = dist.new_group(list(range(n)))  # every rank takes part in the call
        dt = None
        if rank < n:
            k = config.num_samples // n
            local = sample_noise_block(key, config.num_samples, config.horizon, rank * k,
                                       (rank + 1) * k, dtype)
            step = lambda: _local_step(config, hf, costmap, goal, robot, ctrl,  # noqa: E731
                                       local, group)
            step()
            _sync(device)
            dist.barrier(group=group)
            t0 = time.perf_counter()
            for _ in range(iters):
                step()
            _sync(device)
            dt = (time.perf_counter() - t0) / iters
        shared = [dt]
        dist.broadcast_object_list(shared, src=0)
        dt = shared[0]
        base_time = base_time or dt
        results[n] = {"step_ms": dt * 1e3, "efficiency": base_time / dt}
        dist.barrier()
    return results


def write_scaling_report(path, results: dict, config: MPPIConfig, note: str = "",
                         device=None) -> dict:
    """Persist a scaling sweep as a JSON report, with the JAX package's
    merge-and-ratchet semantics: keys this writer does not own are kept;
    the result rows are replaced only as a whole (with the config, devices
    and note they were measured under), and only when the stored sweep is
    not comparable (another config or backend) or the new sweep's worst
    multi-shard efficiency beats the stored one; otherwise the new worst
    efficiency is kept as ``last_run_worst_efficiency``. Every run is
    appended to ``<path>.runs.jsonl``.

    The ``devices`` block names the card (``torch.cuda.get_device_name``) or
    the CPU the sweep ran on (``device``: the card unless named), the
    process group's backend and world size, and carries a ``shared_device``
    note when more ranks than cards took part: their efficiencies are no
    scaling claim."""
    device = run_device(device)
    path = Path(path)
    existing = {}
    if path.exists():
        try:
            existing = json.loads(path.read_text())
        except (json.JSONDecodeError, OSError):
            existing = {}

    def worst_eff(rows):
        multi = [r["efficiency"] for k, r in rows.items() if k != "1"]
        return min(multi) if multi else 0.0

    world = dist.get_world_size() if dist.is_initialized() else 1
    devices = {
        "backend": dist.get_backend() if dist.is_initialized() else "none",
        "world_size": world,
        "device_kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "device_count": torch.cuda.device_count() if device.type == "cuda" else 1,
        "host_physical_cores": multiprocessing.cpu_count(),
    }
    if world > devices["device_count"]:
        devices["shared_device"] = (f"{world} ranks share {devices['device_count']} "
                                    f"{devices['device_kind']}: no scaling claim")
    new_rows = {str(k): v for k, v in results.items()}
    new_block = {
        "metric": "mppi_strong_scaling",
        "config": {"num_samples": config.num_samples, "horizon": config.horizon},
        "devices": devices,
        "results": new_rows,
        "note": note,
    }
    old_rows = existing.get("results", {})
    comparable = (old_rows and existing.get("config") == new_block["config"]
                  and existing.get("devices", {}).get("backend") == devices["backend"])
    report = dict(existing)
    if comparable and worst_eff(new_rows) <= worst_eff(old_rows):
        report["last_run_worst_efficiency"] = round(worst_eff(new_rows), 4)
    else:
        report.update(new_block)
        report.pop("last_run_worst_efficiency", None)
    path.write_text(json.dumps(report, indent=1))
    with open(str(path) + ".runs.jsonl", "a") as f:
        f.write(json.dumps({"results": new_rows}) + "\n")
    return report
