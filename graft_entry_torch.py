"""Entry points of the PyTorch port, the counterpart of ``__graft_entry__.py``:
one control step on the flagship configuration, and a dry run of the sharded
multi-rover step on ranks.

    python3 graft_entry_torch.py

runs :func:`entry`'s step on the card (K1 for its rollouts) and prints
``entry OK``. :func:`dryrun_multichip` runs ``sharded_multi_rover_step`` on
a (rover, sample) mesh of ``n`` ranks, each its own process
(``shard_ranks.run_ranks``, gloo: on the CPU, or every rank on one card,
where NCCL refuses two ranks), and holds every rover against the unsharded
``mppi_step`` on the same inputs. The exploration noise of :func:`entry`
is JAX's draw from ``key(0)`` (``__graft_entry__.py:37``), the dry run's
from numpy as in ``__graft_entry__.py``. Both run on the card unless ``device`` names
another device.
"""

from __future__ import annotations

import contextlib
import functools
import tempfile
from pathlib import Path

import numpy as np
import torch

from husky_rover_mppi_isaacsim_torch.core import jax_random as jr
from husky_rover_mppi_isaacsim_torch.core.device import run_device
from husky_rover_mppi_isaacsim_torch.core.heightfield import HeightField
from husky_rover_mppi_isaacsim_torch.mppi import (
    ControllerState,
    MPPIConfig,
    RobotState,
    mppi_step,
    sample_noise,
)
from husky_rover_mppi_isaacsim_torch.terrain import as_costmap, crater_surface

BUILD = Path(__file__).resolve().parent / "build"
# __graft_entry__.py's tolerances of each rover's sharded step against the
# unsharded one (float32 sums over the sample shards in another order)
COSTS_RTOL, COSTS_ATOL, U_RTOL, U_ATOL = 2e-5, 1e-4, 2e-5, 1e-5


def _tiny_world(dtype=torch.float32, grid: int = 256, hw: float = 25.0, device=None):
    """A ``grid``^2 crater surface over +-``hw`` m with one bump and a free
    ``(grid / 8)``^2 costmap (``__graft_entry__._tiny_world``)."""
    z = crater_surface(grid, hw, [((-5.0, 8.0), 2.0, 6.0)], dtype=dtype, device=device)
    hf = HeightField.create(z, hw)
    cm = as_costmap(np.zeros((grid // 8, grid // 8), np.float32), hw, dtype=dtype,
                    device=device)
    return hf, cm


def entry(device=None):
    """``(fn, example_args)``: one MPPI control step on the flagship
    configuration (K=1000 x H=100 skid-steer surface rollouts and critics,
    ``exact=False``) on ``device``; ``fn(*example_args)`` returns the new
    controller state and the step's outputs."""
    device = run_device(device)
    dtype = torch.float32
    config = MPPIConfig(num_samples=1000, horizon=100, exact=False)
    hf, cm = _tiny_world(dtype, device=device)
    goal = torch.tensor([10.0, 9.0], dtype=dtype, device=device)
    robot = RobotState.create(-9.0, -7.0, [1.0, 0.3, 0.0], dtype=dtype, device=device)
    ctrl = ControllerState.create(config, dtype, device)
    noise = sample_noise(jr.key(0, device), config.num_samples, config.horizon, dtype)
    return functools.partial(mppi_step, config), (hf, cm, goal, robot, ctrl, noise)


def dryrun_multichip(n_devices: int, device=None, workdir=None) -> dict:
    """Run the sharded multi-rover MPPI step (rover axis data parallel,
    sample axis sharded with all-reduce collectives) on an ``n_devices``
    rank mesh, 2 r rovers and 8 s samples at H=8 on a 64^2 world, and hold
    every rover's costs and optimal input against ``mppi_step`` at
    ``__graft_entry__.py``'s tolerances (raises where they differ). The
    ranks are gloo processes on ``device`` (default the card); ``workdir``
    holds their job and store (default a temporary directory under the
    checkout's ``build/``). Returns each rover's largest differences and
    each rank's K1 launches."""
    from husky_rover_mppi_isaacsim_torch.parallel.mesh import _tree_map
    from shard_ranks import run_ranks

    device = run_device(device)
    dtype = torch.float32
    # a 2-D mesh when n is even: rovers (data parallel) x samples
    rover_shards = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    sample_shards = n_devices // rover_shards
    n_rovers, num_samples = 2 * rover_shards, 8 * sample_shards
    config = MPPIConfig(num_samples=num_samples, horizon=8, exact=False)
    hf, cm = _tiny_world(dtype, grid=64, hw=8.0)

    rng = np.random.default_rng(0)
    goals = torch.as_tensor(rng.uniform(-4, 4, (n_rovers, 2)), dtype=dtype)
    starts = torch.as_tensor(rng.uniform(-4, 4, (n_rovers, 2)), dtype=dtype)
    head = torch.tensor([1.0, 0.3, 0.0], dtype=dtype)
    zeros = torch.zeros(n_rovers, dtype=dtype)
    robots = RobotState(starts, zeros, (head / torch.linalg.norm(head)).repeat(n_rovers, 1),
                        zeros, zeros)
    ctrl0 = ControllerState.create(config, dtype)
    ctrls = ControllerState(*(t.expand((n_rovers,) + t.shape).contiguous() for t in ctrl0))
    noise = torch.as_tensor(rng.normal(size=(n_rovers, 2, num_samples, config.horizon)),
                            dtype=dtype)
    job = dict(hf=hf, costmap=cm, goals=goals, robots=robots, ctrls=ctrls, rover_noise=noise,
               cases=[{"kind": "multi_rover", "config": config,
                       "mesh": (rover_shards, sample_shards)}])
    if workdir is None:
        BUILD.mkdir(exist_ok=True)
    with (tempfile.TemporaryDirectory(dir=BUILD) if workdir is None
          else contextlib.nullcontext(workdir)) as tmp:
        ranks = run_ranks(job, n_devices, tmp, backend="gloo", device=str(device),
                          timeout_s=300.0)

    to = lambda tree: _tree_map(lambda t: t.to(device), tree)  # noqa: E731
    hf_d, cm_d = to(hf), to(cm)
    per_shard = n_rovers // rover_shards
    diffs = []
    for r in range(n_rovers):
        owners = [(r // per_shard) * sample_shards + j for j in range(sample_shards)]
        local = r % per_shard
        outs = [ranks[o][0] for o in owners]
        costs = torch.cat([o["out"].costs[local] for o in outs])
        u1 = outs[0]["ctrl"].optimal_u1[local]
        assert costs.shape == (num_samples,)
        assert all(torch.isfinite(o["out"].optimal_trajectory).all() for o in outs)
        ref_ctrl, ref_out = mppi_step(
            config, hf_d, cm_d, goals[r].to(device),
            RobotState(*(t[r].to(device) for t in robots)),
            ControllerState(*(t[r].to(device) for t in ctrls)), noise[r].to(device))
        want_costs, want_u1 = ref_out.costs.cpu().numpy(), ref_ctrl.optimal_u1.cpu().numpy()
        np.testing.assert_allclose(costs.numpy(), want_costs, rtol=COSTS_RTOL, atol=COSTS_ATOL)
        np.testing.assert_allclose(u1.numpy(), want_u1, rtol=U_RTOL, atol=U_ATOL)
        diffs.append({"costs": float(np.abs(costs.numpy() - want_costs).max()),
                      "optimal_u1": float(np.abs(u1.numpy() - want_u1).max())})
    return {"mesh": [rover_shards, sample_shards], "rovers": n_rovers, "K": num_samples,
            "H": config.horizon, "max_abs_diff": diffs,
            "k1_launches_per_rank": [r[0]["k1_launches"] for r in ranks]}


def main() -> int:
    fn, args = entry()
    _, out = fn(*args)
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out.costs).all()):
        raise RuntimeError("the entry step's costs are not finite")
    print("entry OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
