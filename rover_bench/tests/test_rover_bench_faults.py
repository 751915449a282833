"""A run whose timed path is broken underneath comes out not correct: the
harness at each cell's tiny size on the CPU (past its look for a card),
with one of the faults a cell can have planted in the port. The cells run
on one card, so no exchange between cards can be left out."""

from unittest import mock

import pytest
import torch

from rover_bench.harness import registry
from rover_bench.tests.tiny import run_tiny

import husky_rover_mppi_isaacsim_torch.env.rover_sim as prs
import husky_rover_mppi_isaacsim_torch.mppi.controller as pc
import husky_rover_mppi_isaacsim_torch.mppi.critics as pcrit

CELLS = [w["name"] for w in registry.benchmark()["workloads"]]


def _unchanged(workload):
    """The step returns the state it was given (the goal-seek's loop count
    still advances, so that an episode ends)."""
    if workload.endswith("goal_seek"):
        drv = registry.load_module("drivers", "goal_seek")

        def fake(config, max_loops, hf, cm, goal, robot, ctrl, loop, halt, pos, vel, key, n):
            return robot, ctrl, loop + n, halt, pos, vel, key
        return mock.patch.object(drv, "masked_steps", fake)
    drv = registry.load_module("drivers", "fleet")
    return mock.patch.object(drv, "closed_loop_step",
                             lambda config, hf, cm, goals, state, key, path=(): state)


def _half_batch(workload):
    """The weights of the second half of each batch of samples dropped: the
    weighted mean taken over the rest."""
    plain = pcrit.softmax_weights

    def fake(costs, temperature, min_cost=None):
        half = costs.shape[-1] // 2
        w = plain(costs[..., :half], temperature)
        return torch.cat([w, torch.zeros_like(costs[..., half:])], dim=-1)
    return mock.patch.object(pcrit, "softmax_weights", fake)


def _altered(workload):
    """A rover's position altered by a centimetre where it is produced."""
    if workload.endswith("goal_seek"):
        plain = pc.kinematic_advance

        def fake(config, robot, out):
            r = plain(config, robot, out)
            return r._replace(position=r.position + 0.01)
        return mock.patch.object(pc, "kinematic_advance", fake)
    plain = prs.step

    def step(*a, **k):
        s = plain(*a, **k)
        return s._replace(position=s.position + 0.01)
    return mock.patch.object(prs, "step", step)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _altered],
                         ids=["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("workload", CELLS)
def test_a_broken_timed_path_is_not_correct(workload, fault):
    with fault(workload):
        out = run_tiny(workload, seconds=0.4)
    assert out["result"]["correct"] is False, out["result"]["checked"]
