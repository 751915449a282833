"""A fleet of rovers in lockstep through the port's
``env.closed_loop.closed_loop_step``, one graphed step for all of them:
MPPI for every rover, the latch and PI trim, the skid-steer physics with
wheel slip. Each step ends with the fleet's poses on the host, as a sim
that publishes every tick does; a rover whose pose is inside its goal's
box gets its next goal written into the goals on the card before the
next step (no re-capture).

Each rover follows its own route of the thesis protocol's pairs, drawn
from the seed: it starts at its first pair's start and heads for that
pair's goal, then for the next pair's start, the next pair's goal, and so
on, every leg across the map. Step ``i`` runs on ``fold_in(key(seed), i)``
(the index a device scalar the graph reads).

The check: the world against the reference's float64 one, and a seeded
sample of the window's steps, each run again by the float64 reference on
its own world from the step's input state and compared, rover by rover,
with what the step produced.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from rover_bench.drivers.goal_seek import (
    build_world,
    jax_normal_shares,
    reference_views,
    reference_world,
    world_checks,
)
from rover_bench.harness import port
from rover_bench.reference import jax_random as rjr
from rover_bench.reference import loops as ref

from husky_rover_mppi_isaacsim_torch.core import jax_random as jr
from husky_rover_mppi_isaacsim_torch.core.graphs import Graphed
from husky_rover_mppi_isaacsim_torch.env.closed_loop import (
    ClosedLoopConfig,
    closed_loop_step,
    init_loop_state,
)
from husky_rover_mppi_isaacsim_torch.env.rover_sim import RoverParams, RoverState


def routes(ctx, n: int, legs: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Each rover's start, heading and ``legs`` goals, ``(n, 2)``, ``(n,
    3)``, ``(n, legs, 2)``, from the seed."""
    p = ctx.traffic["pairs"]
    rng = np.random.default_rng(ctx.seed)
    starts, heads, goals = [], [], []
    for _ in range(n):
        pairs = port.thesis_pairs(legs, ctx.config["world"]["half_width"],
                                  int(rng.integers(0, 2 ** 62)), p["lo"], p["hi"], p["cross"])
        starts.append(pairs[0][0])
        heads.append(pairs[0][2])
        goals.append([pr[1] if i % 2 == 0 else pr[0] for i, pr in enumerate(pairs)])
    return (np.asarray(starts, np.float64), np.asarray(heads, np.float64),
            np.asarray(goals, np.float64))


def physics(ctx) -> dict:
    return dict(ctx.traffic["physics"])


class Session:
    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        dev = ctx.device
        self.n = int(t["rovers"])
        self.config = port.mppi_config(ctx.config["mppi"])
        self.cl = ClosedLoopConfig(mppi=self.config, rover=RoverParams(**physics(ctx)))
        self.hf, self.cm = build_world(ctx)
        self.tol = float(t["goal_tolerance"])
        starts, heads, self.goal_route = routes(ctx, self.n, int(t["legs"]))
        self.leg = np.zeros(self.n, dtype=np.int64)
        self.goals = torch.tensor(self.goal_route[:, 0], dtype=torch.float32, device=dev)
        rovers = RoverState.create(torch.tensor(starts, dtype=torch.float32, device=dev),
                                   torch.tensor(heads, dtype=torch.float32, device=dev), self.hf)
        self.state0 = init_loop_state(self.cl, rovers)
        self.key = jr.key(ctx.seed, dev)
        self.steps = 0
        graph = Graphed(closed_loop_step, in_place_args=(1, 2))
        # (goals, state, key, step index) in; the state out
        self.rec = port.Recorder(graph, int(t["check"]["steps"]), ctx.seed ^ 0x5EED,
                                 lambda a: (a[3], a[4], a[5], a[6][0][1]), lambda o: o,
                                 self._tick)
        # warm-up (eager) and capture at the window's signature
        state = self.state0
        for i in range(2):
            state = self.rec(self.cl, self.hf, self.cm, self.goals, state, self.key,
                             (("fold_in", self._index(i)),))
        self.state0 = state

    def _index(self, i: int) -> torch.Tensor:
        return torch.full((), i, dtype=torch.int64, device=self.ctx.device)

    def _tick(self):
        if self.rec.on:
            self.steps += 1
            self.ctx.tick({"steps": self.steps})

    def window(self) -> dict:
        ctx = self.ctx
        step_s, arrivals = [], 0
        state = self.state0
        legs = self.goal_route.shape[1]
        self.rec.on = True
        ctx.open_window()
        t0 = time.perf_counter()
        i = 2
        while time.perf_counter() - t0 < ctx.seconds:
            t_d = time.perf_counter()
            state = self.rec(self.cl, self.hf, self.cm, self.goals, state, self.key,
                             (("fold_in", self._index(i)),))
            poses = torch.cat([state.rovers.position, state.rovers.z[:, None]], 1).cpu().numpy()
            step_s.append(time.perf_counter() - t_d)
            i += 1
            goal = self.goal_route[np.arange(self.n), self.leg % legs]
            there = np.all(np.abs(poses[:, :2] - goal) <= self.tol, axis=1)
            if there.any():
                arrivals += int(there.sum())
                self.leg[there] += 1
                rows = np.flatnonzero(there)
                nxt = self.goal_route[rows, self.leg[rows] % legs]
                self.goals.index_copy_(0, torch.as_tensor(rows, device=ctx.device),
                                       torch.as_tensor(nxt, dtype=torch.float32,
                                                       device=ctx.device))
        window_s = time.perf_counter() - t0
        ctx.close_window({"steps": self.steps})
        self.rec.on = False
        finite = bool(np.isfinite(poses).all())
        self._record = {"loops": self.n * len(step_s), "steps": len(step_s),
                        "step_s": step_s, "window_s": window_s, "arrivals": arrivals,
                        "attempted": len(step_s), "failed": 0 if finite else 1,
                        "rovers": self.n,
                        "draws_per_step": [2 * self.n * self.config.num_samples
                                           * self.config.horizon, self.n, self.n]}
        return self._record

    def free(self):
        self.rec.fn = None

    def _reference(self, z, cost, snap, control: bool):
        """The step from a kept step's input state: float64, or for the
        control float32 with TF32."""
        dtype = torch.float32 if control else torch.float64
        hf, cm = reference_views(self.ctx, z, cost, dtype)
        goals, st, key, idx = port.cast(snap, dtype)
        state = ref.Loop(ref.Rovers(*st.rovers), ref.Ctrl(*st.ctrl), *st[2:])
        with port.tf32(control):
            return ref.closed_loop_step(port.ref_mppi(self.ctx.config["mppi"]),
                                        ref.Physics.from_config(physics(self.ctx)),
                                        ref.LoopConsts(), hf, cm, goals, state, key,
                                        (("fold_in", idx),))

    def check(self) -> list:
        """The world, then every rover of every kept step against the
        reference: a rover-step is off where its pose (m) or its optimal
        inputs lie farther from the reference's than the configuration's
        tolerance. A sound step can hand a rover's win to another sample
        where two costs lie within rounding, so the share of rover-steps
        off is held to the few such flips sound runs show."""
        ctx, lim, tol = self.ctx, self.ctx.config["limits"], self.ctx.config["tolerances"]
        z, cost = reference_world(ctx)
        checks = world_checks(ctx, self.hf, self.cm, z, cost)
        if not self.rec.kept:
            return checks + [("steps_unchecked", 1.0, 0.0)]
        poses, controls, mismatch = [], [], 0
        for _, inp, out in self.rec.kept:
            r = self._reference(z, cost, inp, False)
            if ctx.control:  # the reference at the next lower precision in the program's place
                out = port.held_in_bf16(self._reference(z, cost, inp, True))
            dz = (out.rovers.z.double() - r.rovers.z).abs()
            dp = (out.rovers.position.double() - r.rovers.position).abs().amax(-1)
            du = torch.maximum((out.ctrl.optimal_u1.double() - r.ctrl.optimal_u1).abs().amax(-1),
                               (out.ctrl.optimal_u2.double() - r.ctrl.optimal_u2).abs().amax(-1))
            poses.append(torch.maximum(dp, dz))
            controls.append(du)
            mismatch += 0 if torch.equal(out.step_index, r.step_index) else 1
        pose, control = torch.cat(poses), torch.cat(controls)
        self._record["check_gaps"] = {"rover_m": pose.tolist(), "control": control.tolist()}
        first = self.rec.kept[0][1]
        self._record["jax_normal_shares"] = jax_normal_shares(
            rjr.derive(first[2], (("fold_in", first[3]),) + ref.K_NOISE),
            2 * self.n * self.config.num_samples * self.config.horizon)
        self._record["dem_cells"] = 0  # the fleet's rollouts: cells not counted
        return checks + [
            ("rover_steps_off_share.pose", port.off_share(pose, tol["pose_m"]),
             lim["rover_steps_off_share.pose"]),
            ("rover_steps_off_share.control", port.off_share(control, tol["control"]),
             lim["rover_steps_off_share.control"]),
            ("state_mismatches", float(mismatch), 0.0),
            ("steps_unchecked", 0.0, 0.0)]
