"""Back-to-back single-rover goal-seek episodes through the port's
``mppi.controller.goal_seek``, one graph of ``unroll`` masked steps shared
by every episode, its stop flag read once a replay.

Set-up builds the configuration's world (``cli.build_standalone_world``:
the crater DEM and the exact-EDT costmap, kernel K2) and warms up and
captures the graph. The window runs episodes until ``--seconds`` have
passed and ends with the episode in flight; every episode is a pair of
the thesis protocol's draw from the seed and a key of its own. Counted:
control loops completed (``res.loops``), control steps computed (masked
ones too: the device's work), episodes, those that ran to the loop cap
without reaching their goal (``episodes_capped``: a navigation outcome,
which the JAX package's own protocol runs show too, not an operation the
system failed to carry out; their loops count as all others do), and
those whose end state is not finite (``failed``).

The check: the world against the reference's float64 one, and a seeded
sample of the window's replays, each followed by the float64 reference on
its own world from the replay's input state (the closed loop cannot be
followed for hundreds of loops by another program: float rounding makes
another path), ``unroll`` steps compared with what the replay produced.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from rover_bench.harness import port
from rover_bench.reference import heightfield as rhf
from rover_bench.reference import jax_random as rjr
from rover_bench.reference import loops as ref
from rover_bench.reference import world as rworld

from husky_rover_mppi_isaacsim_torch.cli import build_standalone_world
from husky_rover_mppi_isaacsim_torch.core import jax_random as jr
from husky_rover_mppi_isaacsim_torch.core.graphs import Graphed
from husky_rover_mppi_isaacsim_torch.mppi.controller import (
    ControllerState,
    RobotState,
    goal_reached,
    goal_seek,
    masked_steps,
)


def build_world(ctx):
    """The port's world of the configuration, and the reference's view of it."""
    w = ctx.config["world"]
    hf, cm, _ = build_standalone_world(
        {"half_width": w["half_width"], "grid_size": w["grid_size"],
         "costmap_size": w["costmap_size"]}, torch.float32, ctx.device)
    return hf, cm


def reference_world(ctx):
    """The reference's own DEM and costmap, float64, from the configuration."""
    w = ctx.config["world"]
    z = rworld.crater_surface(w["grid_size"], w["half_width"], w["bumps"], device=ctx.device)
    o = w["obstacles"]
    occ = rworld.occupancy(rworld.obstacles(o["num"], o["seed"], o["extent"], o["r_max"]),
                           w["half_width"], w["costmap_size"], w["robot_radius"])
    return z, rworld.costmap(occ, w["falloff"], device=ctx.device)


def reference_views(ctx, z, cost, dtype):
    """The reference's world as its loops read it, in ``dtype``."""
    hw = ctx.config["world"]["half_width"]
    return rhf.HeightField.create(z.to(dtype), hw), ref.Costmap.create(cost.to(dtype), hw)


def world_checks(ctx, hf, cm, z, cost) -> list:
    """The port's DEM and costmap against the reference's (m; cost). The
    control puts the reference's own, held in bfloat16, in their place."""
    got_z, got_cost = (port.held_in_bf16((z.float(), cost.float())) if ctx.control
                       else (hf.z, cm.cost))
    return [("dem_gap_m", port.max_gap(got_z, z), ctx.config["limits"]["dem_gap_m"]),
            ("costmap_gap", port.max_gap(got_cost, cost), ctx.config["limits"]["costmap_gap"])]


def jax_normal_shares(key: torch.Tensor, n: int) -> dict:
    """The share of a draw's values that take each side of XLA's
    ``erf_inv`` and ``log1p`` (what the ``jax_normal`` count weighs)."""
    u = rjr.uniform(key, (n,), torch.float32, rjr.f32(rjr.NORMAL_LO_F32), 1.0)
    y = u * -u
    log_share = float((y.abs() >= rjr.f32(rjr.LOG1P_SMALL)).double().mean())
    ge5 = float((~(rjr.log1p_f32(y) > -5.0)).double().mean())
    return {"common": 1.0, "rational": 1.0 - log_share, "log": log_share,
            "w_lt5": 1.0 - ge5, "w_ge5": ge5}


class Session:
    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        self.config = port.mppi_config(ctx.config["mppi"])
        self.hf, self.cm = build_world(ctx)
        dev = ctx.device
        self.cap, self.unroll = int(t["max_loops"]), int(t["unroll"])
        p = t["pairs"]
        rng = np.random.default_rng(ctx.seed)
        self.pairs = port.thesis_pairs(int(t["episodes_drawn"]), ctx.config["world"]["half_width"],
                                       int(rng.integers(0, 2 ** 62)), p["lo"], p["hi"],
                                       p["cross"])
        self.keys = rng.integers(0, 2 ** 62, size=len(self.pairs))
        self.steps = 0
        graph = Graphed(masked_steps, in_place_args=(2, 3))
        # (goal, robot, ctrl, loop, halt, key) in; (robot, ctrl, loop, halt, key) out
        self.rec = port.Recorder(graph, int(t["check"]["replays"]), ctx.seed ^ 0x5EED,
                                 lambda a: (a[4], a[5], a[6], a[7], a[8], a[11]),
                                 lambda o: (o[0], o[1], o[2], o[3], o[6]), self._tick)
        # warm-up (eager) and capture: two calls of the graph at the window's
        # signature, from the first pair's start
        robot, ctrl, goal = self._episode_state(0)
        loop = torch.zeros((), dtype=torch.int64, device=dev)
        halt = goal_reached(robot.position, goal)
        empty3 = torch.zeros((0, 3), dtype=torch.float32, device=dev)
        empty = torch.zeros((0,), dtype=torch.float32, device=dev)
        for _ in range(2):
            self.rec(self.config, self.cap, self.hf, self.cm, goal, robot, ctrl, loop, halt,
                     empty3, empty, jr.key(0, dev), self.unroll)

    def _tick(self):
        if self.rec.on:
            self.steps += self.unroll
            self.ctx.tick({"steps": self.steps})

    def _episode_state(self, i):
        (sx, sy), (gx, gy), heading = self.pairs[i % len(self.pairs)]
        dev = self.ctx.device
        robot = RobotState.create(sx, sy, heading, dtype=torch.float32, device=dev)
        ctrl = ControllerState.create(self.config, torch.float32, dev)
        goal = torch.tensor([gx, gy], dtype=torch.float32, device=dev)
        return robot, ctrl, goal

    def window(self) -> dict:
        ctx = self.ctx
        loops = episodes = failed = capped = 0
        per_episode = []
        self.rec.on = True
        ctx.open_window()
        t0 = time.perf_counter()
        while True:
            robot, ctrl, goal = self._episode_state(episodes)
            key = jr.key(int(self.keys[episodes % len(self.keys)]), ctx.device)
            res = goal_seek(self.config, self.hf, self.cm, goal, robot, ctrl, key,
                            max_loops=self.cap, unroll=self.unroll, steps_fn=self.rec)
            n, reached = int(res.loops), bool(res.reached)
            end = torch.cat([res.robot.position, res.robot.z.reshape(1),
                             res.ctrl.optimal_u1.reshape(-1), res.ctrl.optimal_u2.reshape(-1)])
            loops += n
            capped += 0 if reached else 1
            failed += 0 if bool(torch.isfinite(end).all()) else 1
            per_episode.append(n if reached else -n)
            episodes += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        ctx.sync()
        window_s = time.perf_counter() - t0
        ctx.close_window({"steps": self.steps})
        self.rec.on = False
        self._record = {"loops": loops, "steps": self.steps, "episodes": episodes,
                        "window_s": window_s, "attempted": episodes, "failed": failed,
                        "episodes_capped": capped,
                        "episode_loops": per_episode,
                        "rovers": 1,
                        "draws_per_step": [2 * self.config.num_samples * self.config.horizon]}
        return self._record

    def free(self):
        self.rec.fn = None  # the graph and its buffers

    def _reference(self, z, cost, inputs, control: bool):
        """``unroll`` reference steps from the kept replays' input states, all
        replays at once: float64, or for the control float32 with TF32."""
        dtype = torch.float32 if control else torch.float64
        hf, cm = reference_views(self.ctx, z, cost, dtype)
        goal, robot, ctrl, loop, halt, key = port.cast(inputs, dtype)
        with port.tf32(control):
            return ref.masked_steps(port.ref_mppi(self.ctx.config["mppi"]), self.cap, hf, cm,
                                    goal, ref.Robot(*robot), ref.Ctrl(*ctrl), loop, halt, key,
                                    self.unroll), hf

    def check(self) -> list:
        """The world, then every kept replay against the reference: a replay
        is off where its pose (m) or its optimal inputs lie farther from the
        reference's than the configuration's tolerance. A sound run can
        hand the win to another sample where two costs lie within rounding
        (the weights are that peaked), so the share of replays off is held
        to the few such flips sound runs show."""
        ctx, lim, tol = self.ctx, self.ctx.config["limits"], self.ctx.config["tolerances"]
        z, cost = reference_world(ctx)
        checks = world_checks(ctx, self.hf, self.cm, z, cost)
        record = self._record
        kept = self.rec.kept
        if not kept:
            return checks + [("replays_unchecked", 1.0, 0.0)]
        inputs = port.stack([inp for _, inp, _ in kept])
        (r_robot, r_ctrl, r_loop, r_halt, r_key, ro), hf = self._reference(z, cost, inputs,
                                                                           False)
        out = port.stack([o for _, _, o in kept])
        if ctx.control:  # the reference at the next lower precision in the program's place
            out = port.held_in_bf16(self._reference(z, cost, inputs, True)[0][:5])
        robot, ctrl, loop, halt, key = out
        pose = torch.maximum(
            (robot.position.double() - r_robot.position).abs().amax(-1),
            (robot.z.double() - r_robot.z).abs())
        control = torch.maximum(
            (ctrl.optimal_u1.double() - r_ctrl.optimal_u1).abs().amax(-1),
            (ctrl.optimal_u2.double() - r_ctrl.optimal_u2).abs().amax(-1))
        same = ((loop == r_loop) & (halt == r_halt) & (key == r_key).all(-1))
        record["check_gaps"] = {"pose_m": pose.tolist(), "control": control.tolist()}
        record["dem_cells"] = ref.dem_cells(hf, type(ro)(*(t[0] for t in ro)),
                                            inputs[1][0][0].to(hf.z.dtype))
        record["jax_normal_shares"] = jax_normal_shares(
            rjr.derive(inputs[5][0], ref.SPLIT_SUB),
            2 * self.config.num_samples * self.config.horizon)
        return checks + [
            ("replays_off_share.pose", port.off_share(pose, tol["pose_m"]),
             lim["replays_off_share.pose"]),
            ("replays_off_share.control", port.off_share(control, tol["control"]),
             lim["replays_off_share.control"]),
            ("state_mismatches", float((~same).sum()), 0.0),
            ("replays_unchecked", 0.0, 0.0)]
