"""What the drivers share: the port's objects built from a configuration's
dict, the reference's from the same dict, the traffic generator's draws,
and the recorder that keeps a seeded sample of a graph's calls.

The only module of the benchmark besides the drivers that imports the
port, and only inside functions.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..reference import loops as ref

MPPI_SCALARS = ("num_samples", "horizon", "dt", "robot_radius", "temperature", "sigma_base",
                "projection", "slope_critic", "exact")


def mppi_config(mppi: dict):
    """The port's ``MPPIConfig`` from a configuration's ``mppi`` dict."""
    from husky_rover_mppi_isaacsim_torch.dynamics.skid_steer import DiffDriveLimits
    from husky_rover_mppi_isaacsim_torch.mppi.controller import MPPIConfig
    from husky_rover_mppi_isaacsim_torch.mppi.critics import CriticWeights
    from husky_rover_mppi_isaacsim_torch.mppi.sampling import InputLimits

    kw = {k: mppi[k] for k in MPPI_SCALARS if k in mppi}
    kw["limits"] = DiffDriveLimits(mppi["v_min"], mppi["v_max"], mppi["w_min"], mppi["w_max"])
    kw["inputs"] = InputLimits(mppi["std_u"], mppi["u_min"], mppi["u_max"],
                               mppi["std_u"], mppi["u_min"], mppi["u_max"])
    kw["critic_weights"] = CriticWeights(*mppi["critic_weights"])
    kw["rollout_lag"] = tuple(mppi["rollout_lag"])
    kw["optimal_lag"] = tuple(mppi["optimal_lag"])
    return MPPIConfig(**kw)


def ref_mppi(mppi: dict) -> ref.Mppi:
    """The reference's controller constants from the same dict."""
    return ref.Mppi.from_config(mppi)


def thesis_pairs(n: int, half_width: float, seed: int, lo: float, hi: float,
                 cross: float) -> list:
    """Paired start/goal/heading draws of the thesis protocol
    (MPPI_OO_current.py:756-768; the port's ``mppi.evaluation.thesis_pairs``,
    frozen): ``x`` in ``U(-hi, -lo)`` to ``U(lo, hi)`` with the cross
    coordinate in ``U(-cross, cross)``, the axis alternating, a random
    heading."""
    rng = np.random.default_rng(seed)
    pairs = []
    for i in range(n):
        top = min(hi, half_width - 2.0)
        a, b = rng.uniform(lo, top), rng.uniform(lo, top)
        off_s, off_g = rng.uniform(-cross, cross), rng.uniform(-cross, cross)
        hr = rng.uniform(0.0, 1.0), rng.uniform(-1.0, 1.0)
        if i % 2 == 0:
            start, goal, heading = (-a, off_s), (b, off_g), [hr[0], hr[1], 0.0]
        else:
            start, goal, heading = (off_s, -a), (off_g, b), [hr[1], hr[0], 0.0]
        pairs.append((start, goal, heading))
    return pairs


def clone(tree):
    """A copy of every tensor of a pytree (a graph's buffers are overwritten
    by its next replay)."""
    return pytree.tree_map(lambda t: t.clone() if isinstance(t, torch.Tensor) else t, tree)


class Recorder:
    """Wraps a graphed function: every call is counted and reported to
    ``tick``; while :attr:`on`, a seeded reservoir of ``keep`` calls keeps
    copies of what ``pick_in(args)`` and ``pick_out(result)`` select, the
    inputs copied before the call (a replay overwrites them) and the
    outputs after it. Taking a copy is a few device copies of small
    tensors; whether a call is taken is decided on the host from the seed
    alone."""

    def __init__(self, fn, keep: int, seed: int, pick_in, pick_out, tick=None):
        self.fn, self.keep = fn, keep
        self.rng = np.random.default_rng(seed)
        self.pick_in, self.pick_out, self.tick = pick_in, pick_out, tick
        self.on = False
        self.calls = 0      # calls while on
        self.kept: list = []

    def __call__(self, *args):
        slot = None
        if self.on:
            i = self.calls
            self.calls += 1
            if i < self.keep:
                slot = i
            else:
                j = int(self.rng.integers(0, i + 1))
                slot = j if j < self.keep else None
        inp = clone(self.pick_in(args)) if slot is not None else None
        out = self.fn(*args)
        if slot is not None:
            item = (self.calls - 1, inp, clone(self.pick_out(out)))
            if slot < len(self.kept):
                self.kept[slot] = item
            else:
                self.kept.append(item)
        if self.tick is not None:
            self.tick()
        return out


def max_gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest absolute difference, in float64 (NaN anywhere: inf)."""
    d = (a.double() - b.double()).abs()
    if not bool(torch.isfinite(d).all()):
        return float("inf")
    return float(d.max()) if d.numel() else 0.0


def cast(tree, dtype):
    """Every float tensor of a pytree in ``dtype`` (the reference's state)."""
    return pytree.tree_map(lambda t: t.to(dtype)
                           if isinstance(t, torch.Tensor) and t.is_floating_point() else t, tree)


def stack(trees):
    """A list of like pytrees as one, each leaf stacked on a new first axis."""
    leaves = [pytree.tree_flatten(t) for t in trees]
    spec = leaves[0][1]
    return pytree.tree_unflatten([torch.stack(col) for col in zip(*(lv for lv, _ in leaves))],
                                 spec)


@contextlib.contextmanager
def tf32(on: bool):
    """float32 matmuls in TF32 while inside (the control), full float32 else."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def off_share(gaps: torch.Tensor, tol: float) -> float:
    """The share of per-call gaps that exceed ``tol`` (a NaN counts)."""
    return float((~(gaps <= tol)).double().mean())


def held_in_bf16(tree):
    """Every float tensor of a pytree rounded to bfloat16 and back: the
    control's state held at the next lower precision."""
    return pytree.tree_map(lambda t: t.bfloat16().to(t.dtype)
                           if isinstance(t, torch.Tensor) and t.is_floating_point() else t, tree)
