"""PyTorch port: the rover axis, one repaired function at a time, against
``jax.vmap`` of the JAX function over rovers (float64), and rover n of a
batched call against a one-rover call with rover n's inputs.

Each rover has its own inputs (pose, wheel speeds, optimum, stds, goal), and
the cases include N == K, where a rover-level ``(N,)`` value that lines up
with the sample axis instead of the rover axis would pass silently.

Tolerances: the wheel lag, the critics and the sampling take those of the
unbatched tests (1e-12, rtol 1e-12 and exact; tests/test_torch_dynamics.py,
tests/test_torch_critics.py); the rollout 1e-10 (tests/test_torch_rollout.py).
Rover n of a batched call equals the one-rover call bit for bit, for the
sequential lag, the sampling, the critics and the plain rollout.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch import convert
from husky_rover_mppi_isaacsim_torch.dynamics import skid_steer as tss
from husky_rover_mppi_isaacsim_torch.mppi import critics as tcr
from husky_rover_mppi_isaacsim_torch.mppi import rollout as tro
from husky_rover_mppi_isaacsim_torch.mppi import sampling as tsamp
from husky_rover_mppi_isaacsim_torch.ops.rollout_cuda import rollout_25d_cuda
from husky_rover_mppi_isaacsim_tpu.core import HeightField as JHeightField
from husky_rover_mppi_isaacsim_tpu.dynamics import skid_steer as jss
from husky_rover_mppi_isaacsim_tpu.mppi import critics as jcr
from husky_rover_mppi_isaacsim_tpu.mppi import rollout as jro
from husky_rover_mppi_isaacsim_tpu.mppi import sampling as jsamp
from husky_rover_mppi_isaacsim_tpu.terrain import as_costmap, crater_surface

# small tensors: one intra-op thread each, so that the test workers running
# beside these do not lose their cores
torch.set_num_threads(1)

LIMITS = (0.0, 2.0, -1.0, 1.0)
SHAPES = [(3, 5), (4, 4), (1, 6)]  # (rovers N, samples K); N == K included
SHAPE_IDS = ["n3k5", "n4k4", "n1k6"]


def _close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol,
                               err_msg=what)


@pytest.mark.parametrize("n,k", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("form", ["scan", "matmul"])
def test_wheel_lag_rover_axis_matches_jax_vmap(rng, form, n, k):
    """Inputs (N, K, H), start wheel speeds (N,): rover n's speeds apply to
    its K samples."""
    h = 12
    u1, u2 = rng.uniform(-1, 1, (2, n, k, h))
    left0, right0 = rng.uniform(-0.5, 1.0, (2, n))
    lag = (3.5, 0.96)
    jfn = functools.partial(getattr(jss, f"wheel_lag_{form}"), track=jnp.asarray(1.2),
                            limits=jss.DiffDriveLimits(*LIMITS), k=lag[0], a=lag[1])
    want = jax.vmap(jfn)(jnp.asarray(u1), jnp.asarray(u2), jnp.asarray(left0),
                         jnp.asarray(right0))
    tfn = functools.partial(getattr(tss, f"wheel_lag_{form}"),
                            track=torch.tensor(1.2, dtype=torch.float64),
                            limits=tss.DiffDriveLimits(*LIMITS), k=lag[0], a=lag[1])
    t = torch.as_tensor
    got = tfn(t(u1), t(u2), t(left0), t(right0))
    for g, w in zip(got, want):
        assert tuple(g.shape) == (n, k, h)
        _close(g, w, 0, 1e-12)
    if form == "scan":  # the exact sequential form: rover n is the one-rover call
        for i in range(n):
            one = tfn(t(u1[i]), t(u2[i]), t(left0[i]), t(right0[i]))
            for g, o in zip(got, one):
                assert torch.equal(g[i], o)


@pytest.mark.parametrize("n,k", SHAPES, ids=SHAPE_IDS)
def test_sampling_rover_axis_matches_jax_vmap(rng, n, k):
    """``shift_receding`` shifts each rover's (H,) optimum along the horizon;
    ``perturb`` takes optima (N, H), stds (N,) and noise (N, 2, K, H)."""
    h = 10
    o1, o2 = rng.uniform(-1, 1, (2, n, h))
    s1, s2 = rng.uniform(0.2, 0.8, (2, n))
    noise = rng.normal(size=(n, 2, k, h)) * 3.0  # wide enough to hit the clamps
    t = torch.as_tensor
    np.testing.assert_array_equal(
        tsamp.shift_receding(t(o1)).numpy(),
        np.asarray(jax.vmap(jsamp.shift_receding)(jnp.asarray(o1))))
    jfn = functools.partial(jsamp.perturb, limits=jsamp.InputLimits())
    want = jax.vmap(jfn)(*map(jnp.asarray, (o1, o2, noise, s1, s2)))
    got = tsamp.perturb(t(o1), t(o2), t(noise), t(s1), t(s2), tsamp.InputLimits())
    for g, w in zip(got, want):
        assert tuple(g.shape) == (n, k, h)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for i in range(n):
        one = tsamp.perturb(t(o1[i]), t(o2[i]), t(noise[i]), t(s1[i]), t(s2[i]),
                            tsamp.InputLimits())
        for g, o in zip(got, one):
            assert torch.equal(g[i], o)


def _critic_inputs(rng, n, k, h=20):
    steps = rng.normal(scale=0.6, size=(3, n, k, h, 3))
    steps[..., 2] *= 0.1
    traj, lw, rw = np.cumsum(steps, axis=-2)
    pos = rng.uniform(-3.0, 3.0, (n, 2))
    traj[..., :2] += pos[:, None, None, :]
    goal = rng.uniform(-8.0, 8.0, (n, 2))
    goal[0] = pos[0] + [0.5, -0.3]  # rover 0 within 2 m: the near branches
    lin = rng.uniform(0.0, 2.0, (n, k, h))
    return pos, goal, traj, lw, rw, lin


@pytest.mark.parametrize("n,k", SHAPES, ids=SHAPE_IDS)
def test_critics_rover_axis_match_jax_vmap(rng, n, k):
    """Poses x, y (N,) and goals (N, 2) against trajectories (N, K, H, 3):
    the path-follow and speed critics and the whole critic stack."""
    cost = rng.uniform(0.0, 1.0, (32, 32)) ** 3
    cost[rng.uniform(size=(32, 32)) < 0.05] = 1.0
    jcm = as_costmap(cost, 10.0, dtype=jnp.float64)
    tcm = convert.costmap_from_numpy(*(np.asarray(a) for a in jcm))
    pos, goal, traj, lw, rw, lin = _critic_inputs(rng, n, k)
    x, y = pos[:, 0], pos[:, 1]
    hm, speed = 3.0, 2.0
    t = torch.as_tensor
    s = lambda v: torch.tensor(v, dtype=torch.float64)  # noqa: E731
    j = lambda *a: tuple(map(jnp.asarray, a))  # noqa: E731

    cases = {
        "path_follow": (
            lambda *a: tcr.path_follow_critic(*a, s(hm)), (x, y, goal, traj),
            lambda *a: jcr.path_follow_critic(*a, hm)),
        "maximise_speed": (
            lambda *a: tcr.maximise_speed_critic(*a, s(speed)), (x, y, goal, lin),
            lambda *a: jcr.maximise_speed_critic(*a, speed)),
        "evaluate": (
            lambda x_, y_, g, tr, l_, r_, v: tcr.evaluate_trajectories(
                x_, y_, g, tr, l_, r_, v, s(speed), tcm, s(hm)),
            (x, y, goal, traj, lw, rw, lin),
            lambda x_, y_, g, tr, l_, r_, v: jcr.evaluate_trajectories(
                x_, y_, g, tr, l_, r_, v, speed, jcm, hm)),
    }
    for name, (tfn, args, jfn) in cases.items():
        got = tfn(*map(t, args))
        want = jax.vmap(jfn)(*j(*args))
        assert tuple(got.shape) == (n, k), name
        _close(got, want, 1e-12, 0, name)
        for i in range(n):
            assert torch.equal(got[i], tfn(*(t(a[i]) for a in args))), f"{name}, rover {i}"


def _worlds(grid=200, hw=25.0):
    z = np.asarray(crater_surface(grid, hw, [((-5.0, 8.0), 2.0, 6.0),
                                             ((10.0, -6.0), 3.0, 8.0)], dtype=jnp.float64))
    jhf = JHeightField.create(z, hw, dtype=jnp.float64)
    return jhf, convert.heightfield_from_numpy(*(np.asarray(a) for a in jhf))


@pytest.mark.parametrize("k", [1, 24], ids=["k1", "k24"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
def test_rollout_25d_per_rover_starts(rng, dtype, k):
    """Starts (N, 2) and headings (N, 3) broadcast over each rover's K
    samples: rover n equals a one-rover rollout bit for bit, float64 equals
    ``jax.vmap`` of the JAX rollout, and K1's wrapper on CPU tensors takes
    the rover axis to the same plain rollout without a launch."""
    jhf, thf64 = _worlds()
    thf = type(thf64)(*(a.to(dtype) for a in thf64))
    n, h, dt = 3, 30, 0.045
    pos = rng.uniform(-20.0, 20.0, (n, 2))
    head = np.concatenate([rng.uniform(-1, 1, (n, 2)), rng.uniform(-0.1, 0.1, (n, 1))], 1)
    lin = rng.uniform(0.0, 2.0, (n, k, h))
    ang = rng.uniform(-1.0, 1.0, (n, k, h))
    t = lambda a: torch.from_numpy(a).to(dtype)  # noqa: E731
    got = tro.rollout_25d(thf, t(pos)[:, None], t(head)[:, None], t(lin), t(ang), dt)
    for f in got:
        assert tuple(f.shape) == (n, k, h, 3)
    for i in range(n):
        one = tro.rollout_25d(thf, t(pos[i]), t(head[i]), t(lin[i]), t(ang[i]), dt)
        for g, o in zip(got, one):
            assert torch.equal(g[i], o)
    if dtype == torch.float64:
        want = jax.vmap(functools.partial(jro.rollout_25d, jhf, dt=dt))(
            *map(jnp.asarray, (pos, head, lin, ang)))
        for g, w in zip(got, want):
            _close(g, w, 0, 1e-10)
    before = rollout_25d_cuda.launches
    wrapped = rollout_25d_cuda(thf, t(pos), t(head), t(lin), t(ang), dt)
    assert rollout_25d_cuda.launches == before
    for g, w in zip(wrapped, got):
        assert torch.equal(g, w)
