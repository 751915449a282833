"""PyTorch port: the vectorized rover simulator and the path metrics against
the JAX package, fed the same DEM and state as numpy (float64), and the
rover checks of tests/test_env.py on the port.

Tolerances: the physics step rounds as the JAX one does, op for op, except
``ext_force``'s 3-term dot product (JAX ``jnp.sum``, here written out left
to right); 120 chained steps stay within 1e-10 in float64. The contact loads
and metrics take 1e-12; teleport, reset and the stop box are exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch import convert
from husky_rover_mppi_isaacsim_torch import env as tenv
from husky_rover_mppi_isaacsim_torch.core import HeightField
from husky_rover_mppi_isaacsim_torch.core import jax_random as jr
from husky_rover_mppi_isaacsim_torch.core import heightfield as thf_ops
from husky_rover_mppi_isaacsim_torch.env import rover_sim as trs
from husky_rover_mppi_isaacsim_torch.terrain import crater_surface as t_crater
from husky_rover_mppi_isaacsim_tpu import env as jenv
from husky_rover_mppi_isaacsim_tpu.core import HeightField as JHeightField
from husky_rover_mppi_isaacsim_tpu.core import heightfield as jhf_ops
from husky_rover_mppi_isaacsim_tpu.env import rover_sim as jrs
from husky_rover_mppi_isaacsim_tpu.terrain import crater_surface

# small tensors: one intra-op thread each, so that the test workers running
# beside these do not lose their cores
torch.set_num_threads(1)

CRATER = [((-12.0, 14.0), 1.5, 8.0), ((4.0, -3.0), 3.0, 5.0)]


def _worlds(grid=256, hw=25.0):
    z = np.asarray(crater_surface(grid, hw, CRATER, dtype=jnp.float64))
    jhf = JHeightField.create(z, hw, dtype=jnp.float64)
    return jhf, convert.heightfield_from_numpy(*(np.asarray(a) for a in jhf))


def _close(got, want, atol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=atol,
                               err_msg=what)


def _random_rovers(rng, jhf, n=4):
    pos = rng.uniform(-15.0, 15.0, (n, 2))
    head = np.concatenate([rng.uniform(-1, 1, (n, 2)), np.zeros((n, 1))], axis=1)
    js = jrs.RoverState.create(pos, head, jhf)
    js = js._replace(wheel_left=jnp.asarray(rng.uniform(0, 1, n)),
                     wheel_right=jnp.asarray(rng.uniform(0, 1, n)),
                     yaw_rate=jnp.asarray(rng.uniform(-0.5, 0.5, n)))
    return js, convert.rover_state_from_numpy(*(np.asarray(a) for a in js))


def test_rover_state_create_and_normal_at_match_jax(rng):
    jhf, thf = _worlds()
    pos = rng.uniform(-20.0, 20.0, (5, 2))
    js = jrs.RoverState.create(pos, [1.0, 0.5, 0.0], jhf)
    ts = trs.RoverState.create(pos, [1.0, 0.5, 0.0], thf)
    for f, a, b in zip(ts._fields, ts, js):
        assert a.dtype == torch.float64 and tuple(a.shape) == b.shape, f
        _close(a, b, 1e-14, f)
    x, y = (rng.uniform(-30.0, 30.0, 64) for _ in range(2))  # out-of-window cells too
    _close(thf_ops.normal_at(thf, torch.from_numpy(x), torch.from_numpy(y)),
           jhf_ops.normal_at(jhf, jnp.asarray(x), jnp.asarray(y)), 1e-14)


@pytest.mark.parametrize("wrench", [False, True], ids=["plain", "ext_wrench"])
def test_step_matches_jax_over_120_steps(rng, wrench):
    """N=4 rovers, per-rover commands, slip_std=0: 120 chained physics
    steps, every field within 1e-10."""
    jhf, thf = _worlds()
    js, ts = _random_rovers(rng, jhf)
    start = ts.position
    params = jrs.RoverParams(wheel_tau=0.03)
    tparams = convert.rover_params_from_jax(params)
    cl, cr = rng.uniform(-0.5, 2.0, (2, 4))
    force = rng.normal(size=(4, 3)) * 20.0 if wrench else None
    torque = rng.normal(size=4) * 2.0 if wrench else None
    jstep = jax.jit(lambda s: jrs.step(params, jhf, s, jnp.asarray(cl), jnp.asarray(cr), None,
                                       None if force is None else jnp.asarray(force),
                                       None if torque is None else jnp.asarray(torque)))
    for i in range(120):
        js = jstep(js)
        ts = trs.step(tparams, thf, ts, torch.from_numpy(cl), torch.from_numpy(cr),
                      ext_force=None if force is None else torch.from_numpy(force),
                      ext_torque=None if torque is None else torch.from_numpy(torque))
        if i % 40 == 39:
            for f, a, b in zip(ts._fields, ts, js):
                _close(a, b, 1e-10, f"{f} after {i + 1} steps")
    assert float(torch.abs(ts.position - start).max()) > 0.5  # the rovers did move


def test_step_float32_follows_its_dtype():
    hf = HeightField.create(t_crater(128, 20.0, CRATER[:1]), 20.0)
    state = trs.RoverState.create(np.array([[1.0, 2.0], [-3.0, 0.5]]), [1.0, 0.0, 0.0], hf)
    out = trs.step(trs.RoverParams(), hf, state, torch.ones(2), torch.full((2,), 1.5))
    assert all(t.dtype == torch.float32 for t in out)
    assert out.position.shape == (2, 2) and out.heading.shape == (2, 3)


def test_slip_from_generator_equals_injected_normals():
    """Slip draws JAX's two normals from ``k1, k2 = split(key)``
    (rover_sim.py:99-101): the step equals JAX's step from the same key
    (float64: the draws within a few ulp of JAX's), a key taken down a
    path equals that path's key given, and slip_std=0 or no key means no
    slip."""
    hf = HeightField.create(t_crater(128, 20.0, CRATER[:1]), 20.0, dtype=torch.float64)
    jhf = JHeightField.create(jnp.asarray(hf.z.numpy()), 20.0, dtype=jnp.float64)
    starts = np.array([[0.0, 0.0], [1.0, -2.0], [-3.0, 1.5]])
    state = trs.RoverState.create(starts, [1.0, 0.0, 0.0], hf)
    jstate = jrs.RoverState.create(starts, [1.0, 0.0, 0.0], jhf)
    params = trs.RoverParams(slip_std=0.2)
    cmd = torch.full((3,), 1.0, dtype=torch.float64)
    a = trs.step(params, hf, state, cmd, cmd, key=jr.key(5))
    want = jrs.step(jrs.RoverParams(slip_std=0.2), jhf, jstate, jnp.asarray(cmd.numpy()),
                    jnp.asarray(cmd.numpy()), jax.random.key(5))
    for f, x, y in zip(a._fields, a, want):
        _close(x, y, 1e-12, f)
    b = trs.step(params, hf, state, cmd, cmd, key=jr.key(7), path=(("split", 3, 2),))
    c = trs.step(params, hf, state, cmd, cmd, key=jr.split(jr.key(7), 3)[2])
    for x, y in zip(b, c):
        assert torch.equal(x, y)
    plain = trs.step(params, hf, state, cmd, cmd)
    assert not torch.equal(a.wheel_left, plain.wheel_left)
    assert torch.equal(plain.wheel_left, trs.step(trs.RoverParams(), hf, state, cmd, cmd,
                                                  key=jr.key(5)).wheel_left)


def test_contact_forces_match_jax(rng):
    jhf, thf = _worlds()
    js, ts = _random_rovers(rng, jhf, n=6)
    jp = jrs.RoverParams()
    tp = convert.rover_params_from_jax(jp)
    _close(trs.contact_forces(tp, thf, ts), jrs.contact_forces(jp, jhf, js), 1e-12)
    for wheelbase, com in ((0.512, 0.2), (0.7, 0.35)):
        _close(trs.wheel_contact_forces(tp, thf, ts, wheelbase, com),
               jrs.wheel_contact_forces(jp, jhf, js, wheelbase, com), 1e-12)


def test_teleport_and_reset_mask_match_jax(rng):
    jhf, thf = _worlds()
    js, ts = _random_rovers(rng, jhf, n=5)
    pos, head = np.array([3.0, -4.0]), np.array([0.0, 2.0, 0.0])
    jt = jrs.teleport(js, jhf, 2, jnp.asarray(pos), jnp.asarray(head))
    tt = trs.teleport(ts, thf, 2, pos, head)
    for f, a, b in zip(tt._fields, tt, jt):
        _close(a, b, 0, f)
    assert float(ts.wheel_left[2]) != 0.0  # the input state is not written
    mask = np.array([True, False, True, False, True])
    newp = rng.uniform(-10, 10, (5, 2))
    newh = np.concatenate([rng.uniform(-1, 1, (5, 2)), np.zeros((5, 1))], axis=1)
    jr = jrs.reset_mask(js, jhf, jnp.asarray(mask), jnp.asarray(newp), jnp.asarray(newh))
    tr = trs.reset_mask(ts, thf, torch.from_numpy(mask), newp, newh)
    for f, a, b in zip(tr._fields, tr, jr):
        _close(a, b, 0, f)


def test_metrics_match_jax(rng):
    traj = rng.normal(size=(3, 200, 3)).cumsum(axis=-2) * 0.1
    for t in (traj, traj[0], traj[:, :15]):  # batched, single, shorter than the stride
        got = tenv.path_metrics(torch.from_numpy(t))
        want = jenv.path_metrics(jnp.asarray(t))
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], 1e-12, k)
    pos, goals = rng.uniform(-1, 1, (2, 8, 2))
    _close(tenv.goal_distances(torch.from_numpy(pos), torch.from_numpy(goals)),
           jenv.goal_distances(jnp.asarray(pos), jnp.asarray(goals)), 1e-15)
    box = np.array([[0.4, -0.4], [0.6, 0.0], [0.0, 0.0], [0.5, 0.5]])
    np.testing.assert_array_equal(
        tenv.success_mask(torch.from_numpy(box), torch.zeros(4, 2, dtype=torch.float64)).numpy(),
        np.asarray(jenv.success_mask(jnp.asarray(box), jnp.zeros((4, 2)))))


# --- the rover checks of tests/test_env.py, on the port ---------------------

def _world32(grid=256, hw=25.0):
    return HeightField.create(t_crater(grid, hw, CRATER[:1]), hw)


def test_rover_sim_straight_line():
    hf = _world32()
    state = trs.RoverState.create(np.tile([[-5.0, -5.0]], (4, 1)), [1.0, 0.0, 0.0], hf)
    params = trs.RoverParams(wheel_tau=0.02)
    cmd = torch.full((4,), 1.0)
    for _ in range(120):  # 2 s
        state = trs.step(params, hf, state, cmd, cmd)
    pos = state.position.numpy()
    # equal wheel speeds -> straight +x travel ~ 2 m (minus spin-up)
    assert np.all(pos[:, 0] > -3.6)
    assert np.allclose(pos[:, 1], -5.0, atol=0.05)
    assert np.allclose(state.yaw_rate.numpy(), 0.0, atol=1e-4)
    assert np.allclose(state.wheel_left.numpy(), 1.0, atol=1e-3)


def test_rover_sim_turns_left():
    hf = _world32()
    state = trs.RoverState.create(np.array([[0.0, 0.0]]), [1.0, 0.0, 0.0], hf)
    params = trs.RoverParams(wheel_tau=0.02)
    for _ in range(60):
        state = trs.step(params, hf, state, torch.tensor([0.5]), torch.tensor([1.5]))
    # right wheel faster -> positive yaw rate -> heading rotates toward +y
    assert float(state.yaw_rate[0]) > 0.5
    assert float(state.heading[0, 1]) > 0.2


def test_wheel_contact_forces_flat_ground_is_quarter_weight():
    hf = HeightField.create(torch.zeros((64, 64)), 20.0)
    state = trs.RoverState.create(np.array([[0.0, 0.0]]), [1.0, 0.0, 0.0], hf)
    params = trs.RoverParams()
    loads = trs.wheel_contact_forces(params, hf, state, wheelbase=0.512).numpy()
    np.testing.assert_allclose(loads, params.mass * params.gravity / 4.0, rtol=1e-5)


def test_wheel_contact_forces_side_slope_loads_downhill_wheels():
    hw, n = 20.0, 64
    ys = torch.linspace(-hw, hw, n)
    hf = HeightField.create((0.3 * ys[None, :]).expand(n, n).T.contiguous(), hw)
    state = trs.RoverState.create(np.array([[0.0, 0.0]]), [1.0, 0.0, 0.0], hf)
    params = trs.RoverParams()
    fl, fr, rl, rr = trs.wheel_contact_forces(params, hf, state, wheelbase=0.512)[0].tolist()
    normal = thf_ops.normal_at(hf, torch.tensor([0.0]), torch.tensor([0.0]))[0].tolist()
    assert abs(normal[1]) > 0.05, f"fixture not a side slope: {normal}"
    uphill = (fl + rl) if normal[1] < 0 else (fr + rr)
    downhill = (fr + rr) if normal[1] < 0 else (fl + rl)
    assert downhill > uphill * 1.1
    np.testing.assert_allclose(fl, rl, rtol=1e-4)
    np.testing.assert_allclose(fr, rr, rtol=1e-4)
    np.testing.assert_allclose(fl + fr + rl + rr, params.mass * params.gravity * normal[2],
                               rtol=1e-4)


def test_teleport_resets_wheels():
    hf = _world32()
    state = trs.RoverState.create(np.zeros((3, 2)), [1.0, 0.0, 0.0], hf)
    state = state._replace(wheel_left=torch.ones(3), wheel_right=torch.ones(3))
    state = trs.teleport(state, hf, 1, [3.0, 4.0], [0.0, 1.0, 0.0])
    assert state.position[1].tolist() == [3.0, 4.0]
    assert float(state.wheel_left[1]) == 0.0 and float(state.wheel_left[0]) == 1.0


def test_teleport_keeps_mixed_field_dtypes():
    hf = _world32()
    state = trs.RoverState.create(np.zeros((3, 2)), [1.0, 0.0, 0.0], hf)
    state = state._replace(wheel_left=torch.ones(3, dtype=torch.float64))
    out = trs.teleport(state, hf, 2, [1.0, 2.0], [0.0, 1.0, 0.0])
    assert out.wheel_left.dtype == torch.float64 and out.yaw_rate.dtype == torch.float32
    assert float(out.wheel_left[2]) == 0.0
