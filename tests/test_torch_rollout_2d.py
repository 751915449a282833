"""PyTorch port: the planar rollout kernel's wrapper (ops/rollout_2d_cuda.py,
csrc/rollout_2d.cu) on the CPU, and the 2D control step through it.

On CPU tensors the wrapper runs its plain version, ``mppi/rollout.py::
rollout_2d``; it is held bit for bit against a direct call of that version
and, in float32, against JAX's ``rollout_2d`` (the ``lax.scan`` the kernel
stands for) within ``XY_ATOL`` and ``HEADING_ATOL``. The kernel itself is held against the
plain version on the card (tests/test_torch_gpu.py, chip_smoke.py)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch import convert
from husky_rover_mppi_isaacsim_torch.core import HeightField
from husky_rover_mppi_isaacsim_torch.mppi import controller as tc
from husky_rover_mppi_isaacsim_torch.mppi import rollout as tro
from husky_rover_mppi_isaacsim_torch.ops import rollout_2d_cuda as r2
from husky_rover_mppi_isaacsim_tpu.core import HeightField as JHeightField
from husky_rover_mppi_isaacsim_tpu.mppi import controller as jc
from husky_rover_mppi_isaacsim_tpu.mppi import rollout as jro
from husky_rover_mppi_isaacsim_tpu.terrain import as_costmap, crater_surface

# small tensors: one intra-op thread each, so that the test workers running
# beside these do not lose their cores
torch.set_num_threads(1)

# float32, torch against XLA's CPU code: the same operations, which XLA may
# fuse and contract. Positions drift by a few ulps of ~20 m over 40 steps
# (measured over 80 seeded cases: <= 3.9e-6 m), headings by a few ulps of 1
# (<= 4.8e-7); a height moves with its position times the DEM's slope,
# up to 8 on the test's random DEM (<= 4.1e-5 m)
XY_ATOL, HEADING_ATOL = 1e-5, 1e-6
# the control step in float64: tests/test_torch_controller.py's bounds
STEP_ATOL = 1e-10


def _world(rng, grid=128, hw=16.0, dtype=np.float32):
    z = rng.uniform(-1.0, 1.0, (grid, grid)).astype(dtype)
    jf = JHeightField.create(z, hw, dtype=jnp.asarray(z).dtype)
    return jf, convert.heightfield_from_numpy(*(np.asarray(a) for a in jf))


def _inputs(rng, lead=(), k=12, h=40, start=(-3.0, 2.0)):
    pos = np.asarray(start, np.float32) + rng.uniform(-1.0, 1.0, lead + (2,)).astype(np.float32)
    heading = rng.uniform(-1.0, 1.0, lead + (3,)).astype(np.float32)
    heading[..., 2] = rng.uniform(-0.2, 0.2, lead)  # a raw heading, not yet planar
    lin = rng.uniform(0.0, 2.0, lead + (k, h)).astype(np.float32)
    ang = rng.uniform(-1.0, 1.0, lead + (k, h)).astype(np.float32)
    return pos, heading, lin, ang


@pytest.mark.parametrize("start", [(-3.0, 2.0), (-15.8, 15.9)], ids=["inside", "off_dem"])
def test_wrapper_on_cpu_equals_plain_and_jax(rng, start):
    """The second start drives off the window: wrap-then-clamp reads."""
    jf, tf = _world(rng)
    pos, heading, lin, ang = _inputs(rng, start=start)
    t = [torch.from_numpy(a) for a in (pos, heading, lin, ang)]
    before = r2.rollout_2d_cuda.launches
    got = r2.rollout_2d_cuda(tf, *t, 0.045)
    assert r2.rollout_2d_cuda.launches == before  # CPU tensors: the plain version
    want = tro.rollout_2d(tf, t[0][None], t[1][None], t[2], t[3], 0.045)
    jwant = jro.rollout_2d(jf, *(jnp.asarray(a) for a in (pos, heading, lin, ang)), 0.045)
    for g, w in zip(got, want):
        assert g.shape == lin.shape + (3,) and g.dtype == torch.float32 and g.is_contiguous()
        assert torch.equal(g, w)
    (traj, heads), (jtraj, jheads) = got, [np.asarray(a) for a in jwant]
    slope = max(np.abs(np.diff(np.asarray(jf.z), axis=a)).max() for a in (0, 1))
    slope /= float(jf.resolution)
    np.testing.assert_allclose(traj[..., :2].numpy(), jtraj[..., :2], rtol=0, atol=XY_ATOL)
    np.testing.assert_allclose(traj[..., 2].numpy(), jtraj[..., 2], rtol=0,
                               atol=2 * slope * XY_ATOL)
    np.testing.assert_allclose(heads.numpy(), jheads, rtol=0, atol=HEADING_ATOL)
    assert (heads[..., 2] == 0).all()


# start headings scaled by 2^e around the edges of the kernel's fast-form
# range [2^-60, 2^60) (tests/test_torch_gpu.py holds the kernel there);
# every square stays a normal float32, so XLA's flushing of subnormals on
# the CPU cannot tell the two packages apart
@pytest.mark.parametrize("e", [-60, -59, 58, 59, 60, 61])
def test_wrapper_on_cpu_at_heading_scales_equals_plain_and_jax(rng, e):
    jf, tf = _world(rng)
    pos, heading, lin, ang = _inputs(rng, h=16)
    heading = (np.asarray([0.6, -0.8, 0.3]) * 2.0 ** e).astype(np.float32)
    lin[::3] = 0.0
    t = [torch.from_numpy(a) for a in (pos, heading, lin, ang)]
    got = r2.rollout_2d_cuda(tf, *t, 0.045)
    want = tro.rollout_2d(tf, t[0][None], t[1][None], t[2], t[3], 0.045)
    jwant = jro.rollout_2d(jf, *(jnp.asarray(a) for a in (pos, heading, lin, ang)), 0.045)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    (traj, heads), (jtraj, jheads) = got, [np.asarray(a) for a in jwant]
    np.testing.assert_allclose(traj[..., :2].numpy(), jtraj[..., :2], rtol=0, atol=XY_ATOL)
    np.testing.assert_allclose(heads.numpy(), jheads, rtol=0, atol=HEADING_ATOL)
    assert np.isfinite(traj.numpy()).all()


def test_wrapper_on_cpu_keeps_a_zero_planar_heading(rng):
    """A vertical start heading rotates to a planar norm of exactly 0: both
    packages keep the zero heading, and the rover does not move."""
    jf, tf = _world(rng)
    pos, _, lin, ang = _inputs(rng, h=1)
    heading = np.asarray([0.0, 0.0, 0.5], np.float32)
    t = [torch.from_numpy(a) for a in (pos, heading, lin, ang)]
    traj, heads = r2.rollout_2d_cuda(tf, *t, 0.045)
    jtraj, jheads = jro.rollout_2d(jf, *(jnp.asarray(a) for a in (pos, heading, lin, ang)), 0.045)
    assert (heads == 0).all() and (np.asarray(jheads) == 0).all()
    assert torch.equal(traj[..., :2], t[0].expand(lin.shape[0], 1, 2))
    np.testing.assert_array_equal(traj[..., :2].numpy(), np.asarray(jtraj)[..., :2])


def test_rover_axis_equals_one_rover_calls(rng):
    """N rovers in one call equal N one-rover calls, for K1's pose layout
    ``(N, 2)`` and the plain version's ``(N, 1, 2)`` alike."""
    _, tf = _world(rng)
    pos, heading, lin, ang = (torch.from_numpy(a) for a in _inputs(rng, lead=(4,)))
    batched = r2.rollout_2d_cuda(tf, pos, heading, lin, ang, 0.045)
    unit_axis = r2.rollout_2d_cuda(tf, pos[:, None], heading[:, None], lin, ang, 0.045)
    for n in range(4):
        one = r2.rollout_2d_cuda(tf, pos[n], heading[n], lin[n], ang[n], 0.045)
        for a, b, c in zip(batched, unit_axis, one):
            assert torch.equal(a[n], c) and torch.equal(b[n], c)


def _check_args(lead=(4,), k=5, h=7, dtype=torch.float32):
    hf = HeightField.create(torch.zeros((16, 16), dtype=dtype), 4.0)
    return (hf, torch.zeros(lead + (2,), dtype=dtype), torch.ones(lead + (3,), dtype=dtype),
            torch.ones(lead + (k, h), dtype=dtype), torch.ones(lead + (k, h), dtype=dtype))


@pytest.mark.parametrize("case,error,match", [
    ("float64", TypeError, "float32"),
    ("long_horizon", ValueError, "horizons up to 256"),
    ("other_device", ValueError, "different devices"),
])
def test_wrapper_check_refuses(case, error, match):
    """The wrapper takes what K1 takes; its input check reads no data, so it
    runs here (on the card every call passes through it)."""
    args = _check_args()
    if case == "float64":
        args = _check_args(dtype=torch.float64)
    elif case == "long_horizon":
        args = _check_args(h=r2.MAX_HORIZON + 1)
    elif case == "other_device":
        args = args[:1] + (torch.zeros((4, 2), device="meta"),) + args[2:]
    with pytest.raises(error, match=match):
        r2.check_inputs(*args)
    r2.check_inputs(*_check_args())


def test_wrapper_poses_drop_only_the_unit_sample_axis():
    lin = torch.zeros((3, 5, 7))
    assert r2.rover_poses(torch.zeros((3, 1, 2)), lin).shape == (3, 2)
    assert r2.rover_poses(torch.zeros((3, 2)), lin).shape == (3, 2)
    assert r2.rover_poses(torch.zeros((1, 2)), lin[0]).shape == (2,)
    assert r2.rover_poses(torch.zeros((2,)), lin[0]).shape == (2,)


def test_wrapper_copies_only_what_the_kernel_cannot_read():
    wrapper = r2.CudaRollout2d()
    v = torch.arange(4 * 6 * 10, dtype=torch.float32).reshape(4, 6, 10)
    rovers = v[::2]  # a rover stride only
    assert wrapper.packed(v) is v and wrapper.packed(rovers) is rovers
    assert wrapper.copies == 0
    strided = v[..., ::2]
    assert torch.equal(wrapper.packed(strided), strided) and wrapper.copies == 1


def test_mppi_step_2d_goes_through_the_wrapper_and_matches_jax(rng, monkeypatch):
    """Two chained 2D control steps (float64, injected noise): every sample
    rollout goes through the wrapper, and the step equals JAX's
    ``mppi_step`` at tests/test_torch_controller.py's tolerances."""
    calls = []
    wrapper = r2.rollout_2d_cuda

    def spy(*args):
        calls.append(args[3].shape)
        return wrapper(*args)

    monkeypatch.setattr(r2, "rollout_2d_cuda", spy)
    z = np.asarray(crater_surface(200, 25.0, [((-5.0, 8.0), 2.0, 6.0)], dtype=jnp.float64))
    jhf = JHeightField.create(z, 25.0, dtype=jnp.float64)
    jcm = as_costmap(np.random.default_rng(7).uniform(0, 0.9, (25, 25)) ** 4, 25.0,
                     dtype=jnp.float64)
    thf = convert.heightfield_from_numpy(*(np.asarray(a) for a in jhf))
    tcm = convert.costmap_from_numpy(*(np.asarray(a) for a in jcm))
    jcfg = jc.MPPIConfig(num_samples=24, horizon=30, projection="2d", return_rollouts=True)
    tcfg = convert.config_from_jax(jcfg)
    assert dataclasses.asdict(tcfg)["projection"] == "2d"
    jr = jc.RobotState.create(-10.0, -8.0, [1.0, 0.4, 0.0], dtype=jnp.float64)
    jctrl = jc.ControllerState.create(jcfg, jnp.float64)
    tr = convert.robot_state_from_numpy(*(np.asarray(a) for a in jr))
    tctrl = convert.controller_state_from_numpy(*(np.asarray(a) for a in jctrl))
    goal = np.array([15.0, 12.0])
    for _ in range(2):
        noise = rng.normal(size=(2, 24, 30))
        jctrl, jout = jax.jit(jc.mppi_step, static_argnums=0)(
            jcfg, jhf, jcm, jnp.asarray(goal), jr, jctrl, jnp.asarray(noise))
        tctrl, tout = tc.mppi_step(tcfg, thf, tcm, torch.from_numpy(goal), tr, tctrl,
                                   torch.from_numpy(noise))
        for name in ("rollouts", "optimal_trajectory", "optimal_linear", "optimal_angular"):
            np.testing.assert_allclose(np.asarray(getattr(tout, name)),
                                       np.asarray(getattr(jout, name)), rtol=0,
                                       atol=STEP_ATOL, err_msg=name)
        np.testing.assert_allclose(tout.costs.numpy(), np.asarray(jout.costs), rtol=1e-12)
        jr = jc.kinematic_advance(jcfg, jr, jout)
        tr = tc.kinematic_advance(tcfg, tr, tout)
    assert calls == [(24, 30)] * 2
