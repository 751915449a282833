"""PyTorch port: the thesis protocol's control step at full width against
the JAX package's, on the CPU.

The r05 configuration (``EVAL_r05.json``): K=1000 x H=100, the 3D arm with
the body slope critic, slope weight 35.5, sigma floor 0.3, optimal inputs
and wheel speeds starting at 1 m/s, on the seed-42 thesis terrain at
z = 0.7 (150 m at 0.1 m/px) with the 750-obstacle costmap, from the
protocol's first start, goal and heading. Ten control loops; each starts
from JAX's state (JAX's ``mppi_step`` + ``kinematic_advance``) with JAX's
noise for that loop (the protocol's key ``seed * 1000 + run``, split per
loop as ``goal_seek_recorded`` splits it), on JAX's world converted.

float64: every field agrees to the summation order (costs rtol 1e-10).

float32, the dtype the protocol runs in: the commanded velocities, the
optimal inputs, their stds and the weights agree within 1e-6 (measured
~6e-8: the weights put their mass on one sample, the same in both). Most
costs agree to float32 rounding (at least 97% within 1e-5 relative,
measured >= 98%), but a sample whose float32 rollout reads another nearest
cell or crosses a costmap step at one of its 100 steps moves by up to ~1%
(measured 1.2e-2 relative, once in ten loops): ``COSTS_RTOL`` 2e-2. The
float64 case shows the step's arithmetic is JAX's; the float32 one is what
a protocol run computes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch import convert
from husky_rover_mppi_isaacsim_torch.mppi import controller as tc
from husky_rover_mppi_isaacsim_torch.mppi import evaluation as tev
from husky_rover_mppi_isaacsim_tpu.core import HeightField as JHeightField
from husky_rover_mppi_isaacsim_tpu.mppi import controller as jc
from husky_rover_mppi_isaacsim_tpu.mppi import critics as jcrit
from husky_rover_mppi_isaacsim_tpu.terrain import costmap_750, thesis_statistics_terrain

K, H, LOOPS, Z_SCALE, SEED, RUN = 1000, 100, 10, 0.7, 42, 0
# dtype -> (costs: rtol on every sample, rtol on COSTS_SHARE of them;
#           weights, optimal inputs, stds and velocities: atol)
TOL = {"float64": (1e-10, 1e-10, 1e-12), "float32": (2e-2, 1e-5, 1e-6)}
COSTS_SHARE = 0.97

_jstep = jax.jit(jc.mppi_step, static_argnums=0)
_jadvance = jax.jit(jc.kinematic_advance, static_argnums=0)


def _jax_config():
    return jc.MPPIConfig(num_samples=K, horizon=H, projection="3d",
                         critic_weights=jcrit.CriticWeights(slope_wheels=35.5),
                         sigma_base=0.3, slope_critic="body")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_thesis_step_at_full_width_matches_jax(dtype):
    costs_rtol, share_rtol, atol = TOL[dtype]
    jdtype = getattr(jnp, dtype)
    with jax.enable_x64(dtype == "float64"):
        z = thesis_statistics_terrain(seed=SEED, size_m=150.0, z_scale=Z_SCALE,
                                      max_elevation=1.2 * Z_SCALE,
                                      min_elevation=-1.2 * Z_SCALE)
        jhf = JHeightField.create(z, 75.0, dtype=jdtype)
        jcm = costmap_750(half_width=75.0, size=1500, use_exact_edt=True)
        jcfg = _jax_config()
        start, goal, heading = tev.thesis_pairs(64, 75.0, SEED)[RUN]
        robot = jc.RobotState.create(start[0], start[1], heading, dtype=jdtype, wheel_speed=1.0)
        ctrl = jc.ControllerState.create(jcfg, jdtype, initial_u=1.0)
        jgoal = jnp.asarray(goal, jdtype)
        key = jax.random.key(SEED * 1000 + RUN)
        steps = []
        for _ in range(LOOPS):
            key, sub = jax.random.split(key)
            noise = jc.sample_noise(sub, K, H, jdtype)
            jctrl, jout = _jstep(jcfg, jhf, jcm, jgoal, robot, ctrl, noise)
            steps.append((robot, ctrl, noise, jctrl, jout))
            robot, ctrl = _jadvance(jcfg, robot, jout), jctrl
    assert np.asarray(jhf.z).dtype == np.dtype(dtype) and np.asarray(jhf.z).shape == (1500, 1500)

    thf = convert.heightfield_from_numpy(*(np.asarray(a) for a in jhf))
    tcm = convert.costmap_from_numpy(*(np.asarray(a) for a in jcm))
    cfg = convert.config_from_jax(jcfg)
    assert (cfg.slope_critic, cfg.sigma_base, cfg.critic_weights.slope_wheels) == \
        ("body", 0.3, 35.5)
    moved = 0.0
    for loop, (jrobot, jctrl0, noise, jctrl, jout) in enumerate(steps):
        robot = convert.robot_state_from_numpy(*(np.asarray(a) for a in jrobot))
        ctrl = convert.controller_state_from_numpy(*(np.asarray(a) for a in jctrl0))
        new_ctrl, out = tc.mppi_step(cfg, thf, tcm, _t(jgoal), robot, ctrl, _t(noise))
        assert out.costs.dtype == getattr(torch, dtype)
        want = np.asarray(jout.costs)
        rel = np.abs(out.costs.numpy() - want) / np.abs(want)
        assert rel.max() <= costs_rtol, (loop, rel.max())
        assert (rel <= share_rtol).mean() >= COSTS_SHARE, (loop, (rel <= share_rtol).mean())
        np.testing.assert_allclose(out.weights.numpy(), np.asarray(jout.weights), rtol=0,
                                   atol=atol, err_msg=f"weights, loop {loop}")
        for name, a, b in zip(new_ctrl._fields, new_ctrl, jctrl):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=atol,
                                       err_msg=f"{name}, loop {loop}")
        for name in ("linear_velocity", "angular_velocity"):
            np.testing.assert_allclose(getattr(out, name).numpy(), np.asarray(getattr(jout, name)),
                                       rtol=0, atol=atol, err_msg=f"{name}, loop {loop}")
        moved = float(np.linalg.norm(np.asarray(jout.optimal_trajectory[0, :2])
                                     - np.asarray(start)))
    assert moved > 0.1  # the rover drove
