"""PyTorch port: the wheel terramechanics solver and the scene config
(physics/), the stellar engine (aux/stellar.py, the port's own copy) and the
scoped timer (utils/timer.py) against the JAX package.

The solver is float32 on both sides: 32-point Gauss-Legendre sums of stress
profiles whose terms reach ~1e7 N, summed in another order (XLA fuses the
four integrals of a force): they differ by up to 1.3e-6 of the largest
magnitude over the batch, held to TERRA_RTOL = 1e-5 of it. The stellar
engine is the same float64 numpy code: exact."""

import dataclasses
import datetime

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch import physics as tphys
from husky_rover_mppi_isaacsim_torch.aux import stellar as tst
from husky_rover_mppi_isaacsim_torch.utils import timer as ttimer
from husky_rover_mppi_isaacsim_tpu import physics as jphys
from husky_rover_mppi_isaacsim_tpu.aux import stellar as jst

# small tensors: one intra-op thread each, so that the test workers running
# beside these do not lose their cores
torch.set_num_threads(1)

TERRA_RTOL = 1e-5


def _wheels(seed=7, n=(3, 4)):
    """Velocities, wheel speeds and sinkages of a (rover, wheel) batch:
    driving and braking slip, sinkage from 0 to 5 cm."""
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.05, 1.2, n).astype(np.float32),
            rng.uniform(0.5, 8.0, n).astype(np.float32),
            rng.uniform(0.0, 0.05, n).astype(np.float32))


@pytest.mark.parametrize("terrain_kw", [{}, {"c": 900.0, "phi": 0.5, "n": 1.1}])
def test_solver_forces_and_torques_match_jax(terrain_kw):
    v, omega, sink = _wheels()
    robot = dict(wheel_radius=0.2, wheel_base=0.3)
    tsolver = tphys.TerramechanicsSolver(tphys.RobotParameter(**robot),
                                         tphys.TerrainMechanicalParameter(**terrain_kw))
    jsolver = jphys.TerramechanicsSolver(jphys.RobotParameter(**robot),
                                         jphys.TerrainMechanicalParameter(**terrain_kw))
    np.testing.assert_allclose(
        tsolver.slip_ratio(torch.from_numpy(v), torch.from_numpy(omega)).numpy(),
        np.asarray(jsolver.slip_ratio(jnp.asarray(v), jnp.asarray(omega))), rtol=1e-6)
    forces, torques = tsolver.compute_force_and_torque(torch.from_numpy(v),
                                                       torch.from_numpy(omega),
                                                       torch.from_numpy(sink))
    jforces, jtorques = (np.asarray(a) for a in jsolver.compute_force_and_torque(v, omega, sink))
    assert forces.shape == torques.shape == jforces.shape == (3, 4, 3)
    assert forces.dtype == torch.float32
    for got, want in ((forces.numpy(), jforces), (torques.numpy(), jtorques)):
        scale = np.abs(want).reshape(-1, 3).max(axis=0)
        np.testing.assert_allclose(got, want, rtol=0, atol=TERRA_RTOL * scale.max())
        assert np.array_equal(got == 0, want == 0)  # the zero components stay zero


def test_solver_broadcasts_scalars_like_jax():
    v = np.float32([0.3, 0.6])
    forces, _ = tphys.TerramechanicsSolver().compute_force_and_torque(torch.from_numpy(v), 3.0,
                                                                     0.01)
    jforces, _ = jphys.TerramechanicsSolver().compute_force_and_torque(v, 3.0, 0.01)
    np.testing.assert_allclose(forces.numpy(), np.asarray(jforces), rtol=0,
                               atol=TERRA_RTOL * np.abs(np.asarray(jforces)).max())


def test_config_classes_have_the_jax_defaults():
    for name in ("PhysicsSceneConf", "RobotParameter", "TerrainMechanicalParameter"):
        assert dataclasses.asdict(getattr(tphys, name)()) == \
            dataclasses.asdict(getattr(jphys, name)())
    assert dataclasses.asdict(tst.StellarEngineConf()) == \
        dataclasses.asdict(jst.StellarEngineConf())
    assert set(tphys.__all__) == set(jphys.__all__)


@pytest.mark.parametrize("when,lat,lon", [((2024, 5, 1, 12, 0), -26.0, 46.8),
                                          ((2031, 11, 17, 3, 41), -89.5, 0.0),
                                          ((2026, 2, 28, 23, 59), 12.3, -140.0)])
def test_stellar_engine_equals_jax(when, lat, lon):
    """Sun and Earth alt-az, distances, site positions and light
    quaternions: the same numbers, also after time steps through the
    update gate."""
    engines = [pkg.StellarEngine(pkg.StellarEngineConf(start_date=pkg.Date(*when), lat=lat,
                                                       lon=lon, time_scale=60.0))
               for pkg in (tst, jst)]
    for dt in (0.0, 5.0, 11.0, 3600.0):
        gates = [e.update(dt) for e in engines]
        assert gates[0] == gates[1]
        for body in ("sun", "earth"):
            a, b = (e.get_alt_az(body) for e in engines)
            assert a == b
            assert engines[0].get_local_position(body) == engines[1].get_local_position(body)
            assert tst.StellarEngine.convert_alt_az_to_quat(*a[:2]) == \
                jst.StellarEngine.convert_alt_az_to_quat(*b[:2])
    when2 = datetime.datetime(2030, 1, 1, tzinfo=datetime.timezone.utc)
    for e in engines:
        e.set_time(when2)
        e.set_lat_lon(10.0, 20.0)
    assert engines[0].get_alt_az("sun") == engines[1].get_alt_az("sun")


def test_scoped_timer_nests_and_times_callables():
    lines = []
    with ttimer.ScopedTimer("outer", print_fn=lines.append) as outer:
        with ttimer.ScopedTimer("inner", print_fn=lines.append, trace=True) as inner:
            x = torch.ones(1000).cumsum(0)
    assert lines[0].startswith("  [inner]") and lines[1].startswith("[outer]")
    assert outer.elapsed >= inner.elapsed > 0.0
    with ttimer.block_until_ready(x):
        x = x * 2
    assert ttimer.timed(torch.mm, torch.ones(8, 8), torch.ones(8, 8), iters=3, warmup=1) > 0.0
    assert ttimer.wait_for({"a": [x, 1]}) == {"a": [x, 1]}
