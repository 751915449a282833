"""PyTorch port: the copies of the NumPy oracles (``husky_rover_mppi_isaacsim_
torch/compat``) against the JAX package's originals.

Each function of a copy has the original's code (its bytecode, names and
constants, docstrings aside), and each is called on the same seeded inputs
through both modules with EQUAL results. The copies exist for the card's
runs (chip_smoke.py's ``k1_vs_oracle``), where the JAX package is absent.
"""

import inspect

import numpy as np
import pytest

from husky_rover_mppi_isaacsim_torch.compat import numpy_oracle as tno
from husky_rover_mppi_isaacsim_torch.compat import warp_oracle as two
from husky_rover_mppi_isaacsim_tpu.compat import numpy_oracle as jno
from husky_rover_mppi_isaacsim_tpu.compat import warp_oracle as jwo

PAIRS = {"numpy_oracle": (tno, jno), "warp_oracle": (two, jwo)}


def _functions(module):
    return {name: fn for name, fn in inspect.getmembers(module, inspect.isfunction)
            if fn.__module__ == module.__name__}


def _code_key(code):
    consts = code.co_consts
    if consts and isinstance(consts[0], str):  # the docstring
        consts = consts[1:]
    consts = tuple(_code_key(c) if inspect.iscode(c) else c for c in consts)
    return code.co_code, code.co_names, code.co_varnames, consts


@pytest.mark.parametrize("module", sorted(PAIRS))
def test_copies_have_the_originals_functions_and_code(module):
    copy, orig = PAIRS[module]
    got, want = _functions(copy), _functions(orig)
    assert sorted(got) == sorted(want) and len(want) >= 9
    for name, fn in want.items():
        assert _code_key(got[name].__code__) == _code_key(fn.__code__), name
        assert inspect.signature(got[name]) == inspect.signature(fn), name
    if module == "numpy_oracle":
        assert tno.REFERENCE_BUMPS == jno.REFERENCE_BUMPS


def _equal(a, b):
    if isinstance(a, tuple):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
    elif a is None or b is None:
        assert a is None and b is None
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_numpy_oracle_calls_equal(rng):
    args = (200, 20.0, tno.REFERENCE_BUMPS)
    _equal(tno.create_surface(*args), jno.create_surface(*args))
    _, _, z = tno.create_surface(*args)
    res = 40.0 / 200
    lin, ang = rng.uniform(0.5, 1.5, 60), rng.uniform(-0.5, 0.5, 60)
    for mod_args in [(1.0, -2.0, [1.0, 0.3, 0.0], lin, ang, 0.05, 60, res, z),
                     (18.9, 0.0, [1.0, 0.0, 0.0], lin * 4, ang, 0.05, 60, res, z)]:
        _equal(tno.generate_trajectory_25d(*mod_args), jno.generate_trajectory_25d(*mod_args))
    args2 = (-3.0, 4.0, [0.2, 1.0, 0.0], lin, ang, 0.05, 60)
    _equal(tno.generate_trajectory_2d(*args2), jno.generate_trajectory_2d(*args2))
    _equal(tno.generate_velocities(np.random.RandomState(4), 50, 1.0, 0.2, 0.0, 2.0),
           jno.generate_velocities(np.random.RandomState(4), 50, 1.0, 0.2, 0.0, 2.0))


def test_warp_oracle_calls_equal(rng):
    grid, hw = 128, 12.0
    z = rng.uniform(0.0, 2.0, (grid, grid))
    costmap = rng.uniform(0.0, 1.0, (64, 64))
    res = 2 * hw / grid
    k, h = 4, 30
    u1, u2 = rng.uniform(-1, 1, (k, h)), rng.uniform(-1, 1, (k, h))
    pert = (u1[0], u2[0], rng.standard_normal((2, k, h)), 0.3, 0.4, -1.0, 1.0, -1.0, 1.0)
    _equal(two.perturb(*pert), jwo.perturb(*pert))
    lag = (u1, u2, 0.1, -0.1, 0.5, -1.5, 1.5, -1.0, 1.0, 2.0, 0.8)
    _equal(two.wheel_lag(*lag), jwo.wheel_lag(*lag))
    lin, ang = jwo.wheel_lag(*lag)
    lin = np.abs(lin)
    outs = {}
    for mod in (two, jwo):
        roll = [mod.rollout_25d(z, -hw, -hw, res, (1.0, -2.0), (0.8, 0.6, 0.0), lin[s], ang[s],
                                0.05) for s in range(k)]
        roll2 = mod.rollout_2d(z, -hw, -hw, res, (1.0, -2.0), (0.8, 0.6, 0.0), lin[0], ang[0],
                               0.05)
        trajs, lws, rws = (np.stack([r[i] for r in roll]) for i in (0, 2, 3))
        costs = mod.evaluate_trajectories(1.0, -2.0, (8.0, 6.0), trajs, lws, rws, lin, 1.0,
                                          costmap, hw, 2 * hw / 64, 4.0)
        w = mod.softmax_weights(costs, 0.5)
        outs[mod] = (tuple(roll[0]), tuple(roll2), costs, w, mod.weighted_update(w, u1, u2),
                     mod.avoid_slope_critic(trajs[0]))
    _equal(outs[two], outs[jwo])
    assert np.isfinite(outs[two][2]).all()
