"""PyTorch port: ``graft_entry_torch.py``, the counterpart of
``__graft_entry__.py``, on the CPU. ``entry()``'s step (K=1000 x H=100) is
held against the JAX entry's step on the same world, state and noise, at
the float32 tolerances stated below; ``dryrun_multichip`` runs on gloo CPU ranks (2: a
(2, 1) mesh; 4: (2, 2), the sample axis sharded too) and holds every rover
to the unsharded ``mppi_step`` itself."""

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
import graft_entry_torch as tentry
from husky_rover_mppi_isaacsim_torch import convert
from husky_rover_mppi_isaacsim_torch.ops.rollout_cuda import rollout_25d_cuda

# float32 over a 100-step horizon: a sample whose rollout differs in the
# last bits may read another nearest cell for a wheel height, so a few
# costs move while the rest agree to float32 rounding; the optimal inputs
# are the weighted sums of those samples. Measured on the entry's key(0)
# noise: 40 of 1000 costs above 1e-5 relative (96% within), one above 1e-3
# (2.75e-3; the next 8.1e-4), weights and optimal inputs within 1e-6
COSTS_RTOL, COSTS_OUTLIER_RTOL, COSTS_OUTLIERS = 1e-3, 5e-3, 1
COSTS_SHARE_RTOL, COSTS_SHARE, U_ATOL = 1e-5, 0.95, 1e-6


def test_entry_step_matches_the_jax_entry():
    """The port's world is JAX's bit for bit and its noise is the JAX entry's ``key(0)`` draw bit for bit; on JAX's
    world and that noise the port's step gives JAX's costs, weights and
    optimal inputs within the tolerances above: every cost but at most
    ``COSTS_OUTLIERS`` within ``COSTS_RTOL``, those within
    ``COSTS_OUTLIER_RTOL``, and ``COSTS_SHARE`` of them within
    ``COSTS_SHARE_RTOL``."""
    fn, args = tentry.entry(device="cpu")
    hf, cm, goal, robot, ctrl, noise = args
    assert all(t.device.type == "cpu" for t in (hf.z, cm.cost, goal, noise))
    assert noise.shape == (2, 1000, 100) and noise.dtype == torch.float32
    before = rollout_25d_cuda.launches
    new_ctrl, out = fn(*args)
    assert rollout_25d_cuda.launches == before  # CPU tensors: the plain rollout
    assert out.costs.shape == (1000,) and torch.isfinite(out.costs).all()
    assert all(torch.isfinite(t).all() for t in new_ctrl)
    jfn, jargs = jentry.entry()
    jhf, jcm, jgoal, jrobot, jctrl, jnoise = jargs
    np.testing.assert_array_equal(noise.numpy(), np.asarray(jnoise))
    np.testing.assert_array_equal(hf.z.numpy(), np.asarray(jhf.z))  # XLA's float32 terrain
    np.testing.assert_array_equal(cm.cost.numpy(), np.asarray(jcm.cost))
    thf = convert.heightfield_from_numpy(*(np.asarray(a) for a in jhf))
    jctrl_new, jout = jax.jit(jfn)(*jargs)
    new_ctrl, out = fn(thf, cm, goal, robot, ctrl, noise)
    want = np.asarray(jout.costs)
    rel = np.abs(out.costs.numpy() - want) / np.abs(want)
    assert (rel > COSTS_RTOL).sum() <= COSTS_OUTLIERS and rel.max() <= COSTS_OUTLIER_RTOL
    assert (rel <= COSTS_SHARE_RTOL).mean() >= COSTS_SHARE
    np.testing.assert_allclose(out.weights.numpy(), np.asarray(jout.weights), rtol=0,
                               atol=U_ATOL)
    for a, b in zip(new_ctrl, jctrl_new):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=U_ATOL)


@pytest.mark.parametrize("n,mesh", [(2, [2, 1]), (4, [2, 2])])
def test_dryrun_multichip_on_gloo_cpu_ranks(tmp_path, n, mesh):
    report = tentry.dryrun_multichip(n, device="cpu", workdir=tmp_path)
    assert report["mesh"] == mesh and report["rovers"] == 2 * mesh[0]
    assert report["K"] == 8 * mesh[1] and report["H"] == 8
    assert len(report["max_abs_diff"]) == report["rovers"]
    assert report["k1_launches_per_rank"] == [0] * n  # CPU ranks: the plain rollout
