"""PyTorch port: ``graft_entry_torch.py``, the counterpart of
``__graft_entry__.py``, on the CPU. ``entry()``'s step (K=1000 x H=100) is
held against the JAX entry's step on the same world, state and noise, at
the float32 tolerances stated below; ``dryrun_multichip`` runs on gloo CPU ranks (2: a
(2, 1) mesh; 4: (2, 2), the sample axis sharded too) and holds every rover
to the unsharded ``mppi_step`` itself."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
import graft_entry_torch as tentry
from husky_rover_mppi_isaacsim_torch import convert
from husky_rover_mppi_isaacsim_torch.ops.rollout_cuda import rollout_25d_cuda

from test_torch_smallscale import CRATER_ATOL

# float32 over a 100-step horizon: a sample whose rollout differs in the
# last bits may read another nearest cell for a wheel height, so a few
# costs move by up to ~5e-4 relative (measured: 30 of 1000 samples above
# 1e-5 on the same DEM) while the rest agree to float32 rounding; the
# optimal inputs are the weighted sums of those samples
COSTS_RTOL, COSTS_SHARE_RTOL, COSTS_SHARE, U_ATOL = 1e-3, 1e-5, 0.95, 1e-6


def test_entry_step_matches_the_jax_entry():
    """The port's world is JAX's within the crater surface's float32 bound;
    on JAX's world the port's step gives JAX's costs, weights and optimal
    inputs within the tolerances above."""
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
    jhf, jcm, jgoal, jrobot, jctrl, _ = jargs
    # the crater surface's float32 exp differs from XLA's in the last bits
    np.testing.assert_allclose(hf.z.numpy(), np.asarray(jhf.z), rtol=0, atol=CRATER_ATOL)
    np.testing.assert_array_equal(cm.cost.numpy(), np.asarray(jcm.cost))
    jctrl_new, jout = jax.jit(jfn)(jhf, jcm, jgoal, jrobot, jctrl, jnp.asarray(noise.numpy()))
    thf = convert.heightfield_from_numpy(*(np.asarray(a) for a in jhf))
    new_ctrl, out = fn(thf, cm, goal, robot, ctrl, noise)
    want = np.asarray(jout.costs)
    rel = np.abs(out.costs.numpy() - want) / np.abs(want)
    assert rel.max() <= COSTS_RTOL and (rel <= COSTS_SHARE_RTOL).mean() >= COSTS_SHARE
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
