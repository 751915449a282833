"""PyTorch port: the exact EDT and kernel K2's wrapper (ops/edt.py,
ops/edt_cuda.py) against the JAX package's exact EDT and its Pallas
min-plus kernel in interpret mode, with exact equality: every finite squared
distance is an integer, exact in float32, and the obstacle-free map's
sentinel comes from one float32 add in both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch.ops import edt as tedt
from husky_rover_mppi_isaacsim_torch.ops import edt_cuda
from husky_rover_mppi_isaacsim_tpu.ops import edt as jedt
from husky_rover_mppi_isaacsim_tpu.ops.edt_pallas import edt_minplus_pallas

# small tensors: one intra-op thread each, so that the test workers running
# beside these do not lose their cores
torch.set_num_threads(1)


def _corner(rows, cols):
    occ = np.zeros((rows, cols), bool)
    occ[-1, 0] = True
    return occ


MAPS = {
    "square_64": lambda: np.random.default_rng(1).random((64, 64)) < 0.02,
    "non_square_37x53": lambda: np.random.default_rng(2).random((37, 53)) < 0.03,
    "non_multiple_130x257": lambda: np.random.default_rng(3).random((130, 257)) < 0.01,
    "obstacle_free_45x70": lambda: np.zeros((45, 70), bool),
    "all_obstacle_33x33": lambda: np.ones((33, 33), bool),
    "corner_obstacle_50x41": lambda: _corner(50, 41),
}


@pytest.mark.parametrize("name", list(MAPS))
def test_edt_exact_sq_equals_jax_and_pallas(name):
    occ = MAPS[name]()
    before = edt_cuda.edt_minplus_cuda.launches
    got = tedt.edt_exact_sq(torch.from_numpy(occ))
    assert got.dtype == torch.float32 and got.shape == occ.shape
    assert edt_cuda.edt_minplus_cuda.launches == before  # CPU: the plain envelope
    g = jedt._row_distances(jnp.asarray(occ))
    pallas = np.asarray(edt_minplus_pallas(jnp.minimum(g * g, 1e12), block=32,
                                           interpret=True))
    np.testing.assert_array_equal(got.numpy(), pallas)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jedt.edt_exact_sq(jnp.asarray(occ))))
    assert torch.equal(got, tedt.edt_exact_sq_plain(torch.from_numpy(occ)))


def test_envelope_stages_and_edge_values():
    occ = _corner(50, 41)
    g2 = tedt.row_distances_sq(torch.from_numpy(occ))
    d2 = tedt.minplus_envelope(g2)
    ys, xs = np.mgrid[0:50, 0:41]
    np.testing.assert_array_equal(d2.numpy(), ((ys - 49) ** 2 + xs ** 2).astype(np.float32))
    free = tedt.edt_exact_sq(torch.zeros((5, 7), dtype=torch.bool))
    assert torch.all(free >= 1e12) and torch.all(torch.isfinite(free))
    assert torch.equal(tedt.edt_exact_sq(torch.ones((5, 7), dtype=torch.bool)),
                       torch.zeros((5, 7)))


def test_k2_wrapper_on_cpu_runs_the_plain_version():
    g2 = tedt.row_distances_sq(torch.from_numpy(MAPS["non_square_37x53"]()))
    k2 = edt_cuda.CudaMinPlus()
    assert torch.equal(k2(g2), tedt.minplus_envelope(g2))
    assert k2.launches == 0 and k2.built is None  # no launch, nothing built


@pytest.mark.parametrize("bad,error,match", [
    (torch.empty((edt_cuda.MAX_ROWS + 1, 8)), ValueError, "4096 rows"),
    (torch.empty((16, 8), dtype=torch.float64), TypeError, "float32"),
    (torch.empty((8, 16)).t(), ValueError, "contiguous"),
    (torch.empty((2, 8, 8)), ValueError, r"\(R, C\)"),
], ids=["rows_over_4096", "float64", "non_contiguous", "three_dims"])
def test_k2_refuses_what_it_does_not_take(bad, error, match):
    """The checks the wrapper makes before a CUDA launch; they read no
    data, so they run here on CPU tensors."""
    with pytest.raises(error, match=match):
        edt_cuda.check_input(bad)
    edt_cuda.check_input(torch.empty((edt_cuda.MAX_ROWS, 8)))


def test_k2_launch_refuses_mismatched_output():
    k2 = edt_cuda.CudaMinPlus()
    g2 = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="device"):
        k2.launch(g2, torch.zeros((4, 4), device="meta"))
    with pytest.raises(ValueError, match="shape"):
        k2.launch(g2, torch.zeros((4, 5)))
    assert k2.launches == 0
