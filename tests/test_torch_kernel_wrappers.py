"""PyTorch port: what the kernel wrappers check and prepare before a launch,
on the CPU (the launches themselves are in tests/test_torch_gpu.py).

K1's wrapper (ops/rollout_cuda.py) refuses inputs its kernel does not take
and copies only velocities whose (K, H) part is not contiguous; the
measurement helpers (ops/measure.py) tell views from device operators."""

import pytest
import torch

from husky_rover_mppi_isaacsim_torch.core import HeightField
from husky_rover_mppi_isaacsim_torch.ops import measure
from husky_rover_mppi_isaacsim_torch.ops import rollout_cuda as rc

torch.set_num_threads(1)


def _inputs(lead=(), k=5, h=7, dtype=torch.float32):
    hf = HeightField.create(torch.zeros((16, 16), dtype=dtype), 4.0)
    return (hf, torch.zeros(lead + (2,), dtype=dtype), torch.ones(lead + (3,), dtype=dtype),
            torch.ones(lead + (k, h), dtype=dtype), torch.ones(lead + (k, h), dtype=dtype))


@pytest.mark.parametrize("lead", [(), (1,), (4,)])
def test_k1_check_takes_one_rover_and_n_rovers(lead):
    rc.check_inputs(*_inputs(lead))


@pytest.mark.parametrize("case,error,match", [
    ("float64", TypeError, "float32"),
    ("velocity_shapes", ValueError, r"\(K, H\) or \(N, K, H\)"),
    ("flat_velocities", ValueError, r"\(K, H\) or \(N, K, H\)"),
    ("pose_without_rover_axis", ValueError, "position"),
    ("rover_axis_mismatch", ValueError, "heading"),
    ("too_many_rovers", ValueError, "1 to 65535 rovers"),
    ("long_horizon", ValueError, "horizons up to 256"),
    ("other_device", ValueError, "different devices"),
    ("dem_not_2d", ValueError, "contiguous"),
    ("window_scalar_not_0d", ValueError, "0-d"),
])
def test_k1_check_refuses(case, error, match):
    hf, pos, head, lin, ang = _inputs((4,))
    if case == "float64":
        hf, pos, head, lin, ang = _inputs((4,), dtype=torch.float64)
    elif case == "velocity_shapes":
        ang = ang[..., :3]
    elif case == "flat_velocities":
        lin, ang = lin[0, 0], ang[0, 0]
    elif case == "pose_without_rover_axis":
        pos, head = pos[0], head[0]
    elif case == "rover_axis_mismatch":
        head = head[:2]
    elif case == "too_many_rovers":
        hf, pos, head, lin, ang = _inputs((rc.MAX_ROVERS + 1,), k=1, h=1)
    elif case == "long_horizon":
        hf, pos, head, lin, ang = _inputs((4,), h=rc.MAX_HORIZON + 1)
    elif case == "other_device":
        pos = torch.zeros((4, 2), device="meta")
    elif case == "dem_not_2d":
        hf = hf._replace(z=hf.z[None])
    elif case == "window_scalar_not_0d":
        hf = hf._replace(resolution=hf.resolution[None])
    with pytest.raises(error, match=match):
        rc.check_inputs(hf, pos, head, lin, ang)


@pytest.mark.parametrize("make,copies", [
    (lambda v: v, 0),                                       # (N, K, H) contiguous
    (lambda v: v[:, :1], 0),                                # K = 1 rows of a larger batch
    (lambda v: v[::2], 0),                                  # a rover stride only
    (lambda v: v.transpose(1, 2).contiguous().transpose(1, 2), 1),  # H-major
    (lambda v: v[..., ::2], 1),                             # strided horizon
])
def test_k1_wrapper_copies_only_what_the_kernel_cannot_read(make, copies):
    k1 = rc.CudaRollout()
    v = make(torch.arange(4 * 6 * 10, dtype=torch.float32).reshape(4, 6, 10))
    got = k1.packed(v)
    assert k1.copies == copies
    assert torch.equal(got, v)
    assert (got is v) == (copies == 0)
    assert got.stride(-1) == 1 and (got.shape[-2] == 1 or got.stride(-2) == got.shape[-1])


def test_op_log_counts_device_operators_not_views():
    x = torch.ones((3, 4))
    with measure.OpLog() as log:
        y = torch.empty((2, 3, 4))
        y.permute(2, 1, 0)[..., 0:1]
        (x + 1).sum()
    assert [str(f) for f in log.device_ops] == [
        "aten.empty.memory_format", "aten.add.Tensor", "aten.sum.default"]
    assert len(log.ops) > len(log.device_ops)
