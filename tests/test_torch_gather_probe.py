"""PyTorch port: kernel K3's plain formulations, its wrapper's CPU path
and refusals, and its probe entry point, against the JAX probe kernels of
scripts/probe_pallas_gather.py run with ``pl.pallas_call(...,
interpret=True)`` on the CPU, fed the same numpy table and indices. A gather
does no arithmetic: every comparison is bit for bit.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from husky_rover_mppi_isaacsim_torch.ops import gather_probe as gp

torch.set_num_threads(1)

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "probe_pallas_gather.py"


@pytest.fixture(scope="module")
def probe():
    spec = importlib.util.spec_from_file_location("probe_pallas_gather", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _interpret(kernel, table, i, j):
    """The script's pallas_call of ``kernel``, in interpret mode."""
    vmem = pl.BlockSpec(memory_space=pltpu.VMEM)
    out = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct(i.shape, jnp.float32),
                         in_specs=[vmem, vmem, vmem], out_specs=vmem,
                         interpret=True)(jnp.asarray(table), jnp.asarray(i), jnp.asarray(j))
    return np.asarray(out)


def _inputs(kind, p, k, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "arange":  # the script's table
        table = np.arange(p * p, dtype=np.float32).reshape(p, p)
    else:  # every bit pattern matters: negative, tiny and large values
        table = (rng.standard_normal((p, p)) * 10.0 ** rng.integers(-30, 30, (p, p)))
        table = table.astype(np.float32)
    i, j = (rng.integers(0, p, k, dtype=np.int32) for _ in range(2))
    return table, i, j


@pytest.mark.parametrize("name,kernel", [("flat torch.take", "k_flat_take"),
                                         ("advanced getitem", "k_getitem"),
                                         ("index_select rows + gather", "k_take_along")])
@pytest.mark.parametrize("kind", ["arange", "random"])
def test_plain_formulations_equal_the_jax_probe(probe, name, kernel, kind):
    """At the probe's shapes (P=256 table, K=1024 lanes)."""
    table, i, j = _inputs(kind, probe.P, probe.K)
    want = _interpret(getattr(probe, kernel), table, i, j)
    np.testing.assert_array_equal(want, table[j, i])
    t = [torch.from_numpy(a) for a in (table, i, j)]
    got = gp.FORMULATIONS[name](*t)
    assert got.dtype == torch.float32 and got.shape == (probe.K,)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(gp.gather_probe_cuda(*t).numpy(), want)


def test_wrapper_on_cpu_runs_the_plain_version_and_refuses(probe):
    table, i, j = (torch.from_numpy(a) for a in _inputs("random", 16, 40))
    before = gp.gather_probe_cuda.launches
    assert torch.equal(gp.gather_probe_cuda(table, i, j), table[j.long(), i.long()])
    assert gp.gather_probe_cuda.launches == before  # CPU tensors: no launch
    with pytest.raises(TypeError, match="float32"):
        gp.gather_probe_cuda(table.double(), i, j)
    with pytest.raises(TypeError, match="int32"):
        gp.gather_probe_cuda(table, i.long(), j)
    with pytest.raises(ValueError, match="table"):
        gp.gather_probe_cuda(table[0], i, j)
    with pytest.raises(ValueError, match="index vectors"):
        gp.gather_probe_cuda(table, i, j[:3])
    assert (probe.P, probe.K) == (gp.P, gp.K)


def test_probe_entry_point_on_cpu(capsys, monkeypatch):
    assert gp.main(["device=cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[:3] == [f"{name}: COMPILED, correct=True" for name in gp.FORMULATIONS]
    assert lines[3].startswith("cuda kernel gather_probe_f32: NOT RUN")
    table, i, j = gp.probe_inputs()
    assert table.shape == (256, 256) and i.dtype == j.dtype == torch.int32
    assert i.shape == j.shape == (1024,) and not torch.equal(i, j)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gp.main([])
