"""The frozen kernel counts reproduce the bounds PERF.md gives at its
shapes (chip_smoke.py's arithmetic, commit c6c4900)."""

import pytest

from rover_bench.harness import registry

k1 = registry.load_module("counts", "k1")
jn = registry.load_module("counts", "jax_normal")
k2 = registry.load_module("counts", "k2")
crater = registry.load_module("counts", "crater_block")
ups = registry.load_module("counts", "upsample")

# the draw's value shares PERF.md measured (35.7% on log1p's log side, 0.3%
# at w >= 5)
SHARES = {"common": 1.0, "rational": 1 - 0.357, "log": 0.357, "w_lt5": 0.997, "w_ge5": 0.003}


def test_k1_bound_at_k1000_h100():
    # a rollout at K=1000 x H=100 on the 1500^2 DEM reads some thousands of cells
    t, by = k1.bound_s(1, 1000, 100, True, 5000)
    assert by == "bytes" and round(t * 1e6, 2) == 1.68
    assert round(k1.bound_s(1, 1000, 100, True, 0)[0] * 1e6, 2) == 1.67


@pytest.mark.parametrize("shape,us", [((2, 1000, 100), 0.98), ((2, 16384, 64), 10.3)])
def test_jax_normal_bound(shape, us):
    n = shape[0] * shape[1] * shape[2]
    t, by = jn.bound_s(n, SHARES, 1980e6)
    assert by == "alu"
    assert round(t * 1e6, 2 if us < 1 else 1) == us
    assert round(jn.per_value(SHARES)["alu"], 1) == 82.2


@pytest.mark.parametrize("side,ms", [(875, 0.0300), (1500, 0.1511), (750, 0.0189)])
def test_k2_bound(side, ms):
    t, by = k2.bound_s(side, side)
    assert by == "operations" and round(t * 1e3, 4) == ms


def test_crater_and_upsample_counts_are_positive_and_bytes_or_ops():
    t, by = crater.bound_s(2_800_000, 2_600_000, 700, 300, 256)
    assert t > 0 and by in ("bytes", "operations")
    t, by = ups.bound_s(9, 9, 1000, 1000)
    assert by == "bytes" and round(t * 1e6, 1) == 1.2


def test_every_count_names_its_kernels():
    for name in registry.names("counts", ".py"):
        mod = registry.load_module("counts", name)
        if name != "peaks":
            assert mod.SYMBOLS and all(isinstance(s, str) and s for s in mod.SYMBOLS)
