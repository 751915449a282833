"""PyTorch port: the block upsample (``terrain/upsample.py::upsample_block``,
on the card one launch of ``csrc/upsample_taps.cu``) against the JAX
package's ``upsample_bicubic(lr, f)[r0:r0+R, c0:c0+C]``, float32 from a
numpy seed, bit for bit.

Each element takes XLA's GEMV order by its column in the full pass (the
LR column c in the row pass, the HR row h in the column pass): fused from
zero inside the 8-wide tiles, a lone left-over column unfused, a longer
tail chained from its first product. So the crops here start and end
inside a tile and reach the tails of one and of several columns, in both
passes. On the CPU the call runs the plain version (both passes, then the
slice); ``tests/test_torch_gpu.py`` holds the kernel to it on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch.terrain import streaming as tstream
from husky_rover_mppi_isaacsim_torch.terrain import upsample as tup
from husky_rover_mppi_isaacsim_torch.terrain.craters import CraterSamplerConf as TCraterConf
from husky_rover_mppi_isaacsim_tpu.terrain import map_manager as jmap
from husky_rover_mppi_isaacsim_tpu.terrain import streaming as jstream
from husky_rover_mppi_isaacsim_tpu.terrain import upsample as jup
from husky_rover_mppi_isaacsim_tpu.terrain.craters import CraterSamplerConf as JCraterConf

# (LR shape, factor, crop start, crop size or None for the rest); beside
# each, the pass widths n_c (row pass) and n_r * f (column pass)
BLOCK_CASES = {
    # the streamed block: 9 x 9 by 200, the kept [400:1400]^2 (n_c 9, 1800)
    "streamed_block": ((9, 9), 200, (400, 400), (1000, 1000)),
    # start and end inside an 8-wide tile of both passes (9, 180)
    "mid_tile": ((9, 9), 20, (3, 5), (45, 91)),
    # the column pass's tail of five rows (21 = 16 + 5), the row pass's of
    # four columns (12 = 8 + 4)
    "several_column_tails": ((7, 12), 3, (13, 20), (8, 16)),
    # a lone left-over row (25 = 24 + 1) and a lone LR column (9 = 8 + 1)
    "single_column_tails": ((5, 9), 5, (17, 30), (8, 15)),
    # n_c = 17: a lone LR column after two tiles; 42 = 40 + 2 HR rows
    "n_c_17": ((6, 17), 7, (5, 100), (37, 19)),
    # 27 = 24 + 3 rows, 12 = 8 + 4 columns, a crop across both tails
    "both_tails": ((9, 12), 3, (1, 2), (25, 33)),
    # factor 1: a pass narrower than one tile (all tail)
    "factor_1": ((4, 6), 1, (1, 2), (3, 3)),
    # one pixel, the last of the streamed block's upsample
    "last_pixel": ((9, 9), 200, (1799, 1799), (1, 1)),
    # the full crop, n_c 17 (one lone column), 3 * 2 = 6 rows (all tail)
    "full_3x17": ((3, 17), 2, (0, 0), None),
    "full_9x9": ((9, 9), 20, (0, 0), None),
}


def _lr(shape, seed):
    return np.random.default_rng(seed).normal(0.0, 50.0, shape).astype(np.float32)


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_upsample_block_matches_jax_crop(case):
    shape, factor, (r0, c0), size = BLOCK_CASES[case]
    lr = _lr(shape, seed=sum(map(ord, case)))
    full = np.asarray(jup.upsample_bicubic(jnp.asarray(lr), factor))
    rows, cols = size if size is not None else (full.shape[0] - r0, full.shape[1] - c0)
    want = full[r0:r0 + rows, c0:c0 + cols]
    got = tup.upsample_block(torch.from_numpy(lr), factor, (r0, c0), size)
    assert got.is_contiguous() and tuple(got.shape) == (rows, cols)
    np.testing.assert_array_equal(got.numpy(), want)
    if size is None:  # the full crop is the upsample
        np.testing.assert_array_equal(tup.upsample_bicubic(torch.from_numpy(lr), factor).numpy(),
                                      full)


def test_axis_tables_are_built_once_per_key():
    kw, idx = tup.axis_tables(9, 200, torch.float32, "cpu")
    again = tup.axis_tables(9, 200, torch.float32, torch.device("cpu"))
    assert again[0] is kw and again[1] is idx
    kw64, _ = tup.axis_tables(9, 200, torch.float64, "cpu")
    assert kw64 is not kw and kw64.dtype == torch.float64
    assert tup.axis_tables(9, 20, torch.float32, "cpu")[0] is not kw
    assert kw.shape == idx.shape == (1800, 4) and idx.dtype == torch.int32
    assert int(idx.min()) == 0 and int(idx.max()) == 8
    # indices nondecreasing down each tap (the kernel's span of LR columns)
    assert bool((idx[1:] >= idx[:-1]).all())
    np.testing.assert_allclose(kw.double().sum(1).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("start,size", [((-1, 0), (4, 4)), ((0, 0), (19, 4)),
                                        ((10, 0), (9, 4)), ((0, 0), (0, 4))])
def test_upsample_block_refuses_a_crop_off_the_upsample(start, size):
    with pytest.raises(ValueError, match="leaves"):
        tup.upsample_block(torch.zeros((6, 6)), 3, start, size)


def test_build_block_base_is_jax_block_contiguous():
    """The streamer's block without craters is the upsample's kept base,
    as JAX's ``build_block`` slices it, and it is contiguous."""
    kw = dict(block_size=10.0, resolution=0.1, lr_resolution=2.0, num_blocks=1, pad_size=2.0,
              seed=57, generate_craters=False)
    lr = jmap.synthetic_lola_dem(256, 2.0, seed=42)
    js = jstream.TerrainStreamer(
        jstream.StreamerConf(crater=JCraterConf(seed=57), native_pool="never", **kw), lr)
    ts = tstream.TerrainStreamer(
        tstream.StreamerConf(crater=TCraterConf(seed=57), native_pool="never", **kw), lr,
        device="cpu")
    for block in ((0, 0), (1, -1)):
        got = ts.build_block(*block)
        assert got.is_contiguous() and tuple(got.shape) == (100, 100)
        np.testing.assert_array_equal(got.numpy(), np.asarray(js.build_block(*block)))


def test_blocks_built_counts_each_block_once():
    """``blocks_built`` (what the card's traverses hold the upsample's
    launches to) counts a block when it is built, not when the cache
    returns it."""
    kw = dict(block_size=10.0, resolution=0.1, lr_resolution=2.0, num_blocks=1, pad_size=2.0,
              seed=57, generate_craters=False)
    lr = jmap.synthetic_lola_dem(256, 2.0, seed=42)
    ts = tstream.TerrainStreamer(
        tstream.StreamerConf(crater=TCraterConf(seed=57), native_pool="never", **kw), lr,
        device="cpu")
    assert ts.blocks_built == 0
    first = ts.build_block(0, 0)
    assert ts.build_block(0, 0) is first and ts.blocks_built == 1
    assert ts.bulk_build([(0, 0), (1, 0), (0, 1)]) == 2 and ts.blocks_built == 3
