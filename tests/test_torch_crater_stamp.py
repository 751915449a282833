"""PyTorch port: the crater stamp on the CPU (``stamp_patches``, the stamp
of the crater block's plain version, which the card's crater block kernel
is held bit-equal to by ``chip_smoke.py`` and ``tests/test_torch_gpu.py``)
and the capacity-padded radius tiers that feed it, against the JAX package
and against the port's earlier route (live craters only, patches rendered
256 at a time, one slice add each).

Tolerances: the stamp of a padded tier is ``torch.equal`` to the live-only
loop (the same float32 adds in the same order; one intra-op thread, so that
no transcendental lands on another vector lane when the batch grows); the
rendered heights are JAX's bit for bit (``core/xla_math.py``).
The tiers' metadata and capacities equal JAX's.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch import convert
from husky_rover_mppi_isaacsim_torch.ops.crater_block_cuda import crater_block_cuda
from husky_rover_mppi_isaacsim_torch.terrain import craters as tcr
from husky_rover_mppi_isaacsim_torch.terrain import map_manager as tmap
from husky_rover_mppi_isaacsim_torch.terrain import streaming as tstream
from husky_rover_mppi_isaacsim_torch.terrain.craters import CraterSamplerConf as TCraterConf
from husky_rover_mppi_isaacsim_torch.terrain.orchestrator import LargeScaleConf as TLargeScaleConf
from husky_rover_mppi_isaacsim_tpu.terrain import craters as jcr
from husky_rover_mppi_isaacsim_tpu.terrain import streaming as jstream
from husky_rover_mppi_isaacsim_tpu.terrain.craters import CraterSamplerConf as JCraterConf
from husky_rover_mppi_isaacsim_tpu.terrain.orchestrator import LargeScaleConf as JLargeScaleConf

torch.set_num_threads(1)


def _live_only_loop(profiles, field, origin, resolution, z_scale, block_px, pad_px, patch_px):
    """The port's crater route before the stamp kernel: the live craters
    alone, rendered 256 at a time, each stamped by one slice add in crater
    order."""
    live = np.flatnonzero(field.mask.numpy())
    field = tcr.CraterField(*(f[live] for f in field))
    size_px = block_px + 2 * pad_px
    guard, hi = patch_px, block_px + 2 * pad_px + patch_px
    coords = field.coordinates.numpy().astype(np.float32)
    o, res = np.asarray(origin, np.float32), np.float32(resolution)
    cpx = np.floor((coords[:, 0] - o[0]) / res)
    cpy = np.floor((coords[:, 1] - o[1]) / res)
    row0 = np.clip((cpx + pad_px - patch_px // 2).astype(np.int32) + guard, 0, hi)
    col0 = np.clip((cpy + pad_px - patch_px // 2).astype(np.int32) + guard, 0, hi)
    buf = torch.zeros((size_px + 2 * guard,) * 2, dtype=torch.float32)
    for s in range(0, live.size, 256):
        sub = tcr.CraterField(*(f[s:s + 256] for f in field))
        patches = tcr._render_patches(profiles, sub, resolution, z_scale, patch_px)
        for i in range(patches.shape[0]):
            r, c = int(row0[s + i]), int(col0[s + i])
            buf[r:r + patch_px, c:c + patch_px] += patches[i]
    dem = buf[guard:guard + size_px, guard:guard + size_px]
    return dem[pad_px:size_px - pad_px, pad_px:size_px - pad_px]


# the LargeScaleConf tiers' patch sizes (r_hi 2.5 / 1.5 / 0.5 m at 0.025
# m/px) on a 10 m block at 0.05 m/px, so that the radii span the patch
@pytest.mark.parametrize("patch_px,r_range,n,capacity",
                         [(208, (2.0, 5.0), 12, 64), (128, (1.0, 3.0), 40, 64),
                          (48, (0.4, 1.1), 300, 512)], ids=["208", "128", "48"])
def test_padded_tier_stamp_equals_the_live_only_loop_and_jax(patch_px, r_range, n, capacity):
    """A tier padded to its capacity, masked slots last, rendered in one
    call and stamped in one call of the crater block wrapper (the CPU's
    plain version: render, then stamp):
    ``torch.equal`` to the live-only loop, and JAX's block renderer on the
    same padded field bit for bit; some craters overhang the
    block and its pad."""
    rng = np.random.default_rng(patch_px)
    block_px, pad_px, res = 200, 24, 0.05
    coords = rng.uniform(-2.0, 12.0, (n, 2))
    radius = rng.uniform(*r_range, n)
    jprof = jcr.build_profiles(16, seed=5)
    jfield = jcr.randomize_metadata(np.random.default_rng(8), coords, radius, 16, capacity)
    prof = convert.crater_profiles_from_numpy(*(np.asarray(a) for a in jprof))
    field = convert.crater_field_from_numpy(*(np.asarray(a) for a in jfield))
    assert int(field.mask.sum()) == n and not bool(field.mask[n:].any())
    origin = (0.5, -0.25)
    before = crater_block_cuda.launches
    got = tcr.render_crater_block(prof, field, origin, res, 1.1, block_px, pad_px, patch_px)
    assert crater_block_cuda.launches == before  # the CPU runs the plain version
    want = _live_only_loop(prof, field, origin, res, 1.1, block_px, pad_px, patch_px)
    assert got.shape == want.shape == (block_px, block_px) and got.abs().max() > 0.1
    assert torch.equal(got, want)
    # rendered in chunks, stamped once: the same block
    chunked = tcr.render_crater_block(prof, field, origin, res, 1.1, block_px, pad_px, patch_px,
                                      chunk=32)
    assert torch.equal(chunked, got)
    jwant = np.asarray(jcr.render_crater_block(jprof, jfield, jnp.asarray(origin, jnp.float32),
                                               res, 1.1, block_px=block_px, pad_px=pad_px,
                                               patch_px=patch_px))
    np.testing.assert_array_equal(got.numpy(), jwant)


def test_stamp_adds_live_slots_in_slot_order():
    """The plain stamp: overlapping patches summed in slot order (float32
    rounding shows the order), masked slots skipped, placements at the
    raster's edges; the crater block wrapper, whose plain version stamps
    through it, refuses what the kernel does not take."""
    rng = np.random.default_rng(3)
    p, slots = 6, 9
    patches = torch.from_numpy(rng.normal(0.0, 1.0, (slots, p, p)).astype(np.float32))
    patches[0] *= 1e8  # a large first term: adding in another order rounds otherwise
    row0 = torch.tensor([0, 1, 2, 10, 0, 3, 10, 4, 2], dtype=torch.int32)
    col0 = torch.tensor([0, 2, 1, 10, 10, 3, 0, 4, 2], dtype=torch.int32)
    mask = torch.tensor([1, 1, 1, 1, 1, 0, 1, 1, 0], dtype=torch.bool)
    buf = torch.zeros((16, 16), dtype=torch.float32)
    assert tcr.stamp_patches(buf, patches, row0, col0, mask) is buf
    want = np.zeros((16, 16), np.float32)
    for s in range(slots):
        if mask[s]:
            r, c = int(row0[s]), int(col0[s])
            want[r:r + p, c:c + p] += patches[s].numpy()
    np.testing.assert_array_equal(buf.numpy(), want)
    # slot 5 is masked: where only it would land, nothing did
    assert float(buf[8, 8]) == float(patches[7, 4, 4])
    prof = tcr.build_profiles(4, seed=1)
    field = tcr.randomize_metadata(np.random.default_rng(1), rng.uniform(0, 1, (slots, 2)),
                                   rng.uniform(0.1, 0.2, slots), 4, slots)
    with pytest.raises(TypeError, match="int32"):
        crater_block_cuda(buf, prof, field, row0.long(), col0, 0.05, 1.0, p)
    with pytest.raises(TypeError, match="float32"):
        crater_block_cuda(buf.double(), prof, field, row0, col0, 0.05, 1.0, p)
    with pytest.raises(ValueError, match="slots"):
        crater_block_cuda(buf, prof, field, row0[:4], col0, 0.05, 1.0, p)


def test_tier_specs_at_the_largescale_defaults():
    """At the ``LargeScaleConf`` defaults (25 m blocks at 0.025 m/px, a 10 m
    pad) the tiers are (capacity, patch) = (192, 208), (256, 128) and
    (1600, 48), as in the JAX package."""
    tconf = TLargeScaleConf().streamer_conf
    jconf = JLargeScaleConf().streamer_conf
    assert (tconf.block_size, tconf.resolution, tconf.pad_size) == (25.0, 0.025, 10.0)
    lr = tmap.synthetic_lola_dem(64, 5.0, seed=1)
    specs = tstream.TerrainStreamer(tconf, lr, device="cpu")._tier_specs
    assert [(c, p) for _, c, p in specs] == [(192, 208), (256, 128), (1600, 48)]
    assert specs == jstream.TerrainStreamer(jconf, lr)._tier_specs


def test_block_fields_pad_to_the_tier_capacities_with_jax_live_rows():
    """``_block_fields`` of a 25 m block at the default crater densities:
    one field per tier, padded to the tier's capacity, the live rows (and
    their order) JAX's, masked slots after them."""
    kw = dict(block_size=25.0, resolution=0.025, lr_resolution=5.0, num_blocks=1, pad_size=10.0,
              seed=31, native_pool="never")
    lr = tmap.synthetic_lola_dem(128, 5.0, seed=2)
    ts = tstream.TerrainStreamer(tstream.StreamerConf(crater=TCraterConf(seed=31), **kw), lr,
                                 device="cpu")
    js = jstream.TerrainStreamer(jstream.StreamerConf(crater=JCraterConf(seed=31), **kw), lr)
    for key in ((0, 0), (2, -1)):
        tiers_t, tiers_j = ts._block_fields(*key), js._block_fields(*key)
        assert [(f.mask.shape[0], p) for f, p in tiers_t] == [(192, 208), (256, 128), (1600, 48)]
        live = 0
        for (ft, pt), (fj, pj) in zip(tiers_t, tiers_j):
            n = int(np.asarray(fj.mask).sum())
            live += n
            assert pt == pj and bool(ft.mask[:n].all()) and not bool(ft.mask[n:].any())
            for a, b in zip(ft, fj):
                assert a.shape == np.asarray(b).shape
                np.testing.assert_array_equal(a.numpy()[:n], np.asarray(b)[:n])
            assert bool((ft.xy_factor[n:] == 1.0).all())
        assert live > 500  # ~1150 per block at these densities
