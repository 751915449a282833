"""PyTorch port: the crater block on the CPU, the arithmetic and the order of
the card's crater block kernel (csrc/crater_block.cu), which ``chip_smoke.py``
and ``tests/test_torch_gpu.py`` hold ``torch.equal`` to its plain version
(``_render_patches``, then ``stamp_patches``) on the card.

Here, on the same numpy inputs in both packages (``convert.crater_*_from_
numpy``), at the three streamed tiers' patch sizes, a 1-slot tier, an
all-masked tier and craters that overhang the pad and the guard band:

- a plain per-pixel function that writes out the kernel's float32 arithmetic
  in its order, over ``(slot, row, col)`` triples, is ``torch.equal`` to
  ``_render_patches`` at those pixels;
- a plain emulation of the kernel's binned, ordered accumulation (the tile
  lists of ``tile_bins``, then each tile's adds in slot order) is
  ``torch.equal`` to ``render_crater_block``'s CPU route;
- both are the JAX package's jitted ``_render_patches`` and
  ``render_crater_block`` bit for bit.

Tolerances: none. Every comparison is exact: the same float32 operations in
the same order, glibc's and XLA's functions copied in ``core/xla_math.py``
and their fused multiply-adds formed exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from husky_rover_mppi_isaacsim_torch import convert
from husky_rover_mppi_isaacsim_torch.core import xla_math as xm
from husky_rover_mppi_isaacsim_torch.ops import crater_block_cuda as cbc
from husky_rover_mppi_isaacsim_torch.terrain import craters as tcr
from husky_rover_mppi_isaacsim_tpu.terrain import craters as jcr

torch.set_num_threads(1)

BLOCK_PX, PAD_PX, RES, Z_SCALE = 200, 24, 0.05, 1.1
ORIGIN = (0.5, -0.25)
# the kernel's scalars: Python floats as torch casts them to float32
DEG2RAD = tcr.DEG2RAD
INV_2PI = tcr.INV_2PI

# (patch_px, radius range, live craters, capacity, coordinate range): the
# LargeScaleConf tiers' patch sizes (r_hi 2.5 / 1.5 / 0.5 m at 0.025 m/px)
# on a 10 m block at 0.05 m/px, so that the radii span the patch; a 1-slot
# tier; an all-masked tier; craters far past the pad, whose patches leave
# the guard band and are clamped into it
CASES = {
    "208": (208, (2.0, 5.0), 12, 64, (-2.0, 12.0)),
    "128": (128, (1.0, 3.0), 40, 64, (-2.0, 12.0)),
    "48": (48, (0.4, 1.1), 300, 512, (-2.0, 12.0)),
    "one_slot": (48, (0.6, 1.1), 1, 1, (3.0, 7.0)),
    "all_masked": (48, (0.4, 1.1), 0, 64, (-2.0, 12.0)),
    "overhang": (128, (1.0, 3.2), 60, 64, (-6.0, 16.0)),
}


def _case(name):
    patch_px, r_range, n, capacity, (lo, hi) = CASES[name]
    rng = np.random.default_rng(patch_px + n)
    coords = rng.uniform(lo, hi, (n, 2))
    radius = rng.uniform(*r_range, n)
    jprof = jcr.build_profiles(16, seed=5)
    jfield = jcr.randomize_metadata(np.random.default_rng(8), coords, radius, 16, capacity)
    prof = convert.crater_profiles_from_numpy(*(np.asarray(a) for a in jprof))
    field = convert.crater_field_from_numpy(*(np.asarray(a) for a in jfield))
    assert int(field.mask.sum()) == n
    return patch_px, jprof, jfield, prof, field


def _lookup(table, offset, x, lead_v0=False):
    """``_table_lookup`` at one point per element, the kernel's order:
    clamp, scale, floor, then the fused lerp."""
    pos = torch.clamp(x, 0.0, 1.0) * float(tcr.TABLE_SIZE - 1)
    f0 = torch.floor(pos)
    i0 = f0.to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=tcr.TABLE_SIZE - 1)
    frac = pos - f0
    flat = table.reshape(-1)
    v0, v1 = flat[offset + i0], flat[offset + i1]
    if lead_v0:
        return xm.fma_f32(v0, 1.0 - frac, v1 * frac)
    return xm.fma_f32(v1, frac, v0 * (1.0 - frac))


def kernel_heights(profiles, field, resolution, z_scale, patch_px, s, i, j):
    """The crater block kernel's float32 arithmetic over ``(slot, row, col)``
    triples of patch pixels (csrc/crater_block.cu, op by op, its device
    functions those of ``core/xla_math.py``): what a thread block stages per
    slot, over all slots as ``_render_patches`` computes it, then each
    pixel's height; 0 outside the slot's square or for a masked slot (where
    the kernel adds nothing)."""
    n = s.shape[0]
    pad = -n % 64
    s, i, j = (torch.cat([t, t[:1].expand(pad)]) for t in (s, i, j))
    # per slot
    res = torch.full((), resolution, dtype=torch.float32)
    half_all = torch.floor(field.radius / res)
    ang = field.rotation * DEG2RAD
    ca_all, sa_all = xm.cos_f32(ang), xm.sin_f32(ang)
    half, ca, sa = half_all[s], ca_all[s], sa_all[s]
    mu1, mu2 = half * 0.15, half * 0.45
    std = torch.clamp(half * 0.05, min=1e-6)
    hclamp = torch.clamp(half, min=1.0)
    size = tcr.TABLE_SIZE
    d_off = field.deformation_id.to(torch.int64)[s] * size
    m_off = field.marks_id.to(torch.int64)[s] * size
    p_off = field.profile_id.to(torch.int64)[s] * size
    # per pixel
    u = (i - patch_px // 2).to(torch.float32)
    v = (j - patch_px // 2).to(torch.float32)
    in_square = (u.abs() <= half) & (v.abs() <= half)
    cau, sau = ca * u, sa * u
    ur = xm.fma_f32(sa, v, cau)
    vr = xm.fma_f32(ca, v, -sau)
    in_rot = torch.maximum(ur.abs(), vr.abs()) <= half
    if patch_px > tcr.ATAN2_UNFUSED_MAX_PX:
        angle = xm.atan2_f32(ur, vr)
    else:
        angle = xm.atan2_f32(cau + sa * v, ca * v - sau)
    theta = xm.fma_f32(angle, INV_2PI, 0.5)
    fac = _lookup(profiles.deformation, d_off, theta)
    marks = _lookup(profiles.marks, m_off, theta, lead_v0=True) * half * field.marks_intensity[s]
    q = vr / field.xy_factor[s]
    m = xm.sqrt_f32(xm.fma_f32(ur, ur, q * q)) * fac
    d1, d2 = (m - mu1) / std, (m - mu2) / std
    sat = torch.where(m < mu1, xm.exp_f32((d1 * d1) * -0.5),
                      torch.where(m > mu2, xm.exp_f32((d2 * d2) * -0.5), torch.ones_like(m)))
    m = torch.where(in_rot, torch.minimum(xm.fma_f32(marks, sat, m), half), half)
    h = _lookup(profiles.height, p_off, m / hclamp) * field.radius[s] * z_scale
    h = torch.where(in_square & field.mask[s], h, torch.zeros_like(h))
    return h[:n]


def _triples(field, patch_px, count=3000, seed=0):
    """``(slot, row, col)`` patch pixels: most inside a live slot's square,
    some anywhere in any slot's patch (masked slots included)."""
    rng = np.random.default_rng(seed)
    slots = field.mask.shape[0]
    live = np.flatnonzero(field.mask.numpy())
    s = rng.integers(0, slots, count)
    i, j = rng.integers(0, patch_px, count), rng.integers(0, patch_px, count)
    if live.size:
        k = count * 3 // 4
        s[:k] = rng.choice(live, k)
        half = cbc.half_px(field.radius.numpy()[s[:k]], RES)
        c = patch_px // 2
        i[:k] = np.clip(c + np.round(rng.uniform(-1, 1, k) * half), 0, patch_px - 1)
        j[:k] = np.clip(c + np.round(rng.uniform(-1, 1, k) * half), 0, patch_px - 1)
    return tuple(torch.from_numpy(a.astype(np.int64)) for a in (s, i, j))


def binned_block(profiles, field, patch_px):
    """The kernel's accumulation emulated with plain patches: the live slots
    binned by tile (``tile_bins``), then, tile by tile, each listed slot's
    heights added to the tile's pixels of its square in list (slot) order,
    into the zeroed guarded raster of ``render_crater_block``; returns the
    unpadded block."""
    size_px = BLOCK_PX + 2 * PAD_PX
    side = size_px + 2 * patch_px
    row0, col0 = tcr.crater_placement(field, ORIGIN, RES, BLOCK_PX, PAD_PX, patch_px)
    bins = cbc.tile_bins(row0, col0, field.radius.numpy(), field.mask.numpy(), RES, patch_px,
                         side)
    patches = tcr._render_patches(profiles, field, RES, Z_SCALE, patch_px)
    half = cbc.half_px(field.radius.numpy(), RES)
    c, t, tiles_x = patch_px // 2, cbc.TILE_PX, -(-side // cbc.TILE_PX)
    buf = torch.zeros((side, side), dtype=torch.float32)
    for k, tile in enumerate(bins.tile_ids.tolist()):
        tr, tc = (tile // tiles_x) * t, (tile % tiles_x) * t
        for s in bins.slots[bins.start[k]:bins.start[k + 1]].tolist():
            r_lo = max(tr, row0[s] + max(c - half[s], 0))
            r_hi = min(tr + t, row0[s] + min(c + half[s], patch_px - 1) + 1, side)
            c_lo = max(tc, col0[s] + max(c - half[s], 0))
            c_hi = min(tc + t, col0[s] + min(c + half[s], patch_px - 1) + 1, side)
            assert r_lo < r_hi and c_lo < c_hi  # a listed slot overlaps its tile
            buf[r_lo:r_hi, c_lo:c_hi] += patches[s, r_lo - row0[s]:r_hi - row0[s],
                                                 c_lo - col0[s]:c_hi - col0[s]]
    dem = buf[patch_px:patch_px + size_px, patch_px:patch_px + size_px]
    return dem[PAD_PX:size_px - PAD_PX, PAD_PX:size_px - PAD_PX]


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_arithmetic_equals_render_patches_per_pixel(case):
    """The kernel's per-pixel arithmetic, written out over triples, is
    ``torch.equal`` to ``_render_patches`` at those pixels."""
    patch_px, _, _, prof, field = _case(case)
    s, i, j = _triples(field, patch_px)
    got = kernel_heights(prof, field, RES, Z_SCALE, patch_px, s, i, j)
    want = tcr._render_patches(prof, field, RES, Z_SCALE, patch_px)[s, i, j]
    assert torch.equal(got, want)
    if int(field.mask.sum()):
        assert int((got != 0).sum()) > len(got) // 2  # mostly real heights
    else:
        assert not bool(got.any())


@pytest.mark.parametrize("case", list(CASES))
def test_binned_accumulation_equals_the_cpu_route(case):
    """The tile lists, then the adds in slot order, give the block that
    ``render_crater_block`` renders on the CPU (its plain version, no
    launch), bit for bit."""
    patch_px, _, _, prof, field = _case(case)
    before = cbc.crater_block_cuda.launches
    got = tcr.render_crater_block(prof, field, ORIGIN, RES, Z_SCALE, BLOCK_PX, PAD_PX, patch_px)
    assert cbc.crater_block_cuda.launches == before
    want = binned_block(prof, field, patch_px)
    assert got.shape == want.shape == (BLOCK_PX, BLOCK_PX)
    assert torch.equal(got, want)
    assert (float(got.abs().max()) > 0.05) == bool(field.mask.any())


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_arithmetic_and_binned_block_match_jax(case):
    """The per-pixel arithmetic against JAX's jitted ``_render_patches`` (on
    the field padded to 64 slots, as ``render_crater_block`` pads a small
    field to its chunk) and the binned block against JAX's
    ``render_crater_block``, bit for bit."""
    patch_px, jprof, jfield, prof, field = _case(case)
    s, i, j = _triples(field, patch_px, count=2000, seed=1)
    got = kernel_heights(prof, field, RES, Z_SCALE, patch_px, s, i, j)
    slots = jfield.mask.shape[0]
    padded = jcr.CraterField(*[jnp.concatenate([f, jnp.zeros((max(64 - slots, 0),) + f.shape[1:],
                                                               f.dtype)]) for f in jfield])
    render = jax.jit(jcr._render_patches, static_argnums=(4,))
    jpatches = np.asarray(render(jprof, padded, jnp.float32(RES), jnp.float32(Z_SCALE),
                                 patch_px))
    np.testing.assert_array_equal(got.numpy(), jpatches[s.numpy(), i.numpy(), j.numpy()])
    block = binned_block(prof, field, patch_px)
    jblock = np.asarray(jcr.render_crater_block(jprof, jfield, jnp.asarray(ORIGIN, jnp.float32),
                                                RES, Z_SCALE, block_px=BLOCK_PX, pad_px=PAD_PX,
                                                patch_px=patch_px))
    np.testing.assert_array_equal(block.numpy(), jblock)


def test_tile_bins_list_every_overlap_in_slot_order():
    """``tile_bins`` against a brute-force overlap of every live slot's
    square with every tile: the same (tile, slot) pairs, tiles ascending and
    unique, each tile's slots ascending; masked slots and tiles no square
    touches are left out; squares cut to their patch window."""
    rng = np.random.default_rng(4)
    slots, patch_px, side = 90, 40, 300
    row0 = rng.integers(0, side - patch_px + 1, slots).astype(np.int32)
    col0 = rng.integers(0, side - patch_px + 1, slots).astype(np.int32)
    radius = rng.uniform(0.0, 1.4, slots).astype(np.float32)  # some squares past the patch
    mask = rng.random(slots) < 0.7
    bins = cbc.tile_bins(row0, col0, radius, mask, 0.05, patch_px, side)
    t, tiles_x = cbc.TILE_PX, -(-side // cbc.TILE_PX)
    half = cbc.half_px(radius, 0.05)
    want = set()
    for s in np.flatnonzero(mask):
        lo, hi = max(patch_px // 2 - half[s], 0), min(patch_px // 2 + half[s], patch_px - 1)
        for tr in range(tiles_x):
            for tc in range(tiles_x):
                if (row0[s] + lo < (tr + 1) * t and row0[s] + hi >= tr * t
                        and col0[s] + lo < (tc + 1) * t and col0[s] + hi >= tc * t):
                    want.add((tr * tiles_x + tc, s))
    got = {(tile, s) for k, tile in enumerate(bins.tile_ids.tolist())
           for s in bins.slots[bins.start[k]:bins.start[k + 1]].tolist()}
    assert got == want and len(bins.slots) == len(want)
    assert all(a.dtype == np.int32 for a in bins)
    assert np.all(np.diff(bins.tile_ids) > 0) and bins.start[0] == 0
    for k in range(len(bins.tile_ids)):
        assert np.all(np.diff(bins.slots[bins.start[k]:bins.start[k + 1]]) > 0)
    empty = cbc.tile_bins(row0, col0, radius, np.zeros(slots, bool), 0.05, patch_px, side)
    assert empty.tile_ids.size == 0 and empty.slots.size == 0 and list(empty.start) == [0]


def test_half_px_equals_render_patches_half_width():
    """The host's half-widths (which bin the slots) are those that
    ``_render_patches`` computes in float32 with a true division."""
    rng = np.random.default_rng(9)
    radius = rng.uniform(0.0, 3.0, 5000).astype(np.float32)
    radius[:4] = [0.05, 0.1, 0.15, 2.5]  # exact multiples of the resolution
    for res in (0.05, 0.025, 0.02, 0.1):
        want = torch.floor(torch.from_numpy(radius) / torch.full((), res)).numpy()
        np.testing.assert_array_equal(cbc.half_px(radius, res), want.astype(np.int64))


def test_wrapper_runs_the_plain_block_on_the_cpu_and_refuses_bad_inputs():
    """On CPU tensors the wrapper adds the plain crater block into the given
    raster in place (no launch), on top of what it holds; it refuses
    another dtype, a raster that is not square and columns of another
    length."""
    patch_px, _, _, prof, field = _case("128")
    side = 2 * patch_px + 60
    rng = np.random.default_rng(2)
    row0 = torch.from_numpy(rng.integers(0, side - patch_px + 1, 64).astype(np.int32))
    col0 = torch.from_numpy(rng.integers(0, side - patch_px + 1, 64).astype(np.int32))
    base = torch.from_numpy(rng.normal(0, 1, (side, side)).astype(np.float32))
    buf = base.clone()
    before = cbc.crater_block_cuda.launches
    assert cbc.crater_block_cuda(buf, prof, field, row0, col0, RES, Z_SCALE, patch_px) is buf
    assert cbc.crater_block_cuda.launches == before
    patches = tcr._render_patches(prof, field, RES, Z_SCALE, patch_px)
    want = tcr.stamp_patches(base.clone(), patches, row0, col0, field.mask)
    assert torch.equal(buf, want) and not torch.equal(buf, base)
    chunked = cbc.crater_block_cuda(base.clone(), prof, field, row0, col0, RES, Z_SCALE,
                                    patch_px, chunk=16)
    assert torch.equal(chunked, want)
    with pytest.raises(TypeError, match="int32"):
        cbc.crater_block_cuda(buf, prof, field, row0.long(), col0, RES, Z_SCALE, patch_px)
    with pytest.raises(TypeError, match="float32"):
        cbc.crater_block_cuda(buf.double(), prof, field, row0, col0, RES, Z_SCALE, patch_px)
    with pytest.raises(TypeError, match="float32"):
        cbc.crater_block_cuda(buf, type(prof)(*(t.double() for t in prof)), field, row0, col0,
                              RES, Z_SCALE, patch_px)
    with pytest.raises(ValueError, match="square"):
        cbc.crater_block_cuda(buf[:-1], prof, field, row0, col0, RES, Z_SCALE, patch_px)
    with pytest.raises(ValueError, match="square"):
        cbc.crater_block_cuda(buf, prof, field, row0[:4], col0, RES, Z_SCALE, patch_px)
