"""Procedural craters: baked profile tables, per-crater metadata and the
block renderer.

Counterpart of ``husky_rover_mppi_isaacsim_tpu/terrain/craters.py``
(crater_generation.py, crater_distribution.py), with the same analytic
substitutions (rotation applied to coordinates, analytic ``sat_gaussian``
normalization, synthetic half-profiles for the missing profile pickle).
The profile tables and the metadata are drawn on the host with numpy and
scipy in the JAX package's draw order, so one seed gives both packages the
same craters.

:func:`render_crater_block` adds every live crater of a (capacity-padded)
field into a guarded block raster in slot order, through the crater block
wrapper (``ops/crater_block_cuda.py``): on the card one launch of the
crater block kernel, the counterpart of the JAX package's one-program scan,
which computes each covered pixel's height in registers (no patch tensor);
on the CPU its plain version, :func:`crater_block_plain`: every slot
rendered as a fixed-size patch (:func:`_render_patches`), the live ones
added by :func:`stamp_patches`, one in-place slice add each. Either way each
pixel sums the same values in the same order, so two builds of one DEM are
bit-equal on the card too; a scatter with ``index_put_(accumulate=True)``
would add with float atomics in no fixed order. Placement and the tile
lists are computed on the host from the metadata.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

from ..core.xla_math import atan2_f32, cos_f32, exp_f32, fma_f32, sin_f32, sqrt_f32

TABLE_SIZE = 256


class CraterProfiles(NamedTuple):
    """Baked profile tables, all ``(num_profiles, TABLE_SIZE)``."""

    deformation: Tensor  # angular deformation factor over theta in [0, 1)
    marks: Tensor        # angular marks amplitude over theta in [0, 1)
    height: Tensor       # radial half-profile over r/R in [0, 1]


class CraterField(NamedTuple):
    """Struct-of-arrays crater metadata (utils.py:89-97 CraterMetadata),
    padded to a fixed capacity with ``mask``."""

    coordinates: Tensor      # (C, 2) meters
    radius: Tensor           # (C,)
    deformation_id: Tensor   # (C,) int32
    marks_id: Tensor         # (C,) int32
    marks_intensity: Tensor  # (C,)
    profile_id: Tensor       # (C,) int32
    xy_factor: Tensor        # (C,) x deformation factor (y factor is 1)
    rotation: Tensor         # (C,) degrees
    mask: Tensor             # (C,) bool


def _closed_spline_table(rng: np.random.Generator, low: float, high: float,
                         num_knots: int) -> np.ndarray:
    """Periodic-ish cubic spline through U(low, high) knots with clamped end
    slopes (crater_distribution.py:386-409), baked to a dense table."""
    from scipy.interpolate import CubicSpline

    knots = rng.uniform(low, high, num_knots)
    knots = np.concatenate([knots, [knots[0]]])
    x = np.linspace(0, 1, knots.shape[0])
    spline = CubicSpline(x, knots, bc_type=((1, 0.0), (1, 0.0)))
    return spline(np.linspace(0, 1, TABLE_SIZE))


def _synthetic_half_profile(rng: np.random.Generator) -> np.ndarray:
    """Synthetic lunar crater half-profile h(r/R) in units of the radius:
    parabolic bowl, raised rim, exponentially decaying ejecta, h(1) = 0."""
    x = np.linspace(0, 1, TABLE_SIZE)
    depth = rng.uniform(0.15, 0.35)
    rim_height = rng.uniform(0.02, 0.08)
    rim_pos = rng.uniform(0.55, 0.75)
    decay = rng.uniform(8.0, 16.0)
    bowl = -depth + (depth + rim_height) * (x / rim_pos) ** 2
    tail_len = max(1.0 - rim_pos, 1e-6)
    frac = (x - rim_pos) / tail_len
    taper = np.exp(-decay * frac) - np.exp(-decay)
    taper /= 1.0 - np.exp(-decay)
    ejecta = rim_height * taper
    h = np.where(x <= rim_pos, bowl, ejecta)
    # gentle smoothing of the rim kink
    kernel = np.array([0.25, 0.5, 0.25])
    h = np.convolve(np.pad(h, 1, mode="edge"), kernel, mode="valid")
    h[-1] = 0.0
    return h


def build_profiles(num_profiles: int = 100, seed: int = 42, dtype=torch.float32,
                   device=None) -> CraterProfiles:
    """Bake the three profile families (CraterMetadataGenerator.build,
    crater_distribution.py:341-396)."""
    rng = np.random.default_rng(seed)
    deform = np.stack([_closed_spline_table(rng, 0.95, 1.0, 9) for _ in range(num_profiles)])
    marks = np.stack([_closed_spline_table(rng, 0.0, 0.01, 45) for _ in range(num_profiles)])
    height = np.stack([_synthetic_half_profile(rng) for _ in range(num_profiles)])
    return CraterProfiles(*(torch.as_tensor(t, dtype=dtype, device=device)
                            for t in (deform, marks, height)))


def randomize_metadata(
    rng: np.random.Generator, coordinates: np.ndarray, radius: np.ndarray,
    num_profiles: int, capacity: int, min_xy_ratio: float = 0.85,
    max_xy_ratio: float = 1.0, as_numpy: bool = False,
) -> CraterField:
    """Metadata randomization in the reference's per-attribute draw order
    (crater_distribution.py:427-451: deformation id, marks id, intensity,
    profile id, xy ratio, rotation), padded to ``capacity``. A field of
    float32 / int32 / bool CPU tensors, or of numpy arrays with ``as_numpy``
    (the streamer splits it into radius tiers first)."""
    dtype = np.float32
    n = coordinates.shape[0]
    if n > capacity:
        raise ValueError(f"{n} craters exceed the capacity {capacity}")
    field = CraterField(
        coordinates=np.zeros((capacity, 2), dtype),
        radius=np.zeros((capacity,), dtype),
        deformation_id=np.zeros((capacity,), np.int32),
        marks_id=np.zeros((capacity,), np.int32),
        marks_intensity=np.zeros((capacity,), dtype),
        profile_id=np.zeros((capacity,), np.int32),
        xy_factor=np.ones((capacity,), dtype),
        rotation=np.zeros((capacity,), dtype),
        mask=np.zeros((capacity,), bool),
    )
    field.coordinates[:n] = coordinates
    field.radius[:n] = radius
    field.deformation_id[:n] = rng.integers(0, num_profiles, n)
    field.marks_id[:n] = rng.integers(0, num_profiles, n)
    field.marks_intensity[:n] = rng.uniform(0, 1, n)
    field.profile_id[:n] = rng.integers(0, num_profiles, n)
    field.xy_factor[:n] = rng.uniform(min_xy_ratio, max_xy_ratio, n)
    field.rotation[:n] = rng.uniform(0, 360, n).astype(np.int64)
    field.mask[:n] = True
    if as_numpy:
        return field
    return CraterField(*(torch.from_numpy(f) for f in field))


def _table_lookup(table: Tensor, ids: Tensor, x: Tensor, lead_v0: bool = False) -> Tensor:
    """Linear interpolation into per-crater rows of a baked table, in
    float32 as XLA's CPU code for the JAX package's jitted render computes
    it: ``fma(v1, frac, v0 * (1 - frac))``, or with ``lead_v0``
    ``fma(v0, 1 - frac, v1 * frac)`` (the marks table's order).
    ``ids``: (C,) row per crater; ``x``: (C, ...) in [0, 1]."""
    pos = torch.clamp(x, 0.0, 1.0) * (TABLE_SIZE - 1)
    i0 = torch.floor(pos).to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=TABLE_SIZE - 1)
    frac = pos - i0.to(pos.dtype)
    base = ids.to(torch.int64).reshape(ids.shape + (1,) * (x.ndim - 1)) * TABLE_SIZE
    v0 = torch.take(table, base + i0)
    v1 = torch.take(table, base + i1)
    if lead_v0:
        return fma_f32(v0, 1.0 - frac, v1 * frac)
    return fma_f32(v1, frac, v0 * (1.0 - frac))


# float32 constants of the render, as XLA folds them: pi / 180, 1 / (2 pi)
DEG2RAD = float(np.float32(np.pi / 180.0))
INV_2PI = float(np.float32(1.0 / (2.0 * np.pi)))
# the widest patch whose atan2 arguments XLA's CPU code computes without
# fused multiply-adds (its pixel loop unrolled; from 64 pixels on it fuses)
ATAN2_UNFUSED_MAX_PX = 56


def _render_patches(profiles: CraterProfiles, field: CraterField, resolution: float,
                    z_scale: float, patch_px: int) -> Tensor:
    """Every crater of ``field`` in its own ``(patch_px, patch_px)`` patch
    centered on the crater, ``(C, patch_px, patch_px)`` float32
    (centered_distance_matrix + apply_profile, crater_generation.py:77-167).

    The JAX package's bits: each operation as XLA's CPU code for its jitted
    render evaluates it (:mod:`..core.xla_math`: glibc's ``cosf``, ``sinf``
    and ``atan2f``, XLA's ``exp``), with the fused multiply-adds LLVM forms
    there: ``ur = fma(sa, v, ca u)``, ``vr = fma(ca, v, -(sa u))`` (the
    products of ``u`` are computed once a row, outside the fused loop), the
    table lookups, ``ur^2 + (vr/xf)^2``, ``m + marks sat``; the atan2
    arguments, in a loop of their own, fuse only from 64-pixel patches on.
    Every operation is elementwise, so the heights are computed on the
    drawn pixels alone (inside a live crater's square; the profile's
    argument inside its rotated square), gathered and scattered back.
    Divisions by a variable are by tensors: on the card a division by a
    Python float becomes a multiply by its reciprocal."""
    dev = profiles.height.device
    rows = torch.arange(patch_px, dtype=torch.float32, device=dev) - patch_px // 2
    u = rows[None, :, None]  # (1, P, 1) x offset in px
    v = rows[None, None, :]  # (1, 1, P) y offset in px

    res = torch.full((), resolution, dtype=torch.float32, device=dev)
    half_px = torch.floor(field.radius / res)
    ang = field.rotation * DEG2RAD
    ca, sa = cos_f32(ang)[:, None, None], sin_f32(ang)[:, None, None]
    cau, sau = ca * u, sa * u  # (C, P, 1), rounded
    ur = fma_f32(sa, v, cau)
    vr = fma_f32(ca, v, -sau)
    half3 = half_px[:, None, None]
    inside_square = (torch.maximum(torch.abs(u), torch.abs(v)) <= half3) & field.mask[:, None, None]
    inside_rot = inside_square & (torch.maximum(torch.abs(ur), torch.abs(vr)) <= half3)

    # the profile's argument m where the crater is drawn (half_px outside the
    # rotated square), computed elementwise on those pixels alone
    m = half3.expand(inside_square.shape).clone()
    slot, ri, ci = torch.nonzero(inside_rot, as_tuple=True)
    ur_p, vr_p, half = ur[slot, ri, ci], vr[slot, ri, ci], half_px[slot]
    if patch_px > ATAN2_UNFUSED_MAX_PX:
        angle = atan2_f32(ur_p, vr_p)
    else:
        ca_p, sa_p, v_p = ca.reshape(-1)[slot], sa.reshape(-1)[slot], rows[ci]
        cau_p, sau_p = cau.reshape(cau.shape[:2])[slot, ri], sau.reshape(sau.shape[:2])[slot, ri]
        angle = atan2_f32(cau_p + sa_p * v_p, ca_p * v_p - sau_p)
    # XLA compiles the division by the constant 2 pi into a multiply by its
    # float32 reciprocal, fused with the + 0.5
    theta = fma_f32(angle, INV_2PI, 0.5)
    fac = _table_lookup(profiles.deformation, field.deformation_id[slot], theta)
    marks = (_table_lookup(profiles.marks, field.marks_id[slot], theta, lead_v0=True)
             * half * field.marks_intensity[slot])

    q = vr_p / field.xy_factor[slot]
    m_p = sqrt_f32(fma_f32(ur_p, ur_p, q * q)) * fac

    # saturated-gaussian marks envelope (analytic normalization), the exp of
    # the branch taken
    mu1, mu2 = half * 0.15, half * 0.45
    std = torch.clamp(half * 0.05, min=1e-6)
    below = m_p < mu1
    d = torch.where(below, (m_p - mu1) / std, (m_p - mu2) / std)
    sat = torch.where(below | (m_p > mu2), exp_f32((d * d) * -0.5), torch.ones_like(m_p))
    m[slot, ri, ci] = torch.minimum(fma_f32(marks, sat, m_p), half)

    h = torch.zeros(inside_square.shape, dtype=torch.float32, device=dev)
    slot, ri, ci = torch.nonzero(inside_square, as_tuple=True)
    h[slot, ri, ci] = (_table_lookup(profiles.height, field.profile_id[slot],
                                     m[slot, ri, ci] / torch.clamp(half_px[slot], min=1.0))
                       * field.radius[slot] * z_scale)
    return h


def stamp_patches(buf: Tensor, patches: Tensor, row0: Tensor, col0: Tensor,
                  mask: Tensor) -> Tensor:
    """The plain crater stamp: for every slot ``s`` with ``mask[s]``, in slot
    order, one in-place slice add ``buf[row0[s]:, col0[s]:][:P, :P] +=
    patches[s]``; masked slots are skipped. Placements must put every live
    patch inside ``buf``. Returns ``buf``. The stamp of
    :func:`crater_block_plain`."""
    p = patches.shape[-1]
    rows, cols = row0.tolist(), col0.tolist()
    for i in torch.nonzero(mask.cpu()).flatten().tolist():
        r, c = rows[i], cols[i]
        buf[r:r + p, c:c + p] += patches[i]
    return buf


def crater_block_plain(buf: Tensor, profiles: CraterProfiles, field: CraterField, row0: Tensor,
                       col0: Tensor, resolution: float, z_scale: float, patch_px: int,
                       bins=None, chunk: int | None = None) -> Tensor:
    """The plain crater block, the route the crater block kernel is held
    against: every slot of ``field`` rendered as a ``(patch_px, patch_px)``
    patch by :func:`_render_patches` (``chunk`` slots per call; all of them
    in one call by default; an all-masked chunk is not rendered) and the
    live ones added into ``buf`` by :func:`stamp_patches` in slot order, in
    place. ``bins`` (the kernel's tile lists) is not used. Returns ``buf``."""
    slots = field.mask.shape[0]
    step = slots if chunk is None else chunk
    if step >= slots:
        patches = _render_patches(profiles, field, resolution, z_scale, patch_px)
    else:  # slots of an all-masked chunk are never stamped: left unrendered
        mask = field.mask.cpu()
        patches = torch.empty((slots, patch_px, patch_px), dtype=torch.float32, device=buf.device)
        for s in range(0, slots, step):
            if mask[s:s + step].any():
                part = CraterField(*(f[s:s + step] for f in field))
                patches[s:s + step] = _render_patches(profiles, part, resolution, z_scale,
                                                      patch_px)
    return stamp_patches(buf, patches, row0, col0, field.mask)


def crater_placement(field: CraterField, block_origin, resolution: float, block_px: int,
                     pad_px: int, patch_px: int) -> tuple[np.ndarray, np.ndarray]:
    """Each slot's patch corner ``(row0, col0)`` (int32, host) in the
    guarded raster of :func:`render_crater_block`, whose side is
    ``block_px + 2 * pad_px + 2 * patch_px``: truncated like the reference
    (:169-176) in float32, offset by the patch-sized guard band, and clamped
    into the raster (craters.py:229-230 of the JAX package)."""
    size_px = block_px + 2 * pad_px
    guard = patch_px
    hi = size_px + 2 * guard - patch_px
    coords = field.coordinates.cpu().numpy().astype(np.float32)
    origin = np.asarray(block_origin, np.float32)
    res = np.float32(resolution)
    cpx = np.floor((coords[:, 0] - origin[0]) / res)
    cpy = np.floor((coords[:, 1] - origin[1]) / res)
    row0 = np.clip((cpx + pad_px - patch_px // 2).astype(np.int32) + guard, 0, hi)
    col0 = np.clip((cpy + pad_px - patch_px // 2).astype(np.int32) + guard, 0, hi)
    return row0.astype(np.int32), col0.astype(np.int32)


def render_crater_block(
    profiles: CraterProfiles, field: CraterField, block_origin, resolution: float,
    z_scale: float, block_px: int, pad_px: int, patch_px: int = 128, chunk: int | None = None,
    upload=None,
) -> Tensor:
    """Render all craters of ``field`` into one ``(block_px, block_px)``
    float32 block raster on the tables' device (CraterBuilder.
    generate_craters, crater_generation.py:182-221); row = x, col = y.

    The live slots are added into a zeroed guarded raster in slot order by
    one call of the crater block wrapper: on the card one kernel launch,
    which allocates no patch tensor; on the CPU :func:`crater_block_plain`,
    which renders ``chunk`` slots per :func:`_render_patches` call (all of
    them in one call by default). A field with no live slot renders
    nothing. Placement truncates like the reference (:169-176) and is
    computed on the host in float32, the live slots are binned by raster
    tile on the host too (``ops.crater_block_cuda.tile_bins``, which the
    kernel reads and the CPU route ignores), and both go to the device as
    int32 tensors. The raster carries a
    patch-sized guard band, so a patch that overhangs the padded block is
    cut off, not moved; a crater whose patch leaves the guard band too is
    clamped into it, as in the JAX package. ``upload`` moves the (host)
    field, the placements and the tile lists to the tables' device
    (default: ``Tensor.to``; the streamer passes its pinned
    :class:`..core.device.HostUploader`)."""
    from ..ops.crater_block_cuda import TileBins, crater_block_cuda, tile_bins

    dev = profiles.height.device
    if upload is None:
        upload = lambda t: t.to(dev)  # noqa: E731
    size_px = block_px + 2 * pad_px
    guard = patch_px
    side = size_px + 2 * guard
    row0, col0 = crater_placement(field, block_origin, resolution, block_px, pad_px, patch_px)
    buf = torch.zeros((side, side), dtype=torch.float32, device=dev)
    mask = field.mask.cpu()
    if mask.any():
        sub = CraterField(*(upload(f) for f in field))
        bins = tile_bins(row0, col0, field.radius.cpu().numpy(), mask.numpy(), resolution,
                         patch_px, side)
        # the placements and the tile lists in one upload
        ints = [row0, col0, *bins]
        flat = upload(torch.from_numpy(np.concatenate(ints).astype(np.int32)))
        parts = torch.split(flat, [a.shape[0] for a in ints])
        crater_block_cuda(buf, profiles, sub, parts[0], parts[1], resolution, z_scale, patch_px,
                          bins=TileBins(*parts[2:]), chunk=chunk)
    dem = buf[guard:guard + size_px, guard:guard + size_px]
    return dem[pad_px:size_px - pad_px, pad_px:size_px - pad_px]


@dataclasses.dataclass
class CraterSamplerConf:
    """Crater distribution tiers (CraterDynamicDistributionConf defaults:
    densities [0.025, 0.05, 0.5], radii [[1.5, 2.5], [0.75, 1.5],
    [0.25, 0.5]])."""

    densities: tuple = (0.025, 0.05, 0.5)
    radius_ranges: tuple = ((1.5, 2.5), (0.75, 1.5), (0.25, 0.5))
    num_repeat: int = 1
    num_profiles: int = 100
    capacity_per_block: int = 2048
    min_xy_ratio: float = 0.85
    max_xy_ratio: float = 1.0
    seed: int = 42
