"""Wheel-track terrain deformation engine.

Counterpart of ``husky_rover_mppi_isaacsim_tpu/physics/deformation.py``, the
re-derivation of ``src/terrain_management/deformation_engine.py``
(:22-721): a grid footprint of points per wheel, a separable depth model
``boundary(y) * (amplitude(F) * depth(x) - mean(F))`` with uniform /
sinusoidal / trapezoidal profiles, rotated into the world frame by the link
yaw and stamped into the DEM with a per-pixel pass-count decay. As in the
JAX package the decay reads the pass counts from before the stamp.

The stamp is a plain scatter (the JAX package's ``.at[r, c].add``, no
kernel). It is deterministic on the card: footprint points that share a
pixel are summed first, by one fixed-order reduction over a points x points
equality mask, and the scatter then adds one nonzero value per pixel (the
other points of the pixel add an exact 0.0), so no accumulation order can
change a bit. The stamp writes the DEM and the pass counts in place.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import Tensor


@dataclasses.dataclass
class FootprintConf:
    """deformation_engine.py FootprintConf: wheel contact patch (m)."""

    width: float = 0.25
    height: float = 0.1


@dataclasses.dataclass
class DeformConstrainConf:
    x_deform_offset: float = 0.0
    y_deform_offset: float = 0.0
    deform_decay_ratio: float = 0.01


@dataclasses.dataclass
class DepthDistributionConf:
    distribution: str = "sinusoidal"   # uniform | sinusoidal | trapezoidal
    wave_frequency: float = 4.14       # sinusoidal grouser frequency
    tail_size: float = 0.2             # trapezoidal parameter


@dataclasses.dataclass
class BoundaryDistributionConf:
    distribution: str = "trapezoidal"  # uniform | parabolic | trapezoidal
    angle_of_repose: float = 1.047


@dataclasses.dataclass
class ForceDepthRegressionConf:
    """Linear force -> depth regression (deformation_engine.py:666-680)."""

    amplitude_slope: float = 0.00006
    amplitude_intercept: float = 0.008
    mean_slope: float = -0.00046
    mean_intercept: float = -0.0013


@dataclasses.dataclass
class DeformationEngineConf:
    enable: bool = True
    render_deform_inv: int = 10
    terrain_resolution: float = 0.05
    terrain_width: float = 50.0
    terrain_height: float = 50.0
    footprint: FootprintConf = dataclasses.field(default_factory=FootprintConf)
    constrain: DeformConstrainConf = dataclasses.field(default_factory=DeformConstrainConf)
    depth: DepthDistributionConf = dataclasses.field(default_factory=DepthDistributionConf)
    boundary: BoundaryDistributionConf = dataclasses.field(
        default_factory=BoundaryDistributionConf)
    regression: ForceDepthRegressionConf = dataclasses.field(
        default_factory=ForceDepthRegressionConf)


def _trapezoid_wave(x: np.ndarray, period: float = 1.0) -> np.ndarray:
    """Unit trapezoid wave (deformation_engine.py:256-293 semantics)."""
    saw = (x / period) % 1.0
    return np.clip(np.minimum(saw, 1.0 - saw) * 4.0, 0.0, 1.0)


def _stamp(dem: Tensor, num_pass: Tensor, rows: Tensor, cols: Tensor, depth: Tensor,
           decay_ratio: float) -> None:
    """Add ``depth * ratio ** num_pass`` at every (row, col), in place, and
    one pass per point to ``num_pass``; the decay reads the counts from
    before the stamp. Points sharing a pixel are summed in a fixed order
    (see the module docstring)."""
    flat = rows * dem.shape[1] + cols
    decay = torch.pow(torch.full((), decay_ratio, dtype=torch.float32, device=dem.device),
                      num_pass[rows, cols].to(torch.float32))
    value = (depth * decay).to(dem.dtype)
    same = flat[:, None] == flat[None, :]
    summed = torch.sum(torch.where(same, value[None, :], torch.zeros_like(value)[None, :]),
                       dim=1)
    later = torch.triu(same, diagonal=1).any(dim=0)  # a copy of an earlier point
    dem.index_put_((rows, cols), torch.where(later, torch.zeros_like(summed), summed),
                   accumulate=True)
    num_pass.index_put_((rows, cols), torch.ones_like(rows, dtype=num_pass.dtype),
                        accumulate=True)


class DeformationEngine:
    """Vectorized deformation engine over a DEM and its pass counts."""

    def __init__(self, conf: DeformationEngineConf):
        self.conf = conf
        res = conf.terrain_resolution
        fp = conf.footprint
        # footprint grid in the link frame (FootprintProfileGenerator,
        # deformation_engine.py:40-66)
        x = (np.linspace(-fp.height / 2, fp.height / 2, int(fp.height / res) + 1)
             + conf.constrain.x_deform_offset)
        y = (np.linspace(-fp.width / 2, fp.width / 2, int(fp.width / res) + 1)
             + conf.constrain.y_deform_offset)
        xx, yy = np.meshgrid(x, y)
        self.profile = np.column_stack([xx.flatten(), yy.flatten()])
        self.px_width = xx.shape[0]   # number of y rows
        self.px_height = yy.shape[1]  # number of x columns
        self.depth_dist_np = self._depth_distribution().astype(np.float32)
        self.boundary_dist_np = self._boundary_distribution().astype(np.float32)
        self.profile_np = self.profile.astype(np.float32)
        self.sim_height = int(conf.terrain_height / res)
        self._tables: dict = {}

    def _on(self, device) -> tuple[Tensor, Tensor, Tensor]:
        """(depth, boundary, profile) float32 tables on ``device``, made once."""
        device = torch.device(device)
        if device not in self._tables:
            self._tables[device] = tuple(torch.from_numpy(a).to(device) for a in (
                self.depth_dist_np, self.boundary_dist_np, self.profile_np))
        return self._tables[device]

    # distributions (deformation_engine.py:125-542) -------------------------
    def _depth_distribution(self) -> np.ndarray:
        t = np.linspace(-1, 1, self.px_height)
        kind = self.conf.depth.distribution
        if kind == "uniform":
            slice_x = np.ones(self.px_height, np.float32)
        elif kind == "sinusoidal":
            slice_x = np.cos(self.conf.depth.wave_frequency * np.pi * t)
        elif kind == "trapezoidal":
            slice_x = _trapezoid_wave(t / self.conf.depth.tail_size)
        else:
            raise ValueError(kind)
        return np.repeat(slice_x[None, :], self.px_width, axis=0).reshape(-1)

    def _boundary_distribution(self) -> np.ndarray:
        y = np.linspace(-1, 1, self.px_width)
        kind = self.conf.boundary.distribution
        if kind == "uniform":
            slice_y = -np.ones(self.px_width, np.float32)
        elif kind == "parabolic":
            slice_y = y**2 - 1
        elif kind == "trapezoidal":
            tan = np.tan(self.conf.boundary.angle_of_repose)
            mask = (np.abs(y) >= 1 - (1 / tan)).astype(np.float32)
            slice_y = mask * (tan * np.abs(y) - tan + 1) - 1
        else:
            raise ValueError(kind)
        return np.repeat(slice_y[:, None], self.px_height, axis=1).reshape(-1)

    # force model (deformation_engine.py:666-694) ---------------------------
    def deformation_depth(self, normal_forces: Tensor) -> Tensor:
        """Per-(link, point) deformation depth, flattened."""
        depth_dist, boundary_dist, _ = self._on(normal_forces.device)
        reg = self.conf.regression
        amplitude = reg.amplitude_slope * normal_forces + reg.amplitude_intercept
        mean = reg.mean_slope * normal_forces + reg.mean_intercept
        return (boundary_dist[None, :]
                * (amplitude[:, None] * depth_dist[None, :] - mean[:, None])).reshape(-1)

    def footprint_in_global(self, positions: Tensor, orientations: Tensor) -> Tensor:
        """Rotate the footprint into the world frame by the link yaw
        (get_footprint_profile_in_global, deformation_engine.py:648-664;
        orientations are wxyz scalar-first quaternions, whose heading the
        reference reads as ``hx = 2 w z``, ``hy = 1 - 2 z**2``)."""
        _, _, profile = self._on(positions.device)
        hx = 2.0 * orientations[:, 0] * orientations[:, 3]
        hy = 1.0 - 2.0 * orientations[:, 3] * orientations[:, 3]
        px = (profile[None, :, 0] * hy[:, None] - profile[None, :, 1] * hx[:, None]
              + positions[:, 0][:, None])
        py = (profile[None, :, 0] * hx[:, None] + profile[None, :, 1] * hy[:, None]
              + positions[:, 1][:, None])
        return torch.stack([px, py], dim=-1).reshape(-1, 2)

    def deform(self, dem: Tensor, num_pass: Tensor, positions: Tensor,
               orientations: Tensor, normal_forces: Tensor) -> tuple[Tensor, Tensor]:
        """Stamp all footprints into the fixed lab grid (deform,
        deformation_engine.py:695-721), in place.

        Args:
            dem: (H, W); num_pass: (H, W) int32; positions (n, 3);
            orientations (n, 4) wxyz (scalar-first); normal_forces (n,).
        Returns ``(dem, num_pass)``, the tensors given.
        """
        res = torch.full((), self.conf.terrain_resolution, dtype=positions.dtype,
                         device=positions.device)
        pts = self.footprint_in_global(positions, orientations)
        depth = self.deformation_depth(normal_forces)
        x = torch.trunc(pts[:, 0] / res).to(torch.int64)
        y = (self.sim_height - torch.trunc(pts[:, 1] / res)).to(torch.int64)
        x = torch.clamp(x, 0, dem.shape[1] - 1)
        y = torch.clamp(y, 0, dem.shape[0] - 1)
        _stamp(dem, num_pass, y, x, depth, self.conf.constrain.deform_decay_ratio)
        return dem, num_pass

    def deform_window(self, window: Tensor, num_pass: Tensor, resolution, origin,
                      positions, yaws, normal_forces) -> tuple[Tensor, Tensor]:
        """Stamp footprints into a streamed world window (row = world x,
        col = world y, the TerrainStreamer layout), in place: the
        streamed-terrain deformation the reference applies from robot
        contacts each sim tick (simulation_manager_ros2.py:231-233 ->
        deformation_engine.py:695-721), retargeted at the live window.

        Args:
            window: (H, W) heights, row = world x, col = world y.
            num_pass: (H, W) int32 per-pixel pass counts.
            resolution: window meters/px (a float or a 0-d tensor).
            origin: world coordinate of window pixel [0, 0] (floats or 0-d
                tensors).
            positions: (n, 2) world xy per link (wheel).
            yaws: (n,) world yaw per link (rad).
            normal_forces: (n,) contact normal force per link.
        Returns ``(window, num_pass)``, the tensors given.
        """
        dev = window.device
        f32 = dict(dtype=torch.float32, device=dev)
        positions = torch.as_tensor(positions, **f32)
        yaws = torch.as_tensor(yaws, **f32)
        # quaternion components that reproduce the reference's heading
        # extraction (hx = 2 q0 q3 = sin yaw, hy = 1 - 2 q3^2 = cos yaw)
        half = yaws / 2.0
        zero = torch.zeros_like(half)
        quats = torch.stack([torch.cos(half), zero, zero, torch.sin(half)], dim=-1)
        pts = self.footprint_in_global(positions, quats)
        depth = self.deformation_depth(torch.as_tensor(normal_forces, **f32))
        # a Python float becomes a filled 0-d tensor (``torch.tensor`` on the
        # card waits for the stream), and the division by a tensor is a true
        # division on the card too
        scalar = lambda v: (v.to(**f32) if isinstance(v, Tensor)  # noqa: E731
                            else torch.full((), float(v), **f32))
        ox, oy = scalar(origin[0]), scalar(origin[1])
        res = scalar(resolution)
        r = torch.trunc((pts[:, 0] - ox) / res).to(torch.int64)
        c = torch.trunc((pts[:, 1] - oy) / res).to(torch.int64)
        r = torch.clamp(r, 0, window.shape[0] - 1)
        c = torch.clamp(c, 0, window.shape[1] - 1)
        _stamp(window, num_pass, r, c, depth, self.conf.constrain.deform_decay_ratio)
        return window, num_pass
