"""Geometric layers: domains that map sampler output into world space.

Counterpart of ``husky_rover_mppi_isaacsim_tpu/worldbuilders/layers.py``
(the re-derivation of ``WorldBuilders/Layers.py``, reference :9-1151): each
layer owns a sampler, installs its boundary check, exposes
``__call__(num)`` = sample -> project (pad missing output axes with zeros)
-> optional rigid transform. Point processes receive the layer bounds/area
so densities are per-area.

The bounds, the area and the transform matrix are host config (numpy, as in
the JAX package); the boundary checks, the maps from the sampler's unit
domain, the projection and the transform are float64 torch on the layer's
device. Results equal the JAX package's to the last bits of ``sin`` /
``cos`` / ``pow`` and of the transform's 4-term sums (1e-12 in the tests).
"""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch import Tensor

from ..core.device import run_device
from . import types as T
from ._tensor import F64, f64, quat_from_extrinsic_euler, scalar
from .samplers import Sampler_Factory


def _rot2d(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s], [s, c]])


def _rot3d_from_quat(x, y, z, w):
    q0, q1, q2, q3 = w, x, y, z
    return 2 * np.array([
        [q0 * q0 + q1 * q1, q1 * q2 - q0 * q3, q1 * q3 + q0 * q2],
        [q1 * q2 + q0 * q3, q0 * q0 + q2 * q2, q2 * q3 - q0 * q1],
        [q1 * q3 - q0 * q2, q2 * q3 + q0 * q1, q0 * q0 + q3 * q3],
    ]) - np.eye(3)


def _rot3d_from_euler(x, y, z):
    cx, sx = np.cos(x), np.sin(x)
    cy, sy = np.cos(y), np.sin(y)
    cz, sz = np.cos(z), np.sin(z)
    return np.array([
        [cy * cz, sx * sy * cz - cx * sz, cx * sy * cz + sx * sz],
        [cy * sz, sx * sy * sz + cx * cz, cx * sy * sz - sx * cz],
        [-sy, sx * cy, cx * cy],
    ])


def _in_unit_cube(points: Tensor) -> Tensor:
    return torch.all((points >= 0) & (points <= 1), dim=-1)


class BaseLayer:
    def __init__(self, layer_cfg: T.Layer_T, sampler_cfg, device=None):
        self.device = run_device(device)
        self._layer_cfg = copy.copy(layer_cfg)
        self._sampler_cfg = copy.copy(sampler_cfg)
        self._skip_projection = (
            layer_cfg.output_space == sampler_cfg.randomization_space
        )
        self._T = None
        if layer_cfg.transform is not None:
            tr = layer_cfg.transform
            if isinstance(tr, T.Transformation2D_T):
                mat = np.eye(3)
                mat[:2, :2] = _rot2d(tr.orientation.theta)
                mat[:2, 2] = [tr.translation.x, tr.translation.y]
            else:
                mat = np.eye(4)
                o = tr.orientation
                if isinstance(o, T.Quaternion_T):
                    mat[:3, :3] = _rot3d_from_quat(o.x, o.y, o.z, o.w)
                else:
                    mat[:3, :3] = _rot3d_from_euler(o.x, o.y, o.z)
                mat[:3, 3] = [tr.translation.x, tr.translation.y, tr.translation.z]
            self._T = f64(mat, self.device)
        self.get_bounds()
        self._sampler = Sampler_Factory.get(self._sampler_cfg, device=self.device)
        self._sampler.set_check_fn(self.check_boundaries)
        self._area = getattr(self, "_area", None)

    # overridables -----------------------------------------------------------
    def get_bounds(self):
        self._bounds = None

    def check_boundaries(self, points: Tensor) -> Tensor:
        return torch.ones(points.shape[0], dtype=torch.bool, device=points.device)

    def sample(self, num=1, **kwargs):
        return self._sampler(num=num, bounds=self._bounds, area=self._area, **kwargs)

    # pipeline ---------------------------------------------------------------
    def project(self, points: Tensor) -> Tensor:
        if self._skip_projection:
            return points
        pad = self._layer_cfg.output_space - points.shape[-1]
        if pad <= 0:
            return points
        return torch.cat([points, points.new_zeros((points.shape[0], pad))], dim=-1)

    def transform(self, points: Tensor) -> Tensor:
        if self._T is None:
            return points
        ones = points.new_ones((points.shape[0], 1))
        return (self._T @ torch.cat([points, ones], dim=-1).T).T[:, :-1]

    def __call__(self, num=1, **kwargs):
        points = self.sample(num=num, **kwargs)
        return self.transform(self.project(points))


class LineLayer(BaseLayer):
    """Layers.py:360-414."""

    def get_bounds(self):
        self._bounds = np.array([[self._layer_cfg.xmin, self._layer_cfg.xmax]])

    def check_boundaries(self, points):
        return (points[:, 0] >= self._layer_cfg.xmin) & (points[:, 0] <= self._layer_cfg.xmax)


class CircleLayer(BaseLayer):
    """Angle domain mapped onto an (alpha, beta)-scaled circle
    (Layers.py:416-497)."""

    def get_bounds(self):
        self._bounds = np.array([[self._layer_cfg.theta_min, self._layer_cfg.theta_max]])

    def check_boundaries(self, points):
        return ((points[:, 0] >= self._layer_cfg.theta_min)
                & (points[:, 0] <= self._layer_cfg.theta_max))

    def sample(self, num=1, **kwargs):
        cfg = self._layer_cfg
        theta = self._sampler(num=num, bounds=self._bounds, **kwargs).reshape(-1)
        x = cfg.center[0] + torch.cos(theta) * cfg.radius * cfg.alpha
        y = cfg.center[1] + torch.sin(theta) * cfg.radius * cfg.beta
        return torch.stack([x, y], dim=1)


class PlaneLayer(BaseLayer):
    """Layers.py:498-557."""

    def get_bounds(self):
        cfg = self._layer_cfg
        self._bounds = np.array([[cfg.xmin, cfg.xmax], [cfg.ymin, cfg.ymax]])

    def check_boundaries(self, points):
        cfg = self._layer_cfg
        return ((points[:, 0] >= cfg.xmin) & (points[:, 0] <= cfg.xmax)
                & (points[:, 1] >= cfg.ymin) & (points[:, 1] <= cfg.ymax))


class DiskLayer(BaseLayer):
    """Unit-square sampler output mapped to an annular sector with
    area-correct sqrt radial warp (Layers.py:558-632)."""

    def get_bounds(self):
        cfg = self._layer_cfg
        self._bounds = np.array([[0.0, 1.0], [0.0, 1.0]])
        # reference formula as it is (Layers.py:608). NOTE: the true
        # annular-sector area is 0.5*dtheta*(r_max^2 - r_min^2); the
        # reference's (dtheta)*(dr)^2 mis-scales Poisson intensities on
        # disks, kept for parity with upstream scene densities.
        self._area = (cfg.theta_max - cfg.theta_min) * (cfg.radius_max - cfg.radius_min) ** 2

    def check_boundaries(self, points):
        return _in_unit_cube(points)

    def sample(self, num=1, **kwargs):
        cfg = self._layer_cfg
        rand = self._sampler(num=num, bounds=self._bounds, area=self._area, **kwargs)
        rmin_n = (cfg.radius_min / max(cfg.radius_max, 1e-12)) ** 2
        r = torch.sqrt(rmin_n + rand[:, 0] * (1.0 - rmin_n)) * cfg.radius_max
        t = cfg.theta_min + rand[:, 1] * (cfg.theta_max - cfg.theta_min)
        x = cfg.center[0] + torch.cos(t) * r * cfg.alpha
        y = cfg.center[1] + torch.sin(t) * r * cfg.beta
        return torch.stack([x, y], dim=1)


class PolygonLayer(BaseLayer):
    """Uniform sampling inside a simple polygon by bounding-box rejection
    (Layers.py Polygon_T handling); the even-odd ray test per edge."""

    def get_bounds(self):
        v = np.asarray(self._layer_cfg.vertices, dtype=float)
        self._vertices = v
        self._bounds = np.array([[v[:, 0].min(), v[:, 0].max()],
                                 [v[:, 1].min(), v[:, 1].max()]])

    def check_boundaries(self, points):
        v = self._vertices.tolist()  # Python floats: no numpy scalar meets a tensor
        n = len(v)
        inside = torch.zeros(points.shape[0], dtype=torch.bool, device=points.device)
        x, y = points[:, 0], points[:, 1]
        j = n - 1
        for i in range(n):
            dy = scalar(v[j][1] - v[i][1] + 1e-30, points.device)
            cond = ((y < v[i][1]) != (y < v[j][1])) & (
                x < (v[j][0] - v[i][0]) * (y - v[i][1]) / dy + v[i][0])
            inside ^= cond
            j = i
        return inside

    def sample(self, num=1, **kwargs):
        pts = self._sampler(num=num, bounds=self._bounds, **kwargs)
        return pts[self.check_boundaries(pts)]


class CubeLayer(BaseLayer):
    """Layers.py:633-694."""

    def get_bounds(self):
        cfg = self._layer_cfg
        self._bounds = np.array([[cfg.xmin, cfg.xmax], [cfg.ymin, cfg.ymax],
                                 [cfg.zmin, cfg.zmax]])

    def check_boundaries(self, points):
        cfg = self._layer_cfg
        return ((points[:, 0] >= cfg.xmin) & (points[:, 0] <= cfg.xmax)
                & (points[:, 1] >= cfg.ymin) & (points[:, 1] <= cfg.ymax)
                & (points[:, 2] >= cfg.zmin) & (points[:, 2] <= cfg.zmax))


class SphereLayer(BaseLayer):
    """Unit-cube output mapped to a spherical shell sector with cube-root
    radial warp (Layers.py:762-843)."""

    def get_bounds(self):
        self._bounds = np.array([[0.0, 1.0]] * 3)

    def check_boundaries(self, points):
        return _in_unit_cube(points)

    def sample(self, num=1, **kwargs):
        cfg = self._layer_cfg
        rand = self._sampler(num=num, bounds=self._bounds, **kwargs)
        rmin_n = (cfg.radius_min / max(cfg.radius_max, 1e-12)) ** 3
        r = torch.pow(rmin_n + rand[:, 0] * (1 - rmin_n), 1.0 / 3.0) * cfg.radius_max
        t = cfg.theta_min + rand[:, 1] * (cfg.theta_max - cfg.theta_min)
        p = cfg.phi_min + rand[:, 2] * (cfg.phi_max - cfg.phi_min)
        x = cfg.center[0] + r * torch.sin(p) * torch.cos(t)
        y = cfg.center[1] + r * torch.sin(p) * torch.sin(t)
        z = cfg.center[2] + r * torch.cos(p)
        return torch.stack([x, y, z], dim=1)


class CylinderLayer(BaseLayer):
    """Layers.py:844-925."""

    def get_bounds(self):
        self._bounds = np.array([[0.0, 1.0]] * 3)

    def check_boundaries(self, points):
        return _in_unit_cube(points)

    def sample(self, num=1, **kwargs):
        cfg = self._layer_cfg
        rand = self._sampler(num=num, bounds=self._bounds, **kwargs)
        rmin_n = (cfg.radius_min / max(cfg.radius_max, 1e-12)) ** 2
        r = torch.sqrt(rmin_n + rand[:, 0] * (1 - rmin_n)) * cfg.radius_max
        t = cfg.theta_min + rand[:, 1] * (cfg.theta_max - cfg.theta_min)
        h = cfg.height_min + rand[:, 2] * (cfg.height_max - cfg.height_min)
        x = cfg.center[0] + r * torch.cos(t)
        y = cfg.center[1] + r * torch.sin(t)
        z = cfg.center[2] + h
        return torch.stack([x, y, z], dim=1)


class ConeLayer(BaseLayer):
    """Radius shrinking linearly with height (Layers.py:926-1007)."""

    def get_bounds(self):
        self._bounds = np.array([[0.0, 1.0]] * 3)

    def check_boundaries(self, points):
        return _in_unit_cube(points)

    def sample(self, num=1, **kwargs):
        cfg = self._layer_cfg
        rand = self._sampler(num=num, bounds=self._bounds, **kwargs)
        h = cfg.height_min + rand[:, 2] * (cfg.height_max - cfg.height_min)
        span = scalar(max(cfg.height_max - cfg.height_min, 1e-12), rand.device)
        frac = 1.0 - (h - cfg.height_min) / span
        r_top = cfg.radius_min + frac * (cfg.radius_max - cfg.radius_min)
        r = torch.sqrt(rand[:, 0]) * r_top
        t = cfg.theta_min + rand[:, 1] * (cfg.theta_max - cfg.theta_min)
        x = cfg.center[0] + r * torch.cos(t)
        y = cfg.center[1] + r * torch.sin(t)
        z = cfg.center[2] + h
        return torch.stack([x, y, z], dim=1)


class TorusLayer(BaseLayer):
    """Layers.py:1008-1091."""

    def get_bounds(self):
        self._bounds = np.array([[0.0, 1.0]] * 3)

    def check_boundaries(self, points):
        return _in_unit_cube(points)

    def sample(self, num=1, **kwargs):
        cfg = self._layer_cfg
        rand = self._sampler(num=num, bounds=self._bounds, **kwargs)
        rmin_n = (cfg.tube_radius_min / max(cfg.tube_radius_max, 1e-12)) ** 2
        r = torch.sqrt(rmin_n + rand[:, 0] * (1 - rmin_n)) * cfg.tube_radius_max
        t = cfg.theta_min + rand[:, 1] * (cfg.theta_max - cfg.theta_min)
        p = cfg.phi_min + rand[:, 2] * (cfg.phi_max - cfg.phi_min)
        x = cfg.center[0] + (cfg.ring_radius + r * torch.cos(p)) * torch.cos(t)
        y = cfg.center[1] + (cfg.ring_radius + r * torch.cos(p)) * torch.sin(t)
        z = cfg.center[2] + r * torch.sin(p)
        return torch.stack([x, y, z], dim=1)


class ImageLayer(BaseLayer):
    """Mask-weighted sampling domain (Layers.py:267-322): the sampler draws
    pixels proportional to the mask."""

    def __init__(self, layer_cfg, sampler_cfg, device=None):
        super().__init__(layer_cfg, sampler_cfg, device=device)
        self._sampler.set_mask(np.asarray(layer_cfg.data, float), layer_cfg.mpp_resolution)
        self._sampler._cfg.use_image_sampling = True

    def get_bounds(self):
        data = np.asarray(self._layer_cfg.data)
        mpp = self._layer_cfg.mpp_resolution
        self._bounds = np.array([[0.0, data.shape[1] * mpp], [0.0, data.shape[0] * mpp]])


class RollPitchYawLayer(BaseLayer):
    """Uniform Euler ranges -> quaternion xyzw (Layers.py:695-761): scipy's
    extrinsic ``from_euler("xyz")``, written out in torch."""

    def get_bounds(self):
        cfg = self._layer_cfg
        self._bounds = np.array([[cfg.rmin, cfg.rmax], [cfg.pmin, cfg.pmax],
                                 [cfg.ymin, cfg.ymax]])

    def sample(self, num=1, **kwargs):
        rpy = self._sampler(num=num, bounds=self._bounds, **kwargs)
        return quat_from_extrinsic_euler("xyz", rpy.to(F64))


class LayerFactory:
    def __init__(self):
        self._creators = {}

    def register(self, name, cls):
        self._creators[name] = cls

    def get(self, layer_cfg, sampler_cfg, device=None, **kwargs):
        """The layer for ``layer_cfg`` with its sampler, on ``device``
        (default: the card, see :func:`..core.device.run_device`)."""
        name = layer_cfg.__class__.__name__
        if name not in self._creators:
            raise ValueError(f"Unknown layer requested: {name}")
        return self._creators[name](layer_cfg, sampler_cfg, device=device)


Layer_Factory = LayerFactory()
Layer_Factory.register("Line_T", LineLayer)
Layer_Factory.register("Circle_T", CircleLayer)
Layer_Factory.register("Plane_T", PlaneLayer)
Layer_Factory.register("Disk_T", DiskLayer)
Layer_Factory.register("Polygon_T", PolygonLayer)
Layer_Factory.register("Cube_T", CubeLayer)
Layer_Factory.register("Sphere_T", SphereLayer)
Layer_Factory.register("Cylinder_T", CylinderLayer)
Layer_Factory.register("Cone_T", ConeLayer)
Layer_Factory.register("Torus_T", TorusLayer)
Layer_Factory.register("Image_T", ImageLayer)
Layer_Factory.register("RollPitchYaw_T", RollPitchYawLayer)
