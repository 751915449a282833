"""Clippers: DEM-conditioned post-processing of sampled positions.

Counterpart of ``husky_rover_mppi_isaacsim_tpu/worldbuilders/clippers.py``
(the re-derivation of ``WorldBuilders/Clippers.py``, reference :5-103):

- :class:`HeightClipper`: z = DEM[uv(x, y)] with the three origin modes;
- :class:`NormalMapClipper`: DEM gradient -> slope angles -> quaternion
  (the reference's ``quaternion`` package call, scipy's extrinsic
  ``from_euler("zyz")`` in the JAX package, written out in torch; the
  reference feeds *degrees* into a radians API, kept as it is).

The DEM is held on the clipper's device (a tensor there is used as it is);
the lookups run there. ``x // mpp`` is numpy's floor division
(``torch.div(..., rounding_mode="floor")`` by a 0-d device tensor: the
same fmod-based quotient), so points on cell borders land in the JAX
package's cells.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from ..core.device import run_device
from . import types as T
from ._tensor import F64, quat_from_extrinsic_euler, scalar


def _gradient(f: Tensor, dim: int) -> Tensor:
    """``np.gradient`` along ``dim`` with unit spacing: central differences
    halved inside, one-sided differences at the two edges (edge_order 1)."""
    n = f.shape[dim]
    out = torch.empty_like(f)
    out.narrow(dim, 1, n - 2).copy_((f.narrow(dim, 2, n - 2) - f.narrow(dim, 0, n - 2)) / 2.0)
    out.narrow(dim, 0, 1).copy_(f.narrow(dim, 1, 1) - f.narrow(dim, 0, 1))
    out.narrow(dim, n - 1, 1).copy_(f.narrow(dim, n - 1, 1) - f.narrow(dim, n - 2, 1))
    return out


class BaseClipper:
    def __init__(self, cfg: T.Clipper_T, device=None):
        self._cfg = cfg
        self.device = run_device(device)
        data = cfg.data
        self.image = (data.to(self.device) if isinstance(data, Tensor)
                      else torch.as_tensor(np.asarray(data), device=self.device))
        self.resolution = cfg.resolution
        self.mpp_resolution = cfg.mpp_resolution
        assert self.image.ndim == 2, "clipper image must be single-channel"
        self._mpp = scalar(float(cfg.mpp_resolution), self.device)

    def _to_uv(self, x: Tensor, y: Tensor):
        """Cartesian -> pixel coordinates per origin mode (Clippers.py:31-43)."""
        H, W = self.resolution
        fx = torch.div(x, self._mpp, rounding_mode="floor")
        fy = torch.div(y, self._mpp, rounding_mode="floor")
        if self._cfg.loc_origin == "lower":
            u, v = fx, (H - 1) - fy
        elif self._cfg.loc_origin == "upper":
            u, v = fx, fy
        else:  # center
            u, v = W // 2 + fx, H // 2 + fy
        u = torch.clamp(u.to(torch.int64), 0, self.image.shape[1] - 1)
        v = torch.clamp(v.to(torch.int64), 0, self.image.shape[0] - 1)
        return u, v

    def __call__(self, query_point=None, **kwargs):
        return self.sample(query_point=query_point, **kwargs)


class HeightClipper(BaseClipper):
    """z lookup (Clippers.py:20-46), in the DEM's dtype."""

    def sample(self, query_point, **kwargs):
        q = torch.as_tensor(query_point, device=self.device)
        u, v = self._to_uv(q[:, 0], q[:, 1])
        return self.image[v, u][:, None]


class NormalMapClipper(BaseClipper):
    """Gradient -> slope -> quaternion (Clippers.py:48-87). The reference
    computes slopes in degrees and passes them to a radians-based
    from_euler_angles, kept as it is for behavioral parity.

    The slopes are in the DEM's dtype (float64 for an integer DEM), as
    numpy's are; each ``atan2`` is evaluated in float64 and rounded to that
    dtype, so a float32 DEM's slopes agree between the card and the CPU
    (numpy's float32 ``arctan2`` is not correctly rounded: the JAX
    package's slopes differ from these in the last bit)."""

    def __init__(self, cfg: T.NormalMapClipper_T, device=None):
        super().__init__(cfg, device=device)
        img = self.image if self.image.is_floating_point() else self.image.to(F64)
        one = torch.ones((), dtype=F64, device=self.device)
        # numpy's rad2deg multiplies by 180/pi rounded to the array's dtype
        to_deg = scalar(180.0, self.device, img.dtype) / scalar(np.pi, self.device, img.dtype)
        self.slope_x, self.slope_y = (
            torch.atan2(_gradient(img, d).to(F64), one).to(img.dtype) * to_deg for d in (0, 1))

    def sample(self, query_point, **kwargs):
        q = torch.as_tensor(query_point, device=self.device)
        u, v = self._to_uv(q[:, 0], q[:, 1])
        roll = self.slope_y[v, u].to(F64)
        pitch = self.slope_x[v, u].to(F64)
        quat = quat_from_extrinsic_euler("zyz", torch.stack(
            [roll, pitch, torch.zeros_like(roll)], dim=-1))
        # wxyz, numpy-quaternion's as_float_array order
        return torch.cat([quat[:, 3:4], quat[:, 0:3]], dim=-1)


class ClipperFactory:
    def __init__(self):
        self._creators = {}

    def register(self, name, cls):
        self._creators[name] = cls

    def get(self, cfg, device=None, **kwargs):
        """The clipper for ``cfg`` with its DEM on ``device`` (default: the
        card, see :func:`..core.device.run_device`)."""
        name = cfg.__class__.__name__
        if name not in self._creators:
            raise ValueError(f"Unknown clipper requested: {name}")
        return self._creators[name](cfg, device=device)


Clipper_Factory = ClipperFactory()
Clipper_Factory.register("ImageClipper_T", HeightClipper)
Clipper_Factory.register("NormalMapClipper_T", NormalMapClipper)
