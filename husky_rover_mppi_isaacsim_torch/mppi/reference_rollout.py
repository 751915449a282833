"""Thesis-convention (python_mppi_projection) 2.5D rollout in plain torch.

Counterpart of ``husky_rover_mppi_isaacsim_tpu/mppi/reference_rollout.py``.
The semantic spec is
``thesis_master/python_mppi_projection/displacement_on_surface.py``, which
differs from the production Warp kernels (and from :mod:`.rollout` and
kernel K1) in three ways, all reproduced here:

* corner indexing ``i = int((x + hw)/res) - 2`` on the *unflipped* grid
  (displacement_on_surface.py:195-201);
* floor-based bilinear fractions (``:254-255``) instead of trunc;
* per-step order: position update *and* heading rotation both use the
  previous step's normal (``update_position``, ``:264-295``), then the new
  cell's normal re-projects the heading.

The JAX package has no Pallas kernel here (its version is an XLA
``lax.scan``), so neither does the port: one eager step per horizon step.
"""

from __future__ import annotations

import torch
from torch import Tensor

from ..core import geometry as geom
from ..core.heightfield import dot3, grid_lookup


def reference_corners(z: Tensor, x: Tensor, y: Tensor, resolution: Tensor,
                      half_width: Tensor) -> Tensor:
    """displacement_on_surface.py:192-203 (the ``-2`` offset quirk intact);
    indices out of the grid follow the JAX gather (wrap a negative index
    once, then clamp)."""
    i = torch.trunc((x + half_width) / resolution).to(torch.int64) - 2
    j = torch.trunc((y + half_width) / resolution).to(torch.int64) - 2
    q00 = grid_lookup(z, i, j)
    q01 = grid_lookup(z, i + 1, j)
    q10 = grid_lookup(z, i, j + 1)
    q11 = grid_lookup(z, i + 1, j + 1)
    return torch.stack([torch.stack([q00, q01], dim=-1), torch.stack([q10, q11], dim=-1)],
                       dim=-2)


def reference_bilinear(x: Tensor, y: Tensor, q: Tensor, resolution: Tensor) -> Tensor:
    """displacement_on_surface.py:239-262 (floor fractions, the same
    transposed weight pairing as the Warp kernel)."""
    xn = x / resolution
    yn = y / resolution
    x2 = xn - torch.floor(xn)
    y2 = yn - torch.floor(yn)
    return ((1.0 - x2) * (1.0 - y2) * q[..., 0, 0]
            + x2 * (1.0 - y2) * q[..., 1, 0]
            + (1.0 - x2) * y2 * q[..., 0, 1]
            + x2 * y2 * q[..., 1, 1])


def _normal(q: Tensor, resolution: Tensor) -> Tensor:
    """displacement_on_surface.py:205-221 (the Warp kernel's formula)."""
    vx = -resolution / 2.0 * (q[..., 0, 1] - q[..., 0, 0] - q[..., 1, 0] + q[..., 1, 1])
    vy = -resolution / 2.0 * (q[..., 1, 0] - q[..., 0, 0] - q[..., 0, 1] + q[..., 1, 1])
    vz = (resolution * resolution).expand_as(vx)
    vec = torch.stack([vx, vy, vz], dim=-1)
    return vec / torch.linalg.vector_norm(vec, dim=-1, keepdim=True)


def _tangent(normal: Tensor, heading: Tensor) -> Tensor:
    """displacement_on_surface.py:223-237."""
    proj = heading - dot3(heading, normal)[..., None] * normal
    return proj / torch.linalg.vector_norm(proj, dim=-1, keepdim=True)


def rollout_25d_reference(z: Tensor, half_width: Tensor, resolution: Tensor, position,
                          heading, linear_velocities: Tensor, angular_velocities: Tensor,
                          dt: float) -> Tensor:
    """Batched thesis-reference trajectory generation
    (displacement_on_surface.py:317-369).

    Arguments as :func:`.rollout.rollout_25d`'s, but on the unflipped grid
    ``z`` (row 0 at y = -half_width); ``half_width`` and ``resolution`` are
    0-d tensors on ``z``'s device. Returns trajectories ``batch + (H, 3)``.
    The reference's out-of-bounds abort (returning None) is a host-side
    concern; like the Warp kernel, this assumes in-window trajectories."""
    lin = torch.as_tensor(linear_velocities)
    ang = torch.as_tensor(angular_velocities, dtype=lin.dtype, device=lin.device)
    batch = lin.shape[:-1]
    pos = torch.as_tensor(position, dtype=lin.dtype, device=lin.device).broadcast_to(batch + (2,))
    hv = torch.as_tensor(heading, dtype=lin.dtype, device=lin.device).broadcast_to(batch + (3,))

    normal = _normal(reference_corners(z, pos[..., 0], pos[..., 1], resolution, half_width),
                     resolution)
    hv = _tangent(normal, hv)
    x, y = pos[..., 0], pos[..., 1]
    steps = []
    for k in range(lin.shape[-1]):
        # update_position (:264-295): displace along the heading, rotate
        # about the PREVIOUS normal (rotvec == Rodrigues), renormalize
        hv = geom.normalize(hv)
        disp = hv * (lin[..., k] * dt)[..., None]
        x = x + disp[..., 0]
        y = y + disp[..., 1]
        hv = geom.normalize(geom.rodrigues_rotate(hv, normal, ang[..., k] * dt))

        q = reference_corners(z, x, y, resolution, half_width)
        height = reference_bilinear(x, y, q, resolution)
        normal = _normal(q, resolution)
        hv = _tangent(normal, hv)
        steps.append(torch.stack([x, y, height], dim=-1))
    return torch.stack(steps, dim=-2)
