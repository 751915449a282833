"""Obstacle costmap construction: the regenerated 750-obstacle field.

Counterpart of ``husky_rover_mppi_isaacsim_tpu/terrain/costmap.py``:
:func:`generate_obstacles` and :func:`rasterize_obstacles` are numpy copies
of the JAX package's (whose module imports jax). The costmap comes from one
of two distance transforms, as in the JAX package:

* :func:`reference_costmap` (host numpy): the cv2-compatible 5x5 chamfer
  (:func:`..ops.edt.chamfer5`), the default of :func:`costmap_750`;
* :func:`device_costmap`: the exact EDT (:mod:`..ops.edt`) on the requested
  device, whose envelope is kernel K2 on the card; the default of
  :func:`update_costmap_with_obstacles`, and what every world build of the
  package asks for (``use_exact_edt=True``).

:func:`costmap_750` takes any ``size``: 750 for the standalone world, 1500
(0.1 m/px) for the thesis statistics protocol.
:func:`update_costmap_with_obstacles` is the streamed-terrain rebuild from
the rock manager's obstacles.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from ..mppi.critics import Costmap
from ..ops.edt import chamfer5, distance_costmap


def generate_obstacles(num: int = 750, seed: int = 99, extent: float = 50.0,
                       r_max: float = 0.4) -> np.ndarray:
    """The deterministic 750-obstacle field (MPPI_OO_current.py:722-726 draw
    order: x, y, r per obstacle). Returns (num, 3) [x, y, radius]."""
    rng = np.random.RandomState(seed)
    obstacles = np.empty((num, 3))
    for i in range(num):
        obstacles[i, 0] = rng.uniform(-extent, extent)
        obstacles[i, 1] = rng.uniform(-extent, extent)
        obstacles[i, 2] = rng.uniform(0.0, r_max)
    return obstacles


def rasterize_obstacles(obstacles: np.ndarray, origin=(0.0, 0.0),
                        half_width: float = 75.0, size: int = 750,
                        robot_radius: float = 1.2, margin: float = 0.1) -> np.ndarray:
    """Binary occupancy image, 255 = free / 0 = obstacle (uint8), with the
    reference's swapped local frame ``x_local = y_g - y0``,
    ``y_local = x_g - x0`` (MPPI_isaac.py:361-372)."""
    lin = np.linspace(-half_width, half_width, size)
    spacing = 2.0 * half_width / (size - 1)
    img = 255 * np.ones((size, size), dtype=np.uint8)
    x0, y0 = origin
    for xg, yg, r in obstacles:
        x_local = yg - y0
        y_local = xg - x0
        total_radius = r / 2.0 + robot_radius + margin
        # bounding-box clip: the same mask as the reference's full-grid one
        c0 = max(0, int(np.floor((x_local - total_radius + half_width) / spacing)))
        c1 = min(size, int(np.ceil((x_local + total_radius + half_width) / spacing)) + 1)
        r0 = max(0, int(np.floor((y_local - total_radius + half_width) / spacing)))
        r1 = min(size, int(np.ceil((y_local + total_radius + half_width) / spacing)) + 1)
        if c0 >= c1 or r0 >= r1:
            continue
        sub_x = lin[c0:c1][None, :]
        sub_y = lin[r0:r1][:, None]
        mask = (sub_x - x_local) ** 2 + (sub_y - y_local) ** 2 <= total_radius**2
        img[r0:r1, c0:c1][mask] = 0
    return img


def reference_costmap(binary_free: np.ndarray, falloff_power: float = 20.0) -> np.ndarray:
    """Host costmap with cv2-chamfer parity (MPPI_isaac.py:374-377):
    chamfer-5 distance transform, min-max normalize, ``(1-d)^p``."""
    d = chamfer5(binary_free)
    d = (d - d.min()) / (d.max() - d.min())
    return (1.0 - d) ** falloff_power


def _falloff_costmap(binary: np.ndarray, falloff_power: float, use_exact_edt: bool, device):
    if use_exact_edt:
        return device_costmap(binary, falloff_power, device=device)
    return reference_costmap(binary, falloff_power)


def device_costmap(binary_free, falloff_power: float = 20.0, device=None) -> Tensor:
    """Costmap of a free/obstacle image via the exact EDT on ``device``."""
    occupied = torch.as_tensor(np.asarray(binary_free) == 0, device=device)
    return distance_costmap(occupied, falloff_power)


def as_costmap(cost, half_width: float, dtype=None, device=None) -> Costmap:
    """Wrap a cost image in the critic-facing :class:`Costmap` window."""
    cost = torch.as_tensor(cost, dtype=dtype, device=device)
    scalar = lambda v: torch.tensor(v, dtype=cost.dtype, device=cost.device)  # noqa: E731
    return Costmap(cost=cost, half_width=scalar(half_width),
                   resolution=scalar(2.0 * half_width / cost.shape[-1]))


def costmap_750(half_width: float = 75.0, size: int = 750, robot_radius: float = 0.3,
                falloff_power: float = 20.0, use_exact_edt: bool = False,
                dtype=torch.float32, device=None) -> Costmap:
    """The regenerated ``costmap_750_transformed`` fixture as a
    :class:`Costmap` on ``device``: the cv2-chamfer costmap by default (built
    on the host), the exact EDT with ``use_exact_edt``. ``robot_radius`` is
    the 0.3 m of the imported-map Surface (MPPI_OO_current.py:744), not the
    1.2 m wheel track."""
    binary = rasterize_obstacles(generate_obstacles(), half_width=half_width,
                                 size=size, robot_radius=robot_radius)
    cost = _falloff_costmap(binary, falloff_power, use_exact_edt, device)
    return as_costmap(cost, half_width, dtype=dtype, device=device)


def update_costmap_with_obstacles(costmap_size: int, half_width: float,
                                  obstacles_xy: np.ndarray, radii: np.ndarray,
                                  robot_radius: float, falloff_power: float = 20.0,
                                  use_exact_edt: bool = True, origin=(0.0, 0.0),
                                  dtype=torch.float32, device=None) -> Costmap:
    """Streamed-terrain costmap rebuild: rocks become obstacle disks, then
    the distance falloff on ``device`` (the exact EDT unless
    ``use_exact_edt`` is false: then the host chamfer)
    (visual_terrain_stack_full_terrain.py:546-576 rebuild path). ``origin``
    is the window-center world coordinate the reference passes as
    ``(block_x + half_block, block_y + half_block)`` (:556-561)."""
    obstacles_xy = np.asarray(obstacles_xy).reshape(-1, 2)
    obstacles = np.concatenate([obstacles_xy, np.asarray(radii).reshape(-1)[:, None]], axis=-1)
    binary = rasterize_obstacles(obstacles, origin=origin, half_width=half_width,
                                 size=costmap_size, robot_radius=robot_radius)
    cost = _falloff_costmap(binary, falloff_power, use_exact_edt, device)
    return as_costmap(cost, half_width, dtype=dtype, device=device)
