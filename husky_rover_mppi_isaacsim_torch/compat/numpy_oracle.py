"""NumPy oracle of ``thesis_master/python_mppi_projection/displacement_on_surface.py``.

A copy of ``husky_rover_mppi_isaacsim_tpu/compat/numpy_oracle.py`` (this
package imports nothing of that one).

The BASELINE bit-match contract names the ``python_mppi_projection`` NumPy
implementation as the semantic spec for single-trajectory 2.5D/2D projection
(BASELINE.md "Targets"). This module re-derives it faithfully — including its
quirks, which differ from the Warp production kernels:

* floor-based bilinear fractions (displacement_on_surface.py:254-255) vs the
  Warp kernels' trunc;
* the hard-coded ``int((x + 20)/res) - 2`` corner indexing on the unflipped
  grid (displacement_on_surface.py:195-196);
* heading rotation via a rotation-vector quaternion (scipy semantics,
  displacement_on_surface.py:291-292) — mathematically identical to the Warp
  Rodrigues formula for unit axes;
* the ``+/-20 m`` out-of-bounds abort returning ``None``
  (displacement_on_surface.py:364-365).

Used only by tests.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial.transform import Rotation


def create_surface(grid_size, half_width, bumps):
    """Analytic bump surface + arctan ramp (displacement_on_surface.py:48-79)."""
    x = np.linspace(-half_width, half_width, grid_size)
    y = np.linspace(-half_width, half_width, grid_size)
    X, Y = np.meshgrid(x, y)
    Z = np.zeros_like(X)
    for (cx, cy), height, width in bumps:
        Z += height * np.exp(-((X - cx) ** 2 + (Y - cy) ** 2) / (2 * width**2))
    Z += 0.85 * np.arctan(0.5 * X)
    return X, Y, Z


def find_corners_heights(x, y, resolution, Z, half_width=20.0):
    """displacement_on_surface.py:173-203 — note the ``-2`` offset quirk and
    the unflipped row-major layout ``q[a, b] = Z[j + a, i + b]``."""
    i = int((x + half_width) / resolution) - 2
    j = int((y + half_width) / resolution) - 2
    q = np.empty((2, 2), dtype=Z.dtype)
    q[0, 0] = Z[j, i]
    q[0, 1] = Z[j, i + 1]
    q[1, 0] = Z[j + 1, i]
    q[1, 1] = Z[j + 1, i + 1]
    return q


def normal_on_grid(q, grid_size):
    """displacement_on_surface.py:205-221."""
    vec = np.array(
        [
            -grid_size / 2.0 * (q[0, 1] - q[0, 0] - q[1, 0] + q[1, 1]),
            -grid_size / 2.0 * (q[1, 0] - q[0, 0] - q[0, 1] + q[1, 1]),
            grid_size * grid_size,
        ]
    )
    return vec / np.linalg.norm(vec)


def get_heading_tangent_vector(normal, previous_heading_vector):
    """displacement_on_surface.py:223-237."""
    projection = (
        previous_heading_vector - np.dot(previous_heading_vector, normal) * normal
    )
    return projection / np.linalg.norm(projection)


def bilinear_interpolator(x, y, q, resolution):
    """displacement_on_surface.py:239-262 (floor fractions)."""
    xn = x / resolution
    yn = y / resolution
    x2 = xn - np.floor(xn)
    y2 = yn - np.floor(yn)
    return (
        (1.0 - x2) * (1.0 - y2) * q[0, 0]
        + x2 * (1.0 - y2) * q[1, 0]
        + (1.0 - x2) * y2 * q[0, 1]
        + x2 * y2 * q[1, 1]
    )


def update_position(x, y, heading_vector, linear_velocity, angular_velocity,
                    normal_vector, dt):
    """displacement_on_surface.py:264-295 (rotvec rotation about the normal)."""
    heading_vector = heading_vector / np.linalg.norm(heading_vector)
    displacement = heading_vector * linear_velocity * dt
    new_x = x + displacement[0]
    new_y = y + displacement[1]
    angle = angular_velocity * dt
    rotation = Rotation.from_rotvec(angle * normal_vector)
    new_heading = rotation.apply(heading_vector)
    new_heading = new_heading / np.linalg.norm(new_heading)
    return new_x, new_y, new_heading


def generate_trajectory_25d(x0, y0, heading_vector, linear_velocity,
                            angular_velocity, dt, iterations, resolution,
                            Z, half_width=20.0):
    """displacement_on_surface.py:317-369. Returns None on the ±half_width
    boundary abort, matching the reference — including its quirk of
    indexing the grid BEFORE the bounds check (:343 vs :348), so a single
    step jumping more than ~2 cells past the edge can IndexError/wrap
    exactly as the reference would; keep lin*dt below a couple of cells."""
    trajectory = np.zeros((iterations, 3))
    q = find_corners_heights(x0, y0, resolution, Z, half_width)
    normal = normal_on_grid(q, resolution)
    heading_vector = get_heading_tangent_vector(normal, np.asarray(heading_vector, float))
    x, y = x0, y0
    for k in range(iterations):
        x, y, heading_vector = update_position(
            x, y, heading_vector, linear_velocity[k], angular_velocity[k],
            normal, dt,
        )
        q = find_corners_heights(x, y, resolution, Z, half_width)
        height = bilinear_interpolator(x, y, q, resolution)
        normal = normal_on_grid(q, resolution)
        heading_vector = get_heading_tangent_vector(normal, heading_vector)
        if x >= half_width or x <= -half_width or y >= half_width or y <= -half_width:
            return None
        trajectory[k, :] = [x, y, height]
    return trajectory


def generate_trajectory_2d(x0, y0, heading_vector, linear_velocity,
                           angular_velocity, dt, iterations, half_width=20.0):
    """displacement_on_surface.py:371-418 (note: stores the start point and
    advances ``iterations - 1`` steps, unlike the 2.5D variant)."""
    trajectory = np.zeros((iterations, 3))
    x, y = x0, y0
    heading_vector = np.asarray(heading_vector, float)
    heading_vector = heading_vector / np.linalg.norm(heading_vector)
    trajectory[0, :] = [x, y, 0]
    for k in range(iterations - 1):
        displacement = heading_vector * linear_velocity[k] * dt
        x += displacement[0]
        y += displacement[1]
        angle = angular_velocity[k] * dt
        rot = np.array(
            [[np.cos(angle), -np.sin(angle)], [np.sin(angle), np.cos(angle)]]
        )
        heading_vector[:2] = rot @ heading_vector[:2]
        trajectory[k + 1, :] = [x, y, 0]
        if x >= half_width or x <= -half_width or y >= half_width or y <= -half_width:
            return None
    return trajectory


def generate_velocities(rng, iterations, initial_velocity, std_dev,
                        min_velocity, max_velocity):
    """Markov-chain velocity sampler (displacement_on_surface.py:420-466);
    ``rng`` is a ``np.random.RandomState`` reproducing the legacy global
    ``np.random.seed`` stream."""
    velocities = np.zeros(iterations)
    velocities[0] = initial_velocity
    for i in range(1, iterations):
        new_velocity = rng.normal(velocities[i - 1], std_dev)
        velocities[i] = np.clip(new_velocity, min_velocity, max_velocity)
    return velocities


# The fixed bump list of the reference experiment
# (displacement_on_surface.py:472-486).
REFERENCE_BUMPS = [
    ((-18.32, -8.94), 2.48, 3.62),
    ((-13.01, 6.74), 4.45, 5.85),
    ((-8.64, -14.23), 1.12, 4.39),
    ((-3.57, 12.05), 2.39, 1.92),
    ((0.97, -17.81), 1.62, 2.91),
    ((3.15, -1.56), 3.23, 2.21),
    ((9.87, 16.38), 1.45, 3.74),
    ((14.94, 15.64), 2.89, 4.02),
    ((19.83, -9.56), 2.58, 1.72),
    ((-6.34, 5.56), 0.58, 4.55),
    ((-12.21, -13.32), 1.01, 3.89),
    ((-5.21, -5.32), 4.01, 3.89),
]
