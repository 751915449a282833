"""Heightfield geometry ops (counterpart of the JAX ``core``)."""

from .geometry import (
    align_leading,
    cross3,
    normalize,
    rodrigues_rotate,
    update_orientation,
    update_orientation_2d,
    update_position,
)
from .heightfield import (
    HeightField,
    bilinear,
    corner_cell,
    corners_at,
    gather_corners,
    grid_lookup,
    height_at,
    jacobian_slope,
    nearest_height,
    normal_at,
    quad_normal,
    surface_frame,
    tangent_project,
    wrap_clamp,
)
