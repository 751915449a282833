"""Worlds: the standalone crater surface and 750-obstacle costmap, and the
small-scale procedural terrain of the thesis statistics protocol."""

from .costmap import (
    as_costmap,
    costmap_750,
    device_costmap,
    generate_obstacles,
    rasterize_obstacles,
)
from .smallscale import thesis_statistics_terrain
from .surface import STANDALONE_CRATER_BUMPS, bump_surface, crater_surface
