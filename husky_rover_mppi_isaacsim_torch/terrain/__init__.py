"""Worlds: the standalone crater surface and 750-obstacle costmap, the
small-scale procedural terrain of the thesis statistics protocol, and the
streamed large-scale terrain (streamer, rocks, clipmaps, collider window and
their orchestrator)."""

from .costmap import (
    as_costmap,
    costmap_750,
    device_costmap,
    generate_obstacles,
    rasterize_obstacles,
    reference_costmap,
    update_costmap_with_obstacles,
)
from .orchestrator import LargeScaleConf, LargeScaleTerrainManager
from .rocks import RockDistConf
from .smallscale import thesis_statistics_terrain
from .surface import (
    STANDALONE_CRATER_BUMPS,
    bump_surface,
    crater_surface,
    imported_surface,
    surface_heightfield,
)
