"""Visualization: rollout spreads, costmaps, closed-loop runs.

Matplotlib-native replacement for the reference's plotting utilities
(MPPI_isaac.py:40-219) and the USD ``VisualizeMPPI`` rollout instancer
(src/terrain_management/large_scale_terrain/mppi_instancer.py:7-101):
rollouts are colored by normalized cost exactly as the instancer maps cost
to its 256 hue-coded prototypes.

Counterpart of ``husky_rover_mppi_isaacsim_tpu/aux/visualize.py``: the same
plots, taking tensors (on any device: they are copied to the host) or
arrays. matplotlib is imported only when a plot is drawn. Import-safe
without a display (Agg backend); every function accepts ``save_path`` to
write frames like the reference's frame folders.
"""

from __future__ import annotations

import os

import numpy as np


def _host(a) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array."""
    if hasattr(a, "detach"):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _plt():
    import matplotlib

    if os.environ.get("DISPLAY") is None:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def cost_to_color_ids(costs: np.ndarray, num_colors: int = 256) -> np.ndarray:
    """Normalized cost -> color id (VisualizeMPPI.update_visualizer,
    mppi_instancer.py:65-91)."""
    costs = _host(costs).astype(float)
    lo, hi = costs.min(), costs.max()
    norm = (costs - lo) / (hi - lo + 1e-12)
    return np.clip((norm * (num_colors - 1)).astype(int), 0, num_colors - 1)


def plot_rollout_spread(z, half_width, costmap, rollouts, optimal=None,
                        goal=None, save_path=None, stride=25):
    """2D heatmap + rollout spread colored by cost (the
    plot_2d_surface_with_trajectory role, MPPI_isaac.py:112-186).

    ``z``/``costmap`` must use the Warp standalone layout (row = y counting
    DOWN from +half_width, col = x — core/heightfield.py:24). A raw
    streamer window (row = x, col = y) must be transposed+flipped first:
    ``np.flipud(window.T)``."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 7))
    extent = [-half_width, half_width, -half_width, half_width]
    ax.imshow(_host(z), cmap="gray", origin="upper", extent=extent)
    if costmap is not None:
        cm = _host(costmap)
        masked = np.ma.masked_where(cm < 0.5, cm)
        ax.imshow(masked, cmap="autumn", origin="upper", extent=extent,
                  alpha=0.6)
    if rollouts is not None:
        rollouts = _host(rollouts)
        for traj in rollouts[::stride]:
            ax.plot(traj[:, 0], traj[:, 1], color="red", alpha=0.2, lw=0.5)
    if optimal is not None:
        optimal = _host(optimal)
        ax.plot(optimal[:, 0], optimal[:, 1], color="blue", lw=2.0)
    if goal is not None:
        goal = _host(goal)
        ax.scatter([goal[0]], [goal[1]], color="green", s=60, zorder=5)
    ax.set_xlabel("X [m]")
    ax.set_ylabel("Y [m]")
    ax.set_title("MPPI rollout spread")
    if save_path:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
    return fig


def plot_costmap(costmap, half_width, save_path=None, frame=0):
    """Costmap frame dump (plot_costmap_with_frames, MPPI_isaac.py:189-219)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(6, 6))
    extent = [-half_width, half_width, -half_width, half_width]
    img = ax.imshow(_host(costmap), origin="upper", cmap="gray_r",
                    extent=extent)
    fig.colorbar(img, label="Cost value")
    ax.set_title("Costmap")
    ax.set_xlabel("X [m]")
    ax.set_ylabel("Y [m]")
    fig.tight_layout()
    if save_path:
        os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
        fig.savefig(save_path)
        plt.close(fig)
    return fig


def plot_closed_loop_run(path_xy, goal, z=None, half_width=None,
                         save_path=None):
    """Driven path over the terrain (the trajectory overlays of
    plot_surface_with_trajectory)."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 7))
    if z is not None and half_width is not None:
        extent = [-half_width, half_width, -half_width, half_width]
        ax.imshow(_host(z), cmap="gray", origin="upper", extent=extent)
    path_xy = _host(path_xy)
    goal = _host(goal)
    ax.plot(path_xy[:, 0], path_xy[:, 1], color="blue", lw=1.5)
    ax.scatter([path_xy[0, 0]], [path_xy[0, 1]], color="orange", label="start")
    ax.scatter([goal[0]], [goal[1]], color="green", label="goal")
    ax.legend()
    ax.set_title("Closed-loop traverse")
    if save_path:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
    return fig
