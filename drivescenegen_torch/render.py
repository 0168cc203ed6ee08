"""The port's copy of render_vectorized_scenario_on_axes from
drivescenegen_tpu/render.py, for the vectorization CLI's plots. matplotlib
is imported only when a scenario is drawn.

Vectorized-scenario renderer — same information content as the
reference's viz (utils/render.py:9-89: road ribbon per lane, centerline,
direction arrows, agent boxes, velocity arrows) with our own styling and a
physically sized road ribbon (width in metres via the axes transform,
instead of a fixed point width that only looks right at one figure size).
"""

from __future__ import annotations

import numpy as np

ROAD_COLOR = "#3b4252"       # asphalt
CENTER_COLOR = "#2bb8a3"     # lane centerline + flow arrows
AGENT_COLOR = "#f5a623"      # vehicle boxes
VEL_COLOR = "#d64545"        # velocity arrows
ROAD_WIDTH_M = 4.0           # drawn ribbon width per centerline


def _metres_to_points(ax, metres: float, map_range: float) -> float:
    """Linewidth (points) spanning `metres` of world space on this axes."""
    try:
        bbox = ax.get_window_extent()
        px_per_m = bbox.width / map_range
        return max(metres * px_per_m * 72.0 / ax.figure.dpi, 0.5)
    except Exception:
        return 12.0


def render_vectorized_scenario_on_axes(ax, lanes, agents, map_range: float = 80.0):
    import matplotlib as mpl
    from matplotlib.patches import Rectangle

    margin = map_range / 2
    ax.axis([-margin, margin, -margin, margin])
    ax.set_aspect("equal")
    road_lw = _metres_to_points(ax, ROAD_WIDTH_M, map_range)

    for lane in lanes:
        lane_np = np.asarray(lane)
        ax.plot(lane_np[:, 0], lane_np[:, 1], color=ROAD_COLOR, linewidth=road_lw,
                solid_capstyle="round", zorder=1)
        ax.plot(lane_np[:, 0], lane_np[:, 1], color=CENTER_COLOR, linewidth=0.8,
                linestyle=(0, (6, 3)), solid_capstyle="round", zorder=5)
        if lane_np.shape[1] <= 2:
            continue
        step = max(len(lane_np) // 6, 10)
        ax.quiver(lane_np[::step, 0], lane_np[::step, 1],
                  lane_np[::step, 3] * 1.5, lane_np[::step, 4] * 1.5,
                  color=CENTER_COLOR, angles="xy", scale_units="xy",
                  units="xy", scale=1.0, width=0.25, zorder=50)

    for agent in agents:
        rect = Rectangle(
            (agent[0] - agent[3] / 2, agent[1] - agent[4] / 2),
            agent[3], agent[4],
            transform=mpl.transforms.Affine2D().rotate_around(
                agent[0], agent[1], agent[6]
            ) + ax.transData,
            facecolor=AGENT_COLOR, edgecolor="#7a5410", linewidth=0.6,
            zorder=100,
        )
        ax.add_patch(rect)

    if len(agents):
        agent_np = np.asarray(agents).reshape((-1, 9))
        ax.quiver(agent_np[:, 0], agent_np[:, 1],
                  agent_np[:, -2] * 2.0, agent_np[:, -1] * 2.0,
                  color=VEL_COLOR, angles="xy", scale_units="xy", units="xy",
                  scale=1.0, width=0.3, zorder=150)

    ax.margins(0)
    ax.grid(False)
    ax.axis("off")
    return ax
