"""GT-scenario debug visualization (port of drivescenegen_tpu/
visualization.py; reference: utils/datasets/visualization.py —
plot_static_map :40, plot_dynamic_objects :132,
animate_scenario/visualize_scenario :332-371).

These are matplotlib debug views of decoded scenario dicts; the training
raster itself comes from the analytic rasterizer (ops/raster.py), not from
these plots. matplotlib is imported only when a figure is drawn.
"""

from __future__ import annotations

import numpy as np


def polygon_completion(polygon: np.ndarray) -> np.ndarray:
    """Close and densify a polygon outline (visualization.py:16-37)."""
    xs, ys = [], []
    n = len(polygon)
    for i in range(n):
        j = (i + 1) % n
        dist = np.linalg.norm(polygon[j, :2] - polygon[i, :2])
        interp_num = int(np.ceil(dist)) * 2
        idx = np.arange(2 + interp_num)
        px = np.interp(idx, [0, idx[-1]], [polygon[i, 0], polygon[j, 0]])
        py = np.interp(idx, [0, idx[-1]], [polygon[i, 1], polygon[j, 1]])
        xs.extend(px[:-1])
        ys.extend(py[:-1])
    return np.array([xs, ys]).T


_ROAD_LINE_STYLES = {
    6: ("w", "dashed"), 7: ("w", "solid"), 8: ("w", "solid"),
    9: ("xkcd:yellow", "dashed"), 10: ("xkcd:yellow", "dashed"),
    11: ("xkcd:yellow", "solid"), 12: ("xkcd:yellow", "solid"),
    13: ("xkcd:yellow", "dotted"), 15: ("k", "solid"), 16: ("k", "solid"),
}


def plot_static_map(scenario_info: dict, ax=None) -> None:
    """Lane centerlines green, road lines styled by type, stop signs as red
    circles, crosswalks blue, speed bumps/driveways orange."""
    import matplotlib.pyplot as plt

    ax = ax or plt.gca()
    for polyline in scenario_info.get("lane", {}).values():
        if polyline[0, 6] in (1, 2, 3):
            ax.plot(polyline[:, 0], polyline[:, 1], "g", linestyle="solid", linewidth=1)

    for polyline in scenario_info.get("road_polylines", {}).values():
        style = _ROAD_LINE_STYLES.get(int(polyline[0, 6]))
        if style:
            color, ls = style
            ax.plot(polyline[:, 0], polyline[:, 1], color, linestyle=ls, linewidth=1)

    for polyline in scenario_info.get("stop_sign", {}).values():
        for row in polyline:
            ax.add_patch(plt.Circle(row[:2], 2, color="r"))

    for polyline in scenario_info.get("crosswalk", {}).values():
        closed = polygon_completion(polyline).astype(np.float32)
        ax.plot(closed[:, 0], closed[:, 1], "b", linewidth=1)

    for key in ("speed_bump", "drive_way"):
        for polyline in scenario_info.get(key, {}).values():
            closed = polygon_completion(polyline).astype(np.float32)
            ax.plot(closed[:, 0], closed[:, 1], "xkcd:orange", linewidth=1)


_TYPE_COLORS = {
    1: ("violet", "magenta"),
    2: ("lightskyblue", "deepskyblue"),
    3: ("springgreen", "lime"),
}


def plot_dynamic_objects(scenario_info: dict, t_step: int = 11, ax=None) -> None:
    """History/future trajectories + current bounding boxes, colored by
    object type; ego in red tones (visualization.py:132-170)."""
    import matplotlib as mpl
    import matplotlib.pyplot as plt

    ax = ax or plt.gca()
    sdc = scenario_info["sdc_track_index"]
    trajs = scenario_info["tracks_info"]["trajs"]
    for i, traj in enumerate(trajs):
        history = traj[:t_step]
        future = traj[t_step:]
        if future.shape[0] == 0 or future[0, 9] == 0:
            continue
        if i == sdc:
            h_color, f_color = "mistyrose", "tomato"
        else:
            colors = _TYPE_COLORS.get(int(traj[0, 10]))
            if colors is None:
                continue
            h_color, f_color = colors

        h_mask = history[:, 9] > 0
        f_mask = future[:, 9] > 0
        ax.plot(history[h_mask][::5, 0], history[h_mask][::5, 1], linewidth=2,
                color=h_color, marker="*", markersize=2, zorder=4)
        ax.plot(future[f_mask][::5, 0], future[f_mask][::5, 1], linewidth=2,
                color=f_color, marker=".", markersize=6, zorder=4)
        rect = plt.Rectangle(
            (future[0, 0] - future[0, 3] / 2, future[0, 1] - future[0, 4] / 2),
            future[0, 3], future[0, 4], linewidth=2, color=f_color, alpha=0.6,
            zorder=5,
            transform=mpl.transforms.Affine2D().rotate_around(
                future[0, 0], future[0, 1], future[0, 6]
            ) + ax.transData,
        )
        ax.add_patch(rect)


def animate_scenario(t_step: int, t_res: float, t_start: int, scenario_info: dict):
    import matplotlib.pyplot as plt

    ax = plt.gca()
    ax.clear()
    ax.set_title(f"Simulation Time = {(t_step - t_start) * t_res:.1f} s")
    ax.set_facecolor("xkcd:grey")
    ax.margins(0)
    ax.set_aspect("equal")
    ax.axes.get_yaxis().set_visible(False)
    ax.axes.get_xaxis().set_visible(False)
    plot_static_map(scenario_info, ax)
    plot_dynamic_objects(scenario_info, t_step, ax)


def visualize_scenario(scenario_info: dict, t_start: int = 10, t_steps: int = 0,
                       t_res: float = 0.1, save_path: str = None):
    """Animated scenario playback; saves an mp4/gif when save_path given,
    else plt.show()."""
    from functools import partial

    import matplotlib

    if save_path:
        matplotlib.use("Agg")
    import matplotlib.animation as animation
    import matplotlib.pyplot as plt

    _, t_end, _ = scenario_info["tracks_info"]["trajs"].shape
    if t_steps > 0 and t_start + t_steps <= t_end:
        t_end = t_start + t_steps

    fig, ax = plt.subplots()
    ani = animation.FuncAnimation(
        fig,
        partial(animate_scenario, t_res=t_res, t_start=t_start,
                scenario_info=scenario_info),
        frames=np.arange(t_start, t_end, 1),
    )
    plt.tight_layout()
    if save_path:
        writer = animation.PillowWriter(fps=int(1 / t_res))
        ani.save(save_path, writer=writer)
    else:
        plt.show()
    plt.close(fig)
    return ani
