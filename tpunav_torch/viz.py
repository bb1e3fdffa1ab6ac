"""Visualization: maps, landmarks, obstacle worlds, paths → matplotlib.

Port of ``tpunav/viz.py``: every array argument may be a tensor on any
device or anything numpy takes; tensors are copied to the host first.
matplotlib is imported when a figure is drawn. Replaces the reference's
rviz publishing layer (SURVEY.md §5: draw_map node cylinder
MarkerArrays nuslam/src/draw_map_node.cpp:59-102, draw_cont_map polygon
line markers planner/src/draw_cont_map_node.cpp,
OccupancyGrid / Path topics everywhere). Figures instead of topics: each
helper draws onto a matplotlib Axes so demos compose them and save PNGs.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(a, dtype=None) -> np.ndarray:
    """``a`` (a tensor on any device, or anything numpy takes) as numpy."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


def _ax(ax=None):
    if ax is None:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        _, ax = plt.subplots(figsize=(6, 6))
    ax.set_aspect("equal")
    return ax


def draw_occupancy(grid_cfg, prob_grid, ax=None, cmap="gray_r"):
    """Occupancy-probability grid (ref: GridMapper::gridMap rviz export,
    grid_mapper.cpp:185-226). prob_grid: (H, W) in [0, 1]."""
    ax = _ax(ax)
    ax.imshow(_np(prob_grid), origin="lower", cmap=cmap,
              vmin=0.0, vmax=1.0,
              extent=[grid_cfg.xmin, grid_cfg.xmax,
                      grid_cfg.ymin, grid_cfg.ymax])
    return ax


def draw_landmarks(centers, radii=None, ax=None, color="tab:red",
                   truth=None):
    """Estimated cylinder landmarks (+ optional ground truth crosses)
    (ref: draw_map_node.cpp cylinder markers)."""
    import matplotlib.patches as mp

    ax = _ax(ax)
    centers = _np(centers)
    radii = np.full(len(centers), 0.05) if radii is None else _np(radii)
    for (x, y), r in zip(centers, radii):
        ax.add_patch(mp.Circle((x, y), max(float(r), 0.02), fill=False,
                               color=color, lw=1.5))
    if truth is not None:
        t = _np(truth)
        ax.plot(t[:, 0], t[:, 1], "+", color="k", ms=8, mew=1.5)
    return ax


def draw_world(obstacles, bounds=None, ax=None, color="tab:gray"):
    """Polygonal obstacle world (ref: draw_cont_map_node.cpp line
    markers). obstacles: list of (V, 2) vertex arrays."""
    import matplotlib.patches as mp

    ax = _ax(ax)
    for poly in obstacles:
        ax.add_patch(mp.Polygon(_np(poly), closed=True,
                                facecolor=color, alpha=0.6,
                                edgecolor="k"))
    if bounds is not None:
        (x0, x1), (y0, y1) = bounds
        ax.set_xlim(x0, x1)
        ax.set_ylim(y0, y1)
    return ax


def draw_path(path, ax=None, color="tab:blue", label=None, lw=1.5):
    """Trajectory polyline (ref: nav_msgs/Path publishing — slam/odom/
    gazebo paths, nuslam/src/slam_node.cpp:343-392). path: (T, >=2) with
    columns [x, y, ...]."""
    ax = _ax(ax)
    p = _np(path)
    ax.plot(p[:, 0], p[:, 1], color=color, label=label, lw=lw)
    if label:
        ax.legend(loc="upper right", fontsize=8)
    return ax


def draw_robot(pose, model=None, ax=None, color="tab:blue"):
    """2D render of the robot model at ``pose`` [theta, x, y] (the
    framework's SE(2) convention) — the rviz RobotModel display
    replacement (ref: the xacro visuals,
    nuturtle_description/urdf/diff_drive.urdf.xacro): chassis/wheel
    footprint polygon, wheel rectangles, caster dot, heading arrow."""
    import matplotlib.patches as mp

    from .robot_model import TURTLEBOT3_MODEL

    model = model or TURTLEBOT3_MODEL
    ax = _ax(ax)
    th, x, y = (float(v) for v in _np(pose, float)[:3])
    c, s = np.cos(th), np.sin(th)
    R = np.asarray([[c, -s], [s, c]])

    fp = model.footprint() @ R.T + [x, y]
    ax.add_patch(mp.Polygon(fp, closed=True, facecolor=color, alpha=0.35,
                            edgecolor=color))
    cfg = model.config
    for side in (1.0, -1.0):
        wheel = np.asarray([
            [-2 * cfg.wheel_radius, side * cfg.wheel_base / 2
             - cfg.wheel_width / 2],
            [0.0, side * cfg.wheel_base / 2 - cfg.wheel_width / 2],
            [0.0, side * cfg.wheel_base / 2 + cfg.wheel_width / 2],
            [-2 * cfg.wheel_radius, side * cfg.wheel_base / 2
             + cfg.wheel_width / 2]])
        ax.add_patch(mp.Polygon(wheel @ R.T + [x, y], closed=True,
                                facecolor="k", alpha=0.7))
    caster = model.links["caster"]
    cx, cy = R @ np.asarray(caster.origin_xyz[:2]) + [x, y]
    ax.add_patch(mp.Circle((cx, cy), model.caster_radius, color="k"))
    ax.annotate("", xy=(x + 0.1 * c, y + 0.1 * s), xytext=(x, y),
                arrowprops=dict(arrowstyle="->", color=color))
    return ax


def save(ax, path: str, title: str = ""):
    if title:
        ax.set_title(title)
    ax.figure.savefig(path, dpi=120, bbox_inches="tight")
    return path


def plot_series(series, panels, out: str, title: str = "",
                xlabel: str = "tick", x=None):
    """Multi-panel per-tick metrics plot — the framework's rqt_plot.

    Every demo streams per-tick observability series (the reference
    streams PoseError topics into rqt_plot live,
    tsim/launch/trect.launch:18-21, and paths/markers into rviz); this is
    the shared render for those streams.

    ``series``: dict name → 1-D array (all the same length).
    ``panels``: list of (ylabel, [series names]) — one axis per panel,
    series identified by legend + fixed color order (never a dual axis).
    """
    import os

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    series = {k: _np(v, float) for k, v in series.items()}
    n = len(panels)
    fig, axes = plt.subplots(n, 1, figsize=(7, 2.2 * n + 0.8), sharex=True)
    axes = np.atleast_1d(axes)
    for ax, (ylabel, names) in zip(axes, panels):
        for name in names:
            y = series[name]
            ax.plot(np.arange(y.size) if x is None else _np(x),
                    y, lw=1.4, label=name)
        ax.set_ylabel(ylabel)
        ax.grid(alpha=0.25, lw=0.5)
        if len(names) > 1:
            ax.legend(loc="upper left", fontsize=8)
        else:
            ax.set_title(names[0], fontsize=9, loc="left")
    axes[-1].set_xlabel(xlabel)
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    d = os.path.dirname(out)
    if d:
        os.makedirs(d, exist_ok=True)
    fig.savefig(out, dpi=110)
    plt.close(fig)
    return out
