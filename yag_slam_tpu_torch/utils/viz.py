"""Visualization with matplotlib: the map, trajectory and graph edges of a
GraphSlam, in 2-D and as a 3-D inspector.

Counterpart of ``yag_slam_tpu/utils/viz.py`` (the dependency-light
equivalent of the reference's threeviz inspector,
``visualize_slam_threeviz`` in upstream yag_slam's helpers.py).  The map
comes from the slam's own ``make_occupancy_grid``, so it renders on the
slam's device.  matplotlib is imported inside the functions, on the Agg
backend unless one is already chosen.
"""
from __future__ import annotations

import numpy as np


def plot_slam(slam, ax=None, show_lasers=False, map_resolution=0.05,
              range_threshold=12.0, pose_color="tab:red",
              edge_color="tab:blue"):
    """Draw the current map, trajectory, and graph edges onto a matplotlib
    axis; returns the axis."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    if ax is None:
        _, ax = plt.subplots(figsize=(8, 8))

    if slam.graph.vertices:
        grid = slam.make_occupancy_grid(resolution=map_resolution,
                                        range_threshold=range_threshold)
        extent = [
            grid.offset.x,
            grid.offset.x + grid.width * map_resolution,
            grid.offset.y,
            grid.offset.y + grid.height * map_resolution,
        ]
        ax.imshow(grid.image, origin="lower", cmap="gray", vmin=0, vmax=255,
                  extent=extent)

    for e in slam.graph.edges:
        s, t = e.source.obj.corrected_pose, e.target.obj.corrected_pose
        ax.plot([s.x, t.x], [s.y, t.y], color=edge_color, linewidth=0.6,
                alpha=0.7)

    xs = [v.obj.corrected_pose.x for v in slam.graph.vertices]
    ys = [v.obj.corrected_pose.y for v in slam.graph.vertices]
    ax.plot(xs, ys, ".", color=pose_color, markersize=3)

    if show_lasers:
        for v in slam.graph.vertices:
            px, py = v.obj.points()
            ax.plot(px, py, ".", markersize=0.5, alpha=0.2, color="black")

    ax.set_aspect("equal")
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    return ax


def visualize_slam_3d(slam, ax=None, show_lasers=True, map_resolution=0.05,
                      range_threshold=12.0, pose_height=0.25,
                      laser_height=0.1):
    """3-D inspector: the shape of the reference's threeviz viewer
    (`visualize_slam_threeviz`, upstream yag_slam helpers.py:576-605:
    per-pose axes above the plane, graph edges as 3-D lines, laser points,
    and the rendered map as a textured ground plane) on matplotlib's 3-D
    axes, so it needs no viewer process or network (threeviz streams to a
    browser).  Returns the Axes3D."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    if ax is None:
        fig = plt.figure(figsize=(9, 9))
        ax = fig.add_subplot(projection="3d")

    if slam.graph.vertices:
        grid = slam.make_occupancy_grid(resolution=map_resolution,
                                        range_threshold=range_threshold)
        im = np.asarray(grid.image, dtype=np.float64) / 255.0
        # textured ground plane at z=0 (decimated for plot speed)
        step = max(1, grid.width // 200, grid.height // 200)
        sub = im[::step, ::step]
        xs = grid.offset.x + np.arange(sub.shape[1]) * map_resolution * step
        ys = grid.offset.y + np.arange(sub.shape[0]) * map_resolution * step
        X, Y = np.meshgrid(xs, ys)
        rgba = np.repeat(sub[..., None], 3, axis=-1)
        rgba = np.concatenate([rgba, np.full_like(sub[..., None], 0.9)],
                              axis=-1)
        ax.plot_surface(X, Y, np.zeros_like(X), facecolors=rgba,
                        rstride=1, cstride=1, shade=False, linewidth=0)

    for e in slam.graph.edges:
        s, t = e.source.obj.corrected_pose, e.target.obj.corrected_pose
        ax.plot([s.x, t.x], [s.y, t.y], [pose_height, pose_height],
                color="tab:blue", linewidth=0.6, alpha=0.7)

    for v in slam.graph.vertices:
        p = v.obj.corrected_pose
        yaw = p.euler[-1]
        # a small pose axis (heading arrow), as threeviz draws axes
        ax.plot([p.x, p.x + 0.3 * np.cos(yaw)],
                [p.y, p.y + 0.3 * np.sin(yaw)],
                [pose_height, pose_height], color="tab:red", linewidth=1.0)

    if show_lasers:
        for v in slam.graph.vertices[:: max(1, len(slam.graph.vertices) // 40)]:
            px, py = v.obj.points()
            ax.plot(px, py, np.full(len(px), laser_height), ".",
                    markersize=0.5, alpha=0.15, color="black")

    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.set_zlim(0, 2.0)
    return ax


def save_slam_figure(slam, path, **kwargs):
    """Render :func:`plot_slam` (with `kwargs`) to an image file at `path`
    (150 dpi); returns `path`."""
    import matplotlib

    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt

    ax = plot_slam(slam, **kwargs)
    ax.figure.savefig(path, dpi=150, bbox_inches="tight")
    plt.close(ax.figure)
    return path
