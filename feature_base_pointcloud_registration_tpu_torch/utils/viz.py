"""Trajectory / map plot exporter — the rviz topology analog.

The port's copy of the JAX package's `utils/viz.py` (which imports no JAX;
the port imports none of the JAX package).  `matplotlib` is imported inside
`export_run_plot` only, so the module imports where it is not installed.

The reference ships an rviz session (ref: launch/run.launch:19,
config/rviz.rviz) showing the live map cloud, the keyframe path, and loop
constraints.  Headless runs have no display server, so the analog is a
static artifact: `export_run_plot` renders the SAME layers — global map
snapshot (context, neutral gray), keyframe trajectory (slot-1 blue), loop
closure chords (slot-2 orange), start/end markers — to a PNG, from either
a live SlamPipeline or a saved map directory (save_map output).

    from feature_base_pointcloud_registration_tpu_torch.utils.viz import (
        export_run_plot)
    export_run_plot(pipe, "run.png")                   # live pipeline
    export_run_plot("maps/session_a", "run.png")       # saved directory
"""

from __future__ import annotations

import os

import numpy as np

# categorical slots 1/2 of the validated default palette (adjacent-pair
# CVD-checked order); map context is deliberately NOT a series color
_C_TRAJ = "#2a78d6"
_C_LOOP = "#eb6834"
_C_MAP = "#b9b8b3"
_C_TEXT = "#52514e"


def _load_from_dir(directory: str):
    """(poses [N,6], loop_ij or None, map_pts) from a save_map directory."""
    from ..io.pcd import read_pcd

    z_path = os.path.join(directory, "keyframes.npz")
    poses = None
    if os.path.exists(z_path):
        poses = np.load(z_path)["poses"]
    else:
        tr = read_pcd(os.path.join(directory, "transformations.pcd"))
        poses = np.stack([tr["roll"], tr["pitch"], tr["yaw"],
                          tr["x"], tr["y"], tr["z"]], -1)
    g = read_pcd(os.path.join(directory, "cloudGlobal.pcd"))
    map_pts = np.stack([g["x"], g["y"], g["z"]], -1)
    return poses.astype(np.float32), None, map_pts.astype(np.float32)


def _load_from_pipeline(pipe):
    n = pipe.n_keyframes
    poses = pipe.kf_poses[:n].copy()
    loops = np.array([(i, j) for i, j, _, _ in pipe.loop_factors],
                     np.int64).reshape(-1, 2)
    try:
        map_pts = pipe.global_map_snapshot()
    except Exception:
        map_pts = np.zeros((0, 3), np.float32)
    return poses, loops, map_pts


def export_run_plot(source, path: str, *, max_map_points: int = 60000,
                    title: str | None = None, gt_xy: np.ndarray | None = None,
                    dpi: int = 130) -> str:
    """Render the run overview (top-down XY) to `path` (PNG/SVG/PDF).

    source: a SlamPipeline, or a directory produced by save_map.
    gt_xy:  optional [N,2] ground-truth track, drawn dashed underneath.
    Returns `path`.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if isinstance(source, (str, os.PathLike)):
        poses, loops, map_pts = _load_from_dir(os.fspath(source))
    else:
        poses, loops, map_pts = _load_from_pipeline(source)

    if map_pts.shape[0] > max_map_points:
        sel = np.random.RandomState(0).choice(
            map_pts.shape[0], max_map_points, replace=False)
        map_pts = map_pts[sel]

    fig, ax = plt.subplots(figsize=(8, 8), facecolor="#fcfcfb")
    ax.set_facecolor("#fcfcfb")

    if map_pts.shape[0]:
        ax.scatter(map_pts[:, 0], map_pts[:, 1], s=0.5, c=_C_MAP,
                   linewidths=0, alpha=0.6, rasterized=True, zorder=1)
    if gt_xy is not None and len(gt_xy):
        ax.plot(gt_xy[:, 0], gt_xy[:, 1], "--", color=_C_TEXT, lw=1.2,
                label="ground truth", zorder=2)
    xy = poses[:, 3:5]
    ax.plot(xy[:, 0], xy[:, 1], "-", color=_C_TRAJ, lw=2.0,
            label="keyframe trajectory", zorder=3)
    if loops is not None and len(loops):
        for li, (i, j) in enumerate(loops):
            ax.plot([xy[i, 0], xy[j, 0]], [xy[i, 1], xy[j, 1]], "-",
                    color=_C_LOOP, lw=2.0, alpha=0.9, zorder=4,
                    label="loop closure" if li == 0 else None)
    if len(xy):
        ax.plot(*xy[0], marker="o", ms=9, mfc="white", mec=_C_TRAJ,
                mew=2, zorder=5)
        ax.annotate("start", xy[0], textcoords="offset points",
                    xytext=(8, 6), color=_C_TEXT, fontsize=9)
        ax.plot(*xy[-1], marker="s", ms=9, mfc=_C_TRAJ, mec=_C_TRAJ,
                zorder=5)
        ax.annotate("end", xy[-1], textcoords="offset points",
                    xytext=(8, 6), color=_C_TEXT, fontsize=9)

    ax.set_aspect("equal")
    ax.grid(True, color="#e8e7e3", lw=0.6)
    ax.set_axisbelow(True)
    for spine in ax.spines.values():
        spine.set_color("#d6d5d0")
    ax.tick_params(colors=_C_TEXT, labelsize=9)
    ax.set_xlabel("x [m]", color=_C_TEXT)
    ax.set_ylabel("y [m]", color=_C_TEXT)
    if title is None:
        title = f"{len(xy)} keyframes" + (
            f", {len(loops)} loop closures" if loops is not None and
            len(loops) else "")
    ax.set_title(title, color="#0b0b0b", fontsize=11)
    if len(xy) and (gt_xy is not None or (loops is not None and len(loops))):
        ax.legend(loc="best", fontsize=9, framealpha=0.9)

    fig.tight_layout()
    fig.savefig(path, dpi=dpi)
    plt.close(fig)
    return path
