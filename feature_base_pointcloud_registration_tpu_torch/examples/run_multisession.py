"""Multi-session mapping demo on the PyTorch port (BASELINE.json config 5):
run two SLAM sessions over the same synthetic world, merge them with
cross-session registration links + joint pose-graph optimization, save the
merged map, and verify it by localizing a held-out scan against it.

    python -m feature_base_pointcloud_registration_tpu_torch.examples.run_multisession \\
        [--scans N] [--save-dir DIR] [--device cuda|cpu]

The port's counterpart of the JAX package's examples/run_multisession.py,
with its tracks, seeds and capacities.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch

# the held-out scan's ground truth (world frame) and its guess offset
HELD_OUT_GT = np.array([0, 0, 0.1, -0.5, 0.0, 0.0], np.float32)
HELD_OUT_OFFSET = np.array([0, 0, 0.02, 0.2, -0.15, 0.05], np.float32)


def track_a(k):
    """Session A's pose k: one of two passes over the same world, on
    parallel tracks."""
    return np.array([0, 0, 0.03 * k, 0.3 * k - 2.0, -1.5, 0.0], np.float32)


def track_b(k):
    """Session B's pose k."""
    return np.array([0, 0, -0.02 * k, 0.3 * k - 2.0, 1.0, 0.0], np.float32)


def raw_scan(s, device):
    """A simulate_scan dict as a RawScan on `device`."""
    from feature_base_pointcloud_registration_tpu_torch.pipeline.cloud_info import (  # noqa: E501
        RawScan)

    return RawScan.from_numpy(s["xyz"], s["intensity"], s["ring"], s["time"],
                              device=device)._replace(
        valid=torch.from_numpy(s["valid"]).to(device))


def run_session(params, world, gt_fn, scans, seed0, *, device):
    """One SLAM session of `scans` scans along gt_fn, 0.2 s apart."""
    from feature_base_pointcloud_registration_tpu_torch.io.synthetic import (
        simulate_scan)
    from feature_base_pointcloud_registration_tpu_torch.pipeline.slam import (
        SlamPipeline)

    pipe = SlamPipeline(params, max_keyframes=128, device=device)
    for k in range(scans):
        s = simulate_scan(world, gt_fn(k), seed=seed0 + k)
        pipe.step(raw_scan(s, device), timestamp=0.2 * k)
    return pipe


def held_out(world, map_dir, params, *, device):
    """Localize the held-out scan against the map in `map_dir`: returns
    (the estimated pose6, its ground truth in the merged map's frame)."""
    from feature_base_pointcloud_registration_tpu_torch.io.synthetic import (
        simulate_scan)
    from feature_base_pointcloud_registration_tpu_torch.pipeline.localization import (  # noqa: E501
        GlobalMap, LocalizationPipeline)

    gm = GlobalMap.from_pcd_dir(params, map_dir, corner_cap=16384,
                                surf_cap=131072, device=device)
    loc = LocalizationPipeline(params, gm)
    s = simulate_scan(world, HELD_OUT_GT, seed=9999)
    # the merged map lives in session A's odometry frame, whose origin is
    # A's first keyframe (the pipeline anchors it at zero) — express the
    # held-out ground truth there
    a_start = np.zeros(6, np.float32)
    a_start[3:] = track_a(0)[3:]
    gt_map = HELD_OUT_GT - a_start
    pose = loc.step(raw_scan(s, device), timestamp=0.0,
                    initial_guess=gt_map + HELD_OUT_OFFSET)
    return np.asarray(pose), gt_map


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scans", type=int, default=10)
    ap.add_argument("--save-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    from feature_base_pointcloud_registration_tpu_torch import Params
    from feature_base_pointcloud_registration_tpu_torch.io.synthetic import (
        SyntheticWorld)
    from feature_base_pointcloud_registration_tpu_torch.pipeline.multisession import (  # noqa: E501
        merge_sessions, save_merged_map, session_from_pipeline)

    device = torch.device(args.device)
    params = Params(map_corner_cap=8192, map_surf_cap=65536)
    world = SyntheticWorld()

    pipe_a = run_session(params, world, track_a, args.scans, seed0=100,
                         device=device)
    pipe_b = run_session(params, world, track_b, args.scans, seed0=500,
                         device=device)
    print(f"session A: {pipe_a.n_keyframes} keyframes, "
          f"session B: {pipe_b.n_keyframes} keyframes")

    sess_a = session_from_pipeline(pipe_a)
    sess_b = session_from_pipeline(pipe_b)

    res = merge_sessions(None, sess_a, sess_b, params=params,
                         link_radius=8.0, link_stride=1, coarse=False,
                         device=device)
    print(f"merged: {len(res.links)} cross-session links, "
          f"align fitness {res.align_fitness:.4f}")
    for ln in res.links:
        print(f"  link A[{ln.idx_a}] <-> B[{ln.idx_b}] "
              f"correction={ln.correction * 100:.1f} cm")

    out = args.save_dir or os.path.join(tempfile.gettempdir(),
                                        "fbpr_merged_map")
    save_merged_map(out, res, sess_a, sess_b)
    print(f"merged map saved to {out}")

    pose, gt_map = held_out(world, out, params, device=device)
    err = float(np.linalg.norm(pose[3:] - gt_map[3:]))
    print(f"held-out localization vs merged map: err={err * 100:.2f} cm")
    return res, err


if __name__ == "__main__":
    main()
