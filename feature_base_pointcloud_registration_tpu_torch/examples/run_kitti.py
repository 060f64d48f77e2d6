"""KITTI HDL-64E sequence odometry on the PyTorch port: FPFH + RANSAC
coarse init, ICP refine.

BASELINE.json config 3, the port's counterpart of the JAX package's
examples/run_kitti.py: velodyne .bin -> RawScan -> voxel downsample ->
FPFH descriptor match + RANSAC coarse alignment -> ICP refinement ->
chained scan-to-scan odometry, evaluated against the oxts ground truth when
present.

    python -m feature_base_pointcloud_registration_tpu_torch.examples.run_kitti \\
        [--data /path/to/2011_09_26_drive_0001_sync] [--scans N] \\
        [--no-coarse] [--device cuda|cpu]

Without --data it observes a synthetic outdoor world (poles, boxes, blobs
over a ground strip) from a straight drive, so the whole FPFH -> RANSAC ->
ICP chain runs without the dataset.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def synth_outdoor_world(seed=0, n_objects=80, extent=35.0):
    """KITTI-like scattered structure: poles, boxes, and blobs (trees/cars/
    signs) over a ground strip — the 3-D texture FPFH/ICP key on outdoors.
    Returns a fixed world point set shared across scans."""
    rng = np.random.RandomState(seed)
    pts = []
    for _ in range(n_objects):
        c = np.array([rng.uniform(-extent, extent),
                      rng.uniform(-extent, extent), 0.0])
        kind = rng.randint(3)
        if kind == 0:      # pole
            z = rng.uniform(0, 4, 40)
            pts.append(c + np.stack([rng.normal(0, 0.05, 40),
                                     rng.normal(0, 0.05, 40), z], -1))
        elif kind == 1:    # box (car-ish)
            pts.append(c + rng.uniform(0, 1, (60, 3)) * [3.5, 1.6, 1.4])
        else:              # blob (bush/tree crown)
            pts.append(c + [0, 0, rng.uniform(1, 3)]
                       + rng.normal(0, 0.6, (60, 3)))
    ground = np.stack([rng.uniform(-extent, extent, 800),
                       rng.uniform(-extent, extent, 800),
                       rng.normal(0, 0.02, 800)], -1)
    pts.append(ground)
    return np.concatenate(pts).astype(np.float32)


def synth_scan(world_pts, pose6, max_range=25.0, noise=0.01, seed=0):
    """Observe the shared world from pose6: range-gate + sensor-frame
    transform + measurement noise (rings are irrelevant to the FPFH/ICP
    path, so no raycasting needed)."""
    from feature_base_pointcloud_registration_tpu_torch.io.synthetic import (
        pose6_to_matrix_np)

    rng = np.random.RandomState(1000 + seed)
    T = pose6_to_matrix_np(np.asarray(pose6, np.float64))
    local = (world_pts - T[:3, 3]) @ T[:3, :3]
    keep = np.linalg.norm(local, axis=1) < max_range
    return (local[keep] + rng.normal(0, noise, (keep.sum(), 3))
            ).astype(np.float32)


def pair_align(generator, src_xyz, dst_xyz, *, cap=2048, leaf=0.3,
               coarse=True, device):
    """One scan pair on `device`: (optional) FPFH + RANSAC coarse, then ICP
    refine.  `generator` (a torch.Generator on `device`) draws the RANSAC
    triplets.

    Returns (the 4x4 transform taking src points into the dst frame, the
    ICP fitness)."""
    from feature_base_pointcloud_registration_tpu_torch import native
    from feature_base_pointcloud_registration_tpu_torch.ops.icp import (
        icp_align)
    from feature_base_pointcloud_registration_tpu_torch.ops.ransac import (
        coarse_align_fpfh)

    def prep(xyz):
        pts = native.voxel_downsample(np.asarray(xyz, np.float32), leaf)
        buf = np.zeros((cap, 3), np.float32)
        msk = np.zeros(cap, bool)
        m = min(len(pts), cap)
        buf[:m] = pts[:m]
        msk[:m] = True
        return (torch.from_numpy(buf).to(device),
                torch.from_numpy(msk).to(device))

    src, src_m = prep(src_xyz)
    dst, dst_m = prep(dst_xyz)

    T_coarse = torch.eye(4, device=device)
    if coarse:
        T_coarse = coarse_align_fpfh(generator, src, src_m, dst, dst_m,
                                     num_hypotheses=256,
                                     inlier_threshold=0.5).transform

    src_c = src @ T_coarse[:3, :3].T + T_coarse[:3, 3]
    res = icp_align(src_c, src_m, dst, dst_m, max_corr_dist=2.0,
                    max_iterations=50)
    return (res.transform @ T_coarse).cpu().numpy(), float(res.fitness)


def chained_ate(traj, gt_poses):
    """ATE of a chained trajectory [N, 3] (scan 0 at the origin) against
    ground-truth pose6 [N, 6] expressed relative to the first pose."""
    from feature_base_pointcloud_registration_tpu_torch.io.synthetic import (
        pose6_to_matrix_np)

    T0 = pose6_to_matrix_np(np.asarray(gt_poses[0], np.float64))
    rel_gt = np.stack([
        (np.linalg.inv(T0) @ pose6_to_matrix_np(
            np.asarray(p, np.float64)))[:3, 3] for p in gt_poses])
    return float(np.sqrt(((traj - rel_gt) ** 2).sum(-1).mean()))


def main(argv=None):
    """Align the scans pair by pair; returns a dict with the chained
    trajectory, its ATE (None without ground truth) and each pair's wall
    ms."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", default=None,
                    help="KITTI raw drive dir (contains velodyne_points/, "
                         "oxts/); synthetic fallback when omitted")
    ap.add_argument("--scans", type=int, default=6)
    ap.add_argument("--no-coarse", action="store_true",
                    help="skip FPFH+RANSAC (ICP-only, for ablation)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    from feature_base_pointcloud_registration_tpu_torch.io import kitti

    device = torch.device(args.device)
    clouds, gt_poses = [], None
    if args.data:
        vdir = os.path.join(args.data, "velodyne_points", "data")
        files = kitti.scan_files(vdir)[: args.scans]
        if not files:
            raise SystemExit(f"no .bin scans under {vdir}")
        scans = kitti.iter_scans(vdir, device=device)  # threaded prefetch
        for _, raw in zip(files, scans):
            clouds.append(raw.xyz[raw.valid].cpu().numpy())
        scans.close()
        odir = os.path.join(args.data, "oxts", "data")
        if os.path.isdir(odir):
            gt_poses = kitti.load_oxts_poses(odir)[: args.scans]
        print(f"loaded {len(clouds)} KITTI scans from {vdir}")
    else:
        world_pts = synth_outdoor_world()
        gt_poses = np.stack([
            np.array([0, 0, 0.05 * k, 0.8 * k, 0.3 * k, 0.0],
                     np.float32) for k in range(args.scans)])
        for k in range(args.scans):
            clouds.append(synth_scan(world_pts, gt_poses[k], seed=k))
        print(f"synthesized {len(clouds)} outdoor scans "
              f"({clouds[0].shape[0]} pts each)")

    generator = torch.Generator(device=device)
    generator.manual_seed(0)
    T_w = np.eye(4, dtype=np.float32)       # world <- scan 0
    traj = [T_w[:3, 3].copy()]
    pair_ms = []
    for k in range(1, len(clouds)):
        t0 = time.perf_counter()
        T_rel, fitness = pair_align(generator, clouds[k], clouds[k - 1],
                                    coarse=not args.no_coarse,
                                    device=device)
        dt = time.perf_counter() - t0
        pair_ms.append(dt * 1e3)
        T_w = T_w @ T_rel
        traj.append(T_w[:3, 3].copy())
        print(f"pair {k - 1}->{k}: fitness={fitness:.4f}  "
              f"t={T_rel[:3, 3].round(3)}  {dt * 1e3:.0f} ms")

    traj = np.stack(traj)
    ate = None
    if gt_poses is not None and len(gt_poses) == len(traj):
        ate = chained_ate(traj, gt_poses)
        print(f"ATE vs ground truth: {ate * 100:.2f} cm over {len(traj)} "
              "scans")
    return {"traj": traj, "ate": ate, "pair_ms": pair_ms}


if __name__ == "__main__":
    main()
