"""SLAM-mode demo on the PyTorch port: odometry + mapping with keyframes
and factor-graph optimization on the synthetic room, saving the PCD map at
the end (which `LocalizationPipeline` / `GlobalMap.from_pcd_dir` can then
reload).

    python -m feature_base_pointcloud_registration_tpu_torch.examples.run_slam \\
        [--scans N] [--save-dir DIR] [--loop] [--device cuda|cpu]

The trajectory and the map capacities are those of the JAX package's
examples/run_slam.py.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scans", type=int, default=20)
    ap.add_argument("--save-dir", default=None)
    ap.add_argument("--loop", action="store_true",
                    help="enable loop closure")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the pipeline (default cuda)")
    args = ap.parse_args(argv)

    from feature_base_pointcloud_registration_tpu_torch import Params
    from feature_base_pointcloud_registration_tpu_torch.io.synthetic import (
        SyntheticWorld, simulate_scan)
    from feature_base_pointcloud_registration_tpu_torch.pipeline import (
        cloud_info)
    from feature_base_pointcloud_registration_tpu_torch.pipeline.slam import (
        SlamPipeline)

    device = torch.device(args.device)
    params = Params(map_corner_cap=8192, map_surf_cap=65536,
                    loop_closure_enable_flag=args.loop)
    world = SyntheticWorld()
    pipe = SlamPipeline(params, max_keyframes=256, device=device)
    for k in range(args.scans):
        gt = np.array([0, 0, 0.04 * k, 0.25 * k - 2.0, 0.12 * k - 1.0, 0.0],
                      np.float32)
        s = simulate_scan(world, gt, seed=100 + k)
        scan = cloud_info.RawScan.from_numpy(
            s["xyz"], s["intensity"], s["ring"], s["time"],
            device=device)._replace(
            valid=torch.from_numpy(s["valid"]).to(device))
        pose = pipe.step(scan, timestamp=0.2 * k)
        print(f"scan {k:3d}: keyframes={pipe.n_keyframes:3d} "
              f"pose=({pose[3]:+7.3f} {pose[4]:+7.3f} {pose[5]:+7.3f})")
    if args.save_dir:
        pipe.save_map(args.save_dir)
        print(f"map saved to {args.save_dir}")
    return pipe


if __name__ == "__main__":
    main()
