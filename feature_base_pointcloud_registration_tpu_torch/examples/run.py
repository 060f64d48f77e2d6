"""Config-driven topology runner on the PyTorch port — the `roslaunch`
analog.

The reference starts its nodes via launch files that load params.yaml and
wire topics (run.launch / test.launch, ref: launch/run.launch:1-21,
launch/test.launch:1-22).  Here the same topology is a driver loop wiring
arrays between pipeline objects, selected by --mode:

  lio           test.launch equivalent: IMU preintegration odometry feeds
                initial guesses + deskew info into the SLAM pipeline; the
                SLAM pose feeds back as the odometry correction with the
                reset-id protocol (the imageProjection + imuPreintegration
                process pair)
  slam          mapping only (laserCloudInfoHandler path, no IMU)
  localization  scan-to-map registration against a prebuilt PCD map dir
                (the fork's active path, ref: src/mapOptmization.h:263-343)

    python -m feature_base_pointcloud_registration_tpu_torch.examples.run \\
        --mode lio --scans 20 [--device cuda|cpu]
    python -m feature_base_pointcloud_registration_tpu_torch.examples.run \\
        --mode slam --params config/params.yaml --save-dir /tmp/map
    python -m feature_base_pointcloud_registration_tpu_torch.examples.run \\
        --mode localization --map-dir /tmp/map

The port's counterpart of the JAX package's examples/run.py, with its
trajectories, seeds and capacities.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch


def _rpy(R):
    return np.array([np.arctan2(R[2, 1], R[2, 2]),
                     np.arcsin(np.clip(-R[2, 0], -1, 1)),
                     np.arctan2(R[1, 0], R[0, 0])], np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("lio", "slam", "localization"),
                    default="lio")
    ap.add_argument("--params", default=None,
                    help="reference-format params.yaml (keys like N_SCAN, "
                         "edgeThreshold...); built-in defaults when omitted")
    ap.add_argument("--scans", type=int, default=10)
    ap.add_argument("--save-dir", default=None)
    ap.add_argument("--map-dir", default=None,
                    help="prebuilt map directory for --mode localization")
    ap.add_argument("--data", default=None,
                    help="KITTI raw drive dir (velodyne_points/ + oxts/) for "
                         "--mode lio; synthetic platform when omitted")
    ap.add_argument("--loop", action="store_true", help="enable loop closure")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    from feature_base_pointcloud_registration_tpu_torch.config import Params
    from feature_base_pointcloud_registration_tpu_torch.io.synthetic import (
        SyntheticWorld, build_feature_map, simulate_scan)
    from feature_base_pointcloud_registration_tpu_torch.pipeline.cloud_info import (  # noqa: E501
        RawScan)
    from feature_base_pointcloud_registration_tpu_torch.utils.timing import (
        StageTimer)

    device = torch.device(args.device)
    if args.params:
        params = Params.from_yaml(args.params)
        print(f"params loaded from {args.params}")
    else:
        params = Params()
    params = dataclasses.replace(params, map_corner_cap=8192,
                                 map_surf_cap=65536,
                                 loop_closure_enable_flag=args.loop
                                 or params.loop_closure_enable_flag)

    world = SyntheticWorld()
    timer = StageTimer()

    def raw_of(s):
        return RawScan.from_numpy(s["xyz"], s["intensity"], s["ring"],
                                  s["time"], device=device)._replace(
            valid=torch.from_numpy(s["valid"]).to(device))

    if args.mode == "localization":
        from feature_base_pointcloud_registration_tpu_torch.pipeline.localization import (  # noqa: E501
            GlobalMap, LocalizationPipeline)

        if args.map_dir:
            gm = GlobalMap.from_pcd_dir(params, args.map_dir,
                                        corner_cap=16384, surf_cap=131072,
                                        device=device)
            print(f"map loaded from {args.map_dir}")
        else:
            gm = GlobalMap(*(torch.from_numpy(a).to(device) for a in
                             build_feature_map(world, 16384, 131072)))
            print("map built from the synthetic world")
        pipe = LocalizationPipeline(params, gm)
        for k in range(args.scans):
            gt = np.array([0, 0, 0.04 * k, 0.3 * k - 2.0, 0.15 * k - 1.0, 0],
                          np.float32)
            s = simulate_scan(world, gt, seed=200 + k)
            guess = gt + np.array([0, 0, .02, .15, -.1, .05], np.float32)
            with timer.stage("scan"):
                pose = pipe.step(raw_of(s), timestamp=0.2 * k,
                                 initial_guess=guess)
            err = np.linalg.norm(np.asarray(pose)[3:] - gt[3:])
            print(f"scan {k:3d}: err={err * 100:6.2f} cm")
        print(timer.summary())
        return pipe

    from feature_base_pointcloud_registration_tpu_torch.pipeline.slam import (
        SlamPipeline)

    if args.mode == "slam":
        slam = SlamPipeline(params, max_keyframes=256, device=device)
        for k in range(args.scans):
            gt = np.array([0, 0, 0.04 * k, 0.25 * k - 2.0, 0.12 * k - 1.0, 0],
                          np.float32)
            s = simulate_scan(world, gt, seed=100 + k)
            with timer.stage("scan"):
                pose = slam.step(raw_of(s), timestamp=0.2 * k)
            print(f"scan {k:3d}: keyframes={slam.n_keyframes:3d} "
                  f"pose=({pose[3]:+7.3f} {pose[4]:+7.3f} {pose[5]:+7.3f})")
    elif args.mode == "lio" and args.data:
        # full LIO (BASELINE config 4) on a real KITTI raw drive:
        # velodyne scans + oxts IMU stream + oxts GPS fixes
        from feature_base_pointcloud_registration_tpu_torch.io import kitti
        from feature_base_pointcloud_registration_tpu_torch.pipeline.lio import (  # noqa: E501
            LioTopology)

        if args.params is None:
            # HDL-64 geometry unless the user supplied a params.yaml
            params = dataclasses.replace(params, n_scan=64)
        vdir = os.path.join(args.data, "velodyne_points", "data")
        files = kitti.scan_files(vdir)
        if not files:
            raise SystemExit(f"no velodyne .bin files under {vdir}")
        files = files[: args.scans + 2]
        scan_ts = kitti.load_times(
            os.path.join(args.data, "velodyne_points"), len(files))
        imu = kitti.load_oxts_imu(os.path.join(args.data, "oxts"))
        gps = kitti.load_oxts_gps(os.path.join(args.data, "oxts"))
        print(f"{len(files)} scans, {len(imu['times'])} imu records, "
              f"{len(gps['times'])} gps fixes from {args.data}")

        topo = LioTopology(params, max_keyframes=256, imu_window=16,
                           imu_max_samples=256, device=device)
        slam = topo.slam
        imu_idx = gps_idx = 0
        # native threaded prefetch: the next scans decode on the host while
        # this one runs on the device (io.kitti.iter_scans)
        scans = kitti.iter_scans(vdir, device=device)
        try:
            for k in range(len(files)):
                st = float(scan_ts[k])
                hi = np.searchsorted(imu["times"], st, side="right")
                if hi > imu_idx:
                    topo.handle_imu(imu["times"][imu_idx:hi],
                                    imu["acc"][imu_idx:hi],
                                    imu["gyr"][imu_idx:hi],
                                    imu["quat"][imu_idx:hi])
                    imu_idx = hi
                ghi = np.searchsorted(gps["times"], st, side="right")
                for gk in range(gps_idx, ghi):
                    slam.add_gps(float(gps["times"][gk]), gps["xyz"][gk],
                                 gps["cov"][gk])
                gps_idx = ghi
                raw = next(scans)
                with timer.stage("scan"):
                    est = topo.handle_cloud(st, raw)
                if est is None:
                    print(f"t={st:6.2f}s buffering")
                    continue
                print(f"t={topo.slam.time_last_processing:6.2f}s "
                      f"keyframes={slam.n_keyframes:3d} "
                      f"pose=({est[3]:+8.2f} {est[4]:+8.2f} {est[5]:+7.2f})")
        finally:
            scans.close()   # stops the prefetch workers
    else:  # lio — the fully-wired test.launch topology, synthetic platform
        from feature_base_pointcloud_registration_tpu_torch.io.synthetic import (  # noqa: E501
            constant_twist_platform)
        from feature_base_pointcloud_registration_tpu_torch.pipeline.lio import (  # noqa: E501
            LioTopology)

        topo = LioTopology(params, max_keyframes=256, imu_window=16,
                           imu_max_samples=64, device=device)
        slam = topo.slam
        scan_period = max(params.mapping_process_interval, 0.2)
        # ScanBuffer holds 2 scans back, so simulate 2 extra scan periods
        duration = (args.scans + 2) * scan_period + 0.3
        # RAW sensor-frame IMU: the topology's imu_converter must undo the
        # reference extrinsics (config/params.yaml:37-42 equivalents)
        imu, states = constant_twist_platform(
            duration, ext_rot=params.ext_rot, ext_rpy=params.ext_rpy,
            gravity=params.imu_gravity)
        gt_by_time = {round(t, 4): (R, p) for (t, R, p) in states}
        scan_times = np.arange(0.0, duration - 0.25, scan_period)

        imu_idx = 0
        for st in scan_times:
            # batch-feed raw IMU samples up to the scan stamp
            batch = []
            while imu_idx < len(imu) and imu[imu_idx][0] <= st:
                batch.append(imu[imu_idx])
                imu_idx += 1
            if batch:
                topo.handle_imu(*(np.stack([b[i] for b in batch])
                                  for i in range(4)))

            R, p = gt_by_time[round(st, 4)]
            s = simulate_scan(world, np.concatenate([_rpy(R), p]),
                              seed=int(st * 10))
            with timer.stage("scan"):
                est = topo.handle_cloud(float(st), raw_of(s))
            if est is None:
                print(f"t={st:5.1f}s buffering (<3 scans queued)")
                continue
            # the emitted scan lags the input by the buffer depth
            t_proc = topo.slam.time_last_processing
            _, p_gt = gt_by_time[round(t_proc, 4)]
            err = np.linalg.norm(est[3:] - p_gt.astype(np.float32))
            print(f"t={t_proc:5.1f}s keyframes={slam.n_keyframes:3d} "
                  f"err={err * 100:6.2f} cm")

    print(timer.summary())
    if args.save_dir:
        slam.save_map(args.save_dir)
        print(f"map saved to {args.save_dir}")
    return slam


if __name__ == "__main__":
    main()
