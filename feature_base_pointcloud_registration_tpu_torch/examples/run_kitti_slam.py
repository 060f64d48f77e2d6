"""KITTI raw drive through the port's full feature pipeline: loader ->
deskew info -> projection/features -> scan-to-map SLAM (+ optional GPS
factors) -> ATE vs the oxts track.

The port's counterpart of the JAX package's examples/run_kitti_slam.py,
the reference's KITTI workflow (convert with kitti2bag, play the bag into
the LOAM stack, inspect the trajectory — ref: README.md:99-123,
config/doc/kitti2bag/kitti2bag.py) as one direct pipeline.  With --data it
consumes a real KITTI raw drive directory (HDL-64E geometry); without it,
it generates a raw-format drive by raycasting the synthetic world
(`io/kitti_drive.make_drive`) into a temporary directory and runs the
identical loader + pipeline end to end, reporting ATE vs the oxts ground
truth.

    python -m feature_base_pointcloud_registration_tpu_torch.examples.run_kitti_slam \\
        [--scans 40 --gps --navsat --plot run.png] [--data DIR] \\
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch


def _rpy_of_quat(q):
    """(x, y, z, w) -> roll, pitch, yaw (float64 numpy)."""
    x, y, z, w = (float(v) for v in q)
    return np.array([
        np.arctan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y)),
        np.arcsin(np.clip(2 * (w * y - z * x), -1, 1)),
        np.arctan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))])


def main(argv=None):
    """Run the drive; returns a dict with the ATE, the event counts of this
    run, the pipeline, the estimates, the ground truth and the per-scan
    load and step times (ms)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data", default=None,
                    help="KITTI raw drive dir; generated drive if omitted")
    ap.add_argument("--scans", type=int, default=40)
    ap.add_argument("--gps", action="store_true",
                    help="add GPS factors from the oxts fixes")
    ap.add_argument("--loop", action="store_true",
                    help="enable loop closure (ICP revisit detection, "
                         "ref: src/mapOptmization.h:582-782)")
    ap.add_argument("--loop-time-diff", type=float, default=None,
                    metavar="S",
                    help="historyKeyframeSearchTimeDiff override (default "
                         "30 s; the generated drive laps in ~2*pi*r/v s)")
    ap.add_argument("--pose-cov-threshold", type=float, default=None,
                    help="poseCovThreshold override: GPS factors inject only "
                         "once the pose marginal exceeds this (ref "
                         ":1596-1599); 0 trusts GPS unconditionally")
    ap.add_argument("--max-keyframes", type=int, default=256,
                    help="keyframe storage bound; the run EVICTS (folds old "
                         "keyframes into the root prior) past this")
    ap.add_argument("--opt-window", type=int, default=32,
                    help="trailing LM window size (must be < max-keyframes "
                         "for eviction to engage)")
    ap.add_argument("--events", default=None, metavar="JSONL",
                    help="write the full event log to this JSONL file")
    ap.add_argument("--navsat", action="store_true",
                    help="route GPS through the module_navsat analog "
                         "(EkfGps + NavsatTransform) instead of feeding "
                         "raw ENU fixes to add_gps (ref: launch/include/"
                         "module_navsat.launch)")
    ap.add_argument("--radius", type=float, default=4.0,
                    help="generated drive: circle radius (m)")
    ap.add_argument("--speed", type=float, default=1.5,
                    help="generated drive: vehicle speed (m/s)")
    ap.add_argument("--period", type=float, default=0.1,
                    help="generated drive: record interval (s)")
    ap.add_argument("--plot", default=None, metavar="PNG",
                    help="export trajectory/map overview (needs matplotlib)")
    ap.add_argument("--sensor", choices=["hdl64", "vlp16"], default=None,
                    help="lidar geometry (default: hdl64 for --data, "
                         "vlp16 for the generated drive)")
    ap.add_argument("--no-deskew", action="store_true",
                    help="skip the oxts IMU deskew-info path")
    ap.add_argument("--pos-deskew", action="store_true",
                    help="also correct intra-scan TRANSLATION from the oxts "
                         "body velocity (the reference stubs findPosition to "
                         "zero — src/imageProjection.cpp:528-542)")
    ap.add_argument("--no-attitude", action="store_true",
                    help="deskew only: do not feed the oxts attitude into "
                         "the initial-guess / attitude-fusion policies")
    ap.add_argument("--spread", type=float, default=0.0, metavar="M",
                    help="surf_min_planar_spread: reject surf plane fits "
                         "whose 5-NN scatter is near-collinear (middle "
                         "singular value < M meters); 0 = reference parity")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the pipeline (default cuda)")
    args = ap.parse_args(argv)

    from feature_base_pointcloud_registration_tpu_torch import Params
    from feature_base_pointcloud_registration_tpu_torch.io import kitti
    from feature_base_pointcloud_registration_tpu_torch.pipeline.frontend import (  # noqa: E501
        make_deskew_info)
    from feature_base_pointcloud_registration_tpu_torch.pipeline.slam import (
        SlamPipeline)
    from feature_base_pointcloud_registration_tpu_torch.utils.log import (
        EventLog, set_logger)

    device = torch.device(args.device)
    if args.data:
        data_dir = args.data
        sensor = args.sensor or "hdl64"
    else:
        from feature_base_pointcloud_registration_tpu_torch.io.kitti_drive import (  # noqa: E501
            make_drive)

        data_dir = os.path.join(
            tempfile.gettempdir(), "fbpr_kitti_drive",
            f"n{args.scans}_r{args.radius:g}_v{args.speed:g}"
            f"_p{args.period:g}")
        if not os.path.exists(os.path.join(data_dir, "gt_poses.npy")):
            print(f"generating raw-format drive at {data_dir} ...")
            make_drive(data_dir, n_scans=args.scans, radius=args.radius,
                       speed=args.speed, period=args.period)
        sensor = args.sensor or "vlp16"

    # mapping_process_interval=0: process every 10 Hz scan.  The reference
    # default (0.15 s) would skip alternate scans, which is a rate
    # regulator, not SLAM quality — the ATE here should measure the map.
    overrides = dict(loop_closure_enable_flag=args.loop)
    if args.loop_time_diff is not None:
        overrides["history_keyframe_search_time_diff"] = args.loop_time_diff
    if args.pose_cov_threshold is not None:
        overrides["pose_cov_threshold"] = args.pose_cov_threshold
    if sensor == "vlp16":
        geom = dict(n_rings=16, elev_min=-15.0, elev_max=15.0)
        params = Params(n_scan=16, map_corner_cap=8192, map_surf_cap=65536,
                        mapping_process_interval=0.0,
                        surf_min_planar_spread=args.spread, **overrides)
        max_points = 16 * 1800
    else:
        geom = dict(n_rings=64, elev_min=-24.9, elev_max=2.0)
        params = Params(n_scan=64, horizon_scan=1800, corner_cap=7680,
                        surf_cap=32768, sector_cap=304,
                        map_corner_cap=16384, map_surf_cap=131072,
                        mapping_process_interval=0.0,
                        surf_min_planar_spread=args.spread, **overrides)
        max_points = 1 << 17

    vdir = os.path.join(data_dir, "velodyne_points", "data")
    odir = os.path.join(data_dir, "oxts")
    times = kitti.load_times(os.path.join(data_dir, "velodyne_points"),
                             len(kitti.scan_files(vdir)))
    gt = kitti.load_oxts_poses(odir)
    imu = kitti.load_oxts_imu(odir)
    gps = kitti.load_oxts_gps(odir)

    # a fresh process-wide event log: the summary counts this run's events
    # only (the JAX example's counts pile up over calls of main)
    log = EventLog()
    set_logger(log)
    pipe = SlamPipeline(params, max_keyframes=args.max_keyframes,
                        opt_window=min(args.opt_window,
                                       max(args.max_keyframes // 2, 4)),
                        device=device)
    navsat = None
    if args.navsat:
        from feature_base_pointcloud_registration_tpu_torch.pipeline.navsat import (  # noqa: E501
            EkfGps, NavsatTransform)
        navsat = NavsatTransform(EkfGps(device=device))
    est, load_ms, step_ms = [], [], []
    n_done = 0
    t0 = time.perf_counter()
    scans = kitti.iter_scans(vdir, max_points=max_points, device=device,
                             **geom)
    try:
        for k in range(min(args.scans, len(times))):
            t_load = time.perf_counter()
            raw = next(scans, None)
            if raw is None:
                break
            load_ms.append((time.perf_counter() - t_load) * 1e3)
            t_step = time.perf_counter()
            t = float(times[k])
            # oxts IMU stream (10 Hz on KITTI raw): attitude + gyro table
            # for deskew and the rotation initial guess, like the bag replay
            # feeds imuHandler (ref: src/imageProjection.cpp:323-393)
            win = (imu["times"] >= t - 0.15) & (imu["times"] <= t + 0.15)
            dsk = None
            if win.any() and not args.no_deskew:
                # attitude from the sample NEAREST the scan start (the first
                # sample in the window can be 0.1 s stale on 10 Hz oxts)
                ni = int(np.argmin(np.abs(imu["times"] - t)))
                rpy0 = _rpy_of_quat(imu["quat"][ni]).astype(np.float32)
                # positional deskew: scan-duration translation increment in
                # the scan-start body frame, from the oxts body velocity
                incre = imu["vel"][ni] * 0.1 if args.pos_deskew else None
                dsk = make_deskew_info(params, imu["times"][win],
                                       imu["gyr"][win], t, t + 0.1,
                                       imu_rpy=(None if args.no_attitude
                                                else rpy0),
                                       odom_incre=incre,
                                       odom_deskew_flag=args.pos_deskew,
                                       device=device)
                if args.no_attitude:
                    dsk = dsk._replace(
                        imu_available=torch.zeros_like(dsk.imu_available))
            if args.gps and len(gps["times"]):
                gi = int(np.argmin(np.abs(gps["times"] - t)))
                if abs(gps["times"][gi] - t) < 0.05:
                    if navsat is not None:
                        # module_navsat chain: the EKF ingests the IMU
                        # attitude/rate stream + the LIO pose (odometry/
                        # filtered), the navsat node anchors + republishes
                        # the fix as map-frame odometry (odometry/gps)
                        ii = int(np.argmin(np.abs(imu["times"] - t)))
                        rpy_ekf = _rpy_of_quat(imu["quat"][ii])
                        navsat.ekf.add_imu(t, rpy_ekf, imu["gyr"][ii])
                        navsat.ekf.add_odometry(t, pipe.pose)
                        xyz_m, cov_m = navsat.handle_fix(
                            t, gps["xyz"][gi], gps["cov"][gi],
                            imu_yaw=float(rpy_ekf[2]))
                        pipe.add_gps(t, xyz_m, cov_m)
                    else:
                        pipe.add_gps(t, gps["xyz"][gi], gps["cov"][gi])
            pose = pipe.step(raw, timestamp=t, deskew_info=dsk)
            step_ms.append((time.perf_counter() - t_step) * 1e3)
            est.append(pose.copy())
            n_done += 1
            if k % 10 == 0:
                print(f"scan {k:4d}: keyframes={pipe.n_keyframes:3d} "
                      f"pose=({pose[3]:+7.2f} {pose[4]:+7.2f} "
                      f"{pose[5]:+6.2f})")
    finally:
        scans.close()      # stops the prefetch workers
    dt = time.perf_counter() - t0

    est = np.stack(est)
    n = min(len(est), len(gt))
    err = np.linalg.norm(est[:n, 3:6] - gt[:n, 3:6], axis=1)
    ate = float(np.sqrt((err ** 2).mean()))
    print(f"\n{n_done} scans in {dt:.1f}s ({n_done / dt:.1f} scans/s "
          "host-driven)")
    print(f"ATE vs oxts over {n} scans: {ate * 100:.1f} cm "
          f"(max {err.max() * 100:.1f} cm)")

    # event summary: the latent back-end paths that fired this run (loop
    # closure / GPS factors / eviction — the reference's interacting
    # mapOptmization threads, ref: src/mapOptmization.h:346-389)
    events = list(log.events)
    counts = {}
    for ev in events:
        counts[ev["topic"]] = counts.get(ev["topic"], 0) + 1
    interesting = ["mapping/keyframe", "mapping/loop_closure",
                   "mapping/gps_factor", "mapping/evict",
                   "mapping/evict_dropped_factors"]
    print("events: " + "  ".join(
        f"{t.split('/')[-1]}={counts.get(t, 0)}" for t in interesting))
    if args.events:
        log.to_jsonl(args.events)
        print(f"event log written to {args.events}")

    if args.plot:
        from feature_base_pointcloud_registration_tpu_torch.utils.viz import (  # noqa: E501
            export_run_plot)
        export_run_plot(pipe, args.plot, gt_xy=gt[:n, 3:5])
        print(f"overview written to {args.plot}")
    return {"ate": ate, "counts": counts, "pipe": pipe, "est": est,
            "gt": gt[:n], "load_ms": load_ms, "step_ms": step_ms}


if __name__ == "__main__":
    main()
