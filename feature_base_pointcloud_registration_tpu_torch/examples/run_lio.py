"""LIO-mode demo on the PyTorch port: the test.launch process pair —
IMU preintegration odometry feeding initial guesses and deskew into the
SLAM pipeline, the SLAM pose fed back as the odometry correction — on the
synthetic platform of the JAX package's `examples/run.py --mode lio`.

    python -m feature_base_pointcloud_registration_tpu_torch.examples.run_lio \\
        [--scans N] [--save-dir DIR] [--resume DIR] [--device cuda|cpu]

The raw sensor-frame IMU (100 Hz, reference extrinsics) goes in batches
through `LioTopology.handle_imu`, one scan every 0.2 s through
`handle_cloud`.  With `--resume DIR` the SLAM state and the scan cursor are
checkpointed to DIR every 4 scans (`utils.supervise.checkpoint`), and a
run started on a DIR that holds a checkpoint loads it and continues from
the first scan the checkpointed pipeline had not processed (the IMU
odometry starts afresh, as a respawned imuPreintegration node does).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

CHECKPOINT_EVERY = 4      # scans between checkpoints under --resume


def _rpy(R):
    return np.array([np.arctan2(R[2, 1], R[2, 2]),
                     np.arcsin(np.clip(-R[2, 0], -1, 1)),
                     np.arctan2(R[1, 0], R[0, 0])], np.float32)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scans", type=int, default=10)
    ap.add_argument("--save-dir", default=None)
    ap.add_argument("--resume", default=None, metavar="DIR",
                    help="checkpoint here and continue from a checkpoint "
                         "found here")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the pipelines (default cuda)")
    args = ap.parse_args(argv)

    import dataclasses

    from feature_base_pointcloud_registration_tpu_torch import Params
    from feature_base_pointcloud_registration_tpu_torch.io.synthetic import (
        SyntheticWorld, constant_twist_platform, simulate_scan)
    from feature_base_pointcloud_registration_tpu_torch.pipeline import (
        checkpoint as ckpt)
    from feature_base_pointcloud_registration_tpu_torch.pipeline.cloud_info import (  # noqa: E501
        RawScan)
    from feature_base_pointcloud_registration_tpu_torch.pipeline.lio import (
        LioTopology)
    from feature_base_pointcloud_registration_tpu_torch.utils import (
        supervise)

    device = torch.device(args.device)
    params = dataclasses.replace(Params(), map_corner_cap=8192,
                                 map_surf_cap=65536)
    world = SyntheticWorld()
    topo = LioTopology(params, max_keyframes=256, imu_window=16,
                       imu_max_samples=64, device=device)
    scan_period = max(params.mapping_process_interval, 0.2)
    # the ScanBuffer holds 2 scans back: simulate 2 more scan periods
    duration = (args.scans + 2) * scan_period + 0.3
    imu, states = constant_twist_platform(
        duration, ext_rot=params.ext_rot, ext_rpy=params.ext_rpy,
        gravity=params.imu_gravity)
    gt = {round(t, 4): (R, p) for (t, R, p) in states}
    scan_times = np.arange(0.0, duration - 0.25, scan_period)

    start = 0
    if args.resume and ckpt.has_checkpoint(args.resume):
        ckpt.load_checkpoint(topo.slam, args.resume)
        start = supervise.load_cursor(args.resume)
        print(f"resumed from {args.resume} at scan {start} "
              f"({topo.slam.n_keyframes} keyframes)")
    imu_t = np.array([s[0] for s in imu])
    imu_idx = (int(np.searchsorted(imu_t, scan_times[start] - 0.5))
               if start < len(scan_times) else len(imu))
    for k in range(start, len(scan_times)):
        st = scan_times[k]
        batch = []
        while imu_idx < len(imu) and imu[imu_idx][0] <= st:
            batch.append(imu[imu_idx])
            imu_idx += 1
        if batch:
            topo.handle_imu(*(np.stack([b[i] for b in batch])
                              for i in range(4)))
        R, p = gt[round(st, 4)]
        s = simulate_scan(world, np.concatenate([_rpy(R), p]),
                          seed=int(st * 10))
        raw = RawScan.from_numpy(s["xyz"], s["intensity"], s["ring"],
                                 s["time"], device=torch.device("cpu"))
        raw = raw._replace(valid=torch.from_numpy(s["valid"]))
        est = topo.handle_cloud(float(st), raw)
        if est is None:
            print(f"t={st:5.1f}s buffering (<3 scans queued)")
        else:
            t_proc = topo.slam.time_last_processing
            err = np.linalg.norm(est[3:] - gt[round(t_proc, 4)][1])
            print(f"t={t_proc:5.1f}s keyframes={topo.slam.n_keyframes:3d} "
                  f"err={err * 100:6.2f} cm")
        if args.resume and ((k + 1) % CHECKPOINT_EVERY == 0
                            or k + 1 == len(scan_times)):
            # the scans still in the buffer are processed again on resume
            supervise.checkpoint(topo.slam, args.resume,
                                 k + 1 - len(topo.scan_buffer.queue))
    if args.save_dir:
        os.makedirs(args.save_dir, exist_ok=True)
        topo.slam.save_map(args.save_dir)
        print(f"map saved to {args.save_dir}")
    return topo


if __name__ == "__main__":
    main()
