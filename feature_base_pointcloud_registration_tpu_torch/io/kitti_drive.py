"""Generate a KITTI-raw-format drive by raycasting the synthetic world.

The port's copy of `drive_pose`, `oxts_record` and `make_drive` from the
repository's `scripts/make_kitti_drive.py` (which imports the JAX package's
`io/synthetic.py`; this copy stands on the port's, which gives the same
scans for the same seeds, so the two write the same bytes).  It writes a
drive in the exact on-disk raw format `io/kitti.py` consumes (ref:
config/doc/kitti2bag/kitti2bag.py formats): velodyne_points/data/*.bin
float32 [x y z reflectance] of valid returns, oxts/data/*.txt 30-field
records, nanosecond timestamp files.

Scans are VLP-16 raycasts (simulate_scan) of the shared SyntheticWorld
along a closed circular drive; oxts records carry the exact trajectory
(lat/lon/alt via the same equirectangular mapping load_oxts_poses
inverts) with consistent body-frame velocity, acceleration (incl.
gravity), and angular rate.

Known defect, kept for parity with the script: the timestamp lines carry
seconds into minutes but minutes into no hour (`13:{2 + sec // 60:02d}`),
so a drive longer than about 58 minutes gets invalid times.
"""

from __future__ import annotations

import os

import numpy as np

LAT0, LON0, ALT0 = 49.011212, 8.423308, 112.83
EARTH = 6378137.0


def drive_pose(k: int, n: int, radius: float = 4.0, speed: float = 1.5,
               period: float = 0.1):
    """Closed circular drive: pose6 [roll, pitch, yaw, x, y, z] + rates."""
    omega = speed / radius
    t = k * period
    th = omega * t - np.pi / 2
    x = radius * np.cos(th)
    y = radius * np.sin(th) + radius        # start near origin
    yaw = float(np.arctan2(np.sin(th + np.pi / 2),
                           np.cos(th + np.pi / 2)))  # tangent, wrapped
    pose = np.array([0.0, 0.0, yaw, x, y, 0.4], np.float32)
    vx = -radius * omega * np.sin(th)       # world-frame velocity
    vy = radius * omega * np.cos(th)
    return pose, (vx, vy), omega


def oxts_record(pose, vel, omega, speed):
    roll, pitch, yaw, x, y, z = [float(v) for v in pose]
    vx, vy = vel
    scale = np.cos(np.deg2rad(LAT0))
    lat = LAT0 + np.rad2deg(y / EARTH)
    lon = LON0 + np.rad2deg(x / (EARTH * scale))
    alt = ALT0 + z
    vn, ve = vy, vx
    vf, vl, vu = speed, 0.0, 0.0
    # world acceleration = centripetal toward circle center; body frame
    # adds gravity reaction on the up axis
    ax = -omega * vy
    ay = omega * vx
    az = 9.81
    af, al, au = 0.0, omega * speed, 9.81
    wx, wy, wz = 0.0, 0.0, omega
    wf, wl, wu = 0.0, 0.0, omega
    rec = [lat, lon, alt, roll, pitch, yaw, vn, ve, vf, vl, vu,
           ax, ay, az, af, al, au, wx, wy, wz, wf, wl, wu,
           0.05, 0.02, 4, 11, 5, 5, 6]
    return " ".join(f"{v:.12g}" for v in rec)


def make_drive(out: str, n_scans: int = 40, radius: float = 4.0,
               speed: float = 1.5, noise: float = 0.01, seed: int = 0,
               motion_skew: bool = True, period: float = 0.1):
    """motion_skew=True raycasts each scan with the drive's true angular
    rate AND world velocity applied during the sweep (points land in the
    instantaneous sensor frame, like a real spinning lidar on a moving
    vehicle), so the pipeline's gyro deskew is exercised for real; False
    writes rigid snapshots (no intra-scan motion).

    period is the RECORD interval (seconds between stored scans and oxts
    rows); the lidar sweep itself always spans 0.1 s (a 10 Hz spinner).
    period > 0.1 subsamples the drive like the reference's
    mapping_process_interval, so long loops fit in few scans."""
    from .synthetic import SyntheticWorld, simulate_scan

    vdir = os.path.join(out, "velodyne_points", "data")
    odir = os.path.join(out, "oxts", "data")
    os.makedirs(vdir, exist_ok=True)
    os.makedirs(odir, exist_ok=True)

    world = SyntheticWorld()
    gt = []
    for k in range(n_scans):
        pose, vel, omega = drive_pose(k, n_scans, radius, speed,
                                      period=period)
        gt.append(pose)
        skew = (dict(spin_rpy_rate=np.array([0.0, 0.0, omega]),
                     vel_world=np.array([vel[0], vel[1], 0.0]))
                if motion_skew else {})
        s = simulate_scan(world, pose, noise=noise, seed=seed + k, **skew)
        ok = s["valid"]
        arr = np.concatenate(
            [s["xyz"][ok], s["intensity"][ok, None]], -1).astype(np.float32)
        arr.tofile(os.path.join(vdir, f"{k:010d}.bin"))
        with open(os.path.join(odir, f"{k:010d}.txt"), "w") as fh:
            fh.write(oxts_record(pose, vel, omega, speed) + "\n")

    for sub in ("oxts", "velodyne_points"):
        with open(os.path.join(out, sub, "timestamps.txt"), "w") as fh:
            for k in range(n_scans):
                ns = round(k * period * 1e9)
                sec = 25 + ns // 10 ** 9
                fh.write(f"2011-09-26 13:{2 + sec // 60:02d}:{sec % 60:02d}."
                         f"{ns % 10 ** 9:09d}\n")
    np.save(os.path.join(out, "gt_poses.npy"), np.stack(gt))
    return np.stack(gt)
