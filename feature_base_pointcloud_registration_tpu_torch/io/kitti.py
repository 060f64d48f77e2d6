"""KITTI dataset loader (HDL-64E velodyne scans).

Port of the JAX package's `io/kitti.py`.  Replaces the reference's offline
kitti2bag converter (ref: config/doc/kitti2bag/kitti2bag.py — KITTI raw ->
rosbag): scans load straight from the velodyne .bin files into the port's
RawScan on an explicit device (ring inferred from elevation,
azimuth-proportional per-point time, decoded on the host by the copied
`native` runtime), plus oxts ground-truth pose, IMU and GPS parsing, which
stays host NumPy.
"""

from __future__ import annotations

import glob
import os
import warnings

import numpy as np
import torch

from .. import native
from ..pipeline.cloud_info import RawScan

HDL64_RINGS = 64
HDL64_ELEV_MIN = -24.9
HDL64_ELEV_MAX = 2.0


def _raw_scan(d, n: int, max_points: int, device) -> RawScan:
    """A decoded scan's first n points -> RawScan padded to max_points;
    valid = decoded valid and a ring inside the sensor's."""
    raw = RawScan.from_numpy(d["xyz"][:n], d["intensity"][:n],
                             d["ring"][:n], d["time"][:n],
                             max_points=max_points, device=device)
    valid = np.zeros(max_points, bool)
    valid[:n] = d["valid"][:n] & (d["ring"][:n] >= 0)
    return raw._replace(valid=torch.from_numpy(valid).to(device))


def load_scan(path: str, max_points: int = 1 << 17,
              n_rings: int = HDL64_RINGS,
              elev_min: float = HDL64_ELEV_MIN,
              elev_max: float = HDL64_ELEV_MAX, *, device) -> RawScan:
    """One velodyne .bin -> RawScan (padded to max_points) on `device`.

    Sensor geometry defaults to the HDL-64E that recorded KITTI raw; pass
    n_rings/elev_min/elev_max for other spinning lidars stored in the same
    .bin format (ring is re-derived from elevation either way)."""
    d = native.kitti_read_bin(path, n_rings=n_rings, elev_min=elev_min,
                              elev_max=elev_max)
    n = len(d["xyz"])
    if n > max_points:
        _warn_truncated(path, n, max_points)
        n = max_points
    return _raw_scan(d, n, max_points, device)


_warned_truncation = False


def _warn_truncated(path: str, n: int, max_points: int):
    """Warn ONCE per process when a scan exceeds the point cap (dense HDL-64
    frames run ~120-130k points, right at the default 131072 cap)."""
    global _warned_truncation
    if not _warned_truncation:
        _warned_truncation = True
        warnings.warn(
            f"KITTI scan {os.path.basename(path)} has {n} points, truncated "
            f"to max_points={max_points}; raise max_points to keep them "
            "(further truncations this process will be silent)",
            stacklevel=3)


def scan_files(velodyne_dir: str):
    return sorted(glob.glob(os.path.join(velodyne_dir, "*.bin")))


def iter_scans(velodyne_dir: str, max_points: int = 1 << 17,
               queue_depth: int = 4, n_threads: int = 2,
               n_rings: int = HDL64_RINGS,
               elev_min: float = HDL64_ELEV_MIN,
               elev_max: float = HDL64_ELEV_MAX, *, device):
    """Iterate RawScans on `device` with native threaded prefetch: worker
    threads decode upcoming .bin files on the host while the consumer's
    scan is on the device (native.ScanLoader; synchronous fallback without
    the shared library).  Close the generator (or exhaust it) to stop the
    workers."""
    paths = scan_files(velodyne_dir)
    with native.ScanLoader(paths, cap=max_points, queue_depth=queue_depth,
                           n_threads=n_threads, n_rings=n_rings,
                           elev_min=elev_min, elev_max=elev_max) as it:
        for i, d in enumerate(it):
            if len(d["xyz"]) > max_points:
                _warn_truncated(paths[i], len(d["xyz"]), max_points)
            yield _raw_scan(d, min(len(d["xyz"]), max_points), max_points,
                            device)


def load_times(directory: str, n: int):
    """Sensor timestamps (seconds from the first stamp) for a KITTI raw
    stream directory holding a timestamps.txt; 10 Hz index clock fallback."""
    return _oxts_times(directory, n)


_EARTH = 6378137.0


def _oxts_files(oxts_dir: str):
    """Raw layout (<dir>/data/*.txt) or flat (<dir>/*.txt)."""
    files = sorted(glob.glob(os.path.join(oxts_dir, "data", "*.txt")))
    if not files:
        files = sorted(glob.glob(os.path.join(oxts_dir, "*.txt")))
        files = [f for f in files if not f.endswith("timestamps.txt")]
    return files


def _oxts_times(oxts_dir: str, n: int):
    """Parse timestamps.txt (datetime lines, ns precision) into seconds from
    the first stamp; fall back to a 10 Hz index clock (synced dataset rate)
    when absent.  kitti2bag reads the same file (ref: kitti2bag.py:54-67)."""
    for cand in (os.path.join(oxts_dir, "timestamps.txt"),
                 os.path.join(oxts_dir, "..", "timestamps.txt")):
        if os.path.exists(cand):
            stamps = []
            with open(cand) as fh:
                for line in fh:
                    line = line.strip()
                    if not line:
                        continue
                    stamps.append(np.datetime64(line.replace(" ", "T")))
            if stamps:
                t0 = stamps[0]
                return np.array(
                    [(s - t0) / np.timedelta64(1, "ns") * 1e-9
                     for s in stamps[:n]], np.float64)
    return np.arange(n, dtype=np.float64) * 0.1


def _read_oxts(oxts_dir: str):
    """All oxts records as one [N, F] float64 array (F >= 23) + times [N]."""
    files = _oxts_files(oxts_dir)
    if not files:
        return np.zeros((0, 30)), np.zeros(0)
    rows = [np.atleast_1d(np.loadtxt(f)) for f in files]
    width = len(rows[0])
    # ragged records happen in some raw drives (truncated trailing fields);
    # pad short rows with zeros instead of letting np.stack raise
    if any(len(r) != width for r in rows):
        warnings.warn(
            f"oxts records in {oxts_dir} are ragged "
            f"(lengths {sorted({len(r) for r in rows})}); short rows are "
            "zero-padded", stacklevel=2)
    data = np.stack([
        r[:width] if len(r) >= width
        else np.concatenate([r, np.zeros(width - len(r))])
        for r in rows])
    times = _oxts_times(oxts_dir, len(files))
    if len(times) < len(files):
        times = np.arange(len(files), dtype=np.float64) * 0.1
    return data, times[: len(files)]


def _latlon_to_enu(lat, lon, alt, origin):
    """Equirectangular local tangent frame like kitti2bag's odometry path."""
    scale = np.cos(np.deg2rad(origin[0]))
    x = _EARTH * np.deg2rad(lon - origin[1]) * scale
    y = _EARTH * np.deg2rad(lat - origin[0])
    z = alt - origin[2]
    return x, y, z


def _quat_from_euler_np(roll, pitch, yaw):
    """tf-convention (x,y,z,w), matching kitti2bag's
    quaternion_from_euler (ref: kitti2bag.py:31)."""
    cr, sr = np.cos(roll * 0.5), np.sin(roll * 0.5)
    cp, sp = np.cos(pitch * 0.5), np.sin(pitch * 0.5)
    cy, sy = np.cos(yaw * 0.5), np.sin(yaw * 0.5)
    return np.stack([sr * cp * cy - cr * sp * sy,
                     cr * sp * cy + sr * cp * sy,
                     cr * cp * sy - sr * sp * cy,
                     cr * cp * cy + sr * sp * sy], axis=-1)


def load_oxts_poses(oxts_dir: str):
    """oxts txt files -> [N, 6] pose6 (local ENU tangent frame at the first
    fix; lat/lon via equirectangular approximation like kitti2bag's odometry
    path)."""
    data, _ = _read_oxts(oxts_dir)
    if not len(data):
        return np.zeros((0, 6), np.float32)
    origin = data[0, :3]
    x, y, z = _latlon_to_enu(data[:, 0], data[:, 1], data[:, 2], origin)
    return np.stack([data[:, 3], data[:, 4], data[:, 5], x, y, z],
                    axis=-1).astype(np.float32)


def load_oxts_imu(oxts_dir: str):
    """The IMU stream kitti2bag exports on /kitti/oxts/imu
    (ref: config/doc/kitti2bag/kitti2bag.py:28-45): body-frame accel
    (af, al, au — oxts fields 14-16), body-frame rates (wf, wl, wu —
    fields 20-22), orientation quaternion from (roll, pitch, yaw).

    Returns dict(times [N], acc [N,3], gyr [N,3], quat [N,4],
    vel [N,3]) — raw IMU-frame samples for LioTopology.handle_imu; vel is
    the body-frame (forward, left, up) velocity (oxts fields 8-10), the
    velocity source for positional deskew.
    """
    data, times = _read_oxts(oxts_dir)
    if not len(data):
        return {"times": np.zeros(0), "acc": np.zeros((0, 3), np.float32),
                "gyr": np.zeros((0, 3), np.float32),
                "quat": np.zeros((0, 4), np.float32),
                "vel": np.zeros((0, 3), np.float32)}
    return {
        "times": times,
        "acc": data[:, 14:17].astype(np.float32),
        "gyr": data[:, 20:23].astype(np.float32),
        "quat": _quat_from_euler_np(
            data[:, 3], data[:, 4], data[:, 5]).astype(np.float32),
        "vel": data[:, 8:11].astype(np.float32),
    }


def load_oxts_gps(oxts_dir: str):
    """The GPS fix stream kitti2bag exports on /kitti/oxts/gps/fix
    (ref: kitti2bag.py:313-323): lat/lon/alt per record, converted to the
    same local ENU frame as load_oxts_poses so it can feed
    SlamPipeline.add_gps directly.  Covariance: pos_accuracy^2 (oxts field
    23) on each axis — the NavSatFix message carries no covariance, the
    navsat EKF derives one; pos_accuracy is the honest source here.

    Returns dict(times [N], xyz [N,3], cov [N,3]).
    """
    data, times = _read_oxts(oxts_dir)
    if not len(data):
        return {"times": np.zeros(0), "xyz": np.zeros((0, 3), np.float32),
                "cov": np.zeros((0, 3), np.float32)}
    origin = data[0, :3]
    x, y, z = _latlon_to_enu(data[:, 0], data[:, 1], data[:, 2], origin)
    acc2 = (data[:, 23] ** 2 if data.shape[1] > 23
            else np.full(len(data), 1.0))
    return {
        "times": times,
        "xyz": np.stack([x, y, z], axis=-1).astype(np.float32),
        "cov": np.tile(acc2[:, None], (1, 3)).astype(np.float32),
    }
