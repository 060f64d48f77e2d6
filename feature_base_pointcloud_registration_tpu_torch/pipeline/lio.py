"""Integrated LIO topology — the test.launch process pair, fully wired.

Port of the JAX package's `pipeline/lio.py`.  The reference's running
system routes every sensor message through its sensor-facing components
before any math sees it:

  * every IMU sample through imuConverter (extrinsic rotation into the lidar
    frame; ref: src/imageProjection.cpp:152, include/utility.h:219-253) in
    BOTH the projection node and the preintegration node
    (src/imuPreintegration.cpp:417);
  * every point cloud through cachePointCloud (>=3 queued, field checks;
    ref: src/imageProjection.cpp:186,229-301);
  * the IMU-rate odometry stream through odomDeskewInfo to produce the
    scan-bracketing initial guess + positional-deskew increment
    (ref: src/imageProjection.cpp:395-491).

LioTopology is that wiring as one host object: ScanBuffer + OdomQueue +
ImuOdometry + SlamPipeline on `device`, with the reset-id protocol closed
end-to-end.  A caller with a real sensor (ext_rot != I, as in the
reference's own config/params.yaml:37-42) feeds RAW IMU-frame samples to
`handle_imu` and raw clouds to `handle_cloud`; everything else is internal.

The scan's end is the reference's timeScanEnd: its stamp plus its last
point's time (cachePointCloud, ref :229-301), read on the host before the
scan moves to the device.  The JAX package passes the next scan's stamp
instead (ROADMAP Queue 3).  The IMU samples are host data and are
converted on the host, where the deskew table is built from them.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Optional

import numpy as np
import torch

from ..config import Params
from ..geom.se3 import euler_from_quat
from ..imu.conversion import imu_converter
from .cloud_info import RawScan
from .frontend import make_deskew_info
from .imu_odometry import ImuOdometry
from .scan_buffer import OdomQueue, ScanBuffer
from .slam import SlamPipeline


def last_point_time(scan: RawScan) -> float:
    """The time of a scan's last valid point (the reference's
    points.back().time), 0 for a scan with none; read on the host."""
    t = scan.time.cpu().numpy()[scan.valid.cpu().numpy()]
    return float(t[-1]) if len(t) else 0.0


@dataclasses.dataclass
class LioTopology:
    """The imageProjection + imuPreintegration process pair as one driver,
    its pipelines on `device` (required)."""

    params: Params
    max_keyframes: int = 256
    imu_window: int = 16
    imu_max_samples: int = 128
    history_seconds: float = 5.0   # converted-sample retention for deskew
    device: torch.device = dataclasses.field(kw_only=True)

    def __post_init__(self):
        self.slam = SlamPipeline(self.params, max_keyframes=self.max_keyframes,
                                 device=self.device)
        self.odo = ImuOdometry(self.params, window=self.imu_window,
                               max_samples=self.imu_max_samples,
                               device=self.device)
        self.scan_buffer = ScanBuffer()
        self.odom_queue = OdomQueue()
        # the sweep length (last point time) of each scan the buffer holds
        self._sweeps: deque = deque()
        # converted (lidar-frame) IMU history for the deskew table
        self._imu_t: deque = deque()
        self._imu_gyr: deque = deque()
        self._imu_rpy: deque = deque()   # attitude from the converted quaternion

    # ------------------------------------------------------------------ imu
    def handle_imu(self, t, acc, gyr, quat=None):
        """Ingest RAW IMU-frame sample(s); scalars or [n]-batches.

        Applies imuConverter (ext_rot / ext_rpy) before anything downstream —
        the reference does this in both nodes' imuHandlers.  `quat` is the
        9-axis orientation (x,y,z,w); None means 6-axis input (attitude
        unavailable for initialization, like a VLP+6-axis rig).
        """
        t = np.atleast_1d(np.asarray(t, np.float64))
        n = len(t)
        acc = np.asarray(acc, np.float32).reshape(n, 3)
        gyr = np.asarray(gyr, np.float32).reshape(n, 3)
        has_quat = quat is not None
        if has_quat:
            quat = np.asarray(quat, np.float32).reshape(n, 4)
        else:
            quat = np.tile(np.array([0, 0, 0, 1], np.float32), (n, 1))

        acc_l, gyr_l, quat_l, valid = imu_converter(
            self.params, torch.from_numpy(acc), torch.from_numpy(gyr),
            torch.from_numpy(quat))
        if has_quat and not bool(valid.all()):
            # ref: utility.h:246-250 — ros::shutdown on invalid quaternion
            raise RuntimeError(
                "Invalid quaternion, please use a 9-axis IMU!")
        acc_l = acc_l.numpy()
        gyr_l = gyr_l.numpy()
        rpy_l = torch.stack(euler_from_quat(quat_l), -1).numpy()

        for i in range(n):
            self.odo.handle_imu(float(t[i]), acc_l[i], gyr_l[i])
            self._imu_t.append(float(t[i]))
            self._imu_gyr.append(gyr_l[i])
            self._imu_rpy.append(rpy_l[i] if has_quat
                                 else np.zeros(3, np.float32))
        # trim history
        cutoff = float(t[-1]) - self.history_seconds
        while self._imu_t and self._imu_t[0] < cutoff:
            self._imu_t.popleft()
            self._imu_gyr.popleft()
            self._imu_rpy.popleft()

    def _flush_odometry(self):
        """Drain IMU-rate odometry into the OdomQueue (the odomTopic edge,
        ref: src/imuPreintegration.cpp:457-476 publish -> imageProjection
        odometryHandler :176-179)."""
        ts = [s[0] for s in self.odo._pending]
        out = self.odo.flush_imu_odometry()
        if out is None:
            return
        pose6, _ = out
        for t, p6 in zip(ts, pose6):
            self.odom_queue.push(t, p6, reset_id=self.odo.reset_id)

    # ---------------------------------------------------------------- cloud
    def handle_cloud(self, stamp: float, scan: RawScan, *,
                     has_ring: bool = True, has_time: bool = True,
                     is_dense: bool = True) -> Optional[np.ndarray]:
        """Ingest one raw cloud (a RawScan, best given on the host: it is
        moved to the device here); returns the mapped pose once the buffer
        emits a scan (cloudHandler, ref: src/imageProjection.cpp:182-226)."""
        sweep = last_point_time(scan)
        scan = RawScan(*(a.to(self.device) for a in scan))
        buf = self.scan_buffer.push(scan, stamp, has_ring=has_ring,
                                    has_time=has_time, is_dense=is_dense)
        self._sweeps.append(sweep)
        if buf is None:
            return None
        sweep = self._sweeps.popleft()
        self._flush_odometry()

        t_cur = buf.time_scan_cur
        t_end = t_cur + sweep                      # timeScanEnd
        (odom_avail, guess, rid, odom_incre,
         odom_flag) = self.odom_queue.deskew_info(t_cur, t_end)

        # attitude at scan start: last converted 9-axis sample <= t_cur+0.01
        # (imuDeskewInfo, ref :338-345)
        imu_rpy = None
        for i in range(len(self._imu_t) - 1, -1, -1):
            if self._imu_t[i] <= t_cur + 0.01:
                imu_rpy = self._imu_rpy[i]
                break

        if buf.deskew_enabled:
            times = np.asarray(self._imu_t)
            gyros = (np.stack(self._imu_gyr) if self._imu_gyr
                     else np.zeros((0, 3), np.float32))
        else:
            # missing per-point time field: deskew disabled (warned at push)
            times = np.zeros(0)
            gyros = np.zeros((0, 3), np.float32)

        dsk = make_deskew_info(
            self.params, times, gyros, scan_start=t_cur, scan_end=t_end,
            imu_rpy=imu_rpy,
            initial_guess=guess if odom_avail else None,
            odom_incre=odom_incre, odom_deskew_flag=odom_flag,
            reset_id=rid, device=self.device)

        est = self.slam.step(buf.scan, timestamp=t_cur, deskew_info=dsk)
        # the mapping -> preintegration correction edge with the reset id
        # (ref: src/mapOptmization.h:1802 covariance[0] smuggle)
        self.odo.handle_odometry(t_cur, est, reset_id=self.slam.reset_id)
        return est
