"""Scan buffering, field validation, and odometry-based deskew info.

Host-side rebuild of cachePointCloud + odomDeskewInfo
(ref: src/imageProjection.cpp:229-301, :395-491):

  * ScanBuffer queues incoming scans, requires >= 3 queued before emitting
    the oldest (the reference needs the *next* scan's stamp for the scan-end
    time), and runs the field checks: dense-cloud fatal, missing `ring`
    fatal, missing per-point `time` -> deskew disabled with a warning.
  * OdomQueue finds the odometry samples bracketing a scan and produces the
    initial-guess pose + scan-duration translation increment for positional
    deskew, including the reset-id consistency check.

Port of the JAX package's `pipeline/scan_buffer.py`, on the port's `RawScan`
and `geom.se3` (float32 on the CPU, as the JAX version computes on the
host).
"""

from __future__ import annotations

import dataclasses
import warnings
from collections import deque
from typing import Optional

import numpy as np
import torch

from ..geom.se3 import (euler_from_quat, inverse_matrix, matrix_to_pose6,
                        pose6_to_matrix)
from .cloud_info import RawScan


class ScanFieldError(RuntimeError):
    """Fatal input-format error (the reference calls ros::shutdown)."""


@dataclasses.dataclass
class BufferedScan:
    scan: RawScan
    time_scan_cur: float
    time_scan_next: float
    deskew_enabled: bool


class ScanBuffer:
    """cachePointCloud equivalent (ref: src/imageProjection.cpp:229-301)."""

    def __init__(self, min_queue: int = 3):
        self.queue: deque = deque()
        self.min_queue = min_queue
        self._ring_checked = False
        self._deskew_flag = 0  # 0 unknown, 1 enabled, -1 disabled

    def push(self, scan: RawScan, stamp: float, has_ring: bool = True,
             has_time: bool = True, is_dense: bool = True
             ) -> Optional[BufferedScan]:
        """Queue a scan; returns the oldest scan once >= min_queue are held."""
        if not is_dense:
            raise ScanFieldError(
                "Point cloud is not in dense format, remove NaN points first"
            )  # ref :256-259
        if not self._ring_checked:
            self._ring_checked = True
            if not has_ring:
                raise ScanFieldError(
                    "Point cloud ring channel not available"
                )  # ref :276-280
        if self._deskew_flag == 0:
            self._deskew_flag = 1 if has_time else -1
            if self._deskew_flag == -1:
                warnings.warn(
                    "Point cloud timestamp not available, deskew disabled; "
                    "system will drift significantly"  # ref :296-297
                )

        self.queue.append((scan, stamp))
        if len(self.queue) <= self.min_queue - 1:
            return None
        scan0, t0 = self.queue.popleft()
        t1 = self.queue[0][1]
        return BufferedScan(scan=scan0, time_scan_cur=t0, time_scan_next=t1,
                            deskew_enabled=self._deskew_flag == 1)


class OdomQueue:
    """odomDeskewInfo equivalent (ref: src/imageProjection.cpp:395-491)."""

    def __init__(self):
        self.queue: deque = deque()  # (time, pose6, reset_id)

    def push(self, time: float, pose6, reset_id: int = 0):
        self.queue.append((float(time),
                           np.asarray(pose6, np.float32), int(reset_id)))

    @staticmethod
    def from_quat(time, xyz, quat, reset_id=0):
        r, p, y = (float(v) for v in euler_from_quat(
            torch.as_tensor(np.asarray(quat, np.float32))))
        return (time, np.array([r, p, y, *xyz], np.float32), reset_id)

    def deskew_info(self, time_scan_cur: float, time_scan_next: float):
        """Returns (odom_available, initial_guess pose6, reset_id,
        odom_incre xyz, odom_deskew_flag)."""
        while self.queue and self.queue[0][0] < time_scan_cur - 0.01:
            self.queue.popleft()  # ref :399-405
        na = (False, np.zeros(6, np.float32), 0, np.zeros(3, np.float32), False)
        if not self.queue or self.queue[0][0] > time_scan_cur:
            return na

        # start odometry: first sample at/after scan start (ref :415-428)
        start = None
        for (t, pose, rid) in self.queue:
            start = (t, pose, rid)
            if t >= time_scan_cur:
                break
        guess = start[1].copy()
        reset_id = start[2]

        # end odometry: first sample at/after scan end (ref :449-468)
        if self.queue[-1][0] < time_scan_next:
            return (True, guess, reset_id, np.zeros(3, np.float32), False)
        end = None
        for (t, pose, rid) in self.queue:
            end = (t, pose, rid)
            if t >= time_scan_next:
                break
        if end[2] != start[2]:  # covariance/reset-id mismatch (ref :471)
            return (True, guess, reset_id, np.zeros(3, np.float32), False)

        Tb = pose6_to_matrix(torch.from_numpy(start[1]))
        Te = pose6_to_matrix(torch.from_numpy(end[1]))
        rel = matrix_to_pose6(inverse_matrix(Tb) @ Te).numpy()
        return (True, guess, reset_id, rel[3:6].astype(np.float32), True)
