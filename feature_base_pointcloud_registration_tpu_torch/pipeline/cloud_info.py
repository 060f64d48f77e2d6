"""Data model — fixed-shape NamedTuples of tensors.

Port of the JAX package's `pipeline/cloud_info.py`.  The reference moves data
between stages as a `cloud_info` message (ref: msg/cloud_info.msg:1-34);
raw input points carry (x, y, z, intensity, ring, time) (`PointXYZIRT`, ref:
src/imageProjection.cpp:8-21).  Ragged data is padded to fixed shapes with
explicit validity masks.  Where the JAX package vmaps over scans, the port's
functions take these tuples with a leading batch dimension [B, ...].
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class RawScan(NamedTuple):
    """One raw lidar scan (or a batch, with a leading [B]), padded to a fixed
    max point count.  Mirrors PointXYZIRT (ref: src/imageProjection.cpp:8-21).
    """

    xyz: torch.Tensor        # f32 [N, 3]
    intensity: torch.Tensor  # f32 [N]
    ring: torch.Tensor       # i32 [N]
    time: torch.Tensor       # f32 [N] per-point time relative to scan start
    valid: torch.Tensor      # bool [N]

    @staticmethod
    def from_numpy(xyz, intensity, ring, time, max_points=None, *, device):
        """Pad one scan's arrays to `max_points` and place them on `device`
        (required: the caller names the device, CPU included)."""
        n = xyz.shape[0]
        cap = max_points or n
        pad = cap - n
        if pad < 0:
            raise ValueError(f"scan has {n} points > cap {cap}")

        def _pad(a, dtype, fill=0):
            a = np.asarray(a, dtype)
            a = np.concatenate(
                [a, np.full((pad,) + a.shape[1:], fill, dtype)])
            return torch.from_numpy(a).to(device)

        return RawScan(
            xyz=_pad(xyz, np.float32),
            intensity=_pad(intensity, np.float32),
            ring=_pad(ring, np.int32),
            time=_pad(time, np.float32),
            valid=torch.from_numpy(np.concatenate(
                [np.ones(n, bool), np.zeros(pad, bool)])).to(device),
        )


class DeskewInfo(NamedTuple):
    """IMU/odom info attached to a batch of scans for motion compensation
    and the pose initial guess (ref: imuDeskewInfo/odomDeskewInfo,
    src/imageProjection.cpp:323-491)."""

    imu_time: torch.Tensor        # f32 [B, Q] s since scan start, +inf pad
    imu_rot: torch.Tensor         # f32 [B, Q, 3] gyro integral since start
    imu_count: torch.Tensor       # i32 [B] last valid index (imuPointerCur)
    imu_available: torch.Tensor   # bool [B]
    imu_rpy_init: torch.Tensor    # f32 [B, 3] attitude at scan start
    odom_available: torch.Tensor  # bool [B]
    initial_guess: torch.Tensor   # f32 [B, 6] pose6 from preintegration
    odom_incre: torch.Tensor      # f32 [B, 3] translation over the sweep
    odom_deskew_flag: torch.Tensor  # bool [B]
    reset_id: torch.Tensor        # i32 [B]

    @staticmethod
    def empty(batch: int, queue_len: int = 512, *, device):
        """No IMU/odom info for `batch` scans, on `device` (required)."""
        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(batch, *shape, dtype=dtype, device=device)

        return DeskewInfo(
            imu_time=torch.full((batch, queue_len), float("inf"),
                                device=device),
            imu_rot=zeros(queue_len, 3),
            imu_count=zeros(dtype=torch.int32),
            imu_available=zeros(dtype=torch.bool),
            imu_rpy_init=zeros(3),
            odom_available=zeros(dtype=torch.bool),
            initial_guess=zeros(6),
            odom_incre=zeros(3),
            odom_deskew_flag=zeros(dtype=torch.bool),
            reset_id=zeros(dtype=torch.int32),
        )


class CloudInfo(NamedTuple):
    """The inter-stage contract (ref: msg/cloud_info.msg:1-34), batched.

    Compacted range-image clouds plus ring bookkeeping, padded to
    n_scan*horizon_scan points with `point_valid` masks, in the row-major
    order of cloudExtraction (ref: src/imageProjection.cpp:642-670).
    """

    start_ring_index: torch.Tensor  # i32 [B, n_scan]
    end_ring_index: torch.Tensor    # i32 [B, n_scan]
    point_col_ind: torch.Tensor     # i32 [B, P]
    point_range: torch.Tensor       # f32 [B, P]
    point_valid: torch.Tensor       # bool [B, P]
    num_points: torch.Tensor        # i32 [B]
    points: torch.Tensor            # f32 [B, P, 3]
    intensity: torch.Tensor         # f32 [B, P]
    imu_available: torch.Tensor     # bool [B]
    odom_available: torch.Tensor    # bool [B]
    imu_rpy_init: torch.Tensor      # f32 [B, 3]
    initial_guess: torch.Tensor     # f32 [B, 6] pose6
    reset_id: torch.Tensor          # i32 [B]


class ScanFeatures(NamedTuple):
    """LOAM feature sets of a batch of scans (ref:
    src/featureExtraction.h:306-315)."""

    corner_xyz: torch.Tensor   # f32 [B, corner_cap, 3]
    corner_mask: torch.Tensor  # bool [B, corner_cap]
    surf_xyz: torch.Tensor     # f32 [B, surf_cap, 3]
    surf_mask: torch.Tensor    # bool [B, surf_cap]


class FeatureMap(NamedTuple):
    """A feature map: corner + surf point sets with masks.  Replaces
    laserCloud{Corner,Surf}FromMapDS (ref: src/mapOptmization.h:107-108)."""

    corner_xyz: torch.Tensor   # f32 [Mc, 3]
    corner_mask: torch.Tensor  # bool [Mc]
    surf_xyz: torch.Tensor     # f32 [Ms, 3]
    surf_mask: torch.Tensor    # bool [Ms]
