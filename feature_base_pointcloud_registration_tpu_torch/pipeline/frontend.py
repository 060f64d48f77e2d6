"""Front end: raw scans -> deskewed CloudInfo -> downsampled features, batched.

Port of the JAX package's `pipeline/frontend.py` (ImageProjection ->
FeatureExtraction, ref: src/imageProjection.cpp:182-226 cloudHandler).  The
returned features are voxel-downsampled with the mapping leaf sizes
(downsampleCurrentScan, ref: src/mapOptmization.h:981-993) unless the caller
asks for them as picked.
`make_deskew_info` builds a scan's IMU table on the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..config import Params
from ..ops.features import extract_features
from ..ops.projection import project_scan
from ..ops.voxel import voxel_downsample
from .cloud_info import CloudInfo, DeskewInfo, RawScan, ScanFeatures


def process_scan(params: Params, scan: RawScan,
                 deskew_info: DeskewInfo | None = None,
                 enable_deskew: bool = True,
                 downsample: bool = True
                 ) -> Tuple[CloudInfo, ScanFeatures]:
    """Project (deskewed when `deskew_info` is given), extract features
    (strict or fast by `params.strict_feature_pick`) and, unless
    `downsample` is False, downsample a batch of scans."""
    cloud = project_scan(params, scan, deskew_info,
                         enable_deskew=enable_deskew)
    feats = extract_features(params, cloud,
                             strict=params.strict_feature_pick)
    if downsample:
        feats = downsample_features(params, feats)
    return cloud, feats


def downsample_features(params: Params, feats: ScanFeatures) -> ScanFeatures:
    """downsampleCurrentScan (ref: src/mapOptmization.h:981-993): corner leaf
    mappingCornerLeafSize, surf leaf mappingSurfLeafSize."""
    cx, cm, _ = voxel_downsample(feats.corner_xyz, feats.corner_mask,
                                 params.mapping_corner_leaf_size,
                                 feats.corner_xyz.shape[-2])
    sx, sm, _ = voxel_downsample(feats.surf_xyz, feats.surf_mask,
                                 params.mapping_surf_leaf_size,
                                 feats.surf_xyz.shape[-2])
    return ScanFeatures(cx, cm, sx, sm)


def make_deskew_info(params: Params, imu_time, imu_gyro, scan_start: float,
                     scan_end: float, imu_rpy=None, initial_guess=None,
                     reset_id: int = 0, odom_incre=None,
                     odom_deskew_flag: bool = False, *,
                     device) -> DeskewInfo:
    """One scan's deskew table from raw IMU samples, built on the host and
    returned as a batch-1 `DeskewInfo` on `device` (required).

    imuDeskewInfo (ref: src/imageProjection.cpp:323-393): keep the samples
    in [scan_start - 0.01, scan_end + 0.01] and forward-Euler integrate the
    gyro into a rotation table relative to scan start; times in the table
    are relative to scan_start.  `initial_guess` / `odom_incre` /
    `odom_deskew_flag` carry odomDeskewInfo's outputs (ref :395-491), e.g.
    from `scan_buffer.OdomQueue.deskew_info`."""
    q = params.imu_queue_len
    imu_time = np.asarray(imu_time, np.float64)
    imu_gyro = np.asarray(imu_gyro, np.float64)
    keep = imu_time >= scan_start - 0.01
    imu_time, imu_gyro = imu_time[keep], imu_gyro[keep]

    table_t = np.full(q, np.inf, np.float32)
    table_r = np.zeros((q, 3), np.float32)
    ptr = 0
    rot = np.zeros(3, np.float64)
    prev_t = None
    for t, gyro in zip(imu_time, imu_gyro):
        if t > scan_end + 0.01:
            break
        if ptr == 0:
            table_t[0] = t - scan_start
            prev_t = t
            ptr = 1
            continue
        rot = rot + gyro * (t - prev_t)
        if ptr < q:
            table_t[ptr] = t - scan_start
            table_r[ptr] = rot
            ptr += 1
        prev_t = t

    def one(a, dtype):
        return torch.as_tensor(np.asarray(a, dtype)[None], device=device)

    def vec(a, n):
        return one(a if a is not None else np.zeros(n), np.float32)

    return DeskewInfo(
        imu_time=one(table_t, np.float32),
        imu_rot=one(table_r, np.float32),
        imu_count=one(max(ptr - 1, 0), np.int32),
        # imuPointerCur-- then the <= 0 check (ref :385-389)
        imu_available=one(ptr > 1, bool),
        imu_rpy_init=vec(imu_rpy, 3),
        odom_available=one(initial_guess is not None, bool),
        initial_guess=vec(initial_guess, 6),
        odom_incre=vec(odom_incre, 3),
        odom_deskew_flag=one(bool(odom_deskew_flag), bool),
        reset_id=one(reset_id, np.int32),
    )
