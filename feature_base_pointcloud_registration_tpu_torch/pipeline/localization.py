"""Localization pipeline: scan-to-map against a prebuilt global feature map.

Port of the JAX package's `pipeline/localization.py`, the reference's
*active* path (ref: src/mapOptmization.h:263-343 `registration`, driven from
cloudHandler at src/imageProjection.cpp:203-225):

  1. load a prebuilt global corner/surf map (PCD) and voxel-downsample it
     (ref :245-260; `downsample=False` keeps a map its producer voxelized),
  2. per scan (rate-gated by mappingProcessInterval, ref :279): crop a
     +-(30, 30, 10) m local map around the pose guess (ref :283-304),
  3. run the scan-to-map solve (`ops.register.grid_register_step`: grid
     tables around the guess, the fetch kernels, the rounds solver) and the
     IMU attitude fusion (`transform_update`),
  4. chain the pose as the next initial guess (the static pose/step chain at
     src/imageProjection.cpp:206-218).

The map lives on the device it was loaded to; the pose chain and the rate
gate are host state like the reference's statics.  The crop's caps and the
grid tables' cell caps, which the reference does not have, are reported:
a step that drops points emits a `localization/dropped_points` warn event,
its counts carried in the one copy of the pose to the host.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from ..config import Params
from ..ops.cropbox import crop_box
from ..ops.register import (RegisterResult, grid_overflow,
                            grid_register_step, transform_update)
from ..ops.voxel import voxel_downsample
from ..utils.log import get_logger
from .cloud_info import DeskewInfo, FeatureMap, RawScan
from .frontend import process_scan


class GlobalMap:
    """The padded global corner/surf map on one device (corner_GlobalMap /
    surf_GlobalMap, ref: src/mapOptmization.h:110-111, loaded and
    downsampled at :245-260)."""

    def __init__(self, corner_xyz, corner_mask, surf_xyz, surf_mask):
        self.corner_xyz = corner_xyz
        self.corner_mask = corner_mask
        self.surf_xyz = surf_xyz
        self.surf_mask = surf_mask

    @classmethod
    def from_arrays(cls, params: Params, corner, surf,
                    corner_cap: int = 1 << 19, surf_cap: int = 1 << 20,
                    downsample: bool = True, *, device):
        """Numpy [N, 3] corner and surf points, padded to the caps, placed
        on `device` (required) and, unless `downsample` is False (a map
        whose producer already voxelized it), voxel-downsampled with the
        mapping leaf sizes."""
        def pad(a, cap):
            a = np.asarray(a, np.float32)
            if a.shape[0] > cap:
                raise ValueError(f"{a.shape[0]} map points > cap {cap}")
            out = np.zeros((cap, 3), np.float32)
            out[:a.shape[0]] = a
            m = np.arange(cap) < a.shape[0]
            return (torch.from_numpy(out).to(device),
                    torch.from_numpy(m).to(device))

        (cx, cm), (sx, sm) = pad(corner, corner_cap), pad(surf, surf_cap)
        if downsample:
            cx, cm, _ = voxel_downsample(
                cx, cm, params.mapping_corner_leaf_size, corner_cap)
            sx, sm, _ = voxel_downsample(
                sx, sm, params.mapping_surf_leaf_size, surf_cap)
        return cls(cx, cm, sx, sm)

    @classmethod
    def from_pcd_dir(cls, params: Params, directory: str, *, device, **kw):
        """Load cloudCorner.pcd / cloudSurf.pcd like the reference (ref:
        src/mapOptmization.h:245-260); `kw` goes to `from_arrays` (caps,
        `downsample`)."""
        from ..io.pcd import read_pcd

        pts = []
        for name in ("cloudCorner.pcd", "cloudSurf.pcd"):
            c = read_pcd(os.path.join(directory, name))
            pts.append(np.stack([c["x"], c["y"], c["z"]], -1))
        return cls.from_arrays(params, *pts, device=device, **kw)


def _crop_local_map(gm_corner, gm_corner_mask, gm_surf, gm_surf_mask,
                    center, *, half_extent, map_corner_cap, map_surf_cap):
    """CropBox local map around the pose guess (ref :283-304), and the
    corner and surf points inside the box before the caps (int32 [2])."""
    he = torch.tensor(half_extent, dtype=torch.float32, device=center.device)
    cx, cm, nc = crop_box(gm_corner, gm_corner_mask, center, he,
                          map_corner_cap)
    sx, sm, ns = crop_box(gm_surf, gm_surf_mask, center, he, map_surf_cap)
    return FeatureMap(cx, cm, sx, sm), torch.stack([nc, ns])


class LocalizationPipeline:
    """Stateful runner of sequential localization: the host state is the
    reference's statics (the pose chain and the rate gate)."""

    def __init__(self, params: Params, global_map: GlobalMap):
        self.params = params
        self.global_map = global_map
        self._log = get_logger()
        self.pose = np.zeros(6, np.float32)       # chained guess (ref ip:206)
        self.time_last_processing = -1.0          # ref :135,279
        self.last_result: Optional[RegisterResult] = None

    def step(self, scan: RawScan, timestamp: float,
             deskew_info: Optional[DeskewInfo] = None,
             initial_guess: Optional[np.ndarray] = None):
        """Process one scan (a `RawScan.from_numpy` on the map's device;
        `deskew_info` batch-1, e.g. from `make_deskew_info`); returns the
        current pose6 (numpy).

        Scans arriving faster than mappingProcessInterval keep the previous
        pose, like the reference's gate (ref :279)."""
        p = self.params
        if timestamp - self.time_last_processing < p.mapping_process_interval:
            return self.pose
        self.time_last_processing = timestamp
        gm = self.global_map
        dev = gm.corner_xyz.device
        _, feats = process_scan(p, RawScan(*(a[None] for a in scan)),
                                deskew_info)
        guess = np.asarray(initial_guess if initial_guess is not None
                           else self.pose, np.float32)
        guess = torch.from_numpy(guess.reshape(1, 6)).to(dev)
        if deskew_info is None:
            deskew_info = DeskewInfo.empty(1, p.imu_queue_len, device=dev)

        local_map, inside = _crop_local_map(
            gm.corner_xyz, gm.corner_mask, gm.surf_xyz, gm.surf_mask,
            guess[0, 3:6], half_extent=tuple(p.local_map_half_extent),
            map_corner_cap=p.map_corner_cap, map_surf_cap=p.map_surf_cap)
        he = tuple(p.register_grid_half_extent)
        res = grid_register_step(
            local_map, feats, guess, half_extent=he,
            max_iterations=p.max_gn_iterations,
            min_correspondences=p.min_correspondences,
            edge_min_valid=p.edge_feature_min_valid_num,
            surf_min_valid=p.surf_feature_min_valid_num,
            min_plane_spread=p.surf_min_planar_spread)
        fused = transform_update(
            res.pose6, deskew_info.imu_rpy_init, deskew_info.imu_available,
            imu_weight=p.imu_attitude_weight,
            rotation_tolerance=p.rotation_tolerance,
            z_tolerance=p.z_tolerance)
        res = res._replace(
            pose6=torch.where(res.valid[:, None], fused, res.pose6))
        self.last_result = res
        # one copy to the host: the pose, the result's fields, the points
        # in the crop box and the grid tables' dropped shares
        host = torch.cat([
            res.pose6[0], torch.stack([
                res.n_corr[0], res.iterations[0], res.converged[0],
                res.is_degenerate[0], res.valid[0]]).to(torch.float32),
            inside.to(torch.float32),
            grid_overflow(local_map, guess[0, 3:6], half_extent=he)
        ]).cpu().numpy()
        self.pose = host[:6].copy()
        n_corr, iters, conv, degen, valid = host[6:11]
        # the reference's CropBox and KD-tree have no cap: say what the
        # port's fixed capacities drop
        for kind, total, cap in (("corner", host[11], p.map_corner_cap),
                                 ("surf", host[12], p.map_surf_cap)):
            if total > cap:
                self._log.warn("localization/dropped_points", time=timestamp,
                               cap="crop", feature=kind,
                               dropped=int(total) - cap, kept=cap)
        for kind, share in (("corner", host[13]), ("surf", host[14])):
            if share > 0:
                self._log.warn("localization/dropped_points", time=timestamp,
                               cap="grid_cell", feature=kind,
                               dropped_share=float(share))
        # publishOdometry analog (ref :339-341, :1791-1848)
        self._log.event(
            "localization/odometry", level="info" if valid else "warn",
            time=timestamp, pose=self.pose, n_corr=int(n_corr),
            iterations=int(iters), converged=bool(conv),
            degenerate=bool(degen), gate_valid=bool(valid))
        return self.pose
