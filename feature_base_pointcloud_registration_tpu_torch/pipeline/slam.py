"""Full SLAM back end: keyframes + factor graph + loop closure.

Port of the JAX package's `pipeline/slam.py`, the rebuild of the
reference's mapping mode — mapOptimization's laserCloudInfoHandler (ref:
src/mapOptmization.h:346-389) with its whole sub-tree:

  updateInitialGuess            (ref :799-855)   -> _initial_guess
  extractSurroundingKeyFrames   (ref :857-978)   -> _build_local_map (device)
  downsampleCurrentScan         (ref :981-993)   -> frontend.downsample_features
  scan2MapOptimization          (ref :1403-1489) -> ops.register
                                                    .grid_register_step
  saveFrame / addOdomFactor / addGPSFactor / iSAM2 update
                                (ref :1491-1733) -> graph.pose_graph LM window
  correctPoses (+ reset-id bump)(ref :1735-1770) -> _optimize_graph
  loop closure thread           (ref :582-782)   -> maybe_close_loop (ICP)
  PCD map save / reload         (ref :485-521, :245-260) -> save_map

Host state (keyframe clouds, factor lists) mirrors the reference's members
as NumPy arrays, the source of truth for graph logic, loop closure and
save_map; the geometry (local map, registration, ICP, LM) runs on the
pipeline's device, where a mirror of the keyframe clouds is updated one
slot at a time.

Caps the reference does not have are reported, not silent: a keyframe
whose features exceed kf_corner_cap / kf_surf_cap, a local map whose
voxels exceed map_corner_cap / map_surf_cap and a grid table cell over its
cap each emit a `mapping/dropped_points` warn event.  The counts ride in
the one copy of the pose to the host that a step makes anyway.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np
import torch

from ..config import Params
from ..geom.se3 import inverse_matrix, matrix_to_pose6, pose6_to_matrix
from ..graph.pose_graph import (PoseGraphData, optimize_pose_graph,
                                pose_marginal_covariances)
from ..ops.icp import icp_align
from ..ops.register import grid_overflow, grid_register_step, transform_update
from ..ops.voxel import voxel_filter
from ..utils.log import get_logger
from .cloud_info import DeskewInfo, FeatureMap, RawScan, ScanFeatures
from .frontend import process_scan


def _mat(pose6) -> np.ndarray:
    """pose6 -> 4x4 float32 (numpy), through the port's se3."""
    return pose6_to_matrix(torch.as_tensor(
        np.asarray(pose6, np.float32))).numpy()


def _rel(a, b) -> np.ndarray:
    """pose6 of T(a)^-1 T(b) (float32)."""
    Ta = pose6_to_matrix(torch.as_tensor(np.asarray(a, np.float32)))
    Tb = pose6_to_matrix(torch.as_tensor(np.asarray(b, np.float32)))
    return matrix_to_pose6(inverse_matrix(Ta) @ Tb).numpy()


def _build_local_map(kf_corner, kf_corner_mask, kf_surf, kf_surf_mask,
                     kf_poses, corner_leaf, surf_leaf, *, map_corner_cap,
                     map_surf_cap):
    """Transform the selected keyframe clouds [S, P, 3] at their poses
    [S, 6] to the world frame, merge, voxel-downsample to the caps.

    extractCloud equivalent (ref: src/mapOptmization.h:909-955); the OpenMP
    loop becomes one batched transform.  Returns (FeatureMap, voxel counts
    before the caps int64 [2])."""
    T = pose6_to_matrix(kf_poses)                          # [S, 4, 4]

    def to_world(cl):
        return (torch.einsum("kij,kpj->kpi", T[:, :3, :3], cl)
                + T[:, None, :3, 3])

    cx, cm, nc = voxel_filter(to_world(kf_corner).reshape(-1, 3),
                              kf_corner_mask.reshape(-1), corner_leaf,
                              map_corner_cap)
    sx, sm, ns = voxel_filter(to_world(kf_surf).reshape(-1, 3),
                              kf_surf_mask.reshape(-1), surf_leaf,
                              map_surf_cap)
    return FeatureMap(cx, cm, sx, sm), torch.stack([nc, ns])


@dataclasses.dataclass
class SlamPipeline:
    """Sequential SLAM runner (odometry + mapping + optional loop closure)
    on `device` (required): scans, the keyframe mirror, the local map, the
    registration, ICP and the LM solves live there."""

    params: Params
    max_keyframes: int = 512
    kf_corner_cap: int = 1024
    kf_surf_cap: int = 4096
    loop_submap_cap: int = 16384
    opt_window: int = 32          # trailing-window size for incremental LM
    window_gps_cap: int = 16      # in-window GPS factor slots
    loop_factor_cap: int = 64     # full-graph loop-factor slots (fixed shape)
    gps_factor_cap: int = 256     # full-graph GPS-factor slots (fixed shape)
    device: torch.device = dataclasses.field(kw_only=True)

    def __post_init__(self):
        self._log = get_logger()
        K = self.max_keyframes
        self.kf_corner = np.zeros((K, self.kf_corner_cap, 3), np.float32)
        self.kf_corner_mask = np.zeros((K, self.kf_corner_cap), bool)
        self.kf_surf = np.zeros((K, self.kf_surf_cap, 3), np.float32)
        self.kf_surf_mask = np.zeros((K, self.kf_surf_cap), bool)
        self.kf_poses = np.zeros((K, 6), np.float32)   # cloudKeyPoses6D
        self.kf_times = np.zeros(K, np.float64)
        self.n_keyframes = 0

        # factor storage (host; converted to PoseGraphData on optimize).
        # Odometry betweens form a chain — entry j connects keyframe j-1 -> j;
        # loop/GPS factors are sparse lists.
        self.odom_meas = np.zeros((K, 6), np.float32)
        self.odom_sigma = np.ones((K, 6), np.float32)
        self.loop_factors: List[tuple] = []  # (i, j, meas6, sigma6)
        self.gps_factors: List[tuple] = []   # (i, xyz, sigma3)
        self.prior_factor = None
        self.gps_queue: List[tuple] = []     # (time, xyz, cov3)
        self.last_gps_point = np.zeros(3)

        # marginal state for the incremental window (iSAM2 equivalents):
        # poseCovariance (ref :1706) and the carried prior on the pose about
        # to leave the window (the reference's own key==100 reset trick,
        # ref: src/imuPreintegration.cpp:234-267, applied to the pose graph)
        self.pose_cov = np.zeros((6, 6))
        self.carried_prior_sigma = None      # sigma6 for window pose 0

        # device mirror of the keyframe clouds: None = stale (uploaded whole
        # at next use), else updated in place one slot per new keyframe
        self._dev_clouds = None

        self.pose = np.zeros(6, np.float32)  # transformTobeMapped
        self.time_last_processing = -1.0
        self.last_imu_transform: Optional[np.ndarray] = None
        self.reset_id = 0                    # imuPreintegrationResetId
        self.a_loop_is_closed = False
        self.trajectory: List[np.ndarray] = []
        self.last_result = None              # RegisterResult of last step
        self.last_icp = None                 # ICPResult of last loop test

    # ------------------------------------------------------------- guesses
    def _initial_guess(self, cloud_imu_rpy, imu_available, odom_available,
                       odom_guess, odom_reset_id):
        """updateInitialGuess (ref: src/mapOptmization.h:799-855)."""
        p = self.params
        if self.n_keyframes == 0:
            rpy = np.asarray(cloud_imu_rpy, np.float32)
            guess = np.zeros(6, np.float32)
            guess[:3] = rpy
            if not p.use_imu_heading_initialization:
                guess[2] = 0.0
            self.last_imu_transform = rpy.copy()
            self.pose = guess
            return guess
        if odom_available and odom_reset_id == self.reset_id:
            self.last_imu_transform = np.asarray(cloud_imu_rpy, np.float32)
            self.pose = np.asarray(odom_guess, np.float32)
            return self.pose
        if imu_available and self.last_imu_transform is not None:
            rpy = np.asarray(cloud_imu_rpy, np.float32)
            # transIncre = lastImu^-1 * thisImu (rotation only)
            zero = np.zeros(3, np.float32)
            T_incre = _mat(_rel(np.concatenate([self.last_imu_transform,
                                                zero]),
                                np.concatenate([rpy, zero])))
            T_new = _mat(self.pose) @ T_incre
            self.pose = matrix_to_pose6(torch.as_tensor(T_new)).numpy()
            self.last_imu_transform = rpy.copy()
        return self.pose

    # ------------------------------------------------------------ local map
    def _thin_poses(self, indices: np.ndarray, leaf: float) -> np.ndarray:
        """Voxel-thin a keypose index set: one representative keyframe per
        `leaf`-sized voxel, the one nearest the voxel centroid — the
        pcl::VoxelGrid pose-cloud downsample of the reference
        (surroundingKeyframeDensity, ref: src/mapOptmization.h:892;
        globalMapVisualizationPoseDensity, ref :553)."""
        if leaf <= 0 or len(indices) == 0:
            return indices
        pos = self.kf_poses[indices, 3:]
        key = np.floor(pos / leaf).astype(np.int64)
        _, inv = np.unique(key, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        cent = np.zeros((inv.max() + 1, 3))
        np.add.at(cent, inv, pos)
        cent /= np.bincount(inv)[:, None]
        d2c = np.linalg.norm(pos - cent[inv], axis=1)
        order = np.lexsort((d2c, inv))
        first = np.ones(len(order), bool)
        first[1:] = inv[order][1:] != inv[order][:-1]
        return np.sort(indices[order[first]])

    def _surrounding_map(self):
        """extractSurroundingKeyFrames (ref :857-978): keyframes within the
        search radius of the last pose (density-thinned, ref :892) + all
        from the most recent 10 s.  Returns (FeatureMap, voxel counts before
        the caps [2]) on the device, or None before the first keyframe."""
        p = self.params
        n = self.n_keyframes
        if n == 0:
            return None
        sel = np.zeros(n, bool)
        last_pos = self.kf_poses[n - 1, 3:]
        d = np.linalg.norm(self.kf_poses[:n, 3:] - last_pos, axis=1)
        near = np.where(d < p.surrounding_keyframe_search_radius)[0]
        sel[self._thin_poses(near, p.surrounding_keyframe_density)] = True
        sel |= self.kf_times[:n] > self.kf_times[n - 1] - 10.0
        # only the selected slots go through the filter: the unselected
        # ones are all masked out, so the map is the same
        idx = torch.from_numpy(np.nonzero(sel)[0]).to(self.device)
        kc, kcm, ks, ksm = (a[idx] for a in self._device_clouds())
        return _build_local_map(
            kc, kcm, ks, ksm,
            torch.from_numpy(self.kf_poses[:n][sel]).to(self.device),
            p.mapping_corner_leaf_size, p.mapping_surf_leaf_size,
            map_corner_cap=p.map_corner_cap, map_surf_cap=p.map_surf_cap)

    def _device_clouds(self):
        """Device-resident keyframe cloud buffers (lazy full upload, then
        one-slot in-place updates)."""
        if self._dev_clouds is None:
            self._dev_clouds = [
                torch.from_numpy(a).to(self.device)
                for a in (self.kf_corner, self.kf_corner_mask, self.kf_surf,
                          self.kf_surf_mask)]
        return self._dev_clouds

    # ------------------------------------------------------------ keyframes
    def _is_keyframe(self) -> bool:
        """saveFrame (ref :1491-1514)."""
        p = self.params
        if self.n_keyframes == 0:
            return True
        T_rel = _rel(self.kf_poses[self.n_keyframes - 1], self.pose)
        angle = p.surrounding_keyframe_adding_angle_threshold
        return not (np.abs(T_rel[0]) < angle and np.abs(T_rel[1]) < angle
                    and np.abs(T_rel[2]) < angle
                    and np.linalg.norm(T_rel[3:])
                    < p.surrounding_keyframe_adding_dist_threshold)

    def add_gps(self, time: float, xyz, cov3):
        """gpsHandler (ref :391-394) — queue a GPS odometry sample."""
        self.gps_queue.append((time, np.asarray(xyz, np.float64),
                               np.asarray(cov3, np.float64)))

    def _add_gps_factor(self, scan_time: float):
        """addGPSFactor gating (ref :1543-1634)."""
        p = self.params
        n = self.n_keyframes
        if not self.gps_queue or n == 0:
            return
        if np.linalg.norm(self.kf_poses[0, 3:] - self.kf_poses[n - 1, 3:]) \
                < 5.0:
            return
        # poseCovThreshold gate (ref :1596-1599): inject GPS only once the
        # pose estimate has drifted uncertain — poseCovariance(3,3)/(4,4) are
        # the x/y variances of the latest keyframe's marginal
        if (self.pose_cov[3, 3] < p.pose_cov_threshold
                and self.pose_cov[4, 4] < p.pose_cov_threshold):
            return
        while self.gps_queue:
            t, xyz, cov = self.gps_queue[0]
            if t < scan_time - 0.2:
                self.gps_queue.pop(0)
            elif t > scan_time + 0.2:
                break
            else:
                self.gps_queue.pop(0)
                noise = cov.copy()
                if noise[0] > p.gps_cov_threshold or \
                        noise[1] > p.gps_cov_threshold:
                    continue
                gps_xyz = xyz.copy()
                if not p.use_gps_elevation:
                    gps_xyz[2] = self.pose[5]
                    noise[2] = 0.01
                if abs(gps_xyz[0]) < 1e-6 and abs(gps_xyz[1]) < 1e-6:
                    continue
                if np.linalg.norm(gps_xyz - self.last_gps_point) < 5.0:
                    continue
                self.last_gps_point = gps_xyz.copy()
                sigma = np.sqrt(np.maximum(noise, 1.0)).astype(np.float32)
                self.gps_factors.append((n, gps_xyz.astype(np.float32), sigma))
                self.a_loop_is_closed = True
                self._log.info("mapping/gps_factor", time=scan_time,
                               keyframe=n, xyz=gps_xyz, sigma=sigma)
                break

    def _evict_oldest(self, count: int):
        """Bounded keyframe storage: marginalize the oldest `count` keyframes
        into the root prior and evict their clouds.

        The reference grows its keyframe storage unboundedly
        (src/mapOptmization.h:1676-1726); a production run needs a policy.
        The evicted segment's information is absorbed into a prior on the
        new root pose whose sigma comes from that pose's full-graph marginal
        — the marginalization the reference applies at its key==100
        preintegration reset (src/imuPreintegration.cpp:234-267).  Loop/GPS
        factors touching evicted poses are dropped (logged)."""
        n = self.n_keyframes
        count = min(count, n - self.opt_window)   # never evict the window
        if count <= 0:
            return
        g = self._graph_data()
        cov = pose_marginal_covariances(g, self.kf_poses, [count],
                                        active=n)[0]
        sigma = np.sqrt(np.maximum(np.diag(cov), 1e-12)).astype(np.float32)
        self.prior_factor = (0, self.kf_poses[count].copy(), sigma)

        m = n - count
        for arr in (self.kf_corner, self.kf_surf, self.kf_poses,
                    self.kf_times, self.odom_meas):
            arr[:m] = arr[count:n]
            arr[m:n] = 0
        for arr in (self.kf_corner_mask, self.kf_surf_mask):
            arr[:m] = arr[count:n]
            arr[m:n] = False
        self.odom_sigma[:m] = self.odom_sigma[count:n]
        self.odom_sigma[m:n] = 1.0
        self.odom_meas[0] = 0.0   # chain entry 0 (root has no predecessor)
        self.odom_sigma[0] = 1.0

        dropped = sum(1 for (i, j, *_) in self.loop_factors
                      if i < count or j < count)
        dropped += sum(1 for (i, *_) in self.gps_factors if i < count)
        if dropped:
            self._log.warn("mapping/evict_dropped_factors", dropped=dropped,
                           evicted=count)
        self.loop_factors = [(i - count, j - count, m_, s_)
                             for (i, j, m_, s_) in self.loop_factors
                             if i >= count and j >= count]
        self.gps_factors = [(i - count, m_, s_)
                            for (i, m_, s_) in self.gps_factors
                            if i >= count]
        self.n_keyframes = m
        self._dev_clouds = None   # mirror stale after the shift; re-upload
        self._log.info("mapping/evict", evicted=count, remaining=m)

    def _save_keyframe(self, feats: ScanFeatures, scan_time: float):
        """saveKeyFramesAndFactor (ref :1637-1733).  feats: one scan's
        features ([P, 3] / [P], or batch-1), on any device."""
        if self.n_keyframes >= self.max_keyframes:
            self._evict_oldest(max(1, self.max_keyframes // 8))
            if self.n_keyframes >= self.max_keyframes:
                raise RuntimeError(
                    "keyframe capacity exceeded and opt_window too large to "
                    "evict; raise max_keyframes or shrink opt_window")
        n = self.n_keyframes
        # odom factor (ref :1517-1541)
        if n == 0:
            prior_sigma = np.sqrt(np.array(
                [1e-2, 1e-2, np.pi ** 2, 1e8, 1e8, 1e8], np.float32))
            self.prior_factor = (0, self.pose.copy(), prior_sigma)
        else:
            rel = _rel(self.kf_poses[n - 1], self.pose)
            sigma = np.sqrt(np.array([1e-6, 1e-6, 1e-6, 1e-4, 1e-4, 1e-4],
                                     np.float32))
            self.odom_meas[n] = rel.astype(np.float32)
            self.odom_sigma[n] = sigma
        self._add_gps_factor(scan_time)

        # keyframe cloud snapshot (lidar frame, downsampled): the first
        # `cap` features; the rest are dropped with a warning
        def take(kind, x, m, cap):
            x = np.asarray(torch.as_tensor(x).cpu()).reshape(-1, 3)
            m = np.asarray(torch.as_tensor(m).cpu()).reshape(-1)
            xx = x[m]
            if len(xx) > cap:
                self._log.warn("mapping/dropped_points", time=scan_time,
                               cap="keyframe", feature=kind,
                               dropped=len(xx) - cap, kept=cap)
            xx = xx[:cap]
            buf = np.zeros((cap, 3), np.float32)
            msk = np.zeros(cap, bool)
            buf[: len(xx)] = xx
            msk[: len(xx)] = True
            return buf, msk

        self.kf_corner[n], self.kf_corner_mask[n] = take(
            "corner", feats.corner_xyz, feats.corner_mask, self.kf_corner_cap)
        self.kf_surf[n], self.kf_surf_mask[n] = take(
            "surf", feats.surf_xyz, feats.surf_mask, self.kf_surf_cap)
        self.kf_poses[n] = self.pose
        self.kf_times[n] = scan_time
        self.n_keyframes = n + 1
        # in-place one-slot update of the device mirror (one keyframe's
        # bytes travel, not the store's)
        slot = torch.tensor([n], device=self.device)
        for dst, src in zip(self._device_clouds(),
                            (self.kf_corner, self.kf_corner_mask,
                             self.kf_surf, self.kf_surf_mask)):
            dst.index_copy_(0, slot, torch.from_numpy(src[n:n + 1]).to(
                self.device))

        # factor-graph update (iSAM2 -> windowed LM)
        self._optimize_graph()

    def _graph(self, K, poses, mask, prior, btw, gps, Fb, Fg):
        """PoseGraphData on the device from host lists: prior (i, meas,
        sigma) or None, btw [(i, j, meas, sigma)], gps [(i, xyz, sigma)]."""
        f32 = np.float32
        arrays = dict(poses=poses.astype(f32), pose_mask=mask,
                      prior_idx=np.zeros(1, np.int32),
                      prior_meas=np.zeros((1, 6), f32),
                      prior_sigma=np.ones((1, 6), f32),
                      prior_mask=np.zeros(1, bool),
                      btw_i=np.zeros(Fb, np.int32),
                      btw_j=np.zeros(Fb, np.int32),
                      btw_meas=np.zeros((Fb, 6), f32),
                      btw_sigma=np.ones((Fb, 6), f32),
                      btw_mask=np.zeros(Fb, bool),
                      gps_idx=np.zeros(Fg, np.int32),
                      gps_meas=np.zeros((Fg, 3), f32),
                      gps_sigma=np.ones((Fg, 3), f32),
                      gps_mask=np.zeros(Fg, bool))
        a = arrays
        if prior is not None:
            i, meas, sigma = prior
            a["prior_idx"][0], a["prior_meas"][0] = i, meas
            a["prior_sigma"][0], a["prior_mask"][0] = sigma, True
        for f, (i, j, m, s) in enumerate(btw):
            a["btw_i"][f], a["btw_j"][f], a["btw_meas"][f] = i, j, m
            a["btw_sigma"][f], a["btw_mask"][f] = s, True
        for f, (i, m, s) in enumerate(gps):
            a["gps_idx"][f], a["gps_meas"][f] = i, m
            a["gps_sigma"][f], a["gps_mask"][f] = s, True
        return PoseGraphData(**{k: torch.from_numpy(v).to(self.device)
                                for k, v in arrays.items()})

    def _graph_data(self) -> PoseGraphData:
        """Full graph (every keyframe + every factor) at fixed capacities:
        K poses, K + loop_factor_cap betweens, gps_factor_cap GPS factors.
        The odometry chain is never dropped (severing it would disconnect
        later poses from the gauge prior); loop factors overflow oldest
        first, with a warning.  len(chain) = n-1 < K always holds."""
        n = self.n_keyframes
        K = self.max_keyframes
        chain = [(j - 1, j, self.odom_meas[j], self.odom_sigma[j])
                 for j in range(1, n)]
        loops = self.loop_factors
        Fb = K + self.loop_factor_cap
        Fg = self.gps_factor_cap
        if len(chain) + len(loops) > Fb:
            keep = Fb - len(chain)
            self._log.warn("mapping/factor_overflow", kind="loop",
                           dropped=len(loops) - keep)
            loops = loops[len(loops) - keep:]
        gps_factors = self.gps_factors
        if len(gps_factors) > Fg:
            self._log.warn("mapping/factor_overflow", kind="gps",
                           dropped=len(gps_factors) - Fg)
            gps_factors = gps_factors[len(gps_factors) - Fg:]
        mask = np.zeros(K, bool)
        mask[:n] = True
        return self._graph(K, self.kf_poses, mask, self.prior_factor,
                           chain + loops, gps_factors, Fb, Fg)

    def _window_graph_data(self) -> tuple:
        """Trailing-window graph at fixed capacities.

        Poses older than the window are marginalized the way the reference's
        key==100 reset marginalizes the preintegration chain (ref:
        src/imuPreintegration.cpp:234-267): the boundary pose enters as a
        prior at its frozen estimate with sigma = sqrt(diag(marginal cov))
        carried from the solve in which it was last active."""
        n = self.n_keyframes
        W = self.opt_window
        lo = max(0, n - W)
        m = n - lo
        poses = np.zeros((W, 6), np.float32)
        poses[:m] = self.kf_poses[lo:n]
        mask = np.zeros(W, bool)
        mask[:m] = True
        if lo == 0 and self.prior_factor is not None:
            prior = self.prior_factor
        else:
            sigma = (self.carried_prior_sigma
                     if self.carried_prior_sigma is not None
                     else np.full(6, 1e-3, np.float32))
            prior = (0, self.kf_poses[lo].copy(), sigma)
        chain = [(j - 1 - lo, j - lo, self.odom_meas[j], self.odom_sigma[j])
                 for j in range(lo + 1, n)]
        in_win = [(i - lo, m_, s_) for (i, m_, s_) in self.gps_factors
                  if i >= lo]
        return self._graph(W, poses, mask, prior, chain,
                           in_win[-self.window_gps_cap:], W,
                           self.window_gps_cap), lo

    def _optimize_graph(self, iterations: int = 8):
        """iSAM2 update equivalent (ref :1658-1669).

        Steady state runs LM over the trailing window only.  Loop/GPS
        closures (a_loop_is_closed) re-solve the FULL graph, which is
        exactly when the reference calls extra isam updates + correctPoses
        (ref :1663-1669, :1735-1770)."""
        def carry_sigma(cov):
            return np.sqrt(np.maximum(np.diag(cov), 1e-12)).astype(np.float32)

        n = self.n_keyframes
        if self.a_loop_is_closed:
            g = self._graph_data()
            poses, _ = optimize_pose_graph(g, iterations=12)
            self.kf_poses[:n] = poses[:n].cpu().numpy()
            g = g._replace(poses=torch.from_numpy(self.kf_poses).to(
                self.device))
            # the NEXT keyframe's window starts at max(0, n+1-W): carry
            # that boundary pose's marginal; both marginals share one
            # host factorization, restricted to the n active poses
            lo_next = max(0, n + 1 - self.opt_window)
            idxs = [n - 1] + ([lo_next] if lo_next > 0 else [])
            covs = pose_marginal_covariances(g, self.kf_poses, idxs,
                                             active=n)
            self.pose_cov = covs[0]
            if lo_next > 0:
                self.carried_prior_sigma = carry_sigma(covs[1])
            # correctPoses (ref :1735-1770): all keyposes rewritten above;
            # bump the reset id so IMU preintegration re-initializes.
            self.reset_id += 1
            self.a_loop_is_closed = False
        else:
            g, lo = self._window_graph_data()
            poses, _ = optimize_pose_graph(g, iterations=iterations)
            poses = poses.cpu().numpy()
            m = n - lo
            self.kf_poses[lo:n] = poses[:m]
            win_poses = np.zeros_like(poses)
            win_poses[:m] = self.kf_poses[lo:n]
            g = g._replace(poses=torch.from_numpy(win_poses).to(self.device))
            # window full: the oldest pose leaves next keyframe — carry its
            # marginal as the next boundary prior (one factorization)
            idxs = [m - 1] + ([1] if m == self.opt_window else [])
            covs = pose_marginal_covariances(g, win_poses, idxs, active=m)
            self.pose_cov = covs[0]
            if m == self.opt_window:
                self.carried_prior_sigma = carry_sigma(covs[1])
        self.pose = self.kf_poses[n - 1].copy()

    # ---------------------------------------------------------- loop closure
    def _world_cloud(self, indices, cap=None, leaf=None):
        """Keyframes' corner + surf points in the world frame (host); with
        `leaf`, voxel-filtered on the host (downSizeFilterICP); with `cap`,
        padded/cut to cap -> (buf [cap, 3], mask [cap])."""
        pts = []
        for k in indices:
            T = _mat(self.kf_poses[k])
            for cl, m in ((self.kf_corner[k], self.kf_corner_mask[k]),
                          (self.kf_surf[k], self.kf_surf_mask[k])):
                pts.append(cl[m] @ T[:3, :3].T + T[:3, 3])
        pts = np.concatenate(pts) if pts else np.zeros((0, 3), np.float32)
        if leaf is not None and len(pts):
            from .. import native

            pts = native.voxel_downsample(pts.astype(np.float32), leaf)
        if cap is None:
            return pts
        buf = np.zeros((cap, 3), np.float32)
        msk = np.zeros(cap, bool)
        m = min(len(pts), cap)
        buf[:m] = pts[:m]
        msk[:m] = True
        return buf, msk

    def maybe_close_loop(self, scan_time: float) -> bool:
        """detectLoopClosure + performLoopClosure (ref :582-782)."""
        p = self.params
        n = self.n_keyframes
        if not p.loop_closure_enable_flag or n < 2:
            return False
        cur = n - 1
        d = np.linalg.norm(self.kf_poses[:n, 3:] - self.kf_poses[cur, 3:],
                           axis=1)
        cand_mask = ((d < p.history_keyframe_search_radius)
                     & (np.abs(self.kf_times[:n] - scan_time)
                        > p.history_keyframe_search_time_diff))
        if not cand_mask.any():
            return False
        # the reference walks the KD radius search in distance order and
        # takes the first time-gated hit — the NEAREST candidate (ref
        # :627-640)
        closest = int(np.where(cand_mask, d, np.inf).argmin())
        if closest == cur:
            return False

        # submap: +-history_keyframe_search_num around the candidate, its
        # downSizeFilterICP pass (ref :699-703, leaf mappingSurfLeafSize)
        lo = max(0, closest - p.history_keyframe_search_num)
        hi = min(n, closest + p.history_keyframe_search_num + 1)
        src, src_m = self._world_cloud([cur], self.loop_submap_cap // 4)
        dst, dst_m = self._world_cloud(range(lo, hi), self.loop_submap_cap,
                                       leaf=p.mapping_surf_leaf_size)
        res = icp_align(*(torch.from_numpy(a).to(self.device)
                          for a in (src, src_m, dst, dst_m)),
                        max_corr_dist=100.0, max_iterations=100)
        self.last_icp = res
        if not bool(res.converged) or float(res.fitness) > \
                p.history_keyframe_fitness_score:
            return False

        # corrected current pose = icp_transform * wrong_pose (ref :739)
        T_corr = res.transform.cpu().numpy() @ _mat(self.kf_poses[cur])
        pose_corr = matrix_to_pose6(torch.as_tensor(T_corr)).numpy()
        rel = _rel(pose_corr, self.kf_poses[closest])
        sigma = np.full(6, np.sqrt(max(float(res.fitness), 1e-6)),
                        np.float32)
        # BetweenFactor(cur, closest) with fitness noise (ref :743-758)
        self.loop_factors.append((cur, closest, rel.astype(np.float32),
                                  sigma))
        self.a_loop_is_closed = True
        self._optimize_graph()
        self._log.info("mapping/loop_closure", time=scan_time, cur=cur,
                       closest=closest, fitness=float(res.fitness),
                       reset_id=self.reset_id)
        return True

    # ----------------------------------------------------------------- step
    def step(self, scan: RawScan, timestamp: float,
             deskew_info: Optional[DeskewInfo] = None):
        """laserCloudInfoHandler (ref :346-389).  scan: one scan
        (`RawScan.from_numpy`) on the pipeline's device; deskew_info:
        batch-1 (e.g. from `make_deskew_info`).  Returns the pose6 (numpy).

        Scans arriving faster than mappingProcessInterval keep the previous
        pose, like the reference's gate (ref :279)."""
        p = self.params
        if timestamp - self.time_last_processing < p.mapping_process_interval:
            return self.pose
        self.time_last_processing = timestamp

        _, feats = process_scan(p, RawScan(*(a[None] for a in scan)),
                                deskew_info)
        if deskew_info is None:
            deskew_info = DeskewInfo.empty(1, p.imu_queue_len,
                                           device=self.device)
            odom_rid = self.reset_id
        else:
            odom_rid = int(deskew_info.reset_id[0])
        imu_rpy = deskew_info.imu_rpy_init[0].cpu().numpy()
        self._initial_guess(imu_rpy, bool(deskew_info.imu_available[0]),
                            bool(deskew_info.odom_available[0]),
                            deskew_info.initial_guess[0].cpu().numpy(),
                            odom_rid)

        built = self._surrounding_map()
        if built is not None:
            local_map, n_vox = built
            guess = torch.from_numpy(self.pose[None]).to(self.device)
            he = tuple(p.register_grid_half_extent)
            res = grid_register_step(
                local_map, feats, guess, half_extent=he,
                max_iterations=p.max_gn_iterations,
                min_correspondences=p.min_correspondences,
                edge_min_valid=p.edge_feature_min_valid_num,
                surf_min_valid=p.surf_feature_min_valid_num,
                min_plane_spread=p.surf_min_planar_spread)
            fused = transform_update(
                res.pose6, deskew_info.imu_rpy_init,
                deskew_info.imu_available,
                imu_weight=p.imu_attitude_weight,
                rotation_tolerance=p.rotation_tolerance,
                z_tolerance=p.z_tolerance)
            res = res._replace(
                pose6=torch.where(res.valid[:, None], fused, res.pose6))
            self.last_result = res
            # one copy to the host: the pose, the result's fields, the
            # voxel counts and the grid tables' dropped shares
            host = torch.cat([
                res.pose6[0], torch.stack([
                    res.n_corr[0], res.iterations[0], res.converged[0],
                    res.is_degenerate[0], res.valid[0]]).to(torch.float32),
                n_vox.to(torch.float32),
                grid_overflow(local_map, guess[0, 3:6], half_extent=he)
            ]).cpu().numpy()
            self.pose = host[:6].copy()
            n_corr, iters, conv, degen, valid = host[6:11]
            for kind, total, cap in (("corner", host[11], p.map_corner_cap),
                                     ("surf", host[12], p.map_surf_cap)):
                if total > cap:
                    self._log.warn("mapping/dropped_points", time=timestamp,
                                   cap="local_map", feature=kind,
                                   dropped=int(total) - cap, kept=cap)
            for kind, share in (("corner", host[13]), ("surf", host[14])):
                if share > 0:
                    self._log.warn("mapping/dropped_points", time=timestamp,
                                   cap="grid_cell", feature=kind,
                                   dropped_share=float(share))
            # publishOdometry analog (ref :1791-1848): the event stream
            # carries what the reference puts on its publishers
            self._log.event(
                "mapping/odometry", level="info" if valid else "warn",
                time=timestamp, pose=self.pose, n_corr=int(n_corr),
                iterations=int(iters), converged=bool(conv),
                degenerate=bool(degen), gate_valid=bool(valid),
                reset_id=self.reset_id)

        if self._is_keyframe():
            self._save_keyframe(feats, timestamp)
            self._log.info("mapping/keyframe", time=timestamp,
                           index=self.n_keyframes - 1, pose=self.pose)
            if p.loop_closure_enable_flag:
                self.maybe_close_loop(timestamp)

        self.trajectory.append(self.pose.copy())
        return self.pose

    # -------------------------------------------------------- visualization
    def global_map_snapshot(self, radius: float | None = None,
                            leaf: float | None = None):
        """Radius-filtered, downsampled global feature map snapshot —
        publishGlobalMap's payload as a NumPy array (ref:
        src/mapOptmization.h:524-569; the ROS publisher becomes a return
        value)."""
        p = self.params
        radius = radius or p.global_map_visualization_search_radius
        leaf = leaf or p.global_map_visualization_leaf_size
        n = self.n_keyframes
        if n == 0:
            return np.zeros((0, 3), np.float32)
        last = self.kf_poses[n - 1, 3:]
        sel = np.linalg.norm(self.kf_poses[:n, 3:] - last, axis=1) < radius
        # globalMapVisualizationPoseDensity keypose thinning (ref :553)
        keep = self._thin_poses(np.where(sel)[0],
                                p.global_map_visualization_pose_density)
        return self._world_cloud(keep, leaf=leaf)

    # ------------------------------------------------------------- map save
    def save_map(self, directory: str):
        """PCD checkpoint like visualizeGlobalMapThread's shutdown save
        (ref :485-521): trajectory, transformations, corner/surf/global,
        and the per-keyframe clouds (keyframes.npz)."""
        from ..io.pcd import write_pcd

        os.makedirs(directory, exist_ok=True)
        n = self.n_keyframes
        write_pcd(os.path.join(directory, "trajectory.pcd"), {
            "x": self.kf_poses[:n, 3], "y": self.kf_poses[:n, 4],
            "z": self.kf_poses[:n, 5],
            "intensity": np.arange(n, dtype=np.float32)})
        write_pcd(os.path.join(directory, "transformations.pcd"), {
            "x": self.kf_poses[:n, 3], "y": self.kf_poses[:n, 4],
            "z": self.kf_poses[:n, 5],
            "intensity": np.arange(n, dtype=np.float32),
            "roll": self.kf_poses[:n, 0], "pitch": self.kf_poses[:n, 1],
            "yaw": self.kf_poses[:n, 2],
            "time": self.kf_times[:n]})

        def global_cloud(clouds, masks):
            pts = []
            for k in range(n):
                T = _mat(self.kf_poses[k])
                pts.append(clouds[k][masks[k]] @ T[:3, :3].T + T[:3, 3])
            return (np.concatenate(pts) if pts
                    else np.zeros((0, 3), np.float32))

        corner = global_cloud(self.kf_corner, self.kf_corner_mask)
        surf = global_cloud(self.kf_surf, self.kf_surf_mask)
        for name, pts in (("cloudCorner.pcd", corner), ("cloudSurf.pcd", surf),
                          ("cloudGlobal.pcd", np.concatenate([corner, surf]))):
            write_pcd(os.path.join(directory, name), {
                "x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2],
                "intensity": np.zeros(len(pts), np.float32)})

        # per-keyframe feature clouds (lidar frame) — beyond the reference's
        # aggregate PCDs; lets multi-session merging re-render the map after
        # per-keyframe pose corrections
        np.savez_compressed(
            os.path.join(directory, "keyframes.npz"),
            poses=self.kf_poses[:n], times=self.kf_times[:n],
            corner=self.kf_corner[:n], corner_mask=self.kf_corner_mask[:n],
            surf=self.kf_surf[:n], surf_mask=self.kf_surf_mask[:n])
