"""Multi-session map merging (BASELINE.json config 5).

Port of the JAX package's `pipeline/multisession.py`.  Two SLAM sessions
recorded over the same environment — each a keyframe trajectory +
per-keyframe feature clouds saved by `SlamPipeline.save_map` — are merged
into one globally consistent map:

  1. **Coarse inter-session alignment**: FPFH descriptors + RANSAC on the
     voxel-downsampled global clouds, refined by ICP (the same machinery as
     BASELINE config 3, ops/ransac.py + ops/icp.py) -> a rigid T_ab taking
     session B's world frame into session A's.
  2. **Cross-session loop factors**: B keyframes that land near an A
     keyframe after alignment are registered against an A feature submap
     with the point-to-line/plane GN solver (the loop-closure recipe, ref:
     src/mapOptmization.h:676-782, applied across sessions — but with the
     feature solver, which unlike point-to-point ICP does not slide on
     planar structure) -> BetweenFactor(A_i, B_j).
  3. **Joint pose-graph optimization**: one `PoseGraphData` holding both
     trajectories — per-session odometry chains, a prior anchoring A, and
     the cross-session betweens — solved by the same LM window optimizer
     that replaces iSAM2 (graph/pose_graph.py).
  4. **Merged map render**: both sessions' per-keyframe clouds transformed
     by their optimized poses, concatenated, voxel-downsampled, and saved
     in the reference's PCD layout (ref: src/mapOptmization.h:485-521) so
     `GlobalMap.from_pcd_dir` / the localization pipeline can load the
     merged map directly.

Sessions are host NumPy, as `SlamPipeline`'s keyframe arrays are; the
world clouds, the voxel filter (the host `native` runtime) and the link
loop run on the host, as in the JAX package.  The padded clouds,
FPFH/RANSAC/ICP, each link's `grid_register_step` (the K=16 fetch kernels
on a CUDA device) and the joint `optimize_pose_graph` run on `device`.

The reference has no multi-session capability; this extends its
save->reload checkpoint cycle (ref :245-260, :485-521) to N trajectories.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from .. import native
from ..geom.se3 import matrix_to_pose6, pose6_to_matrix
from ..graph.pose_graph import PoseGraphData, optimize_pose_graph
from ..ops.icp import icp_align
from ..ops.ransac import coarse_align_fpfh


class Session(NamedTuple):
    """One recorded session: keyframe poses + per-keyframe feature clouds
    (lidar frame), as persisted in `save_map`'s keyframes.npz."""

    poses: np.ndarray        # f32 [n, 6] pose6 (roll,pitch,yaw,x,y,z)
    times: np.ndarray        # f64 [n]
    corner: np.ndarray       # f32 [n, Cc, 3]
    corner_mask: np.ndarray  # bool [n, Cc]
    surf: np.ndarray         # f32 [n, Cs, 3]
    surf_mask: np.ndarray    # bool [n, Cs]

    @property
    def n(self) -> int:
        return self.poses.shape[0]


def load_session(directory: str) -> Session:
    """Load a session from a `SlamPipeline.save_map` directory."""
    z = np.load(os.path.join(directory, "keyframes.npz"))
    return Session(poses=z["poses"], times=z["times"],
                   corner=z["corner"], corner_mask=z["corner_mask"],
                   surf=z["surf"], surf_mask=z["surf_mask"])


def session_from_pipeline(pipe) -> Session:
    """Snapshot a live `SlamPipeline` as a Session (no disk round-trip)."""
    n = pipe.n_keyframes
    return Session(poses=pipe.kf_poses[:n].copy(),
                   times=pipe.kf_times[:n].copy(),
                   corner=pipe.kf_corner[:n].copy(),
                   corner_mask=pipe.kf_corner_mask[:n].copy(),
                   surf=pipe.kf_surf[:n].copy(),
                   surf_mask=pipe.kf_surf_mask[:n].copy())


def _host_pose6(T) -> np.ndarray:
    """pose6 of 4x4 float32 transform(s), through the port's se3 on the
    host."""
    return matrix_to_pose6(torch.as_tensor(
        np.asarray(T, np.float32))).numpy()


def _pose_mats(poses: np.ndarray) -> np.ndarray:
    """[n, 4, 4] world<-lidar transforms for a pose6 array (host)."""
    return pose6_to_matrix(torch.as_tensor(
        np.asarray(poses, np.float32))).numpy()


def _world_cloud_one(sess: Session, indices, transforms: np.ndarray,
                     which: str, leaf: Optional[float] = None) -> np.ndarray:
    """Corner-only or surf-only keyframe clouds in the world frame."""
    clouds = sess.corner if which == "corner" else sess.surf
    masks = sess.corner_mask if which == "corner" else sess.surf_mask
    pts = []
    for k in indices:
        T = transforms[k]
        q = clouds[k][masks[k]]
        if len(q):
            pts.append(q @ T[:3, :3].T + T[:3, 3])
    out = (np.concatenate(pts).astype(np.float32) if pts
           else np.zeros((0, 3), np.float32))
    if leaf is not None and len(out):
        out = native.voxel_downsample(out, leaf)
    return out


def _pad(pts: np.ndarray, cap: int, device):
    """The first `cap` points of [N, 3] padded to cap, with their mask, on
    `device`."""
    buf = np.zeros((cap, 3), np.float32)
    msk = np.zeros(cap, bool)
    m = min(len(pts), cap)
    buf[:m] = pts[:m]
    msk[:m] = True
    return (torch.from_numpy(buf).to(device),
            torch.from_numpy(msk).to(device))


class AlignResult(NamedTuple):
    transform: np.ndarray    # f32 [4, 4]  A_world <- B_world
    fitness: float
    converged: bool


def align_sessions(generator, sess_a: Session, sess_b: Session, *,
                   leaf: float = 0.4, cap: int = 4096,
                   num_hypotheses: int = 512,
                   inlier_threshold: float = 0.5,
                   coarse: bool = True, device) -> AlignResult:
    """Rigid T_ab between two sessions' world frames, computed on `device`.

    FPFH+RANSAC coarse (skippable via coarse=False when the frames are
    known to be near; `generator`, a torch.Generator on `device`, draws
    the RANSAC triplets and may be None then) followed by ICP refinement,
    both over the voxel-downsampled global clouds.
    """
    Ta = _pose_mats(sess_a.poses)
    Tb = _pose_mats(sess_b.poses)

    def both(sess, T):
        pts = np.concatenate(
            [_world_cloud_one(sess, range(sess.n), T, "corner"),
             _world_cloud_one(sess, range(sess.n), T, "surf")])
        return native.voxel_downsample(pts, leaf) if len(pts) else pts

    dst, dst_m = _pad(both(sess_a, Ta), cap, device)
    src, src_m = _pad(both(sess_b, Tb), cap, device)

    T_coarse = np.eye(4, dtype=np.float32)
    if coarse:
        r = coarse_align_fpfh(generator, src, src_m, dst, dst_m,
                              num_hypotheses=num_hypotheses,
                              inlier_threshold=inlier_threshold)
        T_coarse = r.transform.cpu().numpy()

    Tc = torch.from_numpy(T_coarse).to(device)
    src_c = src @ Tc[:3, :3].T + Tc[:3, 3]
    res = icp_align(src_c, src_m, dst, dst_m, max_corr_dist=5.0,
                    max_iterations=60)
    return AlignResult(res.transform.cpu().numpy() @ T_coarse,
                       float(res.fitness), bool(res.converged))


class CrossLink(NamedTuple):
    idx_a: int
    idx_b: int
    meas: np.ndarray         # f32 [6] relative pose6 (A_i -> B_j)
    sigma: np.ndarray        # f32 [6]
    correction: float        # m the registration moved B_j (diagnostic)


class MergeResult(NamedTuple):
    poses_a: np.ndarray      # f32 [na, 6] optimized, A world frame
    poses_b: np.ndarray      # f32 [nb, 6] optimized, A world frame
    transform_ab: np.ndarray  # f32 [4, 4] initial rigid alignment
    links: List[CrossLink]
    align_fitness: float


def merge_sessions(generator, sess_a: Session, sess_b: Session, *,
                   params=None,
                   leaf: float = 0.4, link_radius: float = 5.0,
                   link_stride: int = 4, max_links: int = 16,
                   submap_halfwidth: int = 3,
                   max_link_correction: float = 3.0,
                   coarse: bool = True,
                   transform_ab: Optional[np.ndarray] = None,
                   iterations: int = 20, device) -> MergeResult:
    """Merge session B into session A's frame with joint optimization, the
    geometry on `device`.

    `transform_ab` short-circuits step 1 when the alignment is known.
    `link_stride`/`max_links` bound the per-link registration work;
    `max_link_correction` rejects links whose registration jumped
    implausibly far (the analog of the loop-closure fitness accept gate,
    ref: src/mapOptmization.h:715, for a solver with no fitness score).
    Pass the `params` the sessions' pipelines ran with: the link
    registration pads to their map and feature capacities.
    """
    if transform_ab is None:
        ar = align_sessions(generator, sess_a, sess_b, leaf=leaf,
                            coarse=coarse, device=device)
        transform_ab = ar.transform
        align_fitness = ar.fitness
    else:
        transform_ab = np.asarray(transform_ab, np.float32)
        align_fitness = 0.0

    Ta = _pose_mats(sess_a.poses)
    Tb0 = _pose_mats(sess_b.poses)
    Tb = np.einsum("ij,njk->nik", transform_ab, Tb0)  # B kf -> A world

    # ---- cross-session links: B keyframes near an A keyframe, verified by
    # feature-based scan-to-map registration (point-to-line/plane GN — the
    # same solver as the odometry hot path, ops/register.py).  Point-to-
    # plane is essential here: point-to-point ICP slides on the planar
    # structure that dominates indoor/urban maps.
    from ..config import Params as _Params
    from ..ops.register import grid_register_step
    from .cloud_info import FeatureMap, ScanFeatures

    p = params if params is not None else _Params()

    def repad(xyz, mask, cap):
        """Re-pad a (N,3)+(N,) masked cloud to capacity `cap`, batch 1."""
        x, m = _pad(np.asarray(xyz)[np.asarray(mask)], cap, device)
        return x[None], m[None]

    links: List[CrossLink] = []
    a_xyz = Ta[:, :3, 3]
    for j in range(0, sess_b.n, link_stride):
        if len(links) >= max_links:
            break
        d = np.linalg.norm(a_xyz - Tb[j, :3, 3], axis=1)
        i = int(d.argmin())
        if d[i] > link_radius:
            continue
        lo = max(0, i - submap_halfwidth)
        hi = min(sess_a.n, i + submap_halfwidth + 1)
        mc, mc_m = _pad(_world_cloud_one(sess_a, range(lo, hi), Ta,
                                         "corner"), p.map_corner_cap, device)
        ms, ms_m = _pad(_world_cloud_one(sess_a, range(lo, hi), Ta, "surf",
                                         leaf=leaf / 2), p.map_surf_cap,
                        device)
        fc, fc_m = repad(sess_b.corner[j], sess_b.corner_mask[j],
                         p.corner_cap)
        fs, fs_m = repad(sess_b.surf[j], sess_b.surf_mask[j], p.surf_cap)
        feats = ScanFeatures(corner_xyz=fc, corner_mask=fc_m,
                             surf_xyz=fs, surf_mask=fs_m)
        guess = _host_pose6(Tb[j])
        res = grid_register_step(
            FeatureMap(mc, mc_m, ms, ms_m), feats,
            torch.from_numpy(guess[None]).to(device),
            half_extent=tuple(p.register_grid_half_extent),
            max_iterations=p.max_gn_iterations,
            min_correspondences=p.min_correspondences,
            edge_min_valid=p.edge_feature_min_valid_num,
            surf_min_valid=p.surf_feature_min_valid_num)
        host = torch.cat([res.pose6[0], torch.stack([
            res.valid[0], res.converged[0],
            res.is_degenerate[0]]).to(torch.float32)]).cpu().numpy()
        pose_j = host[:6]
        valid, converged, degenerate = (bool(v) for v in host[6:9])
        if not (valid and converged):
            continue
        shift = float(np.linalg.norm(pose_j[3:] - guess[3:]))
        if shift > max_link_correction:
            # registration jumped implausibly far — treat as a failed match
            continue
        # corrected B pose in A world; factor meas = inv(T_Ai) @ T_Bj_corr
        T_j = _pose_mats(pose_j)
        rel = _host_pose6(np.linalg.inv(Ta[i]) @ T_j)
        # GN registration is oracle-parity accurate when it converges — tight
        # fixed noise; degenerate solves (weak directions projected out, ref
        # :1346-1377) keep their constrained components but get inflated
        # noise rather than rejection, matching the reference's
        # use-with-projection policy
        sigma = np.array([0.01, 0.01, 0.01, 0.02, 0.02, 0.02], np.float32)
        if degenerate:
            sigma = sigma * 5.0
        links.append(CrossLink(i, j, rel.astype(np.float32), sigma, shift))

    # ---- joint pose graph: A at [0, na), B at [na, na+nb)
    na, nb = sess_a.n, sess_b.n
    K = na + nb
    init = np.zeros((K, 6), np.float32)
    init[:na] = sess_a.poses
    init[na:] = _host_pose6(Tb)

    def chain(poses_mat):
        return [_host_pose6(np.linalg.inv(poses_mat[k - 1]) @ poses_mat[k])
                for k in range(1, len(poses_mat))]

    odom_sigma = np.sqrt(np.array([1e-6, 1e-6, 1e-6, 1e-4, 1e-4, 1e-4],
                                  np.float32))
    btw = []
    for k, rel in enumerate(chain(Ta)):
        btw.append((k, k + 1, rel, odom_sigma))
    for k, rel in enumerate(chain(Tb)):
        btw.append((na + k, na + k + 1, rel, odom_sigma))
    for ln in links:
        btw.append((ln.idx_a, na + ln.idx_b, ln.meas, ln.sigma))

    Fb = max(len(btw), 1)
    g = PoseGraphData.empty(K, Fp=1, Fb=Fb, Fg=1, device=device)
    bi = np.zeros(Fb, np.int32)
    bj = np.zeros(Fb, np.int32)
    bm = np.zeros((Fb, 6), np.float32)
    bs = np.ones((Fb, 6), np.float32)
    bmask = np.zeros(Fb, bool)
    for f, (i, j, m, s) in enumerate(btw):
        bi[f], bj[f], bm[f], bs[f], bmask[f] = i, j, m, s, True

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    g = g._replace(
        poses=dev(init), pose_mask=dev(np.ones(K, bool)),
        prior_idx=dev(np.zeros(1, np.int32)),
        prior_meas=dev(init[:1]),
        # TIGHT anchor: session A's frame is authoritative for the merge —
        # a wide (SLAM-style) prior would let the cross links drag A's
        # whole trajectory toward B (gauge freedom) instead of pulling B
        # onto A
        prior_sigma=dev(np.sqrt(np.full((1, 6), 1e-6, np.float32))),
        prior_mask=dev(np.ones(1, bool)),
        btw_i=dev(bi), btw_j=dev(bj), btw_meas=dev(bm), btw_sigma=dev(bs),
        btw_mask=dev(bmask))

    poses, _ = optimize_pose_graph(g, iterations=iterations)
    poses = poses.cpu().numpy()
    return MergeResult(poses[:na], poses[na:], transform_ab, links,
                       align_fitness)


def merged_session(result: MergeResult, sess_a: Session,
                   sess_b: Session) -> Session:
    """Fold an optimized merge into ONE session (A's frame): concatenated
    keyframes at their optimized poses.  Enables chaining N sessions:
    merge_many folds each new session into the running merged one."""
    if (sess_a.corner.shape[1:] != sess_b.corner.shape[1:]
            or sess_a.surf.shape[1:] != sess_b.surf.shape[1:]):
        raise ValueError(
            "sessions have different per-keyframe cloud capacities "
            f"({sess_a.corner.shape} vs {sess_b.corner.shape}); record "
            "them with the same pipeline caps before merging")
    return Session(
        poses=np.concatenate([result.poses_a, result.poses_b]),
        times=np.concatenate([sess_a.times, sess_b.times]),
        corner=np.concatenate([sess_a.corner, sess_b.corner]),
        corner_mask=np.concatenate([sess_a.corner_mask,
                                    sess_b.corner_mask]),
        surf=np.concatenate([sess_a.surf, sess_b.surf]),
        surf_mask=np.concatenate([sess_a.surf_mask, sess_b.surf_mask]))


def merge_many(generator, sessions, *, device, **kw) -> Session:
    """Merge N sessions into the first session's frame.

    Pairwise left fold: each session is aligned + jointly optimized
    against the accumulated merged session (whose keyframes act as the
    'A' trajectory), so later sessions link against ALL earlier coverage.
    Each pair draws from a fresh generator seeded from `generator` (where
    the JAX package splits its key).  Returns the final merged Session;
    pass it to save_merged-style rendering or build a localization map
    from its keyframes.
    """
    if len(sessions) == 0:
        raise ValueError("need at least one session")
    acc = sessions[0]
    for s in sessions[1:]:
        sub = torch.Generator(device=generator.device)
        sub.manual_seed(int(torch.randint(
            0, 2 ** 62, (), generator=generator, device=generator.device)))
        res = merge_sessions(sub, acc, s, device=device, **kw)
        acc = merged_session(res, acc, s)
    return acc


def save_merged_map(directory: str, result: MergeResult,
                    sess_a: Session, sess_b: Session, *,
                    leaf: float = 0.2):
    """Write the merged map in the reference's PCD checkpoint layout
    (ref: src/mapOptmization.h:485-521) — loadable by
    `GlobalMap.from_pcd_dir` for localization against the merged map."""
    from ..io.pcd import write_pcd

    os.makedirs(directory, exist_ok=True)
    Ta = _pose_mats(result.poses_a)
    Tb = _pose_mats(result.poses_b)

    def render(which):
        return np.concatenate(
            [_world_cloud_one(sess_a, range(sess_a.n), Ta, which),
             _world_cloud_one(sess_b, range(sess_b.n), Tb, which)])

    corner = render("corner")
    surf = render("surf")
    if len(corner):
        corner = native.voxel_downsample(corner, leaf)
    if len(surf):
        surf = native.voxel_downsample(surf, leaf * 2)

    all_poses = np.concatenate([result.poses_a, result.poses_b])
    write_pcd(os.path.join(directory, "trajectory.pcd"), {
        "x": all_poses[:, 3], "y": all_poses[:, 4], "z": all_poses[:, 5],
        "intensity": np.arange(len(all_poses), dtype=np.float32)})
    for name, pts in (("cloudCorner.pcd", corner), ("cloudSurf.pcd", surf),
                      ("cloudGlobal.pcd", np.concatenate([corner, surf]))):
        write_pcd(os.path.join(directory, name), {
            "x": pts[:, 0], "y": pts[:, 1], "z": pts[:, 2],
            "intensity": np.zeros(len(pts), np.float32)})
