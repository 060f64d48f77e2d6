"""Pose graphs for the pose-graph LM kernel (`graph/pose_graph.py`), made
from seeds with numpy: no JAX, so the GPU tests and chip_smoke.py use them.

Every graph comes at one of the SLAM pipeline's two capacities (`SHAPES`):
"window" (its trailing window: K 32, one prior, 32 between and 16 GPS
slots) and "slots512" (its full graph: K 512, one prior, 576 between and
256 GPS slots), the factors in the first slots and the rest masked, as
`SlamPipeline._graph` fills them.

  chain(...)        tests/test_graph.py's chain: a circle of 1 m steps
                    turning 0.3 rad, noisy initial poses, a tight prior on
                    pose 0, true odometry betweens; loop=True adds the
                    closing between, gps=True scales the odometry by 1.05
                    and adds six GPS fixes
  big_chain(n)      n live poses (route B past the kernel's cap): a chain
                    with a loop closure every 40 poses
  blocks_graph(c)   tests/test_torch_slam.py's four-pose graph for the
                    factor blocks: rotation errors random, exactly zero,
                    0.1 rad short of pi about generic axes, or about the
                    coordinate axes (forward mode's NaN and infinite
                    entries)
  gimbal(...)       the chain with pose 5 at pitch pi/2: the between
                    factors' Jacobians are not finite
  loops(n, pairs)   the chain with more betweens (true relative poses)
                    between the given poses, and the poses `inactive`
                    masked: loop closures that widen the rows of the
                    Cholesky's envelope, an inactive pose pinned
  star(n)           the chain with a between from pose 0 to every pose:
                    every row's envelope starts at pose 0
  gimbal_loop(...)  the chain with its loop closure and pose 2 at pitch
                    pi/2: H is not finite in the rows of poses 1-3, and
                    the dense Cholesky would carry NaN (0 x inf) into the
                    later rows left of their envelope
"""

import numpy as np
import torch

from feature_base_pointcloud_registration_tpu_torch.graph.pose_graph import (
    PoseGraphData)

SHAPES = {"window": dict(K=32, Fp=1, Fb=32, Fg=16),
          "slots512": dict(K=512, Fp=1, Fb=576, Fg=256)}
F32 = np.float32


def pose_matrix(p):
    """4x4 of pose6 (roll, pitch, yaw, x, y, z), R = Rz Ry Rx."""
    cr, sr, cp, sp, cy, sy = (np.cos(p[0]), np.sin(p[0]), np.cos(p[1]),
                              np.sin(p[1]), np.cos(p[2]), np.sin(p[2]))
    T = np.eye(4)
    T[:3, :3] = [[cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
                 [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
                 [-sp, cp * sr, cp * cr]]
    T[:3, 3] = p[3:6]
    return T


def matrix_pose(T):
    R = T[:3, :3]
    return np.array([np.arctan2(R[2, 1], R[2, 2]),
                     np.arcsin(np.clip(-R[2, 0], -1.0, 1.0)),
                     np.arctan2(R[1, 0], R[0, 0]), *T[:3, 3]], F32)


def rel_pose(a, b):
    """The relative pose6 a -> b."""
    return matrix_pose(np.linalg.inv(pose_matrix(a)) @ pose_matrix(b))


def graph(shape, poses, pose_mask, prior=None, btw=(), gps=(), device="cpu"):
    """A PoseGraphData at SHAPES[shape] with the factors in its first
    slots: prior (i, meas6, sigma6); btw [(i, j, meas6, sigma6)]; gps [(i,
    xyz, sigma3)]."""
    s = SHAPES[shape]
    K, Fp, Fb, Fg = s["K"], s["Fp"], s["Fb"], s["Fg"]
    a = {k: t.numpy().copy() for k, t in PoseGraphData.empty(
        K, Fp, Fb, Fg, device="cpu")._asdict().items()}
    a["poses"][:len(poses)] = poses
    a["pose_mask"][:len(pose_mask)] = pose_mask
    if prior is not None:
        a["prior_idx"][0], a["prior_meas"][0] = prior[0], prior[1]
        a["prior_sigma"][0], a["prior_mask"][0] = prior[2], True
    for f, (i, j, m, sg) in enumerate(btw):
        a["btw_i"][f], a["btw_j"][f], a["btw_meas"][f] = i, j, m
        a["btw_sigma"][f], a["btw_mask"][f] = sg, True
    for f, (i, m, sg) in enumerate(gps):
        a["gps_idx"][f], a["gps_meas"][f] = i, m
        a["gps_sigma"][f], a["gps_mask"][f] = sg, True
    return PoseGraphData(**{k: torch.from_numpy(v).to(device)
                            for k, v in a.items()})


BTW_SIGMA = np.array([1e-3, 1e-3, 1e-3, 1e-2, 1e-2, 1e-2], F32)


def _truth(n):
    gt = np.zeros((n, 6), F32)
    step = np.array([0.0, 0.0, 0.3, 1.0, 0.0, 0.0], F32)
    for k in range(1, n):
        gt[k] = matrix_pose(pose_matrix(gt[k - 1]) @ pose_matrix(step))
    return gt


def chain(shape="window", n=20, noise=0.02, seed=0, loop=False, gps=False,
          device="cpu"):
    """(graph, ground truth [n, 6])."""
    rng = np.random.RandomState(seed)
    gt = _truth(n)
    init = gt + rng.normal(0, noise, gt.shape).astype(F32) * np.array(
        [1, 1, 1, 5, 5, 5], F32)
    init[0] = gt[0]
    meas = [rel_pose(gt[k - 1], gt[k]) for k in range(1, n)]
    if gps:
        for m in meas:
            m[3] *= 1.05      # 5% scale drift
    btw = [(k - 1, k, meas[k - 1], BTW_SIGMA) for k in range(1, n)]
    if loop:
        btw.append((n - 1, 0, rel_pose(gt[n - 1], gt[0]), BTW_SIGMA))
    fixes = ([(k, gt[k, 3:], np.full(3, 0.01, F32))
              for k in (3, 6, 9, 12, 15, 19) if k < n] if gps else [])
    return graph(shape, init, np.ones(n, bool),
                 (0, gt[0], np.full(6, 1e-2, F32)), btw, fixes,
                 device), gt


def big_chain(n, seed=1, device="cpu"):
    """n live poses in 512 slots: the chain with a loop between every 40th
    pose and pose 0's neighbourhood (true relative poses)."""
    rng = np.random.RandomState(seed)
    gt = _truth(n)
    init = gt + rng.normal(0, 0.01, gt.shape).astype(F32) * np.array(
        [1, 1, 1, 5, 5, 5], F32)
    init[0] = gt[0]
    btw = [(k - 1, k, rel_pose(gt[k - 1], gt[k]), BTW_SIGMA)
           for k in range(1, n)]
    btw += [(k, k % 21, rel_pose(gt[k], gt[k % 21]), BTW_SIGMA)
            for k in range(40, n, 40)]
    return graph("slots512", init, np.ones(n, bool),
                 (0, gt[0], np.full(6, 1e-2, F32)), btw, (), device), gt


def _euler_near_pi(axis):
    """Euler angles of a rotation 0.1 rad short of pi about `axis`."""
    w = np.asarray(axis, np.float64)
    w = w / np.linalg.norm(w) * (np.pi - 0.1)
    th = np.linalg.norm(w)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    T = np.eye(4)
    T[:3, :3] = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
    return matrix_pose(T)[:3]


def blocks_graph(case, device="cpu"):
    """Four poses, a prior, three betweens (one a loop) and two GPS
    factors (the second masked), unit sigmas, at the window's shape."""
    r = np.random.RandomState(11)
    poses = r.uniform(-0.6, 0.6, (4, 6)).astype(F32)
    pairs = [(0, 1), (1, 2), (3, 0)]
    meas = r.uniform(-0.6, 0.6, (3, 6)).astype(F32)
    prior = r.uniform(-0.6, 0.6, 6).astype(F32)
    if case == "identity":
        poses[:, :3] = 0.0
        meas[:, :3] = 0.0
        prior[:3] = 0.0
    elif case == "near_pi":
        poses[:, :3] = 0.0
        meas[:, :3] = [_euler_near_pi(a) for a in ((1, 2, 3), (-2, 1, 0.5),
                                                    (0.3, -1, 2))]
        prior[:3] = _euler_near_pi((2, -1, 1))
    elif case == "near_pi_axis":
        poses[:, :3] = 0.0
        meas[:, :3] = [[np.pi - 0.1, 0.0, 0.0], [0.0, 0.0, np.pi - 0.1],
                       [0.3, 0.0, np.pi - 0.1]]
        prior[:3] = [0.0, 0.0, np.pi - 0.1]
    one = np.ones(6, F32)
    fixes = r.uniform(-1, 1, (2, 3)).astype(F32)
    g = graph("window", poses, np.ones(4, bool), (0, prior, one),
              [(i, j, meas[f], one) for f, (i, j) in enumerate(pairs)],
              [(1, fixes[0], one[:3]), (3, fixes[1], one[:3])], device)
    gps_mask = g.gps_mask.clone()
    gps_mask[1] = False
    return g._replace(gps_mask=gps_mask)


BLOCK_CASES = ("random", "identity", "near_pi", "near_pi_axis")


def gimbal(shape="window", device="cpu"):
    """The chain with pose 5 at pitch pi/2 (gimbal lock): asin's derivative
    in the between factors' relative rotation is infinite."""
    g, _ = chain(shape, device="cpu")
    poses = g.poses.clone()
    poses[4, :2] = 0.0
    poses[5, :3] = torch.tensor([0.0, np.float32(np.pi / 2),
                                 float(poses[4, 2])])
    return g._replace(poses=poses.to(device),
                      **{k: v.to(device) for k, v in g._asdict().items()
                         if k != "poses"})


def loops(n, pairs, shape="window", inactive=(), seed=0, device="cpu"):
    """(graph, ground truth): chain(shape, n) with a between factor at the
    true relative pose for each (i, j) of pairs, and the poses in inactive
    masked (still endpoints of their factors: live and pinned)."""
    g, gt = chain(shape, n=n, seed=seed)
    r = np.random.RandomState(seed + 1)
    btw = [(k - 1, k, rel_pose(gt[k - 1], gt[k]), BTW_SIGMA)
           for k in range(1, n)]
    btw += [(i, j, rel_pose(gt[i], gt[j]), BTW_SIGMA) for i, j in pairs]
    init = g.poses.numpy()[:n].copy()
    init[1:] += r.normal(0, 0.01, (n - 1, 6)).astype(F32)
    mask = np.ones(n, bool)
    mask[list(inactive)] = False
    return graph(shape, init, mask, (0, gt[0], np.full(6, 1e-2, F32)), btw,
                 (), device), gt


def star(n, seed=2, device="cpu"):
    """(graph, ground truth): n poses in 512 slots, the chain and a
    between from pose 0 to every pose from 2 on."""
    return loops(n, [(0, k) for k in range(2, n)], "slots512", seed=seed,
                 device=device)


def gimbal_loop(device="cpu"):
    """chain("window", loop=True) with pose 2 at pitch pi/2: asin's
    derivative in the between factors (1, 2) and (2, 3) is infinite."""
    g, _ = chain("window", loop=True, noise=0.05, device="cpu")
    poses = g.poses.clone()
    poses[1, :2] = 0.0
    poses[2, :3] = torch.tensor([0.0, np.float32(np.pi / 2),
                                 float(poses[1, 2])])
    return g._replace(poses=poses.to(device),
                      **{k: v.to(device) for k, v in g._asdict().items()
                         if k != "poses"})
