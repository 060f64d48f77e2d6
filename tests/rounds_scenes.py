"""Lanes for one round of the rounds-structured solver's GN iterations
(`ops/rounds_gn.py`), made from seeds with numpy: the kernel's packed
layout and each lane's arrays for the JAX `register_rounds_core`.

`edge_lanes(K)` gives six lanes of one shape (Pc 128, Ps 512):
  0, 1  features of a map of vertical lines and three planes at a pose,
        the guess a few cm / mrad off;
  2     lane 0 with 8 live corner features: the feature-count gate fails;
  3     lane 1 with all but 30 corner features moved 50 m up: fewer than
        min_corr (50) correspondences, so the pose never moves;
  4     the port's `parallel/dryrun.tiny_problem` (16 lines and two
        planes; 128 + 256 features, the surf ones padded with dead
        features): degenerate at iteration 0;
  5     lane 0's map with 16 corner and 32 surf features within 1 m of the
        world origin whose K picks are all sentinels (d2 3e38, coordinates
        0 in the port's fetch and FAR = 1e9 in the JAX one), 20 surf
        features with their last three picks sentinels and 10 with only 3
        real picks.
The candidates of each feature are the exact K nearest map points at the
guess (ties by index), as a fetch at the guess gives them.  No JAX here:
the GPU tests and chip_smoke.py use these lanes too.
"""

import numpy as np
import torch

from feature_base_pointcloud_registration_tpu_torch.ops.gn_round import STAT
from feature_base_pointcloud_registration_tpu_torch.parallel.dryrun import (
    tiny_problem)

PC, PS = 128, 512
FAR = np.float32(1.0e9)
BIG = np.float32(3.0e38)


def pose_matrix(pose):
    """4x4 of pose6 (roll, pitch, yaw, x, y, z), R = Rz Ry Rx."""
    r, p, y = (float(a) for a in pose[:3])
    cr, sr, cp, sp, cy, sy = (np.cos(r), np.sin(r), np.cos(p), np.sin(p),
                              np.cos(y), np.sin(y))
    T = np.eye(4)
    T[:3, :3] = [[cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
                 [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
                 [-sp, cp * sr, cp * cr]]
    T[:3, 3] = pose[3:]
    return T


def world_map(seed=5):
    """(corner points [1024, 3], surf points [3072, 3]): 12 vertical lines,
    a floor and two walls, 1 cm noise."""
    r = np.random.RandomState(seed)
    xy = r.uniform(-7, 7, (12, 2))
    li = r.randint(0, 12, 1024)
    mc = np.stack([xy[li, 0], xy[li, 1], r.uniform(-1, 3, 1024)], -1)
    s = r.uniform(-8, 8, (3072, 2))
    which = r.randint(0, 3, 3072)
    ms = np.where(
        (which == 0)[:, None], np.stack([s[:, 0], s[:, 1],
                                         np.full(3072, -1.5)], -1),
        np.where((which == 1)[:, None],
                 np.stack([s[:, 0], np.full(3072, 8.0), s[:, 1] / 2], -1),
                 np.stack([np.full(3072, -8.0), s[:, 0], s[:, 1] / 2], -1)))
    return ((mc + r.normal(0, 0.01, mc.shape)).astype(np.float32),
            (ms + r.normal(0, 0.01, ms.shape)).astype(np.float32))


def knn(q, pts, K):
    """K-NN in float64, ascending d2, ties by index -> (d2 [N,K], nn
    [N,K,3])."""
    q, p = q.astype(np.float64), pts.astype(np.float64)
    d2 = (q * q).sum(1)[:, None] + (p * p).sum(1)[None] - 2.0 * q @ p.T
    idx = np.argpartition(d2, K, axis=1)[:, :K]
    nn = p[idx]
    exact = ((q[:, None, :] - nn) ** 2).sum(-1)
    order = np.lexsort((idx, exact), axis=1)
    idx = np.take_along_axis(idx, order, 1)
    return (np.take_along_axis(exact, order, 1).astype(np.float32),
            pts[idx].astype(np.float32))


def _lane(fc, fs, guess, mc, ms, K, cm=None, sm=None):
    Tg = pose_matrix(guess)
    cd, cnn = knn(fc @ Tg[:3, :3].T + Tg[:3, 3], mc, K)
    sd, snn = knn(fs @ Tg[:3, :3].T + Tg[:3, 3], ms, K)
    return dict(fc=fc.astype(np.float32), fs=fs.astype(np.float32),
                cm=np.ones(len(fc), bool) if cm is None else cm,
                sm=np.ones(len(fs), bool) if sm is None else sm,
                guess=np.asarray(guess, np.float32), cd=cd, cnn=cnn, sd=sd,
                snn=snn, c_sent=np.zeros(cd.shape, bool),
                s_sent=np.zeros(sd.shape, bool))


def edge_lanes(K, seed=7):
    """The module docstring's six lanes: a list of dicts (fc [PC,3], cm,
    fs [PS,3], sm, guess [6], cd [PC,K], cnn [PC,K,3], sd, snn, c_sent /
    s_sent [P,K] the sentinel picks)."""
    r = np.random.RandomState(seed)
    mc, ms = world_map()
    offs = np.array([[0.01, -0.005, 0.008, 0.05, -0.04, 0.02],
                     [-0.006, 0.009, -0.01, -0.05, 0.03, -0.04]])
    lanes = []
    for b in range(2):
        gt = np.array([0.01 * b, -0.01, 0.02, 0.2 * b, -0.1, 0.0])
        T = np.linalg.inv(pose_matrix(gt))
        cw = mc[r.choice(len(mc), PC, replace=False)] + r.normal(
            0, 0.01, (PC, 3))
        sw = ms[r.choice(len(ms), PS, replace=False)] + r.normal(
            0, 0.01, (PS, 3))
        lanes.append(_lane(cw @ T[:3, :3].T + T[:3, 3],
                           sw @ T[:3, :3].T + T[:3, 3], gt + offs[b], mc, ms,
                           K))
    gated = dict(lanes[0])
    gated["cm"] = np.arange(PC) < 8
    lanes.append(gated)
    up = np.array([0.0, 0.0, 50.0])
    l1 = lanes[1]
    fc = np.where((np.arange(PC) < 30)[:, None], l1["fc"], l1["fc"] + up)
    lanes.append(_lane(fc, l1["fs"] + up, l1["guess"], mc, ms, K))
    feats, fmap, pose = tiny_problem(device=torch.device("cpu"),
                                     corner_cap=PC, surf_cap=PS // 2)
    fs = np.zeros((PS, 3), np.float32)
    fs[:PS // 2] = feats.surf_xyz.numpy()
    lanes.append(_lane(feats.corner_xyz.numpy(), fs, pose.numpy(),
                       fmap.corner_xyz.numpy(), fmap.surf_xyz.numpy(), K,
                       sm=np.arange(PS) < PS // 2))
    l0 = lanes[0]
    Ti = np.linalg.inv(pose_matrix(l0["guess"]))
    near = r.uniform(-0.5, 0.5, (48, 3))
    near = near @ Ti[:3, :3].T + Ti[:3, 3]
    fc, fs = l0["fc"].copy(), l0["fs"].copy()
    fc[:16], fs[:32] = near[:16], near[16:]
    lane = _lane(fc, fs, l0["guess"], mc, ms, K)
    lane["c_sent"][:16] = True
    lane["s_sent"][:32] = True
    lane["s_sent"][32:52, K - 3:] = True
    lane["s_sent"][52:62, 3:] = True
    for d, sent in (("cd", "c_sent"), ("sd", "s_sent")):
        lane[d] = np.where(lane[sent], BIG, lane[d])
    lanes.append(lane)
    return lanes


def plain_lanes(n, K, pc=PC, ps=PS, seed=11):
    """n lanes like edge_lanes' first two at pc / ps features each (drawn
    with replacement, 1 cm noise), each at its own pose and guess."""
    r = np.random.RandomState(seed)
    mc, ms = world_map()
    lanes = []
    for _ in range(n):
        gt = np.concatenate([r.uniform(-0.02, 0.02, 3),
                             r.uniform(-1.0, 1.0, 2), [0.0]])
        T = np.linalg.inv(pose_matrix(gt))
        cw = mc[r.randint(0, len(mc), pc)] + r.normal(0, 0.01, (pc, 3))
        sw = ms[r.randint(0, len(ms), ps)] + r.normal(0, 0.01, (ps, 3))
        guess = gt + r.uniform(-1, 1, 6) * [0.01, 0.01, 0.02, 0.1, 0.1, 0.05]
        lanes.append(_lane(cw @ T[:3, :3].T + T[:3, 3],
                           sw @ T[:3, :3].T + T[:3, 3], guess, mc, ms, K))
    return lanes


def gate_of(lane, edge_min_valid=10, surf_min_valid=100):
    return (lane["cm"].sum() > edge_min_valid
            and lane["sm"].sum() > surf_min_valid)


def packed(lanes, K, device="cpu"):
    """The kernel's layout as torch tensors on `device`: (stat, matP,
    featc, feats, candc, cands, cd2, sd2); sentinel picks carry zero
    coordinates, as the port's fetch gives them."""
    B = len(lanes)

    def planes(xyz, mask):
        return np.concatenate([np.stack([lane[xyz].T for lane in lanes]),
                               np.stack([lane[mask] for lane in lanes])[
                                   :, None].astype(np.float32)], 1)

    def cand(nn, sent):
        c = np.stack([np.where(lane[sent][..., None], 0.0, lane[nn])
                      for lane in lanes])               # [B,P,K,3]
        return c.transpose(3, 2, 0, 1).reshape(3 * K, -1)

    def d2(key):
        return np.stack([lane[key] for lane in lanes]).transpose(2, 0, 1) \
            .reshape(K, -1)

    stat = np.zeros((B, STAT), np.float32)
    stat[:, 0:6] = np.stack([lane["guess"] for lane in lanes])
    stat[:, 9] = [float(gate_of(lane)) for lane in lanes]
    matP = np.tile(np.eye(6, dtype=np.float32).reshape(1, 36), (B, 1))
    out = (stat, matP, planes("fc", "cm"), planes("fs", "sm"),
           cand("cnn", "c_sent"), cand("snn", "s_sent"), d2("cd"), d2("sd"))
    return tuple(torch.from_numpy(np.ascontiguousarray(a, np.float32))
                 .to(device) for a in out)
