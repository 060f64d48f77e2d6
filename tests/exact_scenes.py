"""Scenes for the exact solver's one-launch GN loop (`ops/exact_gn.py`),
made from seeds with numpy, for `exact_gn` / `register_scan` and the JAX
`register_scan`.

`scene()` gives rounds_scenes.world_map()'s map (12 vertical lines, a floor
and two walls; 1024 corner and 3072 surf points, four surf points repeated
so that some neighbours tie exactly) in MC = 2048 / MS = 4096 slots, the
live ones scattered in slot order and the dead ones holding junk
coordinates (+-1e3 m) that no result may read, and five lanes of one
shape (PC 128, PS 512 feature slots, zeros where dead):
  0, 1  features of the map at a pose, the guess a few cm / mrad off;
  2     lane 0 with 8 live corner features: the feature-count gate fails;
  3     lane 1 with all but 30 corner features and every surf feature moved
        50 m up: fewer than min_corr (50) correspondences, the pose stays;
  4     lane 0's features with every other slot dead (copies of other
        features there), so the live lists are not prefixes.
`few_live_map(scene)` keeps 3 live corner points (every corner feature
meets no-neighbour slots and fails the 5th-NN gate); `dense_surf_map()`
fills `n` surf slots, every one live, with the floor and walls' points.
No JAX here: the GPU tests and chip_smoke.py use these scenes too.
"""

import numpy as np
import torch

from feature_base_pointcloud_registration_tpu_torch.pipeline.cloud_info import (  # noqa: E501
    FeatureMap, ScanFeatures)

from rounds_scenes import pose_matrix, world_map

PC, PS = 128, 512
MC, MS = 2048, 4096
CHUNK = 1024             # the corner map is 2 chunks, the surf map 4


def _padded(r, pts, cap):
    """pts in `cap` slots: live ones at sorted random slots, the rest
    junk."""
    slots = np.sort(r.choice(cap, len(pts), replace=False))
    xyz = r.uniform(-1e3, 1e3, (cap, 3)).astype(np.float32)
    mask = np.zeros(cap, bool)
    xyz[slots] = pts
    mask[slots] = True
    return xyz, mask


def _features(r, mc, ms, gt):
    T = np.linalg.inv(pose_matrix(gt))
    cw = mc[r.choice(len(mc), PC, replace=False)] + r.normal(0, 0.01,
                                                             (PC, 3))
    sw = ms[r.choice(len(ms), PS, replace=False)] + r.normal(0, 0.01,
                                                             (PS, 3))
    return ((cw @ T[:3, :3].T + T[:3, 3]).astype(np.float32),
            (sw @ T[:3, :3].T + T[:3, 3]).astype(np.float32))


def scene(seed=3):
    """The module docstring's map and lanes: dict(cmap [MC, 3], cmask,
    smap [MS, 3], smask, lanes [dicts of fc [PC, 3], cm, fs [PS, 3], sm,
    guess [6], gt [6]])."""
    r = np.random.RandomState(seed)
    mc, ms = world_map()
    ms = ms.copy()
    ms[101:105] = ms[100]                      # exact ties
    cmap, cmask = _padded(r, mc, MC)
    smap, smask = _padded(r, ms, MS)
    offs = np.array([[0.01, -0.005, 0.008, 0.05, -0.04, 0.02],
                     [-0.006, 0.009, -0.01, -0.05, 0.03, -0.04]], np.float32)
    lanes = []
    for b in range(2):
        gt = np.array([0.01 * b, -0.01, 0.02, 0.2 * b, -0.1, 0.0],
                      np.float32)
        fc, fs = _features(r, mc, ms, gt)
        lanes.append(dict(fc=fc, cm=np.ones(PC, bool), fs=fs,
                          sm=np.ones(PS, bool), guess=gt + offs[b], gt=gt))
    gated = dict(lanes[0], cm=np.arange(PC) < 8)
    gated["fc"] = np.where(gated["cm"][:, None], gated["fc"], 0.0).astype(
        np.float32)
    lanes.append(gated)
    up = np.array([0.0, 0.0, 50.0], np.float32)
    l1 = lanes[1]
    lanes.append(dict(l1, fc=np.where((np.arange(PC) < 30)[:, None],
                                      l1["fc"], l1["fc"] + up),
                      fs=l1["fs"] + up))
    l0 = lanes[0]
    lanes.append(dict(l0, cm=np.arange(PC) % 2 == 0,
                      sm=np.arange(PS) % 2 == 1))
    return dict(cmap=cmap, cmask=cmask, smap=smap, smask=smask, lanes=lanes)


def few_live_map(sc):
    """sc's maps with only its first 3 live corner points left live."""
    cmask = sc["cmask"].copy()
    cmask[np.nonzero(cmask)[0][3:]] = False
    return dict(sc, cmask=cmask)


def dense_surf_map(n=16384, seed=11):
    """(xyz [n, 3], mask [n]) every slot live: points of world_map()'s
    floor and walls with 1 cm noise."""
    r = np.random.RandomState(seed)
    s = r.uniform(-8, 8, (n, 2))
    which = r.randint(0, 3, n)
    pts = np.where(
        (which == 0)[:, None], np.stack([s[:, 0], s[:, 1],
                                         np.full(n, -1.5)], -1),
        np.where((which == 1)[:, None],
                 np.stack([s[:, 0], np.full(n, 8.0), s[:, 1] / 2], -1),
                 np.stack([np.full(n, -8.0), s[:, 0], s[:, 1] / 2], -1)))
    return ((pts + r.normal(0, 0.01, pts.shape)).astype(np.float32),
            np.ones(n, bool))


def batch(sc, which, device, per_lane_maps=False):
    """(ScanFeatures [B, ...], FeatureMap, pose6 [B, 6]) of the lanes
    `which` on device; per_lane_maps: one map a lane ([B, M, 3]), lane j's
    slots rolled by 37 j (the same live points in another slot order)."""
    ls = [sc["lanes"][i] for i in which]

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    feats = ScanFeatures(*(t(np.stack([lane[k] for lane in ls]))
                           for k in ("fc", "cm", "fs", "sm")))
    maps = [sc[k] for k in ("cmap", "cmask", "smap", "smask")]
    if per_lane_maps:
        maps = [np.stack([np.roll(a, 37 * j, axis=0) for j in range(len(ls))])
                for a in maps]
    return (feats, FeatureMap(*map(t, maps)),
            t(np.stack([lane["guess"] for lane in ls])))


def first_nn_agreement(pose, feats, fmap, nn, gated, chunk):
    """The kernel's first-iteration neighbours, nn = (idx, d2) [B, Pc + Ps,
    5] from `kernels.launch_exact_gn(..., nn=nn)` with idx filled with -2
    before, against ops/knn.py::knn at pose on the same device, for the
    live features of the lanes through the gate (gated [B] bool).  Returns
    dict(slots, swaps, d2_err, ok): ok when every d2 is within 1e-6 of the
    terms the formula cancels (|q - c|^2 + |m - c|^2, c the set's
    centroid), every differing index a near-tie (the two exact d2 within
    twice that), a no-neighbour slot (-1) exactly where knn's d2 is 3e38,
    and the rows of dead features and gated-off lanes untouched."""
    from feature_base_pointcloud_registration_tpu_torch.ops.knn import knn
    from feature_base_pointcloud_registration_tpu_torch.ops.register import (
        world_components)
    gi, gd = (a.cpu().numpy() for a in nn)
    gated = np.asarray(gated)
    Pc = feats.corner_xyz.shape[1]
    out = dict(slots=0, swaps=0, d2_err=0.0, ok=True)
    for xyz, msk, ref, rmsk, sl in (
            (feats.corner_xyz, feats.corner_mask, fmap.corner_xyz,
             fmap.corner_mask, slice(0, Pc)),
            (feats.surf_xyz, feats.surf_mask, fmap.surf_xyz, fmap.surf_mask,
             slice(Pc, None))):
        q = torch.stack(world_components(pose, xyz), -1)
        wd, wi = (a.cpu().numpy() for a in knn(q, ref, rmsk, k=5,
                                               chunk=chunk))
        ki, kd = gi[:, sl], gd[:, sl]
        live = msk.cpu().numpy() & gated[:, None]
        none = wd >= 3e38
        qn = q.cpu().numpy().astype(np.float64)
        c = qn.mean(1, keepdims=True)
        r = ref.cpu().numpy().astype(np.float64)
        r = np.broadcast_to(r, (len(qn), *r.shape[-2:]))
        lanes = np.arange(len(qn))[:, None, None]
        tol = 1e-6 * (((qn - c) ** 2).sum(-1)[..., None]
                      + ((r[lanes, wi] - c[:, :, None]) ** 2).sum(-1))
        found = live[..., None] & ~none
        swapped = found & (ki != wi)
        err = np.abs(kd - wd)[found]
        out["slots"] += int(found.sum())
        out["swaps"] += int(swapped.sum())
        out["d2_err"] = max(out["d2_err"], float(err.max()) if err.size
                            else 0.0)
        ok = ((ki[~live] == -2).all()
              and np.array_equal(ki[live] == -1, none[live])
              and (err <= tol[found]).all())
        for b, p, j in zip(*np.nonzero(swapped)):
            e = (((r[b, ki[b, p, j]] - qn[b, p]) ** 2).sum()
                 - ((r[b, wi[b, p, j]] - qn[b, p]) ** 2).sum())
            ok = ok and abs(e) <= 2 * tol[b, p, j]
        out["ok"] = out["ok"] and bool(ok)
    return out
