"""Port parity: the GN round (`ops/gn_round.py`).

On the CPU `gn_round` runs its plain version `gn_round_reference`.  It is
held against:
  * the TPU kernel itself, `gn_round_pallas` in Pallas interpret mode with
    jacobi_sweeps=2 (as tests/test_pallas_gn.py runs it: 6 sweeps take >9
    min to compile that way), on that file's tiny scene (B=2, P=128, K=6,
    5 iterations).  Tolerance: pose <= 1e-4 (m / rad) — the port uses the
    library acos where the kernel has a 2e-8 polynomial, and sums in another
    order — with equal n_corr and equal iteration counts;
  * the XLA solver `register_rounds_core` fed the same candidates through a
    constant fetch, at the 2e-3 that tests/test_pallas_gn.py uses (with and
    without the min_plane_spread gate);
  * the JAX kernel's `_jacobi6` on random SPD matrices (rtol 1e-6).
It also pins the precondition under which the CUDA kernel skips dead
points: with finite candidates, what a dead point carries changes nothing.
The CUDA kernel against its plain version is tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from feature_base_pointcloud_registration_tpu.io.synthetic import (
    pose6_to_matrix_np)
from feature_base_pointcloud_registration_tpu.ops.pallas_gn import (
    _jacobi6, gn_round_pallas)
from feature_base_pointcloud_registration_tpu.ops.register import (
    register_rounds_core)
from feature_base_pointcloud_registration_tpu.pipeline.cloud_info import (
    ScanFeatures)
from feature_base_pointcloud_registration_tpu_torch.ops import gn_round as tgn
from test_torch_batch import one_torch_thread  # noqa: F401

B, PC, PS, K, ITERS = 2, 128, 128, 6, 5


def _knn(q, pts):
    """Exact K-NN, ascending d2, ties by index -> (d2 [N,K], nn [N,K,3])."""
    d2 = ((q[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
    idx = np.argsort(d2, axis=1, kind="stable")[:, :K]
    return (np.take_along_axis(d2, idx, 1).astype(np.float32),
            pts[idx].astype(np.float32))


def _maps(r, spread_string=False):
    """Corner lines + surf planes (tests/test_pallas_gn.py's scenes)."""
    xy = r.uniform(-4, 4, (10, 2))
    li = r.randint(0, 10, 1024)
    mc = np.stack([xy[li, 0], xy[li, 1], r.uniform(-1, 3, 1024)],
                  -1).astype(np.float32)
    if spread_string:
        gx, gy = np.meshgrid(np.linspace(-5, 5, 30), np.linspace(-5, 5, 30))
        ground = np.stack([gx.ravel(), gy.ravel(),
                           np.full(gx.size, -1.5)], -1)
        wx, wz = np.meshgrid(np.linspace(-5, 5, 12), np.linspace(-1, 2, 8))
        wall = np.stack([wx.ravel(), np.full(wx.size, 5.0), wz.ravel()], -1)
        string = np.stack([np.linspace(-4, 4, 64), np.zeros(64),
                           np.full(64, 0.5)], -1)
        string += r.normal(0, 0.02, string.shape)     # nearly collinear
        return mc, np.concatenate([ground, wall, string]).astype(np.float32)
    sx = r.uniform(-5, 5, (1024, 2))
    which = r.randint(0, 3, 1024)
    ms = np.where(
        (which == 0)[:, None],
        np.stack([sx[:, 0], sx[:, 1], np.full(1024, -1.5)], -1),
        np.where((which == 1)[:, None],
                 np.stack([sx[:, 0], np.full(1024, 5.0), sx[:, 1]], -1),
                 np.stack([np.full(1024, -5.0), sx[:, 0], sx[:, 1]], -1))
    ).astype(np.float32)
    return mc, ms


def _scene(seed=7, spread_string=False):
    """Features, guesses and their K candidates at the guess, per lane."""
    r = np.random.RandomState(seed)
    mc, ms = _maps(r, spread_string)
    offs = np.array([[0.01, -0.005, 0.008, 0.05, -0.04, 0.02],
                     [-0.006, 0.009, -0.01, -0.05, 0.03, -0.04]], np.float32)
    lanes = []
    for b in range(B):
        pose = np.array([0.01 * b, -0.01, 0.02, 0.2 * b, -0.1, 0.0],
                        np.float32)
        T = np.linalg.inv(pose6_to_matrix_np(pose))
        cw = mc[r.choice(len(mc), PC, replace=False)] + r.normal(
            0, 0.01, (PC, 3))
        sw = ms[r.choice(len(ms), PS, replace=False)] + r.normal(
            0, 0.005 if spread_string else 0.01, (PS, 3))
        fc = (cw @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
        fs = (sw @ T[:3, :3].T + T[:3, 3]).astype(np.float32)
        guess = (pose + offs[b]).astype(np.float32)
        Rg = pose6_to_matrix_np(guess)
        cd, cnn = _knn(fc @ Rg[:3, :3].T + Rg[:3, 3], mc)
        sd, snn = _knn(fs @ Rg[:3, :3].T + Rg[:3, 3], ms)
        lanes.append(dict(fc=fc, fs=fs, guess=guess, cd=cd, cnn=cnn, sd=sd,
                          snn=snn))
    return lanes


def _kernel_inputs(lanes):
    """Kernel layouts (numpy): stat, matP, featc, feats, candc, cands."""
    def planes(key):
        return np.ascontiguousarray(np.concatenate(
            [np.stack([lane[key].T for lane in lanes]),
             np.ones((B, 1, lanes[0][key].shape[0]), np.float32)], 1))

    def cand(key):
        nn = np.stack([lane[key] for lane in lanes])   # [B,P,K,3]
        return np.ascontiguousarray(
            nn.transpose(3, 2, 0, 1).reshape(3 * K, -1))

    stat = np.zeros((B, tgn.STAT), np.float32)
    stat[:, 0:6] = np.stack([lane["guess"] for lane in lanes])
    stat[:, 9] = 1.0
    matP = np.tile(np.eye(6, dtype=np.float32).reshape(1, 36), (B, 1))
    return (stat, matP, planes("fc"), planes("fs"), cand("cnn"),
            cand("snn"))


def _port(inputs, **kw):
    out = tgn.gn_round(*(torch.from_numpy(a) for a in inputs), K=K,
                       iters=ITERS, **kw)
    return [o.numpy() for o in out]


def test_matches_pallas_kernel_interpret():
    inputs = _kernel_inputs(_scene())
    want, want_mp = gn_round_pallas(*(jnp.asarray(a) for a in inputs), K=K,
                                    iters=ITERS, jacobi_sweeps=2,
                                    interpret=True)
    want, want_mp = np.asarray(want), np.asarray(want_mp)
    got, got_mp = _port(inputs, jacobi_sweeps=2)
    assert (want[:, 10] > 50).all()
    np.testing.assert_allclose(got[:, 0:6], want[:, 0:6], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[:, 6:11], want[:, 6:11])
    np.testing.assert_allclose(got_mp, want_mp, rtol=0, atol=1e-4)


@pytest.mark.parametrize("spread", [0.0, 0.05])
def test_matches_rounds_core_same_candidates(spread):
    lanes = _scene(seed=11 if spread else 7, spread_string=spread > 0)
    got, _ = _port(_kernel_inputs(lanes), min_plane_spread=spread)
    for b, lane in enumerate(lanes):
        feats = ScanFeatures(
            corner_xyz=jnp.asarray(lane["fc"]), corner_mask=jnp.ones(PC, bool),
            surf_xyz=jnp.asarray(lane["fs"]), surf_mask=jnp.ones(PS, bool))
        res = register_rounds_core(
            feats,
            lambda w, lane=lane: (jnp.asarray(lane["cd"]),
                                  jnp.asarray(lane["cnn"])),
            lambda w, lane=lane: (jnp.asarray(lane["sd"]),
                                  jnp.asarray(lane["snn"])),
            jnp.asarray(lane["guess"]), num_rounds=1, iters_per_round=ITERS,
            min_plane_spread=spread)
        np.testing.assert_allclose(got[b, 0:6], np.asarray(res.pose6),
                                   atol=2e-3)
        nr = int(res.n_corr)
        assert nr > 50 and abs(int(got[b, 10]) - nr) <= 0.05 * nr + 10


def test_inactive_lanes_untouched():
    stat, matP, *rest = _kernel_inputs(_scene())
    stat[0, 9] = 0.0                       # lane 0 fails the feature gate
    stat[1, 7] = 1.0                       # lane 1 already converged
    got, got_mp = _port((stat, matP, *rest))
    np.testing.assert_array_equal(got, stat)
    np.testing.assert_array_equal(got_mp, matP)


def test_dead_point_candidates_add_nothing():
    """The CUDA kernel skips dead points (mask 0) where the plain version
    adds their terms times 0; with finite candidates that is the same
    result, so zero and arbitrary finite candidates there give equal
    stat and matP."""
    stat, matP, fc, fs, cc, cs = _kernel_inputs(_scene())
    fc[:, 3, ::4] = 0.0
    fs[:, 3, PS // 2:] = 0.0
    r = np.random.RandomState(3)
    outs = []
    for garbage in (False, True):
        cands = []
        for c, f in ((cc, fc), (cs, fs)):
            c = c.copy()
            dead = (f[:, 3] == 0).reshape(-1)
            c[:, dead] = (r.uniform(-50, 50, (3 * K, dead.sum()))
                          if garbage else 0.0)
            cands.append(c)
        outs.append(_port((stat, matP, fc, fs, *cands)))
    assert (outs[0][0][:, 10] > 50).all()
    assert np.isfinite(outs[0][0][:, :6]).all()
    assert np.isfinite(outs[0][1]).all()
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    np.testing.assert_array_equal(outs[1][1], outs[0][1])


def test_jacobi6_matches_pallas_helper():
    r = np.random.RandomState(0)
    M = r.normal(size=(5, 6, 20)).astype(np.float32)
    A = np.einsum("bik,bjk->bij", M, M).astype(np.float32) * 100
    w, V = _jacobi6({(i, j): jnp.asarray(A[:, i, j])
                     for i in range(6) for j in range(i, 6)}, sweeps=6)
    w = np.stack([np.asarray(x) for x in w], 1)
    V = np.stack([np.stack([np.asarray(V[(i, j)]) for j in range(6)], 1)
                  for i in range(6)], 1)
    tw, tV = tgn.jacobi6(torch.from_numpy(A), sweeps=6)
    np.testing.assert_allclose(tw.numpy(), w, rtol=1e-6, atol=1e-3)
    np.testing.assert_allclose(tV.numpy(), V, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.sort(tw.numpy(), 1),
                               np.linalg.eigvalsh(A.astype(np.float64)),
                               rtol=1e-5)
