"""Port parity: the SLAM back end (pose graph, SlamPipeline) and the caps
that the port reports.

Each test feeds the same numpy-seeded inputs (or the same host state,
through `convert.slam_state_to_torch`) to the JAX package and the port, on
the CPU.  Tolerances (float32):

  * residuals and Jacobian blocks (`graph_factor_blocks`) within 1e-5 of
    JAX at random poses, at identity (exact zero rotation errors, where
    acos has an infinite derivative) and near pi, every entry finite;
  * `optimize_pose_graph` on the chain, GPS and loop graphs of
    tests/test_graph.py (padded with masked factors to the SLAM runs'
    full-graph shape, 12 iterations as SlamPipeline's full solve): poses
    within 1e-4 (LAPACK's float32 Cholesky in another order), and the
    accuracy bounds of that file;
  * a step whose factorization fails is rejected, as JAX's NaN solve is:
    a gimbal-locked between factor (non-finite Jacobian) gives JAX's poses
    (unchanged), and a factorization reported failed (`cholesky_ex`
    info != 0) leaves the poses unchanged where the step would have
    lowered the cost;
  * `pose_marginal_covariances`: within 1e-6 relative (float64 on the
    host in both);
  * SlamPipeline policies of tests/test_slam_policies.py (eviction and
    its reindexing, factor overflow, density thinning) and the GPS gate of
    tests/test_incremental_graph.py, on the port;
  * loop closure on tests/test_incremental_graph.py's revisit world (a
    0.2 m submap leaf, see the test): both packages close, the loop
    factor's measurement and the corrected keyframe poses within 1e-4, its
    sigma within 1e-5, reset_id bumped, the drift reduced;
  * 5 SlamPipeline.steps of tests/test_pipeline.py's SLAM trajectory, the
    JAX pipeline on the port's frontend (see `slam_runs`): poses within
    1e-4 of JAX at every step, equal keyframe counts, equal event topics
    and levels (the port's `mapping/dropped_points` warnings aside, which
    JAX does not emit);
  * `save_map`: the same files, PCD fields within 1e-4, keyframes.npz
    masks equal and arrays within 1e-4;
  * the caps: a scene built to overflow each one emits its
    `*/dropped_points` warning (the crop and the grid cells in
    localization; the keyframe and the local-map voxel caps in SLAM), with
    the pose unchanged.

The SLAM runs use `Params(register_grid_half_extent=(30, 30, 10))` and
small capacities, as tests/test_torch_localization.py does.
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from feature_base_pointcloud_registration_tpu.config import Params
from feature_base_pointcloud_registration_tpu.geom import se3 as jse3
from feature_base_pointcloud_registration_tpu.graph import (
    pose_graph as jpg)
from feature_base_pointcloud_registration_tpu.io.synthetic import (
    SyntheticWorld, simulate_scan)
from feature_base_pointcloud_registration_tpu.pipeline import slam as jslam
from feature_base_pointcloud_registration_tpu.pipeline.cloud_info import (
    RawScan, ScanFeatures as JScanFeatures)
from feature_base_pointcloud_registration_tpu.utils import log as jlog
from feature_base_pointcloud_registration_tpu_torch.convert import (
    slam_state_to_torch, to_torch)
from feature_base_pointcloud_registration_tpu_torch.graph import (
    pose_graph as tpg)
from feature_base_pointcloud_registration_tpu_torch.io.pcd import read_pcd
from feature_base_pointcloud_registration_tpu_torch.pipeline import (
    frontend as tfront, localization as tloc, slam as tslam)
from feature_base_pointcloud_registration_tpu_torch.pipeline.cloud_info import (
    RawScan as TRawScan, ScanFeatures)
from feature_base_pointcloud_registration_tpu_torch.utils import log as tlog
from test_graph import _make_chain
from test_pipeline import _trajectory
from test_torch_batch import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
T = torch.from_numpy
PARAMS = Params(map_corner_cap=8192, map_surf_cap=65536, knn_chunk=2048,
                register_grid_half_extent=(30.0, 30.0, 10.0))
CAPS = dict(max_keyframes=32, opt_window=8)


def _port_graph(g):
    return to_torch(jax.tree.map(np.asarray, g), device=CPU)


def _full_shape(g):
    """A JAX graph (one prior slot in use, the first) padded with inactive
    poses and masked factors to the shape of the SLAM runs' full graph (K
    32, 1 prior, 32 + 64 betweens, 256 GPS slots): one JAX compile serves
    every graph test here and the loop closure's solve."""
    def pad(a, n, fill=0):
        a = np.asarray(a)
        out = np.full((n,) + a.shape[1:], fill, a.dtype)
        out[:len(a)] = a
        return jnp.asarray(out)

    sizes = {"poses": 32, "pose_mask": 32, "btw": 96, "gps": 256}
    return g._replace(**{
        f: (getattr(g, f)[:1] if f.startswith("prior") else
            pad(getattr(g, f), sizes[f] if f in sizes
                else sizes[f.split("_")[0]],
                1 if f.endswith("sigma") else 0))
        for f in g._fields})


def _chain(**kw):
    """tests/test_graph.py's chain graph at the full graph's shape."""
    g, gt, K_active = _make_chain(**kw)
    return _full_shape(g), gt, K_active


FULL_ITERATIONS = 12        # SlamPipeline's full-graph solve


# ------------------------------------------------------------ pose graph

def _euler_near_pi(axis):
    """Euler angles of a rotation 0.1 rad short of pi about `axis`."""
    w = np.asarray(axis, np.float32)
    R = jse3.so3_exp(jnp.asarray(w / np.linalg.norm(w) * (np.pi - 0.1)))
    return np.stack([np.asarray(a) for a in jse3.rot_to_euler(R)])


def _blocks_graph(case):
    """Four poses, a prior, three betweens (one a loop) and two GPS
    factors, unit sigmas; rotation errors random, exactly zero, or 0.1 rad
    short of pi (about generic axes, or about the coordinate axes)."""
    r = np.random.RandomState(11)
    poses = r.uniform(-0.6, 0.6, (4, 6)).astype(np.float32)
    pairs = [(0, 1), (1, 2), (3, 0)]
    meas = r.uniform(-0.6, 0.6, (3, 6)).astype(np.float32)
    prior = r.uniform(-0.6, 0.6, (1, 6)).astype(np.float32)
    if case == "identity":
        poses[:, :3] = 0.0
        meas[:, :3] = 0.0
        prior[:, :3] = 0.0
    elif case == "near_pi":
        poses[:, :3] = 0.0
        meas[:, :3] = [_euler_near_pi(a) for a in ((1, 2, 3), (-2, 1, 0.5),
                                                    (0.3, -1, 2))]
        prior[:, :3] = _euler_near_pi((2, -1, 1))
    elif case == "near_pi_axis":
        poses[:, :3] = 0.0
        meas[:, :3] = [[np.pi - 0.1, 0.0, 0.0], [0.0, 0.0, np.pi - 0.1],
                       [0.3, 0.0, np.pi - 0.1]]
        prior[:, :3] = [[0.0, 0.0, np.pi - 0.1]]
    g = jpg.PoseGraphData.empty(4, Fp=1, Fb=3, Fg=2)
    return _full_shape(g._replace(
        poses=jnp.asarray(poses), pose_mask=jnp.ones(4, bool),
        prior_idx=jnp.zeros(1, jnp.int32), prior_meas=jnp.asarray(prior),
        prior_mask=jnp.ones(1, bool),
        btw_i=jnp.asarray([i for i, _ in pairs], jnp.int32),
        btw_j=jnp.asarray([j for _, j in pairs], jnp.int32),
        btw_meas=jnp.asarray(meas), btw_mask=jnp.ones(3, bool),
        gps_idx=jnp.asarray([1, 3], jnp.int32),
        gps_meas=jnp.asarray(r.uniform(-1, 1, (2, 3)).astype(np.float32)),
        gps_mask=jnp.asarray([True, False])))


@pytest.mark.parametrize("case", ["random", "identity", "near_pi",
                                  "near_pi_axis"])
def test_factor_blocks_match_jax(case):
    """near_pi_axis: a rotation error near pi about a coordinate axis puts
    sqrt(0) on so3_log's diagonal route, and forward mode gives NaN rows
    in JAX's Jacobian blocks (ROADMAP Queue 3); the port's NaNs are in the
    same places and every other entry within 1e-5."""
    g = _blocks_graph(case)
    want = jax.tree.leaves(jax.tree.map(np.asarray, jax.jit(
        jpg.graph_factor_blocks)(g, g.poses)))
    tg = _port_graph(g)
    got = [t.numpy() for group in tpg.graph_factor_blocks(tg, tg.poses)
           for t in group]
    assert [a.shape for a in got] == [a.shape for a in want]
    for a, b in zip(got, want):
        assert a.dtype == np.float32
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b))
        assert np.isfinite(a).all() or case == "near_pi_axis"
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    if case == "identity":
        np.testing.assert_array_equal(got[0][:, :3], 0.0)
    if case == "near_pi_axis":
        assert np.isnan(got[1]).any()


@pytest.mark.parametrize("kind", ["chain", "gps", "loop"])
def test_optimize_pose_graph_matches_jax(kind):
    g, gt, K_active = _chain(noise=0.05 if kind == "loop" else
                             0.0 if kind == "gps" else 0.02,
                             loop=kind == "loop")
    if kind == "gps":
        btw_meas = np.array(g.btw_meas)
        btw_meas[:K_active - 1, 3] *= 1.05      # 5% scale drift
        gps_idx = np.zeros(256, np.int32)
        gps_meas = np.zeros((256, 3), np.float32)
        gps_mask = np.zeros(256, bool)
        for n, k in enumerate([3, 6, 9, 12, 15, 19]):
            gps_idx[n], gps_meas[n], gps_mask[n] = k, gt[k, 3:], True
        g = g._replace(btw_meas=jnp.asarray(btw_meas),
                       gps_idx=jnp.asarray(gps_idx),
                       gps_meas=jnp.asarray(gps_meas),
                       gps_sigma=jnp.full((256, 3), 0.01, jnp.float32),
                       gps_mask=jnp.asarray(gps_mask))
    jp, jc = map(np.asarray, jpg.optimize_pose_graph(g, FULL_ITERATIONS))
    tp, tc = tpg.optimize_pose_graph(_port_graph(g), FULL_ITERATIONS)
    np.testing.assert_allclose(tp.numpy(), jp, atol=1e-4, rtol=0)
    err = np.linalg.norm(tp.numpy()[:K_active, 3:] - gt[:, 3:], axis=1)
    if kind == "chain":
        assert err.max() < 1e-3 and float(tc) < 1e-4
    elif kind == "loop":
        assert err.max() < 1e-2
    else:
        assert err.max() < 0.6 * 0.25       # tests/test_graph.py's bounds


def test_lm_rejects_non_finite_jacobian_like_jax():
    """Pose 5 of the chain at pitch pi/2 (gimbal lock): asin's derivative
    in the between factors' relative rotation is infinite, H is not
    finite, the Cholesky fails; JAX's NaN solve rejects every step, and so
    does the port, without raising."""
    g, _, _ = _chain(noise=0.02)
    poses = np.array(g.poses)
    poses[4, :2] = 0.0
    poses[5, :3] = [0.0, np.float32(np.pi / 2), poses[4, 2]]
    g = g._replace(poses=jnp.asarray(poses))
    tg = _port_graph(g)
    H, _, cost = tpg._assemble(tg, tg.poses, tg.poses.shape[0])
    assert not torch.isfinite(H).all() and torch.isfinite(cost)
    jp, jc = map(np.asarray, jpg.optimize_pose_graph(g, FULL_ITERATIONS))
    tp, tc = tpg.optimize_pose_graph(tg, FULL_ITERATIONS)
    np.testing.assert_array_equal(jp, poses)
    np.testing.assert_array_equal(tp.numpy(), poses)
    assert float(tc) == pytest.approx(float(jc), rel=1e-6)


def test_lm_rejects_a_failed_factorization(monkeypatch):
    """Where the JAX solve (assume_a="pos") returns NaN, torch.linalg.
    cholesky would raise; the port uses cholesky_ex and rejects the step.
    Forced here: the factorization reports failure with a finite L whose
    step (plain gradient descent) would lower the cost."""
    g, _, _ = _chain(noise=0.02)
    tg = _port_graph(g)
    cost0 = tpg._total_cost(tg, tg.poses)
    real = torch.linalg.cholesky_ex

    def failed(A):
        return torch.eye(A.shape[0]), torch.ones((), dtype=torch.int32)

    descent = tpg.optimize_pose_graph(tg, 1)
    monkeypatch.setattr(torch.linalg, "cholesky_ex", failed)
    poses, cost = tpg.optimize_pose_graph(tg, 1)
    monkeypatch.setattr(torch.linalg, "cholesky_ex", real)
    assert float(descent[1]) < float(cost0)
    # the garbage step would have lowered the cost too: accepted only if
    # the failure flag were ignored
    K = tg.poses.shape[0]
    Hd, grad, _ = tpg._assemble(tg, tg.poses, K)
    d = torch.sqrt(torch.clamp(torch.diagonal(Hd), min=1e-12)) + torch.where(
        tg.pose_mask.repeat_interleave(6), 0.0, 1.0)
    step = torch.where(tg.pose_mask.repeat_interleave(6), -grad / d / d, 0.0)
    assert float(tpg._total_cost(tg, tg.poses + step.reshape(K, 6))) < float(
        cost0)
    assert torch.equal(poses, tg.poses) and float(cost) == float(cost0)


def test_pose_marginal_covariances_match_jax():
    sigma = np.array([0.1, 0.1, 0.2, 0.5, 0.5, 1.0], np.float32)
    prior = _full_shape(jpg.PoseGraphData.empty(4, Fp=1, Fb=3, Fg=2)._replace(
        pose_mask=jnp.asarray([True, False, False, False]),
        prior_idx=jnp.asarray([0], jnp.int32),
        prior_sigma=jnp.asarray(sigma[None]), prior_mask=jnp.asarray([True])))
    gps = prior._replace(gps_sigma=prior.gps_sigma.at[0].set(0.1),
                         gps_mask=prior.gps_mask.at[0].set(True))
    chain, _, K_active = _chain(noise=0.02, loop=True)
    for g, idxs, active in ((prior, [0], 4), (gps, [0], 4),
                            (chain, [0, 7, K_active - 1], K_active)):
        poses = np.asarray(g.poses)
        want = jpg.pose_marginal_covariances(g, poses, idxs, active=active)
        got = tpg.pose_marginal_covariances(_port_graph(g), poses, idxs,
                                            active=active)
        for a, b in zip(got, want):
            assert a.dtype == np.float64
            np.testing.assert_allclose(a, b, rtol=1e-6,
                                       atol=1e-6 * np.abs(b).max())
    np.testing.assert_allclose(np.diag(got[0]), 0.0, atol=1.0)
    np.testing.assert_allclose(
        np.diag(tpg.pose_marginal_covariance(_port_graph(prior),
                                             np.zeros((32, 6)), 0,
                                             active=4)),
        sigma.astype(np.float64) ** 2, rtol=1e-4)


# ------------------------------------------------------- SLAM policies

def _tiny_feats(rng, n_corner=8, n_surf=16):
    return ScanFeatures(
        corner_xyz=T(rng.normal(size=(n_corner, 3)).astype(np.float32)),
        corner_mask=torch.ones(n_corner, dtype=torch.bool),
        surf_xyz=T(rng.normal(size=(n_surf, 3)).astype(np.float32)),
        surf_mask=torch.ones(n_surf, dtype=torch.bool))


def _drive_keyframes(pipe, n, step=1.5, start=0):
    rng = np.random.default_rng(0)
    for k in range(start, start + n):
        pipe.pose = np.array([0, 0, 0, step * k, 0, 0], np.float32)
        pipe._save_keyframe(_tiny_feats(rng), 0.5 * k)


def _policy_pipe(**kw):
    return tslam.SlamPipeline(Params(), kf_corner_cap=8, kf_surf_cap=16,
                              device=CPU, **kw)


def test_keyframe_eviction_bounds_storage():
    pipe = _policy_pipe(max_keyframes=8, opt_window=4)
    _drive_keyframes(pipe, 14)
    assert pipe.n_keyframes == 8
    n = pipe.n_keyframes
    xs = pipe.kf_poses[:n, 3]
    assert xs[-1] > 19.0                      # 13 * 1.5 = 19.5
    np.testing.assert_allclose(np.diff(xs), 1.5, atol=0.05)
    i, meas, sigma = pipe.prior_factor
    assert i == 0 and np.all(sigma > 0)
    np.testing.assert_allclose(meas[3], xs[0], atol=0.05)
    # the device mirror follows the shifted host store
    dev = pipe._device_clouds()
    np.testing.assert_array_equal(dev[2].numpy(), pipe.kf_surf)


def test_eviction_reindexes_and_drops_factors():
    log = tlog.EventLog()
    pipe = _policy_pipe(max_keyframes=12, opt_window=4)
    pipe._log = log
    _drive_keyframes(pipe, 11)
    rel = np.zeros(6, np.float32)
    sig = np.full(6, 0.1, np.float32)
    pipe.loop_factors += [(0, 1, rel, sig), (9, 10, rel, sig)]
    pipe.gps_factors += [(1, np.zeros(3, np.float32), np.ones(3, np.float32)),
                         (10, np.zeros(3, np.float32),
                          np.ones(3, np.float32))]
    _drive_keyframes(pipe, 2, start=11)
    assert pipe.n_keyframes == 12
    assert [f[:2] for f in pipe.loop_factors] == [(8, 9)]
    assert [f[0] for f in pipe.gps_factors] == [0, 9]
    dropped = log.drain("mapping/evict_dropped_factors")
    assert [(e["dropped"], e["evicted"]) for e in dropped] == [(1, 1)]


def test_factor_overflow_keeps_odometry_chain():
    log = tlog.EventLog()
    pipe = _policy_pipe(max_keyframes=8, opt_window=4, loop_factor_cap=2)
    pipe._log = log
    _drive_keyframes(pipe, 8)
    n = pipe.n_keyframes
    rel = np.zeros(6, np.float32)
    sig = np.full(6, 0.1, np.float32)
    pipe.loop_factors += [(0, n - 1, rel, sig)] * 12
    g = pipe._graph_data()
    present = {(int(i), int(j)) for i, j, m in zip(g.btw_i, g.btw_j,
                                                   g.btw_mask) if m}
    assert {(j - 1, j) for j in range(1, n)} <= present
    assert int(g.btw_mask.sum()) == (n - 1) + min(12, 10 - (n - 1))
    assert log.drain("mapping/factor_overflow")[0]["dropped"] == 12 - 3


def test_surrounding_density_thins_keyposes():
    pipe = _policy_pipe(max_keyframes=32, opt_window=4)
    poses = [[0, 0, 0, 10.0 * c + 0.05 * k, 0.02 * k, 0]
             for c in range(4) for k in range(4)]
    pipe.kf_poses[:16] = np.array(poses, np.float32)
    pipe.n_keyframes = 16
    keep = pipe._thin_poses(np.arange(16), leaf=2.0)
    assert sorted(k // 4 for k in keep) == [0, 1, 2, 3]
    assert len(pipe._thin_poses(np.arange(16), leaf=0.0)) == 16


def test_gps_pose_cov_gate():
    rng = np.random.RandomState(0)
    pipe = tslam.SlamPipeline(Params(pose_cov_threshold=25.0),
                              max_keyframes=16, device=CPU)
    for pose, t in ((np.zeros(6, np.float32), 0.0),
                    (np.array([0, 0, 0, 6.0, 0, 0], np.float32), 1.0)):
        pipe.pose = pose
        pipe._save_keyframe(_tiny_feats(rng), t)
    pipe.pose_cov = np.eye(6) * 1e-4          # confident: GPS rejected
    pipe.add_gps(2.0, np.array([6.0, 0.0, 0.0]), np.full(3, 0.04))
    pipe._add_gps_factor(2.0)
    assert len(pipe.gps_factors) == 0
    pipe.pose_cov = np.eye(6) * 100.0         # drifted: GPS accepted
    pipe._add_gps_factor(2.0)
    assert len(pipe.gps_factors) == 1 and pipe.a_loop_is_closed


# ------------------------------------------------- steps against JAX

def _raw(world, pose, seed):
    s = simulate_scan(world, pose, seed=seed)
    return RawScan.from_numpy(s["xyz"], s["intensity"], s["ring"],
                              s["time"])._replace(valid=jnp.asarray(
                                  s["valid"]))


def _port_frontend(params, scan, deskew_info=None):
    """JAX `process_scan`'s place in the JAX pipeline: the port's frontend
    on the same scan, its features handed over as JAX arrays."""
    raw = to_torch(jax.tree.map(np.asarray, scan), device=CPU)
    _, feats = tfront.process_scan(params, TRawScan(*(a[None] for a in raw)),
                                   deskew_info)
    return None, JScanFeatures(*(jnp.asarray(a[0].numpy()) for a in feats))


@pytest.fixture(scope="module")
def slam_runs(tmp_path_factory):
    """Both pipelines through 5 steps of the SLAM trajectory of
    tests/test_pipeline.py (0.25 m / 0.04 rad apart: the no-IMU guess),
    once per module, each with its own event log; then save_map.  The JAX
    pipeline's frontend is the port's (strict picking, default Params), so
    both back ends get the same features: the frontends have their own
    parity tests, and the JAX package's jitted strict curvature differs
    from the serial order (ROADMAP Queue 3), a label of which moves a pose
    by ~1e-5 that the 0.05 cm convergence test then lets grow."""
    world = SyntheticWorld()
    logs = (jlog.EventLog(), tlog.EventLog())
    jpipe = jslam.SlamPipeline(PARAMS, **CAPS)
    tpipe = tslam.SlamPipeline(PARAMS, device=CPU, **CAPS)
    jpipe._log, tpipe._log = logs
    poses, n_kf = [], []
    jax_frontend = jslam.process_scan
    jslam.process_scan = _port_frontend
    try:
        for k, gt in enumerate(_trajectory(5, step=0.25, yaw_rate=0.04)):
            raw = _raw(world, gt, seed=10 + k)
            want = jpipe.step(raw, 0.2 * k).copy()
            got = tpipe.step(to_torch(jax.tree.map(np.asarray, raw),
                                      device=CPU), 0.2 * k).copy()
            poses.append((got, want))
            n_kf.append((tpipe.n_keyframes, jpipe.n_keyframes))
    finally:
        jslam.process_scan = jax_frontend
    dirs = [str(tmp_path_factory.mktemp(name)) for name in ("jax", "port")]
    jpipe.save_map(dirs[0])
    tpipe.save_map(dirs[1])
    return jpipe, tpipe, poses, n_kf, logs, dirs


def test_slam_steps_match_jax(slam_runs):
    jpipe, tpipe, poses, n_kf, logs, _ = slam_runs
    for got, want in poses:
        assert got.dtype == np.float32 and got.shape == (6,)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert [a for a, _ in n_kf] == [b for _, b in n_kf]
    assert n_kf[-1][0] == 2
    jev = [(e["topic"], e["level"]) for e in logs[0].events]
    tev = [(e["topic"], e["level"]) for e in logs[1].events
           if e["topic"] != "mapping/dropped_points"]
    assert tev == jev
    odo = [e for e in logs[1].events if e["topic"] == "mapping/odometry"]
    assert len(odo) == 4 and odo[-1]["gate_valid"] is True
    assert set(odo[0]) == {"t", "topic", "level", "time", "pose", "n_corr",
                           "iterations", "converged", "degenerate",
                           "gate_valid", "reset_id"}
    # tests/test_pipeline.py's tracking bound
    gt = np.stack(_trajectory(5, step=0.25, yaw_rate=0.04))
    est = np.stack([g for g, _ in poses])
    rel = np.linalg.norm(np.diff(est[:, 3:], axis=0)
                         - np.diff(gt[:, 3:], axis=0), axis=1)
    assert rel.max() < 0.12
    np.testing.assert_allclose(tpipe.kf_poses, jpipe.kf_poses, atol=1e-4)


def test_save_map_writes_what_jax_writes(slam_runs):
    *_, dirs = slam_runs
    names = sorted(os.listdir(dirs[0]))
    assert sorted(os.listdir(dirs[1])) == names
    for name in names:
        a, b = (os.path.join(d, name) for d in dirs)
        if name.endswith(".pcd"):
            want, got = read_pcd(a), read_pcd(b)
            assert list(got) == list(want)
            for field in want:
                np.testing.assert_allclose(got[field], want[field],
                                           atol=1e-4, rtol=0)
        else:
            want, got = np.load(a), np.load(b)
            assert sorted(got.files) == sorted(want.files)
            for key in want.files:
                if want[key].dtype == bool:
                    np.testing.assert_array_equal(got[key], want[key])
                else:
                    np.testing.assert_allclose(got[key], want[key],
                                               atol=1e-4, rtol=0)


def test_slam_state_carries_to_the_port(slam_runs):
    """convert.slam_state_to_torch: a port pipeline started from the JAX
    pipeline's host state solves the same window graph."""
    jpipe, tpipe, *_ = slam_runs
    fresh = slam_state_to_torch(
        jpipe, tslam.SlamPipeline(PARAMS, device=CPU, **CAPS))
    assert fresh.n_keyframes == jpipe.n_keyframes
    np.testing.assert_array_equal(fresh.kf_surf, jpipe.kf_surf)
    g, lo = fresh._window_graph_data()
    jg, jlo = jpipe._window_graph_data()
    assert lo == jlo
    for a, b in zip(g, jg):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(fresh._device_clouds()[0].numpy(),
                                  jpipe.kf_corner)


# ------------------------------------------------------ loop closure

def _revisit():
    """tests/test_incremental_graph.py's revisit: two walls and posts,
    an out-and-back line of 11 keyframes, the last one drifted."""
    rng = np.random.RandomState(7)
    n_w = 600
    world = np.concatenate([
        np.stack([rng.uniform(-8, 8, n_w), np.full(n_w, 6.0),
                  rng.uniform(0, 3, n_w)], -1),
        np.stack([np.full(n_w, -7.0), rng.uniform(-8, 8, n_w),
                  rng.uniform(0, 3, n_w)], -1),
        rng.uniform(-6, 6, (120, 3)) * np.array([1, 1, 0.25])
    ]).astype(np.float32)
    gts = [np.array([0, 0, 0, 1.2 * k, 0, 0], np.float32) for k in range(6)]
    gts += [np.array([0, 0, 0, 1.2 * (4 - k), 0.4, 0], np.float32)
            for k in range(5)]
    feats = []
    for gt in gts:
        T_inv = np.array(jse3.inverse_matrix(jse3.pose6_to_matrix(
            jnp.asarray(gt))))
        local = world @ T_inv[:3, :3].T + T_inv[:3, 3]
        pts = local[np.linalg.norm(local, axis=1) < 12.0]
        n_c = min(len(pts) // 4, 256)
        feats.append((pts[:n_c], pts[n_c:]))
    return gts, feats


def test_loop_closure_matches_jax():
    # a 0.2 m submap leaf: the JAX test's 0.02 m puts the ICP fitness at
    # ~1e-6, the float32 noise of the streamed d2, and the loop factor's
    # sigma = sqrt(fitness) with it; at 0.2 m the fitness is ~1.4e-3 and
    # the correction still large
    params = Params(loop_closure_enable_flag=True,
                    history_keyframe_search_time_diff=3.0,
                    history_keyframe_search_num=3,
                    mapping_surf_leaf_size=0.2)
    gts, feats = _revisit()
    drift = np.array([0, 0, 0, 0.4, -0.3, 0.0], np.float32)
    # loop_submap_cap 8192 (source cap 2048) holds every point of this
    # world's submaps at the default's half the streamed work
    jpipe = jslam.SlamPipeline(params, loop_submap_cap=8192, **CAPS)
    tpipe = tslam.SlamPipeline(params, device=CPU, loop_submap_cap=8192,
                               **CAPS)
    for k, (gt, (c, s)) in enumerate(zip(gts, feats)):
        est = gt + (drift if k == len(gts) - 1 else 0.0)
        for pipe, f in ((jpipe, JScanFeatures(
                jnp.asarray(c), jnp.ones(len(c), bool), jnp.asarray(s),
                jnp.ones(len(s), bool))), (tpipe, ScanFeatures(
                T(c), torch.ones(len(c), dtype=torch.bool), T(s),
                torch.ones(len(s), dtype=torch.bool)))):
            pipe.pose = est.copy()
            pipe._save_keyframe(f, float(k))
    np.testing.assert_allclose(tpipe.kf_poses, jpipe.kf_poses, atol=1e-4)
    cur = tpipe.n_keyframes - 1

    def rel_err(pipe):
        rel = pipe.kf_poses[cur, 3:] - pipe.kf_poses[0, 3:]
        return np.linalg.norm(rel - (gts[-1][3:] - gts[0][3:]))

    before = rel_err(tpipe)
    t = float(len(gts) - 1)
    assert jpipe.maybe_close_loop(t) and tpipe.maybe_close_loop(t)
    assert tpipe.reset_id == jpipe.reset_id == 1
    (ti, tj, tm, ts), = tpipe.loop_factors
    (ji, jj, jm, js), = jpipe.loop_factors
    assert (ti, tj) == (ji, jj)
    np.testing.assert_allclose(tm, jm, atol=1e-4)
    np.testing.assert_allclose(ts, js, atol=1e-5)
    np.testing.assert_allclose(tpipe.kf_poses, jpipe.kf_poses, atol=1e-4)
    assert float(tpipe.last_icp.fitness) < params.history_keyframe_fitness_score
    assert rel_err(tpipe) < 0.7 * before


# ------------------------------------------------------------- the caps

def _events(log, topic):
    return [e for e in log.events if e["topic"] == topic]


def test_localization_reports_crop_and_cell_caps():
    """A map with more corner points in the crop box than the cap and a
    dense cluster inside one 2 m grid cell: the step warns for both."""
    world = SyntheticWorld()
    corner = world.corner_map_points(0.12)
    surf = world.surf_map_points(0.35)
    rng = np.random.RandomState(0)
    # 40 corners inside the grid cell [3, 5) x [3.5, 5.5) x [0, 2) of the
    # tables around the step's pose: ~27 voxels of 0.2 m, cap 16
    blob = (rng.uniform(-0.3, 0.3, (40, 3)) + [4.0, 4.5, 1.0]).astype(
        np.float32)
    corner = np.concatenate([corner, blob])
    gm = tloc.GlobalMap.from_arrays(PARAMS, corner, surf, corner_cap=4096,
                                    surf_cap=65536, device=CPU)
    n_c = int(gm.corner_mask.sum())
    tight = dataclasses.replace(PARAMS, map_corner_cap=n_c - 100)
    gt = np.array([0.0, 0.0, 0.3, 1.0, -0.5, 0.0], np.float32)
    raw = to_torch(jax.tree.map(np.asarray, _raw(world, gt, seed=4)),
                   device=CPU)
    log = tlog.EventLog()
    tlog.set_logger(log)
    try:
        pipe = tloc.LocalizationPipeline(tight, gm)
        pipe.pose = gt.copy()
        pipe.step(raw, 0.0)
    finally:
        tlog.set_logger(None)
    warns = _events(log, "localization/dropped_points")
    crop = [e for e in warns if e["cap"] == "crop"]
    assert [(e["feature"], e["dropped"], e["kept"]) for e in crop] == [
        ("corner", 100, n_c - 100)]
    cells = [e for e in warns if e["cap"] == "grid_cell"]
    assert "corner" in [e["feature"] for e in cells]
    assert all(e["level"] == "warn" and e["dropped_share"] > 0
               for e in cells)


def test_slam_reports_keyframe_and_local_map_caps(slam_runs):
    """The 5 steps above: the default kf_surf_cap (4096) truncates the
    keyframes, as the JAX package does silently; a local map over a
    reduced voxel cap is reported too."""
    jpipe, tpipe, _, _, logs, _ = slam_runs
    kf = [e for e in _events(logs[1], "mapping/dropped_points")
          if e["cap"] == "keyframe"]
    assert kf and all(e["kept"] == tpipe.kf_surf_cap for e in kf
                      if e["feature"] == "surf")
    np.testing.assert_array_equal(tpipe.kf_surf_mask, jpipe.kf_surf_mask)
    assert tpipe.kf_surf_mask[0].all()       # full: features were dropped

    small = dataclasses.replace(PARAMS, map_surf_cap=2048)
    pipe = slam_state_to_torch(jpipe, tslam.SlamPipeline(
        small, device=CPU, **CAPS))
    log = tlog.EventLog()
    pipe._log = log
    local_map, n_vox = pipe._surrounding_map()
    assert int(local_map.surf_mask.sum()) == 2048 < int(n_vox[1])
    pipe.time_last_processing = -1.0
    world = SyntheticWorld()
    raw = to_torch(jax.tree.map(np.asarray, _raw(
        world, _trajectory(5, step=0.25, yaw_rate=0.04)[4], seed=14)),
        device=CPU)
    pipe.step(raw, 10.0)
    lm = [e for e in _events(log, "mapping/dropped_points")
          if e["cap"] == "local_map"]
    assert [(e["feature"], e["kept"]) for e in lm] == [("surf", 2048)]
    assert lm[0]["dropped"] == int(n_vox[1]) - 2048
