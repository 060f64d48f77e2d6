"""Port parity: the exact verification solver and the loop-closure aligner.

Each test feeds the same numpy-seeded inputs to the JAX function and the
port's, on the CPU.  Tolerances (float32 throughout):

  * `ops/knn.py::knn` / `knn5_points`: d2 within 1e-6 of the terms the
    formula |q|^2 + |m|^2 - 2 q.m cancels, i.e. |dd2| <= 1e-6 * (|q-c|^2 +
    |m-c|^2) with c the query centroid (~8 float32 ulps of those terms;
    XLA's CPU backend contracts the norms into FMAs and PyTorch does not,
    so small d2 differ by more than 1e-6 of themselves); indices equal
    except where the two d2 lie within that tolerance of a tie, and every
    such index difference is printed; exact ties (duplicate points) go to
    the lower index in both.
  * `_extract_topk`: the same values and indices as a stable sort.
  * `corner_correspondence` / `surf_correspondence` with a `knn_fn`: masks
    equal, coefficients and residuals within 1e-5.
  * `register_scan` on two scans: pose within 1e-5, equal iterations and
    n_corr; except that a correspondence whose 5th-NN d2 or plane residual
    lies within float32 rounding of its gate can flip (XLA's FMAs again):
    then n_corr differs by exactly that one and the pose by at most 1e-4
    (the test prints it; one of the two scans must match to 1e-5).  Each
    within 3e-3 m / rad of the serial NumPy oracle (the bound of
    tests/test_register.py); the sparse-scan gate; the IMU epilogue of
    `register_scan_with_params` (1e-6 of JAX `transform_update` on the
    solve's pose) on gated lanes only.
  * `parallel/batch.py::batch_register` with a shared map and with one map
    per scan: each lane bitwise equal to the port's `register_scan` of that
    lane, and against JAX `register_scan` on that lane's map (the function
    JAX's batch_register vmaps) as above.
  * `ops/icp.py::icp_align`: transform within 1e-5, equal converged and
    iterations, fitness within 1e-6; the max-iterations and
    no-correspondence cases of tests/test_slam_policies.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from feature_base_pointcloud_registration_tpu.config import Params
from feature_base_pointcloud_registration_tpu.ops import (
    correspondence as jcorr, icp as jicp, knn as jknn, register as jreg)
from feature_base_pointcloud_registration_tpu.pipeline.cloud_info import (
    FeatureMap as JFeatureMap, ScanFeatures as JScanFeatures)
from feature_base_pointcloud_registration_tpu_torch.io.synthetic import (
    SyntheticWorld, build_feature_map, pose6_to_matrix_np, simulate_scan)
from feature_base_pointcloud_registration_tpu_torch.ops import (
    correspondence as tcorr, icp as ticp, knn as tknn, register as treg)
from feature_base_pointcloud_registration_tpu_torch.parallel.batch import (
    batch_register)
from feature_base_pointcloud_registration_tpu_torch.pipeline.cloud_info import (
    FeatureMap, RawScan, ScanFeatures)
from feature_base_pointcloud_registration_tpu_torch.pipeline.frontend import (
    process_scan)
import oracle
from test_torch_batch import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
T = torch.from_numpy
CHUNK = 2048
PARAMS = Params(corner_cap=512, surf_cap=1024, knn_chunk=CHUNK,
                strict_feature_pick=False)


# ------------------------------------------------------------------ knn

def _knn_case(seed, M, n_query=300, offset=100.0):
    r = np.random.RandomState(seed)
    q = (r.uniform(-20, 20, (n_query, 3)) + offset).astype(np.float32)
    ref = (r.uniform(-20, 20, (M, 3)) + offset).astype(np.float32)
    ref[5:9] = ref[4]                         # exact ties: duplicates
    q[0] = ref[4]
    mask = r.uniform(size=M) < 0.8
    mask[4:9] = True
    return q, ref, mask


def _d2_tolerance(q, ref, idx):
    """1e-6 of |q-c|^2 + |m-c|^2 per (query, neighbor), c the centroid."""
    c = q.astype(np.float64).mean(0)
    qn = ((q - c) ** 2).sum(-1)[:, None]
    mn = ((ref.astype(np.float64)[idx] - c) ** 2).sum(-1)
    return 1e-6 * (qn + mn)


def _check_knn(q, ref, d2_t, idx_t, d2_j, idx_j):
    tol = _d2_tolerance(q, ref, idx_j)
    assert (np.abs(d2_t.astype(np.float64) - d2_j) <= tol).all()
    diff = np.argwhere(idx_t != idx_j)
    for i, j in diff:
        # a swapped pair: both packages' d2 of both points within tol
        exact = ((ref[idx_t[i, j]] - q[i]) ** 2).sum() - (
            (ref[idx_j[i, j]] - q[i]) ** 2).sum()
        assert abs(exact) <= 2 * tol[i, j], (i, j)
    print(f"knn: {len(diff)} index differences at near-ties of "
          f"{idx_j.size}")
    return len(diff)


@pytest.mark.parametrize("M,k", [(2048, 5), (8192, 5), (8192, 1),
                                 (4096, 16)])
def test_knn_matches_jax(M, k):
    q, ref, mask = _knn_case(M + k, M)
    d2_j, idx_j = map(np.asarray, jknn.knn(
        jnp.asarray(q), jnp.asarray(ref), jnp.asarray(mask), k=k,
        chunk=CHUNK))
    d2_t, idx_t = tknn.knn(T(q), T(ref), T(mask), k=k, chunk=CHUNK)
    assert idx_t.dtype == torch.int32 and d2_t.shape == (len(q), k)
    assert _check_knn(q, ref, d2_t.numpy(), idx_t.numpy(), d2_j,
                      idx_j) <= 2
    # the query on the duplicated point: the lowest of the tied indices
    assert idx_t[0, 0] == 4 and idx_j[0, 0] == 4
    assert d2_t[0, 0] <= _d2_tolerance(q, ref, idx_j)[0, 0]
    assert mask[idx_t.numpy()[d2_t.numpy() < 1e37]].all()


def test_knn_batched_maps_match_per_set():
    """Leading batch dims: two query sets, one map each, against a per-set
    call, and the shared-map broadcast."""
    q0, ref0, m0 = _knn_case(1, 4096)
    q1, ref1, m1 = _knn_case(2, 4096)
    d2, idx = tknn.knn(T(np.stack([q0, q1])), T(np.stack([ref0, ref1])),
                       T(np.stack([m0, m1])), chunk=CHUNK)
    for b, (q, ref, m) in enumerate(((q0, ref0, m0), (q1, ref1, m1))):
        want = tknn.knn(T(q), T(ref), T(m), chunk=CHUNK)
        assert torch.equal(d2[b], want[0]) and torch.equal(idx[b], want[1])
    d2s, nns = tknn.knn5_points(T(np.stack([q0, q1])), T(ref0), T(m0),
                                chunk=CHUNK)
    want = tknn.knn5_points(T(q1), T(ref0), T(m0), chunk=CHUNK)
    assert torch.equal(d2s[1], want[0]) and torch.equal(nns[1], want[1])


def test_knn5_points_matches_jax():
    q, ref, mask = _knn_case(7, 8192)
    d2_j, nn_j = map(np.asarray, jknn.knn5_points(
        jnp.asarray(q), jnp.asarray(ref), jnp.asarray(mask), chunk=CHUNK))
    _, idx_j = map(np.asarray, jknn.knn(jnp.asarray(q), jnp.asarray(ref),
                                        jnp.asarray(mask), k=5, chunk=CHUNK))
    d2_t, nn_t = tknn.knn5_points(T(q), T(ref), T(mask), chunk=CHUNK)
    _, idx_t = tknn.knn(T(q), T(ref), T(mask), k=5, chunk=CHUNK)
    _check_knn(q, ref, d2_t.numpy(), idx_t.numpy(), d2_j, idx_j)
    same = idx_t.numpy() == idx_j
    np.testing.assert_array_equal(nn_t.numpy()[same], nn_j[same])
    np.testing.assert_array_equal(nn_t.numpy(), ref[idx_t.numpy()])


def test_extract_topk_is_a_stable_sort():
    r = np.random.RandomState(3)
    d = r.randint(0, 6, (64, 200)).astype(np.float32)
    d[:, 50:60] = 3.0e38
    d[0, :4] = -0.0
    d[1] = 3.0e38
    for k in (1, 5, 16):
        v, i = tknn._extract_topk(T(d), k)
        vs, is_ = torch.sort(T(d + 0.0), dim=1, stable=True)
        assert torch.equal(v, vs[:, :k]) and torch.equal(i.long(),
                                                         is_[:, :k])


# ----------------------------------------------------- scan and map scene

@pytest.fixture(scope="module")
def scene():
    """Two scans' features (the port's fast frontend) and the room's map,
    as numpy, for both packages.  The room is 20 x 20 m (not the default
    50 x 50): the exact solve streams the whole map every iteration, and
    this keeps the map at 10240 surf slots."""
    world = SyntheticWorld(half_x=10.0, half_y=10.0)
    feats, gts = [], []
    for seed, pose in ((5, [0.0, 0.0, -0.3, -1.0, 2.5, 0.0]),
                       (9, [0.0, 0.0, 0.25, 2.0, -1.0, 0.0])):
        pose = np.array(pose, np.float32)
        s = simulate_scan(world, pose, seed=seed)
        raw = RawScan.from_numpy(s["xyz"], s["intensity"], s["ring"],
                                 s["time"], device=CPU)._replace(
            valid=T(s["valid"]))
        _, f = process_scan(PARAMS, RawScan(*(a[None] for a in raw)))
        feats.append([a[0].numpy() for a in f])
        gts.append(pose)
    fmap = build_feature_map(world, 2048, 10240)
    return feats, fmap, gts


def _jax_feats(f):
    return JScanFeatures(*map(jnp.asarray, f))


def _port_feats(*fs):
    return ScanFeatures(*(T(np.stack(a)) for a in zip(*fs)))


def test_correspondences_with_knn_fn_match_jax(scene):
    feats, fmap, gts = scene
    f = [a[::4] for a in feats[0]]             # every 4th feature
    Tw = pose6_to_matrix_np(gts[0] + np.float32(0.02))
    for xyz, mask, mx, mm, name in ((f[0], f[1], fmap[0], fmap[1], "corner"),
                                    (f[2], f[3], fmap[2], fmap[3], "surf")):
        pw = (xyz @ Tw[:3, :3].T + Tw[:3, 3]).astype(np.float32)
        fn = getattr(jcorr, f"{name}_correspondence")
        want = [np.asarray(a) for a in jax.jit(
            lambda p, v, x, m: fn(p, v, jknn.make_local_knn(x, m, CHUNK)))(
            *map(jnp.asarray, (pw, mask, mx, mm)))]
        got = getattr(tcorr, f"{name}_correspondence")(
            T(pw)[None], T(mask)[None],
            tknn.make_local_knn(T(mx), T(mm), CHUNK))
        assert got[0].shape == (1, len(pw), 3)
        np.testing.assert_array_equal(got[2][0].numpy(), want[2])
        assert want[2].sum() > 0.5 * mask.sum()
        for g, w in zip(got[:2], want[:2]):
            np.testing.assert_allclose(g[0].numpy(), w, atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def registered(scene):
    """JAX register_scan of both scans (each guess off the truth), once."""
    feats, fmap, gts = scene
    jmap = JFeatureMap(*map(jnp.asarray, fmap))
    offs = (np.array([0.01, 0.01, -0.03, 0.2, 0.2, -0.1], np.float32),
            np.array([0.015, -0.01, 0.04, 0.3, -0.25, 0.1], np.float32))
    guesses = [g + o for g, o in zip(gts, offs)]
    want = [jax.tree.map(np.asarray, jreg.register_scan(
        _jax_feats(f), jmap, jnp.asarray(g), chunk=CHUNK))
        for f, g in zip(feats, guesses)]
    return guesses, want


def _matches_jax(got, lane, want):
    """The port's result of `lane` against a JAX RegisterResult: 1e-5 with
    equal n_corr, or 1e-4 with one gate flip.  Returns whether strict."""
    d = np.abs(got.pose6[lane].numpy() - want.pose6).max()
    dn = int(got.n_corr[lane]) - int(want.n_corr)
    assert int(got.iterations[lane]) == int(want.iterations)
    assert bool(got.converged[lane]) == bool(want.converged)
    if dn:
        print(f"register_scan: n_corr {int(got.n_corr[lane])} vs JAX "
              f"{int(want.n_corr)}, pose |diff| {d:.3e}")
    assert (dn == 0 and d <= 1e-5) or (abs(dn) == 1 and d <= 1e-4), (dn, d)
    return dn == 0


@pytest.fixture(scope="module")
def port_registered(scene, registered):
    """The port's exact solve of both scans as one batch on the shared map
    (`batch_register` -> `register_scan` -> `register_core`)."""
    feats, fmap, _ = scene
    guesses, _ = registered
    return batch_register(_port_feats(*feats), FeatureMap(*map(T, fmap)),
                          T(np.stack(guesses)), chunk=CHUNK)


@pytest.mark.parametrize("lane", [0, 1])
def test_register_scan_matches_jax_and_oracle(scene, registered,
                                              port_registered, lane):
    feats, fmap, _ = scene
    guesses, want = registered
    got = port_registered
    _matches_jax(got, lane, want[lane])
    assert bool(got.valid[lane]) and int(got.n_corr[lane]) > 100
    f = feats[lane]
    pose_ref, _ = oracle.register_scan(
        f[0][f[1]], f[2][f[3]], fmap[0][fmap[1]], fmap[2][fmap[3]],
        guesses[lane])
    pose = got.pose6[lane].numpy()
    assert np.linalg.norm(pose[3:] - pose_ref[3:]) < 3e-3
    assert np.linalg.norm(pose[:3] - pose_ref[:3]) < 3e-3


def test_register_scan_strict_on_one_scan(registered, port_registered):
    _, want = registered
    assert any(_matches_jax(port_registered, b, want[b]) for b in range(2))


def test_register_scan_gate_on_sparse_scan(scene):
    feats, fmap, _ = scene
    f = feats[0]
    empty = [f[0], np.zeros_like(f[1]), f[2], np.zeros_like(f[3])]
    guess = np.array([0.1, 0.0, 0.0, 1.0, 2.0, 3.0], np.float32)
    want = jax.tree.map(np.asarray, jreg.register_scan(
        _jax_feats(empty), JFeatureMap(*map(jnp.asarray, fmap)),
        jnp.asarray(guess), chunk=CHUNK))
    got = treg.register_scan(_port_feats(empty), FeatureMap(*map(T, fmap)),
                             T(guess[None]), chunk=CHUNK)
    assert not bool(got.valid[0]) and not bool(want.valid)
    np.testing.assert_array_equal(got.pose6[0].numpy(), guess)
    np.testing.assert_array_equal(want.pose6, guess)
    assert int(got.iterations[0]) == int(want.iterations) == 0


def test_register_scan_with_params_epilogue(scene, registered):
    """The IMU fusion runs on the lane through the gate and leaves the
    gated-off lane's pose as it is (ref :1438), as in JAX; one GN
    iteration, the epilogue does not depend on the solve's length."""
    import dataclasses

    feats, fmap, _ = scene
    guesses, _ = registered
    p1 = dataclasses.replace(PARAMS, max_gn_iterations=1)
    f = feats[0]
    empty = [f[0], np.zeros_like(f[1]), f[2], np.zeros_like(f[3])]
    args = (_port_feats(f, empty), FeatureMap(*map(T, fmap)),
            T(np.stack([guesses[0], guesses[0]])))
    rpy = np.array([[0.05, -0.04, 0.0]] * 2, np.float32)
    got = treg.register_scan_with_params(p1, *args, T(rpy),
                                         T(np.ones(2, bool)))
    solved = treg.register_scan_with_params(p1, *args).pose6.numpy()
    assert np.abs(solved[0] - guesses[0]).max() > 1e-3
    jpose = np.asarray(jax.jit(jreg.transform_update)(
        jnp.asarray(solved[0]), jnp.asarray(rpy[0]), jnp.asarray(True)))
    np.testing.assert_allclose(got.pose6[0].numpy(), jpose, atol=1e-6,
                               rtol=0)
    assert np.abs(jpose[:2] - solved[0, :2]).max() > 1e-4
    np.testing.assert_array_equal(got.pose6[1].numpy(), guesses[0])
    np.testing.assert_array_equal(solved[1], guesses[0])


def test_batch_register_per_scan_maps(scene, registered, port_registered):
    """One map per scan: lane 0 on the room map (equal to the shared-map
    batch), lane 1 on the map shifted by 0.5 m in x with its points
    reversed, against JAX register_scan on that map."""
    feats, fmap, _ = scene
    guesses, want = registered
    shift = np.array([0.5, 0.0, 0.0], np.float32)
    m1 = [np.ascontiguousarray(a) for a in (
        fmap[0][::-1] + shift, fmap[1][::-1], fmap[2][::-1] + shift,
        fmap[3][::-1])]
    per = batch_register(_port_feats(*feats),
                         FeatureMap(*(T(np.stack([a, b]))
                                      for a, b in zip(fmap, m1))),
                         T(np.stack(guesses)), chunk=CHUNK)
    assert torch.equal(per.pose6[0], port_registered.pose6[0])
    w1 = jax.tree.map(np.asarray, jreg.register_scan(
        _jax_feats(feats[1]), JFeatureMap(*map(jnp.asarray, m1)),
        jnp.asarray(guesses[1]), chunk=CHUNK))
    _matches_jax(per, 1, w1)
    assert abs(w1.pose6[3] - want[1].pose6[3] - 0.5) < 0.02


# ------------------------------------------------------------------- ICP

def _icp_case():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-2, 2, (256, 3)).astype(np.float32)
    Tm = pose6_to_matrix_np(np.array([0.05, -0.03, 0.1, 0.2, -0.1, 0.05]))
    dst = (pts @ Tm[:3, :3].T + Tm[:3, 3]).astype(np.float32)
    return pts, dst, np.ones(256, bool)


@pytest.mark.parametrize("case", ["align", "max_iterations",
                                  "no_correspondence"])
def test_icp_matches_jax(case):
    pts, dst, mask = _icp_case()
    kw = dict(chunk=256)
    if case == "max_iterations":
        # 2 iterations cannot reach a 1e-12 epsilon: stopped by the budget,
        # and PCL still reports hasConverged() (tests/test_slam_policies.py)
        dst = (pts + np.array([0.05, -0.02, 0.01], np.float32))
        kw.update(max_iterations=2, transformation_epsilon=1e-12)
    elif case == "no_correspondence":
        dst = dst + np.float32(1000.0)
        kw.update(max_corr_dist=1.0, max_iterations=2)
    want = jax.tree.map(np.asarray, jicp.icp_align(
        *map(jnp.asarray, (pts, mask, dst, mask)), **kw))
    got = ticp.icp_align(*map(T, (pts, mask, dst, mask)), **kw)
    np.testing.assert_allclose(got.transform.numpy(), want.transform,
                               atol=1e-5, rtol=0)
    assert bool(got.converged) == bool(want.converged)
    assert int(got.iterations) == int(want.iterations)
    np.testing.assert_allclose(float(got.fitness), float(want.fitness),
                               atol=1e-6, rtol=0)
    if case == "align":
        assert bool(got.converged) and float(got.fitness) < 1e-6
        assert int(got.iterations) < 100
    elif case == "max_iterations":
        assert bool(got.converged) and int(got.iterations) == 2
        assert float(got.delta) > 1e-12 and float(got.fitness) < 0.05
    else:
        assert not bool(got.converged)
