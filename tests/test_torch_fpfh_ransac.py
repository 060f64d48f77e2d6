"""Port parity: FPFH descriptors, descriptor matching and RANSAC.

The same numpy-seeded clouds go through the JAX package's `ops/fpfh.py` /
`ops/ransac.py` and the port's, on the CPU, on
tests/test_fpfh_ransac_icp.py's `_structured_cloud` (n=512, k=12,
chunk=256).  Tolerances (float32):

  * normals within 1e-5, outside the band where the viewpoint sign test
    (`dot(n, vp - p) < 0`) is within 1e-4 m of zero: there a 1-ulp
    difference (XLA's CPU backend contracts FMAs, PyTorch does not) may
    flip the normal.  The cloud's two planes pass through the viewpoint,
    so most points lie in the band (315 of 512 for seed 0); there the
    normals agree within 1e-5 up to the sign, and the flipped signs are
    counted (0 measured) and bounded by 1% of the points.  Where the
    neighborhood's two smallest covariance eigenvalues lie within 5% of
    the largest, the normal (their eigenvector's complement) amplifies
    the 1-ulp differences: there within 1e-4 (2 of 512 points for seed 0,
    one measured at 1.06e-5);
  * descriptors within 1e-5 wherever no histogram bin flipped.  A bin is
    the truncated (v - lo) / (hi - lo) * 11, so a 1-ulp difference in an
    angle moves a pair's count into the next bin; a flip at a point
    changes its descriptor and those of the points that have it as a
    neighbor.  The flipped pairs are counted (0 of 6144 measured) and
    bounded by 1% of the pairs;
  * matches equal wherever the best similarity leads the second by more
    than 1e-5 (within it the argmax is float noise);
  * `ransac_from_samples` fed JAX's own triplets (drawn as
    `ops/ransac.py:44-47` draws them): every non-degenerate hypothesis's
    inlier count within 1 of JAX's (an inlier at the threshold may flip),
    the winner's refit inliers within 1 and its transform within 1e-4.  A
    degenerate triplet (a source or destination triplet within 1e-3 m of
    collinear: a repeated index, or two matches onto one destination
    point) makes Kabsch's SVD rotation non-unique, so its transform and
    count may differ between the packages; those hypotheses are excluded
    and counted: on the FPFH matches 148 of 512 (6 by their source
    triplet; one of them counted 7 inliers in the port and 33 in JAX), on
    the true matches 6 of 256 (repeated indices); fewer than half may be;
  * the random streams cannot be shared (JAX's threefry against a
    `torch.Generator`): `sample_triplets` is held to itself (one seed, one
    draw on the CPU), to the valid matches, and to JAX's edge case (no
    valid match: uniform over all);
  * `coarse_align_fpfh` then `icp_align` on the port alone meets
    tests/test_fpfh_ransac_icp.py's own bounds.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_base_pointcloud_registration_tpu.geom import se3 as jse3
from feature_base_pointcloud_registration_tpu.ops import (
    fpfh as jfp, knn as jknn, ransac as jra)
from feature_base_pointcloud_registration_tpu_torch.ops import (
    fpfh as tfp, icp as ticp, knn as tknn, ransac as tra)
from test_fpfh_ransac_icp import _structured_cloud
from test_torch_batch import one_torch_thread  # noqa: F401

K, CHUNK = 12, 256
GT6 = np.array([0.1, -0.05, 0.8, 3.0, -2.0, 1.0], np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _transformed(pts, pose6=GT6):
    T = np.array(jse3.pose6_to_matrix(jnp.asarray(pose6)))
    return (pts @ T[:3, :3].T + T[:3, 3]).astype(np.float32), T


def _bins(vals, lo, hi):
    return np.clip(((vals - lo) / (hi - lo) * 11).astype(np.int32), 0, 10)


@pytest.mark.parametrize("seed", [0, 2])
def test_normals_match_jax(one_torch_thread, seed):  # noqa: F811
    pts = _structured_cloud(seed=seed)
    m = np.ones(len(pts), bool)
    jn, jv = jfp.estimate_normals(jnp.asarray(pts), jnp.asarray(m), k=K,
                                  chunk=CHUNK)
    tn, tv = tfp.estimate_normals(_t(pts), _t(m), k=K, chunk=CHUNK)
    jn, tn = np.array(jn), tn.numpy()
    np.testing.assert_array_equal(tv.numpy(), np.array(jv))
    band = np.abs((jn * -pts).sum(-1)) < 1e-4
    # the eigen gap of each neighborhood's covariance (float64, host)
    _, idx = tknn.knn(_t(pts), _t(pts), _t(m), k=K, chunk=CHUNK)
    nn = pts[idx.numpy()].astype(np.float64)
    c = nn - nn.mean(1, keepdims=True)
    lam = np.linalg.eigvalsh(np.einsum("nki,nkj->nij", c, c))
    tol = np.where((lam[:, 1] - lam[:, 0]) / lam[:, 2] < 0.05, 1e-4,
                   1e-5)[:, None]
    assert (tol > 1e-5).sum() <= 0.01 * len(pts)
    # in the band (the cloud's planes pass through the viewpoint) up to
    # the sign, and the flipped signs counted
    sign = np.where(band[:, None] & ((tn * jn).sum(-1) < 0)[:, None], -1.0,
                    1.0)
    assert (np.abs(tn * sign - jn) <= tol).all()
    flipped = int((sign < 0).sum())
    assert flipped <= 0.01 * len(pts), (flipped, int(band.sum()))
    assert np.isfinite(tn).all()


@pytest.mark.parametrize("seed", [0, 2])
def test_descriptors_match_jax_outside_bin_flips(one_torch_thread,  # noqa: F811,E501
                                                 seed):
    pts = _structured_cloud(seed=seed)
    m = np.ones(len(pts), bool)
    jd, jv = jfp.fpfh(jnp.asarray(pts), jnp.asarray(m), k=K, chunk=CHUNK)
    td, tv = tfp.fpfh(_t(pts), _t(m), k=K, chunk=CHUNK)
    jd, td = np.array(jd), td.numpy()
    np.testing.assert_array_equal(tv.numpy(), np.array(jv))
    # each package's Darboux angles at its own normals and neighbors, and
    # the bins they fall in
    jn, _ = jfp.estimate_normals(jnp.asarray(pts), jnp.asarray(m), k=K,
                                 chunk=CHUNK)
    _, jidx = jknn.knn(jnp.asarray(pts), jnp.asarray(pts), jnp.asarray(m),
                       k=K, chunk=CHUNK)
    tn, _ = tfp.estimate_normals(_t(pts), _t(m), k=K, chunk=CHUNK)
    _, tidx = tknn.knn(_t(pts), _t(pts), _t(m), k=K, chunk=CHUNK)
    idx = np.array(jidx)
    np.testing.assert_array_equal(tidx.numpy(), idx)
    ja = jfp._pair_features(jnp.asarray(pts), jn, jnp.asarray(pts[idx]),
                            jn[idx])
    ta = tfp._pair_features(_t(pts), tn, _t(pts[idx]), tn[idx.astype(
        np.int64)])
    flip = np.zeros(idx.shape, bool)
    for a, b, (lo, hi) in zip(ja[:3], ta[:3], ((-1, 1), (-1, 1),
                                               (-math.pi, math.pi))):
        flip |= _bins(np.array(a), lo, hi) != _bins(b.numpy(), lo, hi)
    assert flip.sum() <= 0.01 * flip.size, (flip.sum(), flip.size)
    at_point = flip.any(1)
    touched = at_point | at_point[idx].any(1)
    np.testing.assert_allclose(td[~touched], jd[~touched], atol=1e-5)
    assert np.isfinite(td).all()


def test_matches_equal_outside_near_ties(one_torch_thread):  # noqa: F811
    pts = _structured_cloud()
    m = np.ones(len(pts), bool)
    dst, _ = _transformed(pts, np.array([0.3, -0.2, 1.1, 5.0, -3.0, 2.0],
                                        np.float32))
    jd0, jv0 = jfp.fpfh(jnp.asarray(pts), jnp.asarray(m), k=K, chunk=CHUNK)
    jd1, jv1 = jfp.fpfh(jnp.asarray(dst), jnp.asarray(m), k=K, chunk=CHUNK)
    td0, tv0 = tfp.fpfh(_t(pts), _t(m), k=K, chunk=CHUNK)
    td1, tv1 = tfp.fpfh(_t(dst), _t(m), k=K, chunk=CHUNK)
    ji, js = jfp.match_descriptors(jd1, jv1, jd0, jv0)
    ti, ts = tfp.match_descriptors(td1, tv1, td0, tv0)
    ji, js = np.array(ji), np.array(js)
    sim = np.array(jd1) @ np.array(jd0).T
    top2 = np.sort(sim, 1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > 1e-5
    assert clear.mean() > 0.3, clear.mean()
    np.testing.assert_array_equal(ti.numpy()[clear], ji[clear])
    np.testing.assert_allclose(ts.numpy(), js, atol=1e-5)
    # on the same descriptors the match is the same everywhere
    ti2, ts2 = tfp.match_descriptors(_t(jd1), _t(np.array(jv1)), _t(jd0),
                                     _t(np.array(jv0)))
    np.testing.assert_array_equal(ti2.numpy(), ji)
    np.testing.assert_array_equal(ts2.numpy(), js)


def _jax_samples(key, corr_valid, H):
    """The triplets JAX's ransac_align draws (ops/ransac.py:44-47)."""
    logits = jnp.where(jnp.asarray(corr_valid), 0.0, -1e9)
    return np.array(jax.random.categorical(
        key, logits[None, :].repeat(H * 3, 0)).reshape(H, 3))


def _jax_counts(samples, src, dst, corr_valid, thr):
    """JAX's per-hypothesis inlier counts, as ransac_align scores them."""
    T = jse3.kabsch(jnp.asarray(src[samples]), jnp.asarray(dst[samples]))
    src_t = jnp.einsum("hij,nj->hni", T[:, :3, :3], jnp.asarray(src),
                       precision=jax.lax.Precision.HIGHEST) + T[:, None, :3, 3]
    d2 = jnp.sum((src_t - jnp.asarray(dst)[None]) ** 2, -1)
    return np.array(jnp.sum((d2 < thr ** 2) & jnp.asarray(corr_valid)[None],
                            1))


def _degenerate(samples, src, dst):
    """Hypotheses whose source or destination triplet is within 1e-3 m of
    collinear: a repeated index, or two matches onto one destination point
    (descriptor matching maps many points to one)."""
    out = np.zeros(len(samples), bool)
    for pts in (src, dst):
        tri = pts[samples].astype(np.float64)
        sv = np.linalg.svd(tri - tri.mean(1, keepdims=True),
                           compute_uv=False)
        out |= sv[:, 1] < 1e-3
    return out


def _fpfh_matches(seed):
    """The FPFH matches of `_structured_cloud(seed)` against its GT6 copy,
    computed by JAX (the same inputs then go to both RANSACs)."""
    pts = _structured_cloud(seed=seed)
    m = jnp.ones(len(pts), bool)
    dst, _ = _transformed(pts)
    sd, sv = jfp.fpfh(jnp.asarray(pts), m, k=K, chunk=CHUNK)
    dd, dv = jfp.fpfh(jnp.asarray(dst), m, k=K, chunk=CHUNK)
    midx, sim = jfp.match_descriptors(sd, sv, dd, dv)
    return pts, dst[np.array(midx)], np.array(sv) & np.isfinite(
        np.array(sim))


def _true_matches():
    """tests/test_fpfh_ransac_icp.py's true correspondences, 30% corrupted,
    and 20 marked invalid."""
    rng = np.random.RandomState(1)
    src = rng.uniform(-5, 5, (256, 3)).astype(np.float32)
    dst, _ = _transformed(src, np.array([0.2, 0.1, -0.7, 2.0, 1.0, -0.5],
                                        np.float32))
    bad = rng.rand(256) < 0.3
    dst[bad] += rng.uniform(-5, 5, (bad.sum(), 3)).astype(np.float32)
    valid = np.ones(256, bool)
    valid[::13] = False
    return src, dst, valid


@pytest.mark.parametrize("case,thr,H", [("fpfh", 0.4, 512),
                                        ("true", 0.2, 256)])
def test_ransac_scoring_on_jax_triplets(one_torch_thread, case, thr, H):  # noqa: F811,E501
    src, dst, valid = _fpfh_matches(2) if case == "fpfh" else _true_matches()
    key = jax.random.PRNGKey(3)
    samples = _jax_samples(key, valid, H)
    assert valid[samples].all()
    jres = jra.ransac_align(key, jnp.asarray(src), jnp.asarray(dst),
                            jnp.asarray(valid), num_hypotheses=H,
                            inlier_threshold=thr)
    tres = tra.ransac_from_samples(_t(samples), _t(src), _t(dst), _t(valid),
                                   inlier_threshold=thr)
    assert abs(int(tres.inliers) - int(jres.inliers)) <= 1
    np.testing.assert_allclose(tres.transform.numpy(),
                               np.array(jres.transform), atol=1e-4)
    np.testing.assert_allclose(float(tres.inlier_ratio),
                               float(jres.inlier_ratio), atol=1.0 / 256)
    # hypothesis by hypothesis
    _, inl = tra.score_hypotheses(_t(samples), _t(src), _t(dst), _t(valid),
                                  inlier_threshold=thr)
    port, ref = inl.sum(1).numpy(), _jax_counts(samples, src, dst, valid,
                                                thr)
    deg = _degenerate(samples, src, dst)
    assert deg.sum() < H // 2, deg.sum()
    off = np.abs(port - ref)[~deg]
    assert off.max() <= 1, (f"{deg.sum()} of {H} hypotheses excluded as "
                            f"degenerate; max count difference {off.max()}")


def test_nan_hypotheses_never_win(one_torch_thread, monkeypatch):  # noqa: F811
    """A hypothesis whose transform is NaN counts no inlier (a NaN distance
    is not below the threshold, as in JAX): with every other hypothesis
    made NaN, the result is that of the remaining ones alone."""
    src, dst, valid = _true_matches()
    samples = _t(_jax_samples(jax.random.PRNGKey(0), valid, 64))
    real = tra.kabsch

    def nan_every_other(s, d, weights=None):
        T = real(s, d, weights=weights)
        if T.dim() == 3:
            T = T.clone()
            T[::2] = float("nan")
        return T

    monkeypatch.setattr(tra, "kabsch", nan_every_other)
    _, inl = tra.score_hypotheses(samples, _t(src), _t(dst), _t(valid),
                                  inlier_threshold=0.2)
    assert (inl[::2].sum(1) == 0).all()
    got = tra.ransac_from_samples(samples, _t(src), _t(dst), _t(valid),
                                  inlier_threshold=0.2)
    monkeypatch.setattr(tra, "kabsch", real)
    want = tra.ransac_from_samples(samples[1::2], _t(src), _t(dst),
                                   _t(valid), inlier_threshold=0.2)
    assert torch.isfinite(got.transform).all()
    assert torch.equal(got.transform, want.transform)
    assert int(got.inliers) == int(want.inliers) > 150


def test_sample_triplets_stream(one_torch_thread):  # noqa: F811
    valid = np.zeros(300, bool)
    valid[[3, 50, 51, 299]] = True
    draw = [tra.sample_triplets(torch.Generator().manual_seed(7), _t(valid),
                                128) for _ in range(2)]
    assert draw[0].shape == (128, 3) and draw[0].dtype == torch.int64
    assert torch.equal(draw[0], draw[1])
    assert set(draw[0].unique().tolist()) == {3, 50, 51, 299}
    other = tra.sample_triplets(torch.Generator().manual_seed(8), _t(valid),
                                128)
    assert not torch.equal(other, draw[0])
    # no valid match: uniform over all of them, as JAX's logits give
    none = tra.sample_triplets(torch.Generator().manual_seed(7),
                               torch.zeros(300, dtype=torch.bool), 512)
    assert none.min() >= 0 and none.max() < 300
    assert len(none.unique()) > 250


def test_coarse_then_icp_meets_jax_bounds(one_torch_thread):  # noqa: F811
    """tests/test_fpfh_ransac_icp.py::test_coarse_fpfh_ransac_then_icp on
    the port: coarse within 1.5 m, ICP-refined within 2e-2, fitness under
    0.01."""
    pts = _structured_cloud(seed=2)
    dst, T = _transformed(pts)
    mask = _t(np.ones(len(pts), bool))
    res = tra.coarse_align_fpfh(torch.Generator().manual_seed(3), _t(pts),
                                mask, _t(dst), mask, k=K, chunk=CHUNK,
                                num_hypotheses=512, inlier_threshold=0.4)
    T_coarse = res.transform.numpy()
    assert np.linalg.norm(T_coarse[:3, 3] - T[:3, 3]) < 1.5
    src_c = (pts @ T_coarse[:3, :3].T + T_coarse[:3, 3]).astype(np.float32)
    icp = ticp.icp_align(_t(src_c), mask, _t(dst), mask, max_corr_dist=2.0,
                         max_iterations=50, chunk=CHUNK)
    np.testing.assert_allclose(icp.transform.numpy() @ T_coarse, T,
                               atol=2e-2)
    assert float(icp.fitness) < 0.01
