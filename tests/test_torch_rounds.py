"""Port parity: the rounds-structured solver and its modules.

`ops/eig3.py`, `ops/correspondence.py` (the candidate path) and
`ops/solver.py::gn_step` against the JAX functions on numpy-seeded inputs:
rtol 1e-5 (XLA's CPU backend contracts multiply-adds into FMAs and sums in
another order; eigenvalues near zero get an absolute floor of 1e-5 of the
matrix scale, where a relative bound means nothing), masks equal.  JAX
functions are vmapped where the port writes out the lane axis.

`ops/hashgrid.py`'s block table bitwise and its plain fetch
`grid_knn_block` as `tests/test_torch_fetch.py` holds `block_fetch`.

Then the solvers whole, on tests/test_torch_batch.py's tiny and dense
scenes, against the JAX package's `batch_register_blocks`: the port's
`batch_register_blocks` and `batch_register_pallas` (raw and resident
tables; on the CPU the fetch wrappers run their plain versions).  Poses
within 1e-5 m / rad, iterations equal, n_corr within 0.5% + 2.  Last,
`batch_register_fused` gives bitwise the same result on resident tables as
on raw ones: the tables differ only in the coordinates of sentinel queries,
which no gate accepts.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import test_pallas_gn as tpg
import test_torch_batch as ttb
from feature_base_pointcloud_registration_tpu.ops import (
    correspondence as jcorr, eig3 as jeig, hashgrid as jhg, solver as jsolver)
from feature_base_pointcloud_registration_tpu.parallel.batch import (
    batch_register_blocks, build_map_block_tables)
from feature_base_pointcloud_registration_tpu_torch.convert import to_torch
from feature_base_pointcloud_registration_tpu_torch.ops import (
    correspondence as tcorr, eig3 as teig, hashgrid as thg, solver as tsolver)
from feature_base_pointcloud_registration_tpu_torch.ops.fetch import (
    PlanarTable)
from feature_base_pointcloud_registration_tpu_torch.parallel import (
    batch as tbatch)
from test_torch_batch import one_torch_thread  # noqa: F401

CAP = 16
T = torch.from_numpy


def _close(got, want, scale=1.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * scale)


def _sym(r, n):
    A = r.normal(0, 1, (n, 3, 3)).astype(np.float32)
    A = (A @ A.transpose(0, 2, 1)).astype(np.float32)
    A[: n // 4] = np.diag([2.0, 0.5, 0.01]).astype(np.float32)  # line-like
    A[n // 4: n // 4 + 8] = np.eye(3, dtype=np.float32)         # isotropic
    return A


def test_eig3():
    r = np.random.RandomState(0)
    A = _sym(r, 400)
    scale = np.abs(A).max()
    w = teig.eigvals_sym3(T(A))
    _close(w, jeig.eigvals_sym3(jnp.asarray(A)), scale)
    lam = w[:, 2].numpy()
    _close(teig.principal_eigvec_sym3(T(A), T(lam)),
           jeig.principal_eigvec_sym3(jnp.asarray(A), jnp.asarray(lam)))
    M = r.normal(0, 1, (400, 3, 3)).astype(np.float32)
    b = r.normal(0, 1, (400, 3)).astype(np.float32)
    _close(teig.det3(T(M)), jeig.det3(jnp.asarray(M)), 10.0)
    x, d = teig.solve3(T(M), T(b))
    jx, jd = jeig.solve3(jnp.asarray(M), jnp.asarray(b))
    well = np.abs(np.asarray(jd)) > 0.1
    _close(x.numpy()[well], np.asarray(jx)[well], 10.0)
    _close(d, jd, 10.0)


def test_select_smallest():
    r = np.random.RandomState(1)
    d2 = r.uniform(0, 2, (500, 8)).astype(np.float32)
    d2[::3, 2] = d2[::3, 5]                     # ties: the lower index wins
    d2[::7] = 1.0                               # all tied
    d2[::11, 4:] = 3e38                         # invalid candidates
    sel, dmax = tcorr.select_smallest(T(d2), 5)
    jsel, jdmax = jcorr.select_smallest(jnp.asarray(d2), 5)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    np.testing.assert_array_equal(dmax.numpy(), np.asarray(jdmax))
    assert (sel.sum(1) == 5).all()


def _cands(kind, seed, N=600, K=8):
    """Queries near lines (corner) or planes (surf) with K noisy neighbours,
    some candidates invalid and some queries masked."""
    r = np.random.RandomState(seed)
    base = r.uniform(-10, 10, (N, 3))
    t = r.uniform(-0.5, 0.5, (N, K, 1))
    off = r.normal(0, 1, (N, 3))
    if kind == "corner":
        u = r.normal(0, 1, (N, 1, 3))
        u /= np.linalg.norm(u, axis=-1, keepdims=True)
        cand = base[:, None] + t * u
        # the point-to-line direction is ill-conditioned for a point near
        # the line (an error in the fitted line turns it by the error over
        # the distance): keep queries 15-40 cm off it
        off -= (off * u[:, 0]).sum(-1, keepdims=True) * u[:, 0]
        off *= r.uniform(0.15, 0.4, (N, 1)) / np.linalg.norm(
            off, axis=-1, keepdims=True)
    else:
        e1, e2 = r.normal(0, 1, (N, 1, 3)), r.normal(0, 1, (N, 1, 3))
        cand = base[:, None] + t * e1 + r.uniform(-0.5, 0.5, (N, K, 1)) * e2
        off *= 0.1
    cand = cand + r.normal(0, 0.02, cand.shape)
    pts = base + off
    cv = r.uniform(size=(N, K)) > 0.1
    valid = r.uniform(size=N) > 0.05
    return [a.astype(np.float32) if a.dtype == np.float64 else a
            for a in (pts, valid, cand, cv)]


@pytest.mark.parametrize("kind,spread", [("corner", 0.0), ("surf", 0.0),
                                         ("surf", 0.05)])
def test_correspondence_cand(kind, spread):
    args = _cands(kind, {"corner": 2, "surf": 3}[kind])
    targs = [T(a) for a in args]
    jargs = [jnp.asarray(a) for a in args]
    if kind == "corner":
        got = tcorr.corner_correspondence_cand(*targs)
        want = jcorr.corner_correspondence_cand(*jargs)
    else:
        got = tcorr.surf_correspondence_cand(*targs, min_plane_spread=spread)
        want = jcorr.surf_correspondence_cand(*jargs,
                                              min_plane_spread=spread)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert 0.3 < got[2].float().mean() < 0.98
    _close(got[0], want[0])
    _close(got[1], want[1])


def test_householder_lstsq3():
    r = np.random.RandomState(4)
    A = r.normal(0, 5, (300, 8, 3)).astype(np.float32)
    A[:, 5:] = 0.0                               # unselected rows
    b = -np.ones((300, 8), np.float32)
    b[:, 5:] = 0.0
    n, det = tcorr._householder_lstsq3(T(A), T(b))
    jn, jdet = jcorr._householder_lstsq3(jnp.asarray(A), jnp.asarray(b))
    _close(n, jn)
    _close(det, jdet, 1.0)


def test_gn_step():
    r = np.random.RandomState(5)
    B, N = 4, 300
    pts = r.uniform(-10, 10, (B, N, 3)).astype(np.float32)
    coeff = r.normal(0, 1, (B, N, 3)).astype(np.float32)
    coeff /= np.linalg.norm(coeff, axis=-1, keepdims=True)
    resid = r.normal(0, 0.05, (B, N)).astype(np.float32)
    mask = r.uniform(size=(B, N)) > 0.2
    mask[3, 40:] = False                          # too few correspondences
    coeff[1, :, 2] *= 0.01                        # a weak direction
    matP = np.tile(np.eye(6, dtype=np.float32), (B, 1, 1))
    state = (r.normal(0, 0.05, (B, 6)).astype(np.float32), matP,
             np.array([False, True, False, False]), np.zeros(B, bool),
             np.zeros(B, np.int32))
    it = np.array([0, 0, 3, 0], np.int32)
    kw = dict(eigen_threshold=30.0)
    got = tsolver.gn_step(tsolver.GNState(*map(T, state)), T(pts), T(coeff),
                          T(resid), T(mask), T(it), **kw)
    want = jax.vmap(lambda s, p, c, e, m, i: jsolver.gn_step(
        s, p, c, e, m, i, **kw))(
        jsolver.GNState(*map(jnp.asarray, state)), *map(
            jnp.asarray, (pts, coeff, resid, mask, it)))
    want = to_torch(jax.tree.map(np.asarray, want), device="cpu")
    assert type(want) is tsolver.GNState
    assert want.is_degenerate.tolist() == [False, True, False, True]
    for name in ("is_degenerate", "converged", "n_corr"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    _close(got.pose6, want.pose6)
    _close(got.matP, want.matP)


@pytest.mark.parametrize("k", [5, 8])
def test_block_table_and_grid_knn_block(k):
    """`build_block_table` bitwise; `grid_knn_block` d2 within rtol 1e-6
    (FMA contraction), coordinates equal where the k-th distance is not
    tied with the next, FAR/3e38 for queries without candidates."""
    r = np.random.RandomState(6)
    pts = r.uniform(-7, 7, (3000, 3)).astype(np.float32)
    mask = r.uniform(size=3000) > 0.1
    origin, dims = np.full(3, -8.0, np.float32), (8, 8, 8)
    jst = jhg.build_grid_sentinel(jnp.asarray(pts), jnp.asarray(mask),
                                  jnp.asarray(origin), 2.0, dims=dims,
                                  cell_cap=CAP)
    jbt = jhg.build_block_table(jst, dims=dims, cell_cap=CAP)
    tbt = thg.build_block_table(T(np.array(jst)), dims=dims, cell_cap=CAP)
    np.testing.assert_array_equal(tbt.numpy(), np.asarray(jbt))
    q = r.uniform(-9, 9, (700, 3)).astype(np.float32)
    d2, nn = thg.grid_knn_block(T(q), tbt, T(origin), 2.0, dims=dims,
                                cell_cap=CAP, k=k)
    jd2, jnn = map(np.asarray, jhg.grid_knn_block(
        jnp.asarray(q), jbt, jnp.asarray(origin), 2.0, dims=dims,
        cell_cap=CAP, k=k))
    np.testing.assert_allclose(d2.numpy(), jd2, rtol=1e-6, atol=0)
    big = jd2[:, 1:] == np.float32(3e38)          # FAR slots: FAR in both
    untied = np.all((np.diff(jd2, axis=1) > 1e-5 * jd2[:, 1:]) | big, axis=1)
    assert untied.mean() > 0.9 and big.any()
    np.testing.assert_array_equal(nn.numpy()[untied], jnn[untied])


# ---- the solvers whole -----------------------------------------------------

@pytest.fixture(scope="module")
def scenes():
    """Per scene: (port features, port map, guesses, JAX blocks result,
    center, half)."""
    out = {}
    for name, setup in (("tiny", tpg._setup), ("dense", ttb._dense_setup)):
        feats, guesses, _, fmap, center, half = setup()
        cbt, sbt, origin, dims = build_map_block_tables(
            fmap, center, half, corner_cell_cap=CAP, surf_cell_cap=CAP)
        ref = batch_register_blocks(
            feats, cbt, sbt, origin, guesses, grid_dims=dims,
            corner_cell_cap=CAP, surf_cell_cap=CAP, num_rounds=2,
            iters_per_round=15)
        out[name] = (to_torch(jax.tree.map(np.asarray, feats), device="cpu"),
                     to_torch(jax.tree.map(np.asarray, fmap), device="cpu"),
                     T(np.array(guesses)), jax.tree.map(np.asarray, ref),
                     center, half)
    return out


def _port_solve(solver, scene):
    feats, fmap, guesses, _, center, half = scene
    kw = dict(corner_cell_cap=CAP, surf_cell_cap=CAP)
    if solver == "blocks":
        build, solve = tbatch.build_map_block_tables, \
            tbatch.batch_register_blocks
    else:
        build, solve = tbatch.build_map_planar_tables, \
            tbatch.batch_register_pallas
    tables_kw = dict(resident=True) if solver == "pallas_resident" else {}
    ct, st, origin, dims = build(fmap, center, half, **kw, **tables_kw)
    if solver == "pallas_resident":
        assert isinstance(ct, PlanarTable) and isinstance(st, PlanarTable)
    return solve(feats, ct, st, origin, guesses, grid_dims=dims,
                 num_rounds=2, iters_per_round=15, **kw)


@pytest.mark.parametrize("scene", ["tiny", "dense"])
@pytest.mark.parametrize("solver", ["blocks", "pallas_raw",
                                    "pallas_resident"])
def test_rounds_solvers_match_jax_blocks(scenes, scene, solver):
    ref = scenes[scene][3]
    got = _port_solve(solver, scenes[scene])
    assert got.valid.all() and got.converged.all()
    np.testing.assert_allclose(got.pose6.numpy(), ref.pose6, rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(got.iterations.numpy(), ref.iterations)
    np.testing.assert_array_equal(got.is_degenerate.numpy(),
                                  ref.is_degenerate)
    nc = got.n_corr.numpy()
    assert (np.abs(nc - ref.n_corr) <= 0.005 * ref.n_corr + 2).all()


def test_fused_resident_equals_raw(scenes):
    feats, fmap, guesses, _, center, half = scenes["dense"]
    res = {}
    for resident in (False, True):
        ct, st, origin, dims = tbatch.build_map_planar_tables(
            fmap, center, half, corner_cell_cap=CAP, surf_cell_cap=CAP,
            resident=resident)
        res[resident] = tbatch.batch_register_fused(
            feats, ct, st, origin, guesses, grid_dims=dims,
            iters_per_round=15, round1_surf_stride=8, round1_corner_stride=4)
    assert isinstance(ct, PlanarTable)
    for a, b in zip(res[False], res[True]):
        assert torch.equal(a, b)
