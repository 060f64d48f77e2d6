"""Port parity: the resident-table fetch (`ops/fetch.py`).

On tests/test_pallas_fetch.py's 8x8x4 grid with cell cap 16 (its world,
with one corner of the box emptied so that some in-grid blocks hold no
point):

* `compact_row_space` equals the JAX function bitwise (its table after the
  [R, S, 128] -> [R, 3W] reshape; rows_index equal).
* `resident_fetch` (on the CPU its plain version) against the JAX
  `fused_resident_fetch`, its Pallas kernel in interpret mode, at Q=512
  with every third query at the sentinel and one whole group of 32 dead:
  one call, made in a module fixture (~20 s).  d2 within rtol 1e-6 (XLA's
  CPU backend contracts dx*dx + dy*dy + dz*dz into FMAs) and exactly 3e38
  where the JAX gives 3e38; coordinates equal where the K-th and (K+1)-th
  distances are not tied and the query is not a sentinel.  Sentinel queries
  show the documented difference (ROADMAP Queue 3): the port gives zero
  coordinates always, the JAX kernel FAR (1e9) ones in a live group and
  zeros in a dead one.
* Against the port's `block_fetch` on the raw table: d2 bitwise;
  coordinates bitwise where the compact row is not the sentinel; where only
  the compact row is (an in-grid empty block) the raw fetch gives FAR
  coordinates and the resident one zeros.
* `make_pallas_block_knn` on both table kinds against the JAX XLA fetch
  `grid_knn_block`, and `build_map_planar_tables(resident=True)` against
  the JAX package's, including the fall-back to a raw table over the cap.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from feature_base_pointcloud_registration_tpu.ops import hashgrid as jhg
from feature_base_pointcloud_registration_tpu.ops import pallas_fetch as jpf
from feature_base_pointcloud_registration_tpu.parallel import batch as jbatch
from feature_base_pointcloud_registration_tpu.pipeline.cloud_info import (
    FeatureMap)
from feature_base_pointcloud_registration_tpu_torch.convert import (
    planar_table_to_torch, to_torch)
from feature_base_pointcloud_registration_tpu_torch.ops import (
    fetch as tfetch, hashgrid as thg)
from feature_base_pointcloud_registration_tpu_torch.parallel import (
    batch as tbatch)
from test_torch_batch import one_torch_thread  # noqa: F401

CELL = 2.0
DIMS = (8, 8, 4)
CAP = 16
ORIGIN = np.asarray([-8.0, -8.0, -4.0], np.float32)
K = 8
Q = 512
BIG = np.float32(3e38)


def _world(seed=0, m=4096):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-7, 7, (m, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-3, 3, m)
    keep = ~((pts[:, 0] > 1) & (pts[:, 1] > 1))      # an empty corner
    return pts[keep], np.ones(keep.sum(), bool)


def _queries(seed, n=Q):
    rng = np.random.RandomState(seed)
    q = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    q[:, 2] = rng.uniform(-2.5, 2.5, n)
    q[5::50] = 500.0                                  # out of grid
    return q


@pytest.fixture(scope="module")
def tables():
    pts, mask = _world()
    jst = jhg.build_grid_sentinel(jnp.asarray(pts), jnp.asarray(mask),
                                  jnp.asarray(ORIGIN), CELL, dims=DIMS,
                                  cell_cap=CAP)
    jraw = jpf.build_block_table_planar(jst, dims=DIMS)
    jres = jpf.compact_row_space(jraw)
    tst = thg.build_grid_sentinel(torch.from_numpy(pts),
                                  torch.from_numpy(mask),
                                  torch.from_numpy(ORIGIN), CELL, dims=DIMS,
                                  cell_cap=CAP)
    traw = tfetch.build_block_table_planar(tst, dims=DIMS)
    return (jraw, jres, jhg.build_block_table(jst, dims=DIMS, cell_cap=CAP),
            traw, tfetch.compact_row_space(traw))


def _raw_cells(q):
    tq = torch.from_numpy(q)
    return tfetch.block_cell_of(tq, torch.from_numpy(ORIGIN), CELL,
                                dims=DIMS)


@pytest.fixture(scope="module")
def fetched(tables):
    """One JAX interpret-mode call and the port's plain version on the same
    compact row ids (every third query and queries 64..95 at the
    sentinel)."""
    _, jres, _, _, tres = tables
    q = _queries(1)
    Rp = tres.table.shape[0] - 1
    rows = tres.rows_index[_raw_cells(q).long()]
    rows[::3] = Rp
    rows[64:96] = Rp
    W = tres.table.shape[1] // 3
    jd2, jnn = jpf.fused_resident_fetch(
        jres.table, jnp.asarray(rows.numpy()),
        tuple(jnp.asarray(q[:, i]) for i in range(3)), W=W, K=K)
    tq = [torch.from_numpy(q[:, i].copy()) for i in range(3)]
    d2, nn = tfetch.resident_fetch(tres.table, rows, *tq, K=K,
                                   planes_out=False)
    return q, rows.numpy(), (np.asarray(jd2), np.asarray(jnn)), \
        (d2.numpy(), nn.numpy())


def test_compact_row_space(tables):
    _, jres, _, traw, tres = tables
    carried = planar_table_to_torch(jres, device="cpu")
    assert type(carried) is tfetch.PlanarTable
    assert tres.rows_index.dtype == torch.int32
    assert torch.equal(tres.table, carried.table)
    assert torch.equal(tres.rows_index, carried.rows_index)
    Rp = tres.table.shape[0] - 1
    assert 0 < Rp < traw.shape[0] - 1                 # some rows dropped
    assert (tres.table[Rp] == 1e9).all()
    assert tres.rows_index[-1] == Rp


def test_resident_fetch_matches_jax_kernel(fetched):
    q, rows, (jd2, jnn), (d2, nn) = fetched
    Rp = rows.max()
    sent = rows == Rp
    assert sent.mean() > 0.35 and (jd2[sent] == BIG).all()
    np.testing.assert_array_equal(d2[jd2 == BIG], jd2[jd2 == BIG])
    np.testing.assert_allclose(d2, jd2, rtol=1e-6, atol=0)
    untied = np.all(np.diff(jd2, axis=1) > 1e-5 * jd2[:, 1:], axis=1)
    keep = untied & ~sent
    assert keep.sum() > 200
    np.testing.assert_array_equal(nn[keep], jnn[keep])
    # the documented difference on sentinel queries
    live_group = np.repeat((~sent).reshape(-1, 32).any(1), 32)
    assert not live_group[64:96].any() and live_group[sent].any()
    assert (nn[sent] == 0).all()
    assert (jnn[sent & live_group] == 1e9).all()
    assert (jnn[sent & ~live_group] == 0).all()


@pytest.mark.parametrize("planes_out", [True, False])
def test_resident_matches_block_fetch(tables, planes_out):
    _, _, _, traw, tres = tables
    q = _queries(2)
    raw = _raw_cells(q)
    rows = tres.rows_index[raw.long()]
    tq = [torch.from_numpy(q[:, i].copy()) for i in range(3)]
    d2r, cr = tfetch.resident_fetch(tres.table, rows, *tq, K=K,
                                    planes_out=planes_out)
    d2b, cb = tfetch.block_fetch(traw, raw, *tq, K=K, planes_out=planes_out)
    assert torch.equal(d2r, d2b)
    cr, cb = (c.view(3, K, Q).permute(2, 1, 0) if planes_out else c
              for c in (cr, cb))
    compact_sent = rows == tres.table.shape[0] - 1
    raw_sent = raw == traw.shape[0] - 1
    empty = compact_sent & ~raw_sent                  # in-grid, no points
    assert raw_sent.any() and empty.any()
    assert torch.equal(cr[~compact_sent], cb[~compact_sent])
    assert (cr[compact_sent] == 0).all() and (cb[raw_sent] == 0).all()
    assert (cb[empty] == 1e9).all()


@pytest.mark.parametrize("resident", [False, True])
def test_make_pallas_block_knn(tables, resident):
    _, _, jblock, traw, tres = tables
    q = _queries(3)
    knn = tfetch.make_pallas_block_knn(tres if resident else traw,
                                       torch.from_numpy(ORIGIN), CELL,
                                       dims=DIMS, cell_cap=CAP, k=K)
    d2, nn = knn(torch.from_numpy(q))
    assert nn.shape == (Q, K, 3)
    jd2, jnn = jhg.grid_knn_block(jnp.asarray(q), jblock,
                                  jnp.asarray(ORIGIN), CELL, dims=DIMS,
                                  cell_cap=CAP, k=K)
    jd2, jnn = np.asarray(jd2), np.asarray(jnn)
    d2, nn = d2.numpy(), nn.numpy()
    np.testing.assert_allclose(d2, jd2, rtol=1e-6, atol=0)
    found = jd2[:, 0] < 1e17
    untied = np.all(np.diff(jd2, axis=1) > 1e-5 * jd2[:, 1:], axis=1)
    np.testing.assert_array_equal(nn[found & untied], jnn[found & untied])
    # a query without candidates: FAR from the raw table, zeros resident
    assert (nn[~found] == (0.0 if resident else 1e9)).any()


def test_build_map_planar_tables_resident(tables, monkeypatch):
    pts, mask = _world()
    center = np.zeros(3, np.float32)
    half = np.array([6.0, 6.0, 2.0], np.float32)
    jmap = FeatureMap(pts[::4], mask[::4], pts, mask)
    jct, jst, _, jdims = jbatch.build_map_planar_tables(
        FeatureMap(*map(jnp.asarray, jmap)), center, half,
        corner_cell_cap=CAP, surf_cell_cap=32, resident=True)
    tmap = to_torch(jmap, device="cpu")
    ct, st, origin, dims = tbatch.build_map_planar_tables(
        tmap, center, half, corner_cell_cap=CAP, surf_cell_cap=32,
        resident=True)
    assert dims == jdims
    for got, want in ((ct, jct), (st, jst)):
        want = planar_table_to_torch(want, device="cpu")
        assert type(got) is type(want) is tfetch.PlanarTable
        assert torch.equal(got.table, want.table)
        assert torch.equal(got.rows_index, want.rows_index)
    # over the cap a table stays raw: here the corner table fits, surf not
    cap = ct.table.numel() * 4
    assert st.table.numel() * 4 > cap
    monkeypatch.setattr(tbatch, "RESIDENT_TABLE_CAP", cap)
    ct2, st2, _, _ = tbatch.build_map_planar_tables(
        tmap, center, half, corner_cell_cap=CAP, surf_cell_cap=32,
        resident=True)
    raw = tbatch.build_map_planar_tables(tmap, center, half,
                                         corner_cell_cap=CAP,
                                         surf_cell_cap=32)
    assert isinstance(ct2, tfetch.PlanarTable)
    assert torch.equal(ct2.table, ct.table)
    assert isinstance(st2, torch.Tensor) and torch.equal(st2, raw[1])


def test_resident_fetch_rejects_bad_inputs(tables):
    tres = tables[4]
    q = torch.zeros(4)
    rows = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        tfetch.resident_fetch(tres.table, rows.long(), q, q, q, K=K)
    with pytest.raises(ValueError):
        tfetch.resident_fetch(tres.table, rows, q, q, torch.zeros(5), K=K)
