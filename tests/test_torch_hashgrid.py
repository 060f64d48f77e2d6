"""Port parity: the hash-grid families of `ops/hashgrid.py` against the JAX
package's, on tests/test_hashgrid.py's map (seed 1: 8192 points in
[-8, 8]^3, the last 500 masked; 256 uniform queries and 256 near map
points), the index table at 1 m cells (cap 16) and the packed, sentinel and
block tables at 2 m cells (cap 32), the grid from -12 m.

  * tables bitwise (the stable sort and JAX's argsort agree on XLA's CPU
    backend, as for the block tables of earlier slices);
  * each lookup at k = 5 and at k = 16 (where JAX takes `lax.approx_min_k`,
    exact on XLA's CPU backend): d2 within 1e-5 and the neighbor sets
    equal outside near-ties (measured: bitwise on every query);
  * a lookup chunked at a few queries equals the unchunked one;
  * the lower-face rule: with the grid moved to start at -7 m (inside the
    map), the queries within half a cell of a lower face (octant base -1
    on an axis) keep the candidates of their in-grid cells in both
    packages' `grid_knn_oct_sentinel` (counts equal), while the batched
    solvers' block-row fetch (`grid_knn_block`, the JAX package's rule)
    gives them none; the fetch of the port's `grid_register_step`
    (`ops/fetch.py::make_pallas_block_knn` on tables built with
    lower_pad=True, raw and compact, the fetch kernels' plain versions)
    returns JAX `grid_knn_oct_sentinel`'s d2 bitwise for every query, and
    its coordinates bitwise wherever the query's row is not the sentinel
    (a query whose octant holds no in-grid cell reads the sentinel: d2
    3e38 in both, zero coordinates by the fetch's contract, FAR there);
    the counts are printed.

JAX compiles each function at one shape (the query set and table shapes
are the same throughout; the moved grid changes only the traced origin).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import test_hashgrid as thg
from feature_base_pointcloud_registration_tpu.ops import hashgrid as jh
from feature_base_pointcloud_registration_tpu_torch.ops import (
    fetch as tfetch, hashgrid as th)
from test_torch_batch import one_torch_thread  # noqa: F401

T = torch.from_numpy
CAP1, CAP2 = 16, 32
ORIGINS = {"centered": -12.0, "lower_face": -7.0}


def _jax_case(pts, mask, q, origin_v):
    """JAX tables and lookups (numpy) for one grid origin."""
    origin = jnp.full(3, origin_v, jnp.float32)
    d1 = jh.default_grid_spec((10.0,) * 3, 1.0)
    d2 = jh.default_grid_spec((10.0,) * 3, 2.0)
    g = jh.build_grid(pts, mask, origin, 1.0, dims=d1, cell_cap=CAP1)
    packed = jh.build_grid_packed(pts, mask, origin, 2.0, dims=d2,
                                  cell_cap=CAP2)
    sent = jh.build_grid_sentinel(pts, mask, origin, 2.0, dims=d2,
                                  cell_cap=CAP2)
    block = jh.build_block_table(sent, dims=d2, cell_cap=CAP2)
    kw = dict(dims=d2, cell_cap=CAP2)
    out = {"tables": {"index": g.table, "packed": packed, "sentinel": sent,
                      "block": block}}
    for k in (5, 16):
        out[f"k{k}"] = {
            "grid": jh.grid_knn(q, pts, g, k=k),
            "packed": jh.grid_knn_packed(q, packed, origin, 2.0, dims=d2,
                                         cell_cap=CAP2, k=k),
            "oct": jh.grid_knn_oct(q, packed, origin, 2.0, k=k, **kw),
            "oct_sentinel": jh.grid_knn_oct_sentinel(q, sent, origin, 2.0,
                                                     k=k, **kw),
            "block": jh.grid_knn_block(q, block, origin, 2.0, k=k, **kw),
        }
    return (d1, d2), jax.tree.map(np.asarray, out)


def _port_case(pts, mask, q, origin_v, dims):
    d1, d2 = dims
    origin = torch.full((3,), origin_v)
    g = th.build_grid(pts, mask, origin, 1.0, dims=d1, cell_cap=CAP1)
    packed = th.build_grid_packed(pts, mask, origin, 2.0, dims=d2,
                                  cell_cap=CAP2)
    sent = th.build_grid_sentinel(pts, mask, origin, 2.0, dims=d2,
                                  cell_cap=CAP2)
    block = th.build_block_table(sent, dims=d2, cell_cap=CAP2)
    kw = dict(dims=d2, cell_cap=CAP2)
    out = {"tables": {"index": g.table, "packed": packed, "sentinel": sent,
                      "block": block}}
    for k in (5, 16):
        out[f"k{k}"] = {
            "grid": th.grid_knn(q, pts, g, k=k),
            "packed": th.grid_knn_packed(q, packed, origin, 2.0, k=k, **kw),
            "oct": th.grid_knn_oct(q, packed, origin, 2.0, k=k, **kw),
            "oct_sentinel": th.grid_knn_oct_sentinel(q, sent, origin, 2.0,
                                                     k=k, **kw),
            "block": th.grid_knn_block(q, block, origin, 2.0, k=k, **kw),
        }
    out["made"] = (g, packed, sent, origin, d2)
    return out


@pytest.fixture(scope="module")
def cases():
    pts, mask, q = thg._setup(seed=1)
    tp, tm, tq = T(np.array(pts)), T(np.array(mask)), T(np.array(q))
    out = {}
    for name, o in ORIGINS.items():
        dims, j = _jax_case(pts, mask, q, o)
        out[name] = (j, _port_case(tp, tm, tq, o, dims))
    return out, (tp, tm, tq)


@pytest.mark.parametrize("origin", list(ORIGINS))
@pytest.mark.parametrize("table", ["index", "packed", "sentinel", "block"])
def test_tables_bitwise(cases, origin, table):
    j, p = cases[0][origin]
    np.testing.assert_array_equal(p["tables"][table].numpy(),
                                  j["tables"][table])


def _neighbor_sets_equal(q, jd, jn, td, tn, tol=1e-5):
    """Per query: the valid picks' coordinates agree as sets, except where
    the k-th and (k+1)-th distances lie within tol (a near-tie at the
    boundary may swap one neighbor)."""
    real = jd < 1e30
    ties = 0
    for i in range(jd.shape[0]):
        a = {tuple(r) for r in jn[i][real[i]]}
        b = {tuple(r) for r in tn[i][td[i] < 1e30]}
        if a != b:
            ties += 1
            gap = np.diff(np.sort(np.concatenate([jd[i], td[i]])))
            assert gap.min() <= tol, (i, jd[i], td[i])
    return ties


@pytest.mark.parametrize("k", [5, 16])
@pytest.mark.parametrize("family", ["grid", "packed", "oct", "oct_sentinel",
                                    "block"])
def test_lookup_matches_jax(cases, family, k):
    (j, p), (_, _, q) = cases[0]["centered"], cases[1]
    jd, jn = j[f"k{k}"][family]
    td, tn = (a.numpy() for a in p[f"k{k}"][family])
    assert td.shape == (q.shape[0], k) and tn.shape == (q.shape[0], k, 3)
    real = jd < 1e30
    assert real.any(1).mean() > 0.5
    np.testing.assert_array_equal(td < 1e30, real)
    np.testing.assert_allclose(td[real], jd[real], rtol=0, atol=1e-5)
    ties = _neighbor_sets_equal(q.numpy(), jd, jn, td, tn)
    print(f"{family} k={k}: d2 max |diff| "
          f"{np.abs(td[real] - jd[real]).max():.3e}, bitwise "
          f"{np.array_equal(td, jd) and np.array_equal(tn, jn)}, "
          f"near-tie swaps {ties}")


@pytest.mark.parametrize("family", ["grid", "packed", "oct_sentinel"])
def test_chunked_lookup_equals_whole(cases, monkeypatch, family):
    """The lookups gather in chunks of queries (bounded memory): a tiny
    chunk gives the same result as one chunk."""
    (_, p), (pts, _, q) = cases[0]["centered"], cases[1]
    g, packed, sent, origin, d2 = p["made"]
    run = {"grid": lambda: th.grid_knn(q, pts, g, k=5),
           "packed": lambda: th.grid_knn_packed(
               q, packed, origin, 2.0, dims=d2, cell_cap=CAP2, k=5),
           "oct_sentinel": lambda: th.grid_knn_oct_sentinel(
               q, sent, origin, 2.0, dims=d2, cell_cap=CAP2, k=5)}[family]
    whole = run()
    monkeypatch.setattr(th, "_GATHER_ELEMS", 27 * CAP2 * 7)
    chunked = run()
    for a, b in zip(whole, chunked):
        assert torch.equal(a, b)


def test_lower_face_rule(cases):
    """The lower-face rule at k = 5 and 16: JAX grid_knn_oct_sentinel and
    the port's keep the in-grid cells of a query whose octant block starts
    below the grid; the batched solvers' block-row fetch gives it no
    candidate; the fetch of the port's `grid_register_step` (lower_pad
    tables, raw and compact) returns the octant rule's candidates."""
    (j, p), (_, _, q) = cases[0]["lower_face"], cases[1]
    g, packed, sent, origin, dims = p["made"]
    base = th._octant_base(q, origin, 2.0)
    near = (base == -1).any(1).numpy()
    assert near.sum() >= 20
    raw = tfetch.build_block_table_planar(sent, dims=dims, lower_pad=True)
    tables = {"raw": raw, "compact": tfetch.compact_row_space(raw)}
    read = (tfetch.block_cell_of(q, origin, 2.0, dims=dims, lower_pad=True)
            < raw.shape[0] - 1).numpy()
    for k in (5, 16):
        jd, jn = j[f"k{k}"]["oct_sentinel"]
        td = p[f"k{k}"]["oct_sentinel"][0].numpy()
        bd = p[f"k{k}"]["block"][0].numpy()
        kept = {}
        for kind, tab in tables.items():
            fd, fn = (a.numpy() for a in tfetch.make_pallas_block_knn(
                tab, origin, 2.0, dims=dims, cell_cap=CAP2, k=k)(q))
            np.testing.assert_array_equal(fd, jd)
            np.testing.assert_array_equal(fn[read], jn[read])
            np.testing.assert_array_equal(fn[jd < 1e30], jn[jd < 1e30])
            kept[kind] = int((fd[near] < 1e30).sum())
        n_j, n_t, n_b = (int((d[near] < 1e30).sum()) for d in (jd, td, bd))
        print(f"lower face: {near.sum()} of {q.shape[0]} queries within half"
              f" a cell (octant base -1), {int((~read).sum())} on the "
              f"sentinel row; candidates kept at K={k}: JAX "
              f"grid_knn_oct_sentinel {n_j}, port {n_t}, block-row fetch "
              f"{n_b}, lower_pad fetch {kept}; elsewhere equal: "
              f"{np.array_equal(td[~near] < 1e30, bd[~near] < 1e30)}")
        np.testing.assert_array_equal(td < 1e30, jd < 1e30)
        assert n_t == n_j > 0 and n_b == 0
        assert kept["raw"] == kept["compact"] == n_j
        np.testing.assert_array_equal(td[~near], bd[~near])
