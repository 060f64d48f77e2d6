"""Port parity: the candidate fetch (`ops/fetch.py`).

On the CPU `block_fetch` runs its plain version; it is held against the JAX
package's XLA block fetch `grid_knn_block` (same 2x2x2 block rule, exact
top-K on the CPU) and against brute force over each query's block, as
tests/test_pallas_fetch.py checks the TPU kernel.  Tolerance: d2 rtol 1e-6
(XLA's CPU backend contracts dx*dx + dy*dy + dz*dz into FMAs), and the
candidate coordinates equal exactly wherever the query's K-th and (K+1)-th
distances are not tied.  The row space of `grid_register_step`'s tables
(`lower_pad=True`, a row for every octant base from -1) keeps every row of
the batched row space bitwise (`test_lower_pad_row_space`).

The CUDA kernel against its plain version is tests/test_torch_kernels_cuda.py.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from feature_base_pointcloud_registration_tpu.ops import hashgrid as jhg
from feature_base_pointcloud_registration_tpu_torch.ops import (
    fetch as tfetch, hashgrid as thg)
from test_torch_batch import one_torch_thread  # noqa: F401

CELL = 2.0
DIMS = (8, 8, 4)
CAP = 16
ORIGIN = np.asarray([-8.0, -8.0, -4.0], np.float32)
K = 8


def _world(seed=0, m=4096):
    rng = np.random.RandomState(seed)
    pts = rng.uniform(-7, 7, (m, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(-3, 3, m)
    return pts, np.ones(m, bool)


@pytest.fixture(scope="module")
def tables():
    pts, mask = _world()
    jst = jhg.build_grid_sentinel(jnp.asarray(pts), jnp.asarray(mask),
                                  jnp.asarray(ORIGIN), CELL, dims=DIMS,
                                  cell_cap=CAP)
    tst = thg.build_grid_sentinel(torch.from_numpy(pts),
                                  torch.from_numpy(mask),
                                  torch.from_numpy(ORIGIN), CELL, dims=DIMS,
                                  cell_cap=CAP)
    planar = tfetch.build_block_table_planar(tst, dims=DIMS)
    block = jhg.build_block_table(jst, dims=DIMS, cell_cap=CAP)
    return planar, block, np.asarray(jst)


def _queries(seed, n=777):
    rng = np.random.RandomState(seed)
    q = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    q[:, 2] = rng.uniform(-2.5, 2.5, n)
    return q


def _fetch(planar, q, mask=None, planes_out=True):
    tq = torch.from_numpy(q)
    bc = tfetch.block_cell_of_xyz(tq[:, 0], tq[:, 1], tq[:, 2],
                                  torch.from_numpy(ORIGIN), CELL, dims=DIMS)
    if mask is not None:
        bc = torch.where(torch.from_numpy(mask), bc, planar.shape[0] - 1)
    return tfetch.block_fetch(planar, bc.to(torch.int32).contiguous(),
                              *[tq[:, i].contiguous() for i in range(3)],
                              K=K, planes_out=planes_out)


@pytest.mark.parametrize("seed", [1, 2])
def test_fetch_matches_xla_grid_knn_block(tables, seed):
    planar, block, _ = tables
    q = _queries(seed)
    d2, cand = _fetch(planar, q)
    nn = cand.view(3, K, -1).permute(2, 1, 0).numpy()
    jd2, jnn = jhg.grid_knn_block(jnp.asarray(q), block, jnp.asarray(ORIGIN),
                                  CELL, dims=DIMS, cell_cap=CAP, k=K)
    jd2, jnn = np.asarray(jd2), np.asarray(jnn)
    np.testing.assert_allclose(d2.numpy(), jd2, rtol=1e-6, atol=0)
    # same candidate sets; exact coordinates where the order is not tied
    np.testing.assert_array_equal(np.sort(nn, axis=1), np.sort(jnn, axis=1))
    untied = np.all(np.diff(jd2, axis=1) > 1e-5 * jd2[:, 1:], axis=1)
    assert untied.mean() > 0.9
    np.testing.assert_array_equal(nn[untied], jnn[untied])


def test_fetch_matches_bruteforce(tables):
    planar, _, st = tables
    q = _queries(3, n=512)
    d2, nn = _fetch(planar, q, planes_out=False)
    d2, nn = d2.numpy(), nn.numpy()
    assert nn.shape == (512, K, 3)
    st = st.reshape(-1, 3, CAP)
    Gx, Gy, Gz = DIMS
    tq = torch.from_numpy(q)
    bc = tfetch.block_cell_of_xyz(tq[:, 0], tq[:, 1], tq[:, 2],
                                  torch.from_numpy(ORIGIN), CELL,
                                  dims=DIMS).numpy()
    for i in range(0, 512, 37):
        b = bc[i]
        bx, by, bz = b // (Gy * Gz), (b // Gz) % Gy, b % Gz
        cands = [st[((bx + dx) * Gy + by + dy) * Gz + bz + dz].T
                 for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)
                 if bx + dx < Gx and by + dy < Gy and bz + dz < Gz]
        cand = np.concatenate(cands)
        cand = cand[np.abs(cand[:, 0]) < 1e8]
        want = np.sort(((cand - q[i]) ** 2).sum(-1))[:K]
        real = d2[i] < 1e17
        np.testing.assert_allclose(d2[i][real], want[:real.sum()],
                                   rtol=1e-5, atol=1e-5)
        back = ((nn[i] - q[i]) ** 2).sum(-1)
        np.testing.assert_allclose(back[real], d2[i][real], rtol=1e-5,
                                   atol=1e-5)


def test_fetch_out_of_grid_and_padding(tables):
    planar, _, _ = tables
    q = _queries(4, n=300)
    q[:100] = 500.0                                     # far out of grid
    mask = np.ones(300, bool)
    mask[200:] = False                                  # padded queries
    d2, cand = _fetch(planar, q, mask=mask)
    d2, cand = d2.numpy(), cand.numpy()
    assert (d2[:100] == np.float32(3e38)).all()
    assert (d2[200:] == np.float32(3e38)).all()
    assert (cand[:, :100] == 0).all() and (cand[:, 200:] == 0).all()
    assert (d2[100:200] < 1e17).all()
    # fewer than K valid slots: FAR candidates report 3e38 and FAR coords
    sparse = torch.full((2, 3 * 128), 1e9)
    sparse[0, [0, 128, 256]] = torch.tensor([1.0, 2.0, 3.0])
    at_origin = torch.zeros(1)
    d2s, cs = tfetch.block_fetch(sparse, torch.zeros(1, dtype=torch.int32),
                                 at_origin, at_origin, at_origin, K=K)
    assert d2s[0, 0] == 14.0 and (d2s[0, 1:] == np.float32(3e38)).all()
    assert (cs.view(3, K)[:, 1:] == 1e9).all()


def test_fetch_rejects_bad_inputs(tables):
    planar, _, _ = tables
    q = torch.zeros(4)
    bc = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        tfetch.block_fetch(planar, bc.long(), q, q, q, K=K)
    with pytest.raises(ValueError):
        tfetch.block_fetch(planar, bc, q, q, torch.zeros(5), K=K)
    with pytest.raises(ValueError):
        tfetch.block_fetch(planar, bc, q, q, q, K=planar.shape[1])


def test_lower_pad_row_space():
    """`lower_pad=True` (the tables of `grid_register_step`): one row for
    every octant base from -1 to G-1 on each axis; the rows of bases in
    [0, G) bitwise the batched tables' rows, the width unchanged; a padded
    row holds the points of its octant's in-grid cells; `lower_pad_of`
    reads the row space off either table kind and refuses a table of other
    dims; the row index of a query is its octant base's (the sentinel
    outside), and on the batched row space it is unchanged."""
    pts, mask = _world()
    tst = thg.build_grid_sentinel(torch.from_numpy(pts),
                                  torch.from_numpy(mask),
                                  torch.from_numpy(ORIGIN), CELL, dims=DIMS,
                                  cell_cap=CAP)
    plain = tfetch.build_block_table_planar(tst, dims=DIMS)
    padded = tfetch.build_block_table_planar(tst, dims=DIMS, lower_pad=True)
    Gx, Gy, Gz = DIMS
    Px, Py, Pz = Gx + 1, Gy + 1, Gz + 1
    assert padded.shape == (Px * Py * Pz + 1, plain.shape[1])
    b = torch.stack(torch.meshgrid(
        torch.arange(-1, Gx), torch.arange(-1, Gy), torch.arange(-1, Gz),
        indexing="ij"), -1).reshape(-1, 3)
    prow = ((b[:, 0] + 1) * Py + b[:, 1] + 1) * Pz + b[:, 2] + 1
    inner = (b >= 0).all(1)
    bi = b[inner]
    assert torch.equal(padded[prow[inner]],
                       plain[(bi[:, 0] * Gy + bi[:, 1]) * Gz + bi[:, 2]])
    counts = (tst[:-1, :CAP] < 1e8).sum(1).reshape(DIMS)
    for bx, by, bz in b[~inner].tolist()[::7]:
        want = sum(int(counts[x, y, z]) for x in (bx, bx + 1)
                   for y in (by, by + 1) for z in (bz, bz + 1)
                   if 0 <= x < Gx and 0 <= y < Gy and 0 <= z < Gz)
        row = ((bx + 1) * Py + by + 1) * Pz + bz + 1
        assert int((padded[row, :plain.shape[1] // 3] < 1e8).sum()) == want
    assert (padded[-1] == 1e9).all()
    for tab, pad in ((plain, False), (padded, True)):
        assert tfetch.lower_pad_of(tab, DIMS) is pad
        assert tfetch.lower_pad_of(tfetch.compact_row_space(tab), DIMS) is pad
    with pytest.raises(ValueError, match="neither row space"):
        tfetch.lower_pad_of(padded, (Gx, Gy, Gz + 2))
    rng = np.random.RandomState(4)
    q = torch.from_numpy((ORIGIN + rng.uniform(-1.5, 0.75, (2000, 3))
                          * CELL).astype(np.float32))
    base = thg._octant_base(q, torch.from_numpy(ORIGIN), CELL)
    rows = tfetch.block_cell_of(q, torch.from_numpy(ORIGIN), CELL, dims=DIMS,
                                lower_pad=True).long()
    ok = (base >= -1).all(1)
    assert ((base == -1).any(1) & ok).sum() > 300
    want = ((base[:, 0] + 1) * Py + base[:, 1] + 1) * Pz + base[:, 2] + 1
    assert torch.equal(rows, torch.where(ok, want, Px * Py * Pz))
    old = tfetch.block_cell_of(q, torch.from_numpy(ORIGIN), CELL,
                               dims=DIMS).long()
    ok0 = (base >= 0).all(1)
    assert torch.equal(old, torch.where(
        ok0, (base[:, 0] * Gy + base[:, 1]) * Gz + base[:, 2], Gx * Gy * Gz))
