"""Spatial hash-grid neighbor index — the KD-tree replacement.

Port of the JAX package's `ops/hashgrid.py`.  A KD-tree answers "5 nearest
within 1 m" (every accept gate of the reference caps the 5th-NN at 1 m,
ref: src/mapOptmization.h:1027,1154); a dense voxel grid over the local
map's volume answers it in O(1):

  build:  bucket map points into cells of `cell_size` by a stable sort on
          cell id plus a rank-within-cell scatter (one sort per map,
          amortized over every scan and GN iteration registered against
          it); a cell overflowing `cell_cap` drops its latest-sorted points;
  query:  gather a neighborhood's candidates, compute exact distances, take
          the exact top-k among them.

Four table layouts and their lookups, as in the JAX package:

  * `build_grid_table` / `grid_knn`: a [n_cells, cap] table of point
    indices and a 27-cell gather (exact for every neighbor within
    `cell_size`);
  * `build_grid_packed` / `grid_knn_packed`: each cell's coordinates packed
    in its row (planar x|y|z|valid) and the same 27-cell gather;
    `grid_knn_oct` takes the 2x2x2 cells of the query's octant instead
    (exact within cell_size / 2);
  * `build_grid_sentinel` / `grid_knn_oct_sentinel`: three planes, FAR-padded,
    a sentinel row for out-of-grid cells, the octant lookup;
  * `build_block_table` / `grid_knn_block`: one row per 2x2x2 block
    (cell-major), one row gather per query; the fetch kernels' tables
    (`ops/fetch.py`) are its plane-major form.

In the JAX package each `_core` function exists so that its body can be
traced inside an outer jit, beside a jitted twin; here each pair is one
function, and the `_core` name is an alias of it.  Every lookup runs its
gathers in chunks of queries so that no gather holds more than
`_GATHER_ELEMS` candidates (a 27-cell gather at cap 48 over 2.1 M queries
would otherwise take ~32 GB).  Candidates are ranked in the JAX package's
order (neighbor cell, then slot), and ties go to the lower position.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .fetch import _REF_CHUNK, block_cell_of
from .knn import _extract_topk

_FAR = 1.0e9  # empty slots: their distances dominate every real candidate
_BIG = 3.0e38
_GATHER_ELEMS = 1 << 25  # candidates one chunk of a lookup gathers
_OFFS27 = [(dx, dy, dz) for dx in (-1, 0, 1) for dy in (-1, 0, 1)
           for dz in (-1, 0, 1)]
_OFFS8 = [(dx, dy, dz) for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]


def _topk_small(d2, k: int):
    """Smallest-k over the last axis: (values ascending, int32 positions),
    ties to the lower position.

    The JAX package takes k argmin passes for k <= 5 (the 5-NN every gate
    keys off must be exact) and `lax.approx_min_k(recall_target=0.95)` for
    the candidate prefetch at k > 5, which is exact on XLA's CPU backend
    and approximate only on the TPU.  The port is exact for every k
    (`_extract_topk`, the rule of `lax.top_k`); it does not imitate a
    recall target."""
    return _extract_topk(d2, k)


class GridIndex(NamedTuple):
    table: torch.Tensor      # i32 [n_cells, cell_cap] point indices (M = pad)
    origin: torch.Tensor     # f32 [3]
    cell_size: torch.Tensor  # f32 []
    dims: tuple              # (Gx, Gy, Gz)


def default_grid_spec(half_extent, cell_size: float = 1.0,
                      margin: float = 2.0):
    """Static grid dims covering a local-map crop box of +-half_extent."""
    return tuple(int(math.ceil(2.0 * (float(h) + margin) / cell_size))
                 for h in half_extent)


def grid_origin(center, half_extent, margin: float = 2.0, *, device):
    return (torch.as_tensor(center, dtype=torch.float32, device=device)
            - torch.as_tensor(half_extent, dtype=torch.float32,
                              device=device)
            - margin)


def _cell_of(pts, mask, origin, cell_size, dims):
    """Cell id per point; masked or out-of-grid points -> n_cells."""
    Gx, Gy, Gz = dims
    ijk = torch.floor((pts - origin) / cell_size).to(torch.int64)
    in_grid = (mask & (ijk >= 0).all(-1) & (ijk[:, 0] < Gx)
               & (ijk[:, 1] < Gy) & (ijk[:, 2] < Gz))
    cell = (ijk[:, 0] * Gy + ijk[:, 1]) * Gz + ijk[:, 2]
    return torch.where(in_grid, cell, Gx * Gy * Gz), in_grid


def _bucket(pts, mask, origin, cell_size, dims, cell_cap):
    """The points each table keeps: (cell, slot, point index), one entry per
    kept point, the slot its rank within its cell in point order."""
    M = pts.shape[0]
    n_cells = dims[0] * dims[1] * dims[2]
    cell, _ = _cell_of(pts, mask, origin, cell_size, dims)
    cell_s, order = torch.sort(cell, stable=True)
    first = torch.searchsorted(cell_s, cell_s, side="left")
    rank = torch.arange(M, device=pts.device) - first
    keep = (cell_s < n_cells) & (rank < cell_cap)
    return cell_s[keep], rank[keep], order[keep]


def build_grid_table(pts, mask, origin, cell_size, *, dims, cell_cap):
    """Index table [n_cells, cell_cap] int32 of the masked in-grid points
    (M pads an empty slot); wrap it with `GridIndex` (or use `build_grid`)."""
    n_cells = dims[0] * dims[1] * dims[2]
    cell, slot, idx = _bucket(pts, mask, origin, cell_size, dims, cell_cap)
    table = torch.full((n_cells, cell_cap), pts.shape[0], dtype=torch.int32,
                       device=pts.device)
    table[cell, slot] = idx.to(torch.int32)
    return table


build_grid_table_core = build_grid_table


def build_grid(pts, mask, origin, cell_size, *, dims, cell_cap) -> GridIndex:
    """`build_grid_table` wrapped in a GridIndex on the points' device."""
    dev = pts.device
    return GridIndex(
        table=build_grid_table(pts, mask, origin, cell_size, dims=dims,
                               cell_cap=cell_cap),
        origin=torch.as_tensor(origin, dtype=torch.float32, device=dev),
        cell_size=torch.as_tensor(cell_size, dtype=torch.float32,
                                  device=dev),
        dims=tuple(dims))


def _neighbour_cells(base, offs, dims):
    """Cells base + offs of each query: base [Q,3] -> (cell ids [Q,n],
    in-grid [Q,n])."""
    Gx, Gy, Gz = dims
    n = base[:, None, :] + torch.tensor(offs, dtype=base.dtype,
                                        device=base.device)
    ok = ((n >= 0).all(-1) & (n[..., 0] < Gx) & (n[..., 1] < Gy)
          & (n[..., 2] < Gz))
    return (n[..., 0] * Gy + n[..., 1]) * Gz + n[..., 2], ok


def _octant_base(query, origin, cell_size):
    """Lower corner cell of the 2x2x2 block nearest each query."""
    rel = (query - origin) / cell_size
    ijk = torch.floor(rel).to(torch.int64)
    return ijk - (rel - ijk < 0.5).to(torch.int64)


def _nearest(query, cx, cy, cz, valid, k):
    """Exact top-k of query [Q,3] among candidate planes [Q,C]:
    (d2 [Q,k], nn [Q,k,3]); invalid candidates (valid False) rank at 3e38."""
    dx = query[:, 0:1] - cx
    dy = query[:, 1:2] - cy
    dz = query[:, 2:3] - cz
    d2 = dx * dx + dy * dy + dz * dz
    if valid is not None:
        d2 = torch.where(valid, d2, _BIG)
    vals, pos = _topk_small(d2, k)
    pos = pos.long()
    return vals, torch.stack([torch.gather(c, 1, pos) for c in (cx, cy, cz)],
                             dim=-1)


def _chunked(query, per_query: int, k: int, lookup):
    """lookup(query chunk) -> (d2, nn) over chunks of at most
    _GATHER_ELEMS / per_query queries."""
    Q = query.shape[0]
    vals = torch.empty(Q, k, dtype=torch.float32, device=query.device)
    nn = torch.empty(Q, k, 3, dtype=torch.float32, device=query.device)
    step = max(1, _GATHER_ELEMS // per_query)
    for s in range(0, Q, step):
        e = min(Q, s + step)
        vals[s:e], nn[s:e] = lookup(query[s:e])
    return vals, nn


def grid_knn(query, pts, grid: GridIndex, k: int = 5):
    """k-NN among the 27-cell candidates of an index table: query [Q,3] ->
    (d2 [Q,k], nn [Q,k,3]).  Exact for every neighbor within `cell_size`
    of the query (the reference's gates reject anything farther)."""
    M = pts.shape[0]
    cap = grid.table.shape[1]

    def lookup(q):
        Q = q.shape[0]
        ijk = torch.floor((q - grid.origin) / grid.cell_size).to(torch.int64)
        cell, ok = _neighbour_cells(ijk, _OFFS27, grid.dims)
        cand = grid.table[torch.where(ok, cell, 0)].reshape(Q, 27 * cap)
        okc = ok[:, :, None].expand(Q, 27, cap).reshape(Q, 27 * cap)
        cand = torch.where(okc, cand, M)
        safe = torch.clamp(cand, max=M - 1).long()
        return _nearest(q, pts[:, 0][safe], pts[:, 1][safe], pts[:, 2][safe],
                        cand < M, k)

    return _chunked(query, 27 * cap, k, lookup)


def make_grid_knn(pts, grid: GridIndex, k: int = 5):
    """knn closure (query [Q,3] -> (d2, nn)) backed by the grid index."""
    return lambda q: grid_knn(q, pts, grid, k=k)


def build_grid_packed(pts, mask, origin, cell_size, *, dims, cell_cap):
    """Packed cell table [n_cells, 4*cell_cap]: planar x|y|z|valid, each
    plane cell_cap slots, zero-padded."""
    n_cells = dims[0] * dims[1] * dims[2]
    cell, slot, idx = _bucket(pts, mask, origin, cell_size, dims, cell_cap)
    table = torch.zeros(n_cells, 4, cell_cap, dtype=torch.float32,
                        device=pts.device)
    table[cell, :, slot] = torch.cat(
        [pts[idx], torch.ones(idx.shape[0], 1, dtype=torch.float32,
                              device=pts.device)], 1)
    return table.reshape(n_cells, 4 * cell_cap)


build_grid_packed_core = build_grid_packed


def _packed_lookup(query, packed, origin, cell_size, dims, cell_cap, k,
                   offs, base_of):
    """k-NN among the cells base_of(query) + offs of a packed table."""
    n = len(offs)

    def lookup(q):
        Q = q.shape[0]
        cell, ok = _neighbour_cells(base_of(q), offs, dims)
        rows = packed[torch.where(ok, cell, 0)].view(Q, n, 4, cell_cap)
        cx, cy, cz, valid = (rows[:, :, i, :].reshape(Q, n * cell_cap)
                             for i in range(4))
        okc = ok[:, :, None].expand(Q, n, cell_cap).reshape(Q, n * cell_cap)
        return _nearest(q, cx, cy, cz, (valid > 0.5) & okc, k)

    return _chunked(query, n * cell_cap, k, lookup)


def grid_knn_packed(query, packed, origin, cell_size, *, dims, cell_cap,
                    k: int = 5):
    """k-NN among the 27-cell candidates of a packed table: the contract of
    `grid_knn` (row gathers instead of index + coordinate gathers)."""
    return _packed_lookup(
        query, packed, origin, cell_size, dims, cell_cap, k, _OFFS27,
        lambda q: torch.floor((q - origin) / cell_size).to(torch.int64))


def make_packed_grid_knn(packed, origin, cell_size, *, dims, cell_cap,
                         k: int = 5):
    return lambda q: grid_knn_packed(q, packed, origin, cell_size, dims=dims,
                                     cell_cap=cell_cap, k=k)


def grid_knn_oct(query, packed, origin, cell_size, *, dims, cell_cap,
                 k: int = 5):
    """k-NN among the 2x2x2 cells of the query's octant in a packed table
    (cell_size >= 2 * the gate radius): exact within cell_size / 2; 8 rows
    instead of 27.  An out-of-grid cell contributes no candidate."""
    return _packed_lookup(query, packed, origin, cell_size, dims, cell_cap,
                          k, _OFFS8,
                          lambda q: _octant_base(q, origin, cell_size))


def make_oct_grid_knn(packed, origin, cell_size, *, dims, cell_cap,
                      k: int = 5):
    return lambda q: grid_knn_oct(q, packed, origin, cell_size, dims=dims,
                                  cell_cap=cell_cap, k=k)


def grid_overflow_fraction(pts, mask, origin, cell_size, *, dims, cell_cap):
    """Diagnostic: fraction of in-grid points dropped by cell_cap overflow."""
    n_cells = dims[0] * dims[1] * dims[2]
    cell, in_grid = _cell_of(pts, mask, origin, cell_size, dims)
    counts = torch.bincount(cell, minlength=n_cells + 1)[:n_cells]
    dropped = torch.clamp(counts - cell_cap, min=0).sum()
    total = torch.clamp(in_grid.sum(), min=1)
    return dropped.to(torch.float32) / total.to(torch.float32)


def build_grid_sentinel(pts, mask, origin, cell_size, *, dims, cell_cap):
    """Packed [n_cells+1, 3*cell_cap] planar (x|y|z) cell table, FAR-padded;
    the last row is the all-FAR sentinel for out-of-grid lookups."""
    n_cells = dims[0] * dims[1] * dims[2]
    cell, slot, idx = _bucket(pts, mask, origin, cell_size, dims, cell_cap)
    table = torch.full((n_cells + 1, 3, cell_cap), _FAR,
                       dtype=torch.float32, device=pts.device)
    table[cell, :, slot] = pts[idx]
    return table.reshape(n_cells + 1, 3 * cell_cap)


build_grid_sentinel_core = build_grid_sentinel


def grid_knn_oct_sentinel(query, packed, origin, cell_size, *, dims,
                          cell_cap, k: int = 5):
    """Octant k-NN over a sentinel table (`build_grid_sentinel`): out-of-grid
    cells read the all-FAR sentinel row, and picks with d2 > 1e17 (FAR
    slots) report 3e38, their coordinates FAR.

    Unlike the batched solvers' block fetches (`grid_knn_block`, and
    `ops/fetch.py` on its default row space), a query whose octant block
    starts below the grid's lower face (base index -1 on an axis) keeps
    its in-grid cells here; such a block fetch gives it no candidate.  The
    fetch of `grid_register_step` (`ops/fetch.py`, lower_pad) keeps them
    too."""
    Gx, Gy, Gz = dims
    n_cells = Gx * Gy * Gz

    def lookup(q):
        Q = q.shape[0]
        cell, ok = _neighbour_cells(_octant_base(q, origin, cell_size),
                                    _OFFS8, dims)
        rows = packed[torch.where(ok, cell, n_cells)].view(Q, 8, 3, cell_cap)
        cx, cy, cz = (rows[:, :, i, :].reshape(Q, 8 * cell_cap)
                      for i in range(3))
        vals, nn = _nearest(q, cx, cy, cz, None, k)
        return torch.where(vals > 1e17, _BIG, vals), nn

    return _chunked(query, 8 * cell_cap, k, lookup)


def make_oct_sentinel_knn(packed, origin, cell_size, *, dims, cell_cap,
                          k: int = 5):
    return lambda q: grid_knn_oct_sentinel(q, packed, origin, cell_size,
                                           dims=dims, cell_cap=cell_cap, k=k)


# ---------------------------------------------------------------------------
# Block table: one row per block corner holding the full 2x2x2 candidate set
# (cell-major: [cell0 x|y|z, cell1 x|y|z, ...]), the plain fetch that
# `batch_register_blocks` runs and the kernels are checked against.
# ---------------------------------------------------------------------------


def build_block_table(sentinel_table, *, dims, cell_cap):
    """[n_cells+1, 3*cap] sentinel table -> [n_cells+1, 8*3*cap] block rows.

    Row b = concat of rows {b + (dx,dy,dz)} for dx,dy,dz in {0,1}; block
    corners whose neighbours fall outside the grid take the sentinel row.
    The extra row (index n_cells) is all-FAR for out-of-grid queries.
    """
    del cell_cap  # the row width comes with the table
    Gx, Gy, Gz = dims
    n_cells = Gx * Gy * Gz
    dev = sentinel_table.device
    cid = torch.arange(n_cells, device=dev)
    cx, cy, cz = cid // (Gy * Gz), (cid // Gz) % Gy, cid % Gz
    rows = []
    for dx, dy, dz in _OFFS8:
        nx, ny, nz = cx + dx, cy + dy, cz + dz
        ok = (nx < Gx) & (ny < Gy) & (nz < Gz)
        rows.append(sentinel_table[torch.where(
            ok, (nx * Gy + ny) * Gz + nz, n_cells)])
    sent = torch.full((1, 8 * sentinel_table.shape[1]), _FAR,
                      dtype=sentinel_table.dtype, device=dev)
    return torch.cat([torch.cat(rows, 1), sent], 0)


build_block_table_core = build_block_table


def grid_knn_block(query, block_table, origin, cell_size, *, dims, cell_cap,
                   k: int = 5):
    """Octant k-NN via one block-row gather per query: query [Q,3] ->
    (d2 [Q,k] ascending with ties to the lower slot, d2 > 1e17 reported as
    3e38; nn [Q,k,3]).  Exact for every k (see `_topk_small`); the
    [Q, 8*cap] gather runs in chunks of queries so that memory stays
    bounded."""
    Q = query.shape[0]
    W = 8 * cell_cap
    bcell = block_cell_of(query, origin, cell_size, dims=dims).to(torch.int64)
    vals = torch.empty(Q, k, dtype=torch.float32, device=query.device)
    nn = torch.empty(Q, k, 3, dtype=torch.float32, device=query.device)
    for s in range(0, Q, _REF_CHUNK):
        e = min(Q, s + _REF_CHUNK)
        rows = block_table[bcell[s:e]].view(e - s, 8, 3, cell_cap)
        planes = rows.transpose(1, 2).reshape(e - s, 3, W)   # cell-then-slot
        d = planes - query[s:e, :, None]
        d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
        v, pos = _topk_small(d2, k)
        nn[s:e] = torch.gather(planes, 2, pos.long()[:, None, :].expand(
            -1, 3, -1)).transpose(1, 2)
        vals[s:e] = torch.where(v > 1e17, _BIG, v)
    return vals, nn


def make_block_grid_knn(block_table, origin, cell_size, *, dims, cell_cap,
                        k: int = 5):
    return lambda q: grid_knn_block(q, block_table, origin, cell_size,
                                    dims=dims, cell_cap=cell_cap, k=k)
