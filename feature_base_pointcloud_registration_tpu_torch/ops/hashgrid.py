"""Spatial hash-grid map tables — the KD-tree replacement's build side.

Port of the part of the JAX package's `ops/hashgrid.py` that the batched
solvers use: the grid spec, its origin, the FAR-padded planar cell table,
the overflow diagnostic, and the cell-major block table with its plain
fetch (`grid_knn_block`).  Map points are bucketed into cells of
`cell_size` by a stable sort on cell id plus a rank-within-cell scatter (one
sort per map, amortized over every scan and GN iteration registered against
it).  Cells overflowing `cell_cap` drop their latest-sorted points.
"""

from __future__ import annotations

import math

import torch

from .fetch import _REF_CHUNK, block_cell_of
from .knn import _extract_topk

_FAR = 1.0e9  # empty slots: their distances dominate every real candidate
_BIG = 3.0e38


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


def build_grid_sentinel(pts, mask, origin, cell_size, *, dims, cell_cap):
    """Packed [n_cells+1, 3*cell_cap] planar (x|y|z) cell table, FAR-padded;
    the last row is the all-FAR sentinel for out-of-grid lookups."""
    M = pts.shape[0]
    n_cells = dims[0] * dims[1] * dims[2]
    cell, _ = _cell_of(pts, mask, origin, cell_size, dims)
    cell_s, order = torch.sort(cell, stable=True)
    first = torch.searchsorted(cell_s, cell_s, side="left")
    rank = torch.arange(M, device=pts.device) - first
    keep = (cell_s < n_cells) & (rank < cell_cap)

    table = torch.full((n_cells + 1, 3, cell_cap), _FAR,
                       dtype=torch.float32, device=pts.device)
    table[cell_s[keep], :, rank[keep]] = pts[order[keep]]
    return table.reshape(n_cells + 1, 3 * cell_cap)


def grid_overflow_fraction(pts, mask, origin, cell_size, *, dims, cell_cap):
    """Diagnostic: fraction of in-grid points dropped by cell_cap overflow."""
    n_cells = dims[0] * dims[1] * dims[2]
    cell, in_grid = _cell_of(pts, mask, origin, cell_size, dims)
    counts = torch.bincount(cell, minlength=n_cells + 1)[:n_cells]
    dropped = torch.clamp(counts - cell_cap, min=0).sum()
    total = torch.clamp(in_grid.sum(), min=1)
    return dropped.to(torch.float32) / total.to(torch.float32)


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
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                nx, ny, nz = cx + dx, cy + dy, cz + dz
                ok = (nx < Gx) & (ny < Gy) & (nz < Gz)
                rows.append(sentinel_table[torch.where(
                    ok, (nx * Gy + ny) * Gz + nz, n_cells)])
    sent = torch.full((1, 8 * sentinel_table.shape[1]), _FAR,
                      dtype=sentinel_table.dtype, device=dev)
    return torch.cat([torch.cat(rows, 1), sent], 0)


def grid_knn_block(query, block_table, origin, cell_size, *, dims, cell_cap,
                   k: int = 5):
    """Octant k-NN via one block-row gather per query: query [Q,3] ->
    (d2 [Q,k] ascending with ties to the lower slot, d2 > 1e17 reported as
    3e38; nn [Q,k,3]).  Exact for every k (the JAX package's k > 5
    `approx_min_k` is exact off the TPU); the [Q, 8*cap] gather runs in
    chunks of queries so that memory stays bounded."""
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
        v, pos = _extract_topk(d2, k)
        nn[s:e] = torch.gather(planes, 2, pos.long()[:, None, :].expand(
            -1, 3, -1)).transpose(1, 2)
        vals[s:e] = torch.where(v > 1e17, _BIG, v)
    return vals, nn


def make_block_grid_knn(block_table, origin, cell_size, *, dims, cell_cap,
                        k: int = 5):
    return lambda q: grid_knn_block(q, block_table, origin, cell_size,
                                    dims=dims, cell_cap=cell_cap, k=k)
