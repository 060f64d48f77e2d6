"""Candidate fetch for the hash-grid hot path: block tables + top-K kernels.

Port of the JAX package's `ops/pallas_fetch.py` (the TPU kernels
`_fetch_kernel` behind `fused_block_fetch` and `_resident_kernel` behind
`fused_resident_fetch`).  Replaces the reference's per-query
kdtree->nearestKSearch calls (ref: src/mapOptmization.h:1020,1143) on the
batched path.

Table layout: one PLANE-MAJOR block row per 2x2x2 cell block, [R, 3*W] with
row = [ x(W slots) | y | z ]; the last row is the all-FAR sentinel.  The JAX
table is the same rows reshaped to [R, 3*W/128, 128] (TPU lane tiling).
Empty slots hold FAR=1e9 m, so no validity plane is needed: their d2 is
~3e18, reported as 3e38 (downstream gates treat d2 > 1e17 as "no
candidate").  A `PlanarTable` keeps only the populated rows of such a table
plus an index from raw block ids to compact rows.

Row space.  Row b of the batched solvers' tables is the block whose lower
corner cell is b, for b in [0, G) on each axis (the JAX package's rule): a
query within half a cell of a lower face (octant base -1 on an axis) reads
the sentinel and gets no candidate.  `lower_pad=True` (the tables of
`grid_register_step`) adds one padded cell layer below each lower face, so
that every octant base in [-1, G) has a row, (Gx+1)(Gy+1)(Gz+1) rows in
all: the padded cells are empty, and a query with base -1 reads the
in-grid cells of its octant, the candidates of
`ops/hashgrid.py::grid_knn_oct_sentinel`.  The rows of bases in [0, G) are
the same in both layouts.

`block_fetch` (raw table) and `resident_fetch` (compact table) launch the
CUDA kernels `csrc/block_fetch.cu` and `csrc/resident_fetch.cu` on CUDA
tensors and run their plain versions on CPU tensors.  Both keep one
contract: a sentinel query reads no row and gets d2 = 3e38 and zero
coordinates.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .. import kernels

_BIG = 3.0e38
_FAR = 1.0e9
_REF_CHUNK = 1 << 16  # queries per step of the plain version (bounds memory)


def _row_space(dims, lower_pad: bool):
    """(lowest octant base, rows per axis) of a block-row space."""
    lo = -1 if lower_pad else 0
    return lo, tuple(g - lo for g in dims)


def build_block_table_planar(sentinel_table, *, dims, compact: bool = True,
                             lower_pad: bool = False):
    """[n_cells+1, 3*cap] sentinel table -> [n_rows+1, 3*W] block rows.

    Row b covers cells b+(0..1)^3; out-of-grid neighbours take the sentinel
    row.  n_rows is n_cells, or with lower_pad=True one row for each
    octant base in -1..G-1 of each axis (the module docstring's row space).
    With compact=True each row's valid points move to the front (a stable
    sort, so in cell-then-slot order) and the row width shrinks from 8*cap
    to W = max valid count over blocks rounded up to 128 (the JAX package's
    rule, so both packages build tables of one shape; a padded row holds a
    subset of an in-grid row's cells, so lower_pad keeps W).  The candidate
    SET per query is unchanged; only slot order within a row is.
    """
    Gx, Gy, Gz = dims
    n_cells = Gx * Gy * Gz
    lo, (Px, Py, Pz) = _row_space(dims, lower_pad)
    n_rows = Px * Py * Pz
    cap = sentinel_table.shape[1] // 3
    dev = sentinel_table.device

    rid = torch.arange(n_rows, device=dev)
    bx, by, bz = rid // (Py * Pz) + lo, (rid // Pz) % Py + lo, rid % Pz + lo
    nbr = []
    for dx in (0, 1):
        for dy in (0, 1):
            for dz in (0, 1):
                nx, ny, nz = bx + dx, by + dy, bz + dz
                ok = ((nx >= 0) & (ny >= 0) & (nz >= 0)
                      & (nx < Gx) & (ny < Gy) & (nz < Gz))
                nbr.append(torch.where(ok, (nx * Gy + ny) * Gz + nz,
                                       n_cells))
    rows = sentinel_table[torch.stack(nbr, 1)]           # [n, 8, 3*cap]
    planes = rows.reshape(n_rows, 8, 3, cap).transpose(1, 2).reshape(
        n_rows, 3, 8 * cap)                              # [n, 3, 8*cap]
    W = 8 * cap
    if compact:
        invalid = (planes[:, 0] >= 1e8).to(torch.uint8)
        _, order = torch.sort(invalid, dim=1, stable=True)
        planes = torch.gather(planes, 2, order[:, None, :].expand(-1, 3, -1))
        max_valid = int((1 - invalid).sum(1).max()) if n_rows else 0
        W = min(max(128, -(-max_valid // 128) * 128), 8 * cap)
        planes = planes[:, :, :W]
    sent = torch.full((1, 3 * W), _FAR, dtype=sentinel_table.dtype,
                      device=dev)
    return torch.cat([planes.reshape(n_rows, 3 * W), sent], 0).contiguous()


def block_cell_of_xyz(qx, qy, qz, origin, cell_size, *, dims,
                      lower_pad: bool = False):
    """Block-corner row id per query (octant rule; an octant base outside
    the row space -> the sentinel row n_rows), int32, on component arrays of
    any shape.  lower_pad selects the row space of
    `build_block_table_planar`."""
    lo, (Px, Py, Pz) = _row_space(dims, lower_pad)
    Gx, Gy, Gz = dims

    def base_of(q, o):
        rel = (q - o) / cell_size
        ijk = torch.floor(rel).to(torch.int32)
        return ijk - (rel - ijk < 0.5).to(torch.int32)

    bx = base_of(qx, origin[0]) - lo
    by = base_of(qy, origin[1]) - lo
    bz = base_of(qz, origin[2]) - lo
    ok = ((bx >= 0) & (by >= 0) & (bz >= 0)
          & (bx < Gx - lo) & (by < Gy - lo) & (bz < Gz - lo))
    return torch.where(ok, (bx * Py + by) * Pz + bz, Px * Py * Pz).to(
        torch.int32)


def _check(table, bcell, qx, qy, qz, K):
    if table.dim() != 2 or table.shape[1] % 3:
        raise ValueError(f"table must be [R, 3*W], got {tuple(table.shape)}")
    W = table.shape[1] // 3
    if not 1 <= K <= W:
        raise ValueError(f"K={K} must be in [1, W={W}]")
    Q = bcell.shape[0]
    for name, t, dt in (("table", table, torch.float32),
                        ("bcell", bcell, torch.int32),
                        ("qx", qx, torch.float32), ("qy", qy, torch.float32),
                        ("qz", qz, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.device != table.device:
            raise ValueError(f"{name} is on {t.device}, table on "
                             f"{table.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name != "table" and tuple(t.shape) != (Q,):
            raise ValueError(f"{name} must be [{Q}], got {tuple(t.shape)}")
    return W, Q


def block_fetch_reference(table, bcell, qx, qy, qz, *, K: int):
    """Plain PyTorch version of the fetch: (d2 [Q,K], cand [3K,Q]).

    Gathers each query's row, computes d2 = (dx*dx + dy*dy) + dz*dz, and
    takes the first K of a stable ascending sort (ties -> lowest slot;
    `torch.topk` does not promise that).  d2 > 1e17 reports 3e38.  A
    sentinel query (bcell == R-1) gets d2 = 3e38 and zero coordinates."""
    W, Q = _check(table, bcell, qx, qy, qz, K)
    sentinel = table.shape[0] - 1
    d2_out = torch.empty(Q, K, dtype=torch.float32, device=table.device)
    cand = torch.empty(3, K, Q, dtype=torch.float32, device=table.device)
    for s in range(0, Q, _REF_CHUNK):
        e = min(Q, s + _REF_CHUNK)
        bc = bcell[s:e].to(torch.int64)
        rows = table[bc].view(e - s, 3, W)
        dx = rows[:, 0] - qx[s:e, None]
        dy = rows[:, 1] - qy[s:e, None]
        dz = rows[:, 2] - qz[s:e, None]
        d2 = dx * dx + dy * dy + dz * dz
        d2s, idx = torch.sort(d2, dim=1, stable=True)
        d2s, idx = d2s[:, :K], idx[:, :K]
        nn = torch.gather(rows, 2, idx[:, None, :].expand(-1, 3, -1))
        sent = (bc == sentinel)[:, None]
        d2_out[s:e] = torch.where(sent | (d2s > 1e17), _BIG, d2s)
        cand[:, :, s:e] = torch.where(sent[:, None], 0.0, nn).permute(1, 2, 0)
    return d2_out, cand.view(3 * K, Q)


def _fetch(launch, plain, table, bcell, qx, qy, qz, K, planes_out):
    """Shared wrapper: CPU tensors run `plain`, CUDA tensors `launch`."""
    W, Q = _check(table, bcell, qx, qy, qz, K)
    if table.device.type == "cpu":
        d2, cand = plain(table, bcell, qx, qy, qz, K=K)
    elif table.device.type == "cuda":
        d2 = torch.empty(Q, K, dtype=torch.float32, device=table.device)
        cand = torch.empty(3 * K, Q, dtype=torch.float32,
                           device=table.device)
        launch(table, bcell, qx, qy, qz, d2, cand, K=K)
    else:
        raise ValueError(f"unsupported device {table.device}")
    if planes_out:
        return d2, cand
    # a contiguous copy: a solver's reductions over K then meet the layout
    # every other candidate source gives them (on the card a reduction's
    # order can follow the layout, and with it the last bits)
    return d2, cand.view(3, K, Q).permute(2, 1, 0).contiguous()


def block_fetch(table, bcell, qx, qy, qz, *, K: int = 8,
                planes_out: bool = True):
    """Exact top-K of each query's block row: (d2 [Q,K], candidates).

    table [R, 3*W] from build_block_table_planar; bcell [Q] int32 row ids
    (point padded/invalid queries at the sentinel row R-1, which costs no
    row read); qx, qy, qz [Q] query components.  d2 is ascending per query,
    ties broken by the lowest slot.  planes_out=True returns the candidates
    plane-major as one [3K, Q] tensor (x rows 0..K-1, then y, then z) — the
    layout `gn_round` reads; planes_out=False returns nn [Q, K, 3].

    CPU tensors run the plain version; CUDA tensors launch the kernel
    `csrc/block_fetch.cu`.
    """
    def launch(*args, K):
        kernels.launch_block_fetch(*args, K=K)
        block_fetch.launches += 1

    return _fetch(launch, block_fetch_reference, table, bcell, qx, qy, qz,
                  K, planes_out)


block_fetch.launches = 0


# ---------------------------------------------------------------------------
# Resident-table fetch: the same function against a row-compacted table.
# ---------------------------------------------------------------------------

RESIDENT_TABLE_CAP = 10 * 1024 * 1024   # bytes; the JAX package's rule


class PlanarTable(NamedTuple):
    """Row-compacted planar block table for the resident fetch.

    table: [Rp+1, 3*W] — populated block rows only, the all-FAR sentinel
    last.  rows_index: [n_rows+1] int32 — raw block row id -> compact row
    (unpopulated and sentinel rows -> Rp).
    """
    table: torch.Tensor
    rows_index: torch.Tensor


def compact_row_space(table_planar) -> PlanarTable:
    """Drop unpopulated block rows: [R, 3*W] -> PlanarTable.

    A row is populated when any of its x slots is valid (< 1e8); the old
    sentinel row R-1 drops and an all-FAR row is appended.  Most of a map
    grid's cells are empty (the grid covers the bounding box, the cloud
    covers surfaces), so the compact table is a fraction of the raw one.
    """
    R, W3 = table_planar.shape
    pop = (table_planar[:, :W3 // 3] < 1e8).any(1)
    pop[R - 1] = False
    idx = torch.nonzero(pop)[:, 0]
    Rp = idx.shape[0]
    rows_index = torch.full((R,), Rp, dtype=torch.int32,
                            device=table_planar.device)
    rows_index[idx] = torch.arange(Rp, dtype=torch.int32,
                                   device=table_planar.device)
    sent = torch.full((1, W3), _FAR, dtype=table_planar.dtype,
                      device=table_planar.device)
    return PlanarTable(torch.cat([table_planar[idx], sent], 0), rows_index)


def resident_fetch_reference(table, bcell, qx, qy, qz, *, K: int):
    """Plain PyTorch version of the resident fetch: `block_fetch_reference`
    on the compact table (gather the compact rows, stable sort, sentinel
    row Rp -> d2 3e38 and zero coordinates), chunked the same way."""
    return block_fetch_reference(table, bcell, qx, qy, qz, K=K)


def resident_fetch(table, bcell, qx, qy, qz, *, K: int = 8,
                   planes_out: bool = True):
    """`block_fetch`'s contract against a compact table: table [Rp+1, 3*W]
    (`PlanarTable.table`), bcell [Q] COMPACT row ids (route raw block ids
    through `PlanarTable.rows_index`; Rp is the sentinel).

    CPU tensors run the plain version; CUDA tensors launch the kernel
    `csrc/resident_fetch.cu` (W a multiple of 128, at most 512)."""
    def launch(*args, K):
        kernels.launch_resident_fetch(*args, K=K)
        resident_fetch.launches += 1

    return _fetch(launch, resident_fetch_reference, table, bcell, qx, qy,
                  qz, K, planes_out)


resident_fetch.launches = 0


def block_cell_of(query, origin, cell_size, *, dims,
                  lower_pad: bool = False):
    """Block-corner row id per query [..., 3] (`block_cell_of_xyz`)."""
    return block_cell_of_xyz(query[..., 0], query[..., 1], query[..., 2],
                             origin, cell_size, dims=dims,
                             lower_pad=lower_pad)


def fetch_rows(table, bcell, qx, qy, qz, *, K: int, planes_out: bool = True):
    """The fetch of either table kind on RAW block ids: a raw planar table
    runs `block_fetch`; a `PlanarTable` routes the ids through its
    rows_index and runs `resident_fetch`."""
    if isinstance(table, PlanarTable):
        rows = table.rows_index[bcell.long()]
        return resident_fetch(table.table, rows, qx, qy, qz, K=K,
                              planes_out=planes_out)
    return block_fetch(table, bcell, qx, qy, qz, K=K, planes_out=planes_out)


def lower_pad_of(table, dims) -> bool:
    """The row space a table of either kind was built on (its row count
    tells): True for `build_block_table_planar(lower_pad=True)`'s."""
    rows = (table.rows_index if isinstance(table, PlanarTable)
            else table).shape[0] - 1
    for lower_pad in (False, True):
        if rows == math.prod(_row_space(dims, lower_pad)[1]):
            return lower_pad
    raise ValueError(f"a table of {rows} block rows fits neither row space "
                     f"of dims {tuple(dims)}")


def make_pallas_block_knn(table_planar, origin, cell_size, *, dims, cell_cap,
                          k: int = 8):
    """Fetch closure (query [Q,3] -> (d2 [Q,k], nn [Q,k,3])) on the fetch
    kernels (`fetch_rows`), on the table's row space (`lower_pad_of`):
    the contract of ops.hashgrid.make_block_grid_knn, or on a lower_pad
    table that of ops.hashgrid.make_oct_sentinel_knn (the same d2 and real
    candidates; a pick with no candidate, d2 3e38, carries FAR there and
    FAR or, on the sentinel row, zero here).  cell_cap is the JAX
    signature's; the width comes with the table.  `f.planes(q)` is the
    same fetch with the candidates plane-major ([3k, Q], the layout
    `ops.rounds_gn.rounds_gn` reads)."""
    del cell_cap
    lower_pad = lower_pad_of(table_planar, dims)

    def fetch(q, planes_out):
        bcell = block_cell_of(q, origin, cell_size, dims=dims,
                              lower_pad=lower_pad)
        return fetch_rows(table_planar, bcell,
                          *[q[:, i].contiguous() for i in range(3)], K=k,
                          planes_out=planes_out)

    def f(q):
        return fetch(q, False)

    f.planes = lambda q: fetch(q, True)
    return f
