"""Batched scan-to-map registration: map tables + the batched solvers.

Port of the JAX package's `parallel/batch.py` batched solvers.  The
reference scales with OpenMP threads inside one scan (ref:
src/mapOptmization.h:1007,1130); here the batch of scans is the parallel
axis.

  * `batch_register_fused` — the main path: each solve round is one
    candidate fetch per feature kind at the lanes' current poses
    (`ops.fetch.block_fetch`, or `resident_fetch` on a `PlanarTable`), then
    a whole GN round per lane (`ops.gn_round.gn_round`) with per-lane early
    exit.
  * `batch_register_pallas` — the same fetch kernels feeding the
    rounds-structured solver `ops.register.register_rounds_core`.
  * `batch_register_blocks` — that solver on the plain block-table fetch
    (`ops.hashgrid.grid_knn_block`), kernel-free.
  * `batch_register` — the exact solve `ops.register.register_scan`
    (streamed 5-NN, no table) over a batch, against one shared map or one
    map per scan.
  * the XLA solver variants of the JAX package, plain PyTorch on the
    device of their tensors: `batch_register_fast` (streamed candidate
    prefetch), `batch_register_fast_grid` (packed-grid candidate
    prefetch) and `batch_register_rounds` (the rounds solver on the
    octant-sentinel lookup, tables from `build_map_grids`).
  * `shard_register` and `shard_register_tables` — the data-parallel
    forms on `torch.distributed` (the JAX package's `shard_map`): every
    rank passes the same global batch, solves its slice of the `data`
    mesh axis and all-gathers the results.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..ops.fetch import (RESIDENT_TABLE_CAP, PlanarTable, block_cell_of_xyz,
                         build_block_table_planar, compact_row_space,
                         fetch_rows, make_pallas_block_knn)
from ..ops.gn_round import feature_planes, gn_round, initial_state
from ..ops.hashgrid import (build_block_table, build_grid_sentinel,
                            default_grid_spec, grid_origin,
                            make_block_grid_knn, make_oct_sentinel_knn)
from ..ops.register import (RegisterResult, register_rounds_core,
                            register_scan, register_scan_fast,
                            register_scan_fast_grid, world_components)
from ..pipeline.cloud_info import FeatureMap, ScanFeatures


def _sentinel_tables(local_map: FeatureMap, center, half_extent, cell_size,
                     corner_cell_cap, surf_cell_cap, margin):
    dims = default_grid_spec(half_extent, cell_size, margin)
    origin = grid_origin(center, half_extent, margin,
                         device=local_map.corner_xyz.device)
    tables = [build_grid_sentinel(xyz, mask, origin, cell_size, dims=dims,
                                  cell_cap=cap)
              for xyz, mask, cap in (
                  (local_map.corner_xyz, local_map.corner_mask,
                   corner_cell_cap),
                  (local_map.surf_xyz, local_map.surf_mask, surf_cell_cap))]
    return tables, origin, dims


def build_map_planar_tables(local_map: FeatureMap, center, half_extent,
                            cell_size: float = 2.0, corner_cell_cap: int = 16,
                            surf_cell_cap: int = 64, margin: float = 2.0,
                            resident: bool = False, lower_pad: bool = False):
    """Plane-major block tables for the fetch kernels, on the map's device.
    Returns (corner_table, surf_table, origin, dims).

    resident=True row-compacts each table into a `PlanarTable` for
    `resident_fetch` when the compact table takes at most
    RESIDENT_TABLE_CAP bytes (the JAX package's rule and value); a larger
    one stays a raw table for `block_fetch`.  lower_pad=True gives the
    octant rule's row space (`ops.fetch.build_block_table_planar`; the
    tables of `grid_register_step`); the batched solvers take the JAX
    package's, lower_pad=False."""
    (cst, sst), origin, dims = _sentinel_tables(
        local_map, center, half_extent, cell_size, corner_cell_cap,
        surf_cell_cap, margin)
    tables = [build_block_table_planar(st, dims=dims, lower_pad=lower_pad)
              for st in (cst, sst)]
    if resident:
        compact = [compact_row_space(t) for t in tables]
        tables = [c if c.table.numel() * 4 <= RESIDENT_TABLE_CAP else t
                  for c, t in zip(compact, tables)]
    return tables[0], tables[1], origin, dims


def build_map_block_tables(local_map: FeatureMap, center, half_extent,
                           cell_size: float = 2.0, corner_cell_cap: int = 16,
                           surf_cell_cap: int = 64, margin: float = 2.0):
    """Cell-major block tables for `batch_register_blocks` (one row per
    2x2x2 block, 8x the sentinel table).  Returns (corner_table,
    surf_table, origin, dims)."""
    (cst, sst), origin, dims = _sentinel_tables(
        local_map, center, half_extent, cell_size, corner_cell_cap,
        surf_cell_cap, margin)
    return (build_block_table(cst, dims=dims, cell_cap=corner_cell_cap),
            build_block_table(sst, dims=dims, cell_cap=surf_cell_cap),
            origin, dims)


def sentinel_of(table) -> int:
    """Raw block id that reads no row, the last of the row space, for either
    table kind."""
    if isinstance(table, PlanarTable):
        return table.rows_index.shape[0] - 1
    return table.shape[0] - 1


def fetch_queries(pose, xyz, mask, table, origin, cell_size, dims,
                  skip_lane=None):
    """Fetch queries of features xyz [B,P,3] at poses [B,6]: (bcell, qx, qy,
    qz), each [B*P], in the world frame; bcell holds raw block ids.

    Invalid features, and every feature of a lane in `skip_lane`, go to the
    sentinel row: the fetch reads no row for them."""
    B, P, _ = xyz.shape
    w = world_components(pose, xyz)
    bcell = block_cell_of_xyz(w[0], w[1], w[2], origin, cell_size, dims=dims)
    live = mask
    if skip_lane is not None:
        live = live & ~skip_lane[:, None]
    bcell = torch.where(live, bcell, sentinel_of(table)).to(torch.int32)
    return (bcell.reshape(B * P),
            *[c.reshape(B * P).contiguous() for c in w])


def presort_by_row(pose, xyz, mask, table, origin, cell_size, dims):
    """Per-lane sort of features [B,P,3] by their block row at poses [B,6],
    masked features at the sentinel (last): (xyz, mask, bcell), each in the
    sorted order, the row order that favours the fetch kernels' query
    tiles (JAX `batch_register_fused(presort_rows=True)`; the port's solver
    has no such option, `chip_smoke.py` times the fetch on this order).
    The sort is stable, so features of one row keep their order (JAX
    `lax.sort` does not promise that)."""
    w = world_components(pose, xyz)
    bcell = block_cell_of_xyz(w[0], w[1], w[2], origin, cell_size, dims=dims)
    bcell = torch.where(mask, bcell, sentinel_of(table))
    bcell, order = torch.sort(bcell, dim=1, stable=True)
    return (torch.gather(xyz, 1, order[..., None].expand(-1, -1, 3)),
            torch.gather(mask, 1, order), bcell.to(torch.int32))


def fetch_candidates(pose, xyz, mask, table, origin, cell_size, dims, *,
                     K: int, skip_lane=None):
    """Candidates [3K, B*P] of features xyz [B,P,3] at poses [B,6], from
    `block_fetch` on a raw table or `resident_fetch` on a `PlanarTable`
    (raw block ids routed through its rows_index)."""
    queries = fetch_queries(pose, xyz, mask, table, origin, cell_size, dims,
                            skip_lane=skip_lane)
    return fetch_rows(table, *queries, K=K)[1]


def batch_register_fused(features: ScanFeatures, corner_planar, surf_planar,
                         origin, init_poses, *, grid_dims,
                         cell_size: float = 2.0, corner_cell_cap: int = 16,
                         surf_cell_cap: int = 64, num_rounds: int = 2,
                         iters_per_round=15, num_candidates: int = 8,
                         min_correspondences: int = 50,
                         edge_min_valid: int = 10, surf_min_valid: int = 100,
                         shared_fetch=False,
                         skip_converged_refetch: bool = False,
                         round1_surf_stride: int = 1,
                         round1_corner_stride: int = 1,
                         min_plane_spread: float = 0.0) -> RegisterResult:
    """Fused-kernel batched solve: fetch kernel + GN-round kernel per round.

    features [B, ...] with tables from `build_map_planar_tables` (raw
    tables or `PlanarTable`s; the cell caps are the JAX signature's, the
    width comes with the table).
    iters_per_round: an int (same budget every round) or one budget per
    round.  shared_fetch: False = refetch every round; True = one fetch at
    the initial pose shared by all rounds; "tail" = refetch at round 1, then
    share that pool for rounds >= 2.  round1_*_stride > 1 subsamples round
    0's queries (coarse to fine; needs a full-resolution refetch round).
    skip_converged_refetch: lanes converged in the previous round keep
    converged=1 and get no candidates (their GN round is a no-op).  Every
    other round re-verifies convergence on every lane.
    """
    del corner_cell_cap, surf_cell_cap
    K = num_candidates
    if isinstance(iters_per_round, int):
        iters_seq = [iters_per_round] * num_rounds
    else:
        iters_seq = list(iters_per_round)
    if len(iters_seq) != num_rounds:
        raise ValueError(f"iters_per_round {iters_seq} for {num_rounds} "
                         "rounds")
    cs, ss = round1_corner_stride, round1_surf_stride
    if (cs > 1 or ss > 1) and not (shared_fetch in (False, "tail")
                                   and num_rounds >= 2):
        raise ValueError("round-0 subsampling needs a full-resolution "
                         "refetch round")

    stat, matP = initial_state(features, init_poses,
                               edge_min_valid=edge_min_valid,
                               surf_min_valid=surf_min_valid)
    full = (features.corner_xyz, features.corner_mask,
            features.surf_xyz, features.surf_mask)
    r0 = (full[0][:, ::cs], full[1][:, ::cs], full[2][:, ::ss],
          full[3][:, ::ss])
    fc = feature_planes(full[0], full[1])
    fs = feature_planes(full[2], full[3])
    fc0 = fc[:, :, ::cs].contiguous()
    fs0 = fs[:, :, ::ss].contiguous()

    def fetch(pose, cxyz, cmask, sxyz, smask, skip_lane=None):
        return (fetch_candidates(pose, cxyz, cmask, corner_planar, origin,
                                 cell_size, grid_dims, K=K,
                                 skip_lane=skip_lane),
                fetch_candidates(pose, sxyz, smask, surf_planar, origin,
                                 cell_size, grid_dims, K=K,
                                 skip_lane=skip_lane))

    for r in range(num_rounds):
        refetch = (r == 1) if shared_fetch == "tail" else not shared_fetch
        if r == 0:
            candc, cands = fetch(stat[:, 0:6], *r0)
            stat[:, 7] = 0.0
        elif refetch and skip_converged_refetch:
            candc, cands = fetch(stat[:, 0:6], *full,
                                 skip_lane=stat[:, 7] > 0)
        elif refetch:
            candc, cands = fetch(stat[:, 0:6], *full)
            stat[:, 7] = 0.0            # re-verify every lane
        else:
            stat[:, 7] = 0.0            # shared pool: still re-verify
        stat, matP = gn_round(stat, matP, *((fc0, fs0) if r == 0
                                            else (fc, fs)),
                              candc, cands, K=K, iters=iters_seq[r],
                              min_corr=min_correspondences,
                              min_plane_spread=min_plane_spread)

    return RegisterResult(
        pose6=stat[:, 0:6],
        converged=stat[:, 7] > 0,
        iterations=stat[:, 6].to(torch.int32),
        n_corr=stat[:, 10].to(torch.int32),
        is_degenerate=stat[:, 8] > 0,
        valid=stat[:, 9] > 0,
    )


def batch_register_pallas(features: ScanFeatures, corner_planar, surf_planar,
                          origin, init_poses, *, grid_dims,
                          cell_size: float = 2.0, corner_cell_cap: int = 16,
                          surf_cell_cap: int = 64, num_rounds: int = 2,
                          iters_per_round: int = 15,
                          num_candidates: int = 8, edge_min_valid: int = 10,
                          surf_min_valid: int = 100) -> RegisterResult:
    """The CUDA fetch kernels + the rounds-structured solve.

    Tables from `build_map_planar_tables`: a raw table runs
    `csrc/block_fetch.cu`, a `PlanarTable` `csrc/resident_fetch.cu`, both
    through `ops.fetch.make_pallas_block_knn` (the name is the JAX
    package's; its Pallas kernels' query-tile multiple does not carry over:
    any feature caps work).  The solve is `register_rounds_core`."""
    knn = {kind: make_pallas_block_knn(tab, origin, cell_size,
                                       dims=grid_dims, cell_cap=cap,
                                       k=num_candidates)
           for kind, tab, cap in (("corner", corner_planar, corner_cell_cap),
                                  ("surf", surf_planar, surf_cell_cap))}
    return register_rounds_core(
        features, knn["corner"], knn["surf"], init_poses,
        num_rounds=num_rounds, iters_per_round=iters_per_round,
        edge_min_valid=edge_min_valid, surf_min_valid=surf_min_valid)


def batch_register_blocks(features: ScanFeatures, corner_block, surf_block,
                          origin, init_poses, *, grid_dims,
                          cell_size: float = 2.0, corner_cell_cap: int = 16,
                          surf_cell_cap: int = 64, num_rounds: int = 2,
                          iters_per_round: int = 15,
                          num_candidates: int = 8, edge_min_valid: int = 10,
                          surf_min_valid: int = 100,
                          min_plane_spread: float = 0.0) -> RegisterResult:
    """Plain block-table fetch + the rounds-structured solve (no kernel).
    Tables from `build_map_block_tables`."""
    knn = {kind: make_block_grid_knn(tab, origin, cell_size, dims=grid_dims,
                                      cell_cap=cap, k=num_candidates)
           for kind, tab, cap in (("corner", corner_block, corner_cell_cap),
                                  ("surf", surf_block, surf_cell_cap))}
    return register_rounds_core(
        features, knn["corner"], knn["surf"], init_poses,
        num_rounds=num_rounds, iters_per_round=iters_per_round,
        edge_min_valid=edge_min_valid, surf_min_valid=surf_min_valid,
        min_plane_spread=min_plane_spread)


def batch_register(features: ScanFeatures, local_map: FeatureMap,
                   init_poses, *, chunk: int = 4096,
                   max_iterations: int = 30) -> RegisterResult:
    """The exact solve over a batch (the JAX package vmaps `register_scan`;
    here its lane axis is the batch axis of `register_scan` itself).

    features [B, ...]; local_map shared ([M, 3] / [M]) or per scan
    ([B, M, 3] / [B, M]); init_poses [B, 6]."""
    return register_scan(features, local_map, init_poses, chunk=chunk,
                         max_iterations=max_iterations)


def batch_register_fast(features: ScanFeatures, local_map: FeatureMap,
                        init_poses, *, chunk: int = 4096,
                        max_iterations: int = 30,
                        num_candidates: int = 16) -> RegisterResult:
    """The streamed candidate-prefetch solve over a batch (the JAX package
    vmaps `register_scan_fast`; here its lane axis is the batch axis):
    features [B, ...], local_map shared or one per scan, init_poses
    [B, 6]."""
    return register_scan_fast(features, local_map, init_poses, chunk=chunk,
                              max_iterations=max_iterations,
                              num_candidates=num_candidates)


def build_map_grids(local_map: FeatureMap, center, half_extent,
                    cell_size: float = 2.0, corner_cell_cap: int = 16,
                    surf_cell_cap: int = 64, margin: float = 2.0):
    """The corner and surf sentinel tables of one local map (amortized over
    every scan registered against it), for `batch_register_rounds`.
    Returns (corner_table, surf_table, origin, dims)."""
    (cst, sst), origin, dims = _sentinel_tables(
        local_map, center, half_extent, cell_size, corner_cell_cap,
        surf_cell_cap, margin)
    return cst, sst, origin, dims


def batch_register_fast_grid(features: ScanFeatures, local_map: FeatureMap,
                             corner_table, surf_table, origin, init_poses, *,
                             grid_dims, cell_size: float = 1.0,
                             cell_cap: int = 16, max_iterations: int = 30,
                             num_candidates: int = 16) -> RegisterResult:
    """The packed-grid candidate-prefetch solve over a batch against one
    shared map: tables from `ops.hashgrid.build_grid_packed` (one cap for
    both), features [B, ...], init_poses [B, 6]."""
    return register_scan_fast_grid(
        features, local_map, corner_table, surf_table, origin, init_poses,
        grid_dims=grid_dims, cell_size=cell_size, cell_cap=cell_cap,
        max_iterations=max_iterations, num_candidates=num_candidates)


def batch_register_rounds(features: ScanFeatures, corner_packed, surf_packed,
                          origin, init_poses, *, grid_dims,
                          cell_size: float = 2.0, corner_cell_cap: int = 16,
                          surf_cell_cap: int = 64, num_rounds: int = 2,
                          iters_per_round: int = 15,
                          num_candidates: int = 16) -> RegisterResult:
    """The rounds-structured solve on the octant-sentinel lookup
    (`ops.hashgrid.grid_knn_oct_sentinel`) against one shared map: R
    unconditional fetches of K candidates, candidate-GN iterations between
    them.  Tables from `build_map_grids`."""
    knn = [make_oct_sentinel_knn(tab, origin, cell_size, dims=grid_dims,
                                 cell_cap=cap, k=num_candidates)
           for tab, cap in ((corner_packed, corner_cell_cap),
                            (surf_packed, surf_cell_cap))]
    return register_rounds_core(
        features, knn[0], knn[1], init_poses, num_rounds=num_rounds,
        iters_per_round=iters_per_round)


# ---------------------------------------------------------------------------
# Data-parallel solves on torch.distributed: the JAX package's shard_map.
# Every rank calls these with the same global inputs (SPMD), solves the
# slice of the batch that its coordinate on the `data` axis names, and
# all-gathers the slices back into the global result, so that every rank
# returns the whole RegisterResult [B, ...].
# ---------------------------------------------------------------------------


def init_mesh(device_type: str, shape, names) -> DeviceMesh:
    """A DeviceMesh of `shape` over every rank of the default process group
    (which the caller initializes: `torch.distributed.init_process_group`
    with its backend, rank, world size and store), axes named `names`.
    device_type: "cuda" (NCCL, one card a rank) or "cpu" (gloo)."""
    if not dist.is_initialized():
        raise RuntimeError("init_mesh needs an initialized default process "
                           "group (torch.distributed.init_process_group)")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh {tuple(shape)} over "
                         f"{dist.get_world_size()} ranks")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_mesh(device_type: str, n_devices: int | None = None,
              axis_name: str = "data") -> DeviceMesh:
    """1-D data mesh over all n_devices ranks (by default the world)."""
    return init_mesh(device_type, (n_devices or dist.get_world_size(),),
                     (axis_name,))


def all_gather_stack(t, group):
    """Every rank's `t` (the same shape on each), stacked: [n, *t.shape].
    Booleans travel as uint8 (gloo has no bool)."""
    wire = t.contiguous()
    if t.dtype == torch.bool:
        wire = wire.to(torch.uint8)
    out = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, wire, group=group)
    out = torch.stack(out)
    return out.bool() if t.dtype == torch.bool else out


def data_slice(mesh: DeviceMesh, axis_name: str, count: int) -> slice:
    """This rank's part of `count` items split over a mesh axis (a batch's
    lanes, a map's points): its coordinate on the axis names one of equal
    parts (count must divide by the axis)."""
    n = mesh.size(mesh.mesh_dim_names.index(axis_name))
    if count % n:
        raise ValueError(f"{count} items do not divide by the {n} ranks of "
                         f"mesh axis {axis_name!r}")
    i = mesh.get_local_rank(axis_name)
    return slice(i * count // n, (i + 1) * count // n)


def take_lanes(features: ScanFeatures, lanes: slice) -> ScanFeatures:
    return ScanFeatures(*(a[lanes] for a in features))


def gather_result(mesh: DeviceMesh, axis_name: str, res: RegisterResult):
    """Each rank's slice of the solve -> (the global RegisterResult, stats):
    the slices all-gathered over the axis in rank order; n_converged and
    n_total summed and mean_iterations averaged over the axis (psum and
    pmean in the JAX package)."""
    group = mesh.get_group(axis_name)
    full = RegisterResult(*(all_gather_stack(t, group).flatten(0, 1)
                            for t in res))
    dev = res.pose6.device
    counts = torch.stack([res.converged.sum(),
                          torch.tensor(res.converged.shape[0], device=dev)]
                         ).to(torch.int64)
    mean = res.iterations.to(torch.float32).mean()
    dist.all_reduce(counts, group=group)
    dist.all_reduce(mean, group=group)
    return full, {"n_converged": counts[0], "n_total": counts[1],
                  "mean_iterations": mean / dist.get_world_size(group)}


def shard_register(mesh: DeviceMesh, features: ScanFeatures,
                   local_map: FeatureMap, init_poses, *, chunk: int = 4096,
                   max_iterations: int = 30, axis_name: str = "data"):
    """The exact solve (`batch_register`) data-parallel over a mesh axis:
    each rank solves its slice of the batch against the shared local map
    that every rank holds.  Returns (RegisterResult [B, ...], stats), the
    same on every rank."""
    lanes = data_slice(mesh, axis_name, init_poses.shape[0])
    res = batch_register(take_lanes(features, lanes), local_map,
                         init_poses[lanes], chunk=chunk,
                         max_iterations=max_iterations)
    return gather_result(mesh, axis_name, res)


_TABLE_SOLVERS = {"fused": batch_register_fused,
                  "blocks": batch_register_blocks}


def make_shard_register_tables(mesh: DeviceMesh, *, grid_dims,
                               axis_name: str = "data",
                               solver: str = "fused", **solve_kw):
    """The grid-table solver data-parallel over a mesh axis: returns
    `(features, corner_tab, surf_tab, origin, init_poses) -> (res, stats)`.

    solver="fused": `batch_register_fused` (the fetch and GN-round kernels
    on CUDA tensors; tables from `build_map_planar_tables`);
    solver="blocks": `batch_register_blocks` (plain fetch; tables from
    `build_map_block_tables`).  The tables are replicated: every rank holds
    them."""
    solve = _TABLE_SOLVERS[solver]

    def fn(features, corner_tab, surf_tab, origin, init_poses):
        lanes = data_slice(mesh, axis_name, init_poses.shape[0])
        res = solve(take_lanes(features, lanes), corner_tab, surf_tab,
                    origin, init_poses[lanes], grid_dims=grid_dims,
                    **solve_kw)
        return gather_result(mesh, axis_name, res)

    return fn


_SHARD_TABLES_CACHE = {}


def shard_register_tables(mesh: DeviceMesh, features: ScanFeatures,
                          corner_tab, surf_tab, origin, init_poses, *,
                          grid_dims, axis_name: str = "data",
                          solver: str = "fused", **solve_kw):
    """`make_shard_register_tables` applied once: the batch split over the
    axis, the tables replicated; B must divide by the axis size.  The
    callable is memoized on (mesh, config), as in the JAX package (there to
    keep one compiled executable; here it only saves the closure).
    Returns (RegisterResult [B, ...], stats) like `shard_register`."""
    try:
        key = (mesh, tuple(grid_dims), axis_name, solver,
               tuple(sorted(solve_kw.items())))
        fn = _SHARD_TABLES_CACHE.get(key)
    except TypeError:  # an unhashable option (a list of budgets)
        key, fn = None, None
    if fn is None:
        fn = make_shard_register_tables(mesh, grid_dims=grid_dims,
                                        axis_name=axis_name, solver=solver,
                                        **solve_kw)
        if key is not None:
            _SHARD_TABLES_CACHE[key] = fn
    return fn(features, corner_tab, surf_tab, origin, init_poses)
