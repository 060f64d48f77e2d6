"""2-D (data x map) sharded registration: maps too big for one card.

Port of the JAX package's `parallel/map_sharded.py` to `torch.distributed`.
The map is split over the ranks of the `map` mesh axis: each rank searches
only its shard, keeps each query's k best candidates, and the candidates
(coordinates, not indices) of the `map` group are all-gathered and merged
into the global k best (`merge_topk`), a [S, Q, k] exchange instead of
moving the map.  The scan batch is split over the `data` axis as in
`parallel/batch.py`.  Every rank calls these functions with the same
global inputs (SPMD) and returns the whole result.

Distributed top-k is exact: each shard returns its k best, and the global k
best are a subset of their union.  The merge ranks the union in the JAX
package's order (shard-major within each query) with ties to the lower
position, so the ranks of one `map` group compute the same candidates and
return bitwise-equal results (the JAX package folds those copies with a
`pmax` for its replication checker; the port has no such checker and no
fold).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from ..ops.fetch import build_block_table_planar, make_pallas_block_knn
from ..ops.hashgrid import build_grid_sentinel, default_grid_spec, grid_origin
from ..ops.knn import _extract_topk, knn5_points
from ..ops.register import register_core, register_rounds_core
from ..pipeline.cloud_info import FeatureMap, ScanFeatures
from .batch import (all_gather_stack, data_slice, gather_result, init_mesh,
                    take_lanes)


def merge_topk(d_all, nn_all, k: int):
    """The k best of S shards' candidates: d_all [S, ..., K] (each shard's
    ascending d2), nn_all [S, ..., K, 3] -> (d2 [..., k], nn [..., k, 3]).

    Per query the pool is flattened shard-major (JAX's moveaxis(0, 1) then
    reshape(Q, S*K)) and its k smallest taken with ties to the lower flat
    position, the order of `lax.top_k`; `torch.topk` does not promise that
    tie order, `_extract_topk` does."""
    S, K = d_all.shape[0], d_all.shape[-1]
    lead = d_all.shape[1:-1]
    d_flat = d_all.movedim(0, -2).reshape(*lead, S * K)
    nn_flat = nn_all.movedim(0, -3).reshape(*lead, S * K, 3)
    vals, pos = _extract_topk(d_flat, k)
    return vals, torch.gather(nn_flat, -2,
                              pos.long()[..., None].expand(*pos.shape, 3))


def _merged(local, k: int, group):
    """A knn closure whose per-shard result is merged over `group`."""

    def f(q):
        d2, nn = local(q)
        return merge_topk(all_gather_stack(d2, group),
                          all_gather_stack(nn, group), k)

    return f


def make_sharded_knn(ref_shard, mask_shard, group, chunk: int):
    """Exact 5-NN closure over a map sharded across `group` (the process
    group of the `map` axis, `mesh.get_group("map")`): this rank's streamed
    5-NN on its shard, merged over the group."""
    return _merged(lambda q: knn5_points(q, ref_shard, mask_shard,
                                         chunk=chunk), 5, group)


def make_2d_mesh(device_type: str, n_devices: int | None = None,
                 data: int | None = None) -> DeviceMesh:
    """Mesh ("data", "map") over n_devices ranks (by default the world):
    data-parallel scan batch x map-sharded search; data defaults to 2
    when n is even and >= 4, else 1."""
    n = n_devices or dist.get_world_size()
    if data is None:
        data = 2 if n % 2 == 0 and n >= 4 else 1
    if n % data:
        raise ValueError(f"{n} ranks do not divide into data={data}")
    return init_mesh(device_type, (data, n // data), ("data", "map"))


def map_sharded_register(mesh: DeviceMesh, features: ScanFeatures,
                         local_map: FeatureMap, init_poses, *,
                         chunk: int = 1024, max_iterations: int = 30,
                         min_correspondences: int = 50,
                         edge_min_valid: int = 10,
                         surf_min_valid: int = 100):
    """The exact solve (`register_core` on the streamed 5-NN) over a
    ("data", "map") mesh.

    features / init_poses: [B, ...] with B divisible by the `data` axis;
    local_map: one shared map whose point counts divide by the `map` axis
    into parts that are multiples of `chunk`.  Returns (RegisterResult
    [B, ...], {"n_converged"}), the same on every rank."""
    group = mesh.get_group("map")
    # this rank's contiguous part of the map's points (the JAX P("map"))
    cpart = data_slice(mesh, "map", local_map.corner_xyz.shape[0])
    spart = data_slice(mesh, "map", local_map.surf_xyz.shape[0])
    lanes = data_slice(mesh, "data", init_poses.shape[0])
    res = register_core(
        take_lanes(features, lanes),
        make_sharded_knn(local_map.corner_xyz[cpart],
                         local_map.corner_mask[cpart], group, chunk),
        make_sharded_knn(local_map.surf_xyz[spart],
                         local_map.surf_mask[spart], group, chunk),
        init_poses[lanes], max_iterations=max_iterations,
        min_correspondences=min_correspondences,
        edge_min_valid=edge_min_valid, surf_min_valid=surf_min_valid)
    res, stats = gather_result(mesh, "data", res)
    return res, {"n_converged": stats["n_converged"]}


# ---------------------------------------------------------------------------
# Grid-table fast path over the 2-D mesh: each map shard holds a
# full-coverage block table built from 1/S of the map points (a striped
# split), its fetch is the one-row fetch of the single-card path, and the
# K-candidate pools merge over the `map` axis.  Replaces the KD-searches of
# ref src/mapOptmization.h:1020,1143 at beyond-one-card map scale.
# ---------------------------------------------------------------------------


def build_sharded_block_tables(local_map: FeatureMap, center, half_extent,
                               n_shards: int, *, cell_size: float = 2.0,
                               corner_cell_cap: int = 16,
                               surf_cell_cap: int = 64, margin: float = 2.0):
    """Stripe the map's points over n_shards (shard s takes pts[s::S]) and
    build one plane-major block table per shard, the fetch kernels' layout
    (`ops.fetch.build_block_table_planar`; the JAX package's cell-major
    rows, planes first, each row's valid points first).

    Returns (corner_tables [S, n_cells+1, 3W], surf_tables [S, ...], origin,
    dims) on the map's device; each kind's W is its widest shard's, the
    narrower shards padded with FAR slots.  Striping splits every
    neighborhood evenly, so each shard holds ~1/S of a cell's points (the
    caps are per shard).  With S = 1 the table is
    `build_map_planar_tables(resident=False)`'s."""
    dims = default_grid_spec(half_extent, cell_size, margin)
    origin = grid_origin(center, half_extent, margin,
                         device=local_map.corner_xyz.device)

    def tables(xyz, mask, cap):
        out = [build_block_table_planar(
            build_grid_sentinel(xyz[s::n_shards], mask[s::n_shards], origin,
                                cell_size, dims=dims, cell_cap=cap),
            dims=dims) for s in range(n_shards)]
        W = max(t.shape[1] // 3 for t in out)
        return torch.stack([torch.nn.functional.pad(
            t.view(t.shape[0], 3, -1), (0, W - t.shape[1] // 3),
            value=1.0e9).reshape(t.shape[0], 3 * W) for t in out])

    return (tables(local_map.corner_xyz, local_map.corner_mask,
                   corner_cell_cap),
            tables(local_map.surf_xyz, local_map.surf_mask, surf_cell_cap),
            origin, dims)


def make_sharded_block_knn(block_table_shard, origin, cell_size, *, dims,
                           cell_cap, k, group):
    """Fetch closure over block tables sharded across `group`: this rank's
    fetch (`ops.fetch.make_pallas_block_knn`: the `block_fetch` kernel on a
    raw table, `resident_fetch` on a `PlanarTable`, their plain versions on
    CPU tensors), its k best merged over the group."""
    return _merged(make_pallas_block_knn(block_table_shard, origin, cell_size,
                                         dims=dims, cell_cap=cell_cap, k=k),
                   k, group)


def map_sharded_register_tables(mesh: DeviceMesh, features: ScanFeatures,
                                corner_tables, surf_tables, origin,
                                init_poses, *, grid_dims,
                                cell_size: float = 2.0,
                                corner_cell_cap: int = 16,
                                surf_cell_cap: int = 64,
                                num_rounds: int = 2,
                                iters_per_round: int = 15,
                                num_candidates: int = 8,
                                min_correspondences: int = 50,
                                edge_min_valid: int = 10,
                                surf_min_valid: int = 100,
                                min_plane_spread: float = 0.0):
    """`register_rounds_core` over a ("data", "map") mesh on sharded tables.

    features / init_poses: [B, ...] with B divisible by the `data` axis;
    corner_tables / surf_tables: one table per shard (the stacked [S, ...]
    of `build_sharded_block_tables`, or a sequence of tables of either
    kind), S the `map` axis size; the rank at coordinate m on `map` fetches
    from table m.  The merged pools are the replicated table's (exact
    distributed top-K), so the result is the replicated solve's.  Returns
    (RegisterResult [B, ...], {"n_converged"}), the same on every rank."""
    group = mesh.get_group("map")
    m = mesh.get_local_rank("map")
    n_shards = mesh.size(mesh.mesh_dim_names.index("map"))
    if len(corner_tables) != n_shards or len(surf_tables) != n_shards:
        raise ValueError(f"{len(corner_tables)} / {len(surf_tables)} tables "
                         f"for {n_shards} map shards")
    fetch = [make_sharded_block_knn(tabs[m], origin, cell_size,
                                    dims=grid_dims, cell_cap=cap,
                                    k=num_candidates, group=group)
             for tabs, cap in ((corner_tables, corner_cell_cap),
                               (surf_tables, surf_cell_cap))]
    lanes = data_slice(mesh, "data", init_poses.shape[0])
    res = register_rounds_core(
        take_lanes(features, lanes), fetch[0], fetch[1], init_poses[lanes],
        num_rounds=num_rounds, iters_per_round=iters_per_round,
        min_correspondences=min_correspondences,
        edge_min_valid=edge_min_valid, surf_min_valid=surf_min_valid,
        min_plane_spread=min_plane_spread)
    res, stats = gather_result(mesh, "data", res)
    return res, {"n_converged": stats["n_converged"]}
