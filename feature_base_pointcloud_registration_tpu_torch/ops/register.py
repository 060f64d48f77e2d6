"""Scan-to-map registration: the result type, the exact streamed-k-NN
solve, the rounds-structured solve, the pipelines' grid registration step
and the IMU fusion epilogue.

Port of the JAX package's `ops/register.py` (`RegisterResult`,
`register_core`, `register_scan`, `register_scan_with_params`,
`prefetch_candidates`, `make_candidate_knn`, `register_scan_fast`,
`register_grid_core`, `register_scan_fast_grid`, `register_rounds_core`,
`grid_register_step`, `transform_update`).  The fused solve of the batched
main path lives in `parallel/batch.py`; the rounds solver is the body of
`batch_register_blocks`, `batch_register_pallas` and
`batch_register_rounds` there, and of `grid_register_step` here.
`register_scan` is the exactness check: every GN iteration streams the
whole map through the exact 5-NN (scan2MapOptimization with the
reference's KD-tree search, ref: src/mapOptmization.h:1403-1442), the
whole solve one `ops/exact_gn.py::exact_gn` call (the kernel
`csrc/exact_gn.cu` on CUDA tensors; `register_core` on `ops/knn.py` on
CPU tensors).  The candidate
prefetch solvers (`register_scan_fast` on the streamed k-NN,
`register_scan_fast_grid` on the packed grid) fetch K candidates once and
again whenever a lane's pose has moved more than `refetch_dist` from where
it fetched; each GN iteration takes its 5-NN from those candidates.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geom.se3 import (euler_from_quat, euler_to_rot, quat_from_euler,
                        quat_slerp)
from .correspondence import (corner_correspondence,
                             corner_correspondence_cand, surf_correspondence,
                             surf_correspondence_cand)
from .hashgrid import (default_grid_spec, grid_origin,
                       grid_overflow_fraction, make_packed_grid_knn)
from .exact_gn import exact_gn
from .gn_round import feature_planes, initial_state
from .knn import _extract_topk, _rows, knn
from .rounds_gn import rounds_gn
from .solver import GNState, gn_step


class RegisterResult(NamedTuple):
    pose6: torch.Tensor          # f32 [B, 6] optimized pose
    converged: torch.Tensor      # bool [B]
    iterations: torch.Tensor     # i32 [B]
    n_corr: torch.Tensor         # i32 [B] correspondences, final iteration
    is_degenerate: torch.Tensor  # bool [B]
    valid: torch.Tensor          # bool [B] feature-count gate passed


def world_components(pose, xyz):
    """Features [B,P,3] at poses [B,6] -> world (x, y, z), each [B,P]:
    R = Rz Ry Rx as nine multiply-adds per point."""
    R = euler_to_rot(pose[:, 0], pose[:, 1], pose[:, 2])
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    return [R[:, i, 0, None] * x + R[:, i, 1, None] * y
            + R[:, i, 2, None] * z + pose[:, 3 + i, None] for i in range(3)]


def _to_world(pose, xyz):
    """World points [B*P, 3] of features [B,P,3] at poses [B,6]."""
    return torch.stack(world_components(pose, xyz), dim=-1).reshape(-1, 3)


def _initial(features, init_pose6, edge_min_valid, surf_min_valid):
    """(gate [B], GNState) before a lane's first iteration: the feature-count
    gate (ref :1410), the pose, an identity projector."""
    B = features.corner_xyz.shape[0]
    dev = features.corner_xyz.device
    gate = ((features.corner_mask.sum(1) > edge_min_valid)
            & (features.surf_mask.sum(1) > surf_min_valid))
    false = torch.zeros(B, dtype=torch.bool, device=dev)
    return gate, GNState(
        pose6=torch.as_tensor(init_pose6, dtype=torch.float32,
                              device=dev).clone(),
        matP=torch.eye(6, dtype=torch.float32, device=dev).repeat(B, 1, 1),
        is_degenerate=false,
        converged=false,
        n_corr=torch.zeros(B, dtype=torch.int32, device=dev),
    )


def _freeze(active, new, old):
    """`new` where the lane is active, else `old` (a GNState per lane)."""
    B = active.shape[0]
    return GNState(*(torch.where(active.view(B, *[1] * (n.dim() - 1)), n, o)
                     for n, o in zip(new, old)))


def register_core(features, corner_knn, surf_knn, init_pose6, *,
                  max_iterations: int = 30, min_correspondences: int = 50,
                  eigen_threshold: float = 100.0, edge_min_valid: int = 10,
                  surf_min_valid: int = 100, converge_rot_deg: float = 0.05,
                  converge_trans_cm: float = 0.05) -> RegisterResult:
    """LOAM scan-to-map Gauss-Newton solve with pluggable neighbor search,
    over a batch of lanes.

    features: ScanFeatures [B, ...]; init_pose6 [B, 6].  corner_knn /
    surf_knn: world points [B, P, 3] -> (d2 [B, P, 5], nn [B, P, 5, 3]),
    the exact 5-NN (`make_local_knn`).  Per lane, as the JAX package's
    vmapped while-loop: iterate while the lane is under max_iterations,
    not converged and through the feature-count gate; the projector is
    taken at the lane's iteration 0.  A stopped lane is frozen with
    `torch.where`; the loop asks the host once an iteration whether any
    lane is still active."""
    B = features.corner_xyz.shape[0]
    gate, state = _initial(features, init_pose6, edge_min_valid,
                           surf_min_valid)
    it = torch.zeros(B, dtype=torch.int32, device=gate.device)
    pts_all = torch.cat([features.corner_xyz, features.surf_xyz], dim=1)
    for _ in range(max_iterations):
        active = gate & ~state.converged
        if not bool(active.any()):
            break
        c_coeff, c_resid, c_mask = corner_correspondence(
            torch.stack(world_components(state.pose6, features.corner_xyz),
                        -1), features.corner_mask, corner_knn)
        s_coeff, s_resid, s_mask = surf_correspondence(
            torch.stack(world_components(state.pose6, features.surf_xyz),
                        -1), features.surf_mask, surf_knn)
        new = gn_step(
            state, pts_all, torch.cat([c_coeff, s_coeff], 1),
            torch.cat([c_resid, s_resid], 1), torch.cat([c_mask, s_mask], 1),
            it, min_correspondences=min_correspondences,
            eigen_threshold=eigen_threshold,
            converge_rot_deg=converge_rot_deg,
            converge_trans_cm=converge_trans_cm)
        state = _freeze(active, new, state)
        it = it + active.to(torch.int32)
    return RegisterResult(
        pose6=state.pose6,
        converged=state.converged,
        iterations=it,
        n_corr=state.n_corr,
        is_degenerate=state.is_degenerate,
        valid=gate,
    )


def register_scan(features, local_map, init_pose6, *,
                  max_iterations: int = 30, min_correspondences: int = 50,
                  eigen_threshold: float = 100.0, edge_min_valid: int = 10,
                  surf_min_valid: int = 100, chunk: int = 4096,
                  converge_rot_deg: float = 0.05,
                  converge_trans_cm: float = 0.05) -> RegisterResult:
    """Scan-to-map solve on the exact streamed 5-NN (scan2MapOptimization
    equivalent), on the device of its inputs: one `exact_gn` call (one
    kernel launch on CUDA tensors, `register_core` on CPU tensors).

    features: downsampled corner/surf sets in the lidar frame [B, ...];
    local_map: padded FeatureMap in the world frame, one for all lanes
    ([M, 3]) or one per lane ([B, M, 3]); M a multiple of `chunk`;
    init_pose6 [B, 6] (roll, pitch, yaw, x, y, z)."""
    stat = exact_gn(
        torch.as_tensor(init_pose6, dtype=torch.float32,
                        device=features.corner_xyz.device),
        features, local_map, iters=max_iterations,
        min_corr=min_correspondences, eig_thresh=eigen_threshold,
        edge_min_valid=edge_min_valid, surf_min_valid=surf_min_valid,
        chunk=chunk, conv_rot_deg=converge_rot_deg,
        conv_trans_cm=converge_trans_cm)
    return unpack(stat)


def unpack(stat) -> RegisterResult:
    """stat [B, 16] (`ops/exact_gn.py`'s layout) as a RegisterResult."""
    return RegisterResult(
        pose6=stat[:, 0:6].contiguous(),
        converged=stat[:, 7] > 0.0,
        iterations=stat[:, 6].to(torch.int32),
        n_corr=stat[:, 10].to(torch.int32),
        is_degenerate=stat[:, 8] > 0.0,
        valid=stat[:, 9] > 0.0,
    )


def register_scan_with_params(params, features, local_map, init_pose6,
                              imu_rpy_init=None, imu_available=None
                              ) -> RegisterResult:
    """`register_scan` with the Params thresholds, then the IMU fusion
    epilogue `transform_update` (imu_rpy_init [B, 3], imu_available [B],
    True when not given) on the lanes through the feature gate only
    (ref :1438)."""
    res = register_scan(
        features, local_map, init_pose6,
        max_iterations=params.max_gn_iterations,
        min_correspondences=params.min_correspondences,
        eigen_threshold=params.degeneracy_eigen_threshold,
        edge_min_valid=params.edge_feature_min_valid_num,
        surf_min_valid=params.surf_feature_min_valid_num,
        chunk=params.knn_chunk,
        converge_rot_deg=params.converge_delta_rot_deg,
        converge_trans_cm=params.converge_delta_trans_cm,
    )
    if imu_rpy_init is None:
        return res
    if imu_available is None:
        imu_available = torch.ones_like(res.valid)
    pose = transform_update(
        res.pose6, imu_rpy_init, imu_available,
        imu_weight=params.imu_attitude_weight,
        rotation_tolerance=params.rotation_tolerance,
        z_tolerance=params.z_tolerance)
    return res._replace(pose6=torch.where(res.valid[:, None], pose,
                                          res.pose6))


def prefetch_candidates(query_w, ref, ref_mask, K: int, chunk: int):
    """One streamed pass over the map: the K nearest candidates of each
    query.  query_w [..., Q, 3]; ref [M, 3] shared or [..., M, 3] one map
    per set (M a multiple of `chunk`) -> (cand [..., Q, K, 3], valid
    [..., Q, K]).

    The GN loop then takes its 5-NN within these candidates instead of
    streaming the whole map every iteration (the map is fixed; only the
    pose moves, by centimeters an iteration)."""
    d2, idx = knn(query_w, ref, ref_mask, k=K, chunk=chunk)
    return _rows(ref, idx), d2 < 1e37


def make_candidate_knn(cand_xyz, cand_valid):
    """knn closure over per-query candidates cand_xyz [..., Q, K, 3]:
    q [..., Q, 3] -> (d2 [..., Q, 5], nn [..., Q, 5, 3]), the exact 5-NN
    among each query's valid candidates (invalid ones rank at 3e38)."""

    def f(q):
        diff = q[..., None, :] - cand_xyz
        d2 = torch.where(cand_valid, (diff * diff).sum(-1), 3.0e38)
        vals, pos = _extract_topk(d2, 5)
        return vals, torch.gather(
            cand_xyz, -2, pos.long()[..., None].expand(*pos.shape, 3))

    return f


def _lanes_knn(knn_fn):
    """A knn closure on flat queries [Q, 3] as a closure on world points of
    lanes [B, P, 3], the interface of `register_core`."""

    def f(q):
        d2, nn = knn_fn(q.reshape(-1, 3))
        return (d2.view(*q.shape[:-1], -1),
                nn.view(*q.shape[:-1], -1, 3))

    return f


def _prefetch_solve(features, fetch, init_pose6, *, refetch_dist,
                    max_iterations, min_correspondences, eigen_threshold,
                    edge_min_valid, surf_min_valid, converge_rot_deg,
                    converge_trans_cm) -> RegisterResult:
    """The candidate-prefetch solve of `register_scan_fast` and
    `register_scan_fast_grid` over a batch of lanes.

    fetch(pose [b, 6], lanes [b] int64) -> (corner cand [b, Pc, K, 3],
    valid [b, Pc, K], surf cand [b, Ps, K, 3], valid [b, Ps, K]) for the
    given lanes at their poses.  Per lane, as the JAX package's vmapped
    while-loop: fetch at the initial pose; at the start of each iteration,
    refetch when the translation has moved more than refetch_dist from
    where the lane last fetched (JAX's `lax.cond`, which runs both branches
    under vmap and selects per lane: here only the lanes that moved fetch,
    and a mask keeps the others' candidates); then one candidate-GN
    iteration.  The loop stops per lane as `register_core`'s does."""
    B, Pc, _ = features.corner_xyz.shape
    Ps = features.surf_xyz.shape[1]
    gate, state = _initial(features, init_pose6, edge_min_valid,
                           surf_min_valid)
    it = torch.zeros(B, dtype=torch.int32, device=gate.device)
    pts_all = torch.cat([features.corner_xyz, features.surf_xyz], dim=1)
    cmask = features.corner_mask.reshape(B * Pc)
    smask = features.surf_mask.reshape(B * Ps)
    cands = list(fetch(state.pose6, torch.arange(B, device=gate.device)))
    fetched_at = state.pose6[:, 3:6].clone()
    for _ in range(max_iterations):
        active = gate & ~state.converged
        if not bool(active.any()):
            break
        moved = active & (torch.linalg.vector_norm(
            state.pose6[:, 3:6] - fetched_at, dim=1) > refetch_dist)
        lanes = torch.nonzero(moved)[:, 0]
        if lanes.numel():
            for c, new in zip(cands, fetch(state.pose6[lanes], lanes)):
                c[lanes] = new
            fetched_at[lanes] = state.pose6[lanes, 3:6]
        cc, ccv, sc, scv = cands
        K = cc.shape[2]
        c_coeff, c_resid, c_mask = corner_correspondence_cand(
            _to_world(state.pose6, features.corner_xyz), cmask,
            cc.reshape(B * Pc, K, 3), ccv.reshape(B * Pc, K))
        s_coeff, s_resid, s_mask = surf_correspondence_cand(
            _to_world(state.pose6, features.surf_xyz), smask,
            sc.reshape(B * Ps, K, 3), scv.reshape(B * Ps, K))
        new = gn_step(
            state, pts_all,
            torch.cat([c_coeff.view(B, Pc, 3), s_coeff.view(B, Ps, 3)], 1),
            torch.cat([c_resid.view(B, Pc), s_resid.view(B, Ps)], 1),
            torch.cat([c_mask.view(B, Pc), s_mask.view(B, Ps)], 1),
            it, min_correspondences=min_correspondences,
            eigen_threshold=eigen_threshold,
            converge_rot_deg=converge_rot_deg,
            converge_trans_cm=converge_trans_cm)
        state = _freeze(active, new, state)
        it = it + active.to(torch.int32)
    return RegisterResult(
        pose6=state.pose6,
        converged=state.converged,
        iterations=it,
        n_corr=state.n_corr,
        is_degenerate=state.is_degenerate,
        valid=gate,
    )


def register_scan_fast(features, local_map, init_pose6, *,
                       max_iterations: int = 30,
                       min_correspondences: int = 50,
                       eigen_threshold: float = 100.0,
                       edge_min_valid: int = 10, surf_min_valid: int = 100,
                       chunk: int = 4096, num_candidates: int = 16,
                       refetch_dist: float = 0.15,
                       converge_rot_deg: float = 0.05,
                       converge_trans_cm: float = 0.05) -> RegisterResult:
    """Candidate-prefetch scan-to-map solve on the streamed k-NN: the math
    of `register_scan`, with the K = num_candidates nearest map points of
    each feature fetched by one streamed pass (`prefetch_candidates`) at the
    initial pose and again whenever the lane moves more than refetch_dist
    from its fetch point; each GN iteration takes its 5-NN among them.

    features [B, ...]; local_map shared ([M, 3]) or one per lane ([B, M, 3]),
    M a multiple of `chunk`; init_pose6 [B, 6]."""
    def per_lane(a, lanes, dim):
        return a[lanes] if a.dim() == dim else a

    def fetch(pose, lanes):
        out = []
        for xyz, ref, msk in (
                (features.corner_xyz, local_map.corner_xyz,
                 local_map.corner_mask),
                (features.surf_xyz, local_map.surf_xyz,
                 local_map.surf_mask)):
            out += prefetch_candidates(
                torch.stack(world_components(pose, xyz[lanes]), -1),
                per_lane(ref, lanes, 3), per_lane(msk, lanes, 2),
                num_candidates, chunk)
        return out

    return _prefetch_solve(
        features, fetch, init_pose6, refetch_dist=refetch_dist,
        max_iterations=max_iterations,
        min_correspondences=min_correspondences,
        eigen_threshold=eigen_threshold, edge_min_valid=edge_min_valid,
        surf_min_valid=surf_min_valid, converge_rot_deg=converge_rot_deg,
        converge_trans_cm=converge_trans_cm)


def register_grid_core(features, local_map, corner_grid_table,
                       surf_grid_table, grid_origin_xyz, init_pose6, *,
                       grid_dims, cell_size: float = 1.0, cell_cap: int = 16,
                       max_iterations: int = 30,
                       min_correspondences: int = 50,
                       eigen_threshold: float = 100.0,
                       edge_min_valid: int = 10, surf_min_valid: int = 100,
                       converge_rot_deg: float = 0.05,
                       converge_trans_cm: float = 0.05) -> RegisterResult:
    """`register_core` on the packed grid's exact 27-cell 5-NN: tables from
    `ops.hashgrid.build_grid_packed` (one per map, amortized over every scan
    and iteration).  Exact against `register_scan` for every gated
    correspondence (the 27 cells cover the 1 m accept radius).  local_map
    is the JAX signature's; the tables carry the map."""
    del local_map
    knn = [_lanes_knn(make_packed_grid_knn(t, grid_origin_xyz, cell_size,
                                           dims=grid_dims,
                                           cell_cap=cell_cap))
           for t in (corner_grid_table, surf_grid_table)]
    return register_core(
        features, knn[0], knn[1], init_pose6,
        max_iterations=max_iterations,
        min_correspondences=min_correspondences,
        eigen_threshold=eigen_threshold,
        edge_min_valid=edge_min_valid,
        surf_min_valid=surf_min_valid,
        converge_rot_deg=converge_rot_deg,
        converge_trans_cm=converge_trans_cm,
    )


def register_scan_fast_grid(features, local_map, corner_grid_table,
                            surf_grid_table, grid_origin_xyz, init_pose6, *,
                            grid_dims, cell_size: float = 1.0,
                            cell_cap: int = 16, num_candidates: int = 16,
                            refetch_dist: float = 0.15,
                            max_iterations: int = 30,
                            min_correspondences: int = 50,
                            eigen_threshold: float = 100.0,
                            edge_min_valid: int = 10,
                            surf_min_valid: int = 100,
                            converge_rot_deg: float = 0.05,
                            converge_trans_cm: float = 0.05
                            ) -> RegisterResult:
    """Packed-grid candidate prefetch + in-candidate 5-NN: the solve of
    `register_scan_fast` with each fetch one 27-cell lookup
    (`grid_knn_packed` at k = num_candidates) on the packed tables.
    local_map is the JAX signature's; the tables carry the map."""
    del local_map
    knn = [make_packed_grid_knn(t, grid_origin_xyz, cell_size,
                                dims=grid_dims, cell_cap=cell_cap,
                                k=num_candidates)
           for t in (corner_grid_table, surf_grid_table)]

    def fetch(pose, lanes):
        out = []
        for xyz, fn in ((features.corner_xyz, knn[0]),
                        (features.surf_xyz, knn[1])):
            b, P = lanes.shape[0], xyz.shape[1]
            d2, nn = fn(_to_world(pose, xyz[lanes]))
            out += [nn.view(b, P, num_candidates, 3),
                    (d2 < 1e37).view(b, P, num_candidates)]
        return out

    return _prefetch_solve(
        features, fetch, init_pose6, refetch_dist=refetch_dist,
        max_iterations=max_iterations,
        min_correspondences=min_correspondences,
        eigen_threshold=eigen_threshold, edge_min_valid=edge_min_valid,
        surf_min_valid=surf_min_valid, converge_rot_deg=converge_rot_deg,
        converge_trans_cm=converge_trans_cm)


def round_iterations(corner_xyz, corner_mask, corner_nn, corner_valid,
                     surf_xyz, surf_mask, surf_nn, surf_valid, state, it,
                     gate, *, iters: int, min_correspondences: int,
                     eigen_threshold: float, converge_rot_deg: float,
                     converge_trans_cm: float, min_plane_spread: float):
    """One round's GN iterations of `register_rounds_core`, driven from the
    host: the plain version of the kernel `csrc/rounds_gn.cu`
    (`ops/rounds_gn.py::rounds_gn_reference` runs it).

    corner_xyz [B, Pc, 3], corner_mask [B, Pc]; corner_nn [B*Pc, K, 3] and
    corner_valid [B*Pc, K] the round's candidates (the surf ones alike);
    state: GNState [B]; it [B] iterations before the round; gate [B] the
    feature-count gate.  Per lane, as the JAX package's while-loop: up to
    `iters` iterations, ending at convergence or at once for a gated-off
    lane; the degeneracy projector taken at the lane's iteration 0.  Lanes
    that have stopped are frozen with `torch.where`, and the loop ends as
    soon as no lane is active (the same results as running the whole
    budget masked, with fewer steps).  Returns (state, iterations run
    [B])."""
    B, Pc, _ = corner_xyz.shape
    Ps = surf_xyz.shape[1]
    pts_all = torch.cat([corner_xyz, surf_xyz], dim=1)
    cmask = corner_mask.reshape(B * Pc)
    smask = surf_mask.reshape(B * Ps)
    done = torch.zeros(B, dtype=torch.int32, device=gate.device)
    for _ in range(iters):
        active = gate & ~state.converged
        if not bool(active.any()):
            break
        c_coeff, c_resid, c_mask = corner_correspondence_cand(
            _to_world(state.pose6, corner_xyz), cmask, corner_nn,
            corner_valid)
        s_coeff, s_resid, s_mask = surf_correspondence_cand(
            _to_world(state.pose6, surf_xyz), smask, surf_nn, surf_valid,
            min_plane_spread=min_plane_spread)
        new = gn_step(
            state, pts_all,
            torch.cat([c_coeff.view(B, Pc, 3), s_coeff.view(B, Ps, 3)], 1),
            torch.cat([c_resid.view(B, Pc), s_resid.view(B, Ps)], 1),
            torch.cat([c_mask.view(B, Pc), s_mask.view(B, Ps)], 1),
            it + done,
            min_correspondences=min_correspondences,
            eigen_threshold=eigen_threshold,
            converge_rot_deg=converge_rot_deg,
            converge_trans_cm=converge_trans_cm)
        state = _freeze(active, new, state)
        done = done + active.to(torch.int32)
    return state, done


def _planes(fetch, query):
    """A fetch closure's result at world points [Q, 3] in the layout of
    `rounds_gn`: (d2 [K, Q], candidates [3K, Q]), both contiguous.  The
    port's kernel-route closures (`ops.fetch.make_pallas_block_knn`) give
    plane-major candidates themselves (`fetch.planes`); any other closure's
    (d2 [Q, K], nn [Q, K, 3]) is transposed."""
    if hasattr(fetch, "planes"):
        d2, cand = fetch.planes(query)
    else:
        d2, nn = fetch(query)
        cand = nn.permute(2, 1, 0).reshape(-1, nn.shape[0])
    return d2.t().contiguous(), cand.contiguous()


def register_rounds_core(
    features,
    corner_fetch,
    surf_fetch,
    init_pose6,
    *,
    num_rounds: int = 3,
    iters_per_round: int = 10,
    min_correspondences: int = 50,
    eigen_threshold: float = 100.0,
    edge_min_valid: int = 10,
    surf_min_valid: int = 100,
    converge_rot_deg: float = 0.05,
    converge_trans_cm: float = 0.05,
    min_plane_spread: float = 0.0,
) -> RegisterResult:
    """Rounds-structured solve over a batch of lanes: (prefetch K candidates
    -> up to I candidate-GN iterations) x R.

    features: ScanFeatures [B, ...]; init_pose6 [B, 6].  corner_fetch /
    surf_fetch: world points of all lanes [B*P, 3] -> (cand_d2 [B*P, K],
    cand_nn [B*P, K, 3]); a candidate is valid where d2 < 1e37.

    Per lane, as the JAX package's vmapped solve: the feature-count gate;
    `converged` reset at each round start (a fresh candidate set must
    re-verify it); then the round's iterations, one `ops.rounds_gn.rounds_gn`
    call (the kernel `csrc/rounds_gn.cu` on CUDA tensors, with no host sync
    in the solve; `round_iterations` on CPU tensors): each lane runs until
    the round's budget, its convergence, or at once when gated off;
    `iterations` counted per lane; the degeneracy projector taken at the
    lane's iteration 0.  All R rounds run, as the JAX `lax.scan` does.
    """
    stat, matP = initial_state(features, init_pose6,
                               edge_min_valid=edge_min_valid,
                               surf_min_valid=surf_min_valid)
    featc = feature_planes(features.corner_xyz, features.corner_mask)
    feats = feature_planes(features.surf_xyz, features.surf_mask)

    for _ in range(num_rounds):
        stat[:, 7] = 0.0
        cd2, candc = _planes(corner_fetch,
                             _to_world(stat[:, 0:6], features.corner_xyz))
        sd2, cands = _planes(surf_fetch,
                             _to_world(stat[:, 0:6], features.surf_xyz))
        stat, matP = rounds_gn(
            stat, matP, featc, feats, candc, cands, cd2, sd2,
            K=cd2.shape[0], iters=iters_per_round,
            min_corr=min_correspondences, eig_thresh=eigen_threshold,
            conv_rot_deg=converge_rot_deg, conv_trans_cm=converge_trans_cm,
            min_plane_spread=min_plane_spread)

    return unpack(stat)


def grid_register_step(local_map, features, pose6, *, half_extent,
                       cell_size: float = 2.0, corner_cell_cap: int = 16,
                       surf_cell_cap: int = 64, max_iterations: int = 30,
                       min_correspondences: int = 50,
                       edge_min_valid: int = 10, surf_min_valid: int = 100,
                       min_plane_spread: float = 0.0) -> RegisterResult:
    """Grid tables around the pose + the rounds-structured solve: the
    single-scan registration step of the localization pipeline.

    local_map: FeatureMap [M] in the world frame; features: ScanFeatures of
    one scan [1, ...]; pose6 [1, 6].  The tables span pose +- half_extent
    (plus a 2 m margin) in cells of `cell_size`, built by
    `build_map_planar_tables(resident=True, lower_pad=True)`: a table whose
    compact form fits the resident cap runs `resident_fetch`, a larger one
    `block_fetch` (CUDA kernels on CUDA tensors).  Then
    ceil(max_iterations / 10) rounds of (K=16 candidate fetch, up to 10 GN
    iterations).  The JAX step gathers the same 2x2x2 cells in the same
    order from its octant-sentinel tables and keeps the same K smallest
    d2 with ties to the lower slot, so the candidates agree; lower_pad
    gives a query within half a cell of a lower face the in-grid cells of
    its octant, as the octant rule does."""
    # parallel.batch imports this module
    from ..parallel.batch import build_map_planar_tables
    from .fetch import make_pallas_block_knn

    ctab, stab, origin, dims = build_map_planar_tables(
        local_map, pose6[0, 3:6], half_extent, cell_size, corner_cell_cap,
        surf_cell_cap, resident=True, lower_pad=True)
    iters_per_round = 10
    knn = [make_pallas_block_knn(t, origin, cell_size, dims=dims,
                                 cell_cap=cap, k=16)
           for t, cap in ((ctab, corner_cell_cap), (stab, surf_cell_cap))]
    return register_rounds_core(
        features, knn[0], knn[1], pose6,
        num_rounds=max(1, -(-max_iterations // iters_per_round)),
        iters_per_round=iters_per_round,
        min_correspondences=min_correspondences,
        edge_min_valid=edge_min_valid, surf_min_valid=surf_min_valid,
        min_plane_spread=min_plane_spread)


def grid_overflow(local_map, center, *, half_extent, cell_size: float = 2.0,
                  corner_cell_cap: int = 16, surf_cell_cap: int = 64):
    """Share of the local map's in-grid corner and surf points that the
    tables of `grid_register_step` around `center` [3] drop at their cell
    caps: a float32 [2] tensor on the map's device (no host sync)."""
    dims = default_grid_spec(half_extent, cell_size)
    origin = grid_origin(center, half_extent,
                         device=local_map.corner_xyz.device)
    return torch.stack([
        grid_overflow_fraction(xyz, m, origin, cell_size, dims=dims,
                               cell_cap=cap)
        for xyz, m, cap in (
            (local_map.corner_xyz, local_map.corner_mask, corner_cell_cap),
            (local_map.surf_xyz, local_map.surf_mask, surf_cell_cap))])


def transform_update(pose6, imu_rpy_init, imu_available,
                     imu_weight: float = 0.05,
                     rotation_tolerance: float = 1000.0,
                     z_tolerance: float = 1000.0):
    """IMU attitude slerp fusion + clamps (transformUpdate /
    constraintTransformation, ref: src/mapOptmization.h:1444-1489), batched:
    pose6 [B, 6], imu_rpy_init [B, 3], imu_available [B].  Where IMU
    attitude is available and |pitch| < 1.4 rad, roll and pitch slerp toward
    it with weight imu_weight; then roll, pitch and z are clamped."""
    use = imu_available & (torch.abs(imu_rpy_init[:, 1]) < 1.4)
    zero = torch.zeros_like(pose6[:, 0])

    def fused(i, q_pose, q_imu):
        return euler_from_quat(quat_slerp(q_pose, q_imu, imu_weight))[i]

    roll = fused(0, quat_from_euler(pose6[:, 0], zero, zero),
                 quat_from_euler(imu_rpy_init[:, 0], zero, zero))
    pitch = fused(1, quat_from_euler(zero, pose6[:, 1], zero),
                  quat_from_euler(zero, imu_rpy_init[:, 1], zero))
    roll = torch.where(use, roll, pose6[:, 0])
    pitch = torch.where(use, pitch, pose6[:, 1])
    out = pose6.clone()
    out[:, 0] = torch.clamp(roll, -rotation_tolerance, rotation_tolerance)
    out[:, 1] = torch.clamp(pitch, -rotation_tolerance, rotation_tolerance)
    out[:, 5] = torch.clamp(pose6[:, 5], -z_tolerance, z_tolerance)
    return out
