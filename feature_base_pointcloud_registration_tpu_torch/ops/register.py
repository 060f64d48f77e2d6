"""Scan-to-map registration: the result type and the rounds-structured solve.

Port of the JAX package's `ops/register.py` (`RegisterResult`,
`register_rounds_core`).  The fused solve of the main path lives in
`parallel/batch.py`; this solver is the body of `batch_register_blocks` and
`batch_register_pallas` there.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geom.se3 import euler_to_rot
from .correspondence import (corner_correspondence_cand,
                             surf_correspondence_cand)
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
    re-verify it); a while-loop per round that ends at the round's budget,
    at convergence, or at once for a gated-off lane; `iterations` counted
    per lane; the degeneracy projector taken at the lane's iteration 0.
    Lanes that have stopped are frozen with `torch.where`, and a round
    ends as soon as no lane is active (the same results as running the
    whole budget masked, with fewer steps).
    """
    B, Pc, _ = features.corner_xyz.shape
    Ps = features.surf_xyz.shape[1]
    dev = features.corner_xyz.device
    gate = ((features.corner_mask.sum(1) > edge_min_valid)
            & (features.surf_mask.sum(1) > surf_min_valid))
    false = torch.zeros(B, dtype=torch.bool, device=dev)
    state = GNState(
        pose6=torch.as_tensor(init_pose6, dtype=torch.float32,
                              device=dev).clone(),
        matP=torch.eye(6, dtype=torch.float32, device=dev).repeat(B, 1, 1),
        is_degenerate=false,
        converged=false,
        n_corr=torch.zeros(B, dtype=torch.int32, device=dev),
    )
    it = torch.zeros(B, dtype=torch.int32, device=dev)
    pts_all = torch.cat([features.corner_xyz, features.surf_xyz], dim=1)
    cmask = features.corner_mask.reshape(B * Pc)
    smask = features.surf_mask.reshape(B * Ps)

    for _ in range(num_rounds):
        state = state._replace(converged=false)
        cd, cnn = corner_fetch(_to_world(state.pose6, features.corner_xyz))
        sd, snn = surf_fetch(_to_world(state.pose6, features.surf_xyz))
        ccv, scv = cd < 1e37, sd < 1e37
        done = torch.zeros(B, dtype=torch.int32, device=dev)
        for _ in range(iters_per_round):
            active = gate & ~state.converged
            if not bool(active.any()):
                break
            c_coeff, c_resid, c_mask = corner_correspondence_cand(
                _to_world(state.pose6, features.corner_xyz), cmask, cnn, ccv)
            s_coeff, s_resid, s_mask = surf_correspondence_cand(
                _to_world(state.pose6, features.surf_xyz), smask, snn, scv,
                min_plane_spread=min_plane_spread)
            new = gn_step(
                state, pts_all,
                torch.cat([c_coeff.view(B, Pc, 3), s_coeff.view(B, Ps, 3)],
                          1),
                torch.cat([c_resid.view(B, Pc), s_resid.view(B, Ps)], 1),
                torch.cat([c_mask.view(B, Pc), s_mask.view(B, Ps)], 1),
                it + done,
                min_correspondences=min_correspondences,
                eigen_threshold=eigen_threshold,
                converge_rot_deg=converge_rot_deg,
                converge_trans_cm=converge_trans_cm)
            state = GNState(*(
                torch.where(active.view(B, *[1] * (n.dim() - 1)), n, o)
                for n, o in zip(new, state)))
            done = done + active.to(torch.int32)
        it = it + done

    return RegisterResult(
        pose6=state.pose6,
        converged=state.converged,
        iterations=it,
        n_corr=state.n_corr,
        is_degenerate=state.is_degenerate,
        valid=gate,
    )
