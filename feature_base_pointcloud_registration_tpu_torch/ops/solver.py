"""Gauss-Newton pose update with LOAM's degeneracy projection.

Port of the JAX package's `ops/solver.py`, the rebuild of LMOptimization
(ref: src/mapOptmization.h:1246-1401; a plain Gauss-Newton step).  Each
Jacobian row is

    J_i = [ n_i^T (dR/droll) p_i,  n_i^T (dR/dpitch) p_i,  n_i^T (dR/dyaw) p_i,
            n_x, n_y, n_z ],     b_i = -w_i * d_i

with R = Rz(yaw) Ry(pitch) Rx(roll).  The 6x6 normal equations are solved by
eigendecomposition (`torch.linalg.eigh`, where the JAX package calls
`jnp.linalg.eigh`), which doubles as the degeneracy analysis:

  * at a lane's iteration 0, eigenvalues < 100 mark degenerate directions;
    the projector P = V diag(lambda >= 100) V^T is cached and applied to
    every later step (ref :1346-1377), iteration 0 included;
  * convergence when |dR| < 0.05 deg and |dt| < 0.05 cm (ref :1388-1400).

Every function takes any leading batch dims: the port writes out the lane
axis that the JAX package vmaps over.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class GNState(NamedTuple):
    pose6: torch.Tensor          # f32 [..., 6] (roll, pitch, yaw, x, y, z)
    matP: torch.Tensor           # f32 [..., 6, 6] projector (iter-0 cached)
    is_degenerate: torch.Tensor  # bool [...]
    converged: torch.Tensor      # bool [...]
    n_corr: torch.Tensor         # i32 [...]


def _rotation_derivatives(roll, pitch, yaw):
    """dR/droll, dR/dpitch, dR/dyaw [..., 3, 3] for R = Rz(y)Ry(p)Rx(r)."""
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    zero = torch.zeros_like(roll)

    def mat(rows):
        return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)

    dR_roll = mat([
        (zero, cy * sp * cr + sy * sr, -cy * sp * sr + sy * cr),
        (zero, sy * sp * cr - cy * sr, -sy * sp * sr - cy * cr),
        (zero, cp * cr, -cp * sr)])
    dR_pitch = mat([
        (-cy * sp, cy * cp * sr, cy * cp * cr),
        (-sy * sp, sy * cp * sr, sy * cp * cr),
        (-cp, -sp * sr, -sp * cr)])
    dR_yaw = mat([
        (-sy * cp, -sy * sp * sr - cy * cr, -sy * sp * cr + cy * sr),
        (cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr),
        (zero, zero, zero)])
    return dR_roll, dR_pitch, dR_yaw


def gn_step(state: GNState, pts_lidar, coeff, resid, mask, iter_count,
            min_correspondences: int = 50,
            eigen_threshold: float = 100.0,
            converge_rot_deg: float = 0.05,
            converge_trans_cm: float = 0.05) -> GNState:
    """One masked Gauss-Newton update per lane.

    pts_lidar [..., N, 3] correspondence points in the LIDAR frame;
    coeff [..., N, 3] s-weighted residual gradients w.r.t. the world point;
    resid [..., N] s-weighted distances; mask [..., N] validity;
    iter_count [...] the lane's iteration index (0 = capture the projector).
    """
    pose = state.pose6
    n_corr = mask.sum(-1).to(torch.int32)
    enough = n_corr >= min_correspondences   # ref :1268 bails below 50

    dRs = _rotation_derivatives(pose[..., 0], pose[..., 1], pose[..., 2])
    rot = [(coeff * torch.einsum("...ij,...nj->...ni", dR, pts_lidar)).sum(
        -1, keepdim=True) for dR in dRs]
    J = torch.cat([*rot, coeff], dim=-1)                  # [..., N, 6]
    J = torch.where(mask[..., None], J, 0.0)
    b = torch.where(mask, -resid, 0.0)

    Jt = J.transpose(-1, -2)
    JtJ = Jt @ J
    Jtb = (Jt @ b[..., None])[..., 0]

    lam, V = torch.linalg.eigh(JtJ)                       # ascending
    lam_safe = torch.where(torch.abs(lam) > 1e-9, lam, 1e-9)
    Vt = V.transpose(-1, -2)
    x = (V @ ((Vt @ Jtb[..., None])[..., 0] / lam_safe)[..., None])[..., 0]

    # degeneracy analysis cached at the lane's iteration 0 (ref :1346-1371);
    # V diag(good) V^T does not depend on the eigenvectors' signs
    good = lam >= eigen_threshold
    matP_new = (V * good[..., None, :].to(V.dtype)) @ Vt
    first = iter_count == 0
    matP = torch.where(first[..., None, None], matP_new, state.matP)
    is_degenerate = torch.where(first, (~good).any(-1), state.is_degenerate)

    x = torch.where(is_degenerate[..., None], (matP @ x[..., None])[..., 0],
                    x)

    delta_r_deg = torch.sqrt(((x[..., :3] * (180.0 / math.pi)) ** 2).sum(-1))
    delta_t_cm = torch.sqrt(((x[..., 3:] * 100.0) ** 2).sum(-1))
    converged = (enough & (delta_r_deg < converge_rot_deg)
                 & (delta_t_cm < converge_trans_cm))
    return GNState(
        pose6=torch.where(enough[..., None], pose + x, pose),
        matP=matP,
        is_degenerate=is_degenerate,
        converged=converged,
        n_corr=n_corr,
    )
