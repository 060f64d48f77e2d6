"""Point-to-line / point-to-plane correspondence with analytic coefficients.

Port of the JAX package's `ops/correspondence.py`, a vectorized rebuild of
cornerOptimization / surfOptimization (ref: src/mapOptmization.h:1002-1215).
Every query point is processed at once; all accept/reject gates become
masks:

  corner: 5th-NN d2 < 1.0 (ref :1027), line test l0 > 3*l1 (ref :1063),
          weight s = 1 - 0.9*|ld2| > 0.1 (ref :1106,1115)
  surf:   5th-NN d2 < 1.0 (ref :1154), plane residual <= 0.2 m for all 5
          neighbors (ref :1184-1189), s = 1 - 0.9*|pd2|/sqrt(||p||) > 0.1
          (ref :1198,1207 — sqrt(sqrt(squared norm)))

Outputs per query point: unit-direction coefficients scaled by s, weighted
residual, validity mask.  Rejected points are zeroed with `torch.where`, so
the junk arithmetic of a point with no candidates (FAR or zero coordinates)
never reaches the solve.  Shapes of the candidate path: pts_world [N,3],
valid [N], cand_xyz [N,K,3], cand_valid [N,K]; the batched solver flattens
its lanes into N.  The `knn_fn` path (`corner_correspondence`,
`surf_correspondence`) takes the exact 5-NN of a search function and keeps
the caller's leading dims.
"""

from __future__ import annotations

import torch

from .eig3 import eigvals_sym3, principal_eigvec_sym3

_BIG = 3.0e38


def select_smallest(d2, k: int):
    """Boolean mask of the k smallest entries along the last axis (ties by
    lower index), plus the largest selected value.

    rank_i = #{j : d2_j < d2_i, ties by index} via an all-pairs [..., K, K]
    comparison; consumers use the mask in weighted-sum form.
    """
    K = d2.shape[-1]
    idx = torch.arange(K, device=d2.device)
    a, b = d2[..., None, :], d2[..., :, None]
    earlier = (a < b) | ((a == b) & (idx[None, :] < idx[:, None]))
    rank = earlier.sum(-1)                                # [..., K]
    sel = rank < k
    dmax = torch.where(sel, d2, -torch.inf).amax(-1)
    return sel, dmax


def _cand_d2(pts_world, cand_xyz, cand_valid):
    diff = pts_world[:, None, :] - cand_xyz
    d2 = (diff * diff).sum(-1)
    return torch.where(cand_valid, d2, _BIG)


def _from_knn(tail, pts_world, valid, knn_fn, **kw):
    """A fit tail on the exact 5-NN of knn_fn: pts_world [..., N, 3] ->
    (coeff [..., N, 3], resid [..., N], mask [..., N])."""
    d2, nn = knn_fn(pts_world)                  # [..., N, 5], [..., N, 5, 3]
    lead = pts_world.shape[:-1]
    d2 = d2.reshape(-1, d2.shape[-1])
    coeff, resid, mask = tail(
        pts_world.reshape(-1, 3), valid.reshape(-1),
        nn.reshape(-1, *nn.shape[-2:]), torch.ones_like(d2, dtype=torch.bool),
        d2.amax(-1), **kw)
    return coeff.reshape(*lead, 3), resid.reshape(lead), mask.reshape(lead)


def corner_correspondence(pts_world, valid, knn_fn):
    """Point-to-line coefficients for corner features from knn_fn: q ->
    (d2 [..., 5], nn [..., 5, 3]), the exact 5-NN (every neighbor used).
    pts_world [..., N, 3], valid [..., N]."""
    return _from_knn(_corner_from_candidates, pts_world, valid, knn_fn)


def surf_correspondence(pts_world, valid, knn_fn, *,
                        min_plane_spread: float = 0.0):
    """Point-to-plane coefficients for surface features from knn_fn (as
    `corner_correspondence`)."""
    return _from_knn(_surf_from_candidates, pts_world, valid, knn_fn,
                     min_plane_spread=min_plane_spread)


def corner_correspondence_cand(pts_world, valid, cand_xyz, cand_valid):
    """Point-to-line coefficients straight from a K-candidate set: d2 at
    the current pose + rank-mask 5-NN selection + masked-sum line fit."""
    sel, dmax = select_smallest(_cand_d2(pts_world, cand_xyz, cand_valid), 5)
    return _corner_from_candidates(pts_world, valid, cand_xyz, sel, dmax)


def _corner_from_candidates(pts_world, valid, nn, sel, d5max):
    """Shared line-fit tail; sel selects exactly the 5-NN among nn's rows."""
    gate_nn = valid & (d5max < 1.0)

    selF = sel.to(nn.dtype)[..., None]                    # [N,K,1]
    c = (nn * selF).sum(1) / 5.0                          # [N,3]
    dev = (nn - c[:, None, :]) * selF
    cov = (dev[:, :, :, None] * dev[:, :, None, :]).sum(1) / 5.0  # [N,3,3]
    w = eigvals_sym3(cov)
    lam_max, lam_mid = w[:, 2], w[:, 1]
    v = principal_eigvec_sym3(cov, lam_max)               # line direction
    gate_line = lam_max > 3.0 * lam_mid

    p0 = pts_world
    p1 = c + 0.1 * v
    p2 = c - 0.1 * v

    # |(p0-p1) x (p0-p2)| and derivative direction (ref :1083-1103)
    d01 = p0 - p1
    d02 = p0 - p2
    cx = d01[:, 0] * d02[:, 1] - d02[:, 0] * d01[:, 1]
    cy = d01[:, 0] * d02[:, 2] - d02[:, 0] * d01[:, 2]
    cz = d01[:, 1] * d02[:, 2] - d02[:, 1] * d01[:, 2]
    a012 = torch.sqrt(cx * cx + cy * cy + cz * cz)

    d12 = p1 - p2
    l12 = torch.sqrt((d12 * d12).sum(-1))

    denom = a012 * l12
    safe = torch.where(denom > 1e-12, denom, 1.0)
    la = (d12[:, 1] * cx + d12[:, 2] * cy) / safe
    lb = -(d12[:, 0] * cx - d12[:, 2] * cz) / safe
    lc = -(d12[:, 0] * cy + d12[:, 1] * cz) / safe

    ld2 = a012 / torch.where(l12 > 1e-12, l12, 1.0)
    s = 1.0 - 0.9 * torch.abs(ld2)
    mask = gate_nn & gate_line & (s > 0.1) & (denom > 1e-12)

    coeff = s[:, None] * torch.stack([la, lb, lc], dim=-1)
    return (torch.where(mask[:, None], coeff, 0.0),
            torch.where(mask, s * ld2, 0.0), mask)


def surf_correspondence_cand(pts_world, valid, cand_xyz, cand_valid, *,
                             min_plane_spread: float = 0.0):
    """Point-to-plane coefficients straight from a K-candidate set
    (rank-mask 5-NN selection + masked-sum plane fit)."""
    sel, dmax = select_smallest(_cand_d2(pts_world, cand_xyz, cand_valid), 5)
    return _surf_from_candidates(pts_world, valid, cand_xyz, sel, dmax,
                                 min_plane_spread=min_plane_spread)


def _householder_lstsq3(A, b):
    """argmin_n ||A n - b|| for A [N,K,3] (all-zero rows allowed), via 3
    Householder reflections + back substitution (error grows with cond(A),
    not cond(A)^2; the reference uses colPivHouseholderQr, ref :1169).
    Returns (n [N,3], |r00*r11*r22| [N]), the latter the rank gate."""
    K = A.shape[1]
    rows = torch.arange(K, device=A.device)
    cols = [A[:, :, 0], A[:, :, 1], A[:, :, 2]]
    y = b
    for j in range(3):
        x = torch.where((rows >= j)[None, :], cols[j], 0.0)   # [N,K]
        normx = torch.sqrt((x * x).sum(1))
        pj = x[:, j]
        alpha = -torch.where(pj >= 0, 1.0, -1.0) * normx
        v = x - alpha[:, None] * (rows == j)[None, :].to(x.dtype)
        vn2 = (v * v).sum(1)
        inv = torch.where(vn2 > 1e-30, 2.0 / vn2, 0.0)
        for c in range(j, 3):
            coef = inv * (v * cols[c]).sum(1)
            cols[c] = cols[c] - coef[:, None] * v
        coefy = inv * (v * y).sum(1)
        y = y - coefy[:, None] * v
    r00, r01, r02 = cols[0][:, 0], cols[1][:, 0], cols[2][:, 0]
    r11, r12 = cols[1][:, 1], cols[2][:, 1]
    r22 = cols[2][:, 2]

    def _safe(d):
        return torch.where(torch.abs(d) > 1e-20, d, 1e-20)

    n2 = y[:, 2] / _safe(r22)
    n1 = (y[:, 1] - r12 * n2) / _safe(r11)
    n0 = (y[:, 0] - r01 * n1 - r02 * n2) / _safe(r00)
    return torch.stack([n0, n1, n2], dim=-1), torch.abs(r00 * r11 * r22)


def _surf_from_candidates(pts_world, valid, nn, sel, d5max, *,
                          min_plane_spread: float = 0.0):
    """Shared plane-fit tail; sel selects exactly the 5-NN among nn's rows.

    min_plane_spread (meters; 0 = off = reference parity): the neighbor
    scatter's middle singular value must reach it (an opt-in collinearity
    gate the reference lacks; see the JAX package's docstring)."""
    gate_nn = valid & (d5max < 1.0)

    selF = sel.to(nn.dtype)
    n, detR = _householder_lstsq3(nn * selF[..., None], -selF)
    ok_det = detR > 1e-5

    ps = torch.sqrt((n * n).sum(-1))
    ps_safe = torch.where(ps > 1e-12, ps, 1.0)
    pa = n[:, 0] / ps_safe
    pb = n[:, 1] / ps_safe
    pc = n[:, 2] / ps_safe
    pd = 1.0 / ps_safe

    plane_res = torch.abs(pa[:, None] * nn[:, :, 0] + pb[:, None] * nn[:, :, 1]
                          + pc[:, None] * nn[:, :, 2] + pd[:, None])
    plane_valid = (torch.where(sel, plane_res <= 0.2, True).all(1)
                   & ok_det & (ps > 1e-12))

    pd2 = (pa * pts_world[:, 0] + pb * pts_world[:, 1]
           + pc * pts_world[:, 2] + pd)
    # ref :1198: the inner argument is the SQUARED norm: divisor ||p||^(1/2)
    sumsq = (pts_world * pts_world).sum(-1)
    s = 1.0 - 0.9 * torch.abs(pd2) / torch.sqrt(
        torch.sqrt(torch.clamp(sumsq, min=1e-12)))

    mask = gate_nn & plane_valid & (s > 0.1)
    if min_plane_spread > 0.0:
        cnt = torch.clamp(selF.sum(1), min=1.0)
        mu = (nn * selF[..., None]).sum(1) / cnt[:, None]
        d = (nn - mu[:, None, :]) * selF[..., None]
        C = (d[:, :, :, None] * d[:, :, None, :]).sum(1) / cnt[:, None, None]
        lam_mid = eigvals_sym3(C)[:, 1]
        mask = mask & (torch.sqrt(torch.clamp(lam_mid, min=0.0))
                       >= min_plane_spread)
    coeff = s[:, None] * torch.stack([pa, pb, pc], dim=-1)
    return (torch.where(mask[:, None], coeff, 0.0),
            torch.where(mask, s * pd2, 0.0), mask)
