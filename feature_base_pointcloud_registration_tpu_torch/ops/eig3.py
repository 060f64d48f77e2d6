"""Closed-form symmetric 3x3 eigen-decomposition and Cramer solves.

Port of the JAX package's `ops/eig3.py`.  The correspondence loop needs, per
query point, the eigenvalues + principal eigenvector of a 3x3 covariance
(corner line test, ref: src/mapOptmization.h:1060-1078) and a 3x3 linear
solve (surf plane fit, ref :1169): trigonometric Cardano for the spectrum,
cross-product basis extraction for the eigenvector, adjugate/Cramer for the
solve.  All functions broadcast over leading dims (`[..., 3, 3]`).
"""

from __future__ import annotations

import math

import torch


def eigvals_sym3(A):
    """Eigenvalues of symmetric (...,3,3), ascending.  Trigonometric Cardano
    (stable for symmetric matrices)."""
    a00, a01, a02 = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    a11, a12, a22 = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]

    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22
          + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12))
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))
    p_safe = torch.where(p > 1e-12, p, 1.0)

    # det(B/p) / 2
    c00 = b11 * b22 - a12 * a12
    c01 = a01 * b22 - a12 * a02
    c02 = a01 * a12 - b11 * a02
    detB = b00 * c00 - a01 * c01 + a02 * c02
    r = torch.clamp(detB / (2.0 * p_safe ** 3), -1.0, 1.0)

    phi = torch.acos(r) / 3.0
    l2 = q + 2.0 * p * torch.cos(phi)                         # largest
    l0 = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)   # smallest
    l1 = 3.0 * q - l0 - l2
    near_diag = p <= 1e-12
    l0 = torch.where(near_diag, q, l0)
    l1 = torch.where(near_diag, q, l1)
    l2 = torch.where(near_diag, q, l2)
    return torch.stack([l0, l1, l2], dim=-1)


def principal_eigvec_sym3(A, lam_max):
    """Unit eigenvector for the largest eigenvalue of symmetric (...,3,3).

    Rows of (A - lam I) span the orthogonal complement of the eigenvector;
    the largest pairwise cross product of rows is the eigenvector.  Falls
    back to e_x for (near-)isotropic matrices.
    """
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    B = A - lam_max[..., None, None] * eye
    r0, r1, r2 = B[..., 0, :], B[..., 1, :], B[..., 2, :]
    c01 = torch.linalg.cross(r0, r1)
    c02 = torch.linalg.cross(r0, r2)
    c12 = torch.linalg.cross(r1, r2)
    n01 = (c01 * c01).sum(-1)
    n02 = (c02 * c02).sum(-1)
    n12 = (c12 * c12).sum(-1)
    best = torch.where(((n01 >= n02) & (n01 >= n12))[..., None], c01,
                       torch.where((n02 >= n12)[..., None], c02, c12))
    norm = torch.sqrt((best * best).sum(-1, keepdim=True))
    ok = norm > 1e-20
    v = best / torch.where(ok, norm, 1.0)
    fallback = torch.tensor([1.0, 0.0, 0.0], dtype=A.dtype, device=A.device)
    return torch.where(ok, v, fallback)


def det3(A):
    return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2]
                            - A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2]
                              - A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1]
                              - A[..., 1, 1] * A[..., 2, 0]))


def solve3(A, b):
    """Cramer solve of (...,3,3) x = (...,3).  Returns (x, det)."""
    d = det3(A)
    d_safe = torch.where(torch.abs(d) > 1e-20, d, 1.0)
    cols = []
    for j in range(3):
        Aj = A.clone()
        Aj[..., :, j] = b
        cols.append(det3(Aj) / d_safe)
    return torch.stack(cols, dim=-1), d
