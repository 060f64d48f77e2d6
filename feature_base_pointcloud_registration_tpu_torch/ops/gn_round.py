"""Fused Gauss-Newton round: one kernel launch runs a whole solve round.

Port of the JAX package's `ops/pallas_gn.py` (the TPU kernel
`_gn_round_kernel` behind `gn_round_pallas`).  For every scan lane it runs up
to `iters` candidate-local GN iterations, each lane with its own early exit
(converged, or failed feature gate).  Each iteration (the reference's hot
loop, scan2MapOptimization, ref: src/mapOptmization.h:1403-1442):

  * ZYX transform of the features to the world frame;
  * 5-of-K selection (iterative min extraction, ties by lowest row);
  * corner line fit: closed-form 3x3 spectrum (trigonometric Cardano),
    line gate lam_max > 3 lam_mid, principal eigenvector from cross products,
    point-to-line coefficients (ref :1002-1124);
  * surf plane fit: 3-reflection Householder least squares, 0.2 m plane
    check, |r00 r11 r22| > 1e-5, pivot floor 1e-6, clip 1e6, optional
    min_plane_spread gate (ref :1126-1215);
  * J rows [Jr, Jp, Jy, nx, ny, nz, -resid, mask] and G = J J^T;
  * at the lane's iteration 0 only: cyclic Jacobi of JtJ -> matP =
    V diag(lam >= eig_thresh) V^T and the degeneracy flag (ref :1346-1377);
  * (JtJ + 1e-2 I) x = Jtb by unpivoted Gauss-Jordan, projection by matP
    when degenerate, pose update when n_corr >= min_corr, convergence test
    (ref :1380-1401).

`gn_round` launches the CUDA kernel `csrc/gn_round.cu` on CUDA tensors and
runs `gn_round_reference` on CPU tensors.  Where the Pallas kernel used a
polynomial arccos (Mosaic has no acos), both use the library acos.
"""

from __future__ import annotations

import math

import torch

from .. import kernels

# stat vector slots (f32): [0:6] pose6, [6] executed iterations,
# [7] converged, [8] is_degenerate, [9] feature gate, [10] n_corr
STAT = 16

_BIG = 3.0e38
_PI = 3.14159265358979


def feature_planes(xyz, mask):
    """[B,P,3] + [B,P] -> [B,4,P] rows (x, y, z, mask), the GN layout."""
    return torch.cat([xyz.transpose(1, 2), mask[:, None, :].to(xyz.dtype)],
                     dim=1).contiguous()


def initial_state(features, init_poses, *, edge_min_valid: int = 10,
                  surf_min_valid: int = 100):
    """(stat [B,16], matP [B,36]) of ScanFeatures [B, ...] at init_poses
    [B, 6] before round 0: the pose, the feature gate (ref:
    edgeFeatureMinValidNum / surfFeatureMinValidNum) and an identity
    projector."""
    B = features.corner_xyz.shape[0]
    dev = features.corner_xyz.device
    n_edge = features.corner_mask.sum(1)
    n_surf = features.surf_mask.sum(1)
    stat = torch.zeros(B, STAT, dtype=torch.float32, device=dev)
    stat[:, 0:6] = torch.as_tensor(init_poses, dtype=torch.float32,
                                   device=dev)
    stat[:, 9] = ((n_edge > edge_min_valid)
                  & (n_surf > surf_min_valid)).to(torch.float32)
    matP = torch.eye(6, dtype=torch.float32, device=dev).reshape(
        1, 36).repeat(B, 1)
    return stat, matP


def _check(stat, matP, featc, feats, candc, cands, K):
    if K < 5:
        raise ValueError(f"K={K}: the 5-of-K selection needs K >= 5")
    if featc.dim() != 3 or featc.shape[1] != 4:
        raise ValueError(f"featc must be [B,4,Pc], got {tuple(featc.shape)}")
    B, _, Pc = featc.shape
    Ps = feats.shape[2]
    want = {"stat": (B, STAT), "matP": (B, 36), "feats": (B, 4, Ps),
            "candc": (3 * K, B * Pc), "cands": (3 * K, B * Ps)}
    for name, t in (("stat", stat), ("matP", matP), ("featc", featc),
                    ("feats", feats), ("candc", candc), ("cands", cands)):
        if name in want and tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != stat.device:
            raise ValueError(f"{name} is on {t.device}, stat on "
                             f"{stat.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return B, Pc, Ps


def _select5(d2, K):
    """5-of-K selection along dim 1: iterative min extraction, ties by the
    lowest row.  Returns (sel [B,K,P] 0/1 float, d5max [B,P])."""
    rows = torch.arange(K, device=d2.device)[None, :, None]
    d2m = d2
    sel = torch.zeros_like(d2)
    for _ in range(5):
        m = d2m.amin(dim=1, keepdim=True)
        ridx = torch.where(d2m == m, rows, K).amin(dim=1, keepdim=True)
        oh = rows == ridx
        sel = sel + oh.to(d2.dtype)
        d2m = torch.where(oh, _BIG, d2m)
    d5max = torch.where(sel > 0, d2, -math.inf).amax(dim=1)
    return sel, d5max


def _sym3_lam_max_mid(a00, a01, a02, a11, a12, a22):
    """Largest + middle eigenvalue of a symmetric 3x3 (trigonometric
    Cardano spectrum, the JAX package's ops/eig3.eigvals_sym3)."""
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22
          + 2.0 * (a01 * a01 + a02 * a02 + a12 * a12))
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=0.0))
    p_safe = torch.where(p > 1e-12, p, 1.0)
    c00 = b11 * b22 - a12 * a12
    c01 = a01 * b22 - a12 * a02
    c02 = a01 * a12 - b11 * a02
    detB = b00 * c00 - a01 * c01 + a02 * c02
    r = torch.clamp(detB / (2.0 * p_safe * p_safe * p_safe), -1.0, 1.0)
    phi = torch.acos(r) / 3.0
    l2 = q + 2.0 * p * torch.cos(phi)
    l0 = q + 2.0 * p * torch.cos(phi + 2.0 * _PI / 3.0)
    l1 = 3.0 * q - l0 - l2
    near_diag = p <= 1e-12
    return torch.where(near_diag, q, l2), torch.where(near_diag, q, l1)


def _corr_corner(fm, cand, xw, yw, zw, K):
    """Corner point-to-line coefficients.  fm, xw..zw [B,P]; cand
    [B,3,K,P].  Returns (ca, cb, cc, resid, maskf) each [B,P]."""
    cnx, cny, cnz = cand[:, 0], cand[:, 1], cand[:, 2]
    dx = cnx - xw[:, None]
    dy = cny - yw[:, None]
    dz = cnz - zw[:, None]
    sel, d5max = _select5(dx * dx + dy * dy + dz * dz, K)
    gate_nn = fm * (d5max < 1.0)

    cx = (cnx * sel).sum(1) / 5.0
    cy = (cny * sel).sum(1) / 5.0
    cz = (cnz * sel).sum(1) / 5.0
    dvx = (cnx - cx[:, None]) * sel
    dvy = (cny - cy[:, None]) * sel
    dvz = (cnz - cz[:, None]) * sel
    a00 = (dvx * dvx).sum(1) / 5.0
    a01 = (dvx * dvy).sum(1) / 5.0
    a02 = (dvx * dvz).sum(1) / 5.0
    a11 = (dvy * dvy).sum(1) / 5.0
    a12 = (dvy * dvz).sum(1) / 5.0
    a22 = (dvz * dvz).sum(1) / 5.0
    lam_max, lam_mid = _sym3_lam_max_mid(a00, a01, a02, a11, a12, a22)
    gate_line = lam_max > 3.0 * lam_mid

    # principal eigenvector: largest cross product of rows of (A - lam I)
    B00, B11, B22 = a00 - lam_max, a11 - lam_max, a22 - lam_max
    c01 = (a01 * a12 - a02 * B11, a02 * a01 - B00 * a12, B00 * B11 - a01 * a01)
    c02 = (a01 * B22 - a02 * a12, a02 * a02 - B00 * B22, B00 * a12 - a01 * a02)
    c12 = (B11 * B22 - a12 * a12, a12 * a02 - a01 * B22, a01 * a12 - B11 * a02)
    n01 = c01[0] * c01[0] + c01[1] * c01[1] + c01[2] * c01[2]
    n02 = c02[0] * c02[0] + c02[1] * c02[1] + c02[2] * c02[2]
    n12 = c12[0] * c12[0] + c12[1] * c12[1] + c12[2] * c12[2]
    use01 = (n01 >= n02) & (n01 >= n12)
    use02 = ~use01 & (n02 >= n12)
    v = [torch.where(use01, a, torch.where(use02, b, c))
         for a, b, c in zip(c01, c02, c12)]
    nrm = torch.sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])
    ok_v = nrm > 1e-20
    inv = torch.where(ok_v, 1.0 / torch.where(ok_v, nrm, 1.0), 0.0)
    vx = torch.where(ok_v, v[0] * inv, 1.0)
    vy = torch.where(ok_v, v[1] * inv, 0.0)
    vz = torch.where(ok_v, v[2] * inv, 0.0)

    # point-to-line distance + gradient (ref :1083-1120)
    x1, y1, z1 = cx + 0.1 * vx, cy + 0.1 * vy, cz + 0.1 * vz
    x2, y2, z2 = cx - 0.1 * vx, cy - 0.1 * vy, cz - 0.1 * vz
    d01x, d01y, d01z = xw - x1, yw - y1, zw - z1
    d02x, d02y, d02z = xw - x2, yw - y2, zw - z2
    crx = d01x * d02y - d02x * d01y
    cry = d01x * d02z - d02x * d01z
    crz = d01y * d02z - d02y * d01z
    a012 = torch.sqrt(crx * crx + cry * cry + crz * crz)
    d12x, d12y, d12z = x1 - x2, y1 - y2, z1 - z2
    l12 = torch.sqrt(d12x * d12x + d12y * d12y + d12z * d12z)
    denom = a012 * l12
    safe = torch.where(denom > 1e-12, denom, 1.0)
    la = (d12y * crx + d12z * cry) / safe
    lb = -(d12x * crx - d12z * crz) / safe
    lc = -(d12x * cry + d12y * crz) / safe
    ld2 = a012 / torch.where(l12 > 1e-12, l12, 1.0)
    s = 1.0 - 0.9 * torch.abs(ld2)
    maskf = gate_nn * gate_line * (s > 0.1) * (denom > 1e-12)
    return s * la * maskf, s * lb * maskf, s * lc * maskf, s * ld2 * maskf, \
        maskf


def _corr_surf(fm, cand, xw, yw, zw, K, min_plane_spread):
    """Surface point-to-plane coefficients (Householder least squares).
    Shapes as in _corr_corner."""
    snx, sny, snz = cand[:, 0], cand[:, 1], cand[:, 2]
    dx = snx - xw[:, None]
    dy = sny - yw[:, None]
    dz = snz - zw[:, None]
    sel, d5max = _select5(dx * dx + dy * dy + dz * dz, K)
    gate_nn = fm * (d5max < 1.0)

    # argmin ||A n + sel|| over the selected rows (A n = -1; zero rows are
    # no-ops), Householder on all K rows as the TPU kernel does
    rows = torch.arange(K, device=cand.device)[None, :, None]
    cols = [snx * sel, sny * sel, snz * sel]
    y = -sel
    for j in range(3):
        x = cols[j] * (rows >= j)
        normx = torch.sqrt((x * x).sum(1))
        pj = x[:, j]
        alpha = -torch.where(pj >= 0, 1.0, -1.0) * normx
        v = x - alpha[:, None] * (rows == j)
        vn2 = (v * v).sum(1)
        inv = torch.where(vn2 > 1e-30, 2.0 / torch.where(vn2 > 1e-30, vn2,
                                                          1.0), 0.0)
        for c_ in range(j, 3):
            coef = inv * (v * cols[c_]).sum(1)
            cols[c_] = cols[c_] - coef[:, None] * v
        coefy = inv * (v * y).sum(1)
        y = y - coefy[:, None] * v
    r00, r01, r02 = cols[0][:, 0], cols[1][:, 0], cols[2][:, 0]
    r11, r12, r22 = cols[1][:, 1], cols[2][:, 1], cols[2][:, 2]

    def _safe(dv):
        # pivot floor 1e-6: a degenerate R would send the solve to inf/NaN,
        # which survives the later mask multiply; such pivots fail the
        # determinant gate anyway
        return torch.where(torch.abs(dv) > 1e-6, dv,
                           torch.where(dv >= 0, 1e-6, -1e-6))

    n2 = y[:, 2] / _safe(r22)
    n1 = (y[:, 1] - r12 * n2) / _safe(r11)
    n0 = (y[:, 0] - r01 * n1 - r02 * n2) / _safe(r00)
    n0 = torch.clamp(n0, -1e6, 1e6)
    n1 = torch.clamp(n1, -1e6, 1e6)
    n2 = torch.clamp(n2, -1e6, 1e6)
    ok_det = torch.abs(r00 * r11 * r22) > 1e-5

    ps = torch.sqrt(n0 * n0 + n1 * n1 + n2 * n2)
    ps_ok = ps > 1e-12
    ps_safe = torch.where(ps_ok, ps, 1.0)
    pa, pb, pc, pd = n0 / ps_safe, n1 / ps_safe, n2 / ps_safe, 1.0 / ps_safe

    # all 5 selected neighbours within 0.2 m of the plane (ref :1182-1190)
    pres = torch.abs(pa[:, None] * snx + pb[:, None] * sny
                     + pc[:, None] * snz + pd[:, None])
    bad = torch.where(sel > 0, pres, -math.inf).amax(dim=1)
    plane_ok = (bad <= 0.2) & ok_det & ps_ok

    pd2 = pa * xw + pb * yw + pc * zw + pd
    sumsq = xw * xw + yw * yw + zw * zw
    s = 1.0 - 0.9 * torch.abs(pd2) / torch.sqrt(
        torch.sqrt(torch.clamp(sumsq, min=1e-12)))
    maskf = gate_nn * plane_ok * (s > 0.1)
    if min_plane_spread > 0.0:
        # middle singular value of the 5-NN scatter (exactly 5 picked)
        mx = (snx * sel).sum(1) / 5.0
        my = (sny * sel).sum(1) / 5.0
        mz = (snz * sel).sum(1) / 5.0
        cdx = (snx - mx[:, None]) * sel
        cdy = (sny - my[:, None]) * sel
        cdz = (snz - mz[:, None]) * sel
        _, lam_mid = _sym3_lam_max_mid(
            (cdx * cdx).sum(1) / 5.0, (cdx * cdy).sum(1) / 5.0,
            (cdx * cdz).sum(1) / 5.0, (cdy * cdy).sum(1) / 5.0,
            (cdy * cdz).sum(1) / 5.0, (cdz * cdz).sum(1) / 5.0)
        maskf = maskf * (torch.sqrt(torch.clamp(lam_mid, min=0.0))
                         >= min_plane_spread)
    return s * pa * maskf, s * pb * maskf, s * pc * maskf, s * pd2 * maskf, \
        maskf


def jacobi6(A, sweeps: int = 6):
    """Cyclic Jacobi on a batch of symmetric 6x6 matrices [B,6,6].

    Returns (eigvals [B,6], V [B,6,6]) with A = V diag(w) V^T (columns of V
    are eigenvectors).  The rotation order and arithmetic are the TPU
    kernel's `_jacobi6`, which `csrc/gn_round.cu` repeats per lane."""
    A = A.clone()
    V = torch.eye(6, dtype=A.dtype, device=A.device).expand_as(A).clone()
    for _ in range(sweeps):
        for p in range(6):
            for q in range(p + 1, 6):
                apq, app, aqq = A[:, p, q], A[:, p, p], A[:, q, q]
                small = torch.abs(apq) < 1e-20
                apq_s = torch.where(small, 1.0, apq)
                tau = (aqq - app) / (2.0 * apq_s)
                t = torch.sign(tau) / (torch.abs(tau)
                                       + torch.sqrt(1.0 + tau * tau))
                t = torch.where(tau == 0.0, 1.0, t)
                t = torch.where(small, 0.0, t)
                c = (1.0 / torch.sqrt(1.0 + t * t))[:, None]
                s = t[:, None] * c
                for M in (A, V):          # columns p, q
                    mp, mq = M[:, :, p].clone(), M[:, :, q].clone()
                    M[:, :, p] = c * mp - s * mq
                    M[:, :, q] = s * mp + c * mq
                ap, aq = A[:, p, :].clone(), A[:, q, :].clone()  # rows p, q
                A[:, p, :] = c * ap - s * aq
                A[:, q, :] = s * ap + c * aq
    return torch.diagonal(A, dim1=1, dim2=2), V


def gn_round_reference(stat, matP, featc, feats, candc, cands, *, K: int,
                       iters: int, min_corr: int = 50,
                       eig_thresh: float = 100.0, conv_rot_deg: float = 0.05,
                       conv_trans_cm: float = 0.05, jacobi_sweeps: int = 6,
                       min_plane_spread: float = 0.0):
    """Plain PyTorch version of the GN round, batched over lanes.

    A lane's stat and matP change only while it is active
    (converged == 0 and gate > 0), which reproduces the kernel's per-lane
    early exit.  Same arguments and result as `gn_round`."""
    B, Pc, Ps = _check(stat, matP, featc, feats, candc, cands, K)
    stat = stat.clone()
    matP = matP.clone()
    cc = candc.view(3, K, B, Pc).permute(2, 0, 1, 3)       # [B,3,K,Pc]
    cs = cands.view(3, K, B, Ps).permute(2, 0, 1, 3)
    f = torch.cat([featc, feats], dim=2)                   # [B,4,Pc+Ps]
    eye = torch.eye(6, dtype=stat.dtype, device=stat.device)
    deg2 = (180.0 / _PI) ** 2

    for _ in range(iters):
        active = (stat[:, 7] == 0.0) & (stat[:, 9] > 0.0)
        if not bool(active.any()):
            break
        pose = stat[:, 0:6]
        sr, cr = torch.sin(pose[:, 0]), torch.cos(pose[:, 0])
        sp, cp = torch.sin(pose[:, 1]), torch.cos(pose[:, 1])
        sy, cy = torch.sin(pose[:, 2]), torch.cos(pose[:, 2])
        R = ((cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr),
             (sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr),
             (-sp, cp * sr, cp * cr))
        zero = torch.zeros_like(sr)
        dRr = ((zero, cy * sp * cr + sy * sr, -cy * sp * sr + sy * cr),
               (zero, sy * sp * cr - cy * sr, -sy * sp * sr - cy * cr),
               (zero, cp * cr, -cp * sr))
        dRp = ((-cy * sp, cy * cp * sr, cy * cp * cr),
               (-sy * sp, sy * cp * sr, sy * cp * cr),
               (-cp, -sp * sr, -sp * cr))
        dRy = ((-sy * cp, -sy * sp * sr - cy * cr, -sy * sp * cr + cy * sr),
               (cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr),
               (zero, zero, zero))

        fx, fy, fz = f[:, 0], f[:, 1], f[:, 2]
        xw, yw, zw = [R[i][0][:, None] * fx + R[i][1][:, None] * fy
                      + R[i][2][:, None] * fz + pose[:, 3 + i, None]
                      for i in range(3)]
        corner = _corr_corner(featc[:, 3], cc, xw[:, :Pc], yw[:, :Pc],
                              zw[:, :Pc], K)
        surf = _corr_surf(feats[:, 3], cs, xw[:, Pc:], yw[:, Pc:],
                          zw[:, Pc:], K, min_plane_spread)
        ca, cb, ccf, resid, mask = [torch.cat([a, b], 1)
                                    for a, b in zip(corner, surf)]

        def rotdot(dR):
            g = [dR[i][0][:, None] * fx + dR[i][1][:, None] * fy
                 + dR[i][2][:, None] * fz for i in range(3)]
            return ca * g[0] + cb * g[1] + ccf * g[2]

        J = torch.stack([rotdot(dRr), rotdot(dRp), rotdot(dRy), ca, cb, ccf,
                         -resid, mask], dim=1)             # [B,8,P]
        G = torch.bmm(J, J.transpose(1, 2))                # [B,8,8]
        n_corr = G[:, 7, 7]
        enough = n_corr >= float(min_corr)

        # iteration-0 degeneracy analysis (ref :1346-1377)
        first = active & (stat[:, 6] == 0.0)
        if bool(first.any()):
            U = torch.triu(G[:, :6, :6])      # the kernel reads i <= j
            w, V = jacobi6(U + torch.triu(U, 1).transpose(1, 2),
                           sweeps=jacobi_sweeps)
            good = (w >= eig_thresh).to(stat.dtype)
            isdeg = (1.0 - good).amax(dim=1)
            P = torch.zeros(B, 6, 6, dtype=stat.dtype, device=stat.device)
            for k in range(6):
                P = P + (V[:, :, k] * good[:, k, None])[:, :, None] \
                    * V[:, None, :, k]
            matP = torch.where(first[:, None], P.reshape(B, 36), matP)
            stat[:, 8] = torch.where(first, isdeg, stat[:, 8])

        # (JtJ + 1e-2 I) x = Jtb by Gauss-Jordan without pivoting (SPD +
        # Tikhonov shift keeps every pivot >= 1e-2)
        A = torch.cat([G[:, :6, :6] + 1e-2 * eye, G[:, :6, 6:7]], dim=2)
        for j in range(6):
            factor = A[:, :, j] / A[:, j, j, None]
            factor[:, j] = 0.0
            A = A - factor[:, :, None] * A[:, j, None, :]
        x = A[:, :, 6] / torch.diagonal(A[:, :, :6], dim1=1, dim2=2)
        x_proj = torch.bmm(matP.view(B, 6, 6), x[:, :, None])[:, :, 0]
        x = torch.where(stat[:, 8, None] > 0.0, x_proj, x)

        x2 = x * x
        d_r = torch.sqrt(x2[:, 0:3].sum(1) * deg2)
        d_t = torch.sqrt(x2[:, 3:6].sum(1) * 1.0e4)
        conv = enough & (d_r < conv_rot_deg) & (d_t < conv_trans_cm)

        new = stat.clone()
        new[:, 0:6] = pose + enough.to(stat.dtype)[:, None] * x
        new[:, 6] = stat[:, 6] + 1.0
        new[:, 7] = conv.to(stat.dtype)
        new[:, 10] = n_corr
        stat = torch.where(active[:, None], new, stat)
    return stat, matP


def gn_round(stat, matP, featc, feats, candc, cands, *, K: int, iters: int,
             min_corr: int = 50, eig_thresh: float = 100.0,
             conv_rot_deg: float = 0.05, conv_trans_cm: float = 0.05,
             jacobi_sweeps: int = 6, min_plane_spread: float = 0.0):
    """Run one solve round (up to `iters` GN iterations) for every lane.

    stat [B,16], matP [B,36] (see STAT slots); featc [B,4,Pc] / feats
    [B,4,Ps] feature planes (x, y, z, mask rows); candc [3K, B*Pc] / cands
    [3K, B*Ps] candidate planes from `block_fetch(planes_out=True)`: lane b's
    block is the column slice [:, b*P:(b+1)*P].  Returns (stat', matP').

    CPU tensors run the plain version; CUDA tensors launch the kernel.
    """
    args = dict(K=K, iters=iters, min_corr=min_corr, eig_thresh=eig_thresh,
                conv_rot_deg=conv_rot_deg, conv_trans_cm=conv_trans_cm,
                jacobi_sweeps=jacobi_sweeps,
                min_plane_spread=min_plane_spread)
    _check(stat, matP, featc, feats, candc, cands, K)
    if stat.device.type == "cpu":
        return gn_round_reference(stat, matP, featc, feats, candc, cands,
                                  **args)
    if stat.device.type != "cuda":
        raise ValueError(f"unsupported device {stat.device}")
    stat = stat.clone()
    matP = matP.clone()
    kernels.launch_gn_round(stat, matP, featc, feats, candc, cands, **args)
    gn_round.launches += 1
    return stat, matP


gn_round.launches = 0
