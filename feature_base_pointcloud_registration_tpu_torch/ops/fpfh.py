"""FPFH descriptors + normal estimation, fully vectorized.

Port of the JAX package's `ops/fpfh.py`.  The BASELINE north-star asks for
FPFH-style descriptor histograms as a vectorized binning kernel for the
KITTI coarse-init config (descriptor matching + RANSAC, then ICP
refinement).  The reference itself has no descriptors — this extends the
capability surface the way PCL users pair FPFH+SAC-IA with ICP.

Implementation (Rusu et al., ICRA 2009), fixed-K neighborhoods:
  1. normals: smallest eigenvector of the K-NN covariance (closed-form 3x3),
     oriented toward the viewpoint,
  2. SPFH: Darboux-frame angles (alpha, phi, theta) against each neighbor,
     binned into 3 x 11 histograms via one-hot sums,
  3. FPFH: SPFH(p) + mean_k SPFH(neighbor_k)/dist_k.

Everything is [N, K]-shaped masked math on the points' device; the only
searches are the streamed k-NN of `ops/knn.py` (one `csrc/knn_stream.cu`
launch a search on the card).  The JAX package computes all of it outside
any Pallas kernel; the rest is PyTorch ops in the port.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .eig3 import eigvals_sym3, principal_eigvec_sym3
from .knn import knn

N_BINS = 11


def estimate_normals(pts, mask, k: int = 16, chunk: int = 2048,
                     viewpoint=None):
    """Per-point unit normals from K-NN covariance; oriented to viewpoint.

    pts [N, 3], mask [N] (N a multiple of `chunk`).  Returns (normals
    [N, 3], valid [N])."""
    d2, idx = knn(pts, pts, mask, k=k, chunk=chunk)
    return _normals(pts, mask, d2, idx.long(), viewpoint)


def _normals(pts, mask, d2, idx, viewpoint):
    """estimate_normals on the K-NN (d2, idx [N, K]) of pts in itself."""
    nn = pts[idx]                                          # [N,K,3]
    nn_valid = d2 < 1e37
    w = nn_valid.to(pts.dtype)
    cnt = torch.clamp(w.sum(-1), min=1.0)
    c = (nn * w[..., None]).sum(1) / cnt[:, None]
    dev = (nn - c[:, None, :]) * w[..., None]
    cov = torch.einsum("nki,nkj->nij", dev, dev) / cnt[:, None, None]
    # smallest eigenvector = normal: use principal of (trace*I - cov)
    tr = cov[:, 0, 0] + cov[:, 1, 1] + cov[:, 2, 2]
    eye = torch.eye(3, dtype=pts.dtype, device=pts.device)
    flipped = tr[:, None, None] * eye - cov
    n = principal_eigvec_sym3(flipped, eigvals_sym3(flipped)[:, 2])
    vp = (torch.zeros(3, dtype=pts.dtype, device=pts.device)
          if viewpoint is None
          else torch.as_tensor(viewpoint, dtype=pts.dtype, device=pts.device))
    to_vp = vp[None, :] - pts
    sign = torch.where((n * to_vp).sum(-1, keepdim=True) < 0, -1.0, 1.0)
    n = n * sign
    valid = mask & (nn_valid.sum(-1) >= 3)
    return n, valid


def _pair_features(p, n_p, q, n_q):
    """Darboux angles (alpha, phi, theta) for point pairs.

    p, n_p: [N,3]; q, n_q: [N,K,3].  Returns three [N,K] tensors + dist."""
    d = q - p[:, None, :]
    dist = torch.linalg.norm(d, dim=-1)
    safe = torch.where(dist > 1e-9, dist, 1.0)
    du = d / safe[..., None]

    u = n_p[:, None, :].expand_as(du)                   # [N,K,3]
    v = torch.linalg.cross(du, u)
    v_n = torch.linalg.norm(v, dim=-1, keepdim=True)
    v = v / torch.where(v_n > 1e-9, v_n, 1.0)
    w = torch.linalg.cross(u, v)

    alpha = (v * n_q).sum(-1)                           # in [-1,1]
    phi = (u * du).sum(-1)                              # in [-1,1]
    theta = torch.atan2((w * n_q).sum(-1), (u * n_q).sum(-1))
    return alpha, phi, theta, dist


def _hist(vals, lo, hi, weights):
    """Masked histogram into N_BINS bins over [lo, hi] -> [N, N_BINS]: the
    bin is the truncated (v - lo) / (hi - lo) * N_BINS, clipped."""
    b = torch.clamp(((vals - lo) / (hi - lo) * N_BINS).to(torch.int32),
                    0, N_BINS - 1)
    oh = F.one_hot(b.long(), N_BINS).to(vals.dtype)      # [N,K,B]
    return (oh * weights[..., None]).sum(1)


def fpfh(pts, mask, k: int = 16, chunk: int = 2048):
    """FPFH descriptors of pts [N, 3] (mask [N], N a multiple of `chunk`)
    on their device.  Returns (desc [N,33], valid [N])."""
    # one search serves the normals and the pair features (the JAX package
    # runs the same search twice, under one jit)
    d2, idx = knn(pts, pts, mask, k=k, chunk=chunk)
    idx = idx.long()
    normals, n_valid = _normals(pts, mask, d2, idx, None)
    nn = pts[idx]
    nn_n = normals[idx]
    nn_valid = (d2 < 1e37) & n_valid[idx]
    w = nn_valid.to(pts.dtype)

    alpha, phi, theta, dist = _pair_features(pts, normals, nn, nn_n)
    spfh = torch.cat([
        _hist(alpha, -1.0, 1.0, w),
        _hist(phi, -1.0, 1.0, w),
        _hist(theta, -math.pi, math.pi, w),
    ], dim=-1)                                                 # [N,33]
    cnt = torch.clamp(w.sum(-1, keepdim=True), min=1.0)
    spfh = spfh / cnt                                          # normalize

    # FPFH = SPFH(p) + mean_k SPFH(q_k) / dist_k
    inv_d = torch.where(dist > 1e-9, 1.0 / dist, 0.0) * w
    nb = spfh[idx]                                             # [N,K,33]
    acc = (nb * inv_d[..., None]).sum(1) / torch.clamp(
        inv_d.sum(-1, keepdim=True), min=1e-9)
    desc = spfh + acc
    norm = torch.linalg.norm(desc, dim=-1, keepdim=True)
    desc = desc / torch.where(norm > 1e-9, norm, 1.0)
    valid = n_valid & mask
    return torch.where(valid[:, None], desc, 0.0), valid


def match_descriptors(src_desc, src_valid, dst_desc, dst_valid):
    """Nearest-descriptor match src -> dst: one [Ns, Nd] similarity product
    (`torch.matmul`, TF32 off: see device.py), the first maximum per row.

    Returns (idx [Ns] int32 into dst, sim [Ns] cosine-like score)."""
    sim = torch.matmul(src_desc, dst_desc.T)
    sim = torch.where(dst_valid[None, :], sim, -math.inf)
    idx = sim.argmax(1)
    best = torch.gather(sim, 1, idx[:, None])[:, 0]
    best = torch.where(src_valid, best, -math.inf)
    return idx.to(torch.int32), best
