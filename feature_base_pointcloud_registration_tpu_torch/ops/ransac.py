"""RANSAC rigid alignment from descriptor correspondences (SAC-IA style).

Port of the JAX package's `ops/ransac.py`.  Coarse initialization for
registration without a pose prior (BASELINE config 3: FPFH matching +
RANSAC, then ICP refinement): sample [H, 3] correspondence triplets, solve
H Kabsch problems batched, score all H transforms against all N matches at
once, pick the argmax.  No loops, no early exit: H is the budget.

The sampling takes an explicit `torch.Generator` (on the device of the
correspondences) where JAX takes a PRNG key; the two streams differ, so
sampling and scoring are separate functions (`sample_triplets`,
`ransac_from_samples`) and the scoring can be fed any triplets.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geom.se3 import kabsch


class RansacResult(NamedTuple):
    transform: torch.Tensor     # f32 [4,4] src -> dst
    inliers: torch.Tensor       # i32 [] inlier count of the winner
    inlier_ratio: torch.Tensor  # f32 []


def sample_triplets(generator: torch.Generator, corr_valid,
                    num_hypotheses: int):
    """[H, 3] int64 correspondence indices, drawn with replacement,
    uniformly over the valid correspondences — and uniformly over all of
    them when none is valid (the JAX package's categorical over logits 0 /
    -1e9 does the same; `torch.multinomial` would raise on zero weights).
    The generator must live on corr_valid's device."""
    valid = corr_valid.to(torch.float32)
    weights = torch.where(corr_valid.any(), valid, torch.ones_like(valid))
    return torch.multinomial(weights, num_hypotheses * 3, replacement=True,
                             generator=generator).reshape(num_hypotheses, 3)


def score_hypotheses(samples, src_pts, dst_pts, corr_valid, *,
                     inlier_threshold: float = 0.5):
    """The H hypotheses of `samples` [H, 3]: (their transforms [H, 4, 4]
    from a Kabsch solve of each triplet, their inlier masks [H, N] — valid
    correspondences within the threshold after the transform)."""
    samples = samples.long()
    T = kabsch(src_pts[samples], dst_pts[samples])        # [H,4,4]
    src_t = (torch.einsum("hij,nj->hni", T[:, :3, :3], src_pts)
             + T[:, None, :3, 3])
    d2 = ((src_t - dst_pts[None]) ** 2).sum(-1)           # [H,N]
    return T, (d2 < inlier_threshold ** 2) & corr_valid[None, :]


def ransac_from_samples(samples, src_pts, dst_pts, corr_valid, *,
                        inlier_threshold: float = 0.5) -> RansacResult:
    """Score the hypotheses of `samples` [H, 3] and refine the winner.

    src_pts [N,3] <-> dst_pts [N,3] (row-aligned matches, e.g. from
    match_descriptors); corr_valid [N] masks bad matches.  A hypothesis
    whose triplet is degenerate (a repeated index, collinear points) may
    get any rotation, or NaN, from the SVD; it then counts few or no
    inliers (a NaN distance is never below the threshold), and the winner's
    weighted refit over all its inliers is well-posed."""
    thr2 = inlier_threshold ** 2
    _, inlier = score_hypotheses(samples, src_pts, dst_pts, corr_valid,
                                 inlier_threshold=inlier_threshold)
    best = inlier.sum(1).argmax()

    # refine the winner with all its inliers (one weighted Kabsch)
    w = inlier[best].to(torch.float32)
    T_ref = kabsch(src_pts, dst_pts, weights=w)
    src_r = src_pts @ T_ref[:3, :3].T + T_ref[:3, 3]
    d2r = ((src_r - dst_pts) ** 2).sum(-1)
    inl_r = ((d2r < thr2) & corr_valid).sum()
    n_valid = torch.clamp(corr_valid.sum(), min=1)
    return RansacResult(
        transform=T_ref,
        inliers=inl_r.to(torch.int32),
        inlier_ratio=inl_r.to(torch.float32) / n_valid,
    )


def ransac_align(generator: torch.Generator, src_pts, dst_pts, corr_valid, *,
                 num_hypotheses: int = 512,
                 inlier_threshold: float = 0.5) -> RansacResult:
    """Estimate the rigid transform from putative correspondences:
    `sample_triplets` then `ransac_from_samples`."""
    samples = sample_triplets(generator, corr_valid, num_hypotheses)
    return ransac_from_samples(samples, src_pts, dst_pts, corr_valid,
                               inlier_threshold=inlier_threshold)


def coarse_align_fpfh(generator: torch.Generator, src_pts, src_mask,
                      dst_pts, dst_mask, *, k: int = 16, chunk: int = 2048,
                      num_hypotheses: int = 512,
                      inlier_threshold: float = 0.5) -> RansacResult:
    """FPFH match + RANSAC in one call (feeds icp_align for refinement)."""
    from .fpfh import fpfh, match_descriptors

    sd, sv = fpfh(src_pts, src_mask, k=k, chunk=chunk)
    dd, dv = fpfh(dst_pts, dst_mask, k=k, chunk=chunk)
    midx, sim = match_descriptors(sd, sv, dd, dv)
    corr_valid = sv & (sim > -torch.inf)
    return ransac_align(generator, src_pts, dst_pts[midx.long()], corr_valid,
                        num_hypotheses=num_hypotheses,
                        inlier_threshold=inlier_threshold)
