"""Point-to-point ICP — the loop-closure aligner.

Port of the JAX package's `ops/icp.py`, the replacement for
pcl::IterativeClosestPoint as the reference configures it (ref:
src/mapOptmization.h:689-711): max correspondence distance 100 m, <= 100
iterations, transformation epsilon 1e-6, fitness = mean squared distance of
the matched points (accepted below 0.3, ref :715).

Each iteration: masked 1-NN of the transformed source in the target through
the streamed search of `ops/knn.py`, then a weighted Kabsch/SVD update of
the ORIGINAL source onto the matched targets.  The JAX while-loop becomes a
Python loop that asks the host once an iteration whether to go on.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geom.se3 import apply_transform, kabsch
from .knn import knn


class ICPResult(NamedTuple):
    transform: torch.Tensor   # f32 [4, 4] source -> target
    fitness: torch.Tensor     # f32 [] mean squared matched distance
    converged: torch.Tensor   # bool [] PCL hasConverged(): terminated by ANY
    #                           criterion (max-iterations too) with >= 3 matches
    iterations: torch.Tensor  # i32 []
    delta: torch.Tensor       # f32 [] last transform change (epsilon test)


def icp_align(src, src_mask, dst, dst_mask, *, max_corr_dist: float = 100.0,
              max_iterations: int = 100,
              transformation_epsilon: float = 1e-6,
              chunk: int = 2048) -> ICPResult:
    """Align src [N, 3] (mask [N]) onto dst [M, 3] (mask [M], M a multiple
    of `chunk`) on their device; returns the final transform and fitness."""
    max_d2 = max_corr_dist ** 2

    def matched(T):
        """(d2 [N], nearest target [N, 3], weight [N]) at transform T."""
        d2, idx = knn(apply_transform(T, src), dst, dst_mask, k=1,
                      chunk=chunk)
        d2 = d2[:, 0]
        w = (src_mask & (d2 < max_d2)).to(torch.float32)
        return d2, dst[idx[:, 0].long()], w

    T = torch.eye(4, dtype=torch.float32, device=src.device)
    delta = torch.tensor(1e9, dtype=torch.float32, device=src.device)
    it = 0
    while it < max_iterations and float(delta) > transformation_epsilon:
        _, nn_pts, w = matched(T)
        T_new = kabsch(src, nn_pts, weights=w)
        delta = (T_new - T).abs().max()
        T = T_new
        it += 1

    # the fitness at the final transform
    d2, _, w = matched(T)
    n_match = w.sum()
    fitness = (d2 * w).sum() / torch.clamp(n_match, min=1.0)
    # PCL hasConverged() is true on ANY termination criterion, including the
    # iteration budget (ref usage src/mapOptmization.h:715 gates only on
    # hasConverged + fitness); it is false only when correspondence
    # estimation fails (< 3 matches).  `delta` keeps the epsilon criterion.
    return ICPResult(transform=T, fitness=fitness, converged=n_match >= 3.0,
                     iterations=torch.tensor(it, dtype=torch.int32,
                                             device=src.device),
                     delta=delta)
