"""Point-to-point ICP — the loop-closure aligner.

Port of the JAX package's `ops/icp.py`, the replacement for
pcl::IterativeClosestPoint as the reference configures it (ref:
src/mapOptmization.h:689-711): max correspondence distance 100 m, <= 100
iterations, transformation epsilon 1e-6, fitness = mean squared distance of
the matched points (accepted below 0.3, ref :715).

Each iteration: masked 1-NN of the transformed source in the target through
the streamed search of `ops/knn.py`, then a weighted Kabsch/SVD update of
the ORIGINAL source onto the matched targets.  The JAX package compiles the
loop as one `lax.while_loop`.  `icp_align` dispatches by device: CPU
tensors run `icp_align_reference`, the plain version, a Python loop that
asks the host once an iteration whether to go on; CUDA tensors launch
`csrc/icp.cu`, one persistent cooperative kernel that runs every iteration,
the final fitness pass and the stopping test on the device with no host
read, or raise.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import kernels
from ..geom.se3 import apply_transform, kabsch
from .knn import knn_reference


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
    of `chunk`) on their device; returns the final transform and fitness.
    CPU tensors run `icp_align_reference`; CUDA tensors launch `fbpr_icp`
    (one launch a run), or raise."""
    dev = src.device
    if dev.type == "cpu":
        return icp_align_reference(
            src, src_mask, dst, dst_mask, max_corr_dist=max_corr_dist,
            max_iterations=max_iterations,
            transformation_epsilon=transformation_epsilon, chunk=chunk)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    check_kernel_args(src, src_mask, dst, dst_mask, chunk, max_iterations)

    def e(dtype, *shape):
        return torch.empty(shape, dtype=dtype, device=dev)

    out = ICPResult(transform=e(torch.float32, 4, 4),
                    fitness=e(torch.float32), converged=e(torch.bool),
                    iterations=e(torch.int32), delta=e(torch.float32))
    kernels.launch_icp(
        src.contiguous(), src_mask.contiguous(), dst.contiguous(),
        dst_mask.contiguous(), (out.transform, out.fitness, out.converged,
                                out.iterations, out.delta),
        chunk=chunk, max_d2=float(max_corr_dist) ** 2,
        max_iterations=int(max_iterations),
        eps=float(transformation_epsilon))
    _COUNTED.launches += 1
    return out


icp_align.launches = 0
# the counter's owner, whatever a caller rebinds `icp_align` to (a timing
# wrapper, a recorder)
_COUNTED = icp_align


def check_kernel_args(src, src_mask, dst, dst_mask, chunk: int,
                      max_iterations: int):
    """Raise ValueError where `fbpr_icp` does not take a run: M not a
    multiple of chunk, shapes other than src [N, 3], src_mask [N], dst
    [M, 3], dst_mask [M] with N, M >= 1, dtypes other than float32 points
    and bool masks, inputs on different devices, max_iterations < 0."""
    if dst.dim() == 2 and dst.shape[0] % chunk:
        raise ValueError(f"map capacity {dst.shape[0]} not a multiple of "
                         f"chunk {chunk}")
    if src.dim() != 2 or src.shape[1] != 3 or dst.dim() != 2 \
            or dst.shape[1] != 3 or src_mask.shape != src.shape[:1] \
            or dst_mask.shape != dst.shape[:1] or src.shape[0] < 1 \
            or dst.shape[0] < 1:
        raise ValueError(f"icp_align: src {tuple(src.shape)}, src_mask "
                         f"{tuple(src_mask.shape)}, dst {tuple(dst.shape)}, "
                         f"dst_mask {tuple(dst_mask.shape)}")
    if src.dtype != torch.float32 or dst.dtype != torch.float32 \
            or src_mask.dtype != torch.bool or dst_mask.dtype != torch.bool:
        raise ValueError("icp_align: float32 points and bool masks")
    if any(t.device != src.device for t in (src_mask, dst, dst_mask)):
        raise ValueError("icp_align: inputs on different devices")
    if max_iterations < 0:
        raise ValueError(f"max_iterations {max_iterations} < 0")


def icp_align_reference(src, src_mask, dst, dst_mask, *,
                        max_corr_dist: float = 100.0,
                        max_iterations: int = 100,
                        transformation_epsilon: float = 1e-6,
                        chunk: int = 2048) -> ICPResult:
    """The plain version of `icp_align` (the port's loop before the
    kernel), on any device: the streamed 1-NN of `knn_reference` and
    `kabsch` an iteration, the transform change read on the host."""
    max_d2 = max_corr_dist ** 2

    def matched(T):
        """(d2 [N], nearest target [N, 3], weight [N]) at transform T."""
        d2, idx = knn_reference(apply_transform(T, src), dst, dst_mask,
                                k=1, chunk=chunk)
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
