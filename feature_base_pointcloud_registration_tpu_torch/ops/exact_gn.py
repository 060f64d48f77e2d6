"""The exact solver's whole GN loop in one launch.

The JAX package's `register_scan` runs its Gauss-Newton iterations as one
device loop (`register_core`'s `lax.while_loop`), each iteration streaming
the whole map through the exact 5-NN.  The port's
`ops/register.py::register_scan` runs them through `exact_gn`:

  * on CUDA tensors it launches the kernel `csrc/exact_gn.cu` (a cluster
    of C CTAs a lane, C from the shapes by `kernels.exact_gn_cluster`; up
    to `iters` iterations each with the lane's own early exit, the exact
    5-NN, the fits and the solve inside; no host sync);
  * on CPU tensors it runs `exact_gn_reference`, the port's loop
    (`ops/register.py::register_core` on `ops/knn.py`'s exact 5-NN: one
    host check an iteration), its result packed into the kernel's layout.

The kernel computes what the loop computes: the world points, the exact
5-NN of each live feature among its kind's live map points (on
coordinates centred on the query set's centroid, ties to the lower index),
the line and plane fits with their gates, J^T J and J^T b, the
eigen-decomposition of J^T J on every iteration (a converged cyclic Jacobi
where the loop calls `torch.linalg.eigh`), the degeneracy projector at the
lane's iteration 0, the update and the convergence test.  Its query
centroid sums in the order of ATen's CUDA `mean`, so its d2 at a pose are
the loop's on the card bit for bit; it is not bitwise the loop past the
5-NN: its fits and the 28 sums round in another order, and its
eigenvectors are not eigh's (x and the projector do not depend on their
order or signs).

Layouts: pose6 [B, 6]; features: ScanFeatures [B, ...] (xyz [B, P, 3]
float32, masks [B, P] bool); local_map: FeatureMap, one map for every lane
([M, 3], [M]) or one a lane ([B, M, 3], [B, M]), corner and surf each, M
a multiple of `chunk`; the result stat [B, 16] with `ops/gn_round.py`'s
STAT slots ([0:6] pose6, [6] iterations, [7] converged, [8]
is_degenerate, [9] feature gate, [10] n_corr, the rest 0).
"""

from __future__ import annotations

import torch

from .. import kernels
from .gn_round import STAT
from .knn import make_local_knn


def pack(res) -> torch.Tensor:
    """A RegisterResult as stat [B, 16] (float32: iteration and
    correspondence counts are exact up to 2^24)."""
    B = res.pose6.shape[0]
    stat = torch.zeros(B, STAT, dtype=torch.float32, device=res.pose6.device)
    stat[:, 0:6] = res.pose6
    stat[:, 6] = res.iterations.to(torch.float32)
    stat[:, 7] = res.converged.to(torch.float32)
    stat[:, 8] = res.is_degenerate.to(torch.float32)
    stat[:, 9] = res.valid.to(torch.float32)
    stat[:, 10] = res.n_corr.to(torch.float32)
    return stat


def _check(pose6, features, local_map, chunk: int):
    """Raise ValueError where neither route takes a call: shapes other than
    the module docstring's, empty feature or map sets, a map capacity that
    is not a multiple of chunk, dtypes other than float32 points and bool
    masks, tensors on different devices."""
    cx, cm = features.corner_xyz, features.corner_mask
    sx, sm = features.surf_xyz, features.surf_mask
    if cx.dim() != 3 or cx.shape[-1] != 3 or sx.dim() != 3 \
            or sx.shape[-1] != 3 or sx.shape[0] != cx.shape[0] \
            or cm.shape != cx.shape[:2] or sm.shape != sx.shape[:2] \
            or cx.shape[1] < 1 or sx.shape[1] < 1:
        raise ValueError(f"exact_gn: features corner {tuple(cx.shape)} / "
                         f"{tuple(cm.shape)}, surf {tuple(sx.shape)} / "
                         f"{tuple(sm.shape)}")
    B = cx.shape[0]
    if tuple(pose6.shape) != (B, 6):
        raise ValueError(f"exact_gn: pose6 must be {(B, 6)}, got "
                         f"{tuple(pose6.shape)}")
    for kind, ref, msk in (("corner", local_map.corner_xyz,
                            local_map.corner_mask),
                           ("surf", local_map.surf_xyz, local_map.surf_mask)):
        if ref.dim() not in (2, 3) or ref.shape[-1] != 3 \
                or ref.shape[:-2] not in ((), (B,)) \
                or msk.shape != ref.shape[:-1] or ref.shape[-2] < 1:
            raise ValueError(f"exact_gn: {kind} map {tuple(ref.shape)}, "
                             f"mask {tuple(msk.shape)}")
        if ref.shape[-2] % chunk:
            raise ValueError(f"map capacity {ref.shape[-2]} not a multiple "
                             f"of chunk {chunk}")
    points = (pose6, cx, sx, local_map.corner_xyz, local_map.surf_xyz)
    masks = (cm, sm, local_map.corner_mask, local_map.surf_mask)
    if any(t.dtype != torch.float32 for t in points) \
            or any(t.dtype != torch.bool for t in masks):
        raise ValueError("exact_gn: points and poses must be float32, masks "
                         "bool")
    if any(t.device != pose6.device for t in points + masks):
        raise ValueError("exact_gn: inputs on different devices")


def exact_gn_reference(pose6, features, local_map, *, iters: int,
                       min_corr: int = 50, eig_thresh: float = 100.0,
                       edge_min_valid: int = 10, surf_min_valid: int = 100,
                       chunk: int = 4096, conv_rot_deg: float = 0.05,
                       conv_trans_cm: float = 0.05) -> torch.Tensor:
    """Plain PyTorch version of the solve: `register_core` on the exact
    5-NN of `ops/knn.py` (the kernel `knn_stream.cu` on CUDA tensors),
    packed.  Same arguments and result as `exact_gn`."""
    from .register import register_core  # register imports this module

    _check(pose6, features, local_map, chunk)
    return pack(register_core(
        features,
        make_local_knn(local_map.corner_xyz, local_map.corner_mask, chunk),
        make_local_knn(local_map.surf_xyz, local_map.surf_mask, chunk),
        pose6, max_iterations=iters, min_correspondences=min_corr,
        eigen_threshold=eig_thresh, edge_min_valid=edge_min_valid,
        surf_min_valid=surf_min_valid, converge_rot_deg=conv_rot_deg,
        converge_trans_cm=conv_trans_cm))


def exact_gn(pose6, features, local_map, *, iters: int, min_corr: int = 50,
             eig_thresh: float = 100.0, edge_min_valid: int = 10,
             surf_min_valid: int = 100, chunk: int = 4096,
             conv_rot_deg: float = 0.05, conv_trans_cm: float = 0.05,
             cluster: int | None = None) -> torch.Tensor:
    """Run `register_scan`'s solve for every lane from pose6 (the module
    docstring's layouts): up to `iters` GN iterations each.  Returns stat
    [B, 16].

    CPU tensors run the plain version; CUDA tensors launch the kernel, or
    raise; any other device raises.  cluster: the kernel's CTAs a lane (a
    power of two up to kernels.ROUNDS_MAX_CLUSTER, checked on every
    device), for measurements and tests; by default the kernel's rule
    picks it from the shapes."""
    args = dict(iters=iters, min_corr=min_corr, eig_thresh=eig_thresh,
                edge_min_valid=edge_min_valid, surf_min_valid=surf_min_valid,
                chunk=chunk, conv_rot_deg=conv_rot_deg,
                conv_trans_cm=conv_trans_cm)
    _check(pose6, features, local_map, chunk)
    if cluster is not None:
        kernels.check_cluster(cluster)
    if pose6.device.type == "cpu":
        return exact_gn_reference(pose6, features, local_map, **args)
    if pose6.device.type != "cuda":
        raise ValueError(f"unsupported device {pose6.device}")
    del args["chunk"]
    stat = torch.empty(pose6.shape[0], STAT, dtype=torch.float32,
                       device=pose6.device)
    kernels.launch_exact_gn(
        pose6.contiguous(), type(features)(*(t.contiguous()
                                             for t in features)),
        type(local_map)(*(t.contiguous() for t in local_map)), stat,
        cluster=cluster, **args)
    exact_gn.launches += 1
    return stat


exact_gn.launches = 0
