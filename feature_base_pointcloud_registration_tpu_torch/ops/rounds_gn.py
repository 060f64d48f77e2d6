"""One round of the rounds-structured solver's GN iterations in one launch.

The JAX package's `register_rounds_core` runs each round's iterations as
one device loop (`lax.while_loop` inside `lax.scan` over the rounds).  The
port's `ops/register.py::register_rounds_core` runs each round, after its
two fetches, through `rounds_gn`:

  * on CUDA tensors it launches the kernel `csrc/rounds_gn.cu` (a cluster
    of C CTAs a lane, C from the shapes by `kernels.rounds_gn_cluster`, up
    to `iters` iterations each with the lane's own early exit, no host
    sync);
  * on CPU tensors it runs `rounds_gn_reference`, the port's loop body
    (`ops/register.py::round_iterations`: the candidate correspondences
    and `gn_step`, the lanes frozen with `torch.where`, one host check an
    iteration), unpacked from and packed back into the kernel's layout.

The kernel computes what the loop body computes: the candidate d2 with a
candidate invalid where the fetch's d2 is >= 1e37, the 5-of-K selection,
the line and plane fits with their gates, J^T J and J^T b, the
eigen-decomposition of J^T J on every iteration (a converged cyclic Jacobi
where the loop calls `torch.linalg.eigh`), the degeneracy projector at the
lane's global iteration 0, the update and the convergence test.  It is not
bitwise the loop: it sums in another order and its eigenvectors are not
eigh's, and x and the projector do not depend on their order or signs.

Layouts (gn_round's, plus the fetch's d2): stat [B, 16] with
`ops/gn_round.py`'s STAT slots ([0:6] pose6, [6] iterations so far, [7]
converged, [8] is_degenerate, [9] feature gate, [10] n_corr), matP [B, 36],
featc [B, 4, Pc] / feats [B, 4, Ps] (x, y, z, mask rows), candc [3K, B*Pc]
/ cands [3K, B*Ps] plane-major candidates (`block_fetch(planes_out=True)`),
cd2 [K, B*Pc] / sd2 [K, B*Ps] the fetch's d2 transposed; lane b's block is
the columns [b*P, (b+1)*P).
"""

from __future__ import annotations

import torch

from .. import kernels
from .gn_round import _check as _check_gn
from .solver import GNState


def _check(stat, matP, featc, feats, candc, cands, cd2, sd2, K):
    B, Pc, Ps = _check_gn(stat, matP, featc, feats, candc, cands, K)
    for name, t, P in (("cd2", cd2, Pc), ("sd2", sd2, Ps)):
        if tuple(t.shape) != (K, B * P):
            raise ValueError(f"{name} must be {(K, B * P)}, got "
                             f"{tuple(t.shape)}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if t.device != stat.device:
            raise ValueError(f"{name} is on {t.device}, stat on "
                             f"{stat.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    return B, Pc, Ps


def rounds_gn_reference(stat, matP, featc, feats, candc, cands, cd2, sd2, *,
                        K: int, iters: int, min_corr: int = 50,
                        eig_thresh: float = 100.0,
                        conv_rot_deg: float = 0.05,
                        conv_trans_cm: float = 0.05,
                        min_plane_spread: float = 0.0):
    """Plain PyTorch version of the round: the port's loop body on the
    unpacked layout.  Same arguments and result as `rounds_gn`."""
    from .register import round_iterations  # register imports this module

    B, Pc, Ps = _check(stat, matP, featc, feats, candc, cands, cd2, sd2, K)
    state = GNState(
        pose6=stat[:, 0:6].clone(),
        matP=matP.reshape(B, 6, 6).clone(),
        is_degenerate=stat[:, 8] > 0.0,
        converged=stat[:, 7] > 0.0,
        n_corr=stat[:, 10].to(torch.int32),
    )

    def unpack(f, c, d2):
        P = f.shape[2]
        return (f[:, 0:3].transpose(1, 2).contiguous(), f[:, 3] != 0.0,
                c.view(3, K, B * P).permute(2, 1, 0).contiguous(),
                d2.t().contiguous() < 1e37)

    state, done = round_iterations(
        *unpack(featc, candc, cd2), *unpack(feats, cands, sd2), state,
        stat[:, 6].to(torch.int32), stat[:, 9] > 0.0, iters=iters,
        min_correspondences=min_corr, eigen_threshold=eig_thresh,
        converge_rot_deg=conv_rot_deg, converge_trans_cm=conv_trans_cm,
        min_plane_spread=min_plane_spread)
    out = stat.clone()
    out[:, 0:6] = state.pose6
    out[:, 6] = stat[:, 6] + done.to(stat.dtype)
    out[:, 7] = state.converged.to(stat.dtype)
    out[:, 8] = state.is_degenerate.to(stat.dtype)
    out[:, 10] = state.n_corr.to(stat.dtype)
    return out, state.matP.reshape(B, 36).contiguous()


def rounds_gn(stat, matP, featc, feats, candc, cands, cd2, sd2, *, K: int,
              iters: int, min_corr: int = 50, eig_thresh: float = 100.0,
              conv_rot_deg: float = 0.05, conv_trans_cm: float = 0.05,
              min_plane_spread: float = 0.0, cluster: int | None = None):
    """Run one round of up to `iters` GN iterations for every lane, on the
    K candidates of each feature (the module docstring's layouts).
    Returns (stat', matP').  The caller resets converged (stat[:, 7]) at
    the round's start.

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (K in kernels.SUPPORTED_K), or raise.  cluster: the kernel's CTAs a
    lane (a power of two up to kernels.ROUNDS_MAX_CLUSTER, checked on
    every device), for measurements and tests; by default the kernel
    picks it from the shapes."""
    args = dict(K=K, iters=iters, min_corr=min_corr, eig_thresh=eig_thresh,
                conv_rot_deg=conv_rot_deg, conv_trans_cm=conv_trans_cm,
                min_plane_spread=min_plane_spread)
    _check(stat, matP, featc, feats, candc, cands, cd2, sd2, K)
    if cluster is not None:
        kernels.check_cluster(cluster)
    if stat.device.type == "cpu":
        return rounds_gn_reference(stat, matP, featc, feats, candc, cands,
                                   cd2, sd2, **args)
    if stat.device.type != "cuda":
        raise ValueError(f"unsupported device {stat.device}")
    stat = stat.clone()
    matP = matP.clone()
    kernels.launch_rounds_gn(stat, matP, featc, feats, candc, cands, cd2,
                             sd2, cluster=cluster, **args)
    rounds_gn.launches += 1
    return stat, matP


rounds_gn.launches = 0
