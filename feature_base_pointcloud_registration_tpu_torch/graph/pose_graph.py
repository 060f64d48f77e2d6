"""Sliding-window Levenberg-Marquardt pose-graph optimizer.

Port of the JAX package's `graph/pose_graph.py`, the replacement for the
reference's GTSAM iSAM2 back end (ref: src/mapOptmization.h:153-159
construction, :1658-1669 updates) with the same factor types:

  * prior factor on pose 0 (addOdomFactor first branch, ref :1520-1527)
  * between (odometry) factors     (ref :1531-1539)
  * GPS position factors           (addGPSFactor, ref :1543-1634)
  * loop-closure between factors   (performLoopClosure, ref :743-765)

iSAM2's incremental relinearization is replaced by batch LM over a
fixed-capacity, masked window.  The state is poses [K, 6] in pose6 = (roll,
pitch, yaw, x, y, z); residuals use GTSAM-style local coordinates
[so3_log(rotation error), translation error] whitened by per-factor
diagonal sigmas.  Jacobian blocks come from per-factor forward-mode
derivatives (dual numbers, as the JAX package's `jax.jacfwd`), summed
into a dense Hessian; one Cholesky solve per LM step, in float32 after
Jacobi scaling.  Marginal covariances are assembled and solved on the host
in float64, as in the JAX package.

The JAX package compiles the LM steps into one device loop (`lax.scan`).
`optimize_pose_graph` dispatches by the graph's device:

  * CPU tensors run `optimize_pose_graph_reference`, the port's loop body
    (`torch.autograd.forward_ad` Jacobians, `index_put_(accumulate=True)`
    assembly, `torch.linalg.cholesky_ex`), driven from the host;
  * CUDA tensors launch `csrc/pose_graph_lm.cu` on the live poses (below):
    route A, every iteration in one launch of one CTA, where 6 x the live
    count fits shared memory (`kernels.POSE_GRAPH_LM_MAX_LIVE`); route B
    above it, an assemble kernel, `_lm_solve_step` (the dense solve, which
    JAX leaves to `jax.scipy.linalg.solve` outside any kernel) and an
    update kernel an iteration, with no host sync inside the iterations.

A pose is live if it is active or an endpoint of an unmasked factor.  Every
other pose has zero rows in H and grad, a scaled row (lam + 1) I and a
zero step, so a solve over the live poses alone equals, in exact
arithmetic, the solve over all K.  `live_set` compacts them on the device;
its live count is the one host read of a solve.  `graph_factor_blocks`
dispatches the same way (`fbpr_pose_graph_blocks` on CUDA tensors).

The LM loop makes no host decision: a step is accepted with `torch.where`
(on the device in the kernel), and a factorization that fails
(`cholesky_ex`'s info != 0, a pivot that is not > 0 in the kernel, where
the JAX solve gives NaN) is a rejected step.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from .. import kernels
from ..geom.se3 import euler_to_rot, rot_to_euler, so3_log


class PoseGraphData(NamedTuple):
    """Fixed-capacity factor storage (masked)."""

    poses: torch.Tensor        # f32 [K, 6] initial values
    pose_mask: torch.Tensor    # bool [K] active variables
    prior_idx: torch.Tensor    # i32 [Fp]
    prior_meas: torch.Tensor   # f32 [Fp, 6]
    prior_sigma: torch.Tensor  # f32 [Fp, 6]
    prior_mask: torch.Tensor   # bool [Fp]
    btw_i: torch.Tensor        # i32 [Fb]
    btw_j: torch.Tensor        # i32 [Fb]
    btw_meas: torch.Tensor     # f32 [Fb, 6] relative pose6 (i -> j)
    btw_sigma: torch.Tensor    # f32 [Fb, 6]
    btw_mask: torch.Tensor     # bool [Fb]
    gps_idx: torch.Tensor      # i32 [Fg]
    gps_meas: torch.Tensor     # f32 [Fg, 3]
    gps_sigma: torch.Tensor    # f32 [Fg, 3]
    gps_mask: torch.Tensor     # bool [Fg]

    @staticmethod
    def empty(K: int, Fp: int, Fb: int, Fg: int, *, device):
        def z(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=device)

        def one(*shape):
            return torch.ones(shape, dtype=torch.float32, device=device)

        return PoseGraphData(
            poses=z(K, 6), pose_mask=z(K, dtype=torch.bool),
            prior_idx=z(Fp, dtype=torch.int32), prior_meas=z(Fp, 6),
            prior_sigma=one(Fp, 6), prior_mask=z(Fp, dtype=torch.bool),
            btw_i=z(Fb, dtype=torch.int32), btw_j=z(Fb, dtype=torch.int32),
            btw_meas=z(Fb, 6), btw_sigma=one(Fb, 6),
            btw_mask=z(Fb, dtype=torch.bool),
            gps_idx=z(Fg, dtype=torch.int32), gps_meas=z(Fg, 3),
            gps_sigma=one(Fg, 3), gps_mask=z(Fg, dtype=torch.bool),
        )


def _local_coords(meas6, pose6):
    """GTSAM-style error of `pose` w.r.t. measurement:
    [log(Rm^T R), Rm^T (t - tm)]; broadcasts over leading dims."""
    Rm_t = euler_to_rot(meas6[..., 0], meas6[..., 1],
                        meas6[..., 2]).transpose(-1, -2)
    R = euler_to_rot(pose6[..., 0], pose6[..., 1], pose6[..., 2])
    dt = (Rm_t @ (pose6[..., 3:6] - meas6[..., 3:6])[..., None])[..., 0]
    return torch.cat([so3_log(Rm_t @ R), dt], -1)


def between_residual(pose_i, pose_j, meas6):
    """Error of the relative transform (T_i^-1 T_j) w.r.t. meas."""
    Ri_t = euler_to_rot(pose_i[..., 0], pose_i[..., 1],
                        pose_i[..., 2]).transpose(-1, -2)
    Rj = euler_to_rot(pose_j[..., 0], pose_j[..., 1], pose_j[..., 2])
    tij = (Ri_t @ (pose_j[..., 3:6] - pose_i[..., 3:6])[..., None])[..., 0]
    rel = torch.cat([torch.stack(rot_to_euler(Ri_t @ Rj), -1), tij], -1)
    return _local_coords(meas6, rel)


def _prior_res(pose, meas, sigma):
    return _local_coords(meas, pose) / sigma


def _btw_res(pose_i, pose_j, meas, sigma):
    return between_residual(pose_i, pose_j, meas) / sigma


def _gps_res(pose, meas, sigma):
    return (pose[..., 3:6] - meas) / sigma


def _with_jacobians(fn, args, argnums):
    """fn's residuals of F independent factors (batched over F: args [F,
    ...]) and their Jacobian blocks [F, n_out, D] w.r.t. each args[a] [F,
    D], a in argnums, in forward mode like the JAX package's `jax.jacfwd`:
    the D tangent directions of each differentiated argument become copies
    of the batch, one dual-number evaluation (`torch.autograd.forward_ad`)
    gives every column, and its primal part the residuals."""
    F = args[0].shape[0]
    D = args[argnums[0]].shape[-1]
    n = D * len(argnums)
    eye = torch.eye(D, dtype=args[0].dtype,
                    device=args[0].device).repeat_interleave(F, 0)
    with fwAD.dual_level():
        # every argument dual (zero tangents but the differentiated ones):
        # PyTorch takes a slow path for an op between a dual tensor and a
        # plain one
        duals = []
        for i, a in enumerate(args):
            rep = a.repeat(n, *[1] * (a.dim() - 1))
            t = torch.zeros_like(rep)
            if i in argnums:
                k = argnums.index(i)
                t[D * F * k:D * F * (k + 1)] = eye
            duals.append(fwAD.make_dual(rep, t))
        primal, tangent = fwAD.unpack_dual(fn(*duals))
    J = tangent.reshape(len(argnums), D, F, -1).permute(0, 2, 3, 1)
    return primal[:F], list(J)


def _residuals(g: PoseGraphData, poses):
    """Whitened residuals of every factor (masked ones zeroed):
    (r_p [Fp, 6], r_b [Fb, 6], r_g [Fg, 3])."""
    p = _prior_res(poses[g.prior_idx.long()], g.prior_meas, g.prior_sigma)
    b = _btw_res(poses[g.btw_i.long()], poses[g.btw_j.long()], g.btw_meas,
                 g.btw_sigma)
    r = _gps_res(poses[g.gps_idx.long()], g.gps_meas, g.gps_sigma)
    return (torch.where(g.prior_mask[:, None], p, 0.0),
            torch.where(g.btw_mask[:, None], b, 0.0),
            torch.where(g.gps_mask[:, None], r, 0.0))


def _graph_cost_terms(g: PoseGraphData, poses):
    """All whitened residuals + per-factor Jacobian blocks (masked entries
    zeroed): ((r_p, J_p), (r_b, J_bi, J_bj), (r_g, J_g))."""
    r_p, (J_p,) = _with_jacobians(
        _prior_res, (poses[g.prior_idx.long()], g.prior_meas,
                     g.prior_sigma), (0,))
    r_b, (J_bi, J_bj) = _with_jacobians(
        _btw_res, (poses[g.btw_i.long()], poses[g.btw_j.long()],
                   g.btw_meas, g.btw_sigma), (0, 1))
    r_g, (J_g,) = _with_jacobians(
        _gps_res, (poses[g.gps_idx.long()], g.gps_meas, g.gps_sigma), (0,))

    def masked(x, m):
        return torch.where(m.view(-1, *[1] * (x.dim() - 1)), x, 0.0)

    return ((masked(r_p, g.prior_mask), masked(J_p, g.prior_mask)),
            (masked(r_b, g.btw_mask), masked(J_bi, g.btw_mask),
             masked(J_bj, g.btw_mask)),
            (masked(r_g, g.gps_mask), masked(J_g, g.gps_mask)))


def _assemble(g: PoseGraphData, poses, K):
    """Dense H = J^T J and gradient = J^T r from per-factor blocks."""
    (r_p, J_p), (r_b, J_bi, J_bj), (r_g, J_g) = _graph_cost_terms(g, poses)
    D = K * 6
    dev = poses.device
    H = torch.zeros(D, D, dtype=torch.float32, device=dev)
    grad = torch.zeros(D, dtype=torch.float32, device=dev)
    six = torch.arange(6, device=dev)

    def rows(idx):
        return idx.long()[:, None] * 6 + six[None, :]          # [F, 6]

    def add_block(idx_a, idx_b, Ja, Jb):
        blocks = torch.einsum("fab,fac->fbc", Ja, Jb)
        ra, rb = rows(idx_a), rows(idx_b)
        H.index_put_((ra[:, :, None].expand(-1, -1, 6),
                       rb[:, None, :].expand(-1, 6, -1)), blocks,
                      accumulate=True)

    def add_grad(idx, J, r):
        grad.index_put_((rows(idx),), torch.einsum("fab,fa->fb", J, r),
                        accumulate=True)

    add_block(g.prior_idx, g.prior_idx, J_p, J_p)
    add_grad(g.prior_idx, J_p, r_p)
    # betweens (4 blocks each)
    add_block(g.btw_i, g.btw_i, J_bi, J_bi)
    add_block(g.btw_j, g.btw_j, J_bj, J_bj)
    add_block(g.btw_i, g.btw_j, J_bi, J_bj)
    add_block(g.btw_j, g.btw_i, J_bj, J_bi)
    add_grad(g.btw_i, J_bi, r_b)
    add_grad(g.btw_j, J_bj, r_b)
    # gps (Jacobian blocks are [F, 3, 6])
    add_block(g.gps_idx, g.gps_idx, J_g, J_g)
    add_grad(g.gps_idx, J_g, r_g)
    cost = (r_p * r_p).sum() + (r_b * r_b).sum() + (r_g * r_g).sum()
    return H, grad, cost


def _total_cost(g: PoseGraphData, poses):
    r_p, r_b, r_g = _residuals(g, poses)
    return (r_p * r_p).sum() + (r_b * r_b).sum() + (r_g * r_g).sum()


def _lm_solve_step(H, grad, lam, pin, active):
    """The dense part of an LM step: Jacobi scaling, the pin of inactive
    rows, damping, the float32 Cholesky and its two triangular solves.
    Returns (dx [D], info): the step (0 on inactive rows) and
    `cholesky_ex`'s info (!= 0: the factorization failed, a rejected
    step)."""
    # Jacobi-precondition before the float32 Cholesky: factor weights
    # span ~1e-8 (the wide gauge prior) to ~1e6 (tight betweens,
    # fit-scaled loop factors), far beyond float32 solve conditioning;
    # after scaling, the uniform relative damping `lam` (floor 1e-6)
    # bounds the condition number even along the gauge direction.
    d = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-12)) + pin
    A = H / (d[:, None] * d[None, :]) + torch.diag(lam + pin)
    L, info = torch.linalg.cholesky_ex(A)
    dy = torch.cholesky_solve((-grad / d)[:, None], L)[:, 0]
    return torch.where(active, dy / d, 0.0), info


def optimize_pose_graph_reference(g: PoseGraphData, iterations: int = 10,
                                  accepts: list | None = None):
    """Plain PyTorch version of `optimize_pose_graph` on any device: the
    LM steps driven from the host over all K poses.  accepts: a list that
    gets each step's accept flag (a bool tensor)."""
    K = g.poses.shape[0]
    active = g.pose_mask.repeat_interleave(6)
    pin = torch.where(active, 0.0, 1.0)
    poses = g.poses
    cost = _total_cost(g, poses)
    lam = torch.tensor(1e-4, dtype=torch.float32, device=poses.device)
    for _ in range(iterations):
        H, grad, _ = _assemble(g, poses, K)
        dx, info = _lm_solve_step(H, grad, lam, pin, active)
        new_poses = poses + dx.reshape(K, 6)
        new_cost = _total_cost(g, new_poses)
        # a failed factorization is a rejected step (the JAX solve's NaN)
        accept = (info == 0) & (new_cost < cost)
        if accepts is not None:
            accepts.append(accept)
        poses = torch.where(accept, new_poses, poses)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, torch.clamp(lam * 0.3, min=1e-6),
                          torch.clamp(lam * 4.0, max=1e6))
    return poses, cost


class LiveSet(NamedTuple):
    """The live poses of a graph, compacted in pose order."""

    n: int                # live count (read on the host)
    idx: torch.Tensor     # i64 [n] the pose of each live row
    rowmap: torch.Tensor  # i32 [K] the live row of each pose, -1 if none
    rows: torch.Tensor    # i32 [Fp + 2 Fb + Fg] the live rows of the
    #                       factors' endpoints (prior, btw_i, btw_j, gps);
    #                       0 on masked slots


def _endpoints(g: PoseGraphData):
    """(pose index, mask) of every factor endpoint, in `LiveSet.rows`'
    order."""
    return (torch.cat([g.prior_idx, g.btw_i, g.btw_j, g.gps_idx]),
            torch.cat([g.prior_mask, g.btw_mask, g.btw_mask, g.gps_mask]))


def live_set(g: PoseGraphData) -> LiveSet:
    """The live poses (active, or an endpoint of an unmasked factor) and
    the factors' endpoints remapped to them, built on the graph's device;
    one host read, the live count."""
    K = g.poses.shape[0]
    dev = g.poses.device
    ends, emask = _endpoints(g)
    hits = torch.zeros(K, dtype=torch.int32, device=dev)
    hits.index_add_(0, ends.long(), emask.to(torch.int32))
    live = g.pose_mask | (hits > 0)
    rank = torch.cumsum(live, 0, dtype=torch.int32) - 1
    n = int(rank[-1]) + 1 if K else 0
    rowmap = torch.where(live, rank, -1)
    # every non-live pose lands in the spare slot n
    idx = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    idx.scatter_(0, torch.where(live, rank, n).long(),
                 torch.arange(K, device=dev))
    rows = torch.where(emask, rowmap[ends.long()], 0)
    return LiveSet(n, idx[:n], rowmap, rows)


def live_subgraph(g: PoseGraphData, ls: LiveSet) -> PoseGraphData:
    """The graph on its live poses alone (K = ls.n), the factors' endpoints
    remapped."""
    Fp, Fb = g.prior_idx.shape[0], g.btw_i.shape[0]
    r = torch.split(ls.rows, [Fp, Fb, Fb, g.gps_idx.shape[0]])
    return g._replace(poses=g.poses[ls.idx], pose_mask=g.pose_mask[ls.idx],
                      prior_idx=r[0], btw_i=r[1], btw_j=r[2], gps_idx=r[3])


def envelope_starts(g: PoseGraphData, ls: LiveSet) -> torch.Tensor:
    """The plain version of route A's envelope (csrc/pose_graph_lm.cu's
    prologue): i32 [n], for each live pose x the lowest live pose that an
    unmasked between factor couples it to, x itself if none.  H's block
    row x, and the Cholesky factor's, are 0.0 left of block column
    envelope_starts[x]."""
    Fp, Fb = g.prior_idx.shape[0], g.btw_i.shape[0]
    ri = ls.rows[Fp:Fp + Fb].long()
    rj = ls.rows[Fp + Fb:Fp + 2 * Fb].long()
    hi = torch.where(g.btw_mask, torch.maximum(ri, rj), 0)
    lo = torch.where(g.btw_mask, torch.minimum(ri, rj), 0)
    fb = torch.arange(ls.n, dtype=torch.int64, device=g.poses.device)
    if ls.n:
        fb = fb.scatter_reduce(0, hi, lo, reduce="amin")
    return fb.to(torch.int32)


def _check_graph(g: PoseGraphData):
    K = g.pose_mask.shape[0]
    want = {"poses": ((K, 6), torch.float32),
            "pose_mask": ((K,), torch.bool)}
    for kind, names, w in (("prior", ("prior_idx",), 6),
                           ("btw", ("btw_i", "btw_j"), 6),
                           ("gps", ("gps_idx",), 3)):
        F = getattr(g, names[0]).shape[0]
        want.update({n: ((F,), torch.int32) for n in names})
        want.update({f"{kind}_meas": ((F, w), torch.float32),
                     f"{kind}_sigma": ((F, w), torch.float32),
                     f"{kind}_mask": ((F,), torch.bool)})
    for name, (shape, dtype) in want.items():
        t = getattr(g, name)
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != g.poses.device:
            raise ValueError(f"{name} is on {t.device}, poses on "
                             f"{g.poses.device}")


def _contiguous(g: PoseGraphData) -> PoseGraphData:
    return PoseGraphData(*(t.contiguous() for t in g))


def optimize_pose_graph(g: PoseGraphData, iterations: int = 10,
                        accepts: list | None = None):
    """Levenberg-Marquardt over the masked window, `iterations` steps.

    Returns (optimized poses [K, 6], final cost []).  Inactive poses
    (mask False) are pinned by a unit ridge so H stays invertible.  CPU
    tensors run `optimize_pose_graph_reference`; CUDA tensors launch the
    kernel (route A up to kernels.POSE_GRAPH_LM_MAX_LIVE live poses, route
    B above), or raise.  accepts: a list that gets each step's accept flag
    (a bool tensor)."""
    _check_graph(g)
    dev = g.poses.device
    if dev.type == "cpu":
        return optimize_pose_graph_reference(g, iterations, accepts)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    g = _contiguous(g)
    ls = live_set(g)
    iterations = max(iterations, 0)
    acc = torch.zeros(iterations, dtype=torch.int32, device=dev)
    if ls.n == 0:
        # every factor masked, no pose active: the cost is 0, nothing moves
        poses = g.poses.clone()
        cost = torch.zeros((), dtype=torch.float32, device=dev)
    elif ls.n <= kernels.POSE_GRAPH_LM_MAX_LIVE:
        poses = torch.empty_like(g.poses)
        cost = torch.empty((), dtype=torch.float32, device=dev)
        kernels.launch_pose_graph_lm(g, ls, iterations, poses, cost, acc)
        optimize_pose_graph.launches += 1
    else:
        poses, cost = _route_b(g, ls, iterations, acc)
    if accepts is not None:
        accepts.extend(acc != 0)
    return poses, cost


optimize_pose_graph.launches = 0      # route A: one a solve
optimize_pose_graph.launches_b = 0    # route B: two an iteration


def _route_b(g: PoseGraphData, ls: LiveSet, iterations: int, acc):
    """The LM on n live poses past route A's cap: an iteration is one
    assemble launch (H, grad and, at iteration 0, the cost into global
    memory), `_lm_solve_step` at D = 6n and one update launch (the new
    cost, accept and lam on the device)."""
    dev = g.poses.device
    D = 6 * ls.n
    sub = live_subgraph(g, ls)
    poses = sub.poses      # a copy: the update kernel writes it
    active = sub.pose_mask.repeat_interleave(6)
    pin = torch.where(active, 0.0, 1.0)
    H = torch.empty(D, D, dtype=torch.float32, device=dev)
    grad = torch.empty(D, dtype=torch.float32, device=dev)
    state = torch.full((2,), 1e-4, dtype=torch.float32,
                       device=dev)                       # cost, lam
    if iterations == 0:    # the cost alone
        kernels.launch_pose_graph_assemble(g, ls, poses, H, grad, state, 0)
        optimize_pose_graph.launches_b += 1
    for it in range(iterations):
        kernels.launch_pose_graph_assemble(g, ls, poses, H, grad, state, it)
        dx, info = _lm_solve_step(H, grad, state[1], pin, active)
        kernels.launch_pose_graph_update(g, ls, poses, dx, info, state, acc,
                                         it)
        optimize_pose_graph.launches_b += 2
    out = g.poses.clone()
    out.index_copy_(0, ls.idx, poses)
    return out, state[0].clone()


def graph_factor_blocks_reference(g: PoseGraphData, poses):
    """Plain PyTorch version of `graph_factor_blocks` on any device."""
    return _graph_cost_terms(g, poses)


def graph_factor_blocks(g: PoseGraphData, poses):
    """Whitened per-factor residuals + Jacobian blocks at `poses` (masked
    entries zeroed): the square-root-form inputs of the host-side float64
    marginal covariances, ((r_p [Fp, 6], J_p [Fp, 6, 6]), (r_b [Fb, 6],
    J_bi, J_bj [Fb, 6, 6]), (r_g [Fg, 3], J_g [Fg, 3, 6])).  CPU tensors
    run the plain version; CUDA tensors launch `fbpr_pose_graph_blocks`,
    or raise."""
    _check_graph(g._replace(poses=poses))
    dev = poses.device
    if dev.type == "cpu":
        return graph_factor_blocks_reference(g, poses)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    g = _contiguous(g._replace(poses=poses))
    Fp, Fb, Fg = (g.prior_idx.shape[0], g.btw_i.shape[0],
                  g.gps_idx.shape[0])

    def e(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    out = ((e(Fp, 6), e(Fp, 6, 6)), (e(Fb, 6), e(Fb, 6, 6), e(Fb, 6, 6)),
           (e(Fg, 3), e(Fg, 3, 6)))
    kernels.launch_pose_graph_blocks(g, _endpoints(g)[0], out)
    graph_factor_blocks.launches += 1
    return out


graph_factor_blocks.launches = 0


def pose_marginal_covariances(g: PoseGraphData, poses, idxs,
                              active: int | None = None):
    """6x6 marginal covariances of several poses from ONE factorization.

    The reference reads isam->marginalCovariance(latest) after every update
    (ref: src/mapOptmization.h:1706) to gate GPS factors (poseCovThreshold,
    ref :1596-1599).  The Jacobian blocks come off the device in float32;
    the Hessian is assembled and inverted on the host in float64 (in
    float32, the 1e-8-information prior summed into 1e6-scale between
    blocks vanishes and H goes singular along the gauge).

    poses: [K, 6] numpy or tensor.  `active` restricts assembly and solve
    to the first `active` poses (every factor endpoint must lie below it,
    as in the SLAM graph's padded storage).  All `idxs` share one
    assembly and one factorization."""
    poses = torch.as_tensor(np.asarray(poses, np.float32),
                            device=g.poses.device)
    (r_p, J_p), (r_b, J_bi, J_bj), (r_g, J_g) = [
        [t.detach().cpu().numpy().astype(np.float64) for t in group]
        for group in graph_factor_blocks(g, poses)]
    K = g.poses.shape[0]
    n = K if active is None else min(int(active), K)
    if any(int(i) >= n for i in idxs):
        raise ValueError(f"requested pose index >= active count {n}")
    D = n * 6
    H = np.zeros((D, D))

    def add(ia, ib, Ja, Jb):
        blocks = np.einsum("fab,fac->fbc", Ja, Jb)
        for f in range(len(ia)):
            a, b = ia[f], ib[f]
            if a < n and b < n:
                H[a * 6:(a + 1) * 6, b * 6:(b + 1) * 6] += blocks[f]

    pi = g.prior_idx.cpu().numpy()
    bi, bj = g.btw_i.cpu().numpy(), g.btw_j.cpu().numpy()
    gi = g.gps_idx.cpu().numpy()
    add(pi, pi, J_p, J_p)
    add(bi, bi, J_bi, J_bi)
    add(bj, bj, J_bj, J_bj)
    add(bi, bj, J_bi, J_bj)
    add(bj, bi, J_bj, J_bi)
    add(gi, gi, J_g, J_g)
    active_rows = np.repeat(g.pose_mask.cpu().numpy()[:n], 6)
    H[np.diag_indices(D)] += np.where(active_rows, 0.0, 1.0)

    cols = np.concatenate([int(i) * 6 + np.arange(6) for i in idxs])
    E = np.zeros((D, len(cols)))
    E[cols, np.arange(len(cols))] = 1.0
    X = np.linalg.solve(H, E)
    return [X[int(i) * 6 + np.arange(6)][:, k * 6:(k + 1) * 6]
            for k, i in enumerate(idxs)]


def pose_marginal_covariance(g: PoseGraphData, poses, idx: int,
                             active: int | None = None):
    """6x6 marginal covariance [rot(3), trans(3)] of pose `idx`."""
    return pose_marginal_covariances(g, poses, [idx], active=active)[0]
