"""IMU-preintegration factor chain: the iSAM2-in-imuPreintegration replacement.

Port of the JAX package's `graph/imu_graph.py`.  The reference maintains a
chain graph { ImuFactor(k-1,k), bias BetweenFactor, pose PriorFactor(k) }
optimized by iSAM2 after every lidar correction (ref:
src/imuPreintegration.cpp:296-332), reset every 100 keys with marginal
covariances carried into new priors (ref :234-267).  Here the same chain is
a fixed-cap masked window of 15-dim states (pose6, vel3, bias6) optimized
by batch Levenberg-Marquardt; the reset maps to re-priming the window
priors.

IMU factor residual (Forster-style, matching gtsam::ImuFactor):
  r_R = Log( dR(b)^T R_i^T R_j )
  r_v = R_i^T (v_j - v_i - g dt) - dv(b)
  r_p = R_i^T (p_j - p_i - v_i dt - 1/2 g dt^2) - dp(b)
whitened by the preintegrated 9x9 covariance; dR/dv/dp are first-order
bias-corrected around the preintegration linearization point.

Jacobian blocks are forward-mode derivatives, one dual-number evaluation
per factor kind (`graph.pose_graph._with_jacobians`).  The whitening
factor L = chol(cov + 1e-10 I) does not depend on the states, so it is
taken once per solve (batched `cholesky_ex`, never raising; a failed
factorization gives NaN residuals, as the JAX Cholesky does) and applied
to residuals and Jacobian columns by triangular solves.  The Hessian of
the chain is assembled block by block in the JAX package's order of
additions, with no scatter, so it is deterministic on every device.  The LM
loop makes no host decision: a step is accepted with `torch.where`, and a
failed factorization is a rejected step.  Marginal covariances are solved
on the host in float64, as in the JAX package.

The JAX package compiles the LM steps into one device loop (`lax.scan`).
`optimize_imu_chain` and `chain_factor_blocks` dispatch by the chain's
device:

  * CPU tensors run `optimize_imu_chain_reference` /
    `chain_factor_blocks_reference`, the loop above driven from the host;
  * CUDA tensors launch `csrc/imu_chain_lm.cu`: the whole LM in one launch
    of one CTA (`fbpr_imu_chain_lm`; H's block-tridiagonal structure
    factored block by block in global scratch, every window size), or
    the factor blocks (`fbpr_imu_chain_blocks`), with no host read;
  * any other device raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
from ..geom.se3 import euler_to_rot, so3_exp, so3_log
from ..imu.preintegration import PreintState
from .pose_graph import _with_jacobians

# state layout: [roll, pitch, yaw, x, y, z, vx, vy, vz, bax, bay, baz, bgx, bgy, bgz]
STATE_DIM = 15


class ImuChainData(NamedTuple):
    states: torch.Tensor       # f32 [K, 15] initial values
    state_mask: torch.Tensor   # bool [K]
    preint: PreintState        # batched [K]; entry k = interval (k-1, k)
    preint_mask: torch.Tensor  # bool [K] (entry 0 unused)
    pose_meas: torch.Tensor    # f32 [K, 6] lidar-odometry pose corrections
    pose_sigma: torch.Tensor   # f32 [K, 6]
    pose_meas_mask: torch.Tensor  # bool [K]
    prior_state: torch.Tensor  # f32 [15] prior on key 0
    prior_sigma: torch.Tensor  # f32 [15]
    bias_sigma: torch.Tensor   # f32 [6] continuous bias random-walk sigmas
    gravity: torch.Tensor      # f32 []


def _mv(M, v):
    """Batched matrix [..., 3, 3] times vector [..., 3]."""
    return (M @ v[..., None])[..., 0]


def _rot(s):
    return euler_to_rot(s[..., 0], s[..., 1], s[..., 2])


def _imu_residual(s_i, s_j, dR0, dv0, dp0, dt, dR_dbg, dv_dba, dv_dbg,
                  dp_dba, dp_dbg, bias_acc, bias_gyr, gravity):
    """Unwhitened 9-dim residuals of preintegrated intervals [F]."""
    Ri = _rot(s_i)
    Rj = _rot(s_j)
    pi_, pj = s_i[..., 3:6], s_j[..., 3:6]
    vi, vj = s_i[..., 6:9], s_j[..., 6:9]
    ba, bg = s_i[..., 9:12], s_i[..., 12:15]
    g = torch.stack([0.0 * gravity, 0.0 * gravity, -gravity], -1)

    dba = ba - bias_acc
    dbg = bg - bias_gyr
    dR = dR0 @ so3_exp(_mv(dR_dbg, dbg))
    dv = dv0 + _mv(dv_dba, dba) + _mv(dv_dbg, dbg)
    dp = dp0 + _mv(dp_dba, dba) + _mv(dp_dbg, dbg)

    dt = dt[..., None]
    Ri_t = Ri.transpose(-1, -2)
    r_R = so3_log(dR.transpose(-1, -2) @ (Ri_t @ Rj))
    r_v = _mv(Ri_t, vj - vi - g * dt) - dv
    r_p = _mv(Ri_t, pj - pi_ - vi * dt - 0.5 * g * dt * dt) - dp
    return torch.cat([r_R, r_v, r_p], -1)


def _bias_res(s_i, s_j, dt, bias_sigma):
    sig = torch.sqrt(torch.clamp(dt, min=1e-6))[..., None] * bias_sigma  # ref :313
    return (s_j[..., 9:15] - s_i[..., 9:15]) / sig


def _pose_prior_res(s, meas, sigma):
    Rm_t = _rot(meas).transpose(-1, -2)
    dR = Rm_t @ _rot(s)
    dt = _mv(Rm_t, s[..., 3:6] - meas[..., 3:6])
    return torch.cat([so3_log(dR), dt], -1) / sigma


def _init_prior_res(s, prior, sigma):
    return (s - prior) / sigma


def _whitener(d: ImuChainData):
    """L = chol(cov + 1e-10 I) of every interval [K, 9, 9]; NaN where the
    factorization fails (the JAX Cholesky's NaN), never an exception."""
    cov = d.preint.cov
    L, info = torch.linalg.cholesky_ex(
        cov + torch.eye(9, dtype=cov.dtype, device=cov.device) * 1e-10)
    return torch.where((info == 0)[:, None, None], L, float("nan"))


def _whiten(L, x):
    """L^-1 x for residuals [K, 9] or Jacobian blocks [K, 9, n]."""
    if x.dim() == 2:
        return torch.linalg.solve_triangular(L, x[..., None],
                                             upper=False)[..., 0]
    return torch.linalg.solve_triangular(L, x, upper=False)


def _factor_args(d: ImuChainData, states):
    K = states.shape[0]
    prev = torch.clamp(torch.arange(K, device=states.device) - 1, min=0)
    s_prev = states[prev]
    pre = d.preint
    imu = (s_prev, states, pre.dR, pre.dv, pre.dp, pre.dt, pre.dR_dbg,
           pre.dv_dba, pre.dv_dbg, pre.dp_dba, pre.dp_dbg, pre.bias_acc,
           pre.bias_gyr, d.gravity.expand(K))
    bias = (s_prev, states, pre.dt, d.bias_sigma.expand(K, 6))
    pp = (states, d.pose_meas, d.pose_sigma)
    p0 = (states[:1], d.prior_state[None], d.prior_sigma[None])
    return imu, bias, pp, p0


def _masks(d: ImuChainData):
    return d.preint_mask & d.state_mask, d.pose_meas_mask & d.state_mask


def _masked(x, m):
    return torch.where(m.view(-1, *[1] * (x.dim() - 1)), x, 0.0)


def _all_residuals(d: ImuChainData, states, L):
    """Whitened residuals (r_imu, r_b, r_pp, r_0), masked ones zeroed."""
    imu, bias, pp, p0 = _factor_args(d, states)
    m_imu, m_pp = _masks(d)
    return (_masked(_whiten(L, _imu_residual(*imu)), m_imu),
            _masked(_bias_res(*bias), m_imu),
            _masked(_pose_prior_res(*pp), m_pp),
            _init_prior_res(*p0)[0])


def _all_residuals_and_jacs(d: ImuChainData, states, L):
    imu, bias, pp, p0 = _factor_args(d, states)
    m_imu, m_pp = _masks(d)
    r_imu, (Ji, Jj) = _with_jacobians(_imu_residual, imu, (0, 1))
    r_imu, Ji, Jj = (_masked(_whiten(L, x), m_imu) for x in (r_imu, Ji, Jj))
    r_b, (Jbi, Jbj) = _with_jacobians(_bias_res, bias, (0, 1))
    r_b, Jbi, Jbj = (_masked(x, m_imu) for x in (r_b, Jbi, Jbj))
    r_pp, (Jpp,) = _with_jacobians(_pose_prior_res, pp, (0,))
    r_pp, Jpp = _masked(r_pp, m_pp), _masked(Jpp, m_pp)
    r_0, (J_0,) = _with_jacobians(_init_prior_res, p0, (0,))
    return (r_imu, Ji, Jj), (r_b, Jbi, Jbj), (r_pp, Jpp), (r_0[0], J_0[0])


def _cost(d: ImuChainData, states, L):
    return sum((r * r).sum() for r in _all_residuals(d, states, L))


def _assemble(d: ImuChainData, states, L):
    """Dense H = J^T J and gradient J^T r of the chain.  Factor k joins
    states prev(k) = max(k-1, 0) and k, so every block lands on the
    diagonal or next to it: each is summed in place, in the JAX package's
    order of scatter-adds."""
    K = states.shape[0]
    S = STATE_DIM
    (r_imu, Ji, Jj), (r_b, Jbi, Jbj), (r_pp, Jpp), (r_0, J_0) = \
        _all_residuals_and_jacs(d, states, L)
    dev = states.device
    diag = torch.zeros(K, S, S, device=dev)
    up = torch.zeros(K - 1, S, S, device=dev)     # block (k-1, k)
    low = torch.zeros(K - 1, S, S, device=dev)    # block (k, k-1)
    gb = torch.zeros(K, S, device=dev)

    def outer(Ja, Jb):
        return torch.einsum("fab,fac->fbc", Ja, Jb)

    def add_prev(acc, x):
        """acc[prev(k)] += x[k]: x[k] at k-1 for k >= 1, x[0] at 0."""
        acc[:-1] += x[1:]
        acc[0] += x[0]

    for (r, Ja, Jb) in ((r_imu, Ji, Jj), (r_b, Jbi, Jbj)):
        ab, ba = outer(Ja, Jb), outer(Jb, Ja)
        add_prev(diag, outer(Ja, Ja))
        diag += outer(Jb, Jb)
        up += ab[1:]
        diag[0] += ab[0]
        low += ba[1:]
        diag[0] += ba[0]
        add_prev(gb, torch.einsum("fab,fa->fb", Ja, r))
        gb += torch.einsum("fab,fa->fb", Jb, r)
    diag += outer(Jpp, Jpp)
    gb += torch.einsum("fab,fa->fb", Jpp, r_pp)

    H = torch.zeros(K, S, K, S, device=dev)
    k = torch.arange(K, device=dev)
    H[k, :, k, :] = diag
    H[k[:-1], :, k[1:], :] = up
    H[k[1:], :, k[:-1], :] = low
    H = H.reshape(K * S, K * S)
    H[:S, :S] += J_0.T @ J_0
    grad = gb.reshape(-1)
    grad[:S] += J_0.T @ r_0
    return H, grad


def optimize_imu_chain_reference(d: ImuChainData, iterations: int = 5,
                                 accepts: list | None = None):
    """Plain PyTorch version of `optimize_imu_chain` on any device: the LM
    steps driven from the host.  accepts: a list that gets each step's
    accept flag (a bool tensor)."""
    K = d.states.shape[0]
    L = _whitener(d)
    active = d.state_mask.repeat_interleave(STATE_DIM)
    pin = torch.where(active, 0.0, 1.0)
    states = d.states
    cost = _cost(d, states, L)
    lam = torch.tensor(1e-4, device=states.device)
    for _ in range(iterations):
        H, grad = _assemble(d, states, L)
        # Jacobi preconditioning + relative damping: see
        # pose_graph.optimize_pose_graph for the float32 rationale
        dg = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-12)) + pin
        A = H / (dg[:, None] * dg[None, :]) + torch.diag(lam + pin)
        Lc, info = torch.linalg.cholesky_ex(A)
        dy = torch.cholesky_solve((-grad / dg)[:, None], Lc)[:, 0]
        dx = torch.where(active, dy / dg, 0.0)
        new_states = states + dx.reshape(K, STATE_DIM)
        new_cost = _cost(d, new_states, L)
        # a failed factorization is a rejected step (the JAX solve's NaN)
        accept = (info == 0) & (new_cost < cost)
        if accepts is not None:
            accepts.append(accept)
        states = torch.where(accept, new_states, states)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, torch.clamp(lam * 0.3, min=1e-6),
                          torch.clamp(lam * 4.0, max=1e6))
    return states, cost


def _check_chain(d: ImuChainData):
    """The kernel's contract: float32 (bool masks) of the chain's shapes,
    every tensor on the states' device."""
    K = d.states.shape[0] if d.states.dim() == 2 else 0
    f32, b8 = torch.float32, torch.bool
    want = {"states": ((K, STATE_DIM), f32), "state_mask": ((K,), b8),
            "preint_mask": ((K,), b8), "pose_meas": ((K, 6), f32),
            "pose_sigma": ((K, 6), f32), "pose_meas_mask": ((K,), b8),
            "prior_state": ((STATE_DIM,), f32),
            "prior_sigma": ((STATE_DIM,), f32), "bias_sigma": ((6,), f32),
            "gravity": ((), f32)}
    leaves = {"dR": (3, 3), "dv": (3,), "dp": (3,), "dt": (),
              "dR_dbg": (3, 3), "dv_dba": (3, 3), "dv_dbg": (3, 3),
              "dp_dba": (3, 3), "dp_dbg": (3, 3), "cov": (9, 9),
              "bias_acc": (3,), "bias_gyr": (3,)}
    tensors = {n: getattr(d, n) for n in want}
    for n, shape in leaves.items():
        want[f"preint.{n}"] = ((K, *shape), f32)
        tensors[f"preint.{n}"] = getattr(d.preint, n)
    if K == 0:
        raise ValueError(f"states must be float32 (K, 15) with K >= 1, got "
                         f"{d.states.dtype} {tuple(d.states.shape)}")
    for name, (shape, dtype) in want.items():
        t = tensors[name]
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != d.states.device:
            raise ValueError(f"{name} is on {t.device}, states on "
                             f"{d.states.device}")


def _contiguous(d: ImuChainData) -> ImuChainData:
    return ImuChainData(*(PreintState(*(t.contiguous() for t in x))
                          if isinstance(x, PreintState) else x.contiguous()
                          for x in d))


def optimize_imu_chain(d: ImuChainData, iterations: int = 5,
                       accepts: list | None = None):
    """LM over the masked IMU chain window; returns (states, cost).  CPU
    tensors run `optimize_imu_chain_reference`; CUDA tensors launch
    `fbpr_imu_chain_lm` (every iteration in one launch), or raise.
    accepts: a list that gets each step's accept flag (a bool tensor)."""
    dev = d.states.device
    if dev.type == "cpu":
        return optimize_imu_chain_reference(d, iterations, accepts)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_chain(d)
    d = _contiguous(d)
    K = d.states.shape[0]
    iterations = max(iterations, 0)
    states = torch.empty_like(d.states)
    cost = torch.empty((), dtype=torch.float32, device=dev)
    acc = torch.zeros(iterations, dtype=torch.int32, device=dev)
    scratch = torch.empty(kernels.imu_chain_floats(K), dtype=torch.float32,
                          device=dev)
    kernels.launch_imu_chain_lm(d, iterations, states, cost, acc, scratch)
    optimize_imu_chain.launches += 1
    if accepts is not None:
        accepts.extend(acc != 0)
    return states, cost


optimize_imu_chain.launches = 0


def chain_factor_blocks_reference(d: ImuChainData, states):
    """Plain PyTorch version of `chain_factor_blocks` on any device."""
    return _all_residuals_and_jacs(d, states, _whitener(d))


def chain_factor_blocks(d: ImuChainData, states):
    """Whitened per-factor residual/Jacobian blocks at `states`:
    ((r_imu, Ji, Jj), (r_b, Jbi, Jbj), (r_pp, Jpp), (r_0, J_0)).  CPU
    tensors run the plain version; CUDA tensors launch
    `fbpr_imu_chain_blocks`, or raise."""
    dev = d.states.device
    if states.device != dev:
        raise ValueError(f"states are on {states.device}, the chain on {dev}")
    if dev.type == "cpu":
        return chain_factor_blocks_reference(d, states)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    d = d._replace(states=states)
    _check_chain(d)
    d = _contiguous(d)
    K = states.shape[0]

    def e(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    out = ((e(K, 9), e(K, 9, STATE_DIM), e(K, 9, STATE_DIM)),
           (e(K, 6), e(K, 6, STATE_DIM), e(K, 6, STATE_DIM)),
           (e(K, 6), e(K, 6, STATE_DIM)),
           (e(STATE_DIM), e(STATE_DIM, STATE_DIM)))
    kernels.launch_imu_chain_blocks(d, d.states, out)
    chain_factor_blocks.launches += 1
    return out


chain_factor_blocks.launches = 0


def state_marginal_covariance(d: ImuChainData, states, idx: int):
    """15x15 marginal covariance of state `idx` — the carried prior for the
    window reset (ref: src/imuPreintegration.cpp:241-253 reads
    marginalCovariance(X/V/B(key-1)) into the new priors).  Blocks come
    off the device in float32; the Hessian assembles and solves on the host
    in float64 (see pose_graph.pose_marginal_covariances)."""
    states = torch.as_tensor(np.array(states, np.float32),
                             device=d.states.device)
    (r_imu, Ji, Jj), (r_b, Jbi, Jbj), (r_pp, Jpp), (r_0, J_0) = [
        [t.detach().cpu().numpy().astype(np.float64) for t in group]
        for group in chain_factor_blocks(d, states)]
    K = d.states.shape[0]
    D = K * STATE_DIM
    H = np.zeros((D, D))
    S = STATE_DIM
    ip = np.maximum(np.arange(K) - 1, 0)
    ic = np.arange(K)

    def add(ia, ib, Ja, Jb):
        blocks = np.einsum("fab,fac->fbc", Ja, Jb)
        for f in range(len(ia)):
            H[ia[f] * S:(ia[f] + 1) * S, ib[f] * S:(ib[f] + 1) * S] += blocks[f]

    for (Ja, Jb) in ((Ji, Jj), (Jbi, Jbj)):
        add(ip, ip, Ja, Ja)
        add(ic, ic, Jb, Jb)
        add(ip, ic, Ja, Jb)
        add(ic, ip, Jb, Ja)
    add(ic, ic, Jpp, Jpp)
    H[:S, :S] += J_0.T @ J_0
    active = np.repeat(d.state_mask.cpu().numpy(), S)
    H[np.diag_indices(D)] += np.where(active, 0.0, 1.0)

    rows = int(idx) * S + np.arange(S)
    E = np.zeros((D, S))
    E[rows, np.arange(S)] = 1.0
    X = np.linalg.solve(H, E)
    return X[rows]
