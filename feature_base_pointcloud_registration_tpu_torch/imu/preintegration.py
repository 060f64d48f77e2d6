"""IMU preintegration on SO(3)xR6, replacing gtsam::PreintegratedImuMeasurements.

Port of the JAX package's `imu/preintegration.py`.  The reference delegates
all IMU math to GTSAM (ref: src/imuPreintegration.cpp:52-53,115-116,
integrateMeasurement at :283-285,440-441, predict at :324,446); this is the
same manifold preintegration (Forster et al., "On-Manifold
Preintegration"):

  dR <- dR Exp(w dt), dv <- dv + dR a dt, dp <- dp + dv dt + 1/2 dR a dt^2

with first-order bias Jacobians and 9x9 (theta, v, p) covariance
propagation, in float32 and in the JAX package's order of operations.

The JAX package scans a fixed-size masked buffer, where a masked slot
leaves the state unchanged.  Here the mask is read on the host and only the
live samples are integrated (each one a chain of small device ops): the
result is the same, and a 1024-slot buffer with 20 live samples costs 20
steps, not 1024.  What does not depend on the running state (the bias-
corrected samples, Exp(w dt), the right Jacobian) is computed for all live
samples at once before the serial chain.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geom.se3 import so3_exp


def _hat(v):
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], -1),
        torch.stack([z, zero, -x], -1),
        torch.stack([-y, x, zero], -1),
    ], -2)


def _right_jacobian(w):
    """Right Jacobian of SO(3): Jr(w) = I - (1-cos)/t^2 [w]x + (t-sin)/t^3 [w]x^2."""
    theta2 = torch.sum(w * w, -1)
    theta = torch.sqrt(theta2)
    W = _hat(w)
    W2 = W @ W
    small = theta < 1e-5
    t2s = torch.where(small, 1.0, theta2)
    a = torch.where(small, 0.5, (1.0 - torch.cos(theta)) / t2s)
    b = torch.where(small, 1.0 / 6.0,
                    (theta - torch.sin(theta))
                    / torch.where(small, 1.0, theta2 * theta))
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye - a[..., None, None] * W + b[..., None, None] * W2


def _live(mask, n):
    """Host indices of the live slots of a mask (numpy, tensor or None)."""
    if mask is None:
        return np.arange(n)
    if isinstance(mask, torch.Tensor):
        mask = mask.cpu().numpy()
    return np.flatnonzero(np.asarray(mask, bool))


class NavState(NamedTuple):
    """Pose + velocity (gtsam::NavState equivalent)."""

    R: torch.Tensor  # f32 [3,3]
    p: torch.Tensor  # f32 [3]
    v: torch.Tensor  # f32 [3]

    @staticmethod
    def identity(*, device):
        return NavState(torch.eye(3, device=device),
                        torch.zeros(3, device=device),
                        torch.zeros(3, device=device))


class PreintState(NamedTuple):
    """Preintegrated IMU measurement between two correction times."""

    dR: torch.Tensor       # [3,3]
    dv: torch.Tensor       # [3]
    dp: torch.Tensor       # [3]
    dt: torch.Tensor       # [] total integration time (deltaTij)
    # first-order bias Jacobians
    dR_dbg: torch.Tensor   # [3,3]
    dv_dba: torch.Tensor   # [3,3]
    dv_dbg: torch.Tensor   # [3,3]
    dp_dba: torch.Tensor   # [3,3]
    dp_dbg: torch.Tensor   # [3,3]
    cov: torch.Tensor      # [9,9] (theta, v, p)
    bias_acc: torch.Tensor  # [3] linearization point
    bias_gyr: torch.Tensor  # [3]

    @staticmethod
    def zero(bias_acc=None, bias_gyr=None, *, device):
        def z(*shape):
            return torch.zeros(shape, device=device)

        return PreintState(
            dR=torch.eye(3, device=device), dv=z(3), dp=z(3), dt=z(),
            dR_dbg=z(3, 3), dv_dba=z(3, 3), dv_dbg=z(3, 3), dp_dba=z(3, 3),
            dp_dbg=z(3, 3), cov=z(9, 9),
            bias_acc=bias_acc if bias_acc is not None else z(3),
            bias_gyr=bias_gyr if bias_gyr is not None else z(3))


def _integrate(state: PreintState, a, dt, dRk, Jr, A_hat, noise, int_noise):
    """One IMU sample on the running state, its state-free terms given:
    a the bias-corrected accel, dRk = Exp(w dt), Jr = Jr(w dt), A_hat =
    [a]x, noise the 6 diagonal noise densities over dt, int_noise the
    [9, 9] integration-noise increment."""
    dR = state.dR
    dR_a = dR @ a
    dR_new = dR @ dRk
    dv_new = state.dv + dR_a * dt
    dp_new = state.dp + state.dv * dt + 0.5 * dR_a * dt * dt

    dR_Ahat = dR @ A_hat
    dR_Ahat_dRdbg = dR_Ahat @ state.dR_dbg

    dp_dba = state.dp_dba + state.dv_dba * dt - 0.5 * dR * dt * dt
    dp_dbg = state.dp_dbg + state.dv_dbg * dt - 0.5 * dR_Ahat_dRdbg * dt * dt
    dv_dba = state.dv_dba - dR * dt
    dv_dbg = state.dv_dbg - dR_Ahat_dRdbg * dt
    dR_dbg = dRk.T @ state.dR_dbg - Jr * dt

    # covariance propagation, state order (theta, v, p)
    Z = torch.zeros_like(dR)
    eye = torch.eye(3, dtype=dR.dtype, device=dR.device)
    A = torch.cat([
        torch.cat([dRk.T, Z, Z], 1),
        torch.cat([-dR_Ahat * dt, eye, Z], 1),
        torch.cat([-0.5 * dR_Ahat * dt * dt, eye * dt, eye], 1),
    ], 0)
    Jrdt = Jr * dt
    dRdt = dR * dt
    B = torch.cat([
        torch.cat([Jrdt, Z], 1),
        torch.cat([Z, dRdt], 1),
        torch.cat([Z, 0.5 * dRdt * dt], 1),
    ], 0)
    cov = (A @ state.cov) @ A.T + (B * noise[None, :]) @ B.T
    # integration (position) noise, like gtsam integrationCovariance
    cov = cov + int_noise
    return state._replace(
        dR=dR_new, dv=dv_new, dp=dp_new, dt=state.dt + dt,
        dR_dbg=dR_dbg, dv_dba=dv_dba, dv_dbg=dv_dbg,
        dp_dba=dp_dba, dp_dbg=dp_dbg, cov=cov)


def _sample_terms(acc, gyr, dt, bias_acc, bias_gyr, acc_noise_var,
                  gyr_noise_var, int_noise_var):
    """The state-free terms of samples [n] (see `_integrate`)."""
    a = acc - bias_acc
    w = gyr - bias_gyr
    wdt = w * dt[:, None]
    dt_safe = torch.clamp(dt, min=1e-9)
    ones = torch.ones(3, dtype=acc.dtype, device=acc.device)
    noise = torch.cat([(ones * gyr_noise_var)[None] / dt_safe[:, None],
                       (ones * acc_noise_var)[None] / dt_safe[:, None]], 1)
    E = torch.zeros(9, 9, dtype=acc.dtype, device=acc.device)
    E[6:, 6:] = torch.eye(3, dtype=acc.dtype, device=acc.device)
    int_noise = E * int_noise_var * dt[:, None, None]
    return a, so3_exp(wdt), _right_jacobian(wdt), _hat(a), noise, int_noise


def integrate_measurement(state: PreintState, acc, gyr, dt,
                          acc_noise_var, gyr_noise_var, int_noise_var):
    """One IMU sample (gtsam integrateMeasurement equivalent); acc, gyr [3],
    dt [] tensors."""
    terms = _sample_terms(acc[None], gyr[None], dt.reshape(1),
                          state.bias_acc, state.bias_gyr, acc_noise_var,
                          gyr_noise_var, int_noise_var)
    return _integrate(state, terms[0][0], dt, *(t[0] for t in terms[1:]))


def preintegrate(acc, gyr, dt, mask, bias_acc, bias_gyr,
                 acc_noise_var, gyr_noise_var, int_noise_var=1e-8):
    """Integrate the live samples of a buffer into one PreintState.

    acc, gyr: [N,3]; dt: [N] tensors on the device; mask: [N] (numpy,
    tensor or None = all live; read on the host) — masked samples are
    skipped, as the JAX scan skips them."""
    live = _live(mask, acc.shape[0])
    state = PreintState.zero(bias_acc, bias_gyr, device=acc.device)
    if len(live) == 0:
        return state
    idx = torch.from_numpy(live).to(acc.device)
    dts = dt[idx]
    a, dRk, Jr, A_hat, noise, int_noise = _sample_terms(
        acc[idx], gyr[idx], dts, bias_acc, bias_gyr, acc_noise_var,
        gyr_noise_var, int_noise_var)
    for k in range(len(live)):
        state = _integrate(state, a[k], dts[k], dRk[k], Jr[k], A_hat[k],
                           noise[k], int_noise[k])
    return state


def bias_corrected_delta(pre: PreintState, bias_acc, bias_gyr):
    """First-order bias correction of (dR, dv, dp) around the linearization
    point — what gtsam's biasCorrectedDelta does inside predict/ImuFactor."""
    dba = bias_acc - pre.bias_acc
    dbg = bias_gyr - pre.bias_gyr
    dR = pre.dR @ so3_exp(pre.dR_dbg @ dbg)
    dv = pre.dv + pre.dv_dba @ dba + pre.dv_dbg @ dbg
    dp = pre.dp + pre.dp_dba @ dba + pre.dp_dbg @ dbg
    return dR, dv, dp


def predict(nav: NavState, bias_acc, bias_gyr, pre: PreintState,
            gravity: float = 9.80511) -> NavState:
    """Propagate a NavState through a preintegrated interval
    (gtsam predict, ref usage: src/imuPreintegration.cpp:324,446)."""
    g = torch.tensor([0.0, 0.0, -gravity], device=nav.p.device)
    dR, dv, dp = bias_corrected_delta(pre, bias_acc, bias_gyr)
    R_new = nav.R @ dR
    v_new = nav.v + g * pre.dt + nav.R @ dv
    p_new = (nav.p + nav.v * pre.dt + 0.5 * g * pre.dt * pre.dt
             + nav.R @ dp)
    return NavState(R=R_new, p=p_new, v=v_new)


def failure_detection(vel, bias_acc, bias_gyr,
                      vel_limit: float = 30.0, bias_limit: float = 1.0):
    """Reset trigger: |v| > 30 m/s or bias norm > 1
    (ref: src/imuPreintegration.cpp:392-411).  A bool tensor."""
    return ((torch.linalg.norm(vel) > vel_limit)
            | (torch.linalg.norm(bias_acc) > bias_limit)
            | (torch.linalg.norm(bias_gyr) > bias_limit))


def propagate_states(nav: NavState, bias_acc, bias_gyr, acc, gyr, dt, mask,
                     gravity=9.80511):
    """NavState at every IMU sample time (the imuHandler prediction stream,
    ref: src/imuPreintegration.cpp:440-446 per sample).

    acc, gyr: [N,3]; dt: [N] tensors; mask: [N] (numpy, tensor or None;
    read on the host).  Returns NavState with leading [N]; a masked sample
    repeats the state before it, as in the JAX scan."""
    n = acc.shape[0]
    live = set(_live(mask, n).tolist())
    g = torch.tensor([0.0, 0.0, -gravity], device=acc.device)
    a_c = acc - bias_acc
    w_c = gyr - bias_gyr
    dRs = so3_exp(w_c * dt[:, None])
    out = []
    for k in range(n):
        if k in live:
            d = dt[k]
            acc_w = nav.R @ a_c[k] + g
            nav = NavState(R=nav.R @ dRs[k],
                           p=nav.p + nav.v * d + 0.5 * acc_w * d * d,
                           v=nav.v + acc_w * d)
        out.append(nav)
    return NavState(*(torch.stack(f) for f in zip(*out)))
