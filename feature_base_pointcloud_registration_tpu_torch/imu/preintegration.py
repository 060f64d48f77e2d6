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
leaves the state unchanged (two compiled device loops, `lax.scan`).
`preintegrate` and `propagate_states` dispatch by the samples' device:

  * CPU tensors run `preintegrate_reference` / `propagate_states_reference`:
    the mask read on the host and only the live samples integrated, each
    one a chain of small device ops (the result is the same, and a
    1024-slot buffer with 20 live samples costs 20 steps, not 1024); what
    does not depend on the running state (the bias-corrected samples,
    Exp(w dt), the right Jacobian) is computed for all live samples at
    once before the serial chain;
  * CUDA tensors launch `csrc/preintegration.cu` (`fbpr_preintegrate`,
    `fbpr_propagate_states`): one launch a call, the mask read on the
    device, nothing read back;
  * any other device raises.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels
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


def preintegrate_reference(acc, gyr, dt, mask, bias_acc, bias_gyr,
                           acc_noise_var, gyr_noise_var, int_noise_var=1e-8):
    """Plain PyTorch version of `preintegrate` on any device (the mask read
    on the host)."""
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


def propagate_states_reference(nav: NavState, bias_acc, bias_gyr, acc, gyr,
                               dt, mask, gravity=9.80511):
    """Plain PyTorch version of `propagate_states` on any device (the mask
    read on the host)."""
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


def _device_mask(mask, n, dev):
    """The mask as a contiguous bool [n] tensor on dev (an upload from a
    host array or tensor), or None (every sample live)."""
    if mask is None:
        return None
    m = torch.as_tensor(np.asarray(mask, bool) if not isinstance(
        mask, torch.Tensor) else mask, device=dev).to(torch.bool)
    if tuple(m.shape) != (n,):
        raise ValueError(f"mask must be [{n}], got {tuple(m.shape)}")
    return m.contiguous()


def _samples(acc, gyr, dt):
    """acc, gyr [N, 3] and dt [N]: float32, contiguous, on acc's device."""
    n = acc.shape[0]
    for name, t, shape in (("acc", acc, (n, 3)), ("gyr", gyr, (n, 3)),
                           ("dt", dt, (n,))):
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != acc.device:
            raise ValueError(f"{name} is on {t.device}, acc on {acc.device}")
    return acc.contiguous(), gyr.contiguous(), dt.contiguous()


def _vec3(x, dev):
    """A bias: float32 [3] on dev."""
    t = torch.as_tensor(x, dtype=torch.float32, device=dev)
    if tuple(t.shape) != (3,):
        raise ValueError(f"a bias must be [3], got {tuple(t.shape)}")
    return t.contiguous()


def preintegrate(acc, gyr, dt, mask, bias_acc, bias_gyr,
                 acc_noise_var, gyr_noise_var, int_noise_var=1e-8):
    """Integrate the live samples of a buffer into one PreintState.

    acc, gyr: [N,3]; dt: [N] tensors on the device; mask: [N] (numpy,
    tensor or None = all live) — masked samples are skipped, as the JAX
    scan skips them.  CPU tensors run `preintegrate_reference`; CUDA
    tensors launch `fbpr_preintegrate` (the mask on the device), or
    raise."""
    dev = acc.device
    if dev.type == "cpu":
        return preintegrate_reference(acc, gyr, dt, mask, bias_acc, bias_gyr,
                                      acc_noise_var, gyr_noise_var,
                                      int_noise_var)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    acc, gyr, dt = _samples(acc, gyr, dt)
    m = _device_mask(mask, acc.shape[0], dev)
    ba, bg = _vec3(bias_acc, dev), _vec3(bias_gyr, dev)

    def e(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)

    out = PreintState(dR=e(3, 3), dv=e(3), dp=e(3), dt=e(), dR_dbg=e(3, 3),
                      dv_dba=e(3, 3), dv_dbg=e(3, 3), dp_dba=e(3, 3),
                      dp_dbg=e(3, 3), cov=e(9, 9), bias_acc=e(3),
                      bias_gyr=e(3))
    kernels.launch_preintegrate(
        acc, gyr, dt, m, ba, bg, out, acc_var=float(acc_noise_var),
        gyr_var=float(gyr_noise_var), int_var=float(int_noise_var))
    preintegrate.launches += 1
    return out


preintegrate.launches = 0


def propagate_states(nav: NavState, bias_acc, bias_gyr, acc, gyr, dt, mask,
                     gravity=9.80511):
    """NavState at every IMU sample time (the imuHandler prediction stream,
    ref: src/imuPreintegration.cpp:440-446 per sample).

    acc, gyr: [N,3]; dt: [N] tensors; mask: [N] (numpy, tensor or None).
    Returns NavState with leading [N]; a masked sample repeats the state
    before it, as in the JAX scan.  CPU tensors run
    `propagate_states_reference`; CUDA tensors launch
    `fbpr_propagate_states` (the mask on the device), or raise."""
    dev = acc.device
    if dev.type == "cpu":
        return propagate_states_reference(nav, bias_acc, bias_gyr, acc, gyr,
                                          dt, mask, gravity)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    acc, gyr, dt = _samples(acc, gyr, dt)
    n = acc.shape[0]
    if n == 0:
        raise ValueError("propagate_states needs at least one sample")
    m = _device_mask(mask, n, dev)
    nav = NavState(*(torch.as_tensor(t, dtype=torch.float32,
                                     device=dev).contiguous() for t in nav))
    if tuple(nav.R.shape) != (3, 3) or nav.p.shape != (3,) \
            or nav.v.shape != (3,):
        raise ValueError("nav must be R [3, 3], p [3], v [3]")
    out = NavState(torch.empty(n, 3, 3, device=dev),
                   torch.empty(n, 3, device=dev),
                   torch.empty(n, 3, device=dev))
    kernels.launch_propagate_states(
        nav, _vec3(bias_acc, dev), _vec3(bias_gyr, dev), acc, gyr, dt, m,
        out, gravity=float(gravity))
    propagate_states.launches += 1
    return out


propagate_states.launches = 0
