"""IMU chain windows and sample buffers for the IMU kernels
(`graph/imu_graph.py`, `imu/preintegration.py`), made from seeds with numpy
and the port's plain preintegration on the CPU: no JAX, so the GPU tests
and chip_smoke.py use them.

A window is ImuOdometry's: state k at the end of interval k (20 samples of
a 100 Hz IMU, the 0.2 s of a LIO step), interval k preintegrated at the
bias the state before it held, slot 0 without a preintegration, pose
measurements at the truth (sigma 1e-2), the prior on state 0 at its value
with ImuOdometry's first sigmas, the bias random walk of default Params;
the states 1.. moved 1e-2 off the truth in pose and velocity.

  full             K 16 all live (phase 9's window; ImuOdometry at
                   imu_window=16), dbg = bg - bias_gyr exactly 0
  reset            K 16, 2 live: the window just after a reset
  interior_masked  K 16, state 7 masked (the factor into it masked, the one
                   out of it live: an inactive, pinned state in H)
  no_preint        K 16, state 9 live with no preintegration
  k1               K 1: the prior and a pose measurement 1e-2 off it
  nan_cov          full, interval 5's covariance NaN (the whitening fails:
                   every step rejected, the cost NaN)
  pitch_half_pi    a pitch near pi/2, state 4 (and its measurement) at
                   pitch pi/2 exactly (gimbal lock of the Euler angles)
  roll_near_pi     roll crossing pi in the window (the angles wrap)
  dbg_nonzero      full with the states' biases off the linearization
                   point (dbg != 0 at the first iteration)
  near_pi_axis     full with state 3 at zero angles and its measurement
                   at roll pi - 0.1: the pose prior's so3_log near pi about
                   an axis (sqrt(0)'s non-finite Jacobian entries; every
                   step rejected)
  k100             K 100, all live (the reference's reset interval; GPU
                   only)

`scene(name, device, K=None)` returns the port's ImuChainData (K: the
scene at another window size); `buffer(kind, device)` a sample buffer for
preintegrate / propagate_states (`BUFFERS`); `preint_agreement` holds the
preintegration kernel's leaves to its plain version's, and above
`PREINT_SHORT` live samples both to a float64 run of the plain version.
"""

import numpy as np
import torch

from feature_base_pointcloud_registration_tpu_torch.config import Params
from feature_base_pointcloud_registration_tpu_torch.graph.imu_graph import (
    ImuChainData)
from feature_base_pointcloud_registration_tpu_torch.imu.preintegration import (  # noqa: E501
    PreintState, preintegrate_reference)

G = 9.80511
PER = 20          # samples an interval
HZ = 100.0
CPU_SCENES = ("full", "reset", "interior_masked", "no_preint", "k1",
              "nan_cov", "pitch_half_pi", "roll_near_pi", "dbg_nonzero",
              "near_pi_axis")
SCENES = CPU_SCENES + ("k100",)
_P = Params()
ACC_VAR = np.float32(_P.imu_acc_noise ** 2)
GYR_VAR = np.float32(_P.imu_gyr_noise ** 2)
PRIOR_SIGMA = np.concatenate([np.full(6, 1e-2), np.full(3, 1e4),
                              np.full(6, 1e-3)]).astype(np.float32)
BIAS_SIGMA = np.array([_P.imu_acc_bias_n] * 3 + [_P.imu_gyr_bias_n] * 3,
                      np.float32)


def rot(rpy):
    """R = Rz(yaw) Ry(pitch) Rx(roll), float64."""
    cr, sr, cp, sp, cy, sy = (np.cos(rpy[0]), np.sin(rpy[0]),
                              np.cos(rpy[1]), np.sin(rpy[1]),
                              np.cos(rpy[2]), np.sin(rpy[2]))
    return np.array([[cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr],
                     [sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr],
                     [-sp, cp * sr, cp * cr]])


def rpy_of(R):
    return np.array([np.arctan2(R[2, 1], R[2, 2]),
                     np.arcsin(np.clip(-R[2, 0], -1.0, 1.0)),
                     np.arctan2(R[1, 0], R[0, 0])])


def exp3(w):
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def stream(n, seed, rpy0=(0.0, 0.0, 0.0), w=(0.02, -0.01, 0.15),
           ba=(0.02, -0.01, 0.03), bg=(0.004, -0.002, 0.001)):
    """n IMU samples at HZ of a platform turning at w (rad/s, body) with a
    small wobble, accelerating gently in the world: measured acc and gyr
    (biased by ba, bg, with white noise), dt, and the truth (R, p, v) after
    each sample, all float64."""
    r = np.random.RandomState(seed)
    dt = 1.0 / HZ
    g = np.array([0.0, 0.0, -G])
    R, p, v = rot(rpy0), np.zeros(3), np.array([1.2, 0.0, 0.0])
    acc, gyr, truth = [], [], []
    for k in range(n):
        wk = np.asarray(w) + 0.05 * np.sin(0.3 * k + np.arange(3))
        a_w = np.array([0.3 * np.cos(0.05 * k), 0.2, 0.05 * np.sin(0.1 * k)])
        f = R.T @ (a_w - g)
        acc.append(f + ba + r.normal(0, 0.01, 3))
        gyr.append(wk + bg + r.normal(0, 0.001, 3))
        p = p + v * dt + 0.5 * a_w * dt * dt
        v = v + a_w * dt
        R = R @ exp3(wk * dt)
        truth.append((R, p, v))
    return (np.array(acc), np.array(gyr), np.full(n, dt), truth,
            (rot(rpy0), np.zeros(3), np.array([1.2, 0.0, 0.0])))


def _window(K, seed, rpy0=(0.0, 0.0, 0.0), w=(0.02, -0.01, 0.15),
            bias_off=(0.0, 0.0)):
    """K states over K - 1 intervals of a stream (numpy): states, preint
    leaves [K, ...], pose measurements."""
    acc, gyr, dt, truth, start = stream(max(K - 1, 0) * PER, seed, rpy0, w)
    r = np.random.RandomState(seed + 1)
    ba_lin = np.array([0.015, -0.005, 0.02], np.float32)
    bg_lin = np.array([0.003, -0.001, 0.002], np.float32)
    pres = [PreintState.zero(device="cpu")]
    for k in range(1, K):
        sl = slice((k - 1) * PER, k * PER)
        pres.append(preintegrate_reference(
            *(torch.from_numpy(a[sl].astype(np.float32))
              for a in (acc, gyr, dt)), None, torch.from_numpy(ba_lin),
            torch.from_numpy(bg_lin), ACC_VAR, GYR_VAR))
    leaves = [torch.stack(f).numpy() for f in zip(*pres)]
    states = np.zeros((K, 15), np.float32)
    meas = np.zeros((K, 6), np.float32)
    for k in range(K):
        R, p, v = start if k == 0 else truth[k * PER - 1]
        meas[k] = np.concatenate([rpy_of(R), p])
        states[k, :9] = np.concatenate([rpy_of(R), p, v])
        states[k, 9:12] = ba_lin + bias_off[0]
        states[k, 12:15] = bg_lin + bias_off[1]
    states[1:, :9] += r.normal(0, 1e-2, (K - 1, 9)).astype(np.float32)
    return states, leaves, meas


def scene_arrays(name, K=None):
    """The scene's ImuChainData fields as numpy arrays (the preint leaves a
    list of twelve); K: another window size for the scene."""
    K = K or {"k1": 1, "k100": 100}.get(name, 16)
    kw = {"pitch_half_pi": dict(rpy0=(0.0, np.pi / 2 - 0.04, 0.2),
                                w=(0.0, 0.05, 0.02)),
          "roll_near_pi": dict(rpy0=(np.pi - 0.15, 0.05, 0.3),
                               w=(0.5, 0.0, 0.05)),
          "dbg_nonzero": dict(bias_off=(0.01, 0.002))}.get(name, {})
    states, leaves, meas = _window(K, seed=7 + len(name), **kw)
    state_mask = np.ones(K, bool)
    preint_mask = np.arange(K) > 0
    if name == "reset":
        state_mask[2:] = False
        preint_mask[2:] = False
        states[2:] = 0.0
        meas[2:] = 0.0
    if name == "interior_masked":
        state_mask[7] = False
    if name == "no_preint":
        preint_mask[9] = False
    if name == "nan_cov":
        leaves[9][5] = np.nan
    if name == "pitch_half_pi":
        states[4, 1] = meas[4, 1] = np.float32(np.pi / 2)
    if name == "near_pi_axis":
        states[3, :3] = 0.0
        meas[3, :3] = [np.pi - 0.1, 0.0, 0.0]
    if name == "k1":
        meas[0] += np.float32(0.01)
    return dict(states=states, state_mask=state_mask, preint=leaves,
                preint_mask=preint_mask, pose_meas=meas,
                pose_sigma=np.full((K, 6), 1e-2, np.float32),
                pose_meas_mask=state_mask.copy(),
                prior_state=states[0].copy(), prior_sigma=PRIOR_SIGMA.copy(),
                bias_sigma=BIAS_SIGMA.copy(), gravity=np.float32(G))


def scene(name, device="cpu", K=None):
    """The port's ImuChainData of a scene on `device` (K: another window
    size)."""
    a = scene_arrays(name, K)

    def t(x):
        return torch.from_numpy(np.array(x)).to(device)

    return ImuChainData(**{k: (PreintState(*(t(x) for x in v))
                               if k == "preint" else t(v))
                           for k, v in a.items()})


BUFFERS = ("phase9", "cap64", "buffer1024", "none_live")
# the preintegration kernels' edge buffers (tests/preint_chain.py's orders,
# the GPU tests, chip_smoke.py --imu-ab); the last two are not finite
EDGE_BUFFERS = ("one_live", "first_last_masked", "dt_zero", "near_pi",
                "n97", "acc_overflow", "dt_huge")
NONFINITE_BUFFERS = ("acc_overflow", "dt_huge")


def buffer_arrays(kind):
    """A sample buffer (acc, gyr [N, 3], dt [N] float32, mask [N] bool or
    None, bias_acc, bias_gyr [3]): "phase9" one LIO interval (19 samples,
    all live, mask None); "cap64" a 64-sample interval with a masked tail
    and a masked sample inside; "buffer1024" ImuOdometry's default buffer
    with interior masked samples (~70% live); "none_live" no live sample.
    The edge buffers: "one_live" 8 slots, slot 3 live; "first_last_masked"
    40 slots, the first and the last masked; "dt_zero" 24 live slots, dt 0
    at slots 0, 7 and 8; "near_pi" 24 live, slot 5 turning pi - 1e-3 about
    an axis; "n97" 97 slots (a multiple of no chunk), ~80% live;
    "acc_overflow" 24 live, slot 5's accel 1e30 (cov overflows to inf and
    NaN after it); "dt_huge" 24 live, slot 9's dt 1e20 with w = 0 (its
    noise input B overflows, Exp and Jr stay exact)."""
    n = {"phase9": 19, "cap64": 64, "buffer1024": 1024,
         "first_last_masked": 40, "dt_zero": 24, "near_pi": 24, "n97": 97,
         "acc_overflow": 24, "dt_huge": 24}.get(kind, 8)
    acc, gyr, dt, _, _ = stream(n, seed=len(kind))
    r = np.random.RandomState(3)
    dt = (dt * (1.0 + 0.1 * r.uniform(-1, 1, n))).astype(np.float32)
    ba = np.array([0.02, -0.01, 0.03], np.float32)
    bg = np.array([0.004, -0.002, 0.001], np.float32)
    mask = None
    if kind == "cap64":
        mask = np.arange(n) < 50
        mask[17] = False
        acc[17], gyr[17], dt[17] = 50.0, -3.0, 0.5   # garbage, masked
    elif kind == "buffer1024":
        mask = r.uniform(size=n) < 0.7
    elif kind == "none_live":
        mask = np.zeros(n, bool)
    elif kind == "one_live":
        mask = np.arange(n) == 3
    elif kind == "first_last_masked":
        mask = np.ones(n, bool)
        mask[0] = mask[-1] = False
    elif kind == "dt_zero":
        dt[[0, 7, 8]] = 0.0
    elif kind == "near_pi":
        axis = np.array([1.0, 2.0, 2.0]) / 3.0
        gyr[5] = bg + axis * (np.pi - 1e-3) / dt[5]
    elif kind == "n97":
        mask = r.uniform(size=n) < 0.8
    elif kind == "acc_overflow":
        acc[5] = 1e30
    elif kind == "dt_huge":
        gyr[9], dt[9] = bg, 1e20
    return (acc.astype(np.float32), gyr.astype(np.float32), dt, mask, ba,
            bg)


def buffer(kind, device="cpu"):
    acc, gyr, dt, mask, ba, bg = buffer_arrays(kind)

    def t(x):
        return torch.from_numpy(x).to(device)

    return (t(acc), t(gyr), t(dt),
            None if mask is None else t(mask), t(ba), t(bg))


# live samples up to which the preintegration kernel holds the CPU bounds
# of tests/test_torch_imu.py
# against its plain version; above, the float32 rounding of two orders of
# the same operations walks apart (the plain version's 3x3 and 9x9
# products run in cuBLAS on the card)
PREINT_SHORT = 64


def preintegrate_float64(args, kw):
    """preintegrate_reference(*args, **kw) on the CPU in float64."""
    def f64(x):
        if isinstance(x, torch.Tensor):
            return x.cpu().double() if x.is_floating_point() else x.cpu()
        return float(x) if isinstance(x, np.floating) else x

    old = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)
    try:
        return preintegrate_reference(*map(f64, args),
                                      **{k: f64(v) for k, v in kw.items()})
    finally:
        torch.set_default_dtype(old)


def _float64_distance(state, exact):
    """(the leaves' largest |state - exact| over max(1, the leaf's largest),
    cov's over its largest entry)."""
    rel = {f: float((a.double().cpu() - b).abs().max())
           / (float(b.abs().max()) if f == "cov" else
              max(1.0, float(b.abs().max())))
           for f, a, b in zip(state._fields, state, exact)}
    return max(v for f, v in rel.items() if f != "cov"), rel["cov"]


def preint_agreement(got, want, args, kw):
    """The preintegration kernel's leaves (got) against its plain version's
    (want), both of preintegrate(*args, **kw): up to PREINT_SHORT live
    samples the CPU bounds of tests/test_torch_imu.py (the leaves within
    1e-6 of max(1, their largest entry), cov within rtol 1e-5 with a floor
    of 1e-7 of its largest entry); above,
    1e-5 and a floor of 1e-6, held only where the kernel is as near a
    float64 run of the plain version as the plain version is, by the
    leaves' and by cov's figure, within a factor of 2: both are float32
    orders of the same operations, and either may land nearer (on the
    1024-sample buffer on an H100 the kernel 2.774e-06 and 6.938e-06, the
    plain version 3.018e-06 and 6.818e-06).  Returns (ok, report): |diff|
    max by leaf, the cov floor the kernel needs and the two float64
    distances."""
    mask = args[3]
    live = (args[0].shape[0] if mask is None
            else int(torch.as_tensor(mask).sum()))
    short = live <= PREINT_SHORT
    rel, floor = (1e-6, 1e-7) if short else (1e-5, 1e-6)
    errs, ok = {}, True
    for f, a, b in zip(got._fields, got, want):
        errs[f] = float((a - b).abs().max())
        if f == "cov":
            top = max(float(b.abs().max()), 1e-30)
            need = float(((a - b).abs() - 1e-5 * b.abs()).max()) / top
            ok &= need <= floor
        else:
            ok &= errs[f] <= rel * max(1.0, float(b.abs().max()))
    report = dict(live=live, errs=errs, cov_floor_needed=need)
    if not short:
        exact = preintegrate_float64(args, kw)
        k64, p64 = (_float64_distance(s, exact) for s in (got, want))
        report.update(kernel_f64=k64, plain_f64=p64)
        ok &= k64[0] <= 2 * p64[0] and k64[1] <= 2 * p64[1]
    return bool(ok), report
