"""GPS fusion chain: EKF odometry + navsat transform (module_navsat analog).

Port of the JAX package's `pipeline/navsat.py`.  The reference's full
run.launch starts two robot_localization nodes (ref:
launch/include/module_navsat.launch:1-22, launch/run.launch:12-16):

  * ekf_localization_node ("ekf_gps"): a 15-state kinematic EKF fusing IMU
    and odometry into a continuous `odometry/navsat` stream,
  * navsat_transform_node ("navsat"): anchors the first GPS fix against
    the EKF odometry + IMU heading, then republishes every fix as
    odometry in the MAP frame (`odometry/gps`), which mapOptmization's
    addGPSFactor consumes (ref: config/params.yaml:5 gpsTopic,
    src/mapOptmization.h:1543-1634).

`EkfGps` is the 15-state EKF (position, orientation, body-frame velocity /
angular rate / linear acceleration — robot_localization's state vector)
with kinematic prediction and subset measurement updates, its predict and
update cores float32 ops on `device`; its state lives on the host as
NumPy, as in the JAX package.  `NavsatTransform` is the datum/anchor logic
(host NumPy).  Both keep the JAX package's behaviour where it departs from
robot_localization (ROADMAP Queue 3): `odometry(t)` advances the filter,
and `handle_fix` passes the fix's covariance through unrotated.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..geom.se3 import euler_to_rot

# state layout (robot_localization order, condensed):
#   [0:3]  position (world/map frame)
#   [3:6]  roll, pitch, yaw
#   [6:9]  velocity (BODY frame)
#   [9:12] angular velocity (body)
#   [12:15] linear acceleration (body)
N = 15


def _euler_rate_matrix(rpy):
    """Body angular velocity -> euler-angle rates (the EKF's orientation
    kinematics; robot_localization ekf.cpp uses the same small-angle-safe
    transform)."""
    r, p = rpy[0], rpy[1]
    sr, cr = torch.sin(r), torch.cos(r)
    cp = torch.clamp(torch.abs(torch.cos(p)), min=1e-4) * torch.sign(
        torch.where(torch.cos(p) == 0, 1.0, torch.cos(p)))
    tp = torch.sin(p) / cp
    one, zero = torch.ones_like(r), torch.zeros_like(r)
    return torch.stack([
        torch.stack([one, sr * tp, cr * tp]),
        torch.stack([zero, cr, -sr]),
        torch.stack([zero, sr / cp, cr / cp]),
    ])


def ekf_predict(x, P, dt, q_diag):
    """Kinematic predict: p += R(v dt + a dt^2/2); rpy += T w dt; v += a dt.

    F is the transition's Jacobian; its position/attitude block is the JAX
    package's float32 finite difference of R about rpy (eps = 1e-4),
    repeated as it is."""
    rpy = x[3:6]
    v, w, a = x[6:9], x[9:12], x[12:15]
    R = euler_to_rot(rpy[0], rpy[1], rpy[2])
    T = _euler_rate_matrix(rpy)

    dp_body = v * dt + 0.5 * a * dt * dt
    x_new = torch.cat([
        x[0:3] + R @ dp_body,
        rpy + T @ w * dt,
        v + a * dt,
        w,
        a,
    ])

    eps = 1e-4

    def dR_drpy(k):
        d = torch.zeros(3, device=x.device)
        d[k] = eps
        Rp = euler_to_rot(*(rpy + d))
        return (Rp - R) @ dp_body / eps

    J_p_rpy = torch.stack([dR_drpy(0), dR_drpy(1), dR_drpy(2)], 1)

    I3 = torch.eye(3, device=x.device)
    Z3 = torch.zeros(3, 3, device=x.device)
    F = torch.cat([
        torch.cat([I3, J_p_rpy, R * dt, Z3, R * (0.5 * dt * dt)], 1),
        torch.cat([Z3, I3, Z3, T * dt, Z3], 1),
        torch.cat([Z3, Z3, I3, Z3, I3 * dt], 1),
        torch.cat([Z3, Z3, Z3, I3, Z3], 1),
        torch.cat([Z3, Z3, Z3, Z3, I3], 1),
    ], 0)
    P_new = F @ P @ F.T + torch.diag(q_diag) * dt
    return x_new, P_new


def ekf_update(x, P, z, r_diag, h_mask):
    """Masked linear update: h_mask [N] selects measured state components
    (robot_localization's per-sensor config vector).  Angle components get
    wrapped innovations.  Unmeasured rows carry R=1e12 so the masked rows
    are inert — fixed shapes, no dynamic slicing; S is inverted as is
    (`torch.linalg.inv`, as the JAX package's `jnp.linalg.inv`)."""
    H = torch.diag(h_mask)
    innov = z - x
    # wrap angle innovations into [-pi, pi] (only slots 3:6)
    ang = torch.zeros(N, device=x.device)
    ang[3:6] = 1.0
    innov = torch.where(ang > 0,
                        torch.atan2(torch.sin(innov), torch.cos(innov)),
                        innov)
    innov = innov * h_mask
    R_eff = torch.diag(torch.where(h_mask > 0, r_diag, 1e12))
    S = H @ P @ H.T + R_eff
    K = P @ H.T @ torch.linalg.inv(S)
    x_new = x + K @ innov
    I_KH = torch.eye(N, device=x.device) - K @ H
    # Joseph form keeps P symmetric PSD under f32
    P_new = I_KH @ P @ I_KH.T + K @ R_eff @ K.T
    return x_new, P_new


class EkfGps:
    """ekf_localization_node analog ("ekf_gps",
    ref: launch/include/module_navsat.launch:8-10): 15-state kinematic EKF
    producing the continuous `odometry/navsat` stream; its predict and
    update run on `device` (required)."""

    def __init__(self, q_diag=None, *, device):
        self.device = torch.device(device)
        self.x = np.zeros(N, np.float32)
        self.P = np.eye(N, dtype=np.float32)
        if q_diag is None:
            # robot_localization's default process noise ordering: loose on
            # derivatives, tight on pose (it is measurement-driven)
            q_diag = np.array([0.05, 0.05, 0.06, 0.03, 0.03, 0.06,
                               0.025, 0.025, 0.04, 0.01, 0.01, 0.02,
                               0.01, 0.01, 0.015], np.float32)
        self.q_diag = self._dev(q_diag)
        self.t: Optional[float] = None

    def _dev(self, a):
        # a copy: on the CPU `as_tensor` would share the NumPy buffer
        return torch.tensor(np.asarray(a, np.float32), device=self.device)

    def _host(self, x, P):
        """x, P to the host in one copy."""
        xp = torch.cat([x, P.reshape(-1)]).cpu().numpy()
        self.x, self.P = xp[:N].copy(), xp[N:].reshape(N, N).copy()

    def _advance(self, t: float):
        if self.t is None:
            self.t = t
            return
        dt = t - self.t
        if dt > 0:
            self._host(*ekf_predict(self._dev(self.x), self._dev(self.P),
                                    self._dev(np.float32(dt)), self.q_diag))
        self.t = max(self.t, t)

    def _update(self, t, z):
        """z: dict state-slot -> (value, variance)."""
        self._advance(t)
        zrm = np.zeros((3, N), np.float32)        # z, r, mask
        zrm[1] = 1.0
        for slot, (zv, rv) in z.items():
            zrm[:, slot] = zv, rv, 1.0
        zf, rf, mf = self._dev(zrm)
        self._host(*ekf_update(self._dev(self.x), self._dev(self.P), zf, rf,
                               mf))

    def add_imu(self, t: float, rpy, gyro, accel_body=None,
                rpy_var=0.01, gyro_var=0.02):
        """imu_correct stream: absolute orientation + body angular rate
        (accel optional; KITTI oxts accel carries gravity so it is left out
        by default, like robot_localization's two-state imu config)."""
        z = {3 + k: (float(rpy[k]), rpy_var) for k in range(3)}
        z.update({9 + k: (float(gyro[k]), gyro_var) for k in range(3)})
        if accel_body is not None:
            z.update({12 + k: (float(accel_body[k]), 0.1) for k in range(3)})
        self._update(t, z)

    def add_odometry(self, t: float, pose6, pos_var=0.05, rot_var=0.02):
        """LIO/odometry pose update (the reference EKF fuses the LOAM
        odometry stream)."""
        z = {k: (float(pose6[3 + k]), pos_var) for k in range(3)}
        z.update({3 + k: (float(pose6[k]), rot_var) for k in range(3)})
        self._update(t, z)

    def add_velocity(self, t: float, vel_body, var=0.04):
        z = {6 + k: (float(vel_body[k]), var) for k in range(3)}
        self._update(t, z)

    def odometry(self, t: Optional[float] = None):
        """The `odometry/navsat` sample at time t (predict-forward: like the
        JAX package's, it advances the filter state)."""
        if t is not None:
            self._advance(t)
        pose6 = np.concatenate([self.x[3:6], self.x[0:3]]).astype(np.float32)
        cov = self.P[:6, :6].copy()
        return pose6, cov


class NavsatTransform:
    """navsat_transform_node analog (ref: module_navsat.launch:13-18):
    anchors the ENU GPS frame to the EKF's map frame at the first fix,
    using the EKF pose + IMU heading as the datum, then republishes every
    GPS fix as map-frame odometry (`odometry/gps`) with its covariance.

    Host NumPy, as in the JAX package; the lat/lon -> meters mapping lives
    with the KITTI reader.  This class consumes already-metric ENU fixes and
    owns only the datum/alignment logic.
    """

    def __init__(self, ekf: EkfGps):
        self.ekf = ekf
        self._anchor_enu: Optional[np.ndarray] = None
        self._R_map_enu: Optional[np.ndarray] = None
        self._t_map: Optional[np.ndarray] = None

    @property
    def initialized(self) -> bool:
        return self._anchor_enu is not None

    def handle_fix(self, t: float, enu_xyz, cov3, imu_yaw: float = None):
        """One gps/fix sample (already ENU meters).  Returns the
        `odometry/gps` sample (xyz map-frame, cov3), always: the first fix
        sets the datum (the EKF pose, and the IMU yaw when given) and comes
        back as the EKF's position.  The covariance is passed through
        without rotating it into the map frame, as in the JAX package."""
        enu_xyz = np.asarray(enu_xyz, np.float64)
        pose6, _ = self.ekf.odometry(t)
        if self._anchor_enu is None:
            # datum: first fix <-> current EKF pose; yaw from IMU when
            # given (navsat_transform's yaw_offset + datum logic)
            yaw = float(imu_yaw) if imu_yaw is not None else float(pose6[2])
            map_yaw = float(pose6[2])
            dyaw = map_yaw - yaw
            c, s = np.cos(dyaw), np.sin(dyaw)
            self._R_map_enu = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
            self._anchor_enu = enu_xyz.copy()
            self._t_map = pose6[3:6].astype(np.float64)
        xyz_map = self._R_map_enu @ (enu_xyz - self._anchor_enu) + self._t_map
        cov_map = np.asarray(cov3, np.float64).copy()
        return xyz_map.astype(np.float32), cov_map.astype(np.float32)
