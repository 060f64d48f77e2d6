"""High-rate IMU odometry with factor-graph corrections.

Port of the JAX package's `pipeline/imu_odometry.py`, the functional
rebuild of the IMUPreintegration node (ref: src/imuPreintegration.cpp:
27-508): two preintegration streams — one feeding the optimizer, one
re-propagated after every correction to publish IMU-rate odometry — plus
the reset-id protocol and failure detection:

  imuHandler          (ref :413-507) -> handle_imu / flush_imu_odometry
  odometryHandler     (ref :144-390) -> handle_odometry
  key==100 window reset carrying marginal priors (ref :234-267)
      -> _reset_window (priors re-primed from the last optimized state)
  failureDetection    (ref :392-411) -> imu.failure_detection
  reset-id protocol   (ref :161-172) -> reset_id checks

The iSAM2 chain is graph/imu_graph's windowed LM, on `device`.  The queues
and the chain's host arrays are NumPy, as in the JAX package; the
preintegration window, the nav states and the biases live on the device.
A correction makes three copies to the host: the predicted state, the
optimized window and the failure test.

The reference integrates every IMU sample of an interval; this port, like
the JAX package, keeps the first `max_samples`, and reports the rest as an
`imu/dropped_samples` warn event (cap, dropped count).
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np
import torch

from ..config import Params
from ..geom.se3 import euler_to_rot, rot_to_euler
from ..graph.imu_graph import (STATE_DIM, ImuChainData, optimize_imu_chain,
                               state_marginal_covariance)
from ..imu.preintegration import (NavState, PreintState, failure_detection,
                                  predict, preintegrate, propagate_states)
from ..utils.log import get_logger


def _nav_to_state15(nav: NavState, ba, bg):
    r, p, y = rot_to_euler(nav.R)
    return torch.cat([torch.stack([r, p, y]), nav.p, nav.v, ba, bg])


def _state15_to_nav(s):
    R = euler_to_rot(s[0], s[1], s[2])
    return NavState(R=R, p=s[3:6], v=s[6:9]), s[9:12], s[12:15]


@dataclasses.dataclass
class ImuOdometry:
    """Host driver holding the two IMU queues and the chain window; the
    chain's tensors live on `device` (required)."""

    params: Params
    window: int = 32          # ref resets at key==100; smaller LM window
    max_samples: int = 1024   # per-interval IMU sample cap
    device: torch.device = dataclasses.field(kw_only=True)

    def __post_init__(self):
        self._log = get_logger()
        self.system_initialized = False
        self.done_first_opt = False
        self.key = 0
        self.reset_id = 0
        self.last_imu_t_imu = -1.0
        self.last_imu_t_opt = -1.0
        self.que_opt: List[Tuple[float, np.ndarray, np.ndarray]] = []
        self.que_imu: List[Tuple[float, np.ndarray, np.ndarray]] = []
        self._pending: List[Tuple[float, np.ndarray, np.ndarray]] = []

        dev = self.device
        self.prev_nav = NavState.identity(device=dev)
        self.prev_ba = torch.zeros(3, device=dev)
        self.prev_bg = torch.zeros(3, device=dev)
        self.prev_nav_odom = NavState.identity(device=dev)
        self.prev_ba_odom = torch.zeros(3, device=dev)
        self.prev_bg_odom = torch.zeros(3, device=dev)

        K = self.window
        self.chain_states = np.zeros((K, STATE_DIM), np.float32)
        self.chain_mask = np.zeros(K, bool)
        # device-resident stacked preint window (one-slot updates; the host
        # keeps only the per-slot presence flags)
        self.chain_preint_dev = self._zero_preint_window()
        self.chain_has_preint = np.zeros(K, bool)
        self.chain_pose_meas = np.zeros((K, 6), np.float32)
        # priorPoseNoise / priorVelNoise / priorBiasNoise (ref :105-109)
        self.prior_sigma0 = np.concatenate([
            np.full(6, 1e-2), np.full(3, 1e4), np.full(6, 1e-3)
        ]).astype(np.float32)
        self.prior_sigma = self.prior_sigma0.copy()
        self.lidar2imu = np.asarray(self.params.ext_trans, np.float32)

    def _zero_preint_window(self):
        zero = PreintState.zero(device=self.device)
        return PreintState(*(a[None].repeat(self.window, *[1] * a.dim())
                             for a in zero))

    def _dev(self, a):
        # a copy: on the CPU `as_tensor` would share the NumPy buffer
        return torch.tensor(np.asarray(a, np.float32), device=self.device)

    # ------------------------------------------------------------------ imu
    def handle_imu(self, t: float, acc, gyr):
        """Queue one (lidar-frame) IMU sample (imuHandler intake, ref
        :413-430).  Prediction is deferred: the reference publishes IMU-rate
        odometry per sample; a device dispatch per 100-500 Hz sample is the
        wrong grain, so samples buffer here and `flush_imu_odometry()`
        propagates the whole pending chunk in one `propagate_states` call
        (typically once per scan interval)."""
        acc = np.asarray(acc, np.float32)
        gyr = np.asarray(gyr, np.float32)
        self.que_opt.append((t, acc, gyr))
        self.que_imu.append((t, acc, gyr))
        self._pending.append((t, acc, gyr))

    def _propagate(self, samples, anchor):
        """The odometry stream's NavStates at `samples` [(t, acc, gyr)],
        the first dt measured from `anchor`; advances prev_nav_odom."""
        ts = np.array([s[0] for s in samples])
        dts = np.diff(np.concatenate([[anchor], ts])).astype(np.float32)
        navs = propagate_states(
            self.prev_nav_odom, self.prev_ba_odom, self.prev_bg_odom,
            self._dev(np.stack([s[1] for s in samples])),
            self._dev(np.stack([s[2] for s in samples])), self._dev(dts),
            None, gravity=self.params.imu_gravity)
        self.prev_nav_odom = NavState(*(a[-1] for a in navs))
        self.last_imu_t_imu = float(ts[-1])
        return navs

    def flush_imu_odometry(self):
        """Propagate all pending IMU samples in one batched call.

        Returns (pose6 [n,6], vel [n,3]) as NumPy — the lidar-frame IMU-rate
        odometry stream for every pending sample (imuHandler
        predict+publish, ref :440-476) — or None if the system hasn't
        completed its first optimization or nothing is pending."""
        if not self.done_first_opt or not self._pending:
            return None
        pending, self._pending = self._pending, []
        anchor = (pending[0][0] - 1.0 / 500.0 if self.last_imu_t_imu < 0
                  else self.last_imu_t_imu)
        navs = self._propagate(pending, anchor)
        # one copy to the host: R, p, v of every sample
        host = torch.cat([navs.R.reshape(-1, 9), navs.p, navs.v],
                         1).cpu().numpy()
        R = host[:, :9].reshape(-1, 3, 3)
        # imu pose -> lidar pose via extrinsic translation (ref :457-458)
        t_l = host[:, 9:12] - np.einsum("nij,j->ni", R, self.lidar2imu)
        rpy = np.stack([
            np.arctan2(R[:, 2, 1], R[:, 2, 2]),
            np.arcsin(np.clip(-R[:, 2, 0], -1.0, 1.0)),
            np.arctan2(R[:, 1, 0], R[:, 0, 0])], axis=-1)
        pose6 = np.concatenate([rpy, t_l], axis=-1).astype(np.float32)
        return pose6, host[:, 12:15].copy()

    # ------------------------------------------------------- lidar odometry
    def handle_odometry(self, t: float, lidar_pose6, reset_id: int = 0):
        """Fuse a lidar odometry correction (odometryHandler, ref :144-390)."""
        p = self.params
        if not self.que_opt:
            return
        if reset_id != self.reset_id:
            self._log.warn("imu/reset_id_mismatch", time=t,
                           expected=self.reset_id, got=reset_id)
            self._reset_params()
            self.reset_id = reset_id
            return

        pose6 = np.asarray(lidar_pose6, np.float32)
        # lidarPose.compose(lidar2Imu) (ref :198,318), on the host
        R = euler_to_rot(*torch.from_numpy(pose6[:3])).numpy()
        p_imu = pose6[3:6] + R @ self.lidar2imu
        nav_meas = np.concatenate([pose6[:3], p_imu])

        if not self.system_initialized:
            while self.que_opt and self.que_opt[0][0] < t:
                self.last_imu_t_opt = self.que_opt[0][0]
                self.que_opt.pop(0)
            self.chain_states[:] = 0
            self.chain_mask[:] = False
            self.chain_preint_dev = self._zero_preint_window()
            self.chain_has_preint[:] = False
            self.chain_states[0, :6] = nav_meas
            self.chain_mask[0] = True
            self.chain_pose_meas[0] = nav_meas
            self.prev_nav, self.prev_ba, self.prev_bg = _state15_to_nav(
                self._dev(self.chain_states[0]))
            self.prior_sigma = self.prior_sigma0.copy()
            self.key = 1
            self.system_initialized = True
            return

        if self.key >= self.window:
            self._reset_window()

        # integrate opt-queue samples in [last, t) (ref :271-294)
        samples = []
        while self.que_opt and self.que_opt[0][0] < t:
            ti, acc, gyr = self.que_opt.pop(0)
            dt = (1.0 / 500.0) if self.last_imu_t_opt < 0 else ti - self.last_imu_t_opt
            samples.append((dt, acc, gyr))
            self.last_imu_t_opt = ti
        cap = self.max_samples
        if len(samples) > cap:
            self._log.warn("imu/dropped_samples", time=t, cap=cap,
                           dropped=len(samples) - cap)
            samples = samples[:cap]
        n = len(samples)
        # one upload: dt, acc, gyr of the kept samples
        buf = self._dev(np.array([[dt, *a, *g] for dt, a, g in samples],
                                 np.float32).reshape(n, 7))
        pre = preintegrate(
            buf[:, 1:4], buf[:, 4:7], buf[:, 0], None, self.prev_ba,
            self.prev_bg, np.float32(p.imu_acc_noise ** 2),
            np.float32(p.imu_gyr_noise ** 2))

        k = self.key
        prop = predict(self.prev_nav, self.prev_ba, self.prev_bg, pre,
                       gravity=p.imu_gravity)
        self.chain_states[k] = _nav_to_state15(
            prop, self.prev_ba, self.prev_bg).cpu().numpy()
        self.chain_mask[k] = True
        slot = torch.tensor([k], device=self.device)
        for buf_, leaf in zip(self.chain_preint_dev, pre):
            buf_.index_copy_(0, slot, leaf[None])
        self.chain_has_preint[k] = True
        self.chain_pose_meas[k] = nav_meas

        states = self._optimize()
        self.chain_states[: k + 1] = states[: k + 1]
        self.prev_nav, self.prev_ba, self.prev_bg = _state15_to_nav(
            self._dev(self.chain_states[k]))

        if bool(failure_detection(self._dev(self.chain_states[k, 6:9]),
                                  self.prev_ba, self.prev_bg)):
            # ROS_WARN("Large velocity/bias, reset IMU-preintegration!")
            # analog (ref :392-411)
            self._log.warn("imu/failure_reset", time=t,
                           velocity=self.chain_states[k, 6:9],
                           bias_acc=self.prev_ba, bias_gyr=self.prev_bg)
            self._reset_params()
            return

        # re-propagate the odometry stream with the optimized bias (ref :351-386)
        self.prev_nav_odom = self.prev_nav
        self.prev_ba_odom = self.prev_ba
        self.prev_bg_odom = self.prev_bg
        # lastImuQT = timestamp of the last sample dropped as pre-correction
        # (ref :355-359); first re-propagated dt falls back to 1/500 only
        # when no such sample exists (ref :373).
        last_q = -1.0
        kept = []
        for s in self.que_imu:
            if s[0] < t:
                last_q = s[0]
            else:
                kept.append(s)
        self.que_imu = kept
        self._pending = []  # superseded: samples >= t re-propagate below
        if self.que_imu:
            anchor = (self.que_imu[0][0] - 1.0 / 500.0 if last_q < 0
                      else last_q)
            self._propagate(self.que_imu, anchor)

        self.key += 1
        self.done_first_opt = True

    def _optimize(self):
        p = self.params
        K = self.window
        pose_sigma = np.tile(np.full(6, 1e-2, np.float32), (K, 1))  # ref :111
        dev = self.device

        def b(a):
            return torch.from_numpy(np.array(a)).to(dev)

        data = ImuChainData(
            states=b(self.chain_states),
            state_mask=b(self.chain_mask),
            preint=self.chain_preint_dev,
            preint_mask=b(self.chain_has_preint),
            pose_meas=b(self.chain_pose_meas),
            pose_sigma=b(pose_sigma),
            pose_meas_mask=b(self.chain_mask),
            prior_state=b(self.chain_states[0]),
            prior_sigma=b(self.prior_sigma),
            bias_sigma=b(np.array([p.imu_acc_bias_n] * 3
                                  + [p.imu_gyr_bias_n] * 3, np.float32)),
            gravity=b(np.float32(p.imu_gravity)),
        )
        states, _ = optimize_imu_chain(data, iterations=4)
        # shares the window's buffers: the next one-slot update comes after
        # the next correction's _reset_window, which reads this data
        self._last_chain_data = data
        return states.cpu().numpy()

    def _reset_window(self):
        """key==100 graph reset carrying the last state as the new prior
        (ref :234-267); LM-window equivalent: restart the chain at key 1,
        with the new prior sigma = sqrt(diag(marginal covariance)) of the
        last optimized state — the updatedPoseNoise/VelNoise/BiasNoise the
        reference reads from isam marginals (ref :241-253)."""
        last_state = self.chain_states[self.key - 1].copy()
        last_meas = self.chain_pose_meas[self.key - 1].copy()
        chain_data = getattr(self, "_last_chain_data", None)
        if chain_data is not None:
            cov = state_marginal_covariance(
                chain_data, self.chain_states, self.key - 1)
            self.prior_sigma = np.sqrt(
                np.maximum(np.diag(cov), 1e-12)).astype(np.float32)
        else:
            self.prior_sigma = np.concatenate([
                np.full(6, 1e-2), np.full(3, 1e-1), np.full(6, 1e-3)
            ]).astype(np.float32)
        self.chain_states[:] = 0
        self.chain_mask[:] = False
        self.chain_preint_dev = self._zero_preint_window()
        self.chain_has_preint[:] = False
        self.chain_pose_meas[:] = 0
        self.chain_states[0] = last_state
        self.chain_mask[0] = True
        self.chain_pose_meas[0] = last_meas
        self.key = 1

    def _reset_params(self):
        """resetParams (ref :136-141)."""
        self.last_imu_t_imu = -1.0
        self.done_first_opt = False
        self.system_initialized = False
