"""Port parity: the GPS chain (EkfGps, NavsatTransform).

The same numpy-seeded inputs go through the JAX package's
`pipeline/navsat.py` and the port's, on the CPU.  Tolerances (float32):

  * one EKF predict from seeded states, covariances and steps of 0.01,
    0.1 and 0.5 s: the state within 1e-5, P within 1e-3 of its largest
    entry (measured 3.8e-4).  The position/attitude block of F is a
    float32 finite difference over eps = 1e-4 in both packages: an ulp of
    R (6e-8) is 6e-4 of a column of it, times the step's displacement (up
    to ~1 m here), and XLA contracts R's products into FMAs where PyTorch
    does not;
  * one EKF update (measured subsets, an angle across +-pi): the state
    within 1e-5, P within rtol 1e-4 of its largest entry (S carries 1e12
    on the unmeasured rows and is inverted as is, `torch.linalg.inv`
    against `jnp.linalg.inv`);
  * the circular drive of tests/test_navsat.py (120 IMU / velocity and 24
    odometry updates): the state after every update within 1e-3 (the
    filter runs 264 updates of float32 arithmetic, each difference
    corrected by the next measurement), P within rtol 1e-3 of its largest
    entry, and that file's accuracy bounds on the port;
  * the yaw-wrap case: the same corrected yaw within 1e-5;
  * NavsatTransform: the datum and every aligned fix within 1e-5 m, the
    covariance passed through unrotated, a sample returned for the first
    fix (the datum) as well.
"""

import numpy as np
import pytest
import torch

from feature_base_pointcloud_registration_tpu.pipeline import navsat as jnav
from feature_base_pointcloud_registration_tpu_torch.pipeline import (
    navsat as tnav)
from test_navsat import _circle_state
from test_torch_batch import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
T = torch.from_numpy


def _psd(r, scale):
    A = r.normal(0, 1, (15, 15))
    return ((A @ A.T / 15 + np.eye(15) * 0.1) * scale).astype(np.float32)


def _state(r):
    x = np.concatenate([r.uniform(-20, 20, 3), r.uniform(-0.3, 0.3, 2),
                        r.uniform(-3, 3, 1), r.normal(0, 2, 3),
                        r.normal(0, 0.3, 3), r.normal(0, 0.5, 3)])
    return x.astype(np.float32)


def _close(got, want, atol_x, rtol_p):
    np.testing.assert_allclose(got[0], want[0], atol=atol_x, rtol=0)
    np.testing.assert_allclose(got[1], want[1], rtol=0,
                               atol=rtol_p * np.abs(want[1]).max())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ekf_predict_matches_jax(seed):
    r = np.random.RandomState(seed)
    x, P = _state(r), _psd(r, 0.5)
    q = r.uniform(0.01, 0.06, 15).astype(np.float32)
    for dt in (0.01, 0.1, 0.5):
        want = [np.asarray(a) for a in jnav._ekf_predict(
            x, P, np.float32(dt), q)]
        got = [a.numpy() for a in tnav.ekf_predict(
            T(x), T(P), torch.tensor(np.float32(dt)), T(q))]
        assert got[1].dtype == np.float32
        _close(got, want, 1e-5, 1e-3)


@pytest.mark.parametrize("seed", [0, 1])
def test_ekf_update_matches_jax(seed):
    r = np.random.RandomState(seed)
    x, P = _state(r), _psd(r, 0.3)
    x[5] = -np.pi + 0.02                     # yaw near -pi
    for slots in ([3, 4, 5, 9, 10, 11], [0, 1, 2, 3, 4, 5], [6, 7, 8]):
        z = np.zeros(15, np.float32)
        rv = np.ones(15, np.float32)
        m = np.zeros(15, np.float32)
        z[slots] = x[slots] + r.normal(0, 0.1, len(slots))
        z[5] = np.pi - 0.03                  # across the wrap
        rv[slots] = r.uniform(0.01, 0.1, len(slots))
        m[slots] = 1.0
        want = [np.asarray(a) for a in jnav._ekf_update(x, P, z, rv, m)]
        got = [a.numpy() for a in tnav.ekf_update(T(x), T(P), T(z), T(rv),
                                                  T(m))]
        _close(got, want, 1e-5, 1e-4)


def test_ekf_circular_drive_matches_jax():
    """tests/test_navsat.py::test_ekf_tracks_circular_drive on both."""
    r = np.random.RandomState(0)
    je, te = jnav.EkfGps(), tnav.EkfGps(device=CPU)
    errs_mid = []
    for k in range(120):
        t = 0.1 * k
        pos, yaw, vel_body, gyro = _circle_state(t)
        rpy = np.array([0.0, 0.0, yaw]) + r.normal(0, 0.005, 3)
        gy = gyro + r.normal(0, 0.01, 3)
        vb = vel_body + r.normal(0, 0.02, 3)
        pose6 = (np.concatenate([[0, 0, yaw], pos]) + r.normal(0, 0.01, 6)
                 if k % 5 == 0 else None)
        for e in (je, te):
            e.add_imu(t, rpy, gy)
            e.add_velocity(t, vb)
            if pose6 is not None:
                e.add_odometry(t, pose6)
            assert e.x.dtype == np.float32 and e.P.dtype == np.float32
        _close((te.x, te.P), (je.x, je.P), 1e-3, 1e-3)
        if k % 5 == 3 and k > 20:
            want, _ = je.odometry(t)
            est, cov = te.odometry(t)
            np.testing.assert_allclose(est, want, atol=1e-3, rtol=0)
            errs_mid.append(np.linalg.norm(est[3:5] - pos[:2]))
    assert np.median(errs_mid) < 0.25
    w = np.linalg.eigvalsh(te.P[:6, :6].astype(np.float64))
    assert w.min() > 0 and w.max() < 1e4


def test_ekf_yaw_wrap_matches_jax():
    yaws = []
    for e in (jnav.EkfGps(), tnav.EkfGps(device=CPU)):
        e.add_imu(0.0, [0.0, 0.0, -np.pi + 0.01], [0, 0, 0])
        for k in range(5):
            e.add_imu(0.1 * (k + 1), [0.0, 0.0, np.pi - 0.01], [0, 0, 0])
        yaws.append(float(e.x[5]))
    assert abs(yaws[1] - yaws[0]) < 1e-5
    d = np.arctan2(np.sin(yaws[1] - (np.pi - 0.01)),
                   np.cos(yaws[1] - (np.pi - 0.01)))
    assert abs(d) < 0.05


def test_navsat_transform_matches_jax():
    """tests/test_navsat.py's datum and alignment on both; the first fix
    returns a sample (the EKF's position), every fix the covariance as
    given."""
    dyaw = 0.7
    c, s = np.cos(dyaw), np.sin(dyaw)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    anchor_enu = np.array([500.0, -200.0, 30.0])
    map_pos0 = np.array([1.0, 2.0, 0.0])
    outs = []
    for ekf in (jnav.EkfGps(), tnav.EkfGps(device=CPU)):
        nav = (jnav.NavsatTransform(ekf) if isinstance(ekf, jnav.EkfGps)
               else tnav.NavsatTransform(ekf))
        ekf.add_imu(0.0, [0, 0, 0.3], [0, 0, 0])
        ekf.add_odometry(0.0, np.concatenate([[0, 0, 0.3], map_pos0]),
                         pos_var=1e-8, rot_var=1e-8)
        assert not nav.initialized
        fixes = [nav.handle_fix(0.0, anchor_enu, [0.05, 0.05, 0.1],
                                imu_yaw=0.3 - dyaw)]
        assert nav.initialized and fixes[0] is not None
        for k in range(1, 6):
            map_pos = map_pos0 + np.array([0.5 * k, -0.2 * k, 0.0])
            enu = anchor_enu + R.T @ (map_pos - map_pos0)
            fixes.append(nav.handle_fix(0.1 * k, enu, [0.05, 0.05, 0.1]))
            np.testing.assert_allclose(fixes[-1][0], map_pos, atol=1e-3)
        outs.append(fixes)
    for (gx, gc), (wx, wc) in zip(outs[1], outs[0]):
        assert gx.dtype == np.float32 and gc.dtype == np.float32
        np.testing.assert_allclose(gx, wx, atol=1e-5, rtol=0)
        np.testing.assert_array_equal(gc, wc)
        np.testing.assert_array_equal(gc, np.float32([0.05, 0.05, 0.1]))
