"""Port parity: ImuOdometry (the imuPreintegration node).

Both packages' `ImuOdometry` run tests/test_imu_odometry.py's simulated
platform (perfect 100 Hz IMU, 10 Hz pose corrections) on the CPU.
Tolerances (float32):

  * the chain states after every correction within 1e-4 (measured 4.5e-5
    at the second correction, where the velocity is first estimated;
    later ones ~1e-6), the flushed IMU-rate odometry (pose6 and velocity)
    within 1e-4, equal keys and stream lengths; the tracking bounds of
    tests/test_imu_odometry.py on the port's stream;
  * the window reset: the carried prior sigma (sqrt of the float64
    marginal's diagonal) within rtol 1e-4 after each reset, the same
    number of resets;
  * the reset-id protocol: the same flags and reset_id after a bump, and
    the `imu/reset_id_mismatch` event;
  * a port odometry started by `convert.imu_odometry_state_to_torch` from
    the JAX state gives JAX's next correction: the chain states within
    1e-5 (the same inputs, one correction of float32 arithmetic), across a
    window reset too;
  * the sample cap: an interval with more samples than `max_samples`
    keeps the first ones in both (the interval's preintegrated dt, dv, dp
    within 1e-6) and the port warns `imu/dropped_samples` with the cap and
    the count dropped.
"""

import numpy as np
import pytest
import torch

from feature_base_pointcloud_registration_tpu.config import Params
from feature_base_pointcloud_registration_tpu.pipeline import (
    imu_odometry as jodo)
from feature_base_pointcloud_registration_tpu_torch.convert import (
    imu_odometry_state_to_torch)
from feature_base_pointcloud_registration_tpu_torch.pipeline import (
    imu_odometry as todo)
from feature_base_pointcloud_registration_tpu_torch.utils.log import EventLog
from test_imu_odometry import _rpy_from_R, _simulate
from test_torch_batch import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
PARAMS = Params()


def _pair(window, max_samples):
    jo = jodo.ImuOdometry(PARAMS, window=window, max_samples=max_samples)
    to = todo.ImuOdometry(PARAMS, window=window, max_samples=max_samples,
                          device=CPU)
    to._log = EventLog()
    return jo, to


def _drive(odos, duration, period=0.1, on_correction=None, imu_every=1):
    """tests/test_imu_odometry.py's loop over several odometries: flush,
    then correct, every `period`; IMU samples between.  Returns the
    flushed streams [(jax out, port out, ground truth)]."""
    flushed, pending_gt, nc, i = [], [], 0.0, 0
    for k, (t, acc, gyr, R, p, v) in enumerate(_simulate(duration=duration)):
        if t >= nc:
            outs = [o.flush_imu_odometry() for o in odos]
            flushed.append((outs, pending_gt))
            pending_gt = []
            pose6 = np.concatenate([_rpy_from_R(R), p]).astype(np.float32)
            for o in odos:
                o.handle_odometry(t, pose6, reset_id=0)
            if on_correction is not None:
                on_correction(i, t, pose6)
            i += 1
            nc += period
        if k % imu_every == 0:
            for o in odos:
                o.handle_imu(t, acc, gyr)
            pending_gt.append((t, p, v))
    return flushed


def test_corrections_and_stream_match_jax():
    jo, to = _pair(16, 64)
    diffs = []
    flushed = _drive([jo, to], 2.0, on_correction=lambda i, t, p6: (
        diffs.append(np.abs(jo.chain_states - to.chain_states).max()),
        (jo.key == to.key) or pytest.fail(f"key {jo.key} != {to.key}")))
    assert len(diffs) == 20 and max(diffs) < 1e-4, diffs
    preds = []
    for (a, b), gt in flushed:
        assert (a is None) == (b is None)
        if a is None:
            continue
        assert len(b[0]) == len(a[0]) == len(gt)
        assert b[0].dtype == np.float32 and b[1].dtype == np.float32
        np.testing.assert_allclose(b[0], a[0], atol=1e-4, rtol=0)
        np.testing.assert_allclose(b[1], a[1], atol=1e-4, rtol=0)
        preds += [(pp, pv, gp, gv) for pp, pv, (_, gp, gv) in
                  zip(b[0], b[1], gt)]
    # tests/test_imu_odometry.py's tracking bounds, on the port
    assert len(preds) > 100
    errs_p = np.array([np.linalg.norm(pp[3:] - gp) for pp, _, gp, _ in preds])
    errs_v = np.array([np.linalg.norm(pv - gv) for _, pv, _, gv in preds])
    assert np.median(errs_p) < 0.05 and errs_p[-50:].max() < 0.15
    assert np.median(errs_v) < 0.2
    assert to.done_first_opt and not to._log.events


def test_window_reset_carries_the_marginal_prior_like_jax():
    jo, to = _pair(4, 32)
    sigmas = []

    def check(i, t, p6):
        if to.key == 2 and i > 2:          # a reset happened at i
            sigmas.append((to.prior_sigma.copy(), jo.prior_sigma.copy()))
        np.testing.assert_allclose(to.chain_states, jo.chain_states,
                                   atol=1e-4, rtol=0)

    _drive([jo, to], 1.5, on_correction=check)
    assert len(sigmas) >= 3                # tests/test_imu_odometry.py
    for got, want in sigmas:
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-4)
        # carried from the marginal, not the initial 1e4 velocity sigma
        assert got[6:9].max() < 1.0
    assert to.system_initialized and to.key < to.window


def test_reset_id_protocol_matches_jax():
    jo, to = _pair(8, 32)
    _drive([jo, to], 0.6)
    assert jo.done_first_opt and to.done_first_opt
    for o in (jo, to):
        o.handle_odometry(0.65, np.zeros(6, np.float32), reset_id=1)
    for o in (jo, to):
        assert not o.system_initialized and o.reset_id == 1
        assert not o.done_first_opt and o.last_imu_t_imu == -1.0
        assert o.flush_imu_odometry() is None
    ev = to._log.drain("imu/reset_id_mismatch")
    assert len(ev) == 1 and ev[0]["expected"] == 0 and ev[0]["got"] == 1
    for o in (jo, to):
        o.handle_odometry(0.7, np.zeros(6, np.float32), reset_id=1)
        assert o.system_initialized and o.key == 1
    np.testing.assert_array_equal(to.chain_states, jo.chain_states)


def test_state_carried_from_jax_gives_the_next_correction():
    """The JAX odometry's state, carried over at corrections 9 (steady) and
    16 (the window is full: the next correction resets it), gives the
    port JAX's next correction."""
    jo = jodo.ImuOdometry(PARAMS, window=16, max_samples=64)
    checked = []

    def carry(i, t, p6):
        if i not in (8, 15):
            return
        to = imu_odometry_state_to_torch(jo, todo.ImuOdometry(
            PARAMS, window=16, max_samples=64, device=CPU))
        assert to.key == jo.key and len(to.que_opt) == len(jo.que_opt)
        assert isinstance(to.chain_preint_dev.cov, torch.Tensor)
        checked.append(to)

    sim = _simulate(duration=1.8)
    nc, i = 0.0, 0
    for (t, acc, gyr, R, p, v) in sim:
        if t >= nc:
            pose6 = np.concatenate([_rpy_from_R(R), p]).astype(np.float32)
            for to in checked:
                to.handle_odometry(t, pose6, reset_id=0)
            jo.flush_imu_odometry()
            jo.handle_odometry(t, pose6, reset_id=0)
            for to in checked:
                np.testing.assert_allclose(to.chain_states, jo.chain_states,
                                           atol=1e-5, rtol=0)
                np.testing.assert_allclose(to.prior_sigma, jo.prior_sigma,
                                           rtol=1e-5)
                assert to.key == jo.key
            checked = []
            carry(i, t, pose6)
            i += 1
            nc += 0.1
        jo.handle_imu(t, acc, gyr)
        for to in checked:
            to.handle_imu(t, acc, gyr)
    assert i == 18


def test_sample_cap_is_reported():
    """A cap of 6 samples against ~10 a correction interval: both packages
    integrate the first 6, and the port says so."""
    jo, to = _pair(8, 6)

    def check(i, t, p6):
        k = to.key - 1
        if i < 2:
            return
        for f in ("dt", "dv", "dp"):
            np.testing.assert_allclose(
                getattr(to.chain_preint_dev, f)[k].numpy(),
                np.asarray(getattr(jo.chain_preint_dev, f)[k]), atol=1e-6,
                rtol=0)
        assert abs(float(to.chain_preint_dev.dt[k]) - 0.06) < 1e-6

    _drive([jo, to], 0.45, on_correction=check)
    ev = to._log.drain("imu/dropped_samples")
    # corrections 2-4 integrate, at 0.2, 0.31 and 0.4 s (the loop adds 0.1
    # s a period in float64, as tests/test_imu_odometry.py's does): 10, 11
    # and 9 samples
    assert [(e["time"], e["cap"], e["dropped"], e["level"]) for e in ev] == [
        (0.2, 6, 4, "warn"), (0.31, 6, 5, "warn"), (0.4, 6, 3, "warn")]
    # under the cap, nothing is reported
    _, to2 = _pair(8, 64)
    _drive([to2], 0.45)
    assert not to2._log.drain("imu/dropped_samples")
