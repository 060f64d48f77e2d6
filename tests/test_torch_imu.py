"""Port parity: IMU preintegration and the IMU factor chain.

The same numpy-seeded inputs go through the JAX package's
`imu/preintegration.py` / `graph/imu_graph.py` and the port's, on the
CPU.  Tolerances (float32):

  * `integrate_measurement`, `bias_corrected_delta`, `predict`: within
    1e-6 absolute (one sample, one correction: a few ulps of values ~1);
  * `preintegrate` on a 64-slot buffer of 50 samples (the stream of
    tests/test_imu.py) with a masked tail and a masked slot inside it: JAX
    scans all 64 slots, the port integrates the 49 live ones: dR, dv, dp
    and the bias Jacobians within 1e-6 absolute, dt within 1e-7, cov within
    rtol 1e-5, with a floor of 1e-7 of its largest entry (3e-5) for the
    off-diagonal entries that are float32 cancellation noise (~1e-13);
  * `propagate_states` with a masked sample (it repeats the state before
    it, in both): R, p, v within 1e-6;
  * `failure_detection`: equal decisions on both sides of each limit;
  * `chain_factor_blocks` on a 6-state chain built from that stream
    (states perturbed by 1e-2, so residuals are not float32 noise):
    Jacobian blocks within rtol 1e-4 of their largest entry, residuals
    within rtol 1e-4 of theirs (the whitening divides by sqrt(cov) ~1e-5,
    so a 1e-8 difference in a residual is ~1e-3 once whitened);
  * `optimize_imu_chain` (4 LM iterations, as ImuOdometry runs it): states
    within 1e-4; the final cost (~1.4e-6: at the optimum it is float32
    noise of the whitened residuals) within 1e-7 absolute;
  * `state_marginal_covariance`: within rtol 1e-4, with a floor of 1e-6
    of its largest entry for the cross terms that are cancellation noise
    (float64 on the host in both, from float32 blocks).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_base_pointcloud_registration_tpu.graph import imu_graph as jg
from feature_base_pointcloud_registration_tpu.imu import (
    preintegration as jp)
from feature_base_pointcloud_registration_tpu_torch.convert import (
    _as_numpy, to_torch)
from feature_base_pointcloud_registration_tpu_torch.graph import (
    imu_graph as tg)
from feature_base_pointcloud_registration_tpu_torch.imu import (
    preintegration as tp)
from test_imu import G, _simulate_imu
from test_torch_batch import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
T = torch.from_numpy


def _port(tree):
    return to_torch(_as_numpy(tree), device=CPU)


def _np(tree):
    return [np.asarray(a) for a in tree]


def _buffer(n=50, cap=64, hole=17):
    accs, gyrs, dts, *_ = _simulate_imu(n=n)
    acc = np.zeros((cap, 3), np.float32)
    gyr = np.zeros((cap, 3), np.float32)
    dt = np.zeros(cap, np.float32)
    mask = np.zeros(cap, bool)
    acc[:n], gyr[:n], dt[:n], mask[:n] = accs, gyrs, dts, True
    # a garbage sample in a masked slot inside the live run
    acc[hole], gyr[hole], dt[hole], mask[hole] = 50.0, -3.0, 0.5, False
    acc[n:] = 7.0
    return acc, gyr, dt, mask


BIAS = (np.array([0.02, -0.01, 0.03], np.float32),
        np.array([0.004, -0.002, 0.001], np.float32))


def _random_preint(seed):
    r = np.random.RandomState(seed)
    acc, gyr, dt, mask = _buffer()
    return jp.preintegrate(*(jnp.asarray(a) for a in (acc, gyr, dt, mask)),
                           jnp.asarray(BIAS[0]), jnp.asarray(BIAS[1]),
                           1e-4, 1e-5), r


def test_integrate_measurement_matches_jax():
    pre, r = _random_preint(0)
    acc = r.normal(0, 3, 3).astype(np.float32)
    gyr = r.normal(0, 0.5, 3).astype(np.float32)
    dt = np.float32(0.01)
    want = jp.integrate_measurement(pre, jnp.asarray(acc), jnp.asarray(gyr),
                                    jnp.float32(dt), 1e-4, 1e-5, 1e-8)
    got = tp.integrate_measurement(_port(pre), T(acc), T(gyr),
                                   torch.tensor(dt), 1e-4, 1e-5, 1e-8)
    for f, a, b in zip(tp.PreintState._fields, _np(got), _np(want)):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0, err_msg=f)


def test_preintegrate_masked_buffer_matches_jax():
    acc, gyr, dt, mask = _buffer()
    want = jp.preintegrate(*(jnp.asarray(a) for a in (acc, gyr, dt, mask)),
                           jnp.asarray(BIAS[0]), jnp.asarray(BIAS[1]),
                           1e-4, 1e-5)
    for m in (mask, T(mask)):       # the mask as numpy or as a tensor
        got = tp.preintegrate(T(acc), T(gyr), T(dt), m, T(BIAS[0]),
                              T(BIAS[1]), 1e-4, 1e-5)
        for f, a, b in zip(tp.PreintState._fields, _np(got), _np(want)):
            if f == "cov":
                np.testing.assert_allclose(
                    a, b, rtol=1e-5, atol=1e-7 * np.abs(b).max(), err_msg=f)
            else:
                np.testing.assert_allclose(
                    a, b, atol=1e-7 if f == "dt" else 1e-6, rtol=0,
                    err_msg=f)
    assert abs(float(got.dt) - 0.245) < 1e-6      # 49 live samples
    # no live sample: the zero state with the given biases
    empty = tp.preintegrate(T(acc), T(gyr), T(dt), np.zeros(64, bool),
                            T(BIAS[0]), T(BIAS[1]), 1e-4, 1e-5)
    assert float(empty.dt) == 0.0 and torch.equal(empty.dR, torch.eye(3))
    assert torch.equal(empty.bias_acc, T(BIAS[0]))


def test_predict_and_bias_correction_match_jax():
    pre, r = _random_preint(1)
    nav = jp.NavState(R=jnp.asarray(np.asarray(jp.so3_exp(
        jnp.asarray(r.normal(0, 0.3, 3).astype(np.float32))))),
        p=jnp.asarray(r.normal(0, 2, 3).astype(np.float32)),
        v=jnp.asarray(r.normal(0, 1, 3).astype(np.float32)))
    ba = BIAS[0] + r.normal(0, 0.01, 3).astype(np.float32)
    bg = BIAS[1] + r.normal(0, 0.002, 3).astype(np.float32)
    want = jp.bias_corrected_delta(pre, jnp.asarray(ba), jnp.asarray(bg))
    got = tp.bias_corrected_delta(_port(pre), T(ba), T(bg))
    for a, b in zip(_np(got), _np(want)):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    want = jp.predict(nav, jnp.asarray(ba), jnp.asarray(bg), pre, gravity=G)
    got = tp.predict(_port(nav), T(ba), T(bg), _port(pre), gravity=G)
    for a, b in zip(_np(got), _np(want)):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


def test_propagate_states_matches_jax():
    accs, gyrs, dts, *_ = _simulate_imu(n=40)
    mask = np.ones(40, bool)
    mask[[0, 13]] = False
    nav = jp.NavState.identity()
    want = jp.propagate_states(
        nav, jnp.asarray(BIAS[0]), jnp.asarray(BIAS[1]),
        jnp.asarray(accs, jnp.float32), jnp.asarray(gyrs, jnp.float32),
        jnp.asarray(dts, jnp.float32), jnp.asarray(mask), gravity=G)
    got = tp.propagate_states(
        tp.NavState.identity(device=CPU), T(BIAS[0]), T(BIAS[1]),
        T(accs.astype(np.float32)), T(gyrs.astype(np.float32)),
        T(dts.astype(np.float32)), mask, gravity=G)
    for a, b in zip(_np(got), _np(want)):
        assert a.shape == b.shape and a.shape[0] == 40
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    # a masked sample repeats the state before it
    np.testing.assert_array_equal(got.p[13].numpy(), got.p[12].numpy())
    np.testing.assert_array_equal(got.R[0].numpy(), np.eye(3))


@pytest.mark.parametrize("vel,ba,bg", [
    ([1.0, 0, 0], [0, 0, 0], [0, 0, 0]),
    ([31.0, 0, 0], [0, 0, 0], [0, 0, 0]),
    ([0, 29.9, 0], [0.5, 0.5, 0.5], [0, 0, 0]),
    ([0, 0, 0], [1.5, 0, 0], [0, 0, 0]),
    ([0, 0, 0], [0, 0, 0], [0, 0.8, 0.8]),
])
def test_failure_detection_matches_jax(vel, ba, bg):
    args = [np.asarray(a, np.float32) for a in (vel, ba, bg)]
    want = bool(jp.failure_detection(*(jnp.asarray(a) for a in args)))
    got = tp.failure_detection(*(T(a) for a in args))
    assert got.dtype == torch.bool and bool(got) == want


def _chain(K=6, per=20, perturb=1e-2, seed=5):
    """A K-state chain over tests/test_imu.py's stream: interval k holds
    samples [(k-1) per, k per), states at the ground truth (perturbed),
    pose measurements at the truth, the last slot masked."""
    n = (K - 1) * per
    accs, gyrs, dts, Rs, ps, vs = _simulate_imu(n=n)
    r = np.random.RandomState(seed)
    pres = [jp.PreintState.zero()]
    for k in range(1, K):
        sl = slice((k - 1) * per, k * per)
        pres.append(jp.preintegrate(
            jnp.asarray(accs[sl], jnp.float32),
            jnp.asarray(gyrs[sl], jnp.float32),
            jnp.asarray(dts[sl], jnp.float32), jnp.ones(per, bool),
            jnp.zeros(3), jnp.zeros(3), 1e-4, 1e-5))
    preint = jax.tree.map(lambda *a: jnp.stack(a), *pres)
    states = np.zeros((K, 15), np.float32)
    meas = np.zeros((K, 6), np.float32)
    for k in range(K):
        R = np.eye(3) if k == 0 else Rs[k * per - 1]
        p = np.zeros(3) if k == 0 else ps[k * per - 1]
        v = np.zeros(3) if k == 0 else vs[k * per - 1]
        rpy = [np.arctan2(R[2, 1], R[2, 2]), np.arcsin(-R[2, 0]),
               np.arctan2(R[1, 0], R[0, 0])]
        meas[k] = np.concatenate([rpy, p])
        states[k, :9] = np.concatenate([rpy, p, v])
    states[1:, :9] += r.normal(0, perturb, (K - 1, 9)).astype(np.float32)
    mask = np.ones(K, bool)
    mask[-1] = False
    d = jg.ImuChainData(
        states=jnp.asarray(states), state_mask=jnp.asarray(mask),
        preint=preint,
        preint_mask=jnp.asarray(np.arange(K) > 0),
        pose_meas=jnp.asarray(meas),
        pose_sigma=jnp.full((K, 6), 1e-2, jnp.float32),
        pose_meas_mask=jnp.asarray(mask),
        prior_state=jnp.asarray(states[0]),
        prior_sigma=jnp.asarray(np.concatenate([
            np.full(6, 1e-2), np.full(3, 1e4), np.full(6, 1e-3)]),
            jnp.float32),
        bias_sigma=jnp.asarray([6.4e-5] * 3 + [3.6e-5] * 3, jnp.float32),
        gravity=jnp.float32(G))
    return d, _port(d)


def test_chain_factor_blocks_match_jax():
    d, td = _chain()
    want = [np.asarray(a) for a in jax.tree.leaves(
        jg.chain_factor_blocks(d, d.states))]
    got = [t.numpy() for group in tg.chain_factor_blocks(td, td.states)
           for t in group]
    assert [a.shape for a in got] == [a.shape for a in want]
    for a, b in zip(got, want):
        assert a.dtype == np.float32 and np.isfinite(a).all()
        scale = max(float(np.abs(b).max()), 1e-30)
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * scale)
    # the masked slot's factors are zero
    assert not got[0][-1].any() and not got[1][-1].any()


def test_optimize_imu_chain_matches_jax():
    d, td = _chain()
    want, cost_j = jg.optimize_imu_chain(d, iterations=4)
    got, cost_t = tg.optimize_imu_chain(td, iterations=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    # at the optimum the cost is float32 noise of the whitened residuals
    assert abs(float(cost_t) - float(cost_j)) < 1e-7
    # the LM moved the perturbed states toward the truth
    assert float(cost_t) < float(tg._cost(td, td.states,
                                          tg._whitener(td))) * 1e-2


def test_state_marginal_covariance_matches_jax():
    d, td = _chain()
    states, _ = jg.optimize_imu_chain(d, iterations=4)
    for idx in (0, 3):
        want = jg.state_marginal_covariance(d, np.asarray(states), idx)
        got = tg.state_marginal_covariance(td, np.asarray(states), idx)
        assert got.shape == (15, 15) and got.dtype == np.float64
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-6 * np.abs(want).max())
