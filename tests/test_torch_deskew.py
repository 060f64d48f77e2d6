"""Port parity: motion deskew (`ops/projection.py` with a `DeskewInfo`,
`deskew_points`, `pipeline/frontend.py::make_deskew_info`).

  * tests/test_projection.py's rotating-sweep table: the deskewed cloud's
    points within 2e-5 m of the JAX package's and of the serial NumPy
    oracle's (the JAX package's own bound against the oracle: per-point
    float32 Euler rotations in another order); every other CloudInfo field
    equal (point_range: the 1-ulp FMA difference of
    tests/test_torch_frontend.py);
  * tests/test_projection.py's positional deskew: within 2e-5 m of JAX and
    of the expected shift;
  * make_deskew_info: bitwise equal to the JAX package's, field by field;
  * tests/test_projection.py's full motion-skew chain (rotation and
    translation during the sweep): the deskewed points lie on the world's
    surfaces at least as well as the JAX package's (mean surface distance
    no more than 1e-6 m above JAX's) and within that test's own bounds.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import oracle
from feature_base_pointcloud_registration_tpu.config import Params
from feature_base_pointcloud_registration_tpu.io.synthetic import (
    SyntheticWorld, pose6_to_matrix_np, simulate_scan)
from feature_base_pointcloud_registration_tpu.ops.projection import (
    deskew_points, project_scan)
from feature_base_pointcloud_registration_tpu.pipeline.cloud_info import (
    DeskewInfo, RawScan)
from feature_base_pointcloud_registration_tpu.pipeline.frontend import (
    make_deskew_info)
from feature_base_pointcloud_registration_tpu_torch.convert import (
    deskew_info_to_torch, to_numpy, to_torch)
from feature_base_pointcloud_registration_tpu_torch.ops import (
    projection as tproj)
from feature_base_pointcloud_registration_tpu_torch.pipeline import (
    frontend as tfront)
from test_torch_batch import one_torch_thread  # noqa: F401
from test_projection import _surface_distance

PARAMS = Params()
CPU = torch.device("cpu")


def _raw(s):
    raw = RawScan.from_numpy(s["xyz"], s["intensity"], s["ring"], s["time"])
    return raw._replace(valid=jnp.asarray(s["valid"]))


def _batch(tree):
    return to_torch(jax.tree.map(lambda a: np.asarray(a)[None], tree),
                    device=CPU)


def test_rotation_deskew_matches_jax_and_oracle():
    """tests/test_projection.py::test_projection_deskew_matches_oracle."""
    s = simulate_scan(SyntheticWorld(), [0.02, -0.01, 0.3, 1.0, 2.0, 0.0],
                      seed=3)
    q, n_imu = PARAMS.imu_queue_len, 40
    t = np.linspace(-0.005, 0.105, n_imu)
    rot = np.outer(t - t[0], np.array([0.05, -0.08, 0.6]))
    imu_time = np.full(q, np.inf, np.float32)
    imu_time[:n_imu] = t
    imu_rot = np.zeros((q, 3), np.float32)
    imu_rot[:n_imu] = rot
    dsk = DeskewInfo.empty(q)._replace(
        imu_time=jnp.asarray(imu_time), imu_rot=jnp.asarray(imu_rot),
        imu_count=jnp.asarray(n_imu - 1, jnp.int32),
        imu_available=jnp.asarray(True))
    raw = _raw(s)
    want = jax.tree.map(np.asarray, project_scan(PARAMS, raw, dsk,
                                                 enable_deskew=True))
    got = to_numpy(tproj.project_scan(
        PARAMS, _batch(raw), deskew_info_to_torch(
            jax.tree.map(np.asarray, dsk), device=CPU)))
    n = int(want.num_points)
    assert int(got.num_points[0]) == n
    np.testing.assert_allclose(got.points[0], want.points, rtol=0, atol=2e-5)
    ref = oracle.project_scan(s["xyz"], s["ring"], s["time"], s["valid"],
                              deskew=oracle.find_rotation_factory(t, rot))
    np.testing.assert_allclose(got.points[0, :n], ref["points"], rtol=0,
                               atol=2e-5)
    for name in want._fields:
        if name == "point_range":
            np.testing.assert_allclose(got.point_range[0], want.point_range,
                                       rtol=2.4e-7, atol=0)
        elif name != "points":
            np.testing.assert_array_equal(getattr(got, name)[0],
                                          getattr(want, name), err_msg=name)
    # the deskew moved the points (the comparison is not vacuous)
    plain = to_numpy(tproj.project_scan(PARAMS, _batch(raw)))
    assert np.abs(plain.points[0] - got.points[0]).max() > 0.05


@pytest.mark.parametrize("flag", [True, False])
def test_positional_deskew_matches_jax(flag):
    """tests/test_projection.py::test_positional_deskew_applied."""
    n = 8
    xyz = np.stack([np.linspace(2, 5, n), np.zeros(n), np.zeros(n)],
                   -1).astype(np.float32)
    rel_t = np.linspace(0.0, 0.1, n).astype(np.float32)
    incre = np.array([0.5, -0.2, 0.0], np.float32)
    dsk = DeskewInfo.empty(PARAMS.imu_queue_len)._replace(
        imu_available=jnp.asarray(True), odom_available=jnp.asarray(True),
        odom_deskew_flag=jnp.asarray(flag), odom_incre=jnp.asarray(incre))
    want = np.asarray(deskew_points(jnp.asarray(xyz), jnp.asarray(rel_t),
                                    dsk, scan_duration=0.1))
    got = tproj.deskew_points(
        torch.from_numpy(xyz)[None], torch.from_numpy(rel_t)[None],
        deskew_info_to_torch(jax.tree.map(np.asarray, dsk), device=CPU),
        scan_duration=torch.tensor([0.1]))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    shift = np.linspace(0.0, 1.0, n)[:, None] * incre if flag else 0.0
    np.testing.assert_allclose(got, xyz + shift, rtol=0, atol=2e-5)


def _imu_stream(seed, n=60):
    r = np.random.RandomState(seed)
    t = 50.0 + np.sort(r.uniform(-0.05, 0.2, n))
    return t, r.normal(0, 0.4, (n, 3))


@pytest.mark.parametrize("case", ["plain", "odom", "short_queue", "empty"])
def test_make_deskew_info_bitwise(case):
    t, gyr = _imu_stream(len(case))
    params, kw = PARAMS, {}
    if case == "odom":
        kw = dict(imu_rpy=[0.01, -0.02, 0.3],
                  initial_guess=[0.0, 0.0, 0.3, 1.0, 2.0, 0.1],
                  odom_incre=[0.12, -0.01, 0.0], odom_deskew_flag=True,
                  reset_id=3)
    elif case == "short_queue":
        params = Params(imu_queue_len=16)       # more samples than slots
    elif case == "empty":
        t, gyr = t[:0], gyr[:0]
    want = make_deskew_info(params, t, gyr, 50.0, 50.1, **kw)
    got = tfront.make_deskew_info(params, t, gyr, 50.0, 50.1, device=CPU,
                                  **kw)
    assert bool(got.imu_available[0]) == (case != "empty")
    for name in want._fields:
        g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
        assert g.shape == (1,) + w.shape and g.dtype == w.dtype, name
        np.testing.assert_array_equal(g[0], w, err_msg=name)


def test_full_motion_skew_chain():
    """tests/test_projection.py::test_full_motion_skew_deskew_recovers_
    surfaces, through the port's make_deskew_info and project_scan."""
    world = SyntheticWorld()
    yaw = 0.3
    pose = np.array([0.0, 0.0, yaw, 1.0, -2.0, 0.4], np.float32)
    rates = np.array([0.0, 0.0, 0.5])
    vel_w = np.array([1.2, 0.5, 0.0])
    s = simulate_scan(world, pose, noise=0.0, seed=7, spin_rpy_rate=rates,
                      vel_world=vel_w)
    t = 200.0
    imu_t = t + np.linspace(-0.005, 0.105, 23)
    gyr = np.tile(rates, (len(imu_t), 1))
    c, sn = np.cos(yaw), np.sin(yaw)
    incre = np.array([c * vel_w[0] + sn * vel_w[1],
                      -sn * vel_w[0] + c * vel_w[1], 0.0]) * 0.1
    kw = dict(odom_incre=incre, odom_deskew_flag=True)
    raw = _raw(s)
    T = pose6_to_matrix_np(pose.astype(np.float64))

    def err(cloud):
        n = int(np.asarray(cloud.num_points).reshape(-1)[0])
        pts = np.asarray(cloud.points).reshape(-1, 3)[:n]
        return _surface_distance(world, pts @ T[:3, :3].T + T[:3, 3])

    want = err(project_scan(PARAMS, raw, make_deskew_info(
        Params(), imu_t, gyr, t, t + 0.1, **kw), enable_deskew=True))
    got = err(tproj.project_scan(PARAMS, _batch(raw), tfront.make_deskew_info(
        Params(), imu_t, gyr, t, t + 0.1, device=CPU, **kw)))
    assert float(got.mean()) <= float(want.mean()) + 1e-6, (
        got.mean(), want.mean())
    assert float(got.mean()) < 0.004
    assert float(np.quantile(got, 0.99)) < 0.02
