"""Port parity: the LIO topology (ScanBuffer + OdomQueue + ImuOdometry +
SlamPipeline, the test.launch process pair).

Both packages' `LioTopology` run the drive of tests/test_topology.py
(`test_lio_topology_end_to_end_tracks`: 6 + 2 scans 0.2 s apart at 0.8
m/s and 0.1 rad/s, the raw sensor-frame IMU through each package's
imu_converter) on the CPU, with `register_grid_half_extent=(30, 30, 10)`
as the other port SLAM tests.  The JAX topology runs on the port's
frontend (as tests/test_torch_slam.py's `slam_runs`: JAX's jitted strict
curvature differs, ROADMAP Queue 3), and its scan end is made the
reference's, stamp + last point time, by wrapping its `make_deskew_info`
and its OdomQueue's `deskew_info` in the test (the JAX package passes the
next scan's stamp; no JAX file changes).  Then:

  * every emitted pose within 1e-4 of JAX's, equal keyframe counts, equal
    event topics and levels (the port's `*/dropped_points` warnings
    aside), the IMU-rate odometry queued for deskew within 1e-4, and
    tests/test_topology.py's accuracy bound (< 0.15 m) on the port;
  * without the wrapper, the difference is stated, on scan 4 (the first
    whose sweep the IMU odometry brackets): the port's scan end is stamp +
    last point time (0.0999 s after the stamp), JAX's the next stamp (0.2
    s); JAX's odometry increment spans twice the time (1.8-2.4 times the
    port's: 2.16 measured, 0.152 m against 0.070 m), and the positional
    deskew moves the scan's last points by the excess increment (0.082 m
    measured, bounded 0.06-0.10 m; ~0.08 m is the excess at 0.8 m/s).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from feature_base_pointcloud_registration_tpu.io.synthetic import (
    SyntheticWorld, constant_twist_platform)
from feature_base_pointcloud_registration_tpu.pipeline import (
    lio as jlio, slam as jslam)
from feature_base_pointcloud_registration_tpu.utils import log as jlog
from feature_base_pointcloud_registration_tpu_torch.convert import (
    deskew_info_to_torch, to_torch)
from feature_base_pointcloud_registration_tpu_torch.ops.projection import (
    project_scan)
from feature_base_pointcloud_registration_tpu_torch.pipeline import (
    lio as tlio)
from feature_base_pointcloud_registration_tpu_torch.pipeline.cloud_info import (  # noqa: E501
    RawScan as TRawScan)
from feature_base_pointcloud_registration_tpu_torch.utils import log as tlog
from test_topology import EXT_ROT, PARAMS as TOPO_PARAMS, _raw
from test_torch_batch import one_torch_thread  # noqa: F401
from test_torch_slam import _port_frontend as _port_features

CPU = torch.device("cpu")
PARAMS = dataclasses.replace(TOPO_PARAMS,
                             register_grid_half_extent=(30.0, 30.0, 10.0))
PERIOD = 0.2
N_SCANS = 6


def _drive():
    """The platform, the IMU batches before each scan and the scans (JAX
    RawScans) of tests/test_topology.py's end-to-end drive."""
    world = SyntheticWorld()
    duration = (N_SCANS + 2) * PERIOD + 0.3
    imu, states = constant_twist_platform(
        duration, ext_rot=EXT_ROT, ext_rpy=EXT_ROT,
        gravity=PARAMS.imu_gravity, w_body=(0.0, 0.0, 0.1),
        v_body=(0.8, 0.0, 0.0))
    gt = {round(t, 4): (R, p) for (t, R, p) in states}
    steps, i = [], 0
    for k in range(N_SCANS + 2):
        st = PERIOD * k
        batch = [s for s in imu[i:] if s[0] <= st]
        i += len(batch)
        R, p = gt[round(st, 4)]
        rpy = np.array([np.arctan2(R[2, 1], R[2, 2]),
                        np.arcsin(np.clip(-R[2, 0], -1, 1)),
                        np.arctan2(R[1, 0], R[0, 0])], np.float32)
        raw = _raw(world, np.concatenate([rpy, p]).astype(np.float32),
                   seed=70 + k)
        steps.append((st, batch, raw))
    return steps, gt


def _port_frontend(params, scan, deskew_info=None):
    """The port's frontend in the JAX pipeline, the JAX DeskewInfo carried
    over as the port's."""
    if deskew_info is not None:
        deskew_info = deskew_info_to_torch(
            jax.tree.map(np.asarray, deskew_info), device=CPU)
    return _port_features(params, scan, deskew_info)


def _imu_args(batch):
    return (np.array([b[0] for b in batch]), np.stack([b[1] for b in batch]),
            np.stack([b[2] for b in batch]), np.stack([b[3] for b in batch]))


def _sweep(raw):
    t = np.asarray(raw.time)[np.asarray(raw.valid)]
    return float(t[-1])


def _run(steps, reference_end):
    """Both topologies over the drive.  With `reference_end`, the JAX one
    gets stamp + last point time as its scan end.  Returns per step
    (port pose, JAX pose), the two topologies, their logs and the
    DeskewInfos each SLAM step received."""
    sweeps = {st: _sweep(raw) for st, _, raw in steps}
    logs = (jlog.EventLog(), tlog.EventLog())
    jtopo = jlio.LioTopology(PARAMS, max_keyframes=32, imu_window=16,
                             imu_max_samples=64)
    ttopo = tlio.LioTopology(PARAMS, max_keyframes=32, imu_window=16,
                             imu_max_samples=64, device=CPU)
    for topo, log in zip((jtopo, ttopo), logs):
        topo.slam._log = topo.odo._log = log
    seen = ([], [])
    for topo, got in zip((jtopo, ttopo), seen):
        step = topo.slam.step

        def spy(scan, timestamp, deskew_info=None, step=step, got=got):
            got.append(deskew_info)
            return step(scan, timestamp, deskew_info=deskew_info)
        topo.slam.step = spy

    jax_front, jax_dsk = jslam.process_scan, jlio.make_deskew_info
    odom_dsk = jtopo.odom_queue.deskew_info
    if reference_end:
        jlio.make_deskew_info = lambda params, t, g, scan_start, scan_end, \
            **kw: jax_dsk(params, t, g, scan_start=scan_start,
                          scan_end=scan_start + sweeps[scan_start], **kw)
        jtopo.odom_queue.deskew_info = lambda t_cur, t_next: odom_dsk(
            t_cur, t_cur + sweeps[t_cur])
    jslam.process_scan = _port_frontend
    poses = []
    try:
        for st, batch, raw in steps:
            if batch:
                jtopo.handle_imu(*_imu_args(batch))
                ttopo.handle_imu(*_imu_args(batch))
            want = jtopo.handle_cloud(st, raw)
            got = ttopo.handle_cloud(st, to_torch(jax.tree.map(
                np.asarray, raw), device=CPU))
            assert (want is None) == (got is None)
            if got is not None:
                poses.append((got.copy(), want.copy()))
    finally:
        jslam.process_scan, jlio.make_deskew_info = jax_front, jax_dsk
    return poses, (jtopo, ttopo), logs, seen


@pytest.fixture(scope="module")
def drive():
    return _drive()


def test_lio_topology_matches_jax(drive):
    steps, gt = drive
    poses, (jtopo, ttopo), logs, seen = _run(steps, reference_end=True)
    assert len(poses) == N_SCANS
    for got, want in poses:
        assert got.dtype == np.float32 and got.shape == (6,)
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    assert ttopo.slam.n_keyframes == jtopo.slam.n_keyframes >= 1
    assert ttopo.odo.done_first_opt and jtopo.odo.done_first_opt
    assert ttopo.odo.key == jtopo.odo.key
    jev = [(e["topic"], e["level"]) for e in logs[0].events]
    tev = [(e["topic"], e["level"]) for e in logs[1].events
           if not e["topic"].endswith("/dropped_points")]
    assert tev == jev
    # the deskew inputs the SLAM steps got: guesses, increments, flags
    for a, b in zip(seen[1], seen[0]):
        for f in ("odom_available", "odom_deskew_flag", "imu_available",
                  "reset_id"):
            assert bool(getattr(a, f)[0]) == bool(np.asarray(getattr(b, f)))
        for f in ("initial_guess", "odom_incre", "imu_rpy_init"):
            np.testing.assert_allclose(getattr(a, f)[0].numpy(),
                                       np.asarray(getattr(b, f)), atol=1e-4,
                                       rtol=0, err_msg=f)
    assert any(bool(d.odom_deskew_flag[0]) for d in seen[1])
    # the IMU-rate odometry queued for deskew
    assert len(ttopo.odom_queue.queue) == len(jtopo.odom_queue.queue) > 0
    for (ta, pa, ra), (tb, pb, rb) in zip(ttopo.odom_queue.queue,
                                          jtopo.odom_queue.queue):
        assert ta == tb and ra == rb
        np.testing.assert_allclose(pa, pb, atol=1e-4, rtol=0)
    # tests/test_topology.py's accuracy bound
    t_proc = [st for st, _, _ in steps[:N_SCANS]]
    errs = [np.linalg.norm(got[3:] - gt[round(t, 4)][1])
            for (got, _), t in zip(poses, t_proc)]
    assert max(errs) < 0.15, errs


def test_scan_end_differs_from_jax(drive):
    """The JAX topology as it is: its scan end is the next stamp."""
    steps, _ = drive
    captured = {"port": [], "jax": []}
    real = (tlio.make_deskew_info, jlio.make_deskew_info)

    def spy(name, fn):
        def wrapped(*a, **kw):
            captured[name].append((kw["scan_start"], kw["scan_end"]))
            return fn(*a, **kw)
        return wrapped

    tlio.make_deskew_info = spy("port", real[0])
    jlio.make_deskew_info = spy("jax", real[1])
    try:
        _, _, _, seen = _run(steps[:7], reference_end=False)
    finally:
        tlio.make_deskew_info, jlio.make_deskew_info = real
    # scan 4 (stamp 0.8 s), the first whose sweep the IMU odometry brackets
    j = 4
    sweep = _sweep(steps[j][2])
    assert abs(sweep - 0.0999) < 1e-4
    (t0, end_port), (_, end_jax) = captured["port"][j], captured["jax"][j]
    assert t0 == 0.8 and end_port == t0 + sweep and end_jax == 1.0
    # the odometry increment over the longer span (IMU odometry at ~0.8
    # m/s), and its excess at the sweep's end of the scan's deskewed points
    port, jax_ = seen[1][j], seen[0][j]
    assert bool(port.odom_deskew_flag[0]) and bool(jax_.odom_deskew_flag)
    inc_port = port.odom_incre[0].numpy()
    inc_jax = np.asarray(jax_.odom_incre)
    # the span doubles; the early IMU odometry is not yet at the truth's
    # 0.8 m/s (0.070 m over the port's 0.1 s, 0.152 over JAX's 0.2 s)
    assert 1.8 < np.linalg.norm(inc_jax) / np.linalg.norm(inc_port) < 2.4
    raw = TRawScan(*(a[None] for a in to_torch(
        jax.tree.map(np.asarray, steps[j][2]), device=CPU)))
    dsk_jax = port._replace(odom_incre=torch.from_numpy(inc_jax[None].copy()))
    pts = [project_scan(PARAMS, raw, d) for d in (port, dsk_jax)]
    ok = (pts[0].point_valid & pts[1].point_valid)[0]
    diff = torch.linalg.norm(pts[0].points[0] - pts[1].points[0],
                             dim=-1)[ok]
    assert 0.06 < float(diff.max()) < 0.10, float(diff.max())
    np.testing.assert_allclose(float(diff.max()),
                               np.linalg.norm(inc_jax - inc_port), rtol=0.05)
