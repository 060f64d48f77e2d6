"""Port parity: the single-scan localization path and its host modules.

  * `geom/se3.py`, `imu/conversion.py::imu_converter` and
    `ops/register.py::transform_update`: within 1e-6 of the JAX functions
    on numpy-seeded inputs, absolute and, for metre-scale coordinates,
    relative (float32; XLA's CPU backend contracts multiply-adds).
  * `ops/cropbox.py::crop_box`: bitwise.
  * `ops/register.py::grid_register_step` (the port's tables, fetch and
    rounds solver) against the JAX package's (octant-sentinel tables): pose
    within 1e-5 m / rad, iterations equal; on compact tables and, with the
    resident cap at 0, on raw ones, the two bitwise equal.
  * `pipeline/localization.py`: 3 chained steps of tests/test_pipeline.py's
    trajectory, poses within 1e-4 of the JAX pipeline's at every step; the
    interval gate; the `localization/odometry` events carry the JAX
    package's fields; `GlobalMap.from_pcd_dir` reads the port's
    `write_pcd` output as the JAX package's reader does (masks equal,
    points within 1e-5 m: the voxel sums run in another order; bitwise
    with `downsample=False`).
  * `pipeline/scan_buffer.py`: tests/test_scan_buffer.py's cases, each
    against the JAX package's classes (increments within 1e-6).

Both packages get the same reduced `Params`: the register grid spans
+-(30, 30, 10) m, not (60, 60, 25), so the port's raw surf block table fits
a test's memory; the map holds every point of the synthetic room either way.
"""

import warnings

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from feature_base_pointcloud_registration_tpu.config import Params
from feature_base_pointcloud_registration_tpu.geom import se3 as jse3
from feature_base_pointcloud_registration_tpu.imu.conversion import (
    imu_converter)
from feature_base_pointcloud_registration_tpu.io.synthetic import (
    SyntheticWorld, build_feature_map, simulate_scan)
from feature_base_pointcloud_registration_tpu.ops.cropbox import crop_box
from feature_base_pointcloud_registration_tpu.ops.register import (
    grid_register_step, transform_update)
from feature_base_pointcloud_registration_tpu.pipeline import (
    localization as jloc, scan_buffer as jsb)
from feature_base_pointcloud_registration_tpu.pipeline.cloud_info import (
    RawScan)
from feature_base_pointcloud_registration_tpu.pipeline.frontend import (
    process_scan)
from feature_base_pointcloud_registration_tpu_torch.convert import (
    global_map_to_torch, to_numpy, to_torch)
from feature_base_pointcloud_registration_tpu_torch.geom import se3 as tse3
from feature_base_pointcloud_registration_tpu_torch.imu import (
    conversion as timu)
from feature_base_pointcloud_registration_tpu_torch.io import pcd as tpcd
from feature_base_pointcloud_registration_tpu_torch.ops import (
    cropbox as tcrop, fetch as tfetch, register as treg)
from feature_base_pointcloud_registration_tpu_torch.parallel import (
    batch as tbatch)
from feature_base_pointcloud_registration_tpu_torch.pipeline import (
    cloud_info as tci, localization as tloc, scan_buffer as tsb)
from feature_base_pointcloud_registration_tpu_torch.utils import log as tlog
from test_pipeline import _trajectory
from test_torch_batch import one_torch_thread  # noqa: F401

PARAMS = Params(map_corner_cap=8192, map_surf_cap=65536, knn_chunk=2048,
                register_grid_half_extent=(30.0, 30.0, 10.0))
CPU = torch.device("cpu")
T = torch.from_numpy


def _close(got, want, atol=1e-6, rtol=1e-6):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# ------------------------------------------------------------- geometry

def _se3_inputs():
    r = np.random.RandomState(0)
    f = np.float32
    p6 = r.uniform(-1.2, 1.2, (16, 6)).astype(f)
    p6b = r.uniform(-1.2, 1.2, (16, 6)).astype(f)
    w = r.uniform(-1.5, 1.5, (16, 3)).astype(f)
    w[0] = 0.0
    w[1] = [1e-9, 0, 0]
    w[2] = [3.1, 0.2, -0.1]                     # near pi: the diagonal route
    q0 = r.normal(0, 1, (16, 4)).astype(f)
    q0 /= np.linalg.norm(q0, axis=-1, keepdims=True)
    q1 = r.normal(0, 1, (16, 4)).astype(f)
    q1 /= np.linalg.norm(q1, axis=-1, keepdims=True)
    q1[0] = q0[0]                               # parallel: the lerp
    q1[1] = -q0[1]                              # antipodal sign flip
    src = r.normal(0, 2, (3, 40, 3)).astype(f)
    return dict(p6=p6, p6b=p6b, w=w, q0=q0, q1=q1, src=src,
                wts=r.uniform(0.1, 1, (3, 40)).astype(f),
                pts=r.normal(0, 5, (16, 30, 3)).astype(f))


def _se3_case(m, x, name):
    """The function `name` of module m (jse3 or tse3) on inputs x (numpy
    converted by the caller) -> its outputs as a tuple."""
    T6 = m.pose6_to_matrix(x["p6"])
    if name == "euler_to_rot":
        out = m.euler_to_rot(x["p6"][:, 0], x["p6"][:, 1], x["p6"][:, 2])
    elif name == "rot_to_euler":
        out = m.rot_to_euler(T6[..., :3, :3])
    elif name == "pose6_to_matrix":
        out = T6
    elif name == "matrix_to_pose6":
        out = m.matrix_to_pose6(T6)
    elif name == "inverse_matrix":
        out = m.inverse_matrix(T6)
    elif name == "compose_pose6":
        out = m.compose_pose6(x["p6"], x["p6b"])
    elif name == "apply_transform":
        out = m.apply_transform(T6, x["pts"])
    elif name == "quat_from_euler":
        out = m.quat_from_euler(x["p6"][:, 0], x["p6"][:, 1], x["p6"][:, 2])
    elif name == "euler_from_quat":
        out = m.euler_from_quat(x["q0"])
    elif name == "quat_slerp":
        out = m.quat_slerp(x["q0"], x["q1"], 0.05)
    elif name == "so3_exp":
        out = m.so3_exp(x["w"])
    elif name == "so3_log":
        out = m.so3_log(m.so3_exp(x["w"]))
    else:                                       # kabsch
        Tk = m.pose6_to_matrix(x["p6"][:3])
        out = m.kabsch(x["src"], m.apply_transform(Tk, x["src"]), x["wts"])
    return out if isinstance(out, tuple) else (out,)


@pytest.mark.parametrize("name", [
    "euler_to_rot", "rot_to_euler", "pose6_to_matrix", "matrix_to_pose6",
    "inverse_matrix", "compose_pose6", "apply_transform", "quat_from_euler",
    "euler_from_quat", "quat_slerp", "so3_exp", "so3_log", "kabsch"])
def test_se3_matches_jax(name):
    x = _se3_inputs()
    want = _se3_case(jse3, {k: jnp.asarray(v) for k, v in x.items()}, name)
    got = _se3_case(tse3, {k: T(v) for k, v in x.items()}, name)
    for g, w in zip(got, want, strict=True):
        assert g.dtype == torch.float32
        g, w = g.numpy(), np.asarray(w)
        if name == "so3_log":
            # row 2 is 0.06 rad from pi, where the axis comes from the
            # diagonal's square roots: both packages land ~5e-6 from the
            # exact angle there, in float32
            _close(g[2], w[2], 1e-5)
            g, w = np.delete(g, 2, 0), np.delete(w, 2, 0)
        # kabsch: a float32 SVD, in another library
        _close(g, w, 2e-6 if name == "kabsch" else 1e-6)


def test_imu_converter_matches_jax():
    r = np.random.RandomState(1)
    acc = r.normal(0, 3, (20, 3)).astype(np.float32)
    gyr = r.normal(0, 1, (20, 3)).astype(np.float32)
    quat = r.normal(0, 1, (20, 4)).astype(np.float32)
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    quat[3] = 0.0                                # a 6-axis sample
    p = Params(ext_rpy=(0.0, 0.0, 1.0, 0.0, 1.0, 0.0, -1.0, 0.0, 0.0))
    for params in (Params(), p):
        want = imu_converter(params, *map(jnp.asarray, (acc, gyr, quat)))
        got = timu.imu_converter(params, *map(T, (acc, gyr, quat)))
        for g, w in zip(got[:3], want[:3]):
            _close(g.numpy(), w)
        np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
        assert not bool(got[3][3]) and bool(got[3][0])


@pytest.mark.parametrize("kw", [{}, dict(rotation_tolerance=0.2,
                                         z_tolerance=0.05)])
def test_transform_update_matches_jax(kw):
    r = np.random.RandomState(2)
    pose = r.uniform(-0.5, 0.5, (6, 6)).astype(np.float32)
    rpy = r.uniform(-0.5, 0.5, (6, 3)).astype(np.float32)
    rpy[2, 1] = 1.45                             # |pitch| >= 1.4: no fusion
    avail = np.array([True, True, True, False, True, False])
    got = treg.transform_update(T(pose), T(rpy), T(avail), **kw).numpy()
    for b in range(6):
        want = transform_update(jnp.asarray(pose[b]), jnp.asarray(rpy[b]),
                                jnp.asarray(avail[b]), **kw)
        _close(got[b], want)
    fused = avail & (np.abs(rpy[:, 1]) < 1.4)
    moved = np.abs(got[:, :2] - pose[:, :2]).max(1) > 1e-4
    if not kw:
        np.testing.assert_array_equal(moved, fused)


def test_crop_box_bitwise():
    r = np.random.RandomState(3)
    pts = r.uniform(-40, 40, (3000, 3)).astype(np.float32)
    pts[:10] = [30.0, 30.0, 10.0]                # on the box faces
    mask = r.uniform(size=3000) < 0.9
    center = np.array([1.0, -2.0, 0.5], np.float32)
    he = np.array([30.0, 30.0, 10.0], np.float32)
    for cap in (4096, 300):                      # 300: overflow dropped
        want = crop_box(jnp.asarray(pts), jnp.asarray(mask),
                        jnp.asarray(center), jnp.asarray(he), cap)
        got = tcrop.crop_box(T(pts), T(mask), T(center), T(he), cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(got[2]) > 300


# --------------------------------------------------- registration + pipeline

def _raw(world, pose, seed):
    s = simulate_scan(world, pose, seed=seed)
    raw = RawScan.from_numpy(s["xyz"], s["intensity"], s["ring"], s["time"])
    return raw._replace(valid=jnp.asarray(s["valid"]))


def _port_scan(raw):
    return to_torch(jax.tree.map(np.asarray, raw), device=CPU)


@pytest.fixture(scope="module")
def world_map():
    world = SyntheticWorld()
    jgm = jloc.GlobalMap(*build_feature_map(world, PARAMS.map_corner_cap,
                                            PARAMS.map_surf_cap))
    return world, jgm, global_map_to_torch(jgm, device=CPU)


@pytest.fixture(scope="module")
def step_case(world_map):
    """test_grid_register_step_matches_jax's scan, guess and local map, and
    the JAX step's result on them (computed once for both table kinds)."""
    world, jgm, tgm = world_map
    gt = np.array([0.0, 0.0, 0.3, 1.0, -0.5, 0.0], np.float32)
    guess = gt + np.array([0.01, -0.01, 0.03, 0.15, -0.1, 0.05], np.float32)
    _, feats = process_scan(PARAMS, _raw(world, gt, seed=4))
    he = tuple(PARAMS.local_map_half_extent)
    jmap = jloc._crop_local_map(
        jgm.corner_xyz, jgm.corner_mask, jgm.surf_xyz, jgm.surf_mask,
        jnp.asarray(guess[3:6]), half_extent=he,
        map_corner_cap=PARAMS.map_corner_cap,
        map_surf_cap=PARAMS.map_surf_cap)
    kw = dict(half_extent=tuple(PARAMS.register_grid_half_extent))
    want = jax.tree.map(np.asarray, grid_register_step(
        jmap, feats, jnp.asarray(guess), **kw))
    tmap, _ = tloc._crop_local_map(
        tgm.corner_xyz, tgm.corner_mask, tgm.surf_xyz, tgm.surf_mask,
        T(guess[3:6]), half_extent=he, map_corner_cap=PARAMS.map_corner_cap,
        map_surf_cap=PARAMS.map_surf_cap)
    for a, b in zip(tmap, jmap):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    tfeats = to_torch(jax.tree.map(lambda a: np.asarray(a)[None], feats),
                      device=CPU)
    return gt, guess, tmap, tfeats, want, kw


@pytest.mark.parametrize("tables", ["compact", "raw"])
def test_grid_register_step_matches_jax(step_case, tables, monkeypatch):
    """The step on compact tables (resident_fetch's route, this map's) and,
    with the resident cap at 0, on raw tables (block_fetch's route, a map
    whose compact table passes the cap): both the JAX step's result, and
    bitwise each other."""
    gt, guess, tmap, tfeats, want, kw = step_case
    center = T(guess[3:6])
    he = kw["half_extent"]
    res = compact = treg.grid_register_step(tmap, tfeats, T(guess[None]),
                                            **kw)
    if tables == "raw":
        monkeypatch.setattr(tbatch, "RESIDENT_TABLE_CAP", 0)
        res = treg.grid_register_step(tmap, tfeats, T(guess[None]), **kw)
        for a, b in zip(res, compact):
            assert torch.equal(a, b)
    step_tables = tbatch.build_map_planar_tables(tmap, center, he,
                                                 resident=True,
                                                 lower_pad=True)[:2]
    assert all(isinstance(t, tfetch.PlanarTable) == (tables == "compact")
               for t in step_tables)
    got = to_numpy(res)
    _close(got.pose6[0], want.pose6, 1e-5, rtol=0)
    assert got.iterations[0] == want.iterations
    assert bool(got.valid[0]) and bool(got.converged[0]) == bool(
        want.converged)
    assert np.abs(got.pose6[0, 3:] - gt[3:]).max() < 0.03


def test_localization_pipeline_matches_jax(world_map):
    world, jgm, tgm = world_map
    log = tlog.EventLog()
    tlog.set_logger(log)
    try:
        jpipe = jloc.LocalizationPipeline(PARAMS, jgm)
        tpipe = tloc.LocalizationPipeline(PARAMS, tgm)
        gt = _trajectory(3)
        jpipe.pose = gt[0].copy()
        tpipe.pose = gt[0].copy()
        for k, pose_gt in enumerate(gt):
            raw = _raw(world, pose_gt, seed=k)
            want = jpipe.step(raw, timestamp=0.2 * k)
            got = tpipe.step(_port_scan(raw), timestamp=0.2 * k)
            assert got.dtype == np.float32 and got.shape == (6,)
            _close(got, want, 1e-4, rtol=0)
            assert np.linalg.norm(got[3:] - pose_gt[3:]) < 0.06
    finally:
        tlog.set_logger(None)
    events = log.drain("localization/odometry")
    assert len(events) == 3
    assert set(events[0]) == {"t", "topic", "level", "time", "pose",
                              "n_corr", "iterations", "converged",
                              "degenerate", "gate_valid"}
    assert events[-1]["gate_valid"] is True and events[-1]["n_corr"] > 50


def test_localization_interval_gate(world_map):
    world, _, tgm = world_map
    pipe = tloc.LocalizationPipeline(PARAMS, tgm)
    raw = _port_scan(_raw(world, np.zeros(6, np.float32), seed=0))
    p0 = pipe.step(raw, timestamp=0.0).copy()
    p1 = pipe.step(raw, timestamp=0.05)       # under mappingProcessInterval
    assert pipe.time_last_processing == 0.0
    np.testing.assert_array_equal(p0, p1)


@pytest.mark.parametrize("downsample", [True, False])
def test_global_map_from_pcd_dir(tmp_path, downsample):
    world = SyntheticWorld()
    corner = world.corner_map_points(0.12)
    surf = world.surf_map_points(0.35)
    for name, pts in (("cloudCorner.pcd", corner), ("cloudSurf.pcd", surf)):
        tpcd.write_pcd(str(tmp_path / name), dict(
            x=pts[:, 0], y=pts[:, 1], z=pts[:, 2],
            intensity=np.zeros(len(pts), np.float32)))
    caps = dict(corner_cap=1 << 13, surf_cap=1 << 16)
    if not downsample:
        caps["downsample"] = False
    want = jloc.GlobalMap.from_pcd_dir(PARAMS, str(tmp_path), **caps)
    got = tloc.GlobalMap.from_pcd_dir(PARAMS, str(tmp_path), device=CPU,
                                      **caps)
    for name in ("corner_mask", "surf_mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    for name in ("corner_xyz", "surf_xyz"):
        _close(getattr(got, name).numpy(), getattr(want, name), 1e-5)
    if downsample:
        assert 1000 < int(got.surf_mask.sum()) < len(surf)
    else:
        # the points as written, in file order: bitwise
        for name in ("corner_xyz", "surf_xyz"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(want, name)))
        assert int(got.surf_mask.sum()) == len(surf)
        assert int(got.corner_mask.sum()) == len(corner)


# ------------------------------------------------------------ scan buffer

def _scans(n=8):
    r = np.random.RandomState(0)
    arrays = (r.randn(n, 3).astype(np.float32), np.zeros(n, np.float32),
              np.zeros(n, np.int32), np.zeros(n, np.float32))
    return (jsb.RawScan.from_numpy(*arrays),
            tci.RawScan.from_numpy(*arrays, device=CPU))


@pytest.mark.parametrize("has_time", [True, False])
def test_scan_buffer_matches_jax(has_time):
    jscan, tscan = _scans()
    outs = []
    for mod, scan in ((jsb, jscan), (tsb, tscan)):
        buf = mod.ScanBuffer()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = [buf.push(scan, 0.1 * k, has_time=has_time)
                   for k in range(4)]
        outs.append(([None if g is None else (g.time_scan_cur,
                                              g.time_scan_next,
                                              g.deskew_enabled)
                      for g in got], len(caught)))
    assert outs[0] == outs[1]
    assert outs[1][0][:2] == [None, None]
    assert outs[1][1] == (0 if has_time else 1)


@pytest.mark.parametrize("kw", [dict(is_dense=False), dict(has_ring=False)])
def test_scan_buffer_fatal_checks(kw):
    _, tscan = _scans()
    with pytest.raises(tsb.ScanFieldError):
        tsb.ScanBuffer().push(tscan, 0.0, **kw)


@pytest.mark.parametrize("case", ["brackets", "reset_mismatch", "empty",
                                  "no_end", "rotating"])
def test_odom_queue_matches_jax(case):
    queues = (jsb.OdomQueue(), tsb.OdomQueue())
    span = (0.1, 0.3) if case == "reset_mismatch" else (0.1, 0.2)
    n = {"empty": 0, "no_end": 4}.get(case, 10)
    for k in range(n):
        pose = np.array([0, 0, 0.02 * k if case == "rotating" else 0.0,
                         0.1 * k, 0.03 * k, 0], np.float32)
        rid = (0 if k < 5 else 1) if case == "reset_mismatch" else 7
        for q in queues:
            q.push(0.05 * k, pose, reset_id=rid)
    want, got = (q.deskew_info(*span) for q in queues)
    assert [bool(want[0]), want[2], bool(want[4])] == [
        bool(got[0]), got[2], bool(got[4])]
    np.testing.assert_array_equal(got[1], want[1])
    _close(got[3], want[3])
    assert got[3].dtype == np.float32


def test_odom_queue_from_quat_matches_jax():
    q = np.array([0.1, -0.2, 0.3, 0.9])
    q /= np.linalg.norm(q)
    want = jsb.OdomQueue.from_quat(1.5, [1.0, 2.0, 3.0], q, 4)
    got = tsb.OdomQueue.from_quat(1.5, [1.0, 2.0, 3.0], q, 4)
    assert got[0] == want[0] and got[2] == want[2]
    _close(got[1], want[1])
