"""Port parity: KITTI raw I/O, the generated drive and the timing harness.

The same files go through the JAX package's `io/kitti.py` and the port's
`io/kitti.py` on the CPU.  Tolerances: none — every array is bitwise
equal.  The scans are decoded by the same host C++ (`native/`, copied into
the port) or its NumPy fallback, and the oxts parsing is the same host
NumPy:

  * `load_scan` and `iter_scans` on the three HDL-64 scans of
    tests/data/kitti_mini (xyz, intensity, ring, time, valid), also when
    `max_points` truncates a scan (and both warn);
  * `load_oxts_poses`, `load_oxts_imu`, `load_oxts_gps` and `load_times`;
  * `io/kitti_drive.make_drive` writes the same bytes as
    scripts/make_kitti_drive.py for a 3-scan drive (every file: the .bin
    scans, the oxts records, both timestamp files, gt_poses.npy);
  * `utils/timing`: `StageTimer` and `TicToc` on CPU tensors, and
    `trace_profile` writing a Chrome trace;
  * `config.FLT_MAX`, `DEG2RAD`, `RAD2DEG` and `trace_profile`'s default
    directory equal the JAX package's.
"""

import filecmp
import importlib.util
import os
import warnings

import numpy as np
import pytest
import torch

from feature_base_pointcloud_registration_tpu.io import kitti as jk
from feature_base_pointcloud_registration_tpu_torch.io import kitti as tk
from test_torch_batch import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIX = os.path.join(REPO, "tests", "data", "kitti_mini")
VDIR = os.path.join(FIX, "velodyne_points", "data")
CPU = torch.device("cpu")
FIELDS = ("xyz", "intensity", "ring", "time", "valid")


def _assert_scans_equal(port, ref):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(port, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
        assert getattr(port, f).device == CPU


@pytest.mark.parametrize("max_points", [512, 4096])
def test_load_scan_matches_jax(one_torch_thread, max_points):  # noqa: F811
    paths = tk.scan_files(VDIR)
    assert paths == jk.scan_files(VDIR) and len(paths) == 3
    for path in paths:
        _assert_scans_equal(tk.load_scan(path, max_points, device=CPU),
                            jk.load_scan(path, max_points))


def test_iter_scans_matches_jax(one_torch_thread):  # noqa: F811
    port = list(tk.iter_scans(VDIR, max_points=4096, device=CPU))
    ref = list(jk.iter_scans(VDIR, max_points=4096))
    assert len(port) == len(ref) == 3
    for p, r in zip(port, ref):
        _assert_scans_equal(p, r)


def test_truncation_matches_jax_and_warns(one_torch_thread,  # noqa: F811
                                          monkeypatch):
    """A scan over max_points keeps its first max_points points in both
    packages, and each warns once."""
    monkeypatch.setattr(tk, "_warned_truncation", False)
    monkeypatch.setattr(jk, "_warned_truncation", False)
    path = tk.scan_files(VDIR)[0]
    for mod, kw in ((tk, {"device": CPU}), (jk, {})):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            out = mod.load_scan(path, 100, **kw)
            mod.load_scan(path, 100, **kw)
        msgs = [str(w.message) for w in caught]
        assert len(msgs) == 1 and "truncated to max_points=100" in msgs[0]
        if mod is tk:
            port = out
        else:
            ref = out
    _assert_scans_equal(port, ref)
    assert int(port.valid.sum()) == 100


def test_oxts_streams_match_jax(tmp_path):
    odir = os.path.join(FIX, "oxts")
    np.testing.assert_array_equal(tk.load_oxts_poses(odir),
                                  jk.load_oxts_poses(odir))
    for name in ("load_oxts_imu", "load_oxts_gps"):
        port, ref = getattr(tk, name)(odir), getattr(jk, name)(odir)
        assert port.keys() == ref.keys()
        for key in ref:
            np.testing.assert_array_equal(port[key], ref[key], err_msg=key)
            assert port[key].dtype == ref[key].dtype
    for sub in ("oxts", "velodyne_points"):
        d = os.path.join(FIX, sub)
        np.testing.assert_array_equal(tk.load_times(d, 3),
                                      jk.load_times(d, 3))
    # no timestamps.txt: the 10 Hz index clock in both
    np.testing.assert_array_equal(tk.load_times(str(tmp_path), 4),
                                  jk.load_times(str(tmp_path), 4))


def test_make_drive_writes_the_scripts_bytes(one_torch_thread,  # noqa: F811
                                             tmp_path):
    from feature_base_pointcloud_registration_tpu_torch.io import (
        kitti_drive)

    spec = importlib.util.spec_from_file_location(
        "make_kitti_drive", os.path.join(REPO, "scripts",
                                         "make_kitti_drive.py"))
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    gt_port = kitti_drive.make_drive(str(tmp_path / "port"), n_scans=3)
    gt_ref = script.make_drive(str(tmp_path / "ref"), n_scans=3)
    np.testing.assert_array_equal(gt_port, gt_ref)
    files = []
    for root, _, names in os.walk(tmp_path / "ref"):
        files += [os.path.relpath(os.path.join(root, n), tmp_path / "ref")
                  for n in names]
    assert len(files) == 3 + 3 + 2 + 1, files
    for rel in files:
        assert filecmp.cmp(tmp_path / "port" / rel, tmp_path / "ref" / rel,
                           shallow=False), rel
    assert (kitti_drive.oxts_record(*kitti_drive.drive_pose(2, 3)[:3], 1.5)
            == script.oxts_record(*script.drive_pose(2, 3)[:3], 1.5))


def test_stage_timer_and_tictoc_on_cpu(tmp_path):
    from feature_base_pointcloud_registration_tpu_torch.utils import (
        StageTimer, TicToc, trace_profile)
    from feature_base_pointcloud_registration_tpu_torch.utils.timing import (
        block_until_ready)

    tt = TicToc()
    st = StageTimer()
    x = torch.ones(64, 64)
    for _ in range(3):
        with st.stage("matmul", block=x):
            y = x @ x
            st.block({"y": y, "pair": (y, [y.sum()]), "other": 3})
    with st.stage("sum"):
        y.sum()
    assert st.counts == {"matmul": 3, "sum": 1}
    assert all(t >= 0 for t in st.totals.values())
    lines = st.summary().splitlines()
    assert len(lines) == 2 and lines[0].split(":")[0].strip() in (
        "matmul", "sum")
    assert "x3" in st.summary() and "ms/call" in lines[0]
    block_until_ready(None)
    assert tt.toc() >= 0.0
    with trace_profile(str(tmp_path / "trace")) as d:
        (x @ x).sum()
    assert os.path.getsize(os.path.join(d, "trace.json")) > 0


def test_constants_and_trace_profile_default_match_jax():
    """config's FLT_MAX / DEG2RAD / RAD2DEG and trace_profile's default
    directory: the JAX package's, exactly."""
    import inspect

    from feature_base_pointcloud_registration_tpu import config as jconfig
    from feature_base_pointcloud_registration_tpu.utils import (
        timing as jtiming)
    from feature_base_pointcloud_registration_tpu_torch import (
        config as tconfig)
    from feature_base_pointcloud_registration_tpu_torch.utils import (
        timing as ttiming)

    for name in ("FLT_MAX", "DEG2RAD", "RAD2DEG"):
        got, want = getattr(tconfig, name), getattr(jconfig, name)
        assert type(got) is type(want) and got == want, name
    assert tconfig.FLT_MAX == float(np.finfo(np.float32).max)

    def default(fn):
        return inspect.signature(fn).parameters["log_dir"].default

    assert default(ttiming.trace_profile) == default(jtiming.trace_profile)
