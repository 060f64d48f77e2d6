"""Port parity: multi-session map merging (`pipeline/multisession.py`).

The two synthetic sessions of tests/test_multisession.py (`_two_sessions`:
7 keyframes each, B's frame offset by a yaw and a translation) go through
the JAX package's `merge_sessions(coarse=False, link_radius=6.0,
link_stride=2)` and the port's, on the CPU, once each (a module-scoped
fixture).  Both run with `Params(register_grid_half_extent=(30, 30, 10))`,
as the port's other SLAM tests do: the default +-(60, 60, 25) m grid's
tables are too large for a small CPU host.  Tolerances (float32):

  * `align_sessions` (the merge's step 1, ICP over the voxel-downsampled
    global clouds): the transform within 1e-4 of JAX's (2.0e-5 measured)
    and tests/test_multisession.py's bounds on the recovered offset;
  * `merge_sessions`: the same link pairs, each link's measurement within
    1e-4 and its sigma equal, the optimized poses within 1e-4 (5.6e-6
    measured), and tests/test_multisession.py's accuracy bounds;
  * `save_merged_map` on one MergeResult (JAX's): the same files, point
    counts equal, points within 1e-4.  On each package's own result the
    counts are equal too, but a point within 5e-6 m of a voxel face may
    land in the neighboring voxel and move both voxels' centroids (by up
    to 0.05 m measured), so those points are not compared;
  * `merge_many` of two sessions equals `merged_session` of the same
    merge; `load_session` round-trips keyframes.npz as JAX's does.
"""

import os

import jax
import numpy as np
import pytest
import torch

from feature_base_pointcloud_registration_tpu.config import Params as JParams
from feature_base_pointcloud_registration_tpu.geom.se3 import (
    pose6_to_matrix as jpose6_to_matrix)
from feature_base_pointcloud_registration_tpu.io.pcd import read_pcd
from feature_base_pointcloud_registration_tpu.pipeline import (
    multisession as jms)
from feature_base_pointcloud_registration_tpu_torch.config import Params
from feature_base_pointcloud_registration_tpu_torch.pipeline import (
    multisession as tms)
from test_multisession import _two_sessions
from test_torch_batch import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
HALF = (30.0, 30.0, 10.0)
MERGE = dict(coarse=False, link_radius=6.0, link_stride=2)


@pytest.fixture(scope="module")
def merged():
    """(JAX sessions, port sessions, offset, ground truth, JAX result,
    port result), each merge run once on one torch thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        sa, sb, off, gts = _two_sessions()
        ta, tb = tms.Session(*sa), tms.Session(*sb)
        jres = jms.merge_sessions(
            jax.random.PRNGKey(1), sa, sb,
            params=JParams(register_grid_half_extent=HALF), **MERGE)
        tres = tms.merge_sessions(
            None, ta, tb, params=Params(register_grid_half_extent=HALF),
            device=CPU, **MERGE)
    finally:
        torch.set_num_threads(n)
    return (sa, sb), (ta, tb), off, gts, jres, tres


def test_align_sessions_matches_jax(merged):
    _, _, off, _, jres, tres = merged
    np.testing.assert_allclose(tres.transform_ab, jres.transform_ab,
                               atol=1e-4)
    assert tres.transform_ab.dtype == np.float32
    np.testing.assert_allclose(tres.align_fitness, jres.align_fitness,
                               rtol=1e-3)
    off_T = np.array(jpose6_to_matrix(jax.numpy.asarray(off)))
    err = tres.transform_ab @ off_T - np.eye(4)
    assert np.abs(err[:3, 3]).max() < 0.05, err
    assert np.abs(err[:3, :3]).max() < 0.02, err


def test_merge_sessions_matches_jax(merged):
    _, _, _, (gts_a, gts_b), jres, tres = merged
    assert ([(ln.idx_a, ln.idx_b) for ln in tres.links]
            == [(ln.idx_a, ln.idx_b) for ln in jres.links])
    assert len(tres.links) >= 2
    for t, j in zip(tres.links, jres.links):
        np.testing.assert_allclose(t.meas, j.meas, atol=1e-4)
        np.testing.assert_array_equal(t.sigma, j.sigma)
        assert abs(t.correction - j.correction) < 1e-4
    np.testing.assert_allclose(tres.poses_a, jres.poses_a, atol=1e-4)
    np.testing.assert_allclose(tres.poses_b, jres.poses_b, atol=1e-4)
    err_b = np.linalg.norm(tres.poses_b[:, 3:] - np.stack(gts_b)[:, 3:],
                           axis=1)
    err_a = np.linalg.norm(tres.poses_a[:, 3:] - np.stack(gts_a)[:, 3:],
                           axis=1)
    assert err_b.max() < 0.15 and err_a.max() < 0.1, (err_a, err_b)


def _pcds(d):
    return {n: read_pcd(os.path.join(d, n)) for n in sorted(os.listdir(d))}


def test_save_merged_map_matches_jax(merged, tmp_path):
    (sa, sb), (ta, tb), _, _, jres, tres = merged
    jms.save_merged_map(str(tmp_path / "jax"), jres, sa, sb)
    tms.save_merged_map(str(tmp_path / "same"), jres, ta, tb)
    tms.save_merged_map(str(tmp_path / "port"), tres, ta, tb)
    ref, same, own = (_pcds(tmp_path / d) for d in ("jax", "same", "port"))
    assert ref.keys() == same.keys() == own.keys() == {
        "cloudCorner.pcd", "cloudGlobal.pcd", "cloudSurf.pcd",
        "trajectory.pcd"}
    for name in ref:
        assert ref[name].keys() == same[name].keys()
        for f in ref[name]:
            assert len(same[name][f]) == len(own[name][f]) == len(
                ref[name][f])
            np.testing.assert_allclose(same[name][f], ref[name][f],
                                       atol=1e-4, err_msg=name + f)
    for f in ("x", "y", "z"):
        np.testing.assert_allclose(own["trajectory.pcd"][f],
                                   ref["trajectory.pcd"][f], atol=1e-4)
    from feature_base_pointcloud_registration_tpu_torch.pipeline.localization import (  # noqa: E501
        GlobalMap)
    gm = GlobalMap.from_pcd_dir(Params(), str(tmp_path / "port"),
                                corner_cap=16384, surf_cap=65536, device=CPU)
    assert int(gm.corner_mask.sum()) > 100 and int(gm.surf_mask.sum()) > 1000


def test_merge_many_folds_like_merged_session(one_torch_thread,  # noqa: F811
                                              merged):
    """merge_many of [A, B] with the alignment known is merged_session of
    merge_sessions with it (a fresh generator per pair, unused here)."""
    _, (ta, tb), _, _, _, tres = merged
    kw = dict(params=Params(register_grid_half_extent=HALF),
              transform_ab=tres.transform_ab, link_radius=6.0,
              link_stride=2)
    res = tms.merge_sessions(None, ta, tb, device=CPU, **kw)
    acc = tms.merge_many(torch.Generator().manual_seed(0), [ta, tb],
                         device=CPU, **kw)
    want = tms.merged_session(res, ta, tb)
    assert acc.n == ta.n + tb.n == 14
    for f in tms.Session._fields:
        np.testing.assert_array_equal(getattr(acc, f), getattr(want, f))
    with pytest.raises(ValueError):
        tms.merge_many(torch.Generator(), [], device=CPU)


def test_load_session_roundtrip(tmp_path):
    sa = _two_sessions()[0]
    d = str(tmp_path / "sess")
    os.makedirs(d)
    np.savez_compressed(os.path.join(d, "keyframes.npz"),
                        poses=sa.poses, times=sa.times,
                        corner=sa.corner, corner_mask=sa.corner_mask,
                        surf=sa.surf, surf_mask=sa.surf_mask)
    port, ref = tms.load_session(d), jms.load_session(d)
    assert port.n == ref.n == 7
    for f in tms.Session._fields:
        np.testing.assert_array_equal(getattr(port, f), getattr(ref, f))
        np.testing.assert_array_equal(getattr(port, f), getattr(sa, f))
