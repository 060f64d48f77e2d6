"""Port parity: checkpoint/resume and the respawn supervisor.

The port's `pipeline/checkpoint.py` and `utils/supervise.py` on the port's
`SlamPipeline` (CPU), over the 8 scans of tests/test_checkpoint.py, with
`register_grid_half_extent=(30, 30, 10)` as the other port SLAM tests:

  * save at scan 5, a fresh pipeline loads it and runs scans 5-7: keyframe
    poses, trajectory and masks bitwise equal to the uninterrupted run;
  * the supervisor rebuilds from the checkpoint through two injected
    crashes (the final keyframe poses bitwise equal to the uninterrupted
    run, the cursor at the end) and re-raises after its maximum;
  * across packages: a checkpoint written by the JAX package loads into the
    port and one written by the port loads into the JAX package (the same
    keys, the loaded host state equal to the saver's), and the next 2
    steps of the loaded pipeline are within 1e-4 of the saver's own next 2
    steps.  The JAX pipeline runs on the port's frontend, as in
    tests/test_torch_slam.py, so both back ends see the same features.
"""

import numpy as np
import jax
import pytest
import torch

from feature_base_pointcloud_registration_tpu.config import Params
from feature_base_pointcloud_registration_tpu.pipeline import (
    checkpoint as jckpt, slam as jslam)
from feature_base_pointcloud_registration_tpu_torch.convert import to_torch
from feature_base_pointcloud_registration_tpu_torch.pipeline import (
    checkpoint as tckpt, slam as tslam)
from feature_base_pointcloud_registration_tpu_torch.utils import (
    supervise as tsup)
from test_checkpoint import CRASH_AT, N_SCANS, _scan
from test_torch_batch import one_torch_thread  # noqa: F401
from test_torch_slam import _port_frontend

CPU = torch.device("cpu")
PARAMS = Params(map_corner_cap=8192, map_surf_cap=32768,
                register_grid_half_extent=(30.0, 30.0, 10.0))


def _build():
    return tslam.SlamPipeline(PARAMS, max_keyframes=64, device=CPU)


@pytest.fixture(scope="module")
def scans():
    """(JAX RawScans, the port's) of tests/test_checkpoint.py."""
    jax_scans = [_scan(k) for k in range(N_SCANS)]
    return jax_scans, [to_torch(jax.tree.map(np.asarray, s), device=CPU)
                       for s in jax_scans]


@pytest.fixture(scope="module")
def uninterrupted(scans):
    pipe = _build()
    for k, raw in enumerate(scans[1]):
        pipe.step(raw, timestamp=0.2 * k)
    return pipe


def test_checkpoint_roundtrip_resumes_bitwise(scans, uninterrupted,
                                              tmp_path):
    ref = uninterrupted
    pipe = _build()
    for k in range(CRASH_AT):
        pipe.step(scans[1][k], timestamp=0.2 * k)
    tckpt.save_checkpoint(pipe, str(tmp_path))
    assert tckpt.has_checkpoint(str(tmp_path))
    resumed = tckpt.load_checkpoint(_build(), str(tmp_path))
    assert resumed.n_keyframes == pipe.n_keyframes
    assert resumed._dev_clouds is None       # re-uploaded at the next step
    for k in range(CRASH_AT, N_SCANS):
        resumed.step(scans[1][k], timestamp=0.2 * k)
    n = ref.n_keyframes
    assert resumed.n_keyframes == n >= 2
    np.testing.assert_array_equal(resumed.kf_poses[:n], ref.kf_poses[:n])
    np.testing.assert_array_equal(np.stack(resumed.trajectory[CRASH_AT:]),
                                  np.stack(ref.trajectory[CRASH_AT:]))
    np.testing.assert_array_equal(resumed.kf_corner_mask[:n],
                                  ref.kf_corner_mask[:n])
    # a checkpoint of other capacities is refused
    with pytest.raises(ValueError, match="max_keyframes"):
        tckpt.load_checkpoint(tslam.SlamPipeline(PARAMS, max_keyframes=32,
                                                 device=CPU), str(tmp_path))


def test_supervisor_respawns_and_gives_up(scans, uninterrupted, tmp_path):
    crashes = {"left": 2}

    def step(pipe, item):
        k, raw = item
        if k == CRASH_AT and crashes["left"] > 0:
            crashes["left"] -= 1
            raise RuntimeError("injected crash")
        pipe.step(raw, timestamp=0.2 * k)

    pipe, n_respawns = tsup.run_supervised(
        _build, list(enumerate(scans[1])), step, str(tmp_path / "a"),
        checkpoint_every=1, max_respawns=5)
    assert n_respawns == 2 and crashes["left"] == 0
    assert tsup.load_cursor(str(tmp_path / "a")) == N_SCANS
    n = uninterrupted.n_keyframes
    assert pipe.n_keyframes == n
    np.testing.assert_array_equal(pipe.kf_poses[:n],
                                  uninterrupted.kf_poses[:n])

    def broken(pipe, item):
        raise RuntimeError("always broken")

    with pytest.raises(RuntimeError, match="always broken"):
        tsup.run_supervised(_build, list(enumerate(scans[1][:2])), broken,
                            str(tmp_path / "b"), max_respawns=2)


def _keys(directory):
    with np.load(f"{directory}/{tckpt.CHECKPOINT_FILE}") as z:
        return sorted(z.files)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_crosses_packages(scans, tmp_path, writer):
    jax_frontend = jslam.process_scan
    jslam.process_scan = _port_frontend
    try:
        jpipe = jslam.SlamPipeline(PARAMS, max_keyframes=64)
        tpipe = _build()
        saver, loader = ((jpipe, tpipe) if writer == "jax"
                         else (tpipe, jpipe))
        save, load = ((jckpt.save_checkpoint, tckpt.load_checkpoint)
                      if writer == "jax" else
                      (tckpt.save_checkpoint, jckpt.load_checkpoint))
        raws = scans[0] if saver is jpipe else scans[1]
        for k in range(CRASH_AT):
            saver.step(raws[k], timestamp=0.2 * k)
        save(saver, str(tmp_path))
        load(loader, str(tmp_path))
        assert loader.n_keyframes == saver.n_keyframes >= 2
        n = saver.n_keyframes
        for name in ("kf_poses", "kf_corner", "kf_surf_mask", "odom_meas",
                     "pose_cov", "pose"):
            np.testing.assert_array_equal(np.asarray(getattr(loader, name)),
                                          np.asarray(getattr(saver, name)),
                                          err_msg=name)
        assert loader.reset_id == saver.reset_id
        # either package writes the same keys
        other = tmp_path / "other"
        (tckpt.save_checkpoint if writer == "jax"
         else jckpt.save_checkpoint)(loader, str(other))
        assert _keys(str(other)) == _keys(str(tmp_path))
        for k in range(CRASH_AT, CRASH_AT + 2):
            got = [p.step((scans[0] if p is jpipe else scans[1])[k],
                          timestamp=0.2 * k).copy() for p in (loader, saver)]
            np.testing.assert_allclose(got[0], got[1], atol=1e-4, rtol=0)
        np.testing.assert_allclose(loader.kf_poses[:n], saver.kf_poses[:n],
                                   atol=1e-4, rtol=0)
    finally:
        jslam.process_scan = jax_frontend
