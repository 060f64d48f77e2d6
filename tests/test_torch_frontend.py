"""Port parity: the batched frontend (projection, fast and strict feature
picking, feature downsampling) against the JAX package on two full VLP-16
scans.

Tolerances:
  * CloudInfo: every field bit-equal except `point_range`, which XLA's CPU
    backend contracts into fma(z, z, fma(x, x, y*y)) and eager PyTorch does
    not: it must equal the uncontracted float32 sqrt(x*x + y*y + z*z) of the
    (bit-equal) points exactly, and the JAX value to 1 ulp (rtol 2.4e-7).
  * extract_features (fast picking): identical corner sets (same points in
    the same slots); surf centroids within 1e-5 m (the per-ring voxel sums
    run in another order: float64 scatter-add vs float32 segmented scan).
  * downsample_features: masks equal, coordinates within 1e-5 m.
  * process_scan(Params()) picks strictly, as the JAX package's does: the
    same tolerances (corner sets bitwise before downsampling).
  * process_scan(downsample=False) returns the picked features as the JAX
    package's does, held as extract_features is above.
"""

import dataclasses


import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from feature_base_pointcloud_registration_tpu.config import Params
from feature_base_pointcloud_registration_tpu.io.synthetic import (
    SyntheticWorld, simulate_scan)
from feature_base_pointcloud_registration_tpu.ops.features import (
    extract_features)
from feature_base_pointcloud_registration_tpu.ops.projection import (
    project_scan)
from feature_base_pointcloud_registration_tpu.pipeline.cloud_info import (
    RawScan)
from feature_base_pointcloud_registration_tpu.pipeline.frontend import (
    downsample_features, process_scan)
from feature_base_pointcloud_registration_tpu_torch.convert import (
    params_from_dict, to_numpy, to_torch)
from feature_base_pointcloud_registration_tpu_torch.ops import (
    features as tfeat, projection as tproj, voxel as tvox)
from feature_base_pointcloud_registration_tpu_torch.pipeline import (
    frontend as tfront)
from test_torch_batch import one_torch_thread  # noqa: F401

PARAMS = Params()
FAST = dataclasses.replace(PARAMS, strict_feature_pick=False)


@pytest.fixture(scope="module")
def scans():
    """Two scans from the synthetic world: (jax RawScans, port batch)."""
    world = SyntheticWorld()
    jraws = []
    for seed, pose in ((3, [0.02, -0.01, 0.3, 1.0, 2.0, 0.0]),
                       (5, [0.0, 0.01, -0.7, -3.0, 1.5, 0.1])):
        s = simulate_scan(world, pose, seed=seed)
        raw = RawScan.from_numpy(s["xyz"], s["intensity"], s["ring"],
                                 s["time"])
        jraws.append(raw._replace(valid=jnp.asarray(s["valid"])))
    batch = jax.tree.map(lambda *a: np.stack([np.asarray(x) for x in a]),
                         *jraws)
    return jraws, to_torch(batch, device="cpu")


@pytest.fixture(scope="module")
def jax_frontend(scans):
    jraws, _ = scans
    out = []
    for raw in jraws:
        cloud = project_scan(PARAMS, raw, None)
        feats = extract_features(PARAMS, cloud, strict=False)
        out.append(jax.tree.map(np.asarray, (
            cloud, feats, downsample_features(PARAMS, feats))))
    return out


def test_params_round_trip():
    p = params_from_dict(dataclasses.asdict(PARAMS))
    assert dataclasses.asdict(p) == dataclasses.asdict(PARAMS)


def test_project_scan_bit_equal(scans, jax_frontend):
    _, traw = scans
    cloud = to_numpy(tproj.project_scan(PARAMS, traw))
    for b, (jcloud, _, _) in enumerate(jax_frontend):
        for name in jcloud._fields:
            want = getattr(jcloud, name)
            got = getattr(cloud, name)[b]
            assert got.dtype == want.dtype, name
            if name == "point_range":
                p = cloud.points[b]
                plain = np.sqrt(p[:, 0] * p[:, 0] + p[:, 1] * p[:, 1]
                                + p[:, 2] * p[:, 2])
                np.testing.assert_array_equal(got, plain)
                np.testing.assert_allclose(got, want, rtol=2.4e-7, atol=0)
            else:
                np.testing.assert_array_equal(got, want, err_msg=name)


def test_extract_features_fast(scans, jax_frontend):
    _, traw = scans
    cloud = tproj.project_scan(PARAMS, traw)
    feats = to_numpy(tfeat.extract_features(PARAMS, cloud, strict=False))
    for b, (_, jfeats, _) in enumerate(jax_frontend):
        np.testing.assert_array_equal(feats.corner_mask[b], jfeats.corner_mask)
        np.testing.assert_array_equal(feats.corner_xyz[b], jfeats.corner_xyz)
        np.testing.assert_array_equal(feats.surf_mask[b], jfeats.surf_mask)
        np.testing.assert_allclose(feats.surf_xyz[b], jfeats.surf_xyz,
                                   rtol=0, atol=1e-5)
        assert jfeats.corner_mask.sum() > 100 and jfeats.surf_mask.sum() > 1000


def test_downsample_features(scans, jax_frontend):
    _, traw = scans
    _, feats = tfront.process_scan(FAST, traw)
    feats = to_numpy(feats)
    for b, (_, _, jds) in enumerate(jax_frontend):
        for name in ("corner_mask", "surf_mask"):
            np.testing.assert_array_equal(getattr(feats, name)[b],
                                          getattr(jds, name))
        for name in ("corner_xyz", "surf_xyz"):
            np.testing.assert_allclose(getattr(feats, name)[b],
                                       getattr(jds, name), rtol=0, atol=1e-5)


@pytest.mark.parametrize("cap", [7, 64])
def test_voxel_downsample_matches_jax(cap):
    from feature_base_pointcloud_registration_tpu.ops.voxel import (
        voxel_downsample)
    r = np.random.RandomState(cap)
    pts = r.uniform(-3, 3, (2, 300, 3)).astype(np.float32)
    mask = r.uniform(size=(2, 300)) < 0.8
    got = to_numpy(tvox.voxel_downsample(torch.from_numpy(pts),
                                         torch.from_numpy(mask), 0.7, cap))
    for b in range(2):
        want = jax.tree.map(np.asarray, voxel_downsample(
            jnp.asarray(pts[b]), jnp.asarray(mask[b]), 0.7, cap))
        np.testing.assert_array_equal(got[1][b], want[1])
        assert got[2][b] == want[2]
        np.testing.assert_allclose(got[0][b], want[0], rtol=0, atol=1e-5)


def test_process_scan_default_params_picks_strictly(scans):
    """process_scan(Params()) in both packages: strict picking."""
    jraws, traw = scans
    assert PARAMS.strict_feature_pick
    cloud, feats = tfront.process_scan(PARAMS, traw)
    raw_feats = to_numpy(tfeat.extract_features(PARAMS, cloud, strict=True))
    feats = to_numpy(feats)
    for b, raw in enumerate(jraws):
        _, want = jax.tree.map(np.asarray, process_scan(PARAMS, raw))
        want_raw = jax.tree.map(np.asarray, extract_features(
            PARAMS, project_scan(PARAMS, raw, None), strict=True))
        np.testing.assert_array_equal(raw_feats.corner_mask[b],
                                      want_raw.corner_mask)
        np.testing.assert_array_equal(raw_feats.corner_xyz[b],
                                      want_raw.corner_xyz)
        np.testing.assert_array_equal(raw_feats.surf_mask[b],
                                      want_raw.surf_mask)
        for name in ("corner_mask", "surf_mask"):
            np.testing.assert_array_equal(getattr(feats, name)[b],
                                          getattr(want, name))
        for name in ("corner_xyz", "surf_xyz"):
            np.testing.assert_allclose(getattr(feats, name)[b],
                                       getattr(want, name), rtol=0,
                                       atol=1e-5)


@pytest.mark.parametrize("params", [PARAMS, FAST], ids=["strict", "fast"])
def test_process_scan_without_downsample(scans, params):
    """process_scan(downsample=False) in both packages: extract_features'
    output, corner sets and surf masks bitwise."""
    jraws, traw = scans
    cloud, feats = tfront.process_scan(params, traw, downsample=False)
    raw_feats = tfeat.extract_features(params, cloud,
                                       strict=params.strict_feature_pick)
    for got, want in zip(feats, raw_feats):
        assert torch.equal(got, want)
    feats = to_numpy(feats)
    for b, raw in enumerate(jraws):
        _, want = jax.tree.map(np.asarray, process_scan(params, raw,
                                                        downsample=False))
        np.testing.assert_array_equal(feats.corner_mask[b], want.corner_mask)
        np.testing.assert_array_equal(feats.corner_xyz[b], want.corner_xyz)
        np.testing.assert_array_equal(feats.surf_mask[b], want.surf_mask)
        np.testing.assert_allclose(feats.surf_xyz[b], want.surf_xyz,
                                   rtol=0, atol=1e-5)
        assert want.corner_mask.sum() > 100 and want.surf_mask.sum() > 1000
