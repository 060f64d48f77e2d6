"""Port parity: the slice as a whole — `batch_register_fused` on the CPU
(through the plain versions of both kernels) against the JAX package's XLA
solver `batch_register_blocks`, with tables built by each package from the
same map.  Tolerance: max pose difference <= 1e-3 m / rad (sub-mm expected).

Strides 1/1 run on tests/test_pallas_gn.py's `_setup` scene (the scene of
its `test_fused_matches_blocks_tiny`).  Strides 8/4 (the bench's round-0
subsampling) run on the same generator at 4x-8x the feature counts: on the
tiny scene round 0 keeps only 64+64 features, every JtJ eigenvalue falls
under the degeneracy threshold at the lane's first iteration, and the
projector computed there freezes the solve in both packages' fused paths.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import test_pallas_gn as tpg
from feature_base_pointcloud_registration_tpu.io.synthetic import (
    pose6_to_matrix_np)
from feature_base_pointcloud_registration_tpu.parallel.batch import (
    batch_register_blocks, build_map_block_tables)
from feature_base_pointcloud_registration_tpu.pipeline.cloud_info import (
    FeatureMap, ScanFeatures)
from feature_base_pointcloud_registration_tpu_torch.convert import to_torch
from feature_base_pointcloud_registration_tpu_torch.parallel import (
    batch as tbatch)

CAP = 16


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's CPU tests run their torch ops on one thread.  The suite
    runs several pytest workers on a few cores, and a torch intra-op pool
    in each worker oversubscribes them (the port's test files plus two JAX
    ones under 6 workers on an 8-core host: 118 s with torch's default
    pool, 70 s with this fixture).  The other port test files import it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dense_setup(pc=1024, ps=4096, mc=4096, ms=16384):
    """tests/test_pallas_gn.py::_setup at larger feature/map counts."""
    r = np.random.RandomState(3)
    mcp = tpg._lines_and_planes(r, mc, "corner")
    msp = tpg._lines_and_planes(r, ms, "surf")
    fmap = FeatureMap(jnp.asarray(mcp), jnp.ones(mc, bool),
                      jnp.asarray(msp), jnp.ones(ms, bool))
    gt, fc, fs = [], [], []
    for b in range(2):
        pose = np.array([0.01 * b, -0.01, 0.02, 0.3 * b, -0.2, 0.0],
                        np.float32)
        gt.append(pose)
        T = np.linalg.inv(pose6_to_matrix_np(pose))
        cw = mcp[r.choice(mc, pc, replace=False)] + r.normal(0, 0.01,
                                                             (pc, 3))
        sw = msp[r.choice(ms, ps, replace=False)] + r.normal(0, 0.01,
                                                             (ps, 3))
        fc.append((cw @ T[:3, :3].T + T[:3, 3]).astype(np.float32))
        fs.append((sw @ T[:3, :3].T + T[:3, 3]).astype(np.float32))
    feats = ScanFeatures(jnp.asarray(np.stack(fc)), jnp.ones((2, pc), bool),
                         jnp.asarray(np.stack(fs)), jnp.ones((2, ps), bool))
    gt = np.stack(gt)
    guesses = gt + np.array([[0.01, -0.005, 0.01, 0.1, -0.08, 0.03],
                             [-0.008, 0.01, -0.01, -0.1, 0.06, -0.04]],
                            np.float32)
    return (feats, jnp.asarray(guesses), gt, fmap, np.zeros(3, np.float32),
            np.array([12.0, 12.0, 5.0], np.float32))


_SCENES = {"tiny": tpg._setup, "dense": _dense_setup}


@pytest.fixture(scope="module")
def solved():
    """Per scene: (port inputs, JAX blocks result, ground truth)."""
    out = {}
    for name, setup in _SCENES.items():
        feats, guesses, gt, fmap, center, half = setup()
        cbt, sbt, origin, dims = build_map_block_tables(
            fmap, center, half, corner_cell_cap=CAP, surf_cell_cap=CAP)
        ref = batch_register_blocks(
            feats, cbt, sbt, origin, guesses, grid_dims=dims,
            corner_cell_cap=CAP, surf_cell_cap=CAP, num_rounds=2,
            iters_per_round=15)
        tmap = to_torch(jax.tree.map(np.asarray, fmap), device="cpu")
        ct, st, torigin, tdims = tbatch.build_map_planar_tables(
            tmap, center, half, corner_cell_cap=CAP, surf_cell_cap=CAP)
        assert tdims == dims
        inputs = (to_torch(jax.tree.map(np.asarray, feats), device="cpu"),
                  ct, st, torigin,
                  torch.from_numpy(np.array(guesses)))
        out[name] = (inputs, jax.tree.map(np.asarray, ref), gt, dims)
    return out


def _solve(inputs, dims, **kw):
    kw.setdefault("iters_per_round", 15)
    return tbatch.batch_register_fused(*inputs, grid_dims=dims, **kw)


@pytest.mark.parametrize("scene,strides", [("tiny", (1, 1)),
                                           ("dense", (1, 1)),
                                           ("dense", (8, 4))])
def test_fused_matches_xla_blocks(solved, scene, strides):
    inputs, ref, gt, dims = solved[scene]
    got = _solve(inputs, dims, round1_surf_stride=strides[0],
                 round1_corner_stride=strides[1])
    assert got.valid.all() and got.converged.all()
    assert not got.is_degenerate.any()
    np.testing.assert_allclose(got.pose6.numpy(), ref.pose6, rtol=0,
                               atol=1e-3)
    err = np.linalg.norm(got.pose6.numpy()[:, 3:] - gt[:, 3:], axis=1)
    assert err.max() < 0.03, err
    nc_ref = ref.n_corr
    nc_got = got.n_corr.numpy()
    assert (np.abs(nc_got - nc_ref) <= 0.05 * nc_ref + 10).all()
    if strides == (1, 1):
        np.testing.assert_array_equal(got.iterations.numpy(), ref.iterations)


@pytest.mark.parametrize("kw", [
    dict(iters_per_round=[15, 15]),
    dict(shared_fetch="tail", num_rounds=3, iters_per_round=[15, 10, 5]),
    dict(skip_converged_refetch=True),
])
def test_solver_options_stay_on_the_solution(solved, kw):
    inputs, ref, _, dims = solved["dense"]
    got = _solve(inputs, dims, **kw)
    assert got.converged.all()
    np.testing.assert_allclose(got.pose6.numpy(), ref.pose6, rtol=0,
                               atol=1e-3)


def test_shared_fetch_and_gate(solved):
    inputs, _, _, dims = solved["tiny"]
    one = _solve(inputs, dims, num_rounds=1)
    shared = _solve(inputs, dims, num_rounds=1, shared_fetch=True)
    np.testing.assert_array_equal(one.pose6.numpy(), shared.pose6.numpy())
    # a lane under the feature-count gate keeps its initial pose
    feats = inputs[0]
    starved = feats._replace(corner_mask=feats.corner_mask.clone())
    starved.corner_mask[1, 5:] = False
    res = _solve((starved, *inputs[1:]), dims)
    assert res.valid.tolist() == [True, False]
    np.testing.assert_array_equal(res.pose6[1].numpy(), inputs[4][1].numpy())
    assert int(res.iterations[1]) == 0
    with pytest.raises(ValueError):
        _solve(inputs, dims, round1_surf_stride=8, shared_fetch=True)
