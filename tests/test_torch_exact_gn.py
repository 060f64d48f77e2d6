"""The exact solver's one-launch GN loop (`ops/exact_gn.py`) on the CPU.

On tests/exact_scenes.py's lanes (float32 throughout):

  * `exact_gn_reference` (pack -> `register_core` -> unpack) bit for bit
    `register_core` called directly, up to 3 iterations (lane 3 runs them
    all): on a shared map, on one map a lane and on a map with 3 live
    corner points;
  * `register_scan`'s CPU route (`exact_gn` -> the reference) against JAX
    `register_scan` on lanes 0-2 (one compile, at one tiny shape): pose
    within 1e-5 with equal n_corr, or within 1e-4 where one
    correspondence's gate flips on float32 rounding (XLA's FMAs), equal
    iterations and flags; the gated lane unmoved after 0 iterations;
  * the plain fits' exact zeros for a point whose five neighbours are not
    all within 1 m^2 (the 5th-NN gate), NaN and no-neighbour slots
    included: the kernel skips such a point's fit;
  * the refusals of `exact_gn` and `register_scan` on every device: a
    device neither CPU nor CUDA, shapes, dtypes, a map capacity that is
    not a multiple of chunk, a cluster size the kernel does not launch;
  * `kernels.exact_gn_cluster`'s sizes from shapes, and
    `kernels.exact_gn_mean_order`'s centroid order (ATen's, on an H100).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_base_pointcloud_registration_tpu.ops import (
    register as jreg)
from feature_base_pointcloud_registration_tpu.pipeline.cloud_info import (
    FeatureMap as JFeatureMap, ScanFeatures as JScanFeatures)
from feature_base_pointcloud_registration_tpu_torch import kernels
from feature_base_pointcloud_registration_tpu_torch.ops import (
    correspondence as tcorr, exact_gn as texact, knn as tknn,
    register as treg)

import exact_scenes as es
from test_torch_batch import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
SOLVE = dict(min_corr=50, eig_thresh=100.0, edge_min_valid=10,
             surf_min_valid=100, chunk=es.CHUNK, conv_rot_deg=0.05,
             conv_trans_cm=0.05)


@pytest.fixture(scope="module")
def sc():
    return es.scene()


def _core(feats, fmap, pose, iters=30):
    return treg.register_core(
        feats, tknn.make_local_knn(fmap.corner_xyz, fmap.corner_mask,
                                   es.CHUNK),
        tknn.make_local_knn(fmap.surf_xyz, fmap.surf_mask, es.CHUNK), pose,
        max_iterations=iters)


@pytest.mark.parametrize("maps", ["shared", "per_lane", "few_live"])
def test_reference_is_register_core_bitwise(sc, maps):
    scene = es.few_live_map(sc) if maps == "few_live" else sc
    feats, fmap, pose = es.batch(scene, range(5), CPU,
                                 per_lane_maps=maps == "per_lane")
    got = treg.unpack(texact.exact_gn_reference(pose, feats, fmap, iters=3,
                                                **SOLVE))
    want = _core(feats, fmap, pose, iters=3)
    for name, g, w in zip(got._fields, got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    assert got.valid.tolist() == [True, True, False, True, True]
    assert int(got.iterations[3]) == 3 and int(got.iterations[2]) == 0
    assert bool(torch.isfinite(got.pose6).all())
    if maps == "few_live":
        # every corner feature fails the 5th-NN gate; the surf ones carry it
        assert (got.n_corr[[0, 1, 4]] > 50).all()


def test_register_scan_cpu_route_counts_no_launch(sc):
    feats, fmap, pose = es.batch(sc, [0, 1], CPU)
    before = texact.exact_gn.launches
    got = treg.register_scan(feats, fmap, pose, chunk=es.CHUNK)
    assert texact.exact_gn.launches == before
    want = _core(feats, fmap, pose)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.fixture(scope="module")
def jax_results(sc):
    """JAX register_scan of lanes 0-2, one compile."""
    jmap = JFeatureMap(*map(jnp.asarray, (sc["cmap"], sc["cmask"],
                                          sc["smap"], sc["smask"])))
    return [jax.tree.map(np.asarray, jreg.register_scan(
        JScanFeatures(*map(jnp.asarray, (lane["fc"], lane["cm"], lane["fs"],
                                         lane["sm"]))),
        jmap, jnp.asarray(lane["guess"]), chunk=es.CHUNK))
        for lane in sc["lanes"][:3]]


@pytest.fixture(scope="module")
def port_results(sc):
    feats, fmap, pose = es.batch(sc, range(3), CPU)
    return treg.register_scan(feats, fmap, pose, chunk=es.CHUNK)


@pytest.mark.parametrize("lane", [0, 1, 2])
def test_register_scan_cpu_route_matches_jax(sc, jax_results, port_results,
                                             lane):
    got, want = port_results, jax_results[lane]
    d = float(np.abs(got.pose6[lane].numpy() - want.pose6).max())
    dn = int(got.n_corr[lane]) - int(want.n_corr)
    assert int(got.iterations[lane]) == int(want.iterations)
    for name in ("converged", "is_degenerate", "valid"):
        assert bool(getattr(got, name)[lane]) == bool(getattr(want, name))
    if dn:
        print(f"lane {lane}: n_corr {int(got.n_corr[lane])} vs JAX "
              f"{int(want.n_corr)}, pose |diff| {d:.3e}")
    assert (dn == 0 and d <= 1e-5) or (abs(dn) == 1 and d <= 1e-4), (dn, d)
    if lane == 2:
        assert not bool(got.valid[lane]) and int(got.iterations[lane]) == 0
        np.testing.assert_array_equal(got.pose6[lane].numpy(),
                                      sc["lanes"][2]["guess"])
    else:
        assert bool(got.converged[lane])
        assert np.abs(got.pose6[lane].numpy()[3:]
                      - sc["lanes"][lane]["gt"][3:]).max() < 0.01


@pytest.mark.parametrize("kind", ["corner", "surf"])
def test_plain_fit_is_zero_past_the_5th_nn_gate(kind):
    """Rows of `_from_knn` whose neighbours are not all within 1 m^2 add
    exact zeros, whatever their coordinates: a 5th d2 of exactly 1, a
    no-neighbour slot (3e38, junk coordinates), NaN coordinates behind a
    5th d2 of 1, a NaN d2 first (a negative NaN sorts first by key).  The
    last row, all within 1 m^2 on a line and a plane, is fitted."""
    r = np.random.RandomState(2)
    line = np.stack([np.zeros(5), np.zeros(5), np.linspace(-0.4, 0.4, 5)],
                    -1)
    plane = np.stack([r.uniform(-0.4, 0.4, 5), r.uniform(-0.4, 0.4, 5),
                      np.full(5, 0.5)], -1)
    good = line if kind == "corner" else plane
    nn = np.stack([good, good, np.full((5, 3), np.nan), good,
                   good]).astype(np.float32)
    nn[1, 3:] = 1e3
    d2 = np.tile(np.float32([0.01, 0.02, 0.03, 0.04, 0.05]), (5, 1))
    d2[0, 4] = 1.0
    d2[1, 3:] = 3e38
    d2[2, 4] = 1.0
    d2[3, 0] = -np.nan
    q = np.float32([[0.05, 0.02, 0.52]] * 5)
    fn = getattr(tcorr, f"{kind}_correspondence")
    coeff, resid, mask = fn(torch.from_numpy(q)[None],
                            torch.ones(1, 5, dtype=torch.bool),
                            lambda p: (torch.from_numpy(d2)[None],
                                       torch.from_numpy(nn)[None]))
    assert mask[0].tolist() == [False, False, False, False, True]
    assert torch.equal(coeff[0, :4], torch.zeros(4, 3))
    assert torch.equal(resid[0, :4], torch.zeros(4))
    assert bool(torch.isfinite(coeff).all()) and float(
        coeff[0, 4].abs().sum()) > 0.0


def _refusal_inputs(sc, case):
    """lanes 0-1 on the CPU, with one thing wrong."""
    feats, fmap, pose = es.batch(sc, [0, 1], CPU)
    kw = dict(SOLVE, iters=30)
    if case == "device":
        feats, fmap, pose = es.batch(sc, [0, 1], torch.device("meta"))
    elif case == "pose shape":
        pose = pose[:, :5]
    elif case == "lanes":
        pose = pose[:1]
    elif case == "feature mask":
        feats = feats._replace(surf_mask=feats.surf_mask[:, :-1])
    elif case == "feature dtype":
        feats = feats._replace(corner_xyz=feats.corner_xyz.double())
    elif case == "no features":
        feats = feats._replace(corner_xyz=feats.corner_xyz[:, :0],
                               corner_mask=feats.corner_mask[:, :0])
    elif case == "map mask":
        fmap = fmap._replace(corner_mask=fmap.corner_mask[:-1])
    elif case == "map mask dtype":
        fmap = fmap._replace(surf_mask=fmap.surf_mask.to(torch.uint8))
    elif case == "per-lane map of another batch":
        fmap = fmap._replace(surf_xyz=fmap.surf_xyz[None].expand(3, -1, -1),
                             surf_mask=fmap.surf_mask[None].expand(3, -1))
    elif case == "chunk":
        kw["chunk"] = 3 * es.CHUNK // 2
    elif case == "cluster":
        kw["cluster"] = 3
    elif case == "cluster 32":
        kw["cluster"] = 32
    elif case == "devices":
        fmap = fmap._replace(corner_xyz=fmap.corner_xyz.to("meta"))
    return pose, feats, fmap, kw


@pytest.mark.parametrize("case", [
    "device", "pose shape", "lanes", "feature mask", "feature dtype",
    "no features", "map mask", "map mask dtype",
    "per-lane map of another batch", "chunk", "cluster", "cluster 32",
    "devices"])
def test_exact_gn_refuses(sc, case):
    pose, feats, fmap, kw = _refusal_inputs(sc, case)
    with pytest.raises(ValueError):
        texact.exact_gn(pose, feats, fmap, **kw)


def test_register_scan_refuses_other_devices(sc):
    feats, fmap, pose = es.batch(sc, [0], torch.device("meta"))
    with pytest.raises(ValueError, match="unsupported device"):
        treg.register_scan(feats, fmap, pose, chunk=es.CHUNK)


def test_map_capacity_not_a_multiple_of_chunk_refused_by_register_scan(sc):
    feats, fmap, pose = es.batch(sc, [0], CPU)
    with pytest.raises(ValueError, match="multiple of chunk"):
        treg.register_scan(feats, fmap, pose, chunk=3 * es.CHUNK // 2)


@pytest.mark.parametrize("B, P, n_sm, full, want", [
    (1, 10240, 132, None, 16),      # the SLAM step's feature caps
    (32, 10240, 132, None, 4),      # probe (b): 128 CTAs
    (33, 10240, 132, None, 4),
    (34, 10240, 132, None, 2),
    (256, 10240, 132, None, 1),
    (1, 640, 132, None, 8),         # EXACT_MIN_SHARE slots a CTA
    (1, 63, 132, None, 1),
    (1, 10240, 132, 8, 8),          # no 16-CTA cluster resident
    (2, 10240, 132, 16, 16),
])
def test_exact_gn_cluster_rule(B, P, n_sm, full, want):
    def max_clusters(C):
        return 0 if full is not None and C > full else n_sm // C

    assert kernels.exact_gn_cluster(B, P, n_sm, max_clusters) == want
    if full is None:
        assert kernels.exact_gn_cluster(B, P, n_sm) == want


@pytest.mark.parametrize("B, P, want", [
    (1, 8192, (256, 256)),      # phase 8's surf set: 256 rows of a CTA
    (1, 2048, (256, 256)),
    (1, 300, (256, 256)),
    (1, 128, (1, 1)),           # under 256 points: one thread sums all
    (5, 512, (64, 64)),         # tests/exact_scenes.py's surf set
    (32, 8192, (512, 16)),      # probe (b): 32 CTAs an output
    (1, 65536, (4096, 256)),    # probe (c)'s map size as a feature set
])
def test_exact_gn_mean_order(B, P, want):
    """The centroid's order on an H100 (132 SMs of 2048 threads), from
    ATen's setReduceConfig for `q.mean(-2)` of a float32 [B, P, 3]; the
    factor is float32(3B) / float32(3BP)."""
    S, H, factor = kernels.exact_gn_mean_order(B, P, 132, 2048)
    assert (S, H) == want
    assert factor == float(np.float32(3 * B) / np.float32(3 * B * P))


def test_exact_gn_mean_order_refuses_too_many_groups():
    with pytest.raises(ValueError, match="centroid groups"):
        kernels.exact_gn_mean_order(256, 1 << 22, 132, 2048)
