"""The port's CUDA kernels against their plain PyTorch versions, on a GPU.

Imports no JAX, so it runs on a GPU machine without it:

    python -m pytest --noconftest -q tests/test_torch_kernels_cuda.py

(`--noconftest` because tests/conftest.py imports JAX).  Without a GPU every
test skips.  Tolerances: both fetch kernels are bitwise equal to their
plain versions (explicit round-to-nearest arithmetic, same tie rule); the
GN kernel within 1e-4 of its plain version in pose (FMA contraction and
reduction order; both use the library acos) with equal n_corr and flags,
and bitwise equal to itself across two calls (a fixed-order reduction);
the solvers on the GPU within 1e-4 of the same solvers on the CPU (the
GN kernel's arithmetic, and `torch.linalg.eigh` on the card).  The
localization path: the fetch kernels on `grid_register_step`'s lower_pad
tables bitwise their plain versions and the octant rule's candidates for
queries below each lower face; strict picks on the card bitwise equal to
the CPU's on the same cloud, deskewed clouds within 2e-5 m (the card's sin/cos), one
`LocalizationPipeline.step` within 1e-4 of the CPU's, and one
`grid_register_step` on an undownsampled map, whose surf table stays raw
(W 512, 3 `block_fetch` launches), within 1e-4 of the CPU's with
collinear 5-NN plane fits rejected and within 1e-3 without (the fit's
rank gate decides those on rounding noise).  The exact solver
and the SLAM path: `_extract_topk` on the card equal to a stable sort (the
lower index wins ties, which `torch.topk` alone does not promise on CUDA);
the streamed `knn` on the card against the CPU (d2 within 1e-6 of the
cancelled terms |q-c|^2 + |m-c|^2, indices equal except at near-ties);
`register_scan` and two `SlamPipeline.step`s on the card within 1e-4 of
the CPU (the second on the fetch kernels).  The LIO path: preintegration,
the IMU chain LM and its float64 marginal on the card against the CPU
(deltas within 1e-5, states within 1e-4, the marginal within rtol 1e-4),
and two `LioTopology` steps within 1e-4 in pose and IMU chain state.  The
KITTI and multi-session slice: the pair alignment stage by stage (FPFH
within 1e-5 where no histogram bin flipped, flips at most 1% of the
pairs; RANSAC scoring and ICP within 1e-4)
and `merge_sessions` within 1e-4 of the CPU, the links on the K=16 fetch
kernels.  The sharded solvers on a one-rank NCCL group:
`shard_register_tables(solver="fused")` bitwise `batch_register_fused`
(raw and resident tables, the kernels counted), `map_sharded_register_tables`
bitwise `batch_register_pallas` on its one shard's table, and four striped
shards' fetch kernels merged by `merge_topk` bitwise the plain fetches'.
The rounds solver's round kernel `rounds_gn` against its plain version on
the card (tests/rounds_scenes.py's edge lanes at K 6, 8 and 16, one lane at
the localization step's caps, a batch): flags, iterations and n_corr
equal, pose and matP within 1e-5, a degenerate lane's pose within 1e-3;
the same at every cluster size (1 to 16 CTAs a lane) on the edge lanes and
the step's lane, two launches at cluster 8 bitwise, the cluster rule's
sizes on the card (1 at B = 256, more at B = 1), cluster 32 refused;
`register_rounds_core` on the step's tables with no host sync under the
CUDA sync debug mode "error"; K=7 refused on the card.  The pose-graph LM
kernel `csrc/pose_graph_lm.cu` against its plain version on the card
(`optimize_pose_graph_reference`, tests/pose_graph_scenes.py's graphs):
the chain, GPS and loop graphs at the SLAM window's shape and in 512 slots
on route A, in one launch with one host sync (the live count), poses
within 1e-4 and cost within 1e-4 relative (another summation order;
float32 Cholesky on the card against cuSOLVER's); route B at the cap + 1
and at 200 live poses the same, with no host sync inside its iterations;
the factor blocks (`graph_factor_blocks`) with NaN in the same places and
every other entry within 1e-5; gimbal lock and a non-finite H rejected
with the poses bitwise unchanged, also where the non-finite rows sit
early in a chain with a loop closure (the dense update would carry NaN
left of the later rows' envelope); route A's envelope on a loop spanning
the window, several loops, 38 live poses with every row's envelope from
pose 0 (the factorization's wide columns on the whole CTA) and a masked
interior pose (left where it was), one launch and one host sync each;
route B rejecting a factorization reported failed; two launches bitwise
equal.  The IMU odometry's kernels
(csrc/imu_chain_lm.cu, csrc/preintegration.cu) against their plain
versions on the card (tests/imu_chain_scenes.py): the chain LM on every
scene (K 16 windows, K 1, K 100) and the full window at K 1, 48 and
100, in one launch with no host sync, states
within 1e-4 with NaN in the same places, the cost that of the states it
comes with (1e-4 relative) and within 1e-3 relative of the plain
version's (or NaN in both: states 1e-5 apart move a cost of residuals
whitened by ~1e-5 sigmas by up to 6e-4 relative at K 100), two launches
bitwise; the factor blocks
with NaN in the same places and every other entry within 1e-5 of its
block's largest; the preintegration (dR, dv, dp, dt and the bias
Jacobians within 1e-6 of max(1, their largest entry), cov within rtol 1e-5
with a floor of 1e-7 of its largest entry; for the 1024-sample buffer's
731 live samples, over which the float32 rounding of the plain version's
cuBLAS products and the kernel's walks apart, 1e-5 of max(1, largest) and
cov within rtol 1e-5 with a floor of 1e-6, held only where the kernel is
as near a float64 run of the plain version as the plain version, within
a factor of 2) and the propagation (R,
p, v within 1e-5 of max(1, their largest entry)) on one LIO interval, a
64-sample interval, a 1024-sample buffer with interior masked samples and
a buffer with none live, with no host sync and two launches bitwise; both
on tests/imu_chain_scenes.py's edge buffers (one live sample, a masked
first and last slot, dt 0, a rotation near pi, 97 slots; an accel that
overflows cov and a dt that overflows B, held to the plain version's
non-finite leaves).
The streamed k-NN kernel (csrc/knn_stream.cu) against its plain version
on the card (`knn_reference`) on tests/icp_scenes.py's scenes at k 1, 5
and 16, a shared map and one map per set, one chunk and four: one launch
and no host sync a call, the no-neighbour slots exact (the lowest masked
indices with one chunk, 0 with more), d2 within 1e-6 of the terms the
formula cancels, a differing index only at a near-tie, the index sets
equal where the plain k-th and (k+1)-th distances lie apart, duplicates'
ties to the lower index, two launches bitwise; k outside 1..16, float64
and a mask on another device refused.  The ICP kernel (csrc/icp.cu)
against its plain version on the card (`icp_align_reference`) on the
scenes at small caps and at phase 8's, the pair's and the merge's caps:
one launch and no host sync a run, transform within 1e-4, converged and
the fitness gate equal, fitness within the k-NN's d2 tolerance averaged
over the matches (`icp_scenes.fitness_tol`), iterations printed (the 1e-6
epsilon sits on float32 rounding: one route may settle where the other
swaps two matches to the cap), two launches bitwise, R = I where H = 0.
The k-NN kernel bit for bit tests/knn_cells.py's brute force of the parent
kernel's keys (k 1, 5, 16, one chunk and four), and both kernels at
icp_scenes.EDGE_SCENES (points on cell faces, ties across cells,
duplicates, a far row, few and no live points): the k-NN bit for bit the
brute force and held to its plain version, ICP one launch with no sync,
its fitness at T = I against the brute force's and, with few or no live
target points, its run against the plain version.  The exact solver's
kernel (csrc/exact_gn.cu) against its plain loop (`exact_gn_reference`)
on the card, on tests/exact_scenes.py's lanes (shared, per-lane and
3-live maps, every cluster size, a fully live 16384-slot surf map) and the
register_scan scene: one launch and no host sync a solve, two launches
bitwise, iterations, n_corr and flags equal wherever the plain loop's card
and CPU runs agree on them, pose within 1e-4 (1e-3 on a degenerate lane)
or twice the plain loop's own card-vs-CPU spread; its first iteration's
neighbours bit for bit `knn`'s.
"""

import numpy as np
import pytest
import torch

from feature_base_pointcloud_registration_tpu_torch import kernels
from feature_base_pointcloud_registration_tpu_torch.config import Params
from feature_base_pointcloud_registration_tpu_torch.graph import (
    pose_graph as tpg)
from feature_base_pointcloud_registration_tpu_torch.io.synthetic import (
    SyntheticWorld, build_feature_map, pose6_to_matrix_np, simulate_scan)
from feature_base_pointcloud_registration_tpu_torch.ops import (
    features as tfeat, projection as tproj)
from feature_base_pointcloud_registration_tpu_torch.ops import (
    fetch as tfetch, gn_round as tgn, register as treg, rounds_gn as trounds)
from feature_base_pointcloud_registration_tpu_torch.parallel import (
    batch as tbatch)
from feature_base_pointcloud_registration_tpu_torch.pipeline import (
    cloud_info, frontend as tfront, localization as tloc)

import imu_chain_scenes as ics
import pose_graph_scenes as pgs
import rounds_scenes as rs

FeatureMap, ScanFeatures = cloud_info.FeatureMap, cloud_info.ScanFeatures


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _fetch_inputs(seed, R=300, W=256, Q=5000):
    """Random rows with FAR padding, an all-tied row, sentinel queries."""
    r = np.random.RandomState(seed)
    tab = r.uniform(-5, 5, (R, 3, W)).astype(np.float32)
    tab[:, :, W - 40:] = 1e9
    tab[5] = tab[5, :, :1]                      # every slot ties
    tab[7, :, 3:] = 1e9                         # fewer valid slots than K
    tab[-1] = 1e9                               # sentinel row
    bc = r.randint(0, R, Q).astype(np.int32)
    bc[::7] = R - 1
    bc[:20] = 5
    bc[20:40] = 7
    q = r.uniform(-5, 5, (3, Q)).astype(np.float32)
    return tab.reshape(R, 3 * W), bc, q


@pytest.mark.cuda
@pytest.mark.parametrize("K", [6, 8, 16])
def test_fetch_kernel_bitwise(cuda, K):
    tab, bc, q = _fetch_inputs(K)
    args = [torch.from_numpy(a).to(cuda) for a in (tab, bc, *q)]
    before = tfetch.block_fetch.launches
    d2, cand = tfetch.block_fetch(*args, K=K)
    torch.cuda.synchronize()
    assert tfetch.block_fetch.launches == before + 1
    d2r, candr = tfetch.block_fetch_reference(*args, K=K)
    assert torch.equal(d2, d2r)
    assert torch.equal(cand, candr)
    # and the plain version on the GPU equals the one on the CPU
    d2c, candc = tfetch.block_fetch_reference(*[a.cpu() for a in args], K=K)
    assert torch.equal(d2r.cpu(), d2c) and torch.equal(candr.cpu(), candc)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [6, 8, 16])
@pytest.mark.parametrize("W", [128, 256, 384, 512])
def test_resident_kernel_bitwise(cuda, K, W):
    tab, bc, q = _fetch_inputs(K + W, W=W, Q=5000)   # Q % 32 == 8
    bc[64:96] = tab.shape[0] - 1                      # a dead group
    args = [torch.from_numpy(a).to(cuda) for a in (tab, bc, *q)]
    before = tfetch.resident_fetch.launches
    for planes_out in (True, False):
        d2, cand = tfetch.resident_fetch(*args, K=K, planes_out=planes_out)
        torch.cuda.synchronize()
        d2r, candr = tfetch.resident_fetch_reference(*args, K=K)
        if not planes_out:
            candr = candr.view(3, K, -1).permute(2, 1, 0)
        assert torch.equal(d2, d2r)
        assert torch.equal(cand, candr)
    assert tfetch.resident_fetch.launches == before + 2
    assert (d2[64:96] == np.float32(3e38)).all() and (cand[64:96] == 0).all()
    # the same function as the raw-table kernel on the same rows
    d2b, candb = tfetch.block_fetch(*args, K=K, planes_out=False)
    assert torch.equal(d2, d2b) and torch.equal(cand, candb)


TILE = 128          # kernels.FETCH_TILE: queries per block of both kernels


def _adversarial(pattern, W, K, Q=5000, R=300):
    """Row patterns against the tiled kernels (Q % TILE == 8): inputs as
    numpy, plus the ids the plain version runs on (out-of-range ids there
    moved to the sentinel) and the mask of those out-of-range queries."""
    r = np.random.RandomState(1000 * len(pattern) + 20 * W + K)
    tab = r.uniform(-5, 5, (R, 3, W)).astype(np.float32)
    tab[:, :, W - W // 5:] = 1e9
    tab[3, :, 10:20] = tab[3, :, 0:10]          # duplicate points: ties
    tab[5] = tab[5, :, :1]                      # every slot ties
    tab[-1] = 1e9
    q = r.uniform(-5, 5, (3, Q)).astype(np.float32)
    if pattern == "one_row":
        bc = np.full(Q, 3)
    elif pattern == "all_distinct":           # overflows the row buffer
        bc = np.arange(Q) % (R - 1)
    elif pattern == "runs":                   # runs across tile edges
        lens = r.randint(1, 3 * TILE, Q)
        bc = np.repeat(r.randint(0, R - 1, Q), lens)[:Q]
        bc[TILE - 5:TILE + 5] = 3
    else:                                     # "sentinels"
        bc = r.randint(0, R - 1, Q)
        bc[:TILE] = R - 1                       # a sentinel-only tile
        bc[TILE:2 * TILE:3] = R - 1
        bc[TILE + 1:2 * TILE:7] = -1            # out of range
        bc[TILE + 2:2 * TILE:11] = R + 4
        bc[-8:] = R - 1                         # the ragged last tile
    bc = bc.astype(np.int32)
    bad = (bc < 0) | (bc >= R)
    return tab.reshape(R, 3 * W), bc, q, np.where(bad, R - 1, bc), bad


def _check_adversarial(fn, cuda, pattern, W, K, table=None):
    tab, bc, q, bc_ref, bad = _adversarial(pattern, W, K)
    t = torch.from_numpy(tab).to(cuda) if table is None else table(tab)
    qs = [torch.from_numpy(c).to(cuda) for c in q]
    d2, cand = fn(t, torch.from_numpy(bc).to(cuda), *qs, K=K)
    torch.cuda.synchronize()
    d2r, candr = tfetch.block_fetch_reference(
        t, torch.from_numpy(bc_ref).to(cuda), *qs, K=K)
    good = torch.from_numpy(~bad).to(cuda)
    assert torch.equal(d2[good], d2r[good])
    assert torch.equal(cand[:, good], candr[:, good])
    assert torch.isnan(d2[~good]).all() and torch.isnan(cand[:, ~good]).all()
    return d2, cand


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["one_row", "all_distinct", "runs",
                                     "sentinels"])
@pytest.mark.parametrize("K", [6, 8, 16])
@pytest.mark.parametrize("W", [160, 384])
def test_fetch_kernel_row_patterns(cuda, pattern, K, W):
    _check_adversarial(tfetch.block_fetch, cuda, pattern, W, K)


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["one_row", "all_distinct", "runs",
                                     "sentinels"])
@pytest.mark.parametrize("K", [6, 8, 16])
@pytest.mark.parametrize("W", [128, 256, 384, 512])
def test_resident_kernel_row_patterns(cuda, pattern, K, W):
    d2, cand = _check_adversarial(tfetch.resident_fetch, cuda, pattern, W,
                                  K)
    # the raw-table kernel on the same rows gives the same results
    d2b, candb = _check_adversarial(tfetch.block_fetch, cuda, pattern, W, K)
    assert torch.equal(d2.nan_to_num(), d2b.nan_to_num())
    assert torch.equal(cand.nan_to_num(), candb.nan_to_num())


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["block_fetch", "resident_fetch"])
def test_fetch_kernels_on_an_unaligned_table(cuda, kernel):
    """A table view 4 bytes past a 16-byte boundary takes the scalar row
    copy."""
    def unaligned(tab):
        flat = torch.empty(tab.size + 1, dtype=torch.float32, device=cuda)
        flat[1:] = torch.from_numpy(tab.reshape(-1)).to(cuda)
        t = flat[1:].view(tab.shape)
        assert t.data_ptr() % 16 == 4
        return t
    _check_adversarial(getattr(tfetch, kernel), cuda, "runs", 256, 8,
                       table=unaligned)


@pytest.mark.cuda
@pytest.mark.parametrize("W,K", [(4200, 8), (16000, 16)])
def test_fetch_kernel_wide_rows(cuda, W, K):
    """Rows wider than the row buffer's budget: one row per round, and
    more than 48 KB of shared memory, up to the widest rows the kernel
    takes (kernels.BLOCK_FETCH_MAX_W) at the largest K."""
    _check_adversarial(tfetch.block_fetch, cuda, "all_distinct", W, K)


@pytest.mark.cuda
def test_kernels_reject_unsupported_k(cuda):
    tab, bc, q = _fetch_inputs(0)
    args = [torch.from_numpy(a).to(cuda) for a in (tab, bc, *q)]
    with pytest.raises(ValueError):
        tfetch.block_fetch(*args, K=7)
    with pytest.raises(ValueError):
        tfetch.resident_fetch(*args, K=7)
    tab, bc, q = _fetch_inputs(0, W=640)
    args = [torch.from_numpy(a).to(cuda) for a in (tab, bc, *q)]
    with pytest.raises(ValueError):                   # W over 512
        tfetch.resident_fetch(*args, K=8)
    tab, bc, q = _fetch_inputs(0, R=8, W=16001, Q=200)
    args = [torch.from_numpy(a).to(cuda) for a in (tab, bc, *q)]
    with pytest.raises(ValueError):                   # W over 16000
        tfetch.block_fetch(*args, K=8)


def _rounds_check(args, kw):
    """rounds_gn's kernel against its plain version on the card (both on
    the same packed inputs): flags, iterations and n_corr equal on every
    lane, pose and matP within 1e-5 on the others than degenerate lanes,
    pose within 1e-3 on degenerate ones; one launch, bitwise the same on a
    second call (a fixed-order reduction).  Returns (stat, matP)."""
    before = trounds.rounds_gn.launches
    sk, mk = trounds.rounds_gn(*args, **kw)
    torch.cuda.synchronize()
    assert trounds.rounds_gn.launches == before + 1
    sr, mr = trounds.rounds_gn_reference(
        *args, **{k: v for k, v in kw.items() if k != "cluster"})
    assert torch.equal(sk[:, 6:11], sr[:, 6:11])
    deg = sr[:, 8] > 0
    dpose = (sk[:, :6] - sr[:, :6]).abs().max(1).values
    print(f"rounds_gn K={kw['K']}: pose |diff| {dpose.tolist()}, "
          f"degenerate {deg.tolist()}")
    assert (dpose[~deg] <= 1e-5).all() and (dpose[deg] <= 1e-3).all()
    assert ((mk - mr).abs().max(1).values[~deg] <= 1e-5).all()
    again = trounds.rounds_gn(*args, **kw)
    assert torch.equal(again[0], sk) and torch.equal(again[1], mk)
    return sk, mk


@pytest.mark.cuda
@pytest.mark.parametrize("K,spread", [(6, 0.0), (8, 0.0), (16, 0.05)])
def test_rounds_gn_kernel_edge_lanes(cuda, K, spread):
    """tests/rounds_scenes.py's edge lanes: two plain lanes, a gated-off
    lane (left bitwise untouched), a lane under min_corr, the degenerate
    tiny problem, sentinel picks near the world origin."""
    args = rs.packed(rs.edge_lanes(K), K, cuda)
    sk, mk = _rounds_check(args, dict(K=K, iters=10,
                                      min_plane_spread=spread))
    assert torch.equal(sk[2], args[0][2]) and torch.equal(mk[2], args[1][2])
    assert sk[3, 10] < 50 and torch.equal(sk[3, :6], args[0][3, :6])
    assert sk[4, 8] > 0 and (sk[[0, 1, 5], 10] >= 50).all()


@pytest.mark.cuda
@pytest.mark.parametrize("B,Pc,Ps,K", [(1, 2048, 8192, 16),
                                       (16, 512, 2048, 8)])
def test_rounds_gn_kernel_at_step_and_batch_shapes(cuda, B, Pc, Ps, K):
    """One lane at the localization step's feature caps (K=16) and a batch
    at K=8, with every iteration's budget spent (thresholds 0) and with the
    convergence test on."""
    args = rs.packed(rs.plain_lanes(B, K, Pc, Ps), K, cuda)
    _rounds_check(args, dict(K=K, iters=10))
    sk, _ = _rounds_check(args, dict(K=K, iters=6, conv_rot_deg=0.0,
                                     conv_trans_cm=0.0))
    assert (sk[:, 6] == 6).all()


@pytest.mark.cuda
def test_rounds_solve_has_no_host_sync(cuda):
    """register_rounds_core on grid_register_step's tables (lower_pad,
    resident where they fit, K=16) under the CUDA sync debug mode "error":
    no host sync in the whole solve, one rounds_gn launch a round."""
    params, raw, dsk = _skewed_scan(cuda)
    params = Params(register_grid_half_extent=(30.0, 30.0, 10.0))
    _, feats = tfront.process_scan(params, raw, dsk)
    lmap = FeatureMap(*(torch.from_numpy(a).to(cuda) for a in
                        build_feature_map(SyntheticWorld(),
                                          params.map_corner_cap,
                                          params.map_surf_cap)))
    guess = torch.tensor([[0.0, 0.0, 0.32, 1.1, -2.1, 0.4]], device=cuda)
    ctab, stab, origin, dims = tbatch.build_map_planar_tables(
        lmap, guess[0, 3:6], params.register_grid_half_extent, 2.0, 16, 64,
        resident=True, lower_pad=True)
    knn = [tfetch.make_pallas_block_knn(t, origin, 2.0, dims=dims,
                                        cell_cap=cap, k=16)
           for t, cap in ((ctab, 16), (stab, 64))]
    want = treg.register_rounds_core(feats, *knn, guess)
    torch.cuda.synchronize()
    before = trounds.rounds_gn.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = treg.register_rounds_core(feats, *knn, guess)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert trounds.rounds_gn.launches == before + 3
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert bool(got.valid[0]) and int(got.n_corr[0]) >= 50
    assert (got.pose6[0, 3:].cpu() - torch.tensor([1.0, -2.0, 0.4])).abs() \
        .max() < 0.05


@pytest.mark.cuda
def test_rounds_gn_rejects_unsupported_k_on_cuda(cuda):
    args = rs.packed(rs.edge_lanes(7), 7, cuda)
    with pytest.raises(ValueError):
        trounds.rounds_gn(*args, K=7, iters=2)
    # the plain version takes any K >= 5
    trounds.rounds_gn(*(a.cpu() for a in args), K=7, iters=2)


_STEP_LANE = []


def _step_lane(dev):
    """One lane at the localization step's caps (Pc 2048, Ps 8192, K 16),
    made once."""
    if not _STEP_LANE:
        _STEP_LANE.append(rs.plain_lanes(1, 16, 2048, 8192))
    return rs.packed(_STEP_LANE[0], 16, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("K,spread", [(8, 0.0), (16, 0.05)])
def test_rounds_gn_kernel_cluster_edge_lanes(cuda, cluster, K, spread):
    """The edge lanes with each lane spread over a cluster of every size:
    shares of a few live points, empty shares, a gated-off lane."""
    args = rs.packed(rs.edge_lanes(K), K, cuda)
    sk, mk = _rounds_check(args, dict(K=K, iters=10, min_plane_spread=spread,
                                      cluster=cluster))
    assert torch.equal(sk[2], args[0][2]) and torch.equal(mk[2], args[1][2])
    assert sk[3, 10] < 50 and torch.equal(sk[3, :6], args[0][3, :6])
    assert sk[4, 8] > 0 and (sk[[0, 1, 5], 10] >= 50).all()


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_rounds_gn_kernel_cluster_step_shape(cuda, cluster):
    """One lane at the step's caps on every cluster size, with the
    convergence test on and with every iteration's budget spent."""
    args = _step_lane(cuda)
    _rounds_check(args, dict(K=16, iters=10, cluster=cluster))
    sk, _ = _rounds_check(args, dict(K=16, iters=6, conv_rot_deg=0.0,
                                     conv_trans_cm=0.0, cluster=cluster))
    assert (sk[:, 6] == 6).all()


@pytest.mark.cuda
def test_rounds_gn_cluster_launches_bitwise(cuda):
    """Two launches at cluster 8 agree bitwise (the rank-order sum: no
    atomics), and the rule's size on the card is what it launches."""
    args = _step_lane(cuda)
    kw = dict(K=16, iters=6, conv_rot_deg=0.0, conv_trans_cm=0.0)
    a = trounds.rounds_gn(*args, **kw, cluster=8)
    b = trounds.rounds_gn(*args, **kw, cluster=8)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    C = kernels.rounds_gn_cluster_on(cuda.index or 0, 1, 2048 + 8192, 16)
    assert C > 1
    got = trounds.rounds_gn(*args, **kw)
    want = trounds.rounds_gn(*args, **kw, cluster=C)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
def test_rounds_gn_cluster_rule_on_the_card(cuda):
    """The rule on this card: one CTA a lane at the batched solve's B =
    256, more at the step's B = 1; each size it can pick is resident."""
    index = cuda.index or 0
    n_sm = torch.cuda.get_device_properties(cuda).multi_processor_count
    for K in (8, 16):
        resident = {C: kernels.rounds_gn_max_clusters(index, K, C)
                    for C in (1, 2, 4, 8, 16)}
        print(f"K={K}: resident clusters {resident}")
        assert all(n >= 1 for n in resident.values())
        assert kernels.rounds_gn_cluster(256, 2048 + 8192, n_sm, K,
                                         resident.get) == 1
        assert kernels.rounds_gn_cluster(1, 2048 + 8192, n_sm, K,
                                         resident.get) > 1


@pytest.mark.cuda
def test_rounds_gn_refuses_cluster_32(cuda):
    """A cluster of 32 CTAs raises in the wrapper, in the launch helper
    and in the C entry point itself (which returns an error code)."""
    import ctypes
    K = 8
    args = rs.packed(rs.edge_lanes(K), K, cuda)
    kw = dict(K=K, iters=2, min_corr=50, eig_thresh=100.0, conv_rot_deg=0.05,
              conv_trans_cm=0.05, min_plane_spread=0.0)
    with pytest.raises(ValueError):
        trounds.rounds_gn(*args, K=K, iters=2, cluster=32)
    with pytest.raises(ValueError):
        kernels.launch_rounds_gn(*args, **kw, cluster=32)
    stat = args[0].clone()
    B, _, Pc = args[2].shape
    rc = kernels.library().fbpr_rounds_gn(
        stat.data_ptr(), args[1].clone().data_ptr(),
        *(a.data_ptr() for a in args[2:]), B, Pc, args[3].shape[2], K, 2,
        50, 100.0, 0.05, 0.05, 0.0, 32,
        ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
    torch.cuda.synchronize()
    assert rc != 0 and torch.equal(stat, args[0])


def _lines_planes(r, n_corner, n_surf):
    xy = r.uniform(-4, 4, (10, 2))
    li = r.randint(0, 10, n_corner)
    mc = np.stack([xy[li, 0], xy[li, 1], r.uniform(-1, 3, n_corner)], -1)
    sx = r.uniform(-5, 5, (n_surf, 2))
    w = r.randint(0, 3, n_surf)
    ms = np.where(
        (w == 0)[:, None],
        np.stack([sx[:, 0], sx[:, 1], np.full(n_surf, -1.5)], -1),
        np.where((w == 1)[:, None],
                 np.stack([sx[:, 0], np.full(n_surf, 5.0), sx[:, 1]], -1),
                 np.stack([np.full(n_surf, -5.0), sx[:, 0], sx[:, 1]], -1)))
    return mc.astype(np.float32), ms.astype(np.float32)


def _scene(dev, B=6, Pc=200, Ps=700, seed=0):
    """Features pulled back from a lines+planes map, guesses near truth."""
    r = np.random.RandomState(seed)
    mc, ms = _lines_planes(r, 4096, 8192)
    fc, fs, gt = [], [], []
    for _ in range(B):
        pose = np.concatenate([r.uniform(-0.02, 0.02, 3),
                               r.uniform(-0.3, 0.3, 3)]).astype(np.float32)
        T = np.linalg.inv(pose6_to_matrix_np(pose))
        cw = mc[r.choice(len(mc), Pc)] + r.normal(0, 0.01, (Pc, 3))
        sw = ms[r.choice(len(ms), Ps)] + r.normal(0, 0.01, (Ps, 3))
        fc.append(cw @ T[:3, :3].T + T[:3, 3])
        fs.append(sw @ T[:3, :3].T + T[:3, 3])
        gt.append(pose)
    gt = np.stack(gt)
    guess = gt + r.uniform(-1, 1, gt.shape) * np.array(
        [0.01, 0.01, 0.02, 0.1, 0.1, 0.05])
    cmask = np.ones((B, Pc), bool)
    cmask[1:2, ::3] = False
    feats = ScanFeatures(
        torch.tensor(np.stack(fc), dtype=torch.float32, device=dev),
        torch.from_numpy(cmask).to(dev),
        torch.tensor(np.stack(fs), dtype=torch.float32, device=dev),
        torch.ones(B, Ps, dtype=torch.bool, device=dev))
    fmap = FeatureMap(torch.from_numpy(mc).to(dev),
                      torch.ones(len(mc), dtype=torch.bool, device=dev),
                      torch.from_numpy(ms).to(dev),
                      torch.ones(len(ms), dtype=torch.bool, device=dev))
    return feats, fmap, torch.tensor(guess, dtype=torch.float32, device=dev)


@pytest.mark.cuda
@pytest.mark.parametrize("K,spread", [(8, 0.0), (8, 0.05), (6, 0.0)])
def test_gn_kernel_matches_plain_version(cuda, K, spread):
    feats, fmap, guess = _scene(cuda)
    ct, st, origin, dims = tbatch.build_map_planar_tables(
        fmap, np.zeros(3), np.array([8.0, 8.0, 4.0]), corner_cell_cap=48,
        surf_cell_cap=48)
    stat, matP = tbatch.initial_state(feats, guess)
    stat[-1, 9] = 0.0                           # a gated-off lane
    cc = tbatch.fetch_candidates(stat[:, :6], feats.corner_xyz,
                                 feats.corner_mask, ct, origin, 2.0, dims,
                                 K=K)
    cs = tbatch.fetch_candidates(stat[:, :6], feats.surf_xyz,
                                 feats.surf_mask, st, origin, 2.0, dims, K=K)
    args = (stat, matP,
            tbatch.feature_planes(feats.corner_xyz, feats.corner_mask),
            tbatch.feature_planes(feats.surf_xyz, feats.surf_mask), cc, cs)
    before = tgn.gn_round.launches
    got, got_mp = tgn.gn_round(*args, K=K, iters=15, min_plane_spread=spread)
    torch.cuda.synchronize()
    assert tgn.gn_round.launches == before + 1
    want, want_mp = tgn.gn_round_reference(*args, K=K, iters=15,
                                           min_plane_spread=spread)
    assert (want[:-1, 10] > 100).all()
    torch.testing.assert_close(got[:, :6], want[:, :6], rtol=0, atol=1e-4)
    assert torch.equal(got[:, 6:11], want[:, 6:11])
    torch.testing.assert_close(got_mp, want_mp, rtol=0, atol=1e-4)
    assert torch.equal(got[-1], stat[-1])


def _gn_lanes(cuda, B, Pc, Ps, K, pattern, seed):
    """GN inputs that exercise the live-point list and the warp tail:
    masks front-packed with dead tails (voxel_downsample's packing) or
    interleaved, lane 2 with a few dozen live points (its gate forced on),
    finite garbage candidates on every dead point, odd lanes past their
    iteration 0 (lane 1 degenerate, with a projector), the last lane gated
    off."""
    feats, fmap, guess = _scene(cuda, B=B, Pc=Pc, Ps=Ps, seed=seed)
    r = np.random.RandomState(seed)
    cm, sm = np.ones((B, Pc), bool), np.ones((B, Ps), bool)
    if pattern == "front":
        for b in range(B):
            cm[b, r.randint(Pc // 2, Pc + 1):] = False
            sm[b, r.randint(Ps // 2, Ps + 1):] = False
    else:
        cm[:, ::3] = False
        sm[:, 1::4] = False
    if B > 2:
        cm[2, 12:] = False
        sm[2, 40:] = False
    feats = ScanFeatures(feats.corner_xyz, torch.from_numpy(cm).to(cuda),
                         feats.surf_xyz, torch.from_numpy(sm).to(cuda))
    ct, st, origin, dims = tbatch.build_map_planar_tables(
        fmap, np.zeros(3), np.array([8.0, 8.0, 4.0]), corner_cell_cap=48,
        surf_cell_cap=48)
    stat, matP = tbatch.initial_state(feats, guess)
    fc = tbatch.feature_planes(feats.corner_xyz, feats.corner_mask)
    fs = tbatch.feature_planes(feats.surf_xyz, feats.surf_mask)
    cands = []
    for xyz, mask, tab, m in ((feats.corner_xyz, feats.corner_mask, ct, cm),
                              (feats.surf_xyz, feats.surf_mask, st, sm)):
        c = tbatch.fetch_candidates(stat[:, :6], xyz, mask, tab, origin,
                                    2.0, dims, K=K)
        dead = torch.from_numpy(~m).to(cuda)
        garbage = torch.from_numpy(r.uniform(
            -50, 50, (3 * K, int(dead.sum())))).float().to(cuda)
        c.view(3 * K, B, -1)[:, dead] = garbage
        cands.append(c)
    if B > 2:
        stat[2, 9] = 1.0
        past, past_mp = tgn.gn_round_reference(stat, matP, fc, fs, *cands,
                                               K=K, iters=1)
        stat[1::2], matP[1::2] = past[1::2], past_mp[1::2]
        stat[:, 7] = 0.0
        stat[1, 8] = 1.0
        matP[1] = torch.diag(torch.tensor([1.0, 1, 1, 1, 1, 0])).reshape(36)
    if B > 1:
        stat[-1, 9] = 0.0
    return stat, matP, fc, fs, *cands


@pytest.mark.cuda
@pytest.mark.parametrize("B,Pc,Ps,K,pattern", [
    (133, 203, 707, 6, "front"), (133, 203, 707, 8, "front"),
    (133, 203, 707, 16, "front"), (133, 203, 707, 6, "interleaved"),
    (133, 203, 707, 8, "interleaved"), (133, 203, 707, 16, "interleaved"),
    (1, 1000, 6000, 8, "front"), (300, 77, 333, 8, "front"),
    (300, 77, 333, 8, "interleaved"),
    (3, 1500, 19500, 8, "front"),   # Pc + Ps over the live-list capacity
])
def test_gn_kernel_live_points_and_warp_tail(cuda, B, Pc, Ps, K, pattern):
    args = _gn_lanes(cuda, B, Pc, Ps, K, pattern, seed=B + Pc + K)
    got, got_mp = tgn.gn_round(*args, K=K, iters=15)
    again, again_mp = tgn.gn_round(*args, K=K, iters=15)
    torch.cuda.synchronize()
    assert torch.equal(got, again) and torch.equal(got_mp, again_mp)
    want, want_mp = tgn.gn_round_reference(*args, K=K, iters=15)
    assert (want[:, 10] > 50).float().mean() > 0.5
    torch.testing.assert_close(got[:, :6], want[:, :6], rtol=0, atol=1e-4)
    assert torch.equal(got[:, 6:11], want[:, 6:11])
    torch.testing.assert_close(got_mp, want_mp, rtol=0, atol=1e-4)
    if B > 1:
        assert torch.equal(got[-1], args[0][-1])


@pytest.mark.cuda
def test_fused_solve_on_gpu_matches_cpu(cuda):
    feats, fmap, guess = _scene(cuda, B=8, Pc=1000, Ps=6000, seed=1)
    out = {}
    for dev in (cuda, torch.device("cpu")):
        f = ScanFeatures(*(a.to(dev) for a in feats))
        m = FeatureMap(*(a.to(dev) for a in fmap))
        ct, st, origin, dims = tbatch.build_map_planar_tables(
            m, np.zeros(3), np.array([8.0, 8.0, 4.0]), corner_cell_cap=48,
            surf_cell_cap=48)
        out[dev.type] = tbatch.batch_register_fused(
            f, ct, st, origin, guess.to(dev), grid_dims=dims,
            round1_surf_stride=8, round1_corner_stride=4)
    got, want = out["cuda"], out["cpu"]
    assert want.converged.all() and not want.is_degenerate.any()
    torch.testing.assert_close(got.pose6.cpu(), want.pose6, rtol=0,
                               atol=1e-4)
    assert torch.equal(got.converged.cpu(), want.converged)


@pytest.mark.cuda
@pytest.mark.parametrize("resident", [False, True])
def test_rounds_solve_on_gpu_matches_cpu(cuda, resident):
    feats, fmap, guess = _scene(cuda, B=8, Pc=1000, Ps=6000, seed=2)
    out, launches = {}, {}
    for dev in (cuda, torch.device("cpu")):
        f = ScanFeatures(*(a.to(dev) for a in feats))
        m = FeatureMap(*(a.to(dev) for a in fmap))
        ct, st, origin, dims = tbatch.build_map_planar_tables(
            m, np.zeros(3), np.array([8.0, 8.0, 4.0]), corner_cell_cap=48,
            surf_cell_cap=48, resident=resident)
        assert isinstance(ct, tfetch.PlanarTable) == resident
        before = (tfetch.block_fetch.launches, tfetch.resident_fetch.launches)
        out[dev.type] = tbatch.batch_register_pallas(
            f, ct, st, origin, guess.to(dev), grid_dims=dims,
            corner_cell_cap=48, surf_cell_cap=48)
        launches[dev.type] = (tfetch.block_fetch.launches - before[0],
                              tfetch.resident_fetch.launches - before[1])
    assert launches == {"cuda": (0, 4) if resident else (4, 0),
                        "cpu": (0, 0)}
    got, want = out["cuda"], out["cpu"]
    assert want.converged.all() and not want.is_degenerate.any()
    torch.testing.assert_close(got.pose6.cpu(), want.pose6, rtol=0,
                               atol=1e-4)
    assert torch.equal(got.converged.cpu(), want.converged)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,W,Q", [
    ("resident_fetch", 128, 2048), ("block_fetch", 128, 2048),
    ("resident_fetch", 512, 8192), ("block_fetch", 512, 8192)])
def test_fetch_kernels_at_localization_shapes(cuda, kernel, W, Q):
    """One lane's queries at K=16 (2,048 corner / 8,192 surf features),
    the tail at the sentinel as masked features would be."""
    tab, bc, q = _fetch_inputs(W + Q, W=W, Q=Q)
    bc[Q - Q // 3:] = tab.shape[0] - 1
    args = [torch.from_numpy(a).to(cuda) for a in (tab, bc, *q)]
    fn = getattr(tfetch, kernel)
    before = fn.launches
    d2, cand = fn(*args, K=16)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    d2r, candr = tfetch.block_fetch_reference(*args, K=16)
    assert torch.equal(d2, d2r) and torch.equal(cand, candr)
    assert (d2[Q - Q // 3:] == np.float32(3e38)).all()


def _lower_face_inputs(face, seed):
    """A random map in a (6, 5, 4)-cell grid of 2 m cells (a third of it in
    the lowest cell layer of each axis) and 1000 queries within half a cell
    below the lower faces named in `face` (octant base -1 on those axes),
    inside the grid on the others: (points, mask, queries, origin, dims)
    on the CPU."""
    r = np.random.RandomState(seed)
    dims, cs = (6, 5, 4), 2.0
    origin = np.array([-3.0, 1.0, -2.0], np.float32)
    u = r.uniform(0, 1, (3000, 3)) * np.array(dims)
    u[np.arange(1000), r.randint(0, 3, 1000)] = r.uniform(0, 1, 1000)
    pts = (origin + cs * u).astype(np.float32)
    uq = r.uniform(0.5, np.array(dims) - 0.5, (1000, 3))
    for a in ("xyz".index(c) for c in face):
        uq[:, a] = r.uniform(-0.49, -0.01, 1000)
    q = (origin + cs * uq).astype(np.float32)
    return (torch.from_numpy(pts), torch.ones(3000, dtype=torch.bool),
            torch.from_numpy(q), torch.from_numpy(origin), dims)


@pytest.mark.cuda
@pytest.mark.parametrize("face", ["x", "y", "z", "xyz"])
@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("K", [8, 16])
def test_fetch_kernels_at_lower_faces(cuda, face, resident, K):
    """The fetch of `grid_register_step` (lower_pad tables) for queries
    within half a cell below a lower face: the kernel (`block_fetch` on the
    raw table, `resident_fetch` on the compact one) bitwise its plain
    version, and the octant rule's candidates (`grid_knn_oct_sentinel`:
    d2 bitwise, the real picks' coordinates bitwise, some kept)."""
    from feature_base_pointcloud_registration_tpu_torch.ops import (
        hashgrid as th)
    pts, mask, q, origin, dims = _lower_face_inputs(face, 10 * K + resident)
    base = th._octant_base(q, origin, 2.0)
    assert ((base == -1) == torch.tensor(
        [c in face for c in "xyz"])).all()
    sent = th.build_grid_sentinel(pts, mask, origin, 2.0, dims=dims,
                                  cell_cap=32)
    raw = tfetch.build_block_table_planar(sent, dims=dims, lower_pad=True)
    tab = tfetch.compact_row_space(raw) if resident else raw
    gtab = (tfetch.PlanarTable(*(t.to(cuda) for t in tab)) if resident
            else tab.to(cuda))
    fn = tfetch.resident_fetch if resident else tfetch.block_fetch
    before = fn.launches
    rows = tfetch.block_cell_of(q.to(cuda), origin.to(cuda), 2.0,
                                dims=dims, lower_pad=True)
    args = [rows if not resident else gtab.rows_index[rows.long()],
            *[q[:, i].contiguous().to(cuda) for i in range(3)]]
    table = gtab.table if resident else gtab
    d2, cand = fn(table, *args, K=K)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    d2r, candr = tfetch.block_fetch_reference(table, *args, K=K)
    assert torch.equal(d2, d2r) and torch.equal(cand, candr)
    wd, wn = th.grid_knn_oct_sentinel(q, sent, origin, 2.0, dims=dims,
                                      cell_cap=32, k=K)
    d2, nn = d2.cpu(), cand.cpu().view(3, K, -1).permute(2, 1, 0)
    real = wd < 1e30
    assert torch.equal(d2, wd) and torch.equal(nn[real], wn[real])
    assert real.sum() > 100


def _skewed_scan(dev):
    """A motion-skewed full VLP-16 scan, its IMU table and batch-1 tensors
    on dev."""
    params = Params()
    pose = np.array([0.0, 0.0, 0.3, 1.0, -2.0, 0.4], np.float32)
    s = simulate_scan(SyntheticWorld(), pose, seed=7,
                      spin_rpy_rate=(0.0, 0.0, 0.5), vel_world=(1.2, 0.5, 0))
    raw = cloud_info.RawScan(*(torch.from_numpy(np.asarray(s[k]))[None].to(
        dev) for k in ("xyz", "intensity", "ring", "time", "valid")))
    imu_t = 200.0 + np.linspace(-0.005, 0.105, 23)
    c, sn = np.cos(0.3), np.sin(0.3)               # velocity in scan frame
    dsk = tfront.make_deskew_info(
        params, imu_t, np.tile([0.0, 0.0, 0.5], (23, 1)), 200.0, 200.1,
        odom_incre=[0.1 * (c * 1.2 + sn * 0.5), 0.1 * (c * 0.5 - sn * 1.2),
                    0.0], odom_deskew_flag=True, device=dev)
    return params, raw, dsk


@pytest.mark.cuda
def test_strict_frontend_and_deskew_on_gpu_match_cpu(cuda):
    out = []
    for dev in (cuda, torch.device("cpu")):
        params, raw, dsk = _skewed_scan(dev)
        out.append((tproj.project_scan(params, raw, dsk),
                    tproj.project_scan(params, raw)))
    (desk_g, plain_g), (desk_c, plain_c) = out
    n = int(desk_c.num_points[0])
    assert int(desk_g.num_points[0]) == n
    torch.testing.assert_close(desk_g.points.cpu(), desk_c.points, rtol=0,
                               atol=2e-5)
    assert (desk_c.points - plain_c.points).abs().max() > 0.05
    # the picks: on the same cloud, bitwise; on each device's own, equal
    for cloud in (plain_c, desk_c):
        want = tfeat.window_labels(params, cloud)
        got = tfeat.window_labels(params, cloud_info.CloudInfo(
            *(a.to(cuda) for a in cloud)))
        assert torch.equal(got[1].cpu(), want[1])
    assert torch.equal(tfeat.window_labels(params, plain_g)[1].cpu(),
                       tfeat.window_labels(params, plain_c)[1])
    feats_g = tfeat.extract_features(params, plain_g)
    feats_c = tfeat.extract_features(params, plain_c)
    assert torch.equal(feats_g.corner_mask.cpu(), feats_c.corner_mask)
    assert torch.equal(feats_g.corner_xyz.cpu(), feats_c.corner_xyz)


@pytest.mark.cuda
def test_localization_step_on_gpu_matches_cpu(cuda):
    params = Params(register_grid_half_extent=(30.0, 30.0, 10.0))
    arrays = build_feature_map(SyntheticWorld(), params.map_corner_cap,
                               params.map_surf_cap)
    poses, launches = [], []
    for dev in (cuda, torch.device("cpu")):
        _, raw, dsk = _skewed_scan(dev)
        pipe = tloc.LocalizationPipeline(params, tloc.GlobalMap(
            *(torch.from_numpy(a).to(dev) for a in arrays)))
        pipe.pose = np.array([0.0, 0.0, 0.32, 1.1, -2.1, 0.4], np.float32)
        before = tfetch.resident_fetch.launches + tfetch.block_fetch.launches
        poses.append(pipe.step(cloud_info.RawScan(*(a[0] for a in raw)),
                               200.0, dsk))
        launches.append(tfetch.resident_fetch.launches
                        + tfetch.block_fetch.launches - before)
        assert bool(pipe.last_result.valid[0])
    assert launches == [6, 0]
    np.testing.assert_allclose(poses[0], poses[1], rtol=0, atol=1e-4)
    assert np.abs(poses[1][3:] - [1.0, -2.0, 0.4]).max() < 0.05


@pytest.mark.cuda
def test_raw_table_localization_step_on_gpu_matches_cpu(cuda):
    """`grid_register_step` on chip_smoke.py phase 7 (h)'s undownsampled
    map (the room's surf points at 0.2 m, Params(map_surf_cap=131072)):
    the crop keeps every surf point, so the surf table stays raw at W 512
    and the step launches 3 block_fetch (and 3 resident_fetch on the
    compact corner table).  The pose within 1e-4 of the CPU step's with
    collinear 5-NN plane fits rejected (min_plane_spread 0.01 m), and
    within 1e-3 at the reference's settings: on this 0.2 m lattice the
    plane fit's rank gate passes some collinear 5-NN on rounding noise,
    which differs between the devices (chip_smoke.py DENSE_CPU_TOL)."""
    from feature_base_pointcloud_registration_tpu_torch.ops import (
        register as treg)

    params = Params(map_surf_cap=131072)
    world = SyntheticWorld()
    corner, surf = world.corner_map_points(), world.surf_map_points(0.2)
    he = params.register_grid_half_extent
    results, spread, launches = [], [], []
    for dev in (cuda, torch.device("cpu")):
        _, raw, dsk = _skewed_scan(dev)
        _, feats = tfront.process_scan(params, raw, dsk)
        gm = tloc.GlobalMap.from_arrays(params, corner, surf,
                                        downsample=False, device=dev)
        guess = torch.tensor([[0.0, 0.0, 0.32, 1.1, -2.1, 0.4]],
                             device=dev)
        lmap, _ = tloc._crop_local_map(
            gm.corner_xyz, gm.corner_mask, gm.surf_xyz, gm.surf_mask,
            guess[0, 3:6], half_extent=params.local_map_half_extent,
            map_corner_cap=params.map_corner_cap,
            map_surf_cap=params.map_surf_cap)
        assert int(lmap.surf_mask.sum()) == len(surf)
        ctab, stab, _, _ = tbatch.build_map_planar_tables(
            lmap, guess[0, 3:6], he, resident=True, lower_pad=True)
        assert isinstance(ctab, tfetch.PlanarTable)
        assert torch.is_tensor(stab) and stab.shape[1] == 3 * 512
        del ctab, stab
        before = (tfetch.block_fetch.launches,
                  tfetch.resident_fetch.launches)
        results.append(treg.grid_register_step(lmap, feats, guess,
                                                half_extent=he))
        launches.append((tfetch.block_fetch.launches - before[0],
                         tfetch.resident_fetch.launches - before[1]))
        assert bool(results[-1].valid[0])
        spread.append(treg.grid_register_step(lmap, feats, guess,
                                               half_extent=he,
                                               min_plane_spread=0.01))
    assert launches == [(3, 3), (0, 0)]
    np.testing.assert_allclose(spread[0].pose6.cpu().numpy(),
                               spread[1].pose6.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(results[0].pose6.cpu().numpy(),
                               results[1].pose6.numpy(), rtol=0, atol=1e-3)
    for r in results + spread:
        assert np.abs(r.pose6[0, 3:].cpu().numpy()
                      - [1.0, -2.0, 0.4]).max() < 0.05


@pytest.mark.cuda
def test_extract_topk_on_gpu_is_a_stable_sort(cuda):
    from feature_base_pointcloud_registration_tpu_torch.ops.knn import (
        _extract_topk)
    r = np.random.RandomState(5)
    d = torch.from_numpy(r.randint(0, 4, (3000, 4096)).astype(
        np.float32)).to(cuda)
    d[:, 100:200] = 3.0e38
    for k in (1, 5, 16):
        v, i = _extract_topk(d, k)
        vs, is_ = torch.sort(d, dim=1, stable=True)
        assert torch.equal(v, vs[:, :k]) and torch.equal(i.long(),
                                                         is_[:, :k])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5])
def test_knn_on_gpu_matches_cpu(cuda, k):
    from feature_base_pointcloud_registration_tpu_torch.ops.knn import knn
    r = np.random.RandomState(k)
    q = (r.uniform(-20, 20, (2000, 3)) + 50).astype(np.float32)
    ref = (r.uniform(-20, 20, (16384, 3)) + 50).astype(np.float32)
    mask = r.uniform(size=16384) < 0.8
    out = [knn(*(torch.from_numpy(a).to(dev) for a in (q, ref, mask)),
               k=k, chunk=4096) for dev in (cuda, torch.device("cpu"))]
    d2g, ig = (a.cpu().numpy() for a in out[0])
    d2c, ic = (a.numpy() for a in out[1])
    c = q.astype(np.float64).mean(0)
    tol = 1e-6 * (((q - c) ** 2).sum(-1)[:, None]
                  + ((ref[ic].astype(np.float64) - c) ** 2).sum(-1))
    assert (np.abs(d2g - d2c) <= tol).all()
    swapped = ig != ic
    exact = [((ref[a] - q[i]) ** 2).sum() - ((ref[b] - q[i]) ** 2).sum()
             for i, a, b in zip(np.nonzero(swapped)[0], ig[swapped],
                                ic[swapped])]
    assert all(abs(e) <= 2 * t for e, t in zip(exact, tol[swapped]))
    assert swapped.mean() < 1e-3


@pytest.mark.cuda
def test_register_scan_on_gpu_matches_cpu(cuda):
    """VLP-16 fast features against the room's 8192 / 65536-slot map
    (chunk 4096): register_scan on the card (one exact_gn launch) within
    1e-4 of the CPU, and the kernel against the plain loop on the card
    (_exact_agrees)."""
    from feature_base_pointcloud_registration_tpu_torch.ops import (
        exact_gn as tex)
    from feature_base_pointcloud_registration_tpu_torch.ops.register import (
        register_scan)
    params = Params(strict_feature_pick=False)
    world = SyntheticWorld()
    gt = np.array([0.0, 0.0, 0.25, 2.0, -1.0, 0.0], np.float32)
    s = simulate_scan(world, gt, seed=9)
    arrays = build_feature_map(world, 8192, 65536)
    poses = []
    for dev in (cuda, torch.device("cpu")):
        raw = cloud_info.RawScan.from_numpy(
            s["xyz"], s["intensity"], s["ring"], s["time"],
            device=dev)._replace(valid=torch.from_numpy(s["valid"]).to(dev))
        _, feats = tfront.process_scan(
            params, cloud_info.RawScan(*(a[None] for a in raw)))
        fmap = FeatureMap(*(torch.from_numpy(a).to(dev) for a in arrays))
        pose = torch.from_numpy((gt + np.array(
            [0.015, -0.01, 0.04, 0.3, -0.25, 0.1], np.float32))[None]
        ).to(dev)
        before = tex.exact_gn.launches
        res = register_scan(feats, fmap, pose, chunk=4096)
        assert tex.exact_gn.launches == before + (dev == cuda)
        assert bool(res.valid[0]) and bool(res.converged[0])
        poses.append(res.pose6[0].cpu().numpy())
        if dev == cuda:
            _exact_agrees(*_exact_pair(cuda, feats, fmap, pose, chunk=4096))
    np.testing.assert_allclose(poses[0], poses[1], rtol=0, atol=1e-4)
    assert np.abs(poses[1][3:] - gt[3:]).max() < 0.03


@pytest.mark.cuda
def test_slam_steps_on_gpu_match_cpu(cuda):
    """Two SLAM steps: the first saves a keyframe, the second registers on
    the local map built from it (K=16 fetch kernels on the card)."""
    from feature_base_pointcloud_registration_tpu_torch.pipeline import (
        slam as tslam)
    params = Params(register_grid_half_extent=(30.0, 30.0, 10.0))
    world = SyntheticWorld()
    gts = [np.array([0.0, 0.0, 0.04 * k, 0.25 * k - 2.0, 0.12 * k - 1.0,
                     0.0], np.float32) for k in range(2)]
    scans = [simulate_scan(world, g, seed=100 + k)
             for k, g in enumerate(gts)]
    poses, launches = [], []
    for dev in (cuda, torch.device("cpu")):
        pipe = tslam.SlamPipeline(params, max_keyframes=32, device=dev)
        before = tfetch.resident_fetch.launches + tfetch.block_fetch.launches
        for k, s in enumerate(scans):
            raw = cloud_info.RawScan.from_numpy(
                s["xyz"], s["intensity"], s["ring"], s["time"],
                device=dev)._replace(valid=torch.from_numpy(
                    s["valid"]).to(dev))
            poses.append(pipe.step(raw, 0.2 * k).copy())
        launches.append(tfetch.resident_fetch.launches
                        + tfetch.block_fetch.launches - before)
        assert bool(pipe.last_result.valid[0]) and pipe.n_keyframes == 1
    assert launches == [6, 0]
    np.testing.assert_allclose(poses[1], poses[3], rtol=0, atol=1e-4)
    rel = (poses[3] - poses[2])[3:] - (gts[1] - gts[0])[3:]
    assert np.abs(rel).max() < 0.06


def _imu_chain(dev, acc, gyr, dt, mask, K=4):
    """A K-state IMU chain on `dev`: interval k preintegrates samples [20
    (k-1), 20 k) of the stream (a masked sample or two among them), the
    states and pose measurements at the predicted nav states, the states
    then moved 1e-2 off.  Returns (the stacked preintegration, its chain
    data)."""
    from feature_base_pointcloud_registration_tpu_torch.geom.se3 import (
        rot_to_euler)
    from feature_base_pointcloud_registration_tpu_torch.graph import (
        imu_graph as tg)
    from feature_base_pointcloud_registration_tpu_torch.imu import (
        preintegration as tp)

    def T(a):
        return torch.from_numpy(a).to(dev)
    z3 = torch.zeros(3, device=dev)
    pres = [tp.PreintState.zero(device=dev)]
    nav = tp.NavState.identity(device=dev)
    states = [torch.zeros(15, device=dev)]
    for k in range(1, K):
        sl = slice(20 * (k - 1), 20 * k)
        pres.append(tp.preintegrate(T(acc[sl]), T(gyr[sl]), T(dt[sl]),
                                    mask[sl], z3, z3, 1e-4, 1e-5))
        nav = tp.predict(nav, z3, z3, pres[-1])
        states.append(torch.cat([torch.stack(rot_to_euler(nav.R)), nav.p,
                                 nav.v, torch.zeros(6, device=dev)]))
    preint = tp.PreintState(*(torch.stack(f) for f in zip(*pres)))
    truth = torch.stack(states)
    off = np.random.RandomState(1).normal(0, 1e-2, (K, 15)) * (
        np.arange(K) > 0)[:, None] * (np.arange(15) < 9)
    ones = torch.ones(K, dtype=torch.bool, device=dev)
    return preint, tg.ImuChainData(
        states=truth + T(off.astype(np.float32)), state_mask=ones,
        preint=preint, preint_mask=torch.arange(K, device=dev) > 0,
        pose_meas=truth[:, :6].clone(),
        pose_sigma=torch.full((K, 6), 1e-2, device=dev),
        pose_meas_mask=ones, prior_state=truth[0],
        prior_sigma=torch.tensor([1e-2] * 6 + [1e4] * 3 + [1e-3] * 6,
                                 device=dev),
        bias_sigma=torch.full((6,), 5e-5, device=dev),
        gravity=torch.tensor(9.80511, device=dev))


@pytest.mark.cuda
def test_imu_chain_on_gpu_matches_cpu(cuda):
    """Preintegration (live samples of a masked buffer), predict, the chain
    LM and the float64 marginal on the card against the CPU: preintegrated
    deltas within 1e-5, the LM's states within 1e-4 and the marginal
    within rtol 1e-4 of its largest entry (the card's sin/cos, Cholesky
    and matmul order)."""
    from feature_base_pointcloud_registration_tpu_torch.graph import (
        imu_graph as tg)
    r = np.random.RandomState(0)
    acc = (np.array([0.3, -0.1, 9.9]) + r.normal(0, 0.05, (60, 3)))
    gyr = (np.array([0.1, -0.2, 0.5]) + r.normal(0, 0.01, (60, 3)))
    acc, gyr = acc.astype(np.float32), gyr.astype(np.float32)
    dt = np.full(60, 0.01, np.float32)
    mask = np.ones(60, bool)
    mask[[7, 33]] = False
    out = []
    for dev in (cuda, torch.device("cpu")):
        preint, d = _imu_chain(dev, acc, gyr, dt, mask)
        states, _ = tg.optimize_imu_chain(d, iterations=4)
        cov = tg.state_marginal_covariance(d, states.cpu().numpy(), 2)
        out.append((preint, states.cpu().numpy(), cov))
    for f in ("dR", "dv", "dp", "dt", "cov"):
        a, b = (getattr(o[0], f).cpu().numpy() for o in out)
        np.testing.assert_allclose(a, b, rtol=0, err_msg=f,
                                   atol=1e-5 * max(1.0, np.abs(b).max()))
    np.testing.assert_allclose(out[0][1], out[1][1], atol=1e-4, rtol=0)
    np.testing.assert_allclose(out[0][2], out[1][2], rtol=0,
                               atol=1e-4 * np.abs(out[1][2]).max())


@pytest.mark.cuda
def test_lio_steps_on_gpu_match_cpu(cuda):
    """Four clouds and the raw IMU between them through LioTopology on the
    card and on the CPU: the buffer emits two steps (the second registers
    on the fetch kernels and is bracketed by the IMU chain), poses within
    1e-4, the IMU chain's states within 1e-4."""
    from feature_base_pointcloud_registration_tpu_torch.io.synthetic import (
        constant_twist_platform)
    from feature_base_pointcloud_registration_tpu_torch.pipeline import (
        lio as tlio)
    params = Params(register_grid_half_extent=(30.0, 30.0, 10.0))
    world = SyntheticWorld()
    imu, states = constant_twist_platform(
        0.7, ext_rot=params.ext_rot, ext_rpy=params.ext_rpy,
        gravity=params.imu_gravity)
    runs = []
    for dev in (cuda, torch.device("cpu")):
        topo = tlio.LioTopology(params, max_keyframes=8, imu_window=8,
                                imu_max_samples=64, device=dev)
        ests = []
        for k in range(4):
            st = 0.2 * k
            batch = [b for b in imu if st - 0.2 < b[0] <= st + 1e-9]
            topo.handle_imu(*(np.stack([b[i] for b in batch])
                              for i in range(4)))
            _, R, p = states[int(round(st * 100))]
            rpy = [np.arctan2(R[2, 1], R[2, 2]), np.arcsin(-R[2, 0]),
                   np.arctan2(R[1, 0], R[0, 0])]
            s = simulate_scan(world, np.concatenate([rpy, p]), seed=60 + k)
            raw = cloud_info.RawScan.from_numpy(
                s["xyz"], s["intensity"], s["ring"], s["time"],
                device=torch.device("cpu"))._replace(
                valid=torch.from_numpy(s["valid"]))
            e = topo.handle_cloud(st, raw)
            if e is not None:
                ests.append(e.copy())
        assert len(ests) == 2 and topo.odo.system_initialized
        runs.append((np.stack(ests), topo.odo.chain_states.copy()))
    np.testing.assert_allclose(runs[0][0], runs[1][0], atol=1e-4, rtol=0)
    np.testing.assert_allclose(runs[0][1], runs[1][1], atol=1e-4, rtol=0)


@pytest.mark.cuda
def test_pair_alignment_on_gpu_matches_cpu(cuda):
    """examples/run_kitti's pair alignment, stage by stage: FPFH on the card
    within 1e-5 of the CPU's wherever no histogram bin flipped (a 1-ulp
    angle difference moves a pair into the next bin, which changes the
    point's descriptor and its neighbors'; flipped pairs at most 1%: 4.7%
    of the descriptors differed by more than 1e-5 in a first run on the
    card), RANSAC scoring of the same triplets and ICP from the same coarse
    transform within 1e-4, and the whole pair on the card within 0.05 m of
    the truth."""
    from feature_base_pointcloud_registration_tpu_torch import native
    from feature_base_pointcloud_registration_tpu_torch.examples import (
        run_kitti)
    from feature_base_pointcloud_registration_tpu_torch.ops import (
        fpfh as tfp, icp as ticp, knn as tknn, ransac as tra)

    world = run_kitti.synth_outdoor_world()
    gts = [np.array([0, 0, 0.05 * k, 0.8 * k, 0.3 * k, 0.0], np.float32)
           for k in range(2)]
    clouds = [run_kitti.synth_scan(world, g, seed=k)
              for k, g in enumerate(gts)]

    def prep(xyz, dev):
        pts = native.voxel_downsample(xyz, 0.3)[:2048]
        buf = np.zeros((2048, 3), np.float32)
        buf[:len(pts)] = pts
        return (torch.from_numpy(buf).to(dev),
                (torch.arange(2048) < len(pts)).to(dev))

    def bins(pts, m):
        """The K-NN and each pair's histogram bins, as fpfh computes them."""
        d2, idx = tknn.knn(pts, pts, m, k=16, chunk=2048)
        idx = idx.long()
        n, _ = tfp._normals(pts, m, d2, idx, None)
        angles = tfp._pair_features(pts, n, pts[idx], n[idx])[:3]
        return idx.cpu(), torch.stack([
            torch.clamp(((a - lo) / (hi - lo) * 11).to(torch.int32), 0,
                        10).cpu()
            for a, (lo, hi) in zip(angles, ((-1, 1), (-1, 1),
                                            (-np.pi, np.pi)))])

    out = []
    for dev in (cuda, torch.device("cpu")):
        (src, sm), (dst, dm) = prep(clouds[1], dev), prep(clouds[0], dev)
        sd, sv = tfp.fpfh(src, sm)
        dd, dv = tfp.fpfh(dst, dm)
        out.append((src, sm, dst, dm, sd, sv, dd, dv, bins(src, sm),
                    bins(dst, dm)))
    g, c = out
    for a, b, (idx, bn), (idx_c, bn_c) in ((g[4], c[4], g[8], c[8]),
                                           (g[6], c[6], g[9], c[9])):
        flip = (bn != bn_c).any(0) | (idx != idx_c)
        assert flip.sum() <= 0.01 * flip.numel()
        at = flip.any(1)
        touched = at | at[idx_c].any(1)
        assert ((a.cpu() - b)[~touched].abs() <= 1e-5).all()
    assert torch.equal(g[5].cpu(), c[5]) and torch.equal(g[7].cpu(), c[7])
    midx, sim = tfp.match_descriptors(*c[4:8])
    corr = c[5] & (sim > -torch.inf)
    samples = tra.sample_triplets(torch.Generator().manual_seed(0), corr,
                                  256)
    fits = [tra.ransac_from_samples(samples.to(d[0].device), d[0],
                                    d[2][midx.long().to(d[0].device)],
                                    corr.to(d[0].device),
                                    inlier_threshold=0.5) for d in (g, c)]
    np.testing.assert_allclose(fits[0].transform.cpu().numpy(),
                               fits[1].transform.numpy(), atol=1e-4)
    assert abs(int(fits[0].inliers) - int(fits[1].inliers)) <= 1
    T = fits[1].transform
    icps = [ticp.icp_align(d[0] @ T[:3, :3].T.to(d[0].device)
                           + T[:3, 3].to(d[0].device), d[1], d[2], d[3],
                           max_corr_dist=2.0, max_iterations=50)
            for d in (g, c)]
    np.testing.assert_allclose(icps[0].transform.cpu().numpy(),
                               icps[1].transform.numpy(), atol=1e-4)
    gen = torch.Generator(device=cuda)
    gen.manual_seed(0)
    T_rel, fitness = run_kitti.pair_align(gen, clouds[1], clouds[0],
                                          device=cuda)
    truth = np.linalg.inv(pose6_to_matrix_np(gts[0])) @ pose6_to_matrix_np(
        gts[1])
    assert np.abs(T_rel[:3, 3] - truth[:3, 3]).max() < 0.05
    assert fitness < 0.05


def _observed_sessions():
    """Two 5-keyframe sessions observing the synthetic world's map points
    (within 14 m, 5 mm noise) from parallel tracks; B's stored frame offset
    by a yaw and a translation."""
    from feature_base_pointcloud_registration_tpu_torch.pipeline import (
        multisession as tms)

    world = SyntheticWorld()
    pts = np.concatenate([world.corner_map_points(0.5),
                          world.surf_map_points(1.0)]).astype(np.float32)
    off = pose6_to_matrix_np(np.array([0, 0, 0.1, 0.6, -0.4, 0.05]))
    out = []
    for y, T_off, seed in ((-1.5, np.eye(4), 1), (1.0, off, 2)):
        rng = np.random.RandomState(seed)
        n, cc, sc = 5, 256, 2048
        s = dict(poses=np.zeros((n, 6), np.float32), times=np.arange(
            n, dtype=np.float64), corner=np.zeros((n, cc, 3), np.float32),
            corner_mask=np.zeros((n, cc), bool),
            surf=np.zeros((n, sc, 3), np.float32),
            surf_mask=np.zeros((n, sc), bool))
        for k in range(n):
            T = pose6_to_matrix_np(np.array([0, 0, 0.02 * k, 0.6 * k - 2.0,
                                             y, 0.0]))
            local = (pts - T[:3, 3]) @ T[:3, :3]
            near = local[np.linalg.norm(local, axis=1) < 14.0]
            near = near + rng.normal(0, 0.005, near.shape)
            rng.shuffle(near)
            s["corner"][k, :cc] = near[:cc]
            s["corner_mask"][k, :cc] = True
            m = min(sc, len(near) - cc)
            s["surf"][k, :m] = near[cc:cc + m]
            s["surf_mask"][k, :m] = True
            Ts = T_off @ T
            s["poses"][k] = [np.arctan2(Ts[2, 1], Ts[2, 2]),
                             np.arcsin(-Ts[2, 0]),
                             np.arctan2(Ts[1, 0], Ts[0, 0]), *Ts[:3, 3]]
        out.append(tms.Session(**s))
    return out


@pytest.mark.cuda
def test_merge_on_gpu_matches_cpu(cuda):
    """merge_sessions(coarse=False) on the card and on the CPU from the same
    Sessions: the same link pairs, poses within 1e-4 (the links'
    registrations on the K=16 fetch kernels on the card)."""
    from feature_base_pointcloud_registration_tpu_torch.pipeline import (
        multisession as tms)

    sa, sb = _observed_sessions()
    params = Params(register_grid_half_extent=(30.0, 30.0, 10.0))
    res, launches = [], []
    for dev in (cuda, torch.device("cpu")):
        before = tfetch.resident_fetch.launches + tfetch.block_fetch.launches
        res.append(tms.merge_sessions(None, sa, sb, params=params,
                                      coarse=False, link_radius=8.0,
                                      link_stride=1, device=dev))
        launches.append(tfetch.resident_fetch.launches
                        + tfetch.block_fetch.launches - before)
    links = [[(ln.idx_a, ln.idx_b) for ln in r.links] for r in res]
    assert links[0] == links[1] and len(links[0]) >= 2
    assert launches[1] == 0 and launches[0] >= 6 * len(links[0])
    np.testing.assert_allclose(res[0].transform_ab, res[1].transform_ab,
                               atol=1e-4)
    np.testing.assert_allclose(res[0].poses_a, res[1].poses_a, atol=1e-4)
    np.testing.assert_allclose(res[0].poses_b, res[1].poses_b, atol=1e-4)


@pytest.fixture
def nccl_group(cuda, tmp_path):
    """A one-rank NCCL group (a FileStore in tmp_path) for the test."""
    import torch.distributed as dist

    dist.init_process_group("nccl", store=dist.FileStore(
        str(tmp_path / "store"), 1), rank=0, world_size=1)
    yield cuda
    dist.destroy_process_group()


def _sharded_inputs(dev, resident=False):
    feats, fmap, guess = _scene(dev, B=4, Pc=512, Ps=2048, seed=3)
    tabs = tbatch.build_map_planar_tables(
        fmap, np.zeros(3), np.array([8.0, 8.0, 4.0]), corner_cell_cap=32,
        surf_cell_cap=48, resident=resident)
    return feats, fmap, guess, tabs


def _counts():
    return (tfetch.block_fetch.launches, tfetch.resident_fetch.launches,
            tgn.gn_round.launches)


@pytest.mark.cuda
@pytest.mark.parametrize("resident", [False, True])
def test_shard_register_tables_fused_on_gpu(nccl_group, resident):
    """shard_register_tables(solver="fused") on a one-rank NCCL mesh runs
    the fetch and GN kernels (4 fetches, 2 GN rounds) and returns
    batch_register_fused's result bitwise."""
    feats, _, guess, (ct, st, origin, dims) = _sharded_inputs(nccl_group,
                                                              resident)
    kw = dict(grid_dims=dims, round1_surf_stride=8, round1_corner_stride=4)
    want = tbatch.batch_register_fused(feats, ct, st, origin, guess, **kw)
    before = _counts()
    got, stats = tbatch.shard_register_tables(
        tbatch.make_mesh("cuda"), feats, ct, st, origin, guess,
        solver="fused", corner_cell_cap=32, surf_cell_cap=48, **kw)
    torch.cuda.synchronize()
    delta = tuple(a - b for a, b in zip(_counts(), before))
    assert delta == ((0, 4, 2) if resident else (4, 0, 2))
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert int(stats["n_total"]) == 4


@pytest.mark.cuda
def test_map_sharded_tables_on_gpu(nccl_group):
    """map_sharded_register_tables on a one-rank ("data", "map") mesh: its
    one shard's table is build_map_planar_tables', its fetch the
    block_fetch kernel, its result batch_register_pallas' bitwise."""
    from feature_base_pointcloud_registration_tpu_torch.parallel import (
        map_sharded as tms)

    feats, fmap, guess, (ct, st, origin, dims) = _sharded_inputs(nccl_group)
    cts, sts, o1, d1 = tms.build_sharded_block_tables(
        fmap, np.zeros(3), np.array([8.0, 8.0, 4.0]), 1, corner_cell_cap=32,
        surf_cell_cap=48)
    assert torch.equal(cts[0], ct) and torch.equal(sts[0], st)
    kw = dict(corner_cell_cap=32, surf_cell_cap=48)
    want = tbatch.batch_register_pallas(feats, ct, st, origin, guess,
                                        grid_dims=dims, **kw)
    before = _counts()
    got, _ = tms.map_sharded_register_tables(
        tms.make_2d_mesh("cuda", 1), feats, cts, sts, o1, guess,
        grid_dims=d1, **kw)
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_counts(), before)) == (4, 0, 0)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_merged_shard_fetch_on_gpu(cuda):
    """Four striped shards' block_fetch kernels merged by merge_topk equal
    the plain fetches' merge bitwise."""
    from feature_base_pointcloud_registration_tpu_torch.parallel import (
        map_sharded as tms)

    feats, fmap, guess, (_, st, origin, dims) = _sharded_inputs(cuda)
    _, sts, _, _ = tms.build_sharded_block_tables(
        fmap, np.zeros(3), np.array([8.0, 8.0, 4.0]), 4, corner_cell_cap=32,
        surf_cell_cap=48)
    q = tbatch.fetch_queries(guess, feats.surf_xyz, feats.surf_mask, st,
                             origin, 2.0, dims)
    kern = [tfetch.block_fetch(t, *q, K=8, planes_out=False) for t in sts]
    plain = [tfetch.block_fetch_reference(t, *q, K=8) for t in sts]
    plain = [(d, c.view(3, 8, -1).permute(2, 1, 0)) for d, c in plain]
    got, want = (tms.merge_topk(torch.stack([p[0] for p in ps]),
                                torch.stack([p[1] for p in ps]), 8)
                 for ps in (kern, plain))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---- the ring-pick kernel (csrc/ring_pick.cu) ----

def _pick_cases():
    """(name, window, (edge, surf)) of tests/pick_windows.py's windows, at
    tests/test_torch_ring_pick.py's thresholds."""
    import pick_windows
    cases = [(f"stream-{t}", w, (1.0, 0.1))
             for t, w in enumerate(pick_windows.stream_windows())]
    for t in range(pick_windows.N_STRIDE):
        w = pick_windows.stride_window(t)
        cases += [(f"stride-{t}", w, (0.05, 0.1)),
                  (f"ties-{t}", w, (-1.0, 0.1))]
    cases += [(f"gap-{t}", pick_windows.gap_window(t), (1.0, 0.1))
              for t in range(pick_windows.N_GAP)]
    return cases


def _assert_kernel_picks_as_plain(win, edge, surf, strict):
    """The kernel's labels on CUDA windows bitwise the plain version's on
    the same windows on the CPU; one launch."""
    before = tfeat.ring_pick.launches
    got = tfeat.ring_pick(win, edge, surf, strict)
    torch.cuda.synchronize()
    assert tfeat.ring_pick.launches == before + 1
    want = tfeat.ring_pick_reference({k: v.cpu() for k, v in win.items()},
                                     edge, surf, strict)
    assert got.dtype == torch.int8 and got.shape == want.shape
    assert torch.equal(got.cpu(), want)
    return want


@pytest.mark.cuda
@pytest.mark.parametrize("strict", [True, False], ids=["strict", "fast"])
def test_ring_pick_kernel_on_test_windows(cuda, strict):
    for name, window, (edge, surf) in _pick_cases():
        win = {k: torch.from_numpy(np.asarray(v))[None, None].to(cuda)
               for k, v in window.items()}
        _assert_kernel_picks_as_plain(win, edge, surf, strict)


EDGE_CASES = {"cap_and_step_edges": 0, "sectors_600_2000": 1,
              "equal_keys": 2, "all_corners_gaps": 3, "all_corners": 4}


@pytest.mark.cuda
@pytest.mark.parametrize("strict", [True, False], ids=["strict", "fast"])
@pytest.mark.parametrize("name", list(EDGE_CASES))
def test_ring_pick_kernel_on_walk_edges(cuda, name, strict):
    """tests/pick_windows.py's edge windows, where a walk 32 candidates a
    step meets its edges: exactly 20 corners in a sector and 21 with the
    21st first or last in its step, a corner and a surf pick whose
    suppression reaches the next step's first candidate, sectors of equal
    keys, sectors of 600 and 2000 slots (lists past the register sort),
    all six sectors full of corners."""
    import pick_windows
    window = pick_windows.edge_window(EDGE_CASES[name])
    win = {k: torch.from_numpy(np.asarray(v))[None, None].to(cuda)
           for k, v in window.items()}
    want = _assert_kernel_picks_as_plain(win, 1.0, 0.1, strict)
    want = want[0, 0].numpy()
    per_sector = [int((want[a:b + 1] == 1).sum())
                  for a, b in zip(window["sp"], window["ep"])]
    if name == "cap_and_step_edges":
        assert per_sector[:4] == [20, 20, 20, 12]
    if name.startswith("all_corners"):
        assert per_sector == [20] * 6


@pytest.mark.cuda
@pytest.mark.parametrize("strict", [True, False], ids=["strict", "fast"])
def test_ring_pick_kernel_on_overlapping_sectors(cuda, strict):
    """Sectors whose ranges overlap (no ring window has them) run one after
    another on one warp: the labels of the reference's serial greedy
    (pick_windows.serial_pick), as the kernel gave them before."""
    import pick_windows
    for t in range(pick_windows.N_STREAM):
        window = dict(pick_windows.stream_windows()[t])
        sp, ep = window["sp"].copy(), window["ep"].copy()
        sp[1:] -= 20 + 7 * t                    # each reaches into the last
        ep[2] = ep[4]                           # and one spans three
        window.update(sp=sp, ep=ep, sector_ok=sp < ep)
        win = {k: torch.from_numpy(np.asarray(v))[None, None].to(cuda)
               for k, v in window.items()}
        got = tfeat.ring_pick(win, 1.0, 0.1, strict)
        want = pick_windows.serial_pick(window, 1.0, 0.1, strict)
        np.testing.assert_array_equal(got[0, 0].cpu().numpy(), want)


def _scan_windows(dev, which):
    """(params, ring windows on dev) of a VLP-16 scan (B=1), the bench's
    batch (B=256 scans of chip_smoke.py's setup) or a 64-ring scan."""
    import pick_windows
    params, world = Params(), SyntheticWorld()
    if which == "vlp16":
        scans = [simulate_scan(world, [0.02, -0.01, 0.3, 1.0, 2.0, 0.0],
                               seed=0, noise=0.02)]
    elif which == "bench":
        rng = np.random.RandomState(0)
        scans = [simulate_scan(world, [0, 0, rng.uniform(-1, 1),
                                       rng.uniform(-6, 6), rng.uniform(-6, 6),
                                       0.0], seed=i) for i in range(256)]
    else:
        params = Params(n_scan=64, horizon_scan=1800)
        scans = [pick_windows.hdl64_scan(0)]
    raw = cloud_info.RawScan(*(torch.from_numpy(np.stack(
        [np.asarray(s[k]) for s in scans])).to(dev)
        for k in ("xyz", "intensity", "ring", "time", "valid")))
    cloud = tproj.project_scan(params, raw)
    return params, tfeat._ring_windows(cloud, params.n_scan,
                                       params.horizon_scan)


@pytest.mark.cuda
@pytest.mark.parametrize("which,strict", [
    ("vlp16", True), ("vlp16", False), ("bench", False), ("bench", True),
    ("hdl64", True), ("hdl64", False)])
def test_ring_pick_kernel_on_scans(cuda, which, strict):
    params, win = _scan_windows(cuda, which)
    want = _assert_kernel_picks_as_plain(win, params.edge_threshold,
                                         params.surf_threshold, strict)
    assert (want == 1).sum() > 100
    assert win["curv"].shape[-1] == params.horizon_scan + 16


@pytest.mark.cuda
@pytest.mark.parametrize("strict", [True, False], ids=["strict", "fast"])
def test_extract_features_picks_in_one_launch_without_syncs(
        cuda, monkeypatch, strict):
    """One extract_features call on the card launches the kernel once, and
    its picking makes no host sync (the sync debug mode raises on one)."""
    pick = tfeat._pick
    calls = []

    def no_sync_pick(*a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = pick(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        calls.append(1)
        return out

    params, raw, _ = _skewed_scan(cuda)
    cloud = tproj.project_scan(params, raw)
    monkeypatch.setattr(tfeat, "_pick", no_sync_pick)
    before = (tfeat.ring_pick.launches, tfeat.extract_features.host_syncs)
    feats = tfeat.extract_features(params, cloud, strict=strict)
    torch.cuda.synchronize()
    assert calls == [1]
    assert (tfeat.ring_pick.launches,
            tfeat.extract_features.host_syncs) == (before[0] + 1, before[1])
    want = tfeat.extract_features(params, cloud_info.CloudInfo(
        *(a.cpu() for a in cloud)), strict=strict)
    assert all(torch.equal(a.cpu(), b) for a, b in zip(feats, want))


@pytest.mark.cuda
def test_ring_pick_rejects_what_the_kernel_does_not_take(cuda):
    import pick_windows
    window = pick_windows.stream_windows()[0]
    win = {k: torch.from_numpy(np.asarray(v))[None, None].to(cuda)
           for k, v in window.items()}
    bad = [("curv", win["curv"].double(), TypeError),
           ("col", win["col"].long(), TypeError),
           ("picked", win["picked"].to(torch.uint8), TypeError),
           ("sp", win["sp"].long(), TypeError),
           ("sector_ok", win["sector_ok"].int(), TypeError),
           ("col", win["col"][..., :-1], ValueError),
           ("ep", win["ep"][..., :5], ValueError),
           ("curv", torch.stack([win["curv"]] * 2, -1)[..., 0], ValueError),
           ("sp", win["sp"].cpu(), ValueError)]
    before = tfeat.ring_pick.launches
    for name, t, error in bad:
        with pytest.raises(error):
            tfeat.ring_pick({**win, name: t}, 1.0, 0.1, True)
    W = 8200                                          # over RING_PICK_MAX_W
    wide = {"curv": torch.zeros(1, 1, W, device=cuda),
            "col": torch.zeros(1, 1, W, dtype=torch.int32, device=cuda),
            "picked": torch.zeros(1, 1, W, dtype=torch.bool, device=cuda),
            "sp": torch.zeros(1, 1, 6, dtype=torch.int32, device=cuda),
            "ep": torch.full((1, 1, 6), W - 1, dtype=torch.int32,
                             device=cuda),
            "sector_ok": torch.ones(1, 1, 6, dtype=torch.bool, device=cuda)}
    with pytest.raises(ValueError):
        tfeat.ring_pick(wide, 1.0, 0.1, True)
    assert tfeat.ring_pick.launches == before
    # the widest window it takes, one sector over all of it, runs
    W = 8192
    wide = {k: v[..., :W] if v.shape[-1] == 8200 else v
            for k, v in wide.items()}
    wide["curv"] = torch.rand(1, 1, W, generator=torch.Generator(
        cuda).manual_seed(0), device=cuda) * 2
    wide["ep"] = torch.full_like(wide["ep"], W - 1)
    wide["sector_ok"][..., 1:] = False
    _assert_kernel_picks_as_plain({k: v.contiguous() for k, v in
                                   wide.items()}, 1.0, 0.1, True)


# ------------------------------------------------------- pose-graph LM

def _pose_graph_kw(kind):
    return {"chain": {}, "gps": dict(gps=True, noise=0.0),
            "loop": dict(loop=True, noise=0.05)}[kind]


def _host_syncs(caught):
    """The synchronizing operations the CUDA sync debug mode reported (not
    its one-time notice that the mode is a prototype)."""
    return sum("called a synchronizing" in str(w.message) for w in caught)


def _lm_counts():
    return (tpg.optimize_pose_graph.launches,
            tpg.optimize_pose_graph.launches_b)


def _assert_lm_as_plain(g, iterations):
    """The kernel's solve against the plain version's on the card: poses
    within 1e-4, cost within 1e-4 relative.  Returns the kernel's."""
    acc_k, acc_p = [], []
    pk, ck = tpg.optimize_pose_graph(g, iterations, acc_k)
    pp, cp = tpg.optimize_pose_graph_reference(g, iterations, acc_p)
    torch.cuda.synchronize()
    assert pk.shape == g.poses.shape and bool(torch.isfinite(pk).all())
    assert float((pk - pp).abs().max()) <= 1e-4
    # a converged graph's cost (~1e-8) is rounding noise: abs 1e-6
    assert float(ck) == pytest.approx(float(cp), rel=1e-4, abs=1e-6)
    assert len(acc_k) == len(acc_p) == iterations
    return pk, ck


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["window", "slots512"])
@pytest.mark.parametrize("kind", ["chain", "gps", "loop"])
def test_pose_graph_lm_kernel_matches_plain(cuda, kind, shape):
    g, _ = pgs.chain(shape, device=cuda, **_pose_graph_kw(kind))
    a0, b0 = _lm_counts()
    with pytest.warns(UserWarning, match="synchroniz") as caught:
        torch.cuda.set_sync_debug_mode("warn")
        try:
            tpg.optimize_pose_graph(g, 12)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert _host_syncs(caught) == 1
    assert _lm_counts() == (a0 + 1, b0)
    pk, _ = _assert_lm_as_plain(g, 12)
    # the non-live slots come back as they were, bitwise
    assert torch.equal(pk[20:], g.poses[20:])
    again = tpg.optimize_pose_graph(g, 12)
    assert torch.equal(again[0], pk)


ENVELOPE_GRAPHS = {
    # a loop closure spanning the whole window
    "window_loop": lambda dev: pgs.loops(30, [(29, 0)], device=dev)[0],
    "loops": lambda dev: pgs.loops(24, [(23, 0), (15, 3), (20, 8)],
                                   device=dev)[0],
    # every row's envelope from pose 0: the factorization on the whole CTA
    "star_at_cap": lambda dev: pgs.star(kernels.POSE_GRAPH_LM_MAX_LIVE,
                                        device=dev)[0],
    "masked_interior": lambda dev: pgs.loops(20, [(19, 0)], inactive=(7,),
                                             device=dev)[0],
}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", list(ENVELOPE_GRAPHS))
def test_pose_graph_lm_envelope_graphs_match_plain(cuda, kind):
    """Route A's envelope factorization on graphs whose envelope is wider
    than the window's chain: one launch, one host sync (the live count),
    the plain version's poses and cost, two launches bitwise, an inactive
    pose where it was."""
    g = ENVELOPE_GRAPHS[kind](cuda)
    a0, b0 = _lm_counts()
    with pytest.warns(UserWarning, match="synchroniz") as caught:
        torch.cuda.set_sync_debug_mode("warn")
        try:
            tpg.optimize_pose_graph(g, 12)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert _host_syncs(caught) == 1
    assert _lm_counts() == (a0 + 1, b0)
    pk, ck = _assert_lm_as_plain(g, 12)
    again = tpg.optimize_pose_graph(g, 12)
    assert torch.equal(again[0], pk) and torch.equal(again[1], ck)
    if kind == "masked_interior":
        assert torch.equal(pk[7], g.poses[7])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [kernels.POSE_GRAPH_LM_MAX_LIVE,
                               kernels.POSE_GRAPH_LM_MAX_LIVE + 1, 200])
def test_pose_graph_lm_routes_by_live_count(cuda, n):
    g, _ = pgs.big_chain(n, device=cuda)
    a0, b0 = _lm_counts()
    route_b = n > kernels.POSE_GRAPH_LM_MAX_LIVE
    with pytest.warns(UserWarning, match="synchroniz") as caught:
        torch.cuda.set_sync_debug_mode("warn")
        try:
            tpg.optimize_pose_graph(g, 12)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert _host_syncs(caught) == 1
    assert _lm_counts() == ((a0, b0 + 24) if route_b else (a0 + 1, b0))
    pk, _ = _assert_lm_as_plain(g, 12)
    assert torch.equal(tpg.optimize_pose_graph(g, 12)[0], pk)


@pytest.mark.cuda
@pytest.mark.parametrize("case", pgs.BLOCK_CASES)
def test_pose_graph_blocks_kernel_matches_plain(cuda, case):
    g = pgs.blocks_graph(case, device=cuda)
    before = tpg.graph_factor_blocks.launches
    got = [t for grp in tpg.graph_factor_blocks(g, g.poses) for t in grp]
    want = [t for grp in tpg.graph_factor_blocks_reference(g, g.poses)
            for t in grp]
    assert tpg.graph_factor_blocks.launches == before + 1
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        keep = ~torch.isnan(b)
        assert float((a[keep] - b[keep]).abs().max()) <= 1e-5
    if case == "near_pi_axis":
        assert bool(torch.isnan(got[1]).any())
    else:
        assert all(bool(torch.isfinite(t).all()) for t in got)


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["gimbal", "near_pi_axis", "gimbal_loop"])
def test_pose_graph_lm_rejects_a_non_finite_hessian(cuda, which):
    """Gimbal lock (asin's infinite derivative) and a rotation error near
    pi about an axis (sqrt(0)'s): H is not finite, every pivot test fails,
    every step is rejected, the poses come back bitwise.  gimbal_loop: the
    non-finite rows early in a chain with a loop closure, where the dense
    update would carry NaN left of the later rows' envelope; the envelope
    factorization fails all the same."""
    g = {"gimbal": pgs.gimbal, "gimbal_loop": pgs.gimbal_loop,
         "near_pi_axis": lambda device: pgs.blocks_graph(
             "near_pi_axis", device)}[which](device=cuda)
    acc = []
    pk, ck = tpg.optimize_pose_graph(g, 8, acc)
    pp, cp = tpg.optimize_pose_graph_reference(g, 8)
    assert torch.equal(pk, g.poses) and torch.equal(pp, g.poses)
    assert not any(bool(a) for a in acc)
    assert float(ck) == pytest.approx(float(cp), rel=1e-6)


@pytest.mark.cuda
def test_pose_graph_lm_route_b_rejects_a_failed_factorization(
        cuda, monkeypatch):
    """Route B's dense solve is torch.linalg.cholesky_ex: forced to report
    failure with a finite L (plain gradient descent, which lowers the
    cost), the update kernel must reject every step."""
    g, _ = pgs.big_chain(kernels.POSE_GRAPH_LM_MAX_LIVE + 1, device=cuda)

    def failed(A):
        return (torch.eye(A.shape[0], device=A.device),
                torch.ones((), dtype=torch.int32, device=A.device))

    monkeypatch.setattr(torch.linalg, "cholesky_ex", failed)
    acc = []
    pk, ck = tpg.optimize_pose_graph(g, 2, acc)
    cost0 = tpg._total_cost(g, g.poses)
    monkeypatch.undo()
    assert torch.equal(pk, g.poses) and not any(bool(a) for a in acc)
    assert float(ck) == pytest.approx(float(cost0), rel=1e-5)
    # the garbage step would have lowered the cost: taken only if the
    # failure flag were ignored
    K = g.poses.shape[0]
    H, grad, _ = tpg._assemble(g, g.poses, K)
    active = g.pose_mask.repeat_interleave(6)
    d = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-12)) + torch.where(
        active, 0.0, 1.0)
    step = torch.where(active, -grad / d / d, 0.0)
    assert float(tpg._total_cost(g, g.poses + step.reshape(K, 6))) < float(
        cost0)


@pytest.mark.cuda
def test_pose_graph_lm_raises_off_the_kernel(cuda):
    g, _ = pgs.chain("window", device=cuda)
    with pytest.raises(ValueError):
        tpg.optimize_pose_graph(g._replace(gps_mask=g.gps_mask.int()), 2)
    with pytest.raises(ValueError):
        tpg.graph_factor_blocks(g, g.poses.cpu())


# ---------------------------------------------- IMU chain LM, preintegration

def _syncs_of(fn):
    """fn's result and its host syncs in the CUDA sync debug mode."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, _host_syncs(caught)


def _same_nan_within(a, b, tol):
    """NaN (and infinities) in the same places and the rest within tol;
    returns the largest difference."""
    assert a.shape == b.shape and a.dtype == b.dtype
    assert torch.equal(torch.isnan(a), torch.isnan(b))
    fin = torch.isfinite(b)
    assert torch.equal(torch.isfinite(a), fin)
    assert torch.equal(a[torch.isinf(b)], b[torch.isinf(b)])
    err = float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0
    assert err <= tol, (err, tol)
    return err


def _assert_chain_as_plain(d, iterations=4):
    """The kernel's chain solve against the plain version's on the card:
    one launch, no host sync, states within 1e-4 (NaN in the same places),
    the cost that of the kernel's states (1e-4 relative) and within 1e-3
    relative of the plain version's (or both NaN), two launches bitwise."""
    from feature_base_pointcloud_registration_tpu_torch.graph import (
        imu_graph as tg)
    before = tg.optimize_imu_chain.launches
    acc_k, acc_p = [], []
    (sk, ck), syncs = _syncs_of(lambda: tg.optimize_imu_chain(
        d, iterations, acc_k))
    sp, cp = tg.optimize_imu_chain_reference(d, iterations, acc_p)
    torch.cuda.synchronize()
    assert tg.optimize_imu_chain.launches == before + 1 and syncs == 0
    agree = sum(bool(x) == bool(y) for x, y in zip(acc_k, acc_p))
    print(f"chain LM K {d.states.shape[0]}: states |diff| max "
          f"{float((sk - sp).abs().max()):.3e}, cost {float(ck):.6e} vs "
          f"{float(cp):.6e}, accepts equal on {agree}/{iterations}")
    _same_nan_within(sk, sp, 1e-4)
    if np.isnan(float(cp)):
        assert np.isnan(float(ck))
    else:
        # the cost is that of the states it comes with, and within 1e-3 of
        # the plain version's (states 1e-5 apart move a cost of residuals
        # whitened by ~1e-5 sigmas by up to 6e-4 relative before the
        # window converges, K 100)
        at = tg._cost(d, sk, tg._whitener(d))
        assert float(ck) == pytest.approx(float(at), rel=1e-4, abs=1e-4)
        assert float(ck) == pytest.approx(float(cp), rel=1e-3, abs=1e-4)
    again = tg.optimize_imu_chain(d, iterations)
    assert torch.equal(again[0], sk) and (
        torch.equal(again[1], ck) or bool(torch.isnan(ck)))
    return sk, ck, acc_k


@pytest.mark.cuda
@pytest.mark.parametrize("name", ics.SCENES)
def test_imu_chain_lm_kernel_matches_plain(cuda, name):
    d = ics.scene(name, device=cuda)
    sk, _, acc = _assert_chain_as_plain(d)
    if name in ("nan_cov", "near_pi_axis"):     # every step rejected
        assert torch.equal(sk, d.states) and not any(bool(a) for a in acc)
    if name == "interior_masked":               # the inactive state pinned
        assert torch.equal(sk[7], d.states[7])


@pytest.mark.cuda
@pytest.mark.parametrize("K", [1, 48, 100])
def test_imu_chain_lm_kernel_by_window_size(cuda, K):
    """The full window's scene at K 1 (no block below the diagonal), 48
    and 100 (the reference's reset interval): one launch, no host sync,
    the plain version's states and cost, two launches bitwise."""
    d = ics.scene("full", device=cuda, K=K)
    sk, _, acc = _assert_chain_as_plain(d)
    assert bool(torch.isfinite(sk).all())
    # K 1: the state sits at its prior and measurement, the cost is 0
    assert any(bool(a) for a in acc) == (K > 1)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ics.SCENES)
def test_imu_chain_blocks_kernel_matches_plain(cuda, name):
    from feature_base_pointcloud_registration_tpu_torch.graph import (
        imu_graph as tg)
    d = ics.scene(name, device=cuda)
    before = tg.chain_factor_blocks.launches
    got, syncs = _syncs_of(lambda: tg.chain_factor_blocks(d, d.states))
    want = tg.chain_factor_blocks_reference(d, d.states)
    assert tg.chain_factor_blocks.launches == before + 1 and syncs == 0
    errs = []
    for a, b in zip((t for g in got for t in g), (t for g in want for t in g)):
        fin = b[torch.isfinite(b)]
        scale = max(float(fin.abs().max()), 1e-30) if fin.numel() else 1.0
        errs.append(_same_nan_within(a, b, 1e-5 * scale) / scale)
    print(f"chain blocks {name}: |diff| / block max, max {max(errs):.3e}")
    if name in ("nan_cov", "near_pi_axis"):
        assert not all(bool(torch.isfinite(t).all()) for g in got for t in g)


def _pre_leaves_as_plain(got, want, args):
    """The PreintState leaves by ics.preint_agreement (the CPU bounds up to
    64 live samples; above, 1e-5 and a cov floor of 1e-6, the kernel as
    near the float64 plain version as the plain version, within a factor
    of 2), NaN in the same places; prints the measured figures first."""
    ok, rep = ics.preint_agreement(got, want, args, {})
    print(rep)
    for a, b in zip(got, want):
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(torch.isfinite(a), torch.isfinite(b))
    assert ok, rep


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ics.BUFFERS)
def test_preintegrate_kernel_matches_plain(cuda, kind):
    from feature_base_pointcloud_registration_tpu_torch.imu import (
        preintegration as tp)
    buf = ics.buffer(kind, device=cuda)
    before = tp.preintegrate.launches
    got, syncs = _syncs_of(lambda: tp.preintegrate(*buf, ics.ACC_VAR,
                                                   ics.GYR_VAR))
    want = tp.preintegrate_reference(*buf, ics.ACC_VAR, ics.GYR_VAR)
    assert tp.preintegrate.launches == before + 1 and syncs == 0
    assert all(t.shape == w.shape and t.is_contiguous()
               for t, w in zip(got, want))
    print(f"preintegrate {kind}: ", end="")
    _pre_leaves_as_plain(got, want, (*buf, ics.ACC_VAR, ics.GYR_VAR))
    again = tp.preintegrate(*buf, ics.ACC_VAR, ics.GYR_VAR)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    if kind == "none_live":
        assert float(got.dt) == 0.0 and torch.equal(
            got.dR, torch.eye(3, device=cuda))
    # the mask as a host array: uploaded, the same result
    if buf[3] is not None:
        host = tp.preintegrate(*buf[:3], buf[3].cpu().numpy(), *buf[4:],
                               ics.ACC_VAR, ics.GYR_VAR)
        assert all(torch.equal(a, b) for a, b in zip(host, got))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ics.BUFFERS)
def test_propagate_states_kernel_matches_plain(cuda, kind):
    from feature_base_pointcloud_registration_tpu_torch.imu import (
        preintegration as tp)
    acc, gyr, dt, m, ba, bg = ics.buffer(kind, device=cuda)
    nav = tp.NavState(
        torch.from_numpy(ics.rot((0.1, -0.2, 0.7)).astype(np.float32)).to(
            cuda), torch.tensor([1.0, -2.0, 0.5], device=cuda),
        torch.tensor([1.2, 0.1, 0.0], device=cuda))
    before = tp.propagate_states.launches
    got, syncs = _syncs_of(lambda: tp.propagate_states(
        nav, ba, bg, acc, gyr, dt, m, gravity=ics.G))
    want = tp.propagate_states_reference(nav, ba, bg, acc, gyr, dt, m,
                                         gravity=ics.G)
    assert tp.propagate_states.launches == before + 1 and syncs == 0
    errs = [_same_nan_within(a, b, 1e-5 * max(1.0, float(b.abs().max())))
            for a, b in zip(got, want)]
    print(f"propagate_states {kind}: R, p, v |diff| max {errs}")
    again = tp.propagate_states(nav, ba, bg, acc, gyr, dt, m, gravity=ics.G)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ics.EDGE_BUFFERS)
def test_preintegration_kernels_on_edge_buffers(cuda, kind):
    """Both kernels against their plain versions on the edge buffers (one
    live sample, a masked first and last slot, dt 0, a rotation near pi,
    97 slots, an accel that overflows cov, a dt that overflows B): one
    launch each, no host sync, two launches bitwise; the finite buffers by
    the bounds above, the other two with the same leaves finite and those
    leaves' finite entries within the same bounds."""
    from feature_base_pointcloud_registration_tpu_torch.imu import (
        preintegration as tp)
    buf = ics.buffer(kind, device=cuda)
    args = (*buf, ics.ACC_VAR, ics.GYR_VAR)
    before = tp.preintegrate.launches
    got, syncs = _syncs_of(lambda: tp.preintegrate(*args))
    want = tp.preintegrate_reference(*args)
    assert tp.preintegrate.launches == before + 1 and syncs == 0
    print(f"preintegrate {kind}: ", end="")
    if kind in ics.NONFINITE_BUFFERS:
        for f, a, b in zip(got._fields, got, want):
            assert torch.equal(torch.isfinite(a), torch.isfinite(b)), f
            if f != "cov" and bool(torch.isfinite(b).all()):
                scale = max(1.0, float(b.abs().max()))
                assert float((a - b).abs().max()) <= 1e-6 * scale, f
        print({f: bool(torch.isfinite(a).all()) for f, a in
               zip(got._fields, got)})
    else:
        _pre_leaves_as_plain(got, want, args)
    again = tp.preintegrate(*args)
    assert all(_bits_equal(a, b) for a, b in zip(again, got))
    acc, gyr, dt, m, ba, bg = buf
    nav = tp.NavState(
        torch.from_numpy(ics.rot((0.1, -0.2, 0.7)).astype(np.float32)).to(
            cuda), torch.tensor([1.0, -2.0, 0.5], device=cuda),
        torch.tensor([1.2, 0.1, 0.0], device=cuda))
    before = tp.propagate_states.launches
    got, syncs = _syncs_of(lambda: tp.propagate_states(
        nav, ba, bg, acc, gyr, dt, m, gravity=ics.G))
    want = tp.propagate_states_reference(nav, ba, bg, acc, gyr, dt, m,
                                         gravity=ics.G)
    assert tp.propagate_states.launches == before + 1 and syncs == 0
    errs = []
    for a, b in zip(got, want):
        fin = b[torch.isfinite(b)]
        scale = max(1.0, float(fin.abs().max())) if fin.numel() else 1.0
        errs.append(_same_nan_within(a, b, 1e-5 * scale))
    print(f"propagate_states {kind}: R, p, v |diff| max {errs}")
    again = tp.propagate_states(nav, ba, bg, acc, gyr, dt, m, gravity=ics.G)
    assert all(_bits_equal(a, b) for a, b in zip(again, got))


def _bits_equal(a, b):
    """float32 tensors equal bit for bit, NaN included."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.cuda
def test_imu_kernels_raise_off_the_kernel(cuda):
    from feature_base_pointcloud_registration_tpu_torch.graph import (
        imu_graph as tg)
    from feature_base_pointcloud_registration_tpu_torch.imu import (
        preintegration as tp)
    d = ics.scene("full", device=cuda)
    with pytest.raises(ValueError):
        tg.optimize_imu_chain(d._replace(state_mask=d.state_mask.int()), 2)
    with pytest.raises(ValueError):
        tg.chain_factor_blocks(d, d.states.cpu())
    acc, gyr, dt, m, ba, bg = ics.buffer("cap64", device=cuda)
    with pytest.raises(ValueError):
        tp.preintegrate(acc, gyr, dt.double(), m, ba, bg, 1e-4, 1e-5)
    with pytest.raises(ValueError):
        tp.propagate_states(tp.NavState.identity(device=cuda), ba, bg,
                            acc[:0], gyr[:0], dt[:0], None)


# ---- the streamed k-NN and ICP kernels (csrc/knn_stream.cu, csrc/icp.cu)

import icp_scenes as iscn  # noqa: E402

def _knn_inputs(scene, M, chunk, maps, dev, Q=2000):
    """tests/icp_scenes.py's k-NN scene: one query set against its map, or
    two sets (seeds 0 and 1) with one map each."""
    sets = [iscn.knn_scene(scene, M, chunk, Q=Q, seed=s)
            for s in ((0,) if maps == "shared" else (0, 1))]
    if maps == "shared":
        return [torch.from_numpy(a).to(dev) for a in sets[0]]
    return [torch.from_numpy(np.stack(a)).to(dev) for a in zip(*sets)]


@pytest.mark.cuda
@pytest.mark.parametrize("chunks", ["one", "four"])
@pytest.mark.parametrize("maps", ["shared", "per_set"])
@pytest.mark.parametrize("k", [1, 5, 16])
@pytest.mark.parametrize("scene", iscn.KNN_SCENES)
def test_knn_kernel_matches_plain(cuda, scene, k, maps, chunks):
    """The k-NN kernel against its plain version on the card, in one launch
    with no host sync (icp_scenes.knn_agreement's tolerances); two
    launches bitwise."""
    from feature_base_pointcloud_registration_tpu_torch.ops import (
        knn as tknn)
    M = 4096
    chunk = M if chunks == "one" else M // 4
    q, ref, mask = _knn_inputs(scene, M, chunk, maps, cuda)
    before = tknn.knn.launches
    (d2k, ik), syncs = _syncs_of(lambda: tknn.knn(q, ref, mask, k=k,
                                                  chunk=chunk))
    assert tknn.knn.launches == before + 1 and syncs == 0
    assert d2k.shape == (*q.shape[:-1], k) and ik.dtype == torch.int32
    d2p, ip = tknn.knn_reference(q, ref, mask, k=k, chunk=chunk)
    d2p1 = tknn.knn_reference(q, ref, mask, k=k + 1, chunk=chunk)[0]
    sets = (((q, ref, d2k, ik, d2p, ip, d2p1),) if maps == "shared" else
            zip(q, ref, d2k, ik, d2p, ip, d2p1))
    out = [iscn.knn_agreement(*s) for s in sets]
    print(f"knn {scene} k={k} {maps} {chunks}: d2 |diff| max "
          f"{max(e for e, _ in out):.3e}, index differences "
          f"{sum(n for _, n in out)}")
    if scene == "duplicates":
        want = [4, 5, 6, 7, 8][:k]
        assert ik[..., 0, :len(want)].reshape(-1, len(want))[0].tolist() \
            == want
    again = tknn.knn(q, ref, mask, k=k, chunk=chunk)
    assert torch.equal(again[0], d2k) and torch.equal(again[1], ik)


@pytest.mark.cuda
def test_knn_kernel_refuses_what_it_does_not_take(cuda):
    from feature_base_pointcloud_registration_tpu_torch.ops import (
        knn as tknn)
    q, ref, mask = _knn_inputs("random", 1024, 256, "shared", cuda, Q=64)
    for bad in (dict(k=17), dict(k=0), dict(chunk=384)):
        kw = {"k": 5, "chunk": 256, **bad}
        with pytest.raises(ValueError):
            tknn.knn(q, ref, mask, **kw)
    with pytest.raises(ValueError):
        tknn.knn(q.double(), ref.double(), mask, k=5, chunk=256)
    with pytest.raises(ValueError):
        tknn.knn(q, ref, mask.cpu(), k=5, chunk=256)


ICP_CAPS = {"small": (256, 1024, 256), "phase8": (4096, 16384, 2048),
            "pair": (2048, 2048, 2048), "merge": (4096, 4096, 2048)}
ICP_CASES = [(s, "small") for s in iscn.ICP_SCENES] + [
    ("room", "phase8"), ("pair", "pair"), ("merge", "merge")]


def _icp_inputs(scene, caps, dev):
    N, M, chunk = ICP_CAPS[caps]
    src, sm, dst, dm, kw = iscn.icp_scene(scene, N=N, M=M, chunk=chunk)
    return [torch.from_numpy(a).to(dev) for a in (src, sm, dst, dm)], kw


@pytest.mark.cuda
@pytest.mark.parametrize("scene,caps", ICP_CASES)
def test_icp_kernel_matches_plain(cuda, scene, caps):
    """One icp_align run on the card is one launch with no host sync; its
    transform within 1e-4 of the plain version's on the card
    (icp_align_reference, the parent's loop), converged and the loop
    closure's fitness gate (< 0.3) equal, fitness within the k-NN's d2
    tolerance averaged over the matches (icp_scenes.fitness_tol); two
    launches bitwise; with no correspondence or one (H = 0) R is I in
    both."""
    from feature_base_pointcloud_registration_tpu_torch.ops import (
        icp as ticp)
    args, kw = _icp_inputs(scene, caps, cuda)
    before = ticp.icp_align.launches
    got, syncs = _syncs_of(lambda: ticp.icp_align(*args, **kw))
    assert ticp.icp_align.launches == before + 1 and syncs == 0
    want = ticp.icp_align_reference(*args, **kw)
    d = float((got.transform - want.transform).abs().max())
    print(f"icp {scene} at {caps} caps: transform |diff| {d:.3e}, "
          f"iterations {int(got.iterations)} vs {int(want.iterations)}, "
          f"fitness {float(got.fitness):.7g} vs {float(want.fitness):.7g}, "
          f"delta {float(got.delta):.3e} vs {float(want.delta):.3e}")
    assert d <= 1e-4
    assert bool(got.converged) == bool(want.converged)
    assert (float(got.fitness) < 0.3) == (float(want.fitness) < 0.3)
    tol = iscn.fitness_tol(args[0].cpu(), args[1].cpu(),
                           want.transform.cpu())
    assert abs(float(got.fitness) - float(want.fitness)) <= tol
    assert got.iterations.dtype == torch.int32 \
        and got.converged.dtype == torch.bool
    if scene in ("far", "one_match"):
        assert torch.equal(got.transform[:3, :3], torch.eye(3, device=cuda))
        assert torch.equal(want.transform[:3, :3],
                           torch.eye(3, device=cuda))
    if scene == "far":
        assert torch.equal(got.transform, torch.eye(4, device=cuda))
    again = ticp.icp_align(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(again, got))


@pytest.mark.cuda
def test_icp_kernel_refuses_what_it_does_not_take(cuda):
    from feature_base_pointcloud_registration_tpu_torch.ops import (
        icp as ticp)
    (src, sm, dst, dm), kw = _icp_inputs("room", "small", cuda)
    with pytest.raises(ValueError):
        ticp.icp_align(src, sm, dst, dm, chunk=384)
    with pytest.raises(ValueError):
        ticp.icp_align(src, sm.float(), dst, dm, chunk=256)
    with pytest.raises(ValueError):
        ticp.icp_align(src.double(), sm, dst.double(), dm, chunk=256)
    with pytest.raises(ValueError):
        ticp.icp_align(src, sm, dst.cpu(), dm.cpu(), chunk=256)


# ---- the redesigned k-NN and ICP kernels at the transcription's keys and
# the cell search's edge scenes (tests/knn_cells.py, icp_scenes.EDGE_SCENES)

import knn_cells as kcl  # noqa: E402


def _same_bits(d2, idx, want):
    return np.array_equal(d2.cpu().numpy().view(np.int32),
                          want[0].view(np.int32)) \
        and np.array_equal(idx.cpu().numpy(), want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("chunks", ["one", "four"])
@pytest.mark.parametrize("k", [1, 5, 16])
@pytest.mark.parametrize("scene", iscn.KNN_SCENES)
def test_knn_kernel_is_the_brute_force_transcription(cuda, scene, k, chunks):
    """The k-NN kernel bit for bit tests/knn_cells.py's brute force of the
    parent kernel's keys (no-neighbour slots included), on the centroid
    the call takes on the card."""
    from feature_base_pointcloud_registration_tpu_torch.ops import (
        knn as tknn)
    M = 4096
    chunk = M if chunks == "one" else M // 4
    q, ref, mask = iscn.knn_scene(scene, M, chunk, Q=500)
    tq, tr, tm = (torch.from_numpy(a).to(cuda) for a in (q, ref, mask))
    d2, idx = tknn.knn(tq, tr, tm, k=k, chunk=chunk)
    c = tq.mean(-2).cpu().numpy()
    assert _same_bits(d2, idx, kcl.brute_knn(q, ref, mask, k, chunk == M,
                                             c))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 5, 16])
@pytest.mark.parametrize("scene", iscn.EDGE_SCENES)
def test_knn_kernel_at_edge_scenes(cuda, scene, k):
    """The edge scenes' source rows against their target: the kernel bit
    for bit the brute-force transcription, and held to the plain version
    by icp_scenes.knn_agreement."""
    from feature_base_pointcloud_registration_tpu_torch.ops import (
        knn as tknn)
    src, _, dst, dm, kw = iscn.edge_scene(scene)
    tq, tr, tm = (torch.from_numpy(a).to(cuda) for a in (src, dst, dm))
    d2, idx = tknn.knn(tq, tr, tm, k=k, chunk=kw["chunk"])
    c = tq.mean(-2).cpu().numpy()
    assert _same_bits(d2, idx, kcl.brute_knn(src, dst, dm, k, False, c))
    d2p, ip = tknn.knn_reference(tq, tr, tm, k=k, chunk=kw["chunk"])
    d2p1 = tknn.knn_reference(tq, tr, tm, k=k + 1, chunk=kw["chunk"])[0]
    iscn.knn_agreement(tq, tr, d2, idx, d2p, ip, d2p1)


@pytest.mark.cuda
@pytest.mark.parametrize("scene", iscn.EDGE_SCENES)
def test_icp_kernel_at_edge_scenes(cuda, scene):
    """icp_align at the cell search's edge scenes: one launch, no host
    sync, two launches bitwise; with no iteration the fitness at T = I
    (the mean d2 of the 1-NN over the matches) within the k-NN's d2
    tolerance of the brute-force transcription's and converged equal;
    where no near-tie can steer the run (few and no live target points:
    elsewhere the plain version's cuBLAS keys may break a near-tie the
    other way, and the 1e-6 epsilon then stops one run and not the other,
    ROADMAP Queue 3) the run held to the plain version as
    test_icp_kernel_matches_plain holds it."""
    from feature_base_pointcloud_registration_tpu_torch.ops import (
        icp as ticp)
    src, sm, dst, dm, kw = iscn.edge_scene(scene)
    args = [torch.from_numpy(a).to(cuda) for a in (src, sm, dst, dm)]
    before = ticp.icp_align.launches
    got, syncs = _syncs_of(lambda: ticp.icp_align(*args, **kw))
    assert ticp.icp_align.launches == before + 1 and syncs == 0
    again = ticp.icp_align(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(again, got))
    assert torch.isfinite(got.transform).all()
    first = ticp.icp_align(*args, **dict(kw, max_iterations=0))
    c = np.float32(src.astype(np.float64).mean(0))
    d2, _ = kcl.brute_knn(src, dst, dm, 1, False, c)
    w = sm & (d2[:, 0] < np.float32(kw["max_corr_dist"]) ** 2)
    want = float((d2[:, 0].astype(np.float64) * w).sum() / max(w.sum(), 1))
    tol = iscn.fitness_tol(src, sm, np.eye(4)) + 1e-6 * abs(want)
    print(f"icp {scene}: fitness at T = I {float(first.fitness):.7g} vs "
          f"{want:.7g} (held to {tol:.2e}), {int(got.iterations)} "
          f"iterations")
    assert abs(float(first.fitness) - want) <= tol
    assert bool(first.converged) == bool(w.sum() >= 3)
    if scene not in ("few_live", "no_live"):
        return
    want = ticp.icp_align_reference(*args, **kw)
    assert float((got.transform - want.transform).abs().max()) <= 1e-4
    assert bool(got.converged) == bool(want.converged)
    tol = iscn.fitness_tol(src, sm, want.transform.cpu())
    assert abs(float(got.fitness) - float(want.fitness)) <= tol


# -------------------------------------------- the exact solver's GN loop

import exact_scenes as es  # noqa: E402


def _exact_pair(cuda, feats, fmap, pose, iters=30, cluster=None,
                chunk=es.CHUNK):
    """The exact_gn kernel (one launch, its host syncs counted) and the
    plain loop (`exact_gn_reference`) on the card and on the CPU, on the
    same inputs."""
    from feature_base_pointcloud_registration_tpu_torch.ops import (
        exact_gn as tex)
    kw = dict(iters=iters, chunk=chunk)
    want = tex.exact_gn_reference(pose, feats, fmap, **kw)
    cpu = tex.exact_gn_reference(pose.cpu(), type(feats)(*(
        t.cpu() for t in feats)), type(fmap)(*(t.cpu() for t in fmap)),
        **kw)
    tex.exact_gn(pose, feats, fmap, cluster=cluster, **kw)   # warm-up
    torch.cuda.synchronize()
    before = tex.exact_gn.launches
    got, syncs = _syncs_of(lambda: tex.exact_gn(pose, feats, fmap,
                                                cluster=cluster, **kw))
    assert tex.exact_gn.launches == before + 1 and syncs == 0
    again = tex.exact_gn(pose, feats, fmap, cluster=cluster, **kw)
    assert torch.equal(again, got)
    return got.cpu(), want.cpu(), cpu


def _exact_agrees(got, want, cpu, pose_tol=1e-4, deg_tol=1e-3):
    """The kernel against the plain loop on the card: iterations, n_corr,
    converged, is_degenerate and the gate equal on every lane where the
    plain loop's card and CPU runs agree on them (a correspondence at a
    gate or a neighbour at a near-tie can go either way on float32
    rounding; the plain loop's own runs show where); pose within pose_tol
    (chip_smoke.py's EXACT_TOL, set from the card's readings: the fits'
    arithmetic is not the plain loop's, and a correspondence at a gate
    going the other way moved lane 0 of the 16384-slot dense map by
    2.73e-5 on an H100; deg_tol on a degenerate lane, whose projector
    comes from the Jacobi's frame where the plain loop has eigh's), or
    within twice the plain loop's own card-vs-CPU spread where that is
    larger (as chip_smoke.py's rounds probes hold rounds_gn)."""
    assert torch.equal(got[:, 11:], torch.zeros_like(got[:, 11:]))
    plain_same = (want[:, 6:11] == cpu[:, 6:11]).all(1)
    same = (got[:, 6:11] == want[:, 6:11]).all(1)
    assert bool((same | ~plain_same).all()), (got[:, 6:11], want[:, 6:11],
                                              cpu[:, 6:11])
    spread = float((want[:, :6] - cpu[:, :6]).abs().max(1).values[
        same & plain_same].max()) if bool((same & plain_same).any()) else 0.0
    d = (got[:, :6] - want[:, :6]).abs().max(1).values
    tol = torch.where(want[:, 8] > 0, max(deg_tol, 2 * spread),
                      max(pose_tol, 2 * spread))
    print(f"exact_gn vs plain loop: pose |diff| {d.tolist()}, the plain "
          f"loop card vs CPU {spread:.3e}, iterations {want[:, 6].tolist()},"
          f" n_corr {want[:, 10].tolist()}, lanes equal {same.tolist()}")
    assert bool((d[same] <= tol[same]).all()), d


@pytest.mark.cuda
@pytest.mark.parametrize("maps", ["shared", "per_lane", "few_live"])
def test_exact_gn_kernel_matches_plain_loop(cuda, maps):
    """tests/exact_scenes.py's five lanes (two plain, a gated-off lane,
    one with too few correspondences, one with interleaved dead features)
    as one batch on a shared map, on one map a lane (slots rolled), and
    on a map with 3 live corner points (every corner feature meets
    no-neighbour slots): one launch, no host sync, two launches bitwise,
    against the plain loop on the card."""
    sc = es.scene()
    if maps == "few_live":
        sc = es.few_live_map(sc)
    got, want, cpu = _exact_pair(cuda, *es.batch(
        sc, range(5), cuda, per_lane_maps=maps == "per_lane"))
    _exact_agrees(got, want, cpu)
    assert want[:, 9].tolist() == [1, 1, 0, 1, 1]
    assert want[2, 6] == 0 and torch.equal(got[2, :6], want[2, :6])


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_exact_gn_kernel_at_every_cluster_size(cuda, cluster):
    _exact_agrees(*_exact_pair(cuda, *es.batch(es.scene(), range(5), cuda),
                               cluster=cluster))


@pytest.mark.cuda
def test_exact_gn_kernel_on_a_map_larger_than_shared_memory(cuda):
    """Lanes 0 and 1 on a fully live 16384-slot surf map (256 KB of
    staged points: the map streams through the tile)."""
    sc = es.scene()
    sx, sm = es.dense_surf_map(16384)
    got, want, cpu = _exact_pair(cuda, *es.batch(
        dict(sc, smap=sx, smask=sm), [0, 1], cuda))
    _exact_agrees(got, want, cpu)
    assert (want[:, 10] > 300).all()


@pytest.mark.cuda
def test_exact_gn_first_neighbours_are_the_knn(cuda):
    """The kernel's first-iteration neighbours (its diagnostic output)
    against ops/knn.py::knn at the guesses (exact_scenes.first_nn_agreement:
    exact ties, four repeated surf points, to the lower index; no-neighbour
    slots exactly where knn's d2 is 3e38, on the map with 3 live corner
    points), bit for bit: the kernel sums the centroid in the order of
    ATen's CUDA mean, so every d2 is knn's and no index swaps."""
    for sc in (es.scene(), es.few_live_map(es.scene())):
        feats, fmap, pose = es.batch(sc, range(5), cuda)
        B, P = pose.shape[0], es.PC + es.PS
        nn = (torch.full((B, P, 5), -2, dtype=torch.int32, device=cuda),
              torch.zeros(B, P, 5, device=cuda))
        stat = torch.empty(B, 16, device=cuda)
        kernels.launch_exact_gn(
            pose, feats, fmap, stat, iters=1, min_corr=50, eig_thresh=100.0,
            edge_min_valid=10, surf_min_valid=100, conv_rot_deg=0.05,
            conv_trans_cm=0.05, nn=nn)
        got = es.first_nn_agreement(pose, feats, fmap, nn,
                                    stat[:, 9].cpu().numpy() > 0, es.CHUNK)
        print(f"exact_gn first neighbours: {got}")
        assert got["ok"] and got["slots"] > 5000
        # the centroid in ATen's order: every d2 bit for bit knn's
        assert got["swaps"] == 0 and got["d2_err"] == 0.0
