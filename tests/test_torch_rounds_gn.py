"""Port parity: one round of the rounds solver's GN iterations
(`ops/rounds_gn.py`) and `register_rounds_core` through it.

On the CPU `rounds_gn` runs its plain version `rounds_gn_reference`, the
port's loop body on the kernel's packed layout.  It is held against the
JAX package's `register_rounds_core(num_rounds=1)` fed the same
candidates through constant fetch closures, on tests/rounds_scenes.py's
six lanes (two plain lanes, a gated-off lane, a lane under min_corr, the
degenerate tiny problem, sentinel picks near the world origin: FAR
coordinates in JAX, zeros in the port, d2 3e38 in both), at K 8 without
and K 16 with the min_plane_spread gate.  Tolerance: the rounds core's,
pose within 1e-5 (m / rad), iterations, n_corr and the flags equal.  The
degenerate lane is the one exception: its update rests on the
eigenvectors of a near-degenerate JtJ, which float32 rounding turns
(ROADMAP Queue 3), so its flags, iterations and n_corr are equal and its
pose within 1e-3 (printed).  The JAX solve is compiled once for each of
the two configurations.

Then `register_rounds_core` with three rounds through the wrapper is held
bitwise to the host-driven loop it replaced (kept below), and the wrapper's
argument checks.  The CUDA kernel against this plain version is
tests/test_torch_kernels_cuda.py.

Last, the kernel's launch shape, which is host arithmetic: the cluster
size rule `kernels.rounds_gn_cluster` (CTAs a lane from B, Pc + Ps, the
SM count and K alone) at B 1, 3 and 256, K 8 and 16, at the wave's edge,
at tiny point counts and under an occupancy limit; and the refusal of a
cluster size that is not a power of two up to 16, on the CPU too.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import rounds_scenes as rs
from feature_base_pointcloud_registration_tpu.ops.register import (
    register_rounds_core as jrounds)
from feature_base_pointcloud_registration_tpu.pipeline.cloud_info import (
    ScanFeatures as JScanFeatures)
from feature_base_pointcloud_registration_tpu_torch import kernels
from feature_base_pointcloud_registration_tpu_torch.ops import (
    register as treg)
from feature_base_pointcloud_registration_tpu_torch.ops.rounds_gn import (
    rounds_gn, rounds_gn_reference)
from feature_base_pointcloud_registration_tpu_torch.pipeline.cloud_info import (  # noqa: E501
    ScanFeatures)
from test_torch_batch import one_torch_thread  # noqa: F401

ITERS = 8
DEGENERATE = 4                  # rounds_scenes.edge_lanes' tiny-problem lane
CONFIGS = [(8, 0.0), (16, 0.05)]


@pytest.fixture(scope="module")
def jax_results():
    """{(K, spread): (lanes, JAX RegisterResult fields as numpy)}."""
    out = {}
    for K, spread in CONFIGS:
        lanes = rs.edge_lanes(K)

        def solve(fc, cm, fs, sm, cd, cnn, sd, snn, guess, spread=spread):
            return jrounds(JScanFeatures(fc, cm, fs, sm),
                           lambda w: (cd, cnn), lambda w: (sd, snn), guess,
                           num_rounds=1, iters_per_round=ITERS,
                           min_plane_spread=spread)

        def far(nn, sent):
            return np.where(sent[..., None], rs.FAR, nn)

        args = [np.stack([f(lane) for lane in lanes]) for f in (
            lambda l: l["fc"], lambda l: l["cm"], lambda l: l["fs"],
            lambda l: l["sm"], lambda l: l["cd"],
            lambda l: far(l["cnn"], l["c_sent"]), lambda l: l["sd"],
            lambda l: far(l["snn"], l["s_sent"]), lambda l: l["guess"])]
        res = jax.jit(jax.vmap(solve))(*(jnp.asarray(a) for a in args))
        out[K, spread] = lanes, {k: np.asarray(v)
                                 for k, v in res._asdict().items()}
    return out


@pytest.mark.parametrize("K,spread", CONFIGS)
def test_reference_matches_jax_rounds_core(jax_results, K, spread):
    lanes, want = jax_results[K, spread]
    args = rs.packed(lanes, K)
    stat, matP = rounds_gn(*args, K=K, iters=ITERS, min_plane_spread=spread)
    got = stat.numpy()
    print(f"K={K} spread={spread}: iterations {got[:, 6].tolist()} n_corr "
          f"{got[:, 10].tolist()} degenerate {got[:, 8].tolist()}; pose "
          f"|diff| by lane {np.abs(got[:, :6] - want['pose6']).max(1)}")
    assert want["valid"].tolist() == [True, True, False, True, True, True]
    assert (want["n_corr"][[0, 1, 5]] >= 50).all()
    assert 0 < want["n_corr"][3] < 50 and want["is_degenerate"][DEGENERATE]
    np.testing.assert_array_equal(got[:, 6], want["iterations"])
    np.testing.assert_array_equal(got[:, 10], want["n_corr"])
    np.testing.assert_array_equal(got[:, 7] > 0, want["converged"])
    np.testing.assert_array_equal(got[:, 8] > 0, want["is_degenerate"])
    plain = np.arange(len(lanes)) != DEGENERATE
    np.testing.assert_allclose(got[plain, :6], want["pose6"][plain],
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[DEGENERATE, :6],
                               want["pose6"][DEGENERATE], rtol=0, atol=1e-3)
    # the gated-off lane is left bitwise untouched
    assert torch.equal(stat[2], args[0][2]) and torch.equal(matP[2],
                                                             args[1][2])


def test_sentinel_picks_carry_nothing():
    """Sentinel picks near the origin: zero coordinates within 1 m of the
    feature, rejected by their d2 alone (the same round with the picks at
    FAR gives the bitwise same result)."""
    K = 8
    lanes = rs.edge_lanes(K)[5:]
    args = rs.packed(lanes, K)
    far = list(args)
    for i, sent in ((4, "c_sent"), (5, "s_sent")):
        s = torch.from_numpy(np.ascontiguousarray(
            np.stack([lane[sent] for lane in lanes]).transpose(2, 0, 1)
            .reshape(K, -1)))
        far[i] = torch.where(s.repeat(3, 1), float(rs.FAR),
                           args[i]).contiguous()
    got = rounds_gn_reference(*args, K=K, iters=ITERS)
    got_far = rounds_gn_reference(*far, K=K, iters=ITERS)
    assert got[0][0, 10] >= 50
    assert torch.equal(got[0], got_far[0]) and torch.equal(got[1],
                                                           got_far[1])


def _old_rounds_core(features, corner_fetch, surf_fetch, init_pose6, *,
                     num_rounds, iters_per_round, min_correspondences=50,
                     eigen_threshold=100.0, edge_min_valid=10,
                     surf_min_valid=100, converge_rot_deg=0.05,
                     converge_trans_cm=0.05, min_plane_spread=0.0):
    """`register_rounds_core` as the port ran it before the round kernel:
    every round's iterations a host-driven loop."""
    B, Pc, _ = features.corner_xyz.shape
    Ps = features.surf_xyz.shape[1]
    dev = features.corner_xyz.device
    gate, state = treg._initial(features, init_pose6, edge_min_valid,
                                surf_min_valid)
    false = state.converged
    it = torch.zeros(B, dtype=torch.int32, device=dev)
    pts_all = torch.cat([features.corner_xyz, features.surf_xyz], dim=1)
    cmask = features.corner_mask.reshape(B * Pc)
    smask = features.surf_mask.reshape(B * Ps)
    for _ in range(num_rounds):
        state = state._replace(converged=false)
        cd, cnn = corner_fetch(treg._to_world(state.pose6,
                                              features.corner_xyz))
        sd, snn = surf_fetch(treg._to_world(state.pose6, features.surf_xyz))
        ccv, scv = cd < 1e37, sd < 1e37
        done = torch.zeros(B, dtype=torch.int32, device=dev)
        for _ in range(iters_per_round):
            active = gate & ~state.converged
            if not bool(active.any()):
                break
            c_coeff, c_resid, c_mask = treg.corner_correspondence_cand(
                treg._to_world(state.pose6, features.corner_xyz), cmask, cnn,
                ccv)
            s_coeff, s_resid, s_mask = treg.surf_correspondence_cand(
                treg._to_world(state.pose6, features.surf_xyz), smask, snn,
                scv, min_plane_spread=min_plane_spread)
            new = treg.gn_step(
                state, pts_all,
                torch.cat([c_coeff.view(B, Pc, 3), s_coeff.view(B, Ps, 3)],
                          1),
                torch.cat([c_resid.view(B, Pc), s_resid.view(B, Ps)], 1),
                torch.cat([c_mask.view(B, Pc), s_mask.view(B, Ps)], 1),
                it + done, min_correspondences=min_correspondences,
                eigen_threshold=eigen_threshold,
                converge_rot_deg=converge_rot_deg,
                converge_trans_cm=converge_trans_cm)
            state = treg._freeze(active, new, state)
            done = done + active.to(torch.int32)
        it = it + done
    return treg.RegisterResult(pose6=state.pose6, converged=state.converged,
                               iterations=it, n_corr=state.n_corr,
                               is_degenerate=state.is_degenerate, valid=gate)


def _knn_fetch(points, K):
    """Fetch closure: the exact K nearest of `points` [M, 3]; a pick farther
    than 1.5 m is a sentinel (d2 3e38, zero coordinates)."""
    def f(q):
        d2 = ((q[:, None, :] - points[None]) ** 2).sum(-1)
        d2, idx = torch.sort(d2, dim=1, stable=True)
        d2, idx = d2[:, :K], idx[:, :K]
        sent = d2 > 2.25
        return (torch.where(sent, 3.0e38, d2),
                torch.where(sent[..., None], 0.0, points[idx]))
    return f


@pytest.mark.parametrize("spread", [0.0, 0.05])
def test_rounds_core_bitwise_the_loop_it_replaced(spread):
    K = 8
    lanes = rs.edge_lanes(K)[:4]
    mc, ms = (torch.from_numpy(a) for a in rs.world_map())
    feats = ScanFeatures(*(torch.from_numpy(np.stack([lane[k] for lane in
                                                      lanes]))
                           for k in ("fc", "cm", "fs", "sm")))
    guess = torch.from_numpy(np.stack([lane["guess"] for lane in lanes]))
    kw = dict(num_rounds=3, iters_per_round=4, min_plane_spread=spread)
    want = _old_rounds_core(feats, _knn_fetch(mc, K), _knn_fetch(ms, K),
                            guess, **kw)
    got = treg.register_rounds_core(feats, _knn_fetch(mc, K),
                                    _knn_fetch(ms, K), guess, **kw)
    assert int(want.iterations.max()) > 4      # more than one round ran
    for name, w in want._asdict().items():
        g = getattr(got, name)
        assert g.dtype == w.dtype and torch.equal(g, w), name


def test_wrapper_rejects_bad_arguments():
    K = 8
    args = list(rs.packed(rs.edge_lanes(K)[:2], K))

    def call(a, k=K):
        return rounds_gn(*a, K=k, iters=2)

    def swap(i, t):
        return [t if j == i else a for j, a in enumerate(args)]

    with pytest.raises(TypeError):
        call(swap(0, args[0].double()))
    with pytest.raises(TypeError):
        call(swap(6, args[6].half()))
    with pytest.raises(ValueError):
        call(swap(7, args[7][:, :-1].contiguous()))
    with pytest.raises(ValueError):
        call(swap(4, args[4][:-3].contiguous()))
    with pytest.raises(ValueError):       # K < 5: no 5-of-K selection
        call([*args[:4], args[4][:12].contiguous(), args[5][:12].contiguous(),
              args[6][:4].contiguous(), args[7][:4].contiguous()], k=4)
    with pytest.raises(ValueError):       # K that the layouts do not hold
        call(args, k=6)
    with pytest.raises(ValueError):
        call(swap(6, args[6].t().contiguous().t()))
    with pytest.raises(ValueError):
        call(swap(7, torch.empty_like(args[7], device="meta")))
    with pytest.raises(ValueError):
        call([torch.empty_like(a, device="meta") for a in args])


H100_SMS = 132
STEP_P = 2048 + 8192            # the localization step's feature caps
SHARE = kernels.ROUNDS_MIN_SHARE


def _pow2_floor(n):
    return 1 << (max(n, 1).bit_length() - 1)


@pytest.mark.parametrize("B,P,K,want", [
    # one lane (the step paths): as many CTAs as the points allow
    (1, STEP_P, 16, min(16, _pow2_floor(STEP_P // SHARE))),
    (1, STEP_P, 8, min(16, _pow2_floor(STEP_P // SHARE))),
    (3, STEP_P, 16, min(16, _pow2_floor(STEP_P // SHARE))),
    (3, STEP_P, 8, min(16, _pow2_floor(STEP_P // SHARE))),
    # the batched solve: a full wave of lanes already, one CTA a lane
    (256, STEP_P, 16, 1),
    (256, STEP_P, 8, 1),
    # the wave's edge: 132 SMs, one CTA an SM at K 16, two at K <= 8
    (9, 16 * SHARE, 16, 8),
    (8, 16 * SHARE, 16, 16),
    (66, 16 * SHARE, 8, 4),
    (67, 16 * SHARE, 8, 2),
    (133, 16 * SHARE, 16, 1),
    # tiny lanes: each CTA keeps at least SHARE points
    (1, 2 * SHARE - 1, 16, 1),
    (1, 2 * SHARE, 16, 2),
    (1, 5 * SHARE, 8, 4),
    (1, 64 * SHARE, 16, 16),
    (1, 1, 16, 1),
])
def test_cluster_rule(B, P, K, want):
    C = kernels.rounds_gn_cluster(B, P, H100_SMS, K)
    assert C == want
    kernels.check_cluster(C)
    assert B * C <= H100_SMS * (1 if K > 8 else 2) or C == 1


def test_cluster_rule_at_the_step_and_the_batch():
    """More than one CTA a lane on the step paths (B = 1 at the step's
    caps), one at the batched solve's B = 256."""
    assert kernels.rounds_gn_cluster(1, STEP_P, H100_SMS, 16) > 1
    assert kernels.rounds_gn_cluster(256, STEP_P, H100_SMS, 8) == 1


def test_cluster_rule_under_an_occupancy_limit():
    """Where fewer clusters of a size can be resident than there are
    lanes, the rule halves the size until B clusters fit."""
    resident = {16: 2, 8: 5, 4: 40}
    C = kernels.rounds_gn_cluster(3, 64 * SHARE, H100_SMS, 16,
                                  lambda c: resident.get(c, 1000))
    assert C == 8
    C = kernels.rounds_gn_cluster(6, 64 * SHARE, H100_SMS, 16,
                                  lambda c: resident.get(c, 1000))
    assert C == 4
    C = kernels.rounds_gn_cluster(2, 64 * SHARE, H100_SMS, 16,
                                  lambda c: resident.get(c, 1000))
    assert C == 16
    assert kernels.rounds_gn_cluster(1, 64 * SHARE, H100_SMS, 16,
                                     lambda c: 0) == 1


@pytest.mark.parametrize("cluster", [0, 3, 6, 12, 32, -2, 2.0, True, None])
def test_cluster_size_refused(cluster):
    with pytest.raises(ValueError):
        kernels.check_cluster(cluster)


@pytest.mark.parametrize("cluster", [3, 32])
def test_wrapper_refuses_cluster_size_on_cpu(cluster):
    K = 8
    args = rs.packed(rs.edge_lanes(K)[:2], K)
    with pytest.raises(ValueError):
        rounds_gn(*args, K=K, iters=2, cluster=cluster)


def test_wrapper_takes_cluster_size_on_cpu():
    """On CPU tensors a valid cluster size changes nothing: the plain
    version runs, bitwise the call without it."""
    K = 8
    args = rs.packed(rs.edge_lanes(K)[:2], K)
    want = rounds_gn(*args, K=K, iters=2)
    for cluster in (1, 2, 4, 8, 16):
        got = rounds_gn(*args, K=K, iters=2, cluster=cluster)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
