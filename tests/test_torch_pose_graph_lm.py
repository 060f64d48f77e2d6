"""The pose-graph LM's plain version and the live set the kernel solves
over (graph/pose_graph.py), on the CPU.

On CUDA tensors `optimize_pose_graph` solves over the live poses alone
(active, or an endpoint of an unmasked factor), compacted by `live_set`;
the kernel itself runs only on a GPU (tests/test_torch_kernels_cuda.py).
Here, with the JAX graphs of tests/test_graph.py at
tests/test_torch_slam.py's full-graph shape (one JAX compile serves the
file):

  * the plain version run on the compacted live subgraph, scattered back,
    equals JAX's solve over all K poses within 1e-4 (LAPACK's float32
    Cholesky against XLA's, as tests/test_torch_slam.py) and the port's
    plain solve over all K within 1e-6 (the same arithmetic on a smaller
    matrix: the non-live rows add exact zeros), cost within 1e-6
    relative (1e-6 absolute: a converged chain's ~1e-8 is noise); on a
    graph whose unmasked factor couples an inactive pose, that pose is
    live, stays where it is, and leaving it out moves the solution past
    the bound;
  * `live_set` round trip: the live rows map back to their poses, the
    factors' remapped endpoints to the original indices;
  * `optimize_pose_graph_reference`, whose loop body calls
    `_lm_solve_step`, is bitwise the loop body it was taken from (kept
    here);
  * the dispatch: CPU tensors run the plain versions, another device
    raises, as do route A's launch past its cap and a graph of the wrong
    dtype;
  * route A's envelope (csrc/pose_graph_lm.cu) on tests/pose_graph_scenes.py's
    graphs: `envelope_starts` equals a brute-force walk over the factors;
    the live subgraph's dense H (`_assemble`) and the float32 Cholesky
    factor of its scaled, damped matrix are exactly 0.0 outside the
    envelope and the envelope is no wider than H; the kernel's envelope
    factorization with the forward solve inside and its backward solve,
    transcribed in numpy column by column (each entry's operations in the
    order that both the kernel's warp block steps and its CTA column
    steps keep), are bit for bit the dense right-looking factorization and
    the column-oriented solves of the kernel they replaced; where H is not
    finite, the dense update carries NaN outside the envelope and both
    fail.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from feature_base_pointcloud_registration_tpu.graph import (
    pose_graph as jpg)
from feature_base_pointcloud_registration_tpu_torch import kernels
from feature_base_pointcloud_registration_tpu_torch.graph import (
    pose_graph as tpg)
from test_graph import _rel_pose
from test_torch_batch import one_torch_thread  # noqa: F401
from test_torch_slam import FULL_ITERATIONS, _chain, _port_graph

import pose_graph_scenes as pgs


def _graph(kind):
    """tests/test_torch_slam.py's chain, GPS and loop graphs; "coupled": the
    chain with one more between factor, pose 10 to the inactive slot 25
    (pinned: its step is 0), 0.2 m off the chain's own estimate of pose
    10."""
    g, gt, K_active = _chain(noise=0.05 if kind == "loop" else
                             0.0 if kind == "gps" else 0.02,
                             loop=kind == "loop")
    if kind == "gps":
        btw_meas = np.array(g.btw_meas)
        btw_meas[:K_active - 1, 3] *= 1.05
        gps_idx = np.zeros(256, np.int32)
        gps_meas = np.zeros((256, 3), np.float32)
        gps_mask = np.zeros(256, bool)
        for n, k in enumerate([3, 6, 9, 12, 15, 19]):
            gps_idx[n], gps_meas[n], gps_mask[n] = k, gt[k, 3:], True
        g = g._replace(btw_meas=jnp.asarray(btw_meas),
                       gps_idx=jnp.asarray(gps_idx),
                       gps_meas=jnp.asarray(gps_meas),
                       gps_sigma=jnp.full((256, 3), 0.01, jnp.float32),
                       gps_mask=jnp.asarray(gps_mask))
    if kind == "coupled":
        poses = np.array(g.poses)
        poses[25] = [0.1, -0.05, 1.2, 4.0, 3.0, 0.5]
        off = gt[10] + np.array([0, 0, 0, 0.2, -0.1, 0.0], np.float32)
        f = K_active - 1
        g = g._replace(
            poses=jnp.asarray(poses),
            btw_i=g.btw_i.at[f].set(10), btw_j=g.btw_j.at[f].set(25),
            btw_meas=g.btw_meas.at[f].set(_rel_pose(off, poses[25])),
            btw_mask=g.btw_mask.at[f].set(True))
    return g


def _scattered(tg, ls, sub_poses):
    out = tg.poses.clone()
    out[ls.idx] = sub_poses
    return out


@pytest.mark.parametrize("kind", ["chain", "gps", "loop", "coupled"])
def test_live_subgraph_solve_matches_jax(kind):
    g = _graph(kind)
    jp, jc = map(np.asarray, jpg.optimize_pose_graph(g, FULL_ITERATIONS))
    tg = _port_graph(g)
    full_p, full_c = tpg.optimize_pose_graph_reference(tg, FULL_ITERATIONS)
    ls = tpg.live_set(tg)
    sub_p, sub_c = tpg.optimize_pose_graph_reference(
        tpg.live_subgraph(tg, ls), FULL_ITERATIONS)
    got = _scattered(tg, ls, sub_p).numpy()
    np.testing.assert_allclose(got, jp, atol=1e-4, rtol=0)
    np.testing.assert_allclose(got, full_p.numpy(), atol=1e-6, rtol=0)
    # a converged chain's cost (~1e-8) is rounding noise: abs 1e-6
    assert float(sub_c) == pytest.approx(float(full_c), rel=1e-6, abs=1e-6)
    assert float(sub_c) == pytest.approx(float(jc), rel=1e-4, abs=1e-6)
    assert ls.n == (21 if kind == "coupled" else 20)
    if kind != "coupled":
        return
    # pose 25: live, inactive, pinned
    assert int(ls.rowmap[25]) == 20 and not bool(tg.pose_mask[25])
    np.testing.assert_array_equal(got[25], np.asarray(g.poses)[25])
    # without it (its factor masked: the graph without that pose) the
    # active poses' solution moves past the bound
    f = 19
    cut = tg._replace(btw_mask=tg.btw_mask.clone().index_fill_(
        0, torch.tensor([f]), False))
    ls_cut = tpg.live_set(cut)
    assert ls_cut.n == 20 and int(ls_cut.rowmap[25]) == -1
    cut_p, _ = tpg.optimize_pose_graph_reference(
        tpg.live_subgraph(cut, ls_cut), FULL_ITERATIONS)
    assert np.abs(_scattered(cut, ls_cut, cut_p).numpy() - jp).max() > 1e-2


def _random_graph(seed, K=40, Fp=2, Fb=24, Fg=6):
    """Active poses and factors scattered over their slots; masked factor
    slots index pose 0 or garbage, as the SLAM graph's do."""
    r = np.random.RandomState(seed)
    g = tpg.PoseGraphData.empty(K, Fp, Fb, Fg, device="cpu")

    def idx(n):
        return torch.from_numpy(r.randint(0, K, n).astype(np.int32))

    def mask(n, p):
        return torch.from_numpy(r.uniform(size=n) < p)

    return g._replace(
        poses=torch.from_numpy(r.normal(size=(K, 6)).astype(np.float32)),
        pose_mask=mask(K, 0.3), prior_idx=idx(Fp), prior_mask=mask(Fp, 0.5),
        btw_i=idx(Fb), btw_j=idx(Fb), btw_mask=mask(Fb, 0.4),
        gps_idx=idx(Fg), gps_mask=mask(Fg, 0.5),
        btw_meas=torch.from_numpy(r.normal(size=(Fb, 6)).astype(np.float32)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_live_set_round_trip(seed):
    g = _random_graph(seed)
    ls = tpg.live_set(g)
    K = g.poses.shape[0]
    live = g.pose_mask.clone()
    for idx, m in ((g.prior_idx, g.prior_mask), (g.btw_i, g.btw_mask),
                   (g.btw_j, g.btw_mask), (g.gps_idx, g.gps_mask)):
        live[idx[m].long()] = True
    want = torch.nonzero(live)[:, 0]
    assert ls.n == len(want) and torch.equal(ls.idx, want)
    assert ls.idx.dtype == torch.int64 and ls.rowmap.dtype == torch.int32
    assert torch.equal(ls.rowmap[ls.idx], torch.arange(ls.n,
                                                       dtype=torch.int32))
    assert bool((ls.rowmap[~live] == -1).all())
    sub = tpg.live_subgraph(g, ls)
    assert torch.equal(sub.poses, g.poses[want])
    assert torch.equal(sub.pose_mask, g.pose_mask[want])
    for name_idx, name_mask in (("prior_idx", "prior_mask"),
                                ("btw_i", "btw_mask"), ("btw_j", "btw_mask"),
                                ("gps_idx", "gps_mask")):
        m = getattr(g, name_mask)
        rows = getattr(sub, name_idx)
        assert rows.dtype == torch.int32
        assert torch.equal(ls.idx[rows[m].long()],
                           getattr(g, name_idx)[m].long())
        assert bool((rows[~m] == 0).all())
    for name in g._fields:
        if name.endswith(("meas", "sigma", "mask")) and name != "pose_mask":
            assert torch.equal(getattr(sub, name), getattr(g, name))
    # the plain solve on it, scattered back, leaves the non-live poses
    sub_p, _ = tpg.optimize_pose_graph_reference(sub, 3)
    out = _scattered(g, ls, sub_p)
    assert torch.equal(out[~live], g.poses[~live])


def _parent_loop(g, iterations):
    """graph/pose_graph.py's loop before `_lm_solve_step` was taken out."""
    K = g.poses.shape[0]
    active = g.pose_mask.repeat_interleave(6)
    pin = torch.where(active, 0.0, 1.0)
    poses = g.poses
    cost = tpg._total_cost(g, poses)
    lam = torch.tensor(1e-4, dtype=torch.float32)
    for _ in range(iterations):
        H, grad, _ = tpg._assemble(g, poses, K)
        d = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-12)) + pin
        A = H / (d[:, None] * d[None, :]) + torch.diag(lam + pin)
        L, info = torch.linalg.cholesky_ex(A)
        dy = torch.cholesky_solve((-grad / d)[:, None], L)[:, 0]
        dx = torch.where(active, dy / d, 0.0)
        new_poses = poses + dx.reshape(K, 6)
        new_cost = tpg._total_cost(g, new_poses)
        accept = (info == 0) & (new_cost < cost)
        poses = torch.where(accept, new_poses, poses)
        cost = torch.where(accept, new_cost, cost)
        lam = torch.where(accept, torch.clamp(lam * 0.3, min=1e-6),
                          torch.clamp(lam * 4.0, max=1e6))
    return poses, cost


@pytest.mark.parametrize("kind", ["chain", "gps", "loop"])
def test_plain_loop_is_the_parent_loop_bitwise(kind):
    tg = _port_graph(_graph(kind))
    accepts = []
    got = tpg.optimize_pose_graph_reference(tg, FULL_ITERATIONS, accepts)
    want = _parent_loop(tg, FULL_ITERATIONS)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert len(accepts) == FULL_ITERATIONS and any(map(bool, accepts))
    # the dispatch on CPU tensors: the plain version, the same bits
    disp = tpg.optimize_pose_graph(tg, FULL_ITERATIONS)
    assert torch.equal(disp[0], want[0]) and torch.equal(disp[1], want[1])
    for a, b in zip(tpg.graph_factor_blocks(tg, tg.poses),
                    tpg.graph_factor_blocks_reference(tg, tg.poses)):
        for x, y in zip(a, b):
            assert torch.equal(x, y)


def test_dispatch_rejects_what_it_cannot_run():
    tg = _port_graph(_graph("chain"))
    meta = tpg.PoseGraphData(*(t.to("meta") for t in tg))
    with pytest.raises(ValueError, match="unsupported device"):
        tpg.optimize_pose_graph(meta, 2)
    with pytest.raises(ValueError, match="unsupported device"):
        tpg.graph_factor_blocks(meta, meta.poses)
    with pytest.raises(ValueError, match="btw_i"):
        tpg.optimize_pose_graph(tg._replace(btw_i=tg.btw_i.long()), 2)
    with pytest.raises(ValueError, match="poses"):
        tpg.graph_factor_blocks(tg, tg.poses[:4])
    ls = tpg.live_set(tg)
    cap = kernels.POSE_GRAPH_LM_MAX_LIVE
    with pytest.raises(ValueError, match="route A"):
        kernels.launch_pose_graph_lm(tg, ls._replace(n=cap + 1), 2, None,
                                     None, None)


# ------------------------------------------------- route A's envelope

ENVELOPE_GRAPHS = {
    "chain": lambda: pgs.chain("window")[0],
    "gps": lambda: pgs.chain("window", gps=True, noise=0.0)[0],
    "loop": lambda: pgs.chain("window", loop=True, noise=0.05)[0],
    "big_chain": lambda: pgs.big_chain(81)[0],
    "loops": lambda: pgs.loops(24, [(23, 0), (15, 3), (20, 8)],
                               inactive=(7,))[0],
    "star": lambda: pgs.star(kernels.POSE_GRAPH_LM_MAX_LIVE)[0],
}


def _brute_envelope(g, ls):
    """Each live pose's lowest coupled live pose, factor by factor."""
    rowmap = ls.rowmap.tolist()
    fb = list(range(ls.n))
    for s in range(g.btw_i.shape[0]):
        if bool(g.btw_mask[s]):
            i, j = rowmap[int(g.btw_i[s])], rowmap[int(g.btw_j[s])]
            fb[max(i, j)] = min(fb[max(i, j)], i, j)
    return fb


def _inside(fb):
    """[D, D] bool: the lower triangle's entries inside the envelope."""
    D = 6 * len(fb)
    i = np.arange(D)[:, None]
    j = np.arange(D)[None, :]
    return (j <= i) & (j >= 6 * np.asarray(fb)[i // 6])


def _scaled(g, lam=1e-4):
    """The live subgraph's scaled, damped matrix and right-hand side of the
    first LM step (`_lm_solve_step`'s), float32 numpy, and its envelope."""
    ls = tpg.live_set(g)
    sub = tpg.live_subgraph(g, ls)
    H, grad, _ = tpg._assemble(sub, sub.poses, ls.n)
    pin = torch.where(sub.pose_mask.repeat_interleave(6), 0.0, 1.0)
    d = torch.sqrt(torch.clamp(torch.diagonal(H), min=1e-12)) + pin
    A = H / (d[:, None] * d[None, :]) + torch.diag(lam + pin)
    return (H.numpy(), A.numpy(), (-grad / d).numpy(),
            tpg.envelope_starts(g, ls).tolist())


@pytest.mark.parametrize("kind", [*ENVELOPE_GRAPHS, "random0", "random1",
                                  "random2"])
def test_envelope_starts_match_brute_force(kind):
    g = (_random_graph(int(kind[-1])) if kind.startswith("random")
         else ENVELOPE_GRAPHS[kind]())
    ls = tpg.live_set(g)
    got = tpg.envelope_starts(g, ls)
    assert got.dtype == torch.int32 and got.shape == (ls.n,)
    assert got.tolist() == _brute_envelope(g, ls)


@pytest.mark.parametrize("kind", list(ENVELOPE_GRAPHS))
def test_envelope_holds_h_and_its_factor(kind):
    H, A, _, fb = _scaled(ENVELOPE_GRAPHS[kind]())
    inside = _inside(fb)
    lower = np.tril(np.ones_like(inside))
    assert np.all(np.isfinite(H))
    assert np.all(H[lower & ~inside] == 0.0)
    L = torch.linalg.cholesky(torch.from_numpy(A)).numpy()
    assert np.all(L[lower & ~inside] == 0.0)
    # no wider than H: each block row's first block holds a nonzero
    for x, y in enumerate(fb):
        assert np.any(H[6 * x:6 * x + 6, 6 * y:6 * y + 6] != 0.0)


def _dense_factor(A, b):
    """The dense right-looking float32 Cholesky (one column a step) and the
    column-oriented solves that route A ran before its envelope, entry by
    entry: (A with L in its lower triangle, x, failed)."""
    A, b = A.copy(), b.copy()
    D = len(A)
    for k in range(D):
        p = A[k, k]
        if not p > 0:
            return A, None, True
        l = np.sqrt(p)
        A[k + 1:, k] = A[k + 1:, k] / l
        A[k, k] = l
        c = A[k + 1:, k].copy()
        for i in range(k + 1, D):
            A[i, k + 1:i + 1] = A[i, k + 1:i + 1] - c[i - k - 1] * c[:i - k]
    for k in range(D):
        y = b[k] / A[k, k]
        b[k] = y
        b[k + 1:] = b[k + 1:] - A[k + 1:, k] * y
    for k in range(D - 1, -1, -1):
        x = b[k] / A[k, k]
        b[k] = x
        b[:k] = b[:k] - A[k, :k] * x
    return A, b, False


def _envelope_factor(A, b, fb):
    """csrc/pose_graph_lm.cu's envelope_cholesky (the forward solve inside)
    and backward_solve_warp, transcribed: column k of block q updates the
    rows below it in block q and the rows of the blocks p > q with fb[p]
    <= q.  (A, x, failed)."""
    A, b = A.copy(), b.copy()
    n = len(fb)
    for q in range(n):
        rl = [6 * p + i for p in range(q + 1, n) if fb[p] <= q
              for i in range(6)]
        for a6 in range(6):
            k = 6 * q + a6
            rows = np.array(list(range(k + 1, 6 * q + 6)) + rl, dtype=int)
            p = A[k, k]
            if not p > 0:
                return A, None, True
            l = np.sqrt(p)
            y = b[k] / l
            col = A[rows, k] / l
            A[rows, k] = col
            A[k, k] = l
            b[k] = y
            b[rows] = b[rows] - col * y
            for u in range(len(rows)):
                A[rows[u], rows[:u + 1]] = (A[rows[u], rows[:u + 1]]
                                            - col[u] * col[:u + 1])
    for k in range(6 * n - 1, -1, -1):
        x = b[k] / A[k, k]
        b[k] = x
        lo = 6 * fb[k // 6]
        b[lo:k] = b[lo:k] - A[k, lo:k] * x
    return A, b, False


@pytest.mark.parametrize("kind", ["chain", "gps", "loop", "loops", "star"])
def test_envelope_factor_is_the_dense_one_bitwise(kind):
    _, A, b, fb = _scaled(ENVELOPE_GRAPHS[kind]())
    Ad, xd, fd = _dense_factor(A, b)
    Ae, xe, fe = _envelope_factor(A, b, fb)
    assert not fd and not fe
    inside = _inside(fb)
    lower = np.tril(np.ones_like(inside))
    np.testing.assert_array_equal(Ae[inside], Ad[inside])
    assert np.all(Ad[lower & ~inside] == 0.0)
    np.testing.assert_array_equal(xe, xd)
    assert np.all(np.isfinite(xe))


@pytest.mark.parametrize("which", ["gimbal", "gimbal_loop"])
def test_envelope_factor_fails_as_the_dense_one(which):
    """H not finite: the dense update carries NaN (0 x inf) left of the
    later rows' envelope; the envelope factorization fails as the dense
    one does (every step of the LM rejected, in the GPU tests)."""
    g = pgs.gimbal() if which == "gimbal" else pgs.gimbal_loop()
    H, A, b, fb = _scaled(g)
    assert not np.all(np.isfinite(H))
    with np.errstate(all="ignore"):
        Ad, _, fd = _dense_factor(A, b)
        _, _, fe = _envelope_factor(A, b, fb)
    assert fd and fe
    outside = np.tril(np.ones_like(_inside(fb))) & ~_inside(fb)
    assert np.any(np.isnan(Ad[outside]))

