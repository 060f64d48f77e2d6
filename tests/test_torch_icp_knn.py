"""The plain versions of the streamed k-NN and of ICP against the JAX
package, and the device dispatch in front of their CUDA kernels.

`ops/knn.py::knn` and `ops/icp.py::icp_align` launch `csrc/knn_stream.cu`
and `csrc/icp.cu` on CUDA tensors (tests/test_torch_kernels_cuda.py holds
the kernels against these plain versions on a card) and run
`knn_reference` / `icp_align_reference` on CPU tensors.  Here, on the CPU,
on tests/icp_scenes.py's scenes:

  * `knn_reference` against JAX `knn`, with one map chunk (M == chunk) and
    with four: d2 within 1e-6 of the terms |q|^2 + |m|^2 - 2 q.m cancels
    (tests/test_torch_knn_register.py's tolerance), indices equal except at
    near-ties within it; the no-neighbour slots (d2 3e38) exactly: the
    lowest masked indices with one chunk in both packages; with more, index
    0 in the port and, in JAX, the index its argmin merge repeats (a live
    neighbour's, or 0; no caller weighs such a slot's point); duplicate map
    points' ties to the lower index; an all-masked map;
  * `icp_align_reference` against JAX `icp_align` on the SLAM-shaped padded
    room at small caps (256 source rows, 1024 target rows, chunk 256, 40 m
    out): transform within 2e-5 (five float32 ulps of the 40 m
    coordinates), converged equal, fitness within the k-NN's d2 tolerance
    averaged over the matches (`icp_scenes.fitness_tol`: the padding pulls
    knn's centre ~20 m from the points, and the fitness, ~1e-5 m^2 here, is
    mostly the rounding of their |q - c|^2), the iterations printed and
    within 2 of each other (the 1e-6 epsilon sits on float32 rounding);
    with no correspondence and with one: the transform I and (I, offset),
    bitwise in both;
  * the dispatch: on CPU tensors `knn` and `icp_align` are bitwise the
    parent's code (the loop of ICP kept here) and launch nothing; any other
    device raises, as do k outside 1..16, a bad shape or dtype and a map
    that is not a multiple of chunk (the checks in front of the kernels).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from feature_base_pointcloud_registration_tpu.ops import (
    icp as jicp, knn as jknn)
from feature_base_pointcloud_registration_tpu_torch.geom.se3 import (
    apply_transform, kabsch)
from feature_base_pointcloud_registration_tpu_torch.ops import (
    icp as ticp, knn as tknn)

import icp_scenes as scn

T = torch.from_numpy
M_MAP = 1024
BIG = np.float32(3.0e38)


def _d2_tol(q, ref, idx):
    """1e-6 of |q-c|^2 + |m-c|^2 per (query, neighbour), c the centroid."""
    c = q.astype(np.float64).mean(0)
    qn = ((q - c) ** 2).sum(-1)[:, None]
    mn = ((ref.astype(np.float64)[idx] - c) ** 2).sum(-1)
    return 1e-6 * (qn + mn)


@pytest.mark.parametrize("chunk", [M_MAP, M_MAP // 4])
@pytest.mark.parametrize("name,k", [("random", 5), ("random", 16),
                                    ("duplicates", 5), ("few_live", 5),
                                    ("all_masked", 1), ("all_masked", 5)])
def test_knn_reference_matches_jax(name, k, chunk):
    q, ref, mask = scn.knn_scene(name, M_MAP, chunk)
    d2_j, idx_j = map(np.asarray, jknn.knn(
        jnp.asarray(q), jnp.asarray(ref), jnp.asarray(mask), k=k,
        chunk=chunk))
    d2_t, idx_t = (a.numpy() for a in tknn.knn_reference(
        T(q), T(ref), T(mask), k=k, chunk=chunk))
    empty = d2_j >= BIG
    # the no-neighbour slots, exactly
    assert np.array_equal(d2_t >= BIG, empty)
    assert (d2_t[empty] == BIG).all()
    one = chunk == M_MAP
    if one:
        assert np.array_equal(idx_t[empty], idx_j[empty])
    else:
        # JAX's merge takes k argmin passes and sets each pick to 3e38: once
        # only 3e38 is left it picks the first candidate again, the running
        # best's first slot before the last merge (a live neighbour, or the
        # initial index 0)
        for i, j in np.argwhere(empty):
            assert idx_j[i, j] in set(idx_j[i][~empty[i]]) | {0}
    masked = np.nonzero(~mask)[0]
    n_live = int(mask.sum())
    for i in range(len(q)):
        slots = np.nonzero(empty[i])[0]
        want = masked[:len(slots)] if one else np.zeros(len(slots), int)
        assert len(slots) == max(0, k - n_live)
        assert np.array_equal(idx_t[i, slots], want)
    # live slots: d2 within the tolerance, swaps only at near-ties
    live = ~empty
    tol = _d2_tol(q, ref, idx_j)
    assert (np.abs(d2_t.astype(np.float64) - d2_j)[live] <= tol[live]).all()
    for i, j in np.argwhere((idx_t != idx_j) & live):
        exact = ((ref[idx_t[i, j]] - q[i]) ** 2).sum() - (
            (ref[idx_j[i, j]] - q[i]) ** 2).sum()
        assert abs(exact) <= 2 * tol[i, j], (i, j)
    assert mask[idx_t[live]].all()
    if name == "duplicates":
        assert idx_t[0, 0] == 4 and idx_j[0, 0] == 4
        assert list(idx_t[0, :5]) == [4, 5, 6, 7, 8]


def _parent_icp(src, src_mask, dst, dst_mask, *, max_corr_dist=100.0,
                max_iterations=100, transformation_epsilon=1e-6, chunk=2048):
    """The port's icp_align before the kernel, as it was."""
    max_d2 = max_corr_dist ** 2

    def matched(Tm):
        d2, idx = tknn.knn(apply_transform(Tm, src), dst, dst_mask, k=1,
                           chunk=chunk)
        d2 = d2[:, 0]
        w = (src_mask & (d2 < max_d2)).to(torch.float32)
        return d2, dst[idx[:, 0].long()], w

    Tm = torch.eye(4, dtype=torch.float32, device=src.device)
    delta = torch.tensor(1e9, dtype=torch.float32, device=src.device)
    it = 0
    while it < max_iterations and float(delta) > transformation_epsilon:
        _, nn_pts, w = matched(Tm)
        T_new = kabsch(src, nn_pts, weights=w)
        delta = (T_new - Tm).abs().max()
        Tm = T_new
        it += 1
    d2, _, w = matched(Tm)
    n_match = w.sum()
    fitness = (d2 * w).sum() / torch.clamp(n_match, min=1.0)
    return ticp.ICPResult(transform=Tm, fitness=fitness,
                          converged=n_match >= 3.0,
                          iterations=torch.tensor(it, dtype=torch.int32),
                          delta=delta)


@pytest.mark.parametrize("name", ["room", "far", "one_match"])
def test_icp_reference_matches_jax(name):
    src, sm, dst, dm, kw = scn.icp_scene(name)
    want = jax.tree.map(np.asarray, jicp.icp_align(
        *map(jnp.asarray, (src, sm, dst, dm)), **kw))
    got = ticp.icp_align_reference(*map(T, (src, sm, dst, dm)), **kw)
    print(f"icp {name}: iterations {int(got.iterations)} (JAX "
          f"{int(want.iterations)}), fitness {float(got.fitness):.6g}")
    np.testing.assert_allclose(got.transform.numpy(), want.transform,
                               atol=2e-5, rtol=0)
    assert bool(got.converged) == bool(want.converged)
    np.testing.assert_allclose(float(got.fitness), float(want.fitness),
                               atol=scn.fitness_tol(src, sm, want.transform),
                               rtol=0)
    assert abs(int(got.iterations) - int(want.iterations)) <= 2
    if name == "room":
        assert bool(got.converged) and float(got.fitness) < 0.3
    elif name == "far":
        # H = 0: R = I from the SVD, t = 0 from the empty centroids
        assert torch.equal(got.transform, torch.eye(4))
        assert np.array_equal(want.transform, np.eye(4, dtype=np.float32))
        assert not bool(got.converged) and int(got.iterations) == 1
    else:
        assert torch.equal(got.transform[:3, :3], torch.eye(3))
        assert np.array_equal(want.transform[:3, :3],
                              np.eye(3, dtype=np.float32))
        off = T(dst[0] - src[0])
        torch.testing.assert_close(got.transform[:3, 3], off, rtol=0,
                                   atol=1e-6)
        assert not bool(got.converged)


def test_knn_cpu_dispatch_is_the_plain_version():
    q, ref, mask = scn.knn_scene("duplicates", M_MAP, M_MAP // 4)
    before = tknn.knn.launches
    for k in (1, 5, 20):
        got = tknn.knn(T(q), T(ref), T(mask), k=k, chunk=M_MAP // 4)
        want = tknn.knn_reference(T(q), T(ref), T(mask), k=k,
                                  chunk=M_MAP // 4)
        assert all(map(torch.equal, got, want))
    batch = tknn.knn(T(np.stack([q, q[::-1].copy()])), T(ref), T(mask),
                     k=5, chunk=M_MAP // 4)
    assert torch.equal(batch[1][1], tknn.knn_reference(
        T(q[::-1].copy()), T(ref), T(mask), k=5, chunk=M_MAP // 4)[1])
    assert tknn.knn.launches == before


@pytest.mark.parametrize("name", ["room", "one_match"])
def test_icp_cpu_dispatch_is_the_parent_loop(name):
    src, sm, dst, dm, kw = scn.icp_scene(name)
    before = ticp.icp_align.launches
    got = ticp.icp_align(*map(T, (src, sm, dst, dm)), **kw)
    want = _parent_icp(*map(T, (src, sm, dst, dm)), **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert ticp.icp_align.launches == before


def _knn_args(**bad):
    q, ref, mask = scn.knn_scene("random", 512, 256, Q=16)
    args = dict(query=T(q), ref=T(ref), ref_mask=T(mask), k=5, chunk=256)
    args.update(bad)
    return args


KNN_REFUSED = {
    "k=0": dict(k=0), "k=17": dict(k=17), "k>chunk": dict(k=8, chunk=4),
    "M%chunk": dict(chunk=384),
    "query [Q, 2]": dict(query=torch.zeros(16, 2)),
    "ref [M]": dict(ref=torch.zeros(512)),
    "mask [M - 1]": dict(ref_mask=torch.ones(511, dtype=torch.bool)),
    "per-set map of another batch": dict(ref=torch.zeros(2, 512, 3),
                                         ref_mask=torch.ones(
                                             2, 512, dtype=torch.bool)),
    "float64 query": dict(query=torch.zeros(16, 3, dtype=torch.float64)),
    "uint8 mask": dict(ref_mask=torch.ones(512, dtype=torch.uint8)),
}


@pytest.mark.parametrize("case", sorted(KNN_REFUSED))
def test_knn_kernel_checks_refuse(case):
    with pytest.raises(ValueError):
        tknn.check_kernel_args(**_knn_args(**KNN_REFUSED[case]))


def test_knn_kernel_checks_take_the_callers_shapes():
    tknn.check_kernel_args(**_knn_args())
    tknn.check_kernel_args(**_knn_args(k=16))
    tknn.check_kernel_args(**_knn_args(
        query=torch.zeros(2, 16, 3), ref=torch.zeros(2, 512, 3),
        ref_mask=torch.ones(2, 512, dtype=torch.bool)))
    tknn.check_kernel_args(**_knn_args(query=torch.zeros(2, 16, 3)))


def _icp_args(**bad):
    src, sm, dst, dm, _ = scn.icp_scene("room")
    args = dict(src=T(src), src_mask=T(sm), dst=T(dst), dst_mask=T(dm),
                chunk=256, max_iterations=10)
    args.update(bad)
    return args


ICP_REFUSED = {
    "M%chunk": dict(chunk=384),
    "src [N, 2]": dict(src=torch.zeros(256, 2)),
    "src_mask [N + 1]": dict(src_mask=torch.ones(257, dtype=torch.bool)),
    "dst [M]": dict(dst=torch.zeros(1024)),
    "empty src": dict(src=torch.zeros(0, 3),
                      src_mask=torch.ones(0, dtype=torch.bool)),
    "float64 dst": dict(dst=torch.zeros(1024, 3, dtype=torch.float64)),
    "float mask": dict(dst_mask=torch.ones(1024)),
    "negative iterations": dict(max_iterations=-1),
}


@pytest.mark.parametrize("case", sorted(ICP_REFUSED))
def test_icp_kernel_checks_refuse(case):
    with pytest.raises(ValueError):
        ticp.check_kernel_args(**_icp_args(**ICP_REFUSED[case]))
    ticp.check_kernel_args(**_icp_args())


def test_other_devices_raise():
    meta = torch.device("meta")
    q, ref, mask = (torch.empty(s, device=meta, dtype=d) for s, d in (
        ((16, 3), torch.float32), ((512, 3), torch.float32),
        ((512,), torch.bool)))
    with pytest.raises(ValueError, match="unsupported device"):
        tknn.knn(q, ref, mask, k=5, chunk=256)
    with pytest.raises(ValueError, match="unsupported device"):
        ticp.icp_align(q, mask[:16], ref, mask, chunk=256)
    with pytest.raises(ValueError, match="not a multiple"):
        tknn.knn(*(T(a) for a in scn.knn_scene("random", 512, 256)),
                 chunk=384)
    with pytest.raises(ValueError, match="not a multiple"):
        src, sm, dst, dm, _ = scn.icp_scene("room")
        ticp.icp_align(*map(T, (src, sm, dst, dm)), chunk=384)
