"""Port parity: the sharded solvers on torch.distributed (gloo on the CPU).

The ranks are spawned by the port's own `parallel/dryrun.py::
dryrun_multichip` (the spawned children import the port, not these test
modules, which import JAX), each joining through a `FileStore` in a
temporary directory, and solve `dryrun.problem_1d` / `problem_2d`:

  * 2 and 4 processes on a 1-D ("data",) mesh: `shard_register`,
    `shard_register_tables(solver="blocks")` and (solver="fused", the
    kernels' plain versions on the CPU);
  * 4 processes on a 2 x 2 ("data", "map") mesh and 2 on a 1 x 2 one:
    `map_sharded_register` and `map_sharded_register_tables` (tables
    striped over 2 shards).

Each rank's result is bitwise equal to the port's unsharded solve of the
same lanes in this process (`batch_register`, `batch_register_blocks`,
`batch_register_fused`; for the map-sharded tables `register_rounds_core`
on the per-shard fetches merged by `merge_topk` here), each data slice
solved as the rank solved it, and within 1e-5 of one unsharded solve of the
whole batch (a CPU reduction may order its sum by the tensor's shape); the
ranks agree bitwise (those of a `map` group compute the same merge).  Where
no cell overflows (caps 128 / 256), that merged solve is bitwise the
replicated table's `batch_register_pallas`; at the dry run's caps (16 / 32
a shard) the map's cells overflow and the pools differ.

JAX parity without JAX's shard_map: the unsharded counterparts
`batch_register` and `batch_register_blocks` within 1e-4 in pose; the
per-shard tables against JAX `build_sharded_block_tables` (the JAX rows
turned plane-major and row-compacted: bitwise); `merge_topk` against
`lax.top_k` on the same flattened pools, ties included (bitwise); and the
map-sharded tables solve against JAX `register_rounds_core` vmapped over a
fetch that merges JAX's per-shard `grid_knn_block` results with
`lax.top_k` (within 1e-4).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import lax

from feature_base_pointcloud_registration_tpu.ops import hashgrid as jh
from feature_base_pointcloud_registration_tpu.ops.register import (
    register_rounds_core as jrounds)
from feature_base_pointcloud_registration_tpu.parallel import (
    batch as jb, map_sharded as jms)
from feature_base_pointcloud_registration_tpu.pipeline.cloud_info import (
    FeatureMap as JFeatureMap, ScanFeatures as JScanFeatures)
from feature_base_pointcloud_registration_tpu_torch.convert import to_numpy
from feature_base_pointcloud_registration_tpu_torch.ops.fetch import (
    make_pallas_block_knn)
from feature_base_pointcloud_registration_tpu_torch.ops.hashgrid import (
    grid_overflow_fraction)
from feature_base_pointcloud_registration_tpu_torch.ops.register import (
    register_rounds_core)
from feature_base_pointcloud_registration_tpu_torch.parallel import (
    batch as tb, dryrun, map_sharded as tms)
from test_torch_batch import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
CCAP, SCAP = dryrun.CELL_CAPS
ROUNDS = dict(num_rounds=1, iters_per_round=3)
POSE_TOL = 1e-4


_RUNS = {}


def _runs(n):
    """Every rank's dry-run results on n gloo ranks (spawned once)."""
    if n not in _RUNS:
        _RUNS[n] = dryrun.dryrun_multichip(n)
    return _RUNS[n]


def _equal(a, b):
    """Two RegisterResults (NumPy or tensors) bitwise equal."""
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(to_numpy(a), to_numpy(b)))


def _ranks_agree(runs, name):
    for r, out in enumerate(runs[1:], 1):
        assert _equal(out[name][0], runs[0][name][0]), (name, r)
        assert out[name][1] == runs[0][name][1], (name, r)


def _by_slices(solve, feats, poses, n):
    """The unsharded solve run on each of n equal slices of the lanes, the
    results concatenated: the lanes each rank solved, solved here."""
    B = poses.shape[0]
    parts = [solve(tb.take_lanes(feats, slice(i * B // n, (i + 1) * B // n)),
                   poses[i * B // n:(i + 1) * B // n]) for i in range(n)]
    return type(parts[0])(*(torch.cat(a) for a in zip(*parts)))


def _close(a, b, tol=1e-5):
    """Same iterations, n_corr and flags; poses within tol."""
    a, b = to_numpy(a), to_numpy(b)
    d = np.abs(np.asarray(a.pose6) - np.asarray(b.pose6)).max()
    print(f"vs one solve of the whole batch: pose |diff| {d:.3e}")
    assert d <= tol
    for x, y in list(zip(a, b))[1:]:
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def _unsharded_1d(name, n):
    """(solve(features, poses), features, poses) of a data-parallel stage."""
    feats, fmap, poses, center, half = dryrun.problem_1d(n, device=CPU)
    if name == "shard_register":
        return (lambda f, p: tb.batch_register(f, fmap, p, chunk=512,
                                               max_iterations=3),
                feats, poses)
    build, solve = {
        "shard_register_tables": (tb.build_map_block_tables,
                                  tb.batch_register_blocks),
        "shard_register_tables_fused": (tb.build_map_planar_tables,
                                        tb.batch_register_fused)}[name]
    ct, st, origin, dims = build(fmap, center, half, corner_cell_cap=CCAP,
                                 surf_cell_cap=SCAP)
    return (lambda f, p: solve(f, ct, st, origin, p, grid_dims=dims,
                               corner_cell_cap=CCAP, surf_cell_cap=SCAP,
                               **ROUNDS), feats, poses)


@pytest.mark.parametrize("name", ["shard_register", "shard_register_tables",
                                  "shard_register_tables_fused"])
@pytest.mark.parametrize("n", [2, 4])
def test_data_parallel_matches_unsharded(n, name):
    """Bitwise the unsharded solve of each rank's lanes; within 1e-5 of one
    solve of the whole batch (CPU reductions may order their sums by the
    tensor's shape, so a one-lane and a two-lane solve can differ in the
    last bits)."""
    runs = _runs(n)
    _ranks_agree(runs, name)
    res, stats = runs[0][name]
    solve, feats, poses = _unsharded_1d(name, n)
    ref = _by_slices(solve, feats, poses, n)
    assert _equal(res, ref)
    _close(res, solve(feats, poses))
    assert stats["n_total"] == n
    assert stats["n_converged"] == int(ref.converged.sum())
    assert stats["mean_iterations"] == pytest.approx(
        float(ref.iterations.float().mean()))


def _merged_fetch(tables, origin, dims, k):
    """Per-shard fetches of every table in this process, merged."""
    local = [make_pallas_block_knn(t, origin, 2.0, dims=dims, cell_cap=0,
                                   k=k) for t in tables]

    def f(q):
        parts = [fn(q) for fn in local]
        return tms.merge_topk(torch.stack([p[0] for p in parts]),
                              torch.stack([p[1] for p in parts]), k)

    return f


def _map_tables_inputs(n=4):
    data, n_map = dryrun.mesh_shape(n)
    feats, fmap, poses, center, half = dryrun.problem_1d(n, device=CPU)
    b = 2 * data
    return (tb.take_lanes(feats, slice(0, b)), fmap, poses[:b], center, half,
            n_map)


@pytest.mark.parametrize("n", [2, 4])
def test_map_sharded_register_matches_unsharded(n):
    runs = _runs(n)
    _ranks_agree(runs, "map_sharded_register")
    res, stats = runs[0]["map_sharded_register"]
    feats, fmap, poses = dryrun.problem_2d(n, device=CPU)

    def solve(f, p):
        return tb.batch_register(f, fmap, p, chunk=256, max_iterations=3)

    ref = _by_slices(solve, feats, poses, dryrun.mesh_shape(n)[0])
    assert _equal(res, ref)
    _close(res, solve(feats, poses))
    assert stats["n_converged"] == int(ref.converged.sum())


@pytest.mark.parametrize("n", [2, 4])
def test_map_sharded_tables_match_unsharded(n):
    runs = _runs(n)
    _ranks_agree(runs, "map_sharded_register_tables")
    res, stats = runs[0]["map_sharded_register_tables"]
    feats, fmap, poses, center, half, n_map = _map_tables_inputs(n)
    ct, st, origin, dims = tms.build_sharded_block_tables(
        fmap, center, half, n_map, corner_cell_cap=CCAP, surf_cell_cap=SCAP)

    def solve(f, p):
        return register_rounds_core(
            f, _merged_fetch(ct, origin, dims, 8),
            _merged_fetch(st, origin, dims, 8), p, **ROUNDS)

    ref = _by_slices(solve, feats, poses, dryrun.mesh_shape(n)[0])
    assert _equal(res, ref)
    _close(res, solve(feats, poses))
    assert stats["n_converged"] == int(ref.converged.sum())


def test_merged_shards_are_the_replicated_table():
    """Where no cell overflows its cap, the merged per-shard pools are the
    replicated table's: the solve is bitwise `batch_register_pallas`'."""
    feats, fmap, poses, center, half, n_map = _map_tables_inputs()
    caps = dict(corner_cell_cap=128, surf_cell_cap=256)
    ct, st, origin, dims = tms.build_sharded_block_tables(
        fmap, center, half, n_map, **caps)
    for xyz, mask, cap in ((fmap.corner_xyz, fmap.corner_mask, 128),
                           (fmap.surf_xyz, fmap.surf_mask, 256)):
        assert float(grid_overflow_fraction(
            xyz, mask, origin, 2.0, dims=dims, cell_cap=cap)) == 0.0
    merged = register_rounds_core(
        feats, _merged_fetch(ct, origin, dims, 8),
        _merged_fetch(st, origin, dims, 8), poses, **ROUNDS)
    pc, ps, po, _ = tb.build_map_planar_tables(fmap, center, half, **caps)
    rep = tb.batch_register_pallas(feats, pc, ps, po, poses, grid_dims=dims,
                                   **ROUNDS)
    assert _equal(merged, rep)


def test_one_shard_is_the_replicated_table():
    feats, fmap, poses, center, half = dryrun.problem_1d(2, device=CPU)
    ct, st, _, _ = tms.build_sharded_block_tables(
        fmap, center, half, 1, corner_cell_cap=CCAP, surf_cell_cap=SCAP)
    pc, ps, _, _ = tb.build_map_planar_tables(
        fmap, center, half, corner_cell_cap=CCAP, surf_cell_cap=SCAP)
    assert torch.equal(ct[0], pc) and torch.equal(st[0], ps)


# ------------------------------------------------------------ JAX parity

def _jax(tree, cls):
    return cls(*(jnp.asarray(a.numpy()) for a in tree))


@pytest.mark.parametrize("name", ["shard_register", "shard_register_tables"])
def test_data_parallel_matches_jax_unsharded(name):
    res, _ = _runs(2)[0][name]
    feats, fmap, poses, center, half = dryrun.problem_1d(2, device=CPU)
    jf, jm = _jax(feats, JScanFeatures), _jax(fmap, JFeatureMap)
    jp = jnp.asarray(poses.numpy())
    if name == "shard_register":
        want = jb.batch_register(jf, jm, jp, chunk=512, max_iterations=3)
    else:
        ct, st, origin, dims = jb.build_map_block_tables(
            jm, center, half, corner_cell_cap=CCAP, surf_cell_cap=SCAP)
        want = jb.batch_register_blocks(jf, ct, st, origin, jp,
                                        grid_dims=dims, corner_cell_cap=CCAP,
                                        surf_cell_cap=SCAP, **ROUNDS)
    d = np.abs(res.pose6 - np.asarray(want.pose6)).max()
    print(f"{name} vs JAX: pose |diff| {d:.3e}")
    assert d <= POSE_TOL
    np.testing.assert_array_equal(res.iterations, np.asarray(want.iterations))


def test_degenerate_tiny_problem_vs_jax():
    """The JAX dry run's own problem (128 + 256 features, 1024 + 2048 map
    points): every lane is flagged degenerate at iteration 0, and the exact
    solve's update rests on the eigenvectors of a near-degenerate JtJ,
    which float32 rounding turns: the packages agree on the flags,
    iterations and n_corr, and the poses differ by ~4e-4 m (printed; ROADMAP
    Queue 3).  The sharded tests use 4x the features (not degenerate)."""
    feats, fmap, poses = dryrun.tiny_problem(
        device=CPU, batch=2, map_corner=1024, map_surf=2048, corner_cap=128,
        surf_cap=256)
    got = tb.batch_register(feats, fmap, poses, chunk=512, max_iterations=3)
    want = jb.batch_register(_jax(feats, JScanFeatures),
                             _jax(fmap, JFeatureMap),
                             jnp.asarray(poses.numpy()), chunk=512,
                             max_iterations=3)
    print(f"degenerate tiny problem: pose |diff| "
          f"{np.abs(got.pose6.numpy() - np.asarray(want.pose6)).max():.3e}")
    assert got.is_degenerate.all()
    for name in ("is_degenerate", "iterations", "n_corr", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))


def _jax_tables_planar(block):
    """JAX cell-major block tables [S, R, 8*3*cap] -> the port's layout:
    plane-major rows, each row's valid points first (stable), W the widest
    row's valid count rounded up to 128 (at most 8*cap), padded to the
    widest shard with FAR."""
    S, R, w = block.shape
    cap = w // 24
    planes = block.reshape(S, R, 8, 3, cap).transpose(0, 1, 3, 2, 4).reshape(
        S, R, 3, 8 * cap)
    out = []
    for p in planes:
        order = np.argsort(p[:, 0] >= 1e8, axis=1, kind="stable")
        p = np.take_along_axis(p, order[:, None, :], axis=2)
        n = int((p[:, 0] < 1e8).sum(1).max())
        out.append(p[:, :, :min(max(128, -(-n // 128) * 128), 8 * cap)])
    W = max(p.shape[2] for p in out)
    return np.stack([np.pad(p, ((0, 0), (0, 0), (0, W - p.shape[2])),
                            constant_values=1e9).reshape(R, 3 * W)
                     for p in out])


@pytest.fixture(scope="module")
def jax_sharded_tables():
    feats, fmap, poses, center, half, n_map = _map_tables_inputs()
    return jms.build_sharded_block_tables(
        _jax(fmap, JFeatureMap), center, half, n_map, corner_cell_cap=CCAP,
        surf_cell_cap=SCAP)


def test_sharded_tables_match_jax(jax_sharded_tables):
    jct, jst, jorigin, jdims = jax_sharded_tables
    _, fmap, _, center, half, n_map = _map_tables_inputs()
    ct, st, origin, dims = tms.build_sharded_block_tables(
        fmap, center, half, n_map, corner_cell_cap=CCAP, surf_cell_cap=SCAP)
    assert dims == jdims
    np.testing.assert_array_equal(origin.numpy(), np.asarray(jorigin))
    for t, j in ((ct, jct), (st, jst)):
        np.testing.assert_array_equal(t.numpy(),
                                      _jax_tables_planar(np.asarray(j)))


@pytest.mark.parametrize("S,Q,K,k", [(2, 64, 8, 8), (4, 32, 5, 5),
                                     (3, 16, 8, 4)])
def test_merge_topk_matches_lax_top_k(S, Q, K, k):
    r = np.random.RandomState(S * 100 + K)
    d = np.sort(r.randint(0, 6, (S, Q, K)).astype(np.float32), axis=-1)
    d[:, :, -2:] = 3.0e38                      # padding picks tie too
    nn = r.uniform(-1, 1, (S, Q, K, 3)).astype(np.float32)
    got_d, got_nn = tms.merge_topk(torch.from_numpy(d), torch.from_numpy(nn),
                                   k)
    flat_d = jnp.moveaxis(jnp.asarray(d), 0, 1).reshape(Q, S * K)
    flat_nn = jnp.moveaxis(jnp.asarray(nn), 0, 1).reshape(Q, S * K, 3)
    neg, pos = lax.top_k(-flat_d, k)
    want_nn = jnp.take_along_axis(flat_nn, pos[..., None], axis=1)
    np.testing.assert_array_equal(got_d.numpy(), -np.asarray(neg))
    np.testing.assert_array_equal(got_nn.numpy(), np.asarray(want_nn))


def test_map_sharded_tables_match_jax(jax_sharded_tables):
    res, _ = _runs(4)[0]["map_sharded_register_tables"]
    feats, _, poses, _, _, _ = _map_tables_inputs()
    jct, jst, jorigin, dims = jax_sharded_tables

    def fetch(tables, cap):
        def f(q):
            parts = [jh.grid_knn_block(q, t, jorigin, 2.0, dims=dims,
                                       cell_cap=cap, k=8) for t in tables]
            d_all = jnp.stack([p[0] for p in parts])
            nn_all = jnp.stack([p[1] for p in parts])
            S, Q = d_all.shape[:2]
            flat_d = jnp.moveaxis(d_all, 0, 1).reshape(Q, S * 8)
            flat_nn = jnp.moveaxis(nn_all, 0, 1).reshape(Q, S * 8, 3)
            neg, pos = lax.top_k(-flat_d, 8)
            return -neg, jnp.take_along_axis(flat_nn, pos[..., None], axis=1)
        return f

    solve = jax.jit(jax.vmap(lambda f, p: jrounds(
        f, fetch(jct, CCAP), fetch(jst, SCAP), p, **ROUNDS)))
    want = solve(_jax(feats, JScanFeatures), jnp.asarray(poses.numpy()))
    d = np.abs(res.pose6 - np.asarray(want.pose6)).max()
    print(f"map_sharded_register_tables vs JAX merged fetch: pose |diff| "
          f"{d:.3e}")
    assert d <= POSE_TOL
    np.testing.assert_array_equal(res.iterations, np.asarray(want.iterations))


def test_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        tb.make_mesh("cpu", 1)


def test_nccl_dry_run_never_falls_back(monkeypatch):
    """With no card visible the NCCL dry run raises instead of running on
    gloo or the CPU."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="nccl"):
        dryrun.dryrun_multichip(1, backend="nccl")
