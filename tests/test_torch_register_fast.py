"""Port parity: the XLA solver variants of `ops/register.py` and
`parallel/batch.py` against the JAX package's, on tests/test_register.py's
`_features_and_map(seed=9)` scene (one VLP-16 scan of the synthetic room,
its 8192 / 65536-slot feature map; the JAX frontend's features, carried to
the port through numpy).

Two lanes: lane 0 starts from test_register.py's guess (0.3 / 0.25 / 0.1 m
off: it moves more than `refetch_dist` and refetches), lane 1 from 2 cm off
(it never refetches); in the batch of `batch_register_fast_grid` the
recorded fetches check that only lane 0 refetches.  Each lane is held
against the JAX function within 1e-4 in pose (measured: under 2e-6), with
equal iterations:

  * `batch_register_fast` (`register_scan_fast`, the streamed prefetch) on
    lane 0, against JAX `register_scan_fast` (which JAX's
    `batch_register_fast` vmaps), on the scene's valid map points and
    features padded to the k-NN chunk (the same points in both packages,
    half the streaming);
  * `register_grid_core` (exact 27-cell 5-NN on packed 1 m tables);
  * `register_scan_fast_grid` / `batch_register_fast_grid` (packed-grid
    prefetch), tables bitwise;
  * `batch_register_rounds` (the octant-sentinel rounds solver on
    `build_map_grids`' 2 m tables, K=16), tables bitwise; and the same
    solve with the grid's lower x face moved through the scan, beside the
    batched solvers' block-row fetch on that grid (the JAX package's rule:
    the pose difference between the two rules is printed) and beside the
    fetch of the port's `grid_register_step` (lower_pad tables), which
    must give the octant solve's pose within 1e-4 and its n_corr.  On that
    grid one correspondence sits at a gate, and XLA's FMAs flip it (n_corr
    2948 against the port's 2947; the pose 1.557e-4 apart): the test
    allows that one flip there (ROADMAP Queue 3), and only there;
  * `grid_register_step` on a grid whose lower x face lies 0.5 m behind
    the room's x = -25 m wall (half extent (25.8, 30, 10) around lane 0's
    guess: the wall's surf features within half a cell of the face)
    against JAX `grid_register_step`: pose within 1e-4, iterations and
    n_corr equal.

JAX compiles each function at one shape: the batch variants on the two
lanes, the single-scan functions on lane 0.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import test_register as tr
from feature_base_pointcloud_registration_tpu.ops import (
    hashgrid as jh, register as jreg)
from feature_base_pointcloud_registration_tpu.parallel import batch as jb
from feature_base_pointcloud_registration_tpu.pipeline.cloud_info import (
    FeatureMap, ScanFeatures)
from feature_base_pointcloud_registration_tpu_torch.convert import to_torch
from feature_base_pointcloud_registration_tpu_torch.ops import (
    fetch as tfetch, hashgrid as th, register as treg)
from feature_base_pointcloud_registration_tpu_torch.parallel import (
    batch as tb)
from test_torch_batch import one_torch_thread  # noqa: F401

CPU = torch.device("cpu")
CHUNK = 2048
POSE_GT = np.array([0.0, 0.0, 0.25, 2.0, -1.0, 0.0], np.float32)
GUESSES = POSE_GT + np.array([[0.015, -0.01, 0.04, 0.3, -0.25, 0.1],
                              [0.002, -0.001, 0.004, 0.02, -0.01, 0.01]],
                             np.float32)
HALF = (30.0, 30.0, 10.0)
POSE_TOL = 1e-4


def _compact(xyz, mask, multiple):
    """The valid points first, padded (masked) to a multiple."""
    xyz, mask = np.asarray(xyz), np.asarray(mask)
    n = -(-int(mask.sum()) // multiple) * multiple
    out = np.zeros((n, 3), np.float32)
    out[:mask.sum()] = xyz[mask]
    return out, np.arange(n) < mask.sum()


@pytest.fixture(scope="module")
def scene():
    feats, fmap = tr._features_and_map(POSE_GT, seed=9)
    feats, fmap = (jax.tree.map(np.array, t) for t in (feats, fmap))
    feats2 = jax.tree.map(lambda a: np.stack([a, a]), feats)
    # the streamed prefetch's inputs: valid points only (see the docstring)
    cx, cm = _compact(feats.corner_xyz, feats.corner_mask, 1)
    sx, sm = _compact(feats.surf_xyz, feats.surf_mask, 1)
    small = (ScanFeatures(*(np.stack([a, a]) for a in (cx, cm, sx, sm))),
             FeatureMap(*_compact(fmap.corner_xyz, fmap.corner_mask, CHUNK),
                        *_compact(fmap.surf_xyz, fmap.surf_mask, CHUNK)))
    return feats, fmap, feats2, small


def _port(tree):
    return to_torch(tree, device=CPU)


def _same_as_jax(got, want, lanes=(0, 1)):
    """Port RegisterResult [B] against JAX results per lane."""
    pose = got.pose6.numpy()
    for b in lanes:
        d = np.abs(pose[b] - np.asarray(want.pose6)[b]).max()
        print(f"lane {b}: pose |diff| {d:.3e} iterations "
              f"{int(got.iterations[b])} / {int(want.iterations[b])}")
        assert d <= POSE_TOL, (b, pose[b], want.pose6[b])
        assert int(got.iterations[b]) == int(want.iterations[b])
        assert bool(got.valid[b]) == bool(want.valid[b])
    err = np.linalg.norm(pose[:, 3:] - POSE_GT[3:], axis=1)
    assert (err < 0.03).all(), err


class _Recorder:
    """Wraps a fetch factory of `ops.register` and records how many query
    points each fetch takes."""

    def __init__(self, monkeypatch, name):
        self.sizes = []
        real = getattr(treg, name)

        def wrapped(*a, **kw):
            q = a[0]
            self.sizes.append(q.shape[0] if q.dim() != 3 else
                              q.shape[0] * q.shape[1])
            return real(*a, **kw)

        monkeypatch.setattr(treg, name, wrapped)


def _refetch_pattern(sizes, n_corner, n_surf):
    """Fetch sizes (corner, surf alternating) -> lanes of each refetch."""
    lanes = [(c // n_corner, s // n_surf)
             for c, s in zip(sizes[0::2], sizes[1::2])]
    assert all(a == b for a, b in lanes), lanes
    return [a for a, _ in lanes]


def test_batch_register_fast_matches_jax(scene, monkeypatch):
    """`batch_register_fast` (the port's `register_scan_fast` over its
    lanes) on lane 0 against JAX `register_scan_fast`, which JAX's
    `batch_register_fast` vmaps; the lane refetches once it has moved."""
    _, _, _, (f2, m) = scene
    want = jreg.register_scan_fast(
        jax.tree.map(lambda a: jnp.asarray(a[0]), f2),
        jax.tree.map(jnp.asarray, m), jnp.asarray(GUESSES[0]), chunk=CHUNK,
        num_candidates=16)
    rec = _Recorder(monkeypatch, "prefetch_candidates")
    got = tb.batch_register_fast(
        _port(jax.tree.map(lambda a: a[:1], f2)), _port(m),
        torch.from_numpy(GUESSES[:1]), chunk=CHUNK)
    _same_as_jax(got, jax.tree.map(lambda a: np.asarray(a)[None], want),
                 lanes=(0,))
    print(f"fetches: {len(rec.sizes) // 2}")
    assert len(rec.sizes) >= 4


@pytest.fixture(scope="module")
def packed(scene):
    """Packed 1 m tables (cap 16) around lane 0's guess, both packages."""
    _, fmap, _, _ = scene
    dims = jh.default_grid_spec(HALF, 1.0)
    origin = np.asarray(jh.grid_origin(GUESSES[0, 3:6], jnp.asarray(HALF)))
    jt = [np.asarray(jh.build_grid_packed(
        jnp.asarray(x), jnp.asarray(mk), jnp.asarray(origin), 1.0, dims=dims,
        cell_cap=16)) for x, mk in ((fmap.corner_xyz, fmap.corner_mask),
                                    (fmap.surf_xyz, fmap.surf_mask))]
    tm = _port(fmap)
    tt = [th.build_grid_packed(x, mk, torch.tensor(origin), 1.0,
                               dims=dims, cell_cap=16)
          for x, mk in ((tm.corner_xyz, tm.corner_mask),
                        (tm.surf_xyz, tm.surf_mask))]
    return jt, tt, origin, dims


def test_packed_tables_bitwise(packed):
    jt, tt, _, _ = packed
    for j, t in zip(jt, tt):
        np.testing.assert_array_equal(t.numpy(), j)


def test_register_grid_core_matches_jax(scene, packed):
    feats, fmap, f2, _ = scene
    jt, tt, origin, dims = packed
    solve = jax.jit(lambda f, ct, st, o, p: jreg.register_grid_core(
        f, fmap, ct, st, o, p, grid_dims=dims, cell_size=1.0, cell_cap=16))
    want = solve(jax.tree.map(jnp.asarray, feats), jt[0], jt[1], origin,
                 jnp.asarray(GUESSES[0]))
    got = treg.register_grid_core(
        _port(jax.tree.map(lambda a: a[:1], f2)), _port(fmap), tt[0], tt[1],
        torch.tensor(origin), torch.from_numpy(GUESSES[:1]),
        grid_dims=dims, cell_size=1.0, cell_cap=16)
    _same_as_jax(got, jax.tree.map(lambda a: np.asarray(a)[None], want),
                 lanes=(0,))


def test_register_scan_fast_grid_matches_jax(scene, packed):
    feats, fmap, f2, _ = scene
    jt, tt, origin, dims = packed
    want = jreg.register_scan_fast_grid(
        jax.tree.map(jnp.asarray, feats), fmap, jt[0], jt[1],
        jnp.asarray(origin), jnp.asarray(GUESSES[0]), grid_dims=dims,
        cell_size=1.0, cell_cap=16)
    got = treg.register_scan_fast_grid(
        _port(jax.tree.map(lambda a: a[:1], f2)), _port(fmap), tt[0], tt[1],
        torch.tensor(origin), torch.from_numpy(GUESSES[:1]),
        grid_dims=dims, cell_size=1.0, cell_cap=16)
    _same_as_jax(got, jax.tree.map(lambda a: np.asarray(a)[None], want),
                 lanes=(0,))


def test_batch_register_fast_grid_matches_jax(scene, packed, monkeypatch):
    """The lanes differ in whether they refetch: lane 0 refetches, lane 1
    keeps its first candidates."""
    _, fmap, f2, _ = scene
    jt, tt, origin, dims = packed
    want = jb.batch_register_fast_grid(
        jax.tree.map(jnp.asarray, f2), fmap, jt[0], jt[1],
        jnp.asarray(origin), jnp.asarray(GUESSES), grid_dims=dims,
        cell_size=1.0, cell_cap=16)
    rec = []
    real = treg.make_packed_grid_knn

    def recording(*a, **kw):
        fn = real(*a, **kw)

        def f(q):
            rec.append(q.shape[0])
            return fn(q)
        return f

    monkeypatch.setattr(treg, "make_packed_grid_knn", recording)
    got = tb.batch_register_fast_grid(
        _port(f2), _port(fmap), tt[0], tt[1], torch.tensor(origin),
        torch.from_numpy(GUESSES), grid_dims=dims, cell_size=1.0,
        cell_cap=16)
    _same_as_jax(got, jax.tree.map(np.asarray, want))
    lanes = _refetch_pattern(rec, f2.corner_xyz.shape[1],
                             f2.surf_xyz.shape[1])
    print(f"lanes fetching: {lanes}")
    assert lanes[0] == 2 and lanes[1:] and set(lanes[1:]) == {1}


@pytest.fixture(scope="module")
def rounds(scene):
    """build_map_grids' 2 m sentinel tables (caps 16 / 64) on two grids:
    around lane 0's guess, and with the lower x face 0.5 m behind the
    scan's position (the features straddle it).  Same dims: JAX compiles
    once."""
    _, fmap, f2, _ = scene
    out = {}
    for name, shift in (("centered", 0.0), ("lower_face", HALF[0] + 1.5)):
        center = GUESSES[0, 3:6] + np.array([shift, 0, 0], np.float32)
        jc, js, jo, dims = jb.build_map_grids(
            jax.tree.map(jnp.asarray, fmap), center, HALF)
        want = jb.batch_register_rounds(
            jax.tree.map(jnp.asarray, f2), jc, js, jo, jnp.asarray(GUESSES),
            grid_dims=dims)
        tc, ts, to, tdims = tb.build_map_grids(_port(fmap), center, HALF)
        assert tdims == dims
        out[name] = (jax.tree.map(np.asarray, (jc, js, jo, want)),
                     (tc, ts, to), dims, center)
    return out


@pytest.mark.parametrize("grid", ["centered"])
def test_batch_register_rounds_matches_jax(scene, rounds, grid):
    _, _, f2, _ = scene
    (jc, js, jo, want), (tc, ts, to), dims, _ = rounds[grid]
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(to.numpy(), jo)
    got = tb.batch_register_rounds(_port(f2), tc, ts, to,
                                   torch.from_numpy(GUESSES), grid_dims=dims)
    _same_as_jax(got, want)


def test_lower_face_pose_difference(scene, rounds):
    """The same solve on the grid whose lower x face crosses the scan, with
    the batched solvers' block-row fetch in place of the octant-sentinel
    lookup: the features within half a cell of that face lose their
    candidates, and the pose moves.  With the fetch of the port's
    `grid_register_step` (lower_pad tables) they keep them, and the solve
    is the octant solve's."""
    _, fmap, f2, _ = scene
    (jc, js, _, want), (tc, ts, to), dims, center = rounds["lower_face"]
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_array_equal(ts.numpy(), js)
    feats = _port(f2)
    octant = tb.batch_register_rounds(feats, tc, ts, to,
                                      torch.from_numpy(GUESSES),
                                      grid_dims=dims)
    # against JAX's octant solve on this grid: equal within 1e-4 unless a
    # correspondence at a gate flips (one n_corr; ROADMAP Queue 3)
    dj = np.abs(octant.pose6.numpy() - want.pose6).max(1)
    flips = np.abs(octant.n_corr.numpy() - want.n_corr)
    print(f"octant solve vs JAX batch_register_rounds on this grid: pose "
          f"|diff| {dj.tolist()}, n_corr {octant.n_corr.tolist()} vs "
          f"{want.n_corr.tolist()}")
    assert ((dj <= POSE_TOL) | (flips == 1)).all() and (flips <= 1).all()
    bc, bs, bo, _ = tb.build_map_block_tables(_port(fmap), center, HALF,
                                              corner_cell_cap=16,
                                              surf_cell_cap=64)
    blocks = tb.batch_register_blocks(
        feats, bc, bs, bo, torch.from_numpy(GUESSES), grid_dims=dims,
        corner_cell_cap=16, surf_cell_cap=64, num_candidates=16)
    w = treg._to_world(torch.from_numpy(GUESSES), feats.surf_xyz).view(
        2, -1, 3)
    rel = (w[..., 0] - to[0]) / 2.0
    near = (feats.surf_mask & (rel >= 0) & (rel < 0.5)).sum(1)
    d = (octant.pose6 - blocks.pose6).abs().max(1).values
    print(f"lower face at x = {float(to[0]):.2f} m: surf features within "
          f"half a cell of it per lane {near.tolist()}; pose |diff| octant "
          f"vs block rows per lane {d.tolist()}; n_corr "
          f"{octant.n_corr.tolist()} vs {blocks.n_corr.tolist()}")
    assert (near > 50).all()
    assert (octant.n_corr > blocks.n_corr).all()
    pc, ps, po, pdims = tb.build_map_planar_tables(
        _port(fmap), center, HALF, resident=True, lower_pad=True)
    assert pdims == dims and torch.equal(po, to)
    knn = [tfetch.make_pallas_block_knn(t, po, 2.0, dims=dims, cell_cap=0,
                                        k=16)
           for t in (pc, ps)]
    padded = treg.register_rounds_core(feats, knn[0], knn[1],
                                       torch.from_numpy(GUESSES),
                                       num_rounds=2, iters_per_round=15)
    dp = (octant.pose6 - padded.pose6).abs().max(1).values
    print(f"lower_pad fetch vs the octant solve: pose |diff| per lane "
          f"{dp.tolist()}, n_corr {padded.n_corr.tolist()}")
    assert (dp <= POSE_TOL).all()
    assert torch.equal(padded.n_corr, octant.n_corr)
    assert torch.equal(padded.iterations, octant.iterations)


def test_lower_face_grid_register_step_matches_jax(scene):
    """`grid_register_step` with the grid's lower x face 0.5 m behind the
    room's x = -25 m wall: the wall's surf features lie within half a cell
    of the face (octant base -1), and the port's step (the lower_pad
    tables) keeps their candidates as JAX's octant-sentinel step does."""
    feats, fmap, f2, _ = scene
    he = (25.8, 30.0, 10.0)
    want = jax.tree.map(np.asarray, jreg.grid_register_step(
        jax.tree.map(jnp.asarray, fmap), jax.tree.map(jnp.asarray, feats),
        jnp.asarray(GUESSES[0]), half_extent=he))
    tf1 = _port(jax.tree.map(lambda a: a[:1], f2))
    g = torch.from_numpy(GUESSES[:1])
    got = treg.grid_register_step(_port(fmap), tf1, g, half_extent=he)
    origin = th.grid_origin(g[0, 3:6], he, device=CPU)
    rel = (treg._to_world(g, tf1.surf_xyz).view(-1, 3)[:, 0]
           - origin[0]) / 2.0
    near = int((tf1.surf_mask[0] & (rel >= 0) & (rel < 0.5)).sum())
    d = float(np.abs(got.pose6[0].numpy() - want.pose6).max())
    # the same solve on the batched solvers' row space, for the record
    ct, st, to, dims = tb.build_map_planar_tables(_port(fmap), g[0, 3:6],
                                                  he, resident=True)
    old = treg.register_rounds_core(
        tf1, *[tfetch.make_pallas_block_knn(t, to, 2.0, dims=dims,
                                            cell_cap=0, k=16)
               for t in (ct, st)], g, num_rounds=3, iters_per_round=10)
    print(f"lower face at x = {float(origin[0]):.2f} m: {near} surf features"
          f" within half a cell; pose |diff| vs JAX {d:.3e}, n_corr "
          f"{int(got.n_corr[0])} / {int(want.n_corr)}, iterations "
          f"{int(got.iterations[0])} / {int(want.iterations)}; on the "
          f"batched row space (no lower_pad): pose |diff| vs JAX "
          f"{float(np.abs(old.pose6[0].numpy() - want.pose6).max()):.3e}, "
          f"n_corr {int(old.n_corr[0])}")
    assert near > 50
    assert int(old.n_corr[0]) < int(want.n_corr)
    assert d <= POSE_TOL
    assert int(got.n_corr[0]) == int(want.n_corr)
    assert int(got.iterations[0]) == int(want.iterations)
    assert bool(got.valid[0]) and bool(want.valid)
