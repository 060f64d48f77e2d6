"""The k-NN selections of csrc/knn_stream.cu and csrc/icp.cu, transcribed
in numpy float32 (tests/knn_cells.py), held key for key to a brute-force
transcription of the parent kernels' keys; no JAX.

  * the brute force (every map point's d2_bits, the least k by (bits,
    index), the no-neighbour rule) against the plain version,
    `knn_reference`, by icp_scenes.knn_agreement (its tolerances: the
    plain version's cross term is a torch.matmul, whose CPU rounding may
    differ from the kernels' products), on KNN_SCENES at k 1, 5 and 16,
    one chunk and four;
  * knn_stream.cu's split, masked-slot compaction and its warps' and
    cluster's merges bit for bit the brute force on the same cases (a 512
    slot map), at the kernel's own split count and at 4 and 16 splits;
  * icp.cu's cell search (the index, the shells, the margin, the full
    scan) bit for bit the brute force's 1-NN on every icp_scenes scene and
    edge scene, from no seed and from the last trip's neighbours, and with
    the pair's 2 m cut: every row below the cut its neighbour, the others
    a finite key at or above it;
  * the margin is needed: on small scenes whose centroid lies 40 m from a
    row, the search without it (pruning on the bare distance) takes
    another key for some rows, and with it none.
"""

import numpy as np
import pytest
import torch

from feature_base_pointcloud_registration_tpu_torch.ops.knn import (
    knn_reference)

import icp_scenes as scn
import knn_cells as kc

T = torch.from_numpy
M_MAP = 1024


def _knn_case(scene, chunks, Q=300, M=M_MAP):
    chunk = M if chunks == "one" else M // 4
    q, ref, mask = scn.knn_scene(scene, M, chunk, Q=Q)
    # the plain version's centre (knn's callers pass it to the kernel)
    return q, ref, mask, chunk, T(q).mean(0).numpy()


@pytest.mark.parametrize("chunks", ["one", "four"])
@pytest.mark.parametrize("k", [1, 5, 16])
@pytest.mark.parametrize("scene", scn.KNN_SCENES)
def test_brute_transcription_is_the_plain_knn(scene, k, chunks):
    q, ref, mask, chunk, c = _knn_case(scene, chunks)
    d2, idx = kc.brute_knn(q, ref, mask, k, chunk == M_MAP, c)
    d2p, ip = knn_reference(T(q), T(ref), T(mask), k=k, chunk=chunk)
    d2p1 = knn_reference(T(q), T(ref), T(mask), k=k + 1, chunk=chunk)[0]
    scn.knn_agreement(T(q), T(ref), T(d2), T(idx), d2p, ip, d2p1)


@pytest.mark.parametrize("chunks", ["one", "four"])
@pytest.mark.parametrize("k", [1, 5, 16])
@pytest.mark.parametrize("scene", scn.KNN_SCENES)
def test_split_knn_is_the_brute_force(scene, k, chunks):
    q, ref, mask, chunk, c = _knn_case(scene, chunks, Q=96, M=512)
    one = chunk == len(ref)
    want = kc.brute_knn(q, ref, mask, k, one, c)
    C = kc.plan_splits(1, len(q), len(ref), k)
    for splits in sorted({C, 4, 16}):
        got = kc.split_knn(q, ref, mask, k, one, c, C=splits)
        assert np.array_equal(got[0].view(np.int32), want[0].view(np.int32))
        assert np.array_equal(got[1], want[1]), splits


def _icp_case(name):
    if name in scn.ICP_SCENES:
        return scn.icp_scene(name)
    return scn.edge_scene(name)


@pytest.mark.parametrize("name", scn.ICP_SCENES + scn.EDGE_SCENES)
def test_cell_search_is_the_brute_force(name):
    src, sm, dst, dm, kw = _icp_case(name)
    one = len(dst) == kw["chunk"]
    c = np.float32(src.astype(np.float64).mean(0))   # knn's centre
    rows = src[sm]          # the kernel searches the live rows only
    cells = kc.Cells(dst, dm)
    want_b, want_i = kc.select(kc.keys(rows, dst, dm, c), 1, one)
    got_b, got_i, pairs, full = kc.cell_nn(cells, rows, c, dst, dm,
                                           one_chunk=one)
    assert np.array_equal(got_b, want_b[:, 0])
    assert np.array_equal(got_i, want_i[:, 0])
    print(f"{name}: {pairs} pairs visited of {len(rows) * int(dm.sum())}, "
          f"{full} rows scanned everything")
    if name in ("room", "face", "tie", "duplicates"):
        assert cells.valid and full == 0 and pairs < len(rows) * dm.sum() / 4
    if name in ("far", "no_live"):
        assert full == len(rows)
    # from the last trip's neighbours (those of rows 5 cm away)
    moved = (rows + np.float32(0.05)).astype(np.float32)
    prev = kc.select(kc.keys(moved, dst, dm, c), 1, one)[1][:, 0]
    seeded = kc.cell_nn(cells, rows, c, dst, dm, prev=prev, one_chunk=one)
    assert np.array_equal(seeded[0], want_b[:, 0])
    assert np.array_equal(seeded[1], want_i[:, 0])
    # the pair's cut: what lies beyond 2 m is not looked for
    cut = np.float32(4.0)
    b, i, _, _ = kc.cell_nn(cells, rows, c, dst, dm, cut=cut, one_chunk=one)
    d2 = b.astype(np.int32).view(np.float32)
    below = want_b[:, 0].astype(np.int32).view(np.float32) < cut
    assert np.array_equal(b[below], want_b[below, 0])
    assert np.array_equal(i[below], want_i[below, 0])
    assert (np.isfinite(d2[~below]) & (d2[~below] >= cut)).all()


def test_edge_scenes_are_what_they_say():
    src, _, dst, dm, _ = scn.edge_scene("face")
    cells = kc.Cells(dst, dm)
    assert (cells.n == 8).all() and np.allclose(cells.h, 0.75)
    lo = cells.lo.astype(np.float64)
    off = np.abs((dst[dm] - lo) / 0.75 - np.round((dst[dm] - lo) / 0.75))
    assert (off * 0.75 < 1e-5).any(1).sum() > 1000
    src, sm, dst, dm, _ = scn.edge_scene("tie")
    c = np.float32(src.astype(np.float64).mean(0))
    bits = kc.keys(src[sm], dst, dm, c)
    first = np.sort(bits, 1)[:, :2]
    assert (first[:, 0] == first[:, 1]).all()
    cells = kc.Cells(dst, dm)
    cell = cells.cell_of(dst)
    two = [i for i, row in enumerate(bits)
           if len({int(cell[j]) for j in np.nonzero(row == first[i, 0])[0]})
           > 1]
    assert len(two) > 10


def test_the_margin_is_needed():
    """The search pruning on the bare distance takes another key where the
    float32 keys at a centroid 40 m away (~1e-3 m^2 of rounding) put a
    point across a cell face below the row's best; the margin keeps it."""
    r = np.random.RandomState(7)
    corners = np.stack(np.meshgrid(*[[0.0, 10.0]] * 3, indexing="ij"),
                       -1).reshape(-1, 3)
    wrong = 0
    for _ in range(200):
        d = r.uniform(0.2, 0.4)
        y, z = r.uniform(2.0, 3.0, 2)
        q = np.array([5.0 - d, y, z])
        m_face = np.array([5.0, y, z])           # across the x = 5 face
        m_in = q - np.array([d * (1 + r.uniform(0, 4e-5)), 0.0, 0.0])
        dst = (np.vstack([corners, m_face, m_in]) + scn.OFFSET).astype(
            np.float32)
        dm = np.ones(len(dst), bool)
        qw = (q + scn.OFFSET).astype(np.float32)[None]
        c = (qw[0] - np.float32([40.0, 0.0, 0.0])).astype(np.float32)
        cells = kc.Cells(dst, dm)
        assert (cells.n == 2).all()
        want = kc.select(kc.keys(qw, dst, dm, c), 1, True)
        bare = kc.cell_nn(cells, qw, c, dst, dm, one_chunk=True, margin=False)
        kept = kc.cell_nn(cells, qw, c, dst, dm, one_chunk=True)
        assert kept[0][0] == want[0][0, 0] and kept[1][0] == want[1][0, 0]
        wrong += int(bare[1][0] != want[1][0, 0])
    assert wrong > 0
