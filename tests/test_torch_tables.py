"""Port parity: hash-grid map tables and the block-cell rule.

`build_grid_sentinel` and `block_cell_of_xyz` must equal the JAX package
exactly.  `build_block_table_planar` must hold the same shape and, per row,
the same candidate SET; the slot order may differ because the JAX compaction
sort is not asked to be stable (`jax.lax.sort` defaults to is_stable=False),
while the port's is.  The first test also records whether the orders agree.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from feature_base_pointcloud_registration_tpu.ops import hashgrid as jhg
from feature_base_pointcloud_registration_tpu.ops import pallas_fetch as jpf
from feature_base_pointcloud_registration_tpu_torch.convert import (
    planar_table_to_torch, to_numpy, to_torch)
from feature_base_pointcloud_registration_tpu_torch.ops import (
    fetch as tfetch, hashgrid as thg)
from test_torch_batch import one_torch_thread  # noqa: F401

CELL = 2.0
HALF = (7.0, 7.0, 3.0)
CENTER = (0.0, 0.0, 0.0)


def _cloud(seed, m=3000, frac_masked=0.1):
    r = np.random.RandomState(seed)
    pts = r.uniform(-9, 9, (m, 3)).astype(np.float32)   # some out of grid
    pts[:, 2] = r.uniform(-4.5, 4.5, m)
    pts[: m // 4] = np.round(pts[: m // 4] * 4) / 4      # stacked duplicates
    mask = r.uniform(size=m) > frac_masked
    return pts, mask


def _canon_rows(table, W):
    """Per-row candidate sets: slots sorted by (x, y, z)."""
    t = table.reshape(table.shape[0], 3, W).transpose(0, 2, 1)
    o = np.lexsort((t[..., 2], t[..., 1], t[..., 0]), axis=1)
    return np.take_along_axis(t, o[..., None], 1)


def test_grid_spec_and_origin():
    assert thg.default_grid_spec(HALF, CELL) == jhg.default_grid_spec(
        HALF, CELL)
    np.testing.assert_array_equal(
        thg.grid_origin(CENTER, HALF, device="cpu").numpy(),
        np.asarray(jhg.grid_origin(CENTER, HALF)))


@pytest.mark.parametrize("seed,cap", [(0, 16), (1, 32), (2, 48)])
def test_sentinel_and_planar_tables(seed, cap):
    pts, mask = _cloud(seed)
    dims = jhg.default_grid_spec(HALF, CELL)
    jorigin = jhg.grid_origin(CENTER, HALF)
    torigin = thg.grid_origin(CENTER, HALF, device="cpu")
    jst = jhg.build_grid_sentinel(jnp.asarray(pts), jnp.asarray(mask),
                                  jorigin, CELL, dims=dims, cell_cap=cap)
    tst = thg.build_grid_sentinel(torch.from_numpy(pts),
                                  torch.from_numpy(mask), torigin, CELL,
                                  dims=dims, cell_cap=cap)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))

    jpt = planar_table_to_torch(jpf.build_block_table_planar(jst, dims=dims),
                                device="cpu")
    tpt = tfetch.build_block_table_planar(tst, dims=dims)
    assert tpt.shape == jpt.shape
    W = tpt.shape[1] // 3
    np.testing.assert_array_equal(_canon_rows(tpt.numpy(), W),
                                  _canon_rows(jpt.numpy(), W))
    # on these tables the JAX CPU sort happens to keep slot order as well
    np.testing.assert_array_equal(tpt.numpy(), jpt.numpy())

    for name in ("grid_overflow_fraction",):
        want = float(getattr(jhg, name)(jnp.asarray(pts), jnp.asarray(mask),
                                        jorigin, CELL, dims=dims,
                                        cell_cap=cap))
        got = float(getattr(thg, name)(torch.from_numpy(pts),
                                       torch.from_numpy(mask), torigin, CELL,
                                       dims=dims, cell_cap=cap))
        assert got == pytest.approx(want, rel=1e-6)


def test_block_cell_of_xyz():
    r = np.random.RandomState(4)
    q = r.uniform(-12, 12, (4, 500, 3)).astype(np.float32)
    q[0, :50] = np.round(q[0, :50])                     # on cell borders
    dims = jhg.default_grid_spec(HALF, CELL)
    want = np.asarray(jpf.block_cell_of_xyz(
        jnp.asarray(q[..., 0]), jnp.asarray(q[..., 1]), jnp.asarray(q[..., 2]),
        jhg.grid_origin(CENTER, HALF), CELL, dims=dims))
    tq = torch.from_numpy(q)
    got = tfetch.block_cell_of_xyz(tq[..., 0], tq[..., 1], tq[..., 2],
                                   thg.grid_origin(CENTER, HALF, device="cpu"), CELL,
                                   dims=dims)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == dims[0] * dims[1] * dims[2]).any()  # sentinel reached


def test_convert_round_trip():
    from feature_base_pointcloud_registration_tpu.pipeline.cloud_info import (
        FeatureMap)
    from feature_base_pointcloud_registration_tpu_torch.pipeline import (
        cloud_info)
    pts, mask = _cloud(5, m=64)
    jm = FeatureMap(pts, mask, pts[:32], mask[:32])
    tm = to_torch(jm, device="cpu")
    assert type(tm) is cloud_info.FeatureMap
    assert tm.corner_xyz.dtype == torch.float32
    assert tm.corner_mask.dtype == torch.bool
    back = to_numpy(tm)
    for a, b in zip(back, jm):
        np.testing.assert_array_equal(a, b)
