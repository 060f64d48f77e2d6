"""Port parity: `presort_by_row`, the per-lane sort by block row of the JAX
package's `batch_register_fused(presort_rows=True)`.

The port's solver has no `presort_rows` option (it made the solve slower on
both the TPU and the H100); `chip_smoke.py` uses `presort_by_row` to time
the fetch kernels on the row order that favours their query tiles.  Here it
is held against a NumPy restatement of the JAX presort (R0 from
`euler_to_rot`, w0 = R0 xyz + t, `block_cell_of`, masked features at the
sentinel, one sort keyed on the row): the same sorted row sequence exactly,
and per (lane, row) the same multiset of features.  The port's sort is
stable and `lax.sort` is not promised to be, so the order inside a row is
not compared.

Scenes are `tests/test_torch_batch.py`'s.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from feature_base_pointcloud_registration_tpu.geom.se3 import euler_to_rot
from feature_base_pointcloud_registration_tpu.ops.pallas_fetch import (
    block_cell_of)
from feature_base_pointcloud_registration_tpu_torch.convert import to_torch
from feature_base_pointcloud_registration_tpu_torch.parallel import (
    batch as tbatch)
from test_torch_batch import _SCENES, CAP, one_torch_thread  # noqa: F401


@pytest.fixture(scope="module")
def scenes():
    """Per scene: (port features, corner table, surf table, origin, guesses,
    grid dims), the tables from the port's `build_map_planar_tables`."""
    out = {}
    for name, setup in _SCENES.items():
        feats, guesses, _, fmap, center, half = setup()
        tmap = to_torch(jax.tree.map(np.asarray, fmap),
                        device=torch.device("cpu"))
        ct, st, origin, dims = tbatch.build_map_planar_tables(
            tmap, center, half, corner_cell_cap=CAP, surf_cell_cap=CAP)
        out[name] = (to_torch(jax.tree.map(np.asarray, feats),
                              device=torch.device("cpu")),
                     ct, st, origin, torch.from_numpy(np.array(guesses)),
                     dims)
    return out


def _jax_presort_np(pose, xyz, mask, sentinel, origin, dims):
    """The JAX presort restated in NumPy (block_cell_of is the JAX one):
    sorted rows [B,P] and the features [B,P,3] / mask [B,P] in that
    order (a stable sort; only the per-row multisets are compared)."""
    B, P, _ = xyz.shape
    R0 = np.asarray(jax.vmap(euler_to_rot)(
        jnp.asarray(pose[:, 0]), jnp.asarray(pose[:, 1]),
        jnp.asarray(pose[:, 2])))
    w0 = (np.einsum("bij,bpj->bpi", R0, xyz).astype(np.float32)
          + pose[:, None, 3:6])
    bc = np.asarray(block_cell_of(jnp.asarray(w0.reshape(B * P, 3)),
                                  jnp.asarray(origin), 2.0,
                                  dims=dims)).reshape(B, P)
    bc = np.where(mask, bc, sentinel)
    order = np.argsort(bc, axis=1, kind="stable")
    return (np.take_along_axis(bc, order, 1),
            np.take_along_axis(xyz, order[..., None], 1),
            np.take_along_axis(mask, order, 1))


def _row_multisets(bc, xyz, mask):
    """Per lane: rows (row, x, y, z, mask) in lexicographic order."""
    out = []
    for b in range(bc.shape[0]):
        rows = np.concatenate([bc[b, :, None].astype(np.float64),
                               xyz[b].astype(np.float64),
                               mask[b, :, None].astype(np.float64)], 1)
        out.append(rows[np.lexsort(rows.T[::-1])])
    return out


def _masked(mask, masking):
    """The features' mask with some features masked out: none, every
    fifth of lane 0, or all of lane 1 (a lane of sentinels only)."""
    mask = mask.clone()
    if masking == "strided":
        mask[0, ::5] = False
    elif masking == "lane":
        mask[1] = False
    return mask


@pytest.mark.parametrize("masking", ["none", "strided", "lane"])
@pytest.mark.parametrize("scene", ["tiny", "dense"])
@pytest.mark.parametrize("kind", ["corner", "surf"])
def test_presort_matches_jax_restatement(scenes, scene, kind, masking):
    feats, ct, st, origin, guesses, dims = scenes[scene]
    xyz = getattr(feats, f"{kind}_xyz")
    mask = _masked(getattr(feats, f"{kind}_mask"), masking)
    table = ct if kind == "corner" else st
    sxyz, smask, sbc = tbatch.presort_by_row(guesses, xyz, mask, table,
                                             origin, 2.0, dims)
    sentinel = tbatch.sentinel_of(table)
    want_bc, want_xyz, want_mask = _jax_presort_np(
        guesses.numpy(), xyz.numpy(), mask.numpy(), sentinel,
        origin.numpy(), dims)
    np.testing.assert_array_equal(sbc.numpy(), want_bc)
    assert (np.diff(want_bc, axis=1) >= 0).all()
    for b in range(mask.shape[0]):             # masked features sort last
        n_masked = int((~mask[b]).sum())
        assert (want_bc[b, mask.shape[1] - n_masked:] == sentinel).all()
    for got, want in zip(_row_multisets(sbc.numpy(), sxyz.numpy(),
                                        smask.numpy()),
                         _row_multisets(want_bc, want_xyz, want_mask)):
        np.testing.assert_array_equal(got, want)
