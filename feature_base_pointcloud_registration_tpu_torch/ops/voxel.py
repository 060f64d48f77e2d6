"""Voxel-grid centroid downsampling as a fixed-capacity sort/segment op.

Port of the JAX package's `ops/voxel.py`, batched over any leading
dimensions.  Replaces pcl::VoxelGrid (ref: src/mapOptmization.h:190-193,
981-993 and per-ring surface thinning, src/featureExtraction.h:288-292):
bin at ijk = floor(p/leaf), emit per-voxel centroids in ascending voxel-key
order, drop voxels past `cap` (largest keys first).

The two sort keys of the JAX version (x cell; y/z cells rebased to the
cloud's minimum and packed 15+15 bits) become one int64 key k1 << 30 | k2.
Segment sums are a scatter-add in float64, so the centroids differ from the
JAX package's float32 segmented scan only by summation order (SURVEY.md §7
"voxel filter parity": tolerance, not bit-parity).
"""

from __future__ import annotations

import torch

_KEY_MAX = 2 ** 30


def voxel_downsample(pts, mask, leaf_size, cap: int):
    """Centroid voxel filter over the last point axis.

    pts [..., N, 3], mask [..., N] -> (centroids [..., cap, 3],
    mask [..., cap], count [...] int32, at most cap)."""
    out, out_mask, n_vox = voxel_filter(pts, mask, leaf_size, cap)
    return out, out_mask, torch.clamp(n_vox, max=cap).to(torch.int32)


def voxel_filter(pts, mask, leaf_size, cap: int):
    """`voxel_downsample` whose count is the number of voxels BEFORE the
    cap (int64 [...]): above cap, the largest keys were dropped."""
    lead = pts.shape[:-2]
    n = pts.shape[-2]
    pts = pts.reshape(-1, n, 3)
    mask = mask.reshape(-1, n)
    L = pts.shape[0]
    dev = pts.device

    inv = (torch.tensor(1.0, dtype=torch.float32)
           / torch.tensor(leaf_size, dtype=torch.float32)).to(dev)
    ijk = torch.floor(pts * inv).to(torch.int64)  # PCL floor semantics
    base = torch.where(mask[..., None], ijk, _KEY_MAX).amin(dim=1)
    rel = ijk - base[:, None, :]
    k1 = torch.where(mask, rel[..., 0], _KEY_MAX)
    k2 = (rel[..., 1].clamp(0, 32767) << 15) | rel[..., 2].clamp(0, 32767)
    key, perm = torch.sort((k1 << 30) | k2, dim=1, stable=True)
    sm = torch.gather(mask, 1, perm)
    sp = torch.gather(pts, 1, perm[..., None].expand(-1, -1, 3))

    is_new = sm.clone()
    is_new[:, 1:] &= key[:, 1:] != key[:, :-1]
    voxel_id = torch.cumsum(is_new, dim=1) - 1
    n_vox = is_new.sum(dim=1)

    # invalid rows and voxels past `cap` land in the spill slot `cap`
    slot = torch.where(sm & (voxel_id < cap), voxel_id,
                       torch.full_like(voxel_id, cap))
    vals = torch.cat([sp, torch.ones_like(sp[..., :1])], dim=-1)
    vals = torch.where(sm[..., None], vals, 0.0).to(torch.float64)
    acc = torch.zeros(L, cap + 1, 4, dtype=torch.float64, device=dev)
    acc.scatter_add_(1, slot[..., None].expand(-1, -1, 4), vals)
    acc = acc[:, :cap].to(torch.float32)
    sums, counts = acc[..., :3], acc[..., 3]

    out_mask = torch.arange(cap, device=dev)[None, :] < n_vox[:, None]
    out = sums / torch.clamp(counts, min=1.0)[..., None]
    out = torch.where(out_mask[..., None], out, 0.0)
    return (out.reshape(*lead, cap, 3), out_mask.reshape(*lead, cap),
            n_vox.reshape(lead))
