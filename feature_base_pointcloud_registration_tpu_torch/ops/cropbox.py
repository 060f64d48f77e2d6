"""Axis-aligned box crop with fixed-capacity compaction.

Port of the JAX package's `ops/cropbox.py`.  Replaces pcl::CropBox in the
localization path: the local map is the global feature map cropped to pose
+-(30, 30, 10) m (ref: src/mapOptmization.h:283-304).  A boolean mask and a
stable compaction keep input order like CropBox.
"""

from __future__ import annotations

import torch


def crop_box(pts, mask, center, half_extent, cap: int):
    """Masked points with |p - center| <= half_extent on every axis.

    pts [N, 3]; mask [N]; center [3]; half_extent [3].  Returns (out
    [min(cap, N), 3], out_mask, count): the first `cap` hits in input order,
    the overflow dropped; count (int32) is the total before the drop."""
    inside = mask & ((pts >= center - half_extent)
                     & (pts <= center + half_extent)).all(-1)
    order = torch.argsort((~inside).to(torch.uint8), stable=True)[:cap]
    m = inside[order]
    out = torch.where(m[:, None], pts[order], 0.0)
    return out, m, inside.sum(dtype=torch.int32)
