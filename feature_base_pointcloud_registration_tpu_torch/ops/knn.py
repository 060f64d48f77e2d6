"""Exact smallest-k selection (port of the part of the JAX package's
`ops/knn.py` that the block fetch uses; the streamed brute-force `knn`
itself is still to port)."""

from __future__ import annotations

import torch


def _extract_topk(d2, k: int):
    """Exact smallest-k per row, ties to the lower index.  d2: [Q, C] ->
    (values [Q, k], indices int32 [Q, k]).

    The JAX package takes k argmin passes; a stable ascending sort gives
    the same values and indices (first occurrence wins in both)."""
    vals, idx = torch.sort(d2, dim=1, stable=True)
    return vals[:, :k], idx[:, :k].to(torch.int32)
