"""Streamed exact k-nearest-neighbor search: the exactness reference.

Port of the JAX package's `ops/knn.py`.  The reference runs serial FLANN
KD-tree 5-NN queries (ref: src/mapOptmization.h:1020,1143,1413-1414); here
the map is streamed in chunks:

    d2(q, m) = |q|^2 + |m|^2 - 2 q . m^T      (one [Q, C] product per chunk)

with an exact top-k per chunk and a running 2k-column merge, so memory
holds the padded map and one [Q, C] distance buffer.  The cross term is a
plain `torch.matmul` (TF32 off, see device.py), as the JAX package computes
it outside any Pallas kernel.  Every selection is exact with ties to the
lower index, the rule of `lax.top_k`: `torch.topk` does not promise an order
among ties on CUDA, so `_extract_topk` selects on keys that make every entry
distinct (the distance's bits, then the column).

Returned distances are exact squared distances; padded/masked map points get
3e38 and never beat a real point (their indices stay in range).  Every
function broadcasts over leading batch dims: a batch of query sets against
one shared map [M, 3] or one map per set [..., M, 3].
"""

from __future__ import annotations

import torch

_BIG = 3.0e38


def _extract_topk(d2, k: int):
    """Exact smallest-k along the last axis, ties to the lower index.
    d2 [..., C] (non-negative or 3e38) -> (values [..., k] ascending,
    indices int32 [..., k]).

    The JAX package takes k argmin passes (first occurrence wins).  Here
    one `torch.topk` runs on int64 keys (the float32 bits of d2, whose order
    is the values' order for non-negative floats, above the column index):
    the keys are distinct, so the selection and its order are the same as
    a stable ascending sort's, at a fraction of a sort's cost.  A key is
    the pair (column, bits) of int32 words read as one little-endian
    int64.  For k = 1 one `min`, which returns the first minimal index."""
    if k == 1:
        v, i = d2.min(-1, keepdim=True)
        return v, i.to(torch.int32)
    bits = (d2 + 0.0).view(torch.int32)                  # -0.0 -> +0.0
    col = torch.arange(d2.shape[-1], dtype=torch.int32, device=d2.device)
    key = torch.stack([col.expand_as(bits), bits], -1).view(torch.int64)
    key = torch.topk(key[..., 0], k, dim=-1, largest=False).values
    idx = key & 0xFFFFFFFF
    return torch.gather(d2, -1, idx), idx.to(torch.int32)


def _chunk_d2(query, q_norm, pts, msk):
    r_norm = (pts * pts).sum(-1)
    cross = torch.matmul(query, pts.transpose(-1, -2))
    d2 = q_norm + r_norm[..., None, :] - 2.0 * cross
    return torch.where(msk[..., None, :], torch.clamp(d2, min=0.0), _BIG)


def knn(query, ref, ref_mask, k: int = 5, chunk: int = 4096):
    """k-NN of each query point in the masked reference set.

    query [..., Q, 3]; ref [..., M, 3] or [M, 3]; ref_mask [..., M] or [M].
    Returns (dists2 [..., Q, k] ascending, idx [..., Q, k] int32 into ref).
    M must be a multiple of `chunk` (pad the map to its capacity)."""
    M = ref.shape[-2]
    if M % chunk:
        raise ValueError(f"map capacity {M} not a multiple of chunk {chunk}")
    n_chunks = M // chunk

    # Center on the query centroid: d2 is translation-invariant and smaller
    # magnitudes keep the |q|^2+|m|^2-2qm cancellation accurate in float32.
    center = query.mean(-2, keepdim=True)
    query = query - center
    ref = ref - center
    q_norm = (query * query).sum(-1, keepdim=True)            # [..., Q, 1]

    if n_chunks == 1:
        return _extract_topk(_chunk_d2(query, q_norm, ref, ref_mask), k)

    best_d = torch.full((*query.shape[:-1], k), _BIG, dtype=torch.float32,
                        device=query.device)
    best_i = torch.zeros(best_d.shape, dtype=torch.int32,
                         device=query.device)
    for c in range(n_chunks):
        s = slice(c * chunk, (c + 1) * chunk)
        cd, ci = _extract_topk(
            _chunk_d2(query, q_norm, ref[..., s, :], ref_mask[..., s]), k)
        # merge the running best with this chunk's top-k (2k columns);
        # the running best comes first, so ties keep the lower index
        cand_d = torch.cat([best_d, cd], -1)
        cand_i = torch.cat([best_i, ci + c * chunk], -1)
        best_d, pos = _extract_topk(cand_d, k)
        best_i = torch.gather(cand_i, -1, pos.long())
    return best_d, best_i


def _rows(ref, idx):
    """Rows of ref ([M, 3], or [..., M, 3] with idx's leading dims) at idx
    [..., Q, k] -> [..., Q, k, 3]."""
    idx = idx.long()
    if ref.dim() == 2:
        return ref[idx]
    flat = idx.reshape(*idx.shape[:-2], -1, 1).expand(
        *idx.shape[:-2], -1, 3)
    return torch.gather(ref, -2, flat).reshape(*idx.shape, 3)


def knn5(query, ref, ref_mask, chunk: int = 4096):
    """5-NN (the reference's nearestKSearch(point, 5, ...) everywhere)."""
    return knn(query, ref, ref_mask, k=5, chunk=chunk)


def knn5_points(query, ref, ref_mask, chunk: int = 4096):
    """5-NN returning the neighbor coordinates instead of indices, the
    interface the correspondence stage needs.  Returns (d2 [..., Q, 5],
    nn [..., Q, 5, 3])."""
    d2, idx = knn(query, ref, ref_mask, k=5, chunk=chunk)
    return d2, _rows(ref, idx)


def make_local_knn(ref, ref_mask, chunk: int = 4096):
    """Single-device knn closure for register_core."""
    return lambda q: knn5_points(q, ref, ref_mask, chunk=chunk)
