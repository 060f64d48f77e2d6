"""Streamed exact k-nearest-neighbor search: the exactness reference.

Port of the JAX package's `ops/knn.py`.  The reference runs serial FLANN
KD-tree 5-NN queries (ref: src/mapOptmization.h:1020,1143,1413-1414); here
the map is streamed in chunks:

    d2(q, m) = |q|^2 + |m|^2 - 2 q . m^T      (one [Q, C] product per chunk)

on coordinates centred on the query centroid, with an exact top-k and ties
to the lower index.  Returned distances are exact squared distances;
padded/masked map points get 3e38 and never beat a real point (their
indices stay in range).  Every function broadcasts over leading batch dims:
a batch of query sets against one shared map [M, 3] or one map per set
[..., M, 3].

`knn` dispatches by device.  CPU tensors run `knn_reference`, the plain
version: a Python loop of a `torch.matmul` (TF32 off, see device.py), a
top-k and a running 2k-column merge a chunk, as the JAX package's
`lax.scan` does.  `torch.topk` does not promise an order among ties on
CUDA, so `_extract_topk` selects on keys that make every entry distinct
(the distance's bits, then the column).  CUDA tensors launch
`csrc/knn_stream.cu` (one launch a call, k up to `kernels.KNN_MAX_K`), the
same selection in one pass over the map, or raise.  The result does not
depend on `chunk` except in the plain version's no-neighbour slots: with
one chunk (M == chunk) a slot past the live points holds the lowest masked
indices; with more it holds index 0, since the running best starts at
(3e38, 0) and wins every tie at 3e38.  The kernel returns the same.
"""

from __future__ import annotations

import torch

from .. import kernels

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
    M must be a multiple of `chunk` (pad the map to its capacity).  CPU
    tensors run `knn_reference`; CUDA tensors launch `fbpr_knn`, or
    raise."""
    dev = query.device
    if dev.type == "cpu":
        return knn_reference(query, ref, ref_mask, k, chunk)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    check_kernel_args(query, ref, ref_mask, k, chunk)
    M = ref.shape[-2]
    lead = query.shape[:-2]
    Q = query.shape[-2]
    q = query.reshape(-1, Q, 3).contiguous()
    S = q.shape[0]
    center = q.mean(-2)
    r = ref.reshape(-1, M, 3) if ref.dim() > 2 else ref
    msk = ref_mask.reshape(-1, M) if ref.dim() > 2 else ref_mask
    d2 = torch.empty((S, Q, k), dtype=torch.float32, device=dev)
    idx = torch.empty((S, Q, k), dtype=torch.int32, device=dev)
    kernels.launch_knn(q, center, r.contiguous(), msk.contiguous(), d2, idx,
                       one_chunk=M == chunk)
    _COUNTED.launches += 1
    return d2.view(*lead, Q, k), idx.view(*lead, Q, k)


knn.launches = 0
# the counter's owner, whatever a caller rebinds `knn` to (a timing
# wrapper, a recorder)
_COUNTED = knn


def check_kernel_args(query, ref, ref_mask, k: int, chunk: int):
    """Raise ValueError where `fbpr_knn` does not take a call: M not a
    multiple of chunk, k outside 1..min(KNN_MAX_K, chunk), shapes other
    than query [..., Q, 3] against ref [M, 3] / [..., M, 3] and its mask,
    dtypes other than float32 points and a bool mask, inputs on different
    devices."""
    M = ref.shape[-2] if ref.dim() >= 2 else 0
    if ref.dim() >= 2 and M % chunk:
        raise ValueError(f"map capacity {M} not a multiple of chunk {chunk}")
    if not 1 <= k <= min(kernels.KNN_MAX_K, chunk):
        raise ValueError(f"k={k}: the k-NN kernel takes k in 1.."
                         f"{min(kernels.KNN_MAX_K, chunk)} (chunk {chunk})")
    if query.dim() < 2 or query.shape[-1] != 3 or ref.dim() < 2 \
            or ref.shape[-1] != 3 or M < 1 \
            or ref.shape[:-2] not in ((), query.shape[:-2]) \
            or ref_mask.shape != ref.shape[:-1]:
        raise ValueError(f"knn: query {tuple(query.shape)}, ref "
                         f"{tuple(ref.shape)}, ref_mask "
                         f"{tuple(ref_mask.shape)}")
    if query.dtype != torch.float32 or ref.dtype != torch.float32 \
            or ref_mask.dtype != torch.bool:
        raise ValueError(f"knn: dtypes {query.dtype}, {ref.dtype}, "
                         f"{ref_mask.dtype} (float32, float32, bool)")
    if ref.device != query.device or ref_mask.device != query.device:
        raise ValueError("knn: query, ref and ref_mask on different devices")


def knn_reference(query, ref, ref_mask, k: int = 5, chunk: int = 4096):
    """The plain version of `knn` (the port's loop before the kernel): on
    any device, a `torch.matmul`, a top-k and a running 2k-column merge a
    map chunk."""
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
