"""numpy float32 transcriptions of the k-NN selection in csrc/knn_tile.cuh,
csrc/knn_stream.cu and csrc/icp.cu, made to be held key for key to each
other on the CPU (no JAX, no torch: the GPU tests use them too).

  keys          every (query, map point) key as the kernels compute it:
                d2_bits of the centred coordinates, q' = fl(q - c), m' =
                fl(m - c), K = clamp0(fl(fl(|q'|^2 + |m'|^2) - 2 fl(q'.m'))),
                the norms and the dot in PyTorch's order and every product
                and sum rounded to float32 (no FMA); 3e38 at a masked point;
                a NaN key is the card's canonical NaN, kNoKey, never taken
  brute_knn     the parent kernels' selection: the least k keys (bits,
                index) over the map, padded with kNoKey, the no-neighbour
                rule (one chunk or more) applied
  split_knn     knn_stream.cu's: the map in groups of 64 slots dealt to
                C splits and each split's 8 warps, a warp's live points
                only (the masked ones compacted away) pushed in index
                order into TopK lists (push_in_order), then its lowest k
                masked slots at 3e38 where one chunk leaves them in, the
                warps' lists merged, the splits' lists merged through the
                cluster's log2(C) steps (push), the rule
  Cells /       icp.cu's cell index (the live box, ~8 points a cell, at
  cell_nn       most 1024 cells an axis and M / 4 + 64 in all) and a row's
                search: the seed, the shells of growing Chebyshev radius,
                every cell tested against the margin of icp.cu's header
                comment, the stop test beyond the shells, the full scan
                after MAX_SHELLS shells (or where the row or the centroid
                lies 1e15 m out or is not finite, or no cells are built)
"""

import numpy as np

F32 = np.float32
KBIG = F32(3.0e38)
KBIG_BITS = int(np.array(KBIG).view(np.int32))
KNOKEY = 0x7FFFFFFF
U = 2.0 ** -24
HUGE = F32(1.0e15)
PER_CELL = 8
MAX_DIM = 1024
MAX_SHELLS = 4


def _sq(x, y, z):
    return (x * x + y * y) + z * z


def keys(q, ref, mask, center):
    """int64 [Q, M] key bits of queries q [Q, 3] against ref [M, 3] (mask
    [M]) centred on center [3], all float32."""
    c = np.asarray(center, F32)
    q = np.asarray(q, F32) - c
    m = np.asarray(ref, F32) - c
    with np.errstate(invalid="ignore", over="ignore"):
        qn = _sq(q[:, 0], q[:, 1], q[:, 2])
        mn = _sq(m[:, 0], m[:, 1], m[:, 2])
        qq, mm = q[:, None, :], m[None, :, :]
        cross = (qq[..., 0] * mm[..., 0] + qq[..., 1] * mm[..., 1]) \
            + qq[..., 2] * mm[..., 2]
        d = (qn[:, None] + mn[None, :]) - F32(2.0) * cross
        d = np.where(d > 0, d, np.where(np.isnan(d), d, F32(0.0))).astype(F32)
    bits = d.view(np.int32).astype(np.int64)
    bits[np.isnan(d)] = KNOKEY
    bits[:, ~np.asarray(mask, bool)] = KBIG_BITS
    return bits


def _rule(bits, idx, one_chunk):
    """knn_tile.cuh's no_neighbour_rule."""
    if not one_chunk:
        far = bits >= KBIG_BITS
        bits, idx = np.where(far, KBIG_BITS, bits), np.where(far, 0, idx)
    return bits, idx


def _as_out(bits, idx):
    return (np.asarray(bits, np.int64).astype(np.int32).view(F32),
            np.asarray(idx, np.int64).astype(np.int32))


def select(bits, k, one_chunk):
    """The least k (bits, index) of each row of bits [Q, M] below kNoKey,
    padded with (kNoKey, kNoKey), the rule applied: (bits, idx) int64."""
    Q, M = bits.shape
    out_b = np.full((Q, k), KNOKEY, np.int64)
    out_i = np.full((Q, k), KNOKEY, np.int64)
    col = np.arange(M)
    for i in range(Q):
        ok = bits[i] < KNOKEY
        order = np.lexsort((col[ok], bits[i][ok]))[:k]
        out_b[i, :len(order)] = bits[i][ok][order]
        out_i[i, :len(order)] = col[ok][order]
    return _rule(out_b, out_i, one_chunk)


def brute_knn(q, ref, mask, k, one_chunk, center):
    """The parent kernels' k-NN: (d2 float32 [Q, k], idx int32 [Q, k])."""
    return _as_out(*select(keys(q, ref, mask, center), k, one_chunk))


# ---- knn_stream.cu ----

class TopK:
    """knn_tile.cuh's TopK<K> for a batch of queries: bits, idx [Q, K]."""

    def __init__(self, Q, K):
        self.bits = np.full((Q, K), KNOKEY, np.int64)
        self.idx = np.full((Q, K), KNOKEY, np.int64)

    def _insert(self, take, b, j, less):
        if not take.any():
            return
        K = self.bits.shape[1]
        self.bits[take, K - 1] = b[take]
        self.idx[take, K - 1] = j[take]
        for k in range(K - 1, 0, -1):
            sw = take & less(self.bits[:, k], self.idx[:, k],
                             self.bits[:, k - 1], self.idx[:, k - 1])
            if not sw.any():      # a row that stops moving has its place
                break
            for a in (self.bits, self.idx):
                a[sw, k], a[sw, k - 1] = a[sw, k - 1], a[sw, k].copy()

    def push_in_order(self, b, j):
        """candidates after every key held (a higher index): strict < on
        the bits alone."""
        self._insert(b < self.bits[:, -1], b, j,
                     lambda b1, i1, b2, i2: b1 < b2)

    def push(self, b, j):
        """any candidate: by (bits, index)."""
        self._insert(_key_less(b, j, self.bits[:, -1], self.idx[:, -1]), b, j,
                     _key_less)


def _key_less(ab, ai, bb, bi):
    return (ab < bb) | ((ab == bb) & (ai < bi))


GROUP = 64     # map slots a warp stages at once
WARPS = 8      # a CTA's warps, each with every query of the CTA


def plan_splits(S, Q, M, K, sms=132, max_cluster=16, list_slots=16):
    """knn_stream.cu's plan_splits: C, the splits of the map."""
    tiles = -(-Q // (32 * (2 if K <= 8 else 1))) * S
    groups = -(-M // GROUP)
    c = 1
    while (c < max_cluster and tiles * c < 4 * sms
           and groups // (2 * c) >= WARPS
           and M // (2 * c * WARPS) >= list_slots * K):
        c *= 2
    return c


def _merge(into, other, Q, k):
    """take_lists: other's entries up to its first kNoKey (or its first
    one that into rejects) pushed into into; push keeps the k least by
    (bits, index), so the result is the k least of the two lists' entries
    (their indices are distinct)."""
    cut = np.cumsum(other.bits == KNOKEY, 1) > 0
    ob = np.where(cut, KNOKEY, other.bits)
    oi = np.where(cut, KNOKEY, other.idx)
    key = np.concatenate([into.bits * 2 ** 32 + into.idx,
                          ob * 2 ** 32 + oi], 1)
    key = np.sort(key, 1)[:, :k]
    into.bits, into.idx = key >> 32, key & 0xFFFFFFFF


def split_knn(q, ref, mask, k, one_chunk, center, C=None):
    """knn_stream.cu's k-NN of one query set: (d2, idx) as brute_knn.  The
    map in groups of GROUP slots; split s holds the groups g = s (mod C),
    its warp w every WARPS-th of them; each warp's live points (the masked
    ones compacted away) pushed in index order into TopK lists
    (push_in_order), then its lowest k masked slots at 3e38 where one
    chunk leaves them in (push); the warps' lists merged (warp w takes
    warp w + d's, d = 4, 2, 1), the splits' lists merged in log2(C) steps
    (push), the rule."""
    mask = np.asarray(mask, bool)
    Q, M = len(q), len(ref)
    C = plan_splits(1, Q, M, k) if C is None else C
    groups = -(-M // GROUP)
    bits = keys(q, ref, mask, center)
    lists = []
    for s in range(C):
        warps = []
        for w in range(WARPS):
            top = TopK(Q, k)
            off = []
            for g in range(s + C * w, groups, C * WARPS):
                lo = g * GROUP
                for j in lo + np.nonzero(mask[lo:lo + GROUP])[0]:
                    top.push_in_order(bits[:, j], np.full(Q, j))
                off += list(lo + np.nonzero(~mask[lo:lo + GROUP])[0])
            if one_chunk:
                for j in off[:k]:
                    top.push(np.full(Q, KBIG_BITS), np.full(Q, j))
            warps.append(top)
        d = WARPS // 2
        while d:
            for w in range(d):
                _merge(warps[w], warps[w + d], Q, k)
            d //= 2
        lists.append(warps[0])
    d = 1
    while d < C:
        for r in range(0, C, 2 * d):
            if r + d < C:
                _merge(lists[r], lists[r + d], Q, k)
        d *= 2
    return _as_out(*_rule(lists[0].bits, lists[0].idx, one_chunk))


# ---- icp.cu's cells ----

class Cells:
    """icp.cu's cell index over the live points of dst [M, 3] (mask [M])."""

    def __init__(self, dst, dst_mask):
        dst = np.asarray(dst, F32)
        mask = np.asarray(dst_mask, bool)
        M = len(dst)
        live = np.nonzero(mask)[0]
        p = dst[live]
        ok = (np.abs(p) < HUGE).all(1)
        self.first_live = int(live[0]) if len(live) else -1
        self.valid = len(live) > 0 and bool(ok.all())
        if not self.valid:
            return
        self.lo, self.hi = p.min(0), p.max(0)
        e = self.hi.astype(np.float64) - self.lo.astype(np.float64)
        cap = M // 4 + 64
        flat = max(e.max() * 1e-3, 1e-6)
        h = np.cbrt(np.prod(np.maximum(e, flat)) * PER_CELL / max(len(live), 1))
        while True:
            c = np.where(e > 0, np.ceil(e / h), 1.0)
            self.n = np.minimum(np.maximum(c, 1.0), MAX_DIM).astype(np.int64)
            if np.prod(self.n) <= cap:
                break
            h *= 1.25
        self.h = np.where(e > 0, e / self.n, 1.0)
        self.inv = np.where(e > 0, self.n / np.where(e > 0, e, 1.0), 0.0)
        self.eps = 1e-9 * (1.0 + np.sum(np.abs(self.lo.astype(np.float64)) + e))
        cell = self.cell_of(p)
        order = np.lexsort((live, cell))
        self.pts = live[order]                  # target indices, cell order
        self.start = np.searchsorted(cell[order],
                                     np.arange(np.prod(self.n) + 1))

    def axis(self, v, i):
        t = (np.asarray(v, np.float64) - np.float64(self.lo[i])) * self.inv[i]
        return np.clip(t, 0.0, self.n[i] - 1).astype(np.int64)

    def cell_of(self, p):
        c = [self.axis(p[..., i], i) for i in range(3)]
        return (c[2] * self.n[1] + c[1]) * self.n[0] + c[0]

    def gap2(self, c, q):
        """cell_gap2: c [n, 3] cells, q [3] world."""
        lo = self.lo.astype(np.float64) + c * self.h
        hi = self.lo.astype(np.float64) + (c + 1) * self.h
        d = np.zeros(c.shape, np.float64)
        d = np.where(c > 0, np.maximum(d, lo - q), d)
        d = np.where(c < self.n - 1, np.maximum(d, q - hi), d)
        return (d * d).sum(-1)

    def beyond(self, cq, sh, q):
        """(any cell outside shells 0..sh, the least distance to one)."""
        L, any_ = np.inf, False
        for i in range(3):
            lo = np.float64(self.lo[i])
            if cq[i] - sh - 1 >= 0:
                any_ = True
                L = min(L, q[i] - (lo + (cq[i] - sh) * self.h[i]))
            if cq[i] + sh + 1 <= self.n[i] - 1:
                any_ = True
                L = min(L, lo + (cq[i] + sh + 1) * self.h[i] - q[i])
        return any_, L


def _reach(B, sd, sk, margin):
    """icp.cu's reach: the distance beyond which every key exceeds B
    (margin=False: the bare distance, sqrt(B))."""
    if not margin:
        return np.sqrt(B)
    return sd + np.sqrt((B + sk) / (1.0 - 2.0 * U))


def cell_nn(cells, qw, center, dst, dst_mask, prev=None, cut=np.inf,
            one_chunk=False, margin=True, max_shells=MAX_SHELLS):
    """icp.cu's 1-NN of live rows at world coordinates qw [N, 3] (float32)
    with the trip's centroid center [3]: (bits int64 [N], idx int64 [N],
    pairs visited, rows that scanned everything).  prev: each row's last
    neighbour (-1: none); cut: max_d2 (a row with nothing below it gets a
    finite stand-in, (max_d2, the lowest live index)).  margin=False prunes
    on the bare distance (a test of the tests)."""
    dst = np.asarray(dst, F32)
    dst_mask = np.asarray(dst_mask, bool)
    c = np.asarray(center, F32)
    N = len(qw)
    out_b = np.zeros(N, np.int64)
    out_i = np.zeros(N, np.int64)
    pairs = full = 0
    near_c = bool((np.abs(c) < HUGE).all())
    if cells.valid:
        e = np.maximum(np.abs(cells.lo.astype(np.float64) - c),
                       np.abs(cells.hi.astype(np.float64) - c))
        rm2 = float((e * e).sum()) * (1.0 + 1e-6)
    for r in range(N):
        q = np.asarray(qw[r], F32)
        qc = q - c
        qn = float(_sq(*qc))
        row = keys(q[None], dst, dst_mask, c)[0]
        best = (KNOKEY, KNOKEY)

        def push(js):
            """TopK<1>::push of every j in js (any order)."""
            nonlocal best, pairs
            js = np.asarray(js, np.int64)
            pairs += len(js)
            if len(js):
                b = row[js]
                j = int(js[b == b.min()].min())
                if int(row[j]) < best[0] or (int(row[j]) == best[0]
                                             and j < best[1]):
                    best = (int(row[j]), j)

        if cells.valid and near_c and bool((np.abs(qc) < HUGE).all()):
            if (prev is not None and 0 <= prev[r] < len(dst)
                    and dst_mask[prev[r]]):
                push([int(prev[r])])
            qd = q.astype(np.float64)
            cq = np.array([int(cells.axis(q[i], i)) for i in range(3)])
            Rq = np.sqrt(qn * (1.0 + 1e-6)) * (1.0 + 1e-6)
            sd = 2.0 * U * (Rq + np.sqrt(rm2)) + 2.0 * cells.eps
            sk = 20.0 * U * (Rq * Rq + rm2)

            def bound():
                B = np.inf if best[0] == KNOKEY else float(
                    np.array(best[0], np.int32).view(F32))
                return cut if cut < B else B

            done = False
            for sh in range(max_shells + 1):
                # the row's own cell is never pruned
                R = np.inf if sh == 0 else _reach(bound(), sd, sk, margin)
                l0 = np.maximum(cq - sh, 0)
                l1 = np.minimum(cq + sh, cells.n - 1)
                g = np.stack(np.meshgrid(*[np.arange(l0[i], l1[i] + 1)
                                           for i in range(3)], indexing="ij"),
                             -1).reshape(-1, 3)
                g = g[np.abs(g - cq).max(1) == sh]
                ids = (g[:, 2] * cells.n[1] + g[:, 1]) * cells.n[0] + g[:, 0]
                filled = cells.start[ids + 1] > cells.start[ids]
                gaps2 = cells.gap2(g, qd)
                for k in np.nonzero(filled)[0]:
                    if not gaps2[k] > R * R:
                        c0, c1 = cells.start[ids[k]], cells.start[ids[k] + 1]
                        push(cells.pts[c0:c1])
                any_, L = cells.beyond(cq, sh, qd)
                if not any_ or L > _reach(bound(), sd, sk, margin):
                    done = True
                    break
            if done:
                if best[0] == KNOKEY:
                    best = (int(np.array(F32(cut)).view(np.int32)),
                            cells.first_live)
                out_b[r], out_i[r] = best
                continue
        full += 1
        ok = np.nonzero(row < KNOKEY)[0]
        push(ok)
        b, i = _rule(np.array([best[0]]), np.array([best[1]]), one_chunk)
        out_b[r], out_i[r] = int(b[0]), int(i[0])
    return out_b, out_i, pairs, full
