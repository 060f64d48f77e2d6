// Candidate fetch against a row-compacted ("resident") block table.
//
// Replaces the TPU kernel `_resident_kernel` behind `fused_resident_fetch`
// (the JAX package's ops/pallas_fetch.py).  There the compacted table sat
// whole in VMEM and each query's row was a dynamic-slice load, with a
// group of 32 queries skipped whole when none was live.  A block's 227 KB
// of shared memory cannot hold the compact tables of a real map (1-8 MB),
// but the H100's 50 MB L2 holds them many times over: here a tile of
// queries copies each of its distinct rows once from L2 into shared memory
// and serves every query on that row from there; a tile with no live query
// reads no row (csrc/fetch_tile.cuh holds the design and the contract,
// shared with block_fetch.cu).
//
// What bounds it on the H100.  The per-query kernel this replaces (a warp
// per query, the row's distances in registers from 16-byte loads, K
// passes of a shuffle-tree warp arg-min) took the same time with every
// live query on one cached row, and its time grew with K: the selection
// bound it, not the row reads.  The tile keeps its K register passes with
// the arg-min on warp reductions; they still bound it (PERF.md, probe
// split).

// Contract: fetch_tile.cuh, with W = 128 * NV, NV in 1..4, the widths the
// compact tables take (ops/fetch.py::resident_fetch_reference is the plain
// version); other widths are refused.

#include "fetch_tile.cuh"

extern "C" int fbpr_resident_fetch(const float* table, int64_t rows, int W,
                                   const int* bcell, const float* qx,
                                   const float* qy, const float* qz,
                                   int64_t Q, int K, float* d2, float* cand,
                                   void* stream) {
  if (W % 128 != 0 || W < 128 || W > 512) return (int)cudaErrorInvalidValue;
  return fbpr::fetch_tile(table, rows, W, bcell, qx, qy, qz, Q, K, d2, cand,
                          stream);
}
