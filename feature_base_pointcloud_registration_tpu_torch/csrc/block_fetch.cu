// Candidate fetch: exact top-K of each query's hash-grid block row, on a
// raw block table (any W).
//
// Replaces the TPU kernel `_fetch_kernel` behind `fused_block_fetch` (the
// JAX package's ops/pallas_fetch.py), which DMA'd each query's row into
// VMEM in double-buffered waves.  Its FBPR_FETCH_DEDUP option skipped a
// DMA when consecutive queries shared a row; here a tile of queries always
// reads each distinct row once (csrc/fetch_tile.cuh holds the design and
// the contract, shared with resident_fetch.cu).
//
// What bounds it on the H100.  The per-query kernel this replaces (a warp
// per query reading its row from L2, per-lane insertion lists merged by K
// warp arg-mins) read ~4.7 GB of rows for the round-1 surf queries, but
// took the same time with every live query on one cached row, and its
// time grew with K: the selection bound it.  The tile reads each distinct
// (tile, row) pair's row once and selects with K register passes on
// warp reductions; the K passes still bound it (PERF.md, probe split).

// Contract: fetch_tile.cuh (ops/fetch.py::block_fetch_reference is the
// plain version).

#include "fetch_tile.cuh"

extern "C" int fbpr_block_fetch(const float* table, int64_t rows, int W,
                                const int* bcell, const float* qx,
                                const float* qy, const float* qz, int64_t Q,
                                int K, float* d2, float* cand, void* stream) {
  return fbpr::fetch_tile(table, rows, W, bcell, qx, qy, qz, Q, K, d2, cand,
                          stream);
}
