// Tiled candidate fetch shared by block_fetch.cu and resident_fetch.cu:
// exact top-K of each query's block row, each distinct row read once per
// tile of queries.
//
// Contract (ops/fetch.py::block_fetch_reference is the plain version):
//   table [R, 3*W] plane-major rows [x(W) | y(W) | z(W)], FAR=1e9 padding,
//   row R-1 the all-FAR sentinel; bcell [Q] int32; qx/qy/qz [Q].
//   d2 [Q, K] ascending, ties -> lowest slot, d2 > 1e17 reported as 3e38;
//   cand [3K, Q] plane-major (x rows 0..K-1, then y, then z).
//   A sentinel query reads no row: d2 = 3e38 and zero coordinates.  An
//   out-of-range id poisons its result with NaN instead of reading out of
//   bounds.  d2 = (dx*dx + dy*dy) + dz*dz with explicit round-to-nearest
//   intrinsics, so no FMA contraction: bitwise equal to the eager PyTorch
//   version.
//
// Design.  A block takes a tile of kTile consecutive queries.
//   1. Threads 0..kTile-1 load the tile's ids and coordinates, write the
//      results of sentinel and out-of-range queries at once, and vote; a
//      tile with no live query writes its results and reads no row.
//   2. Each live query ranks its (row, query) key against the tile's keys:
//      the live queries in row order, and a warp-ballot prefix over the
//      row changes gives the tile's distinct rows ("segments") and each
//      sorted query's segment.
//   3. The distinct rows go through a shared-memory buffer of nb rows
//      (about kRowBytes) in rounds: the block copies a round's rows with
//      16-byte cp.async (scalar loads where the table is not 16-byte
//      aligned), waits, then the warps take the round's sorted queries
//      round-robin, whatever row each is on.  A warp owns a query: lane l
//      holds the distances of slots l, l+32, ... in registers, and K passes
//      each take the warp's smallest untaken (d2, slot) with two warp
//      reductions (`topk_chunk`).
//   4. The tile's results, staged in shared memory, go out in contiguous
//      runs of the [Q, K] and [3K, Q] outputs.
//
// What bounds it on the H100 (chip_smoke.py's probes, PERF.md).  The
// per-query kernels this replaces read ~4.7 GB of rows from L2 for the
// round-1 surf queries, yet took the same time with every live query on
// one cached row: the selection bound them, not the row reads.  The tile
// reads 4.5x fewer row bytes (each distinct (tile, row) pair once), and the
// selection is the cheaper of the two kernels' former selections (K
// register passes, measured against the per-lane insertion lists in this
// design), with each pass's warp arg-min on redux.sync instead of a
// five-level shuffle tree.  What is left is still the K passes: the time
// grows ~0.17-0.19 ms per unit of K at the surf shapes, the row copies
// are ~9% and the writes alone ~0.12 ms; the bytes the function must move
// (table, ids and coordinates once, outputs once) bound it at ~0.1 ms.
// Tiles of 128: a larger tile saves little more row traffic than the
// row copies now cost, a smaller one reads rows again.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace fbpr {
// Internal linkage: block_fetch.cu and resident_fetch.cu build into two
// libraries loaded into one process, and each must keep its own kernels
// and its own once-per-device flags (a function-local static of an inline
// template would otherwise be one object shared by both libraries).
namespace {

constexpr int kTile = 128;            // queries per block (kernels.FETCH_TILE)
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowBytes = 48 * 1024;  // row buffer per block, about
constexpr float kBig = 3.0e38f;

// Shared-memory layout (bytes from the dynamic base; rows first, so the
// cp.async destinations are 16-byte aligned).
struct TileLayout {
  int nb;         // rows per round
  size_t rows;    // float [nb][3W]
  size_t d2;      // float [kTile][K]
  size_t nn;      // float [3][K][kTile]
  size_t q;       // float [3][kTile]
  size_t ints;    // int: bc[kTile], sq[kTile], pseg[kTile], seg[kTile+1],
                  //      segrow[kTile], wsum[kWarps]
  size_t total;
  __host__ __device__ TileLayout(int W, int K) {
    const size_t row = 12 * (size_t)W;
    nb = (int)(kRowBytes / row);
    nb = nb < 1 ? 1 : (nb > kTile ? kTile : nb);
    rows = 0;
    d2 = rows + nb * row;
    nn = d2 + 4 * (size_t)kTile * K;
    q = nn + 12 * (size_t)kTile * K;
    ints = q + 12 * (size_t)kTile;
    total = ints + 4 * (size_t)(5 * kTile + 1 + kWarps);
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The warp's smallest (u, s) over the lanes' pairs, u first, then s.  A
// distance's bits order like unsigned ints (a distance is >= 0, +inf or
// NaN, and NaN sorts last as in the plain version's sort), so two warp
// reductions (one instruction each on sm_80+) take the place of a
// five-level shuffle tree.
__device__ __forceinline__ void warp_argmin(unsigned u, int s, unsigned& mu,
                                            int& ms) {
  mu = __reduce_min_sync(0xffffffffu, u);
  ms = (int)__reduce_min_sync(0xffffffffu, u == mu ? (unsigned)s : 0xffffffffu);
}

constexpr unsigned kNone = 0xffffffffu;  // no slot: above every distance

// Top-K of the chunk of 32*R slots from c0 (lane l holds slots
// c0 + l + 32 r): K passes, each taking the warp's smallest untaken
// (d2, slot); lane k receives the k-th.  A lane's registers ascend in
// slot, so its strict < keeps the lowest slot of a tie.
template <int K, int R>
__device__ __forceinline__ void topk_chunk(const float* X, int W, int c0,
                                           float x, float y, float z,
                                           int lane, unsigned& kd, int& ks) {
  const float* Y = X + W;
  const float* Z = Y + W;
  unsigned du[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int s = c0 + lane + 32 * r;
    du[r] = kNone;
    if (s < W) {
      const float dx = __fsub_rn(X[s], x);
      const float dy = __fsub_rn(Y[s], y);
      const float dz = __fsub_rn(Z[s], z);
      du[r] = __float_as_uint(__fadd_rn(
          __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
          __fmul_rn(dz, dz)));
    }
  }
  unsigned taken = 0u;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    unsigned bu = kNone;
    int br = -1;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (!((taken >> r) & 1u) && du[r] < bu) {
        bu = du[r];
        br = r;
      }
    }
    const int bs = br >= 0 ? c0 + lane + 32 * br : 0x7fffffff;
    unsigned mu;
    int ms;
    warp_argmin(bu, bs, mu, ms);
    if (br >= 0 && bs == ms) taken |= 1u << br;  // slots are lane-unique
    if (lane == k) {
      kd = mu;
      ks = ms;
    }
  }
}

// Top-K of a whole row; lane k < K receives the k-th (d2 bits, slot).  A
// row wider than one chunk (raw tables with W > 512) takes its chunks in
// turn, each chunk's list merged into the kept one by the same K passes
// over one candidate a lane (the kept list in lanes 0..K-1, the chunk's in
// lanes K..2K-1).
template <int K, int R>
__device__ __forceinline__ void topk_row(const float* X, int W, float x,
                                         float y, float z, int lane,
                                         unsigned& kd, int& ks) {
  kd = kNone;
  ks = 0x7fffffff;
  topk_chunk<K, R>(X, W, 0, x, y, z, lane, kd, ks);
  for (int c0 = 32 * R; c0 < W; c0 += 32 * R) {
    unsigned cd = kNone;
    int cs = 0x7fffffff;
    topk_chunk<K, R>(X, W, c0, x, y, z, lane, cd, cs);
    const int src = (lane + 32 - K) & 31;
    const unsigned ud = __shfl_sync(0xffffffffu, cd, src);
    const int us = __shfl_sync(0xffffffffu, cs, src);
    const unsigned u = lane < K ? kd : (lane < 2 * K ? ud : kNone);
    const int s = lane < K ? ks : (lane < 2 * K ? us : 0x7fffffff);
    bool taken = false;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      unsigned mu;
      int ms;
      warp_argmin(taken ? kNone : u, taken ? 0x7fffffff : s, mu, ms);
      if (!taken && s == ms && u == mu) taken = true;
      if (lane == k) {
        kd = mu;
        ks = ms;
      }
    }
  }
}

template <int K, int R>
__global__ void __launch_bounds__(kThreads)
fetch_tile_kernel(const float* __restrict__ table, int64_t rows, int W,
                  const int* __restrict__ bcell,
                  const float* __restrict__ qx,
                  const float* __restrict__ qy,
                  const float* __restrict__ qz, int64_t Q,
                  float* __restrict__ d2_out, float* __restrict__ cand) {
  extern __shared__ __align__(16) unsigned char smem[];
  const TileLayout L(W, K);
  float* s_rows = reinterpret_cast<float*>(smem + L.rows);
  float* s_d2 = reinterpret_cast<float*>(smem + L.d2);   // [j*K + k]
  float* s_nn = reinterpret_cast<float*>(smem + L.nn);   // [(p*K+k)*kTile + j]
  float* s_q = reinterpret_cast<float*>(smem + L.q);     // [c*kTile + j]
  int* s_bc = reinterpret_cast<int*>(smem + L.ints);     // row or INT_MAX
  int* s_sq = s_bc + kTile;        // sorted position -> tile query
  int* s_pseg = s_sq + kTile;      // sorted position -> segment
  int* s_seg = s_pseg + kTile;     // segment -> first sorted position
  int* s_segrow = s_seg + kTile + 1;
  int* s_wsum = s_segrow + kTile;

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int64_t q0 = (int64_t)blockIdx.x * kTile;
  const int nq = (int)min((int64_t)kTile, Q - q0);
  const int64_t sentinel = rows - 1;
  const int W3 = 3 * W;

  // 1. ids and coordinates; sentinel and out-of-range queries done here
  int live = 0;
  int row = 0x7fffffff;
  if (t < kTile) {
    if (t < nq) {
      const int64_t r = bcell[q0 + t];
      if (r >= 0 && r < sentinel) {
        live = 1;
        row = (int)r;
        s_q[t] = qx[q0 + t];
        s_q[kTile + t] = qy[q0 + t];
        s_q[2 * kTile + t] = qz[q0 + t];
      } else {
        const bool bad = r != sentinel;
#pragma unroll
        for (int k = 0; k < K; ++k) {
          s_d2[t * K + k] = bad ? NAN : kBig;
#pragma unroll
          for (int p = 0; p < 3; ++p)
            s_nn[(p * K + k) * kTile + t] = bad ? NAN : 0.0f;
        }
      }
    }
    s_bc[t] = row;
  }
  const int nlive = __syncthreads_count(live);

  if (nlive > 0) {
    // 2. live queries in (row, query) order; segments of equal rows
    if (live) {
      int rank = 0;
      for (int u = 0; u < kTile; ++u) {
        const int b = s_bc[u];
        rank += (b < row) | ((b == row) & (u < t));
      }
      s_sq[rank] = t;
    }
    __syncthreads();
    int head = 0;
    int prow = 0;
    if (t < nlive) {
      prow = s_bc[s_sq[t]];
      head = t == 0 || prow != s_bc[s_sq[t - 1]];
    }
    const unsigned ball = __ballot_sync(0xffffffffu, head);
    if (lane == 0) s_wsum[warp] = __popc(ball);
    __syncthreads();
    int before = 0;
    for (int w = 0; w < warp; ++w) before += s_wsum[w];
    int nseg = 0;
    for (int w = 0; w < kWarps; ++w) nseg += s_wsum[w];
    if (t < nlive) {
      const int seg = before + __popc(ball & ((2u << lane) - 1u)) - 1;
      s_pseg[t] = seg;
      if (head) {
        s_seg[seg] = t;
        s_segrow[seg] = prow;
      }
    }
    if (t == 0) s_seg[nseg] = nlive;
    __syncthreads();

    // 3. the distinct rows in rounds of nb through shared memory
    const bool vec = (W & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(table) & 15) == 0;
    for (int s0 = 0; s0 < nseg; s0 += L.nb) {
      const int s1 = min(nseg, s0 + L.nb);
      if (vec) {
        const int per = W3 / 4;
        for (int i = t; i < (s1 - s0) * per; i += kThreads) {
          const int s = i / per, o = i - s * per;
          cp_async16(s_rows + (size_t)s * W3 + 4 * o,
                     table + (int64_t)s_segrow[s0 + s] * W3 + 4 * o);
        }
        cp_async_wait_all();
      } else {
        for (int i = t; i < (s1 - s0) * W3; i += kThreads) {
          const int s = i / W3, o = i - s * W3;
          s_rows[(size_t)s * W3 + o] =
              table[(int64_t)s_segrow[s0 + s] * W3 + o];
        }
      }
      __syncthreads();

      for (int p = s_seg[s0] + warp; p < s_seg[s1]; p += kWarps) {
        const int j = s_sq[p];
        const float* X = s_rows + (size_t)(s_pseg[p] - s0) * W3;
        const float x = s_q[j], y = s_q[kTile + j], z = s_q[2 * kTile + j];
        unsigned kd;
        int ks;
        topk_row<K, R>(X, W, x, y, z, lane, kd, ks);
        if (lane < K) {
          const float d = __uint_as_float(kd);
          const int sl = ks < W ? ks : 0;  // no slot: not reached, W >= K
          s_d2[j * K + lane] = d > 1e17f ? kBig : d;
          s_nn[lane * kTile + j] = X[sl];
          s_nn[(K + lane) * kTile + j] = X[W + sl];
          s_nn[(2 * K + lane) * kTile + j] = X[2 * W + sl];
        }
      }
      __syncthreads();  // the next round overwrites the row buffer
    }
  }

  // 4. the tile's results in contiguous runs
  __syncthreads();
  for (int i = t; i < kTile * K; i += kThreads) {
    if (i / K < nq) d2_out[q0 * K + i] = s_d2[i];
  }
  for (int i = t; i < 3 * K * kTile; i += kThreads) {
    const int r = i / kTile, j = i - r * kTile;
    if (j < nq) cand[(int64_t)r * Q + q0 + j] = s_nn[i];
  }
}

// Shared memory a block may take (the card's 227 KB).  Rows above 4096 slots
// go one per round, so a block takes 12*W + 16*kTile*K + 12*kTile +
// 4*(5*kTile + 1 + kWarps) bytes: at K=16 that fits for W up to kMaxW
// (228,900 B at W=16000; kernels.BLOCK_FETCH_MAX_W).
constexpr int kMaxSmem = 227 * 1024;
constexpr int kMaxW = 16000;

template <int K, int R>
int launch_fetch_tile(const float* table, int64_t rows, int W,
                      const int* bcell, const float* qx, const float* qy,
                      const float* qz, int64_t Q, float* d2, float* cand,
                      cudaStream_t stream) {
  const TileLayout L(W, K);
  if (L.total > 48 * 1024) {
    // The limit is raised to the card's maximum once per instance and
    // device, not at every launch.
    static unsigned long long raised = 0;  // bit d: done on device d
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= 64) return (int)cudaErrorInvalidDevice;
    if (!(__atomic_load_n(&raised, __ATOMIC_ACQUIRE) & (1ull << dev))) {
      e = cudaFuncSetAttribute(fetch_tile_kernel<K, R>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxSmem);
      if (e != cudaSuccess) return (int)e;
      __atomic_fetch_or(&raised, 1ull << dev, __ATOMIC_RELEASE);
    }
  }
  const int64_t blocks = (Q + kTile - 1) / kTile;
  fetch_tile_kernel<K, R><<<(unsigned)blocks, kThreads, L.total, stream>>>(
      table, rows, W, bcell, qx, qy, qz, Q, d2, cand);
  return (int)cudaGetLastError();
}

// Slots a lane holds per chunk: W up to 512 in one chunk, wider rows in
// chunks of 512.
template <int K>
int launch_fetch_tile_w(const float* table, int64_t rows, int W,
                        const int* bcell, const float* qx, const float* qy,
                        const float* qz, int64_t Q, float* d2, float* cand,
                        cudaStream_t s) {
  if (W <= 128)
    return launch_fetch_tile<K, 4>(table, rows, W, bcell, qx, qy, qz, Q, d2, cand, s);
  if (W <= 256)
    return launch_fetch_tile<K, 8>(table, rows, W, bcell, qx, qy, qz, Q, d2, cand, s);
  if (W <= 384)
    return launch_fetch_tile<K, 12>(table, rows, W, bcell, qx, qy, qz, Q, d2, cand, s);
  return launch_fetch_tile<K, 16>(table, rows, W, bcell, qx, qy, qz, Q, d2, cand, s);
}

// K dispatch for both C entry points.
inline int fetch_tile(const float* table, int64_t rows, int W,
                      const int* bcell, const float* qx, const float* qy,
                      const float* qz, int64_t Q, int K, float* d2,
                      float* cand, void* stream) {
  if (Q <= 0) return 0;
  if (W < K || W > kMaxW) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 6: return launch_fetch_tile_w<6>(table, rows, W, bcell, qx, qy, qz, Q, d2, cand, s);
    case 8: return launch_fetch_tile_w<8>(table, rows, W, bcell, qx, qy, qz, Q, d2, cand, s);
    case 16: return launch_fetch_tile_w<16>(table, rows, W, bcell, qx, qy, qz, Q, d2, cand, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace fbpr
