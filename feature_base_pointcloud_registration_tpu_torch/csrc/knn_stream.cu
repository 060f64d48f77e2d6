// The streamed exact k-NN on the card.
//
// Stands for the JAX package's `knn` (ops/knn.py): no Pallas kernel but a
// compiled device loop, a lax.scan over map chunks with a running top-k
// merge.  The port's plain version (ops/knn.py::knn_reference) drives that
// loop from the host, a matmul, a top-k and a 2k-column merge a chunk.
//
//   fbpr_knn  one launch a call.  A CTA of kThreads threads takes kQ = 32
//             queries of one query set (blockIdx.y; a batch of sets shares
//             one map or has one map each).  The map streams through
//             shared memory in tiles of kTile points, centred on the set's
//             query centroid as they are staged; warp w scans the w-th
//             eighth of every tile, lane l holding query l's K smallest
//             keys in registers (knn_tile.cuh's TopK).  At the end the 8
//             sorted lists of a query are merged by key in shared memory,
//             and the no-neighbour rule applied.  K 1..16 are template
//             instances.
//
// The centroid comes from the caller (the plain version's own
// `query.mean(-2)` on the card), so both round it alike.
//
// Bound.  Operations: 8 fp32 operations a (query, live map point) pair
// (q . m: 3 multiplies, 2 adds; (|q|^2 + |m|^2) - 2 q.m: 3), over 67
// TFLOP/s; bytes: queries 12 B, map points 13 B, outputs 8 B a slot, read
// or written once.  At the port's shapes (ICP's 4096 x 16384, FPFH's 2048
// x 2048 at K 16) the operations bound it; one thread a query scans M / 8
// points, so a call is latency-bound below ~100 CTAs.
//
// Built without FMA contraction (kernels.SOURCE_FLAGS): the plain version's
// norms and d2 are separate PyTorch operations, each rounded.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#include "knn_tile.cuh"

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kQ = 32;                      // queries a CTA: one a lane
constexpr int kPart = kTile / kWarps;       // points a warp scans a tile

struct KnnArgs {
  const float* query;     // [S, Q, 3]
  const float* center;    // [S, 3]
  const float* map;       // [M, 3] shared, or [S, M, 3]
  const uint8_t* mask;    // [M] or [S, M]
  long long map_stride;   // floats between sets' maps (0: shared)
  long long mask_stride;  // bytes between sets' masks (0: shared)
  int Q;
  int M;
  int one_chunk;          // M == chunk
  float* d2;              // [S, Q, K]
  int* idx;               // [S, Q, K]
};

template <int K>
__global__ void __launch_bounds__(kThreads) knn_kernel(KnnArgs a) {
  // the tile, then (after the last tile) the warps' lists for the merge
  __shared__ __align__(16) unsigned char smem[
      (kTile * 16 > kWarps * kQ * 16 * 8) ? kTile * 16
                                          : kWarps * kQ * 16 * 8];
  float4* tile = reinterpret_cast<float4*>(smem);
  int2* lists = reinterpret_cast<int2*>(smem);   // [kWarps][kQ][K]

  const int set = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int qi = blockIdx.x * kQ + lane;
  const float cx = a.center[3 * set];
  const float cy = a.center[3 * set + 1];
  const float cz = a.center[3 * set + 2];
  const float* map = a.map + set * a.map_stride;
  const uint8_t* mask = a.mask + set * a.mask_stride;

  float qx = 0.0f, qy = 0.0f, qz = 0.0f, qn = 0.0f;
  if (qi < a.Q) {
    const float* q = a.query + (static_cast<long long>(set) * a.Q + qi) * 3;
    qx = q[0] - cx;
    qy = q[1] - cy;
    qz = q[2] - cz;
    qn = sq_norm(qx, qy, qz);
  }
  TopK<K> best;
  best.init();
  for (int base = 0; base < a.M; base += kTile) {
    const int n = min(kTile, a.M - base);
    __syncthreads();
    stage_tile(map, mask, base, base + n, cx, cy, cz, tile, threadIdx.x,
               kThreads);
    __syncthreads();
    const int lo = warp * kPart;
    const int hi = min(n, lo + kPart);
    for (int j = lo; j < hi; ++j) {
      best.push_in_order(d2_bits(qx, qy, qz, qn, tile[j]), base + j);
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < K; ++k) {
    lists[(warp * kQ + lane) * K + k] = make_int2(best.bits[k],
                                                  best.idx[k]);
  }
  __syncthreads();
  if (warp != 0 || qi >= a.Q) return;
  // merge the 8 sorted lists: the next key is the least of their heads
  int head[kWarps];
#pragma unroll
  for (int w = 0; w < kWarps; ++w) head[w] = 0;
  const long long out = (static_cast<long long>(set) * a.Q + qi) * K;
  for (int k = 0; k < K; ++k) {
    int bw = 0;
    int2 bk = lists[lane * K + head[0]];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) {
      const int2 c = lists[(w * kQ + lane) * K + head[w]];
      if (key_less(c.x, c.y, bk.x, bk.y)) {
        bk = c;
        bw = w;
      }
    }
#pragma unroll
    for (int w = 0; w < kWarps; ++w) head[w] += (w == bw);
    int b = bk.x, j = bk.y;
    no_neighbour_rule(a.one_chunk != 0, b, j);
    a.d2[out + k] = __int_as_float(b);
    a.idx[out + k] = j;
  }
}

template <int K>
cudaError_t launch(const KnnArgs& a, int S, cudaStream_t stream) {
  const dim3 grid((a.Q + kQ - 1) / kQ, S);
  knn_kernel<K><<<grid, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// query [S, Q, 3], center [S, 3], map [M, 3] (map_stride 0) or [S, M, 3]
// (map_stride 3 M), mask likewise (mask_stride 0 or M), M >= K; writes d2
// and idx [S, Q, K] (K 1..16).
extern "C" int fbpr_knn(const float* query, const float* center,
                        const float* map, const uint8_t* mask,
                        long long map_stride, long long mask_stride, int S,
                        int Q, int M, int one_chunk, int K, float* d2,
                        int* idx, void* stream) {
  if (S < 0 || S > 65535 || Q < 0 || M < K || K < 1 || K > 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (S == 0 || Q == 0) return static_cast<int>(cudaSuccess);
  const KnnArgs a{query, center, map, mask, map_stride, mask_stride, Q, M,
                  one_chunk, d2, idx};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaErrorInvalidValue;
  switch (K) {
    case 1: rc = launch<1>(a, S, st); break;
    case 2: rc = launch<2>(a, S, st); break;
    case 3: rc = launch<3>(a, S, st); break;
    case 4: rc = launch<4>(a, S, st); break;
    case 5: rc = launch<5>(a, S, st); break;
    case 6: rc = launch<6>(a, S, st); break;
    case 7: rc = launch<7>(a, S, st); break;
    case 8: rc = launch<8>(a, S, st); break;
    case 9: rc = launch<9>(a, S, st); break;
    case 10: rc = launch<10>(a, S, st); break;
    case 11: rc = launch<11>(a, S, st); break;
    case 12: rc = launch<12>(a, S, st); break;
    case 13: rc = launch<13>(a, S, st); break;
    case 14: rc = launch<14>(a, S, st); break;
    case 15: rc = launch<15>(a, S, st); break;
    case 16: rc = launch<16>(a, S, st); break;
  }
  return static_cast<int>(rc);
}
