// The streamed exact k-NN on the card.
//
// Stands for the JAX package's `knn` (ops/knn.py): no Pallas kernel but a
// compiled device loop, a lax.scan over map chunks with a running top-k
// merge.  The port's plain version (ops/knn.py::knn_reference) drives that
// loop from the host, a matmul, a top-k and a 2k-column merge a chunk.
//
//   fbpr_knn  one launch a call.  A CTA of kThreads threads (8 warps)
//             takes 32 qpt(K) queries of one query set (blockIdx.y; a
//             batch of sets shares one map or has one map each), every
//             warp all of them, qpt(K) = 2 or 1 a lane, and one of C
//             splits of the map: C CTAs, a thread-block cluster, share a
//             query tile, C from the shapes so that the CTAs fill the SMs
//             four times over (up to kMaxCluster).  The map is cut into
//             groups of
//             kGroup slots; split s holds the groups g = s (mod C) and its
//             warp w every 8th of them (the masked tail of a padded map
//             spreads over every split and warp).  A warp streams its
//             groups on its own (no CTA barrier): it loads a group's slots
//             into registers, compacts the live points into its
//             shared-memory buffer, centred on the set's query centroid (a
//             ballot and a popcount a step), and scans them while the next
//             group's slots load; each lane keeps its queries' K smallest
//             keys in registers (knn_tile.cuh's TopK; a warp's points come
//             in index order, so push_in_order's tie rule holds).  The 8
//             warps' lists are merged in 3 steps (warp w takes warp w +
//             d's, d = 4, 2, 1; TopK::push, exact by key; where one chunk
//             leaves the masked slots in, each warp's lowest K join its
//             lists first at 3e38), then the cluster's lists are merged
//             through distributed shared memory in log2(C) steps (rank r
//             takes rank r + d's), and rank 0 applies the no-neighbour
//             rule and writes.  K 1..16 are template instances.
//
// The result is the least K keys (d2 bits, index) over the map's live
// points, whose keys never equal kNoKey (a NaN key is never taken), with
// the lowest masked slots at 3e38 where one chunk leaves them in
// (knn_tile.cuh), as the parent's one-CTA-a-query-tile scan gave it: the
// selection is exact by key, so a split, a compaction or a merge order
// changes no bit.
//
// The centroid comes from the caller (the plain version's own
// `query.mean(-2)` on the card), so both round it alike.
//
// Bound.  Operations: 8 fp32 operations a (query, live map point) pair
// (q . m: 3 multiplies, 2 adds; (|q|^2 + |m|^2) - 2 q.m: 3), over 67
// TFLOP/s; bytes: queries 12 B, map points 13 B, outputs 8 B a slot, read
// or written once.  At the port's shapes (ICP's 4096 x 16384, FPFH's 2048
// x 2048 at K 16) the operations bound it; a (query, point) pair is ~15
// dependent instructions, so the design keeps 2 independent chains a
// thread and spreads the map over the cluster's CTAs.
//
// Built without FMA contraction (kernels.SOURCE_FLAGS): the plain version's
// norms and d2 are separate PyTorch operations, each rounded.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

#include "knn_tile.cuh"

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 64;                  // map slots a warp stages at once
constexpr int kMaxCluster = 16;             // above 8: non-portable
constexpr int kListSlots = 16;              // map slots a list, per key kept

// queries a lane, each an independent chain a staged point: 2 up to K = 8,
// 1 above (the lists live in registers)
__host__ __device__ constexpr int qpt(int K) { return K <= 8 ? 2 : 1; }

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
  int splits;             // C, the cluster's CTAs
  float* d2;              // [S, Q, K]
  int* idx;               // [S, Q, K]
};

// A group's slots of this lane: slot g * kGroup + lane + 32 i.
struct Slots {
  float x[2], y[2], z[2];
  bool live[2];
};

__device__ __forceinline__ void load_slots(const float* map,
                                           const uint8_t* mask, int g, int M,
                                           int lane, Slots& s) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = g * kGroup + i * 32 + lane;
    s.live[i] = j < M && mask[j];
    s.x[i] = s.live[i] ? map[3 * j] : 0.0f;
    s.y[i] = s.live[i] ? map[3 * j + 1] : 0.0f;
    s.z[i] = s.live[i] ? map[3 * j + 2] : 0.0f;
  }
}

// Push another sorted list (`from`) into each of the lane's queries' lists,
// up to its first kNoKey or its first key that a list rejects (the later
// ones, larger, are rejected too).
template <int K>
__device__ __forceinline__ void take_lists(TopK<K> (&best)[qpt(K)],
                                           const int2* from, int lane) {
#pragma unroll
  for (int u = 0; u < qpt(K); ++u) {
    const int2* o = from + (u * 32 + lane) * K;
    for (int k = 0; k < K; ++k) {
      const int2 e = o[k];
      if (e.x == kNoKey ||
          !key_less(e.x, e.y, best[u].bits[K - 1], best[u].idx[K - 1])) {
        break;
      }
      best[u].push(e.x, e.y);
    }
  }
}

template <int K>
__device__ __forceinline__ void put_lists(const TopK<K> (&best)[qpt(K)],
                                          int2* to, int lane) {
#pragma unroll
  for (int u = 0; u < qpt(K); ++u) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      to[(u * 32 + lane) * K + k] = make_int2(best[u].bits[k],
                                              best[u].idx[k]);
    }
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads) knn_kernel(KnnArgs a) {
  constexpr int kQpt = qpt(K);
  constexpr int kQ = 32 * kQpt;     // queries a CTA
  // the warps' staging buffers, then (after the scan) the merge's lists
  constexpr int kTileBytes = kWarps * 2 * kGroup * (16 + 4);
  constexpr int kListBytes = (kWarps / 2) * kQ * K * 8;
  __shared__ __align__(16) unsigned char smem[
      kTileBytes > kListBytes ? kTileBytes : kListBytes];
  __shared__ int masked[kWarps][K];   // each warp's lowest masked slots

  const int C = a.splits;
  const int split = blockIdx.x % C;   // the CTA's rank in its cluster
  const int qtile = blockIdx.x / C;
  const int set = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const float cx = a.center[3 * set];
  const float cy = a.center[3 * set + 1];
  const float cz = a.center[3 * set + 2];
  const float* map = a.map + set * a.map_stride;
  const uint8_t* mask = a.mask + set * a.mask_stride;

  float qx[kQpt], qy[kQpt], qz[kQpt], qn[kQpt];
  TopK<K> best[kQpt];
#pragma unroll
  for (int u = 0; u < kQpt; ++u) {
    const int qi = qtile * kQ + u * 32 + lane;
    qx[u] = qy[u] = qz[u] = qn[u] = 0.0f;
    if (qi < a.Q) {
      const float* q =
          a.query + (static_cast<long long>(set) * a.Q + qi) * 3;
      qx[u] = q[0] - cx;
      qy[u] = q[1] - cy;
      qz[u] = q[2] - cz;
      qn[u] = sq_norm(qx[u], qy[u], qz[u]);
    }
    best[u].init();
  }

  // ---- the warp's groups: g = split + C (warp + kWarps i) ----
  float4* tile = reinterpret_cast<float4*>(smem) + warp * 2 * kGroup;
  int* tidx = reinterpret_cast<int*>(smem + kWarps * 2 * kGroup * 16) +
              warp * 2 * kGroup;
  const int groups = (a.M + kGroup - 1) / kGroup;
  const int step = C * kWarps;
  int g = split + C * warp;
  Slots next;
  if (g < groups) load_slots(map, mask, g, a.M, lane, next);
  int n_masked = 0;   // the warp's masked slots kept (one chunk), <= K
  for (int buf = 0; g < groups; g += step, buf ^= 1) {
    float4* t = tile + buf * kGroup;
    int* ti = tidx + buf * kGroup;
    int n = 0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int slot = g * kGroup + i * 32 + lane;
      if (a.one_chunk && n_masked < K) {
        // the warp's lowest K masked slots, in index order
        const bool off = slot < a.M && !next.live[i];
        const unsigned mb = __ballot_sync(0xffffffffu, off);
        const int r = n_masked + __popc(mb & ((1u << lane) - 1u));
        if (off && r < K) masked[warp][r] = slot;
        n_masked = min(K, n_masked + __popc(mb));
      }
      const unsigned bal = __ballot_sync(0xffffffffu, next.live[i]);
      if (next.live[i]) {
        const int pos = n + __popc(bal & ((1u << lane) - 1u));
        const float x = next.x[i] - cx, y = next.y[i] - cy,
                    z = next.z[i] - cz;
        t[pos] = make_float4(x, y, z, sq_norm(x, y, z));
        ti[pos] = slot;
      }
      n += __popc(bal);
    }
    __syncwarp();
    if (g + step < groups) load_slots(map, mask, g + step, a.M, lane, next);
#pragma unroll 2
    for (int p = 0; p < n; ++p) {
      const float4 m = t[p];
      const int j = ti[p];
#pragma unroll
      for (int u = 0; u < kQpt; ++u) {
        // d2_bits on a live point: its masked branch never taken
        const float cross = qx[u] * m.x + qy[u] * m.y + qz[u] * m.z;
        best[u].push_in_order(
            __float_as_int(clamp0((qn[u] + m.w) - 2.0f * cross)), j);
      }
    }
  }

  // one chunk: the warp's lowest K masked slots join its lists at 3e38 (a
  // split's lowest K are among its warps')
  __syncwarp();
  for (int r = 0; r < n_masked; ++r) {
#pragma unroll
    for (int u = 0; u < kQpt; ++u) {
      best[u].push(__float_as_int(kBig), masked[warp][r]);
    }
  }

  // ---- the warps' lists into warp 0's ----
  int2* lists = reinterpret_cast<int2*>(smem);
  __syncthreads();   // the staging buffers are free
  for (int d = kWarps / 2; d > 0; d >>= 1) {
    if (warp >= d && warp < 2 * d) {
      put_lists<K>(best, lists + (warp - d) * kQ * K, lane);
    }
    __syncthreads();
    if (warp < d) take_lists<K>(best, lists + warp * kQ * K, lane);
    __syncthreads();
  }

  if (C > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    if (warp == 0) put_lists<K>(best, lists, lane);
    cluster.sync();
    for (int d = 1; d < C; d <<= 1) {
      if (warp == 0 && (split & (2 * d - 1)) == 0 && split + d < C) {
        take_lists<K>(best, cluster.map_shared_rank(lists, split + d), lane);
        put_lists<K>(best, lists, lane);
      }
      cluster.sync();
    }
  }
  if (split != 0 || warp != 0) return;
#pragma unroll
  for (int u = 0; u < kQpt; ++u) {
    const int qi = qtile * kQ + u * 32 + lane;
    if (qi >= a.Q) continue;
    const long long out = (static_cast<long long>(set) * a.Q + qi) * K;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      int b = best[u].bits[k], j = best[u].idx[k];
      no_neighbour_rule(a.one_chunk != 0, b, j);
      a.d2[out + k] = __int_as_float(b);
      a.idx[out + k] = j;
    }
  }
}

// C: the least power of two (up to kMaxCluster) whose query tiles x splits
// fill the SMs four times over, each split at least two groups a warp and
// each warp's list at least kListSlots map slots a key it keeps (a list
// takes K pushes at least, so more lists cost more at large K).
template <int K>
cudaError_t plan_splits(int S, int Q, int M, int* C) {
  int dev = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return rc;
  const int q_cta = 32 * qpt(K);
  const long long tiles = static_cast<long long>((Q + q_cta - 1) / q_cta) * S;
  const int groups = (M + kGroup - 1) / kGroup;
  int c = 1;
  while (c < kMaxCluster && tiles * c < 4LL * sms &&
         groups / (2 * c) >= kWarps &&
         M / (2 * c * kWarps) >= kListSlots * K) {
    c *= 2;
  }
  *C = c;
  return cudaSuccess;
}

// Sets the attribute a cluster of more than 8 CTAs needs (once a kernel).
template <int K>
cudaError_t allow_large_clusters() {
  static const cudaError_t e = cudaFuncSetAttribute(
      knn_kernel<K>, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

template <int K>
cudaError_t launch(KnnArgs a, int S, cudaStream_t stream) {
  const cudaError_t rc = plan_splits<K>(S, a.Q, a.M, &a.splits);
  if (rc != cudaSuccess) return rc;
  const int C = a.splits;
  const int q_cta = 32 * qpt(K);
  const dim3 grid(((a.Q + q_cta - 1) / q_cta) * C, S);
  if (C == 1) {
    knn_kernel<K><<<grid, kThreads, 0, stream>>>(a);
    return cudaGetLastError();
  }
  if (C > 8) {
    const cudaError_t e = allow_large_clusters<K>();
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, knn_kernel<K>, a);
  return e != cudaSuccess ? e : cudaGetLastError();
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
                  one_chunk, 1, d2, idx};
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
