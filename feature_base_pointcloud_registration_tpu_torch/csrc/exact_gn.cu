// The exact solver's Gauss-Newton loop on the card: a cluster of C CTAs
// runs a whole `register_scan` solve for one lane, its exact 5-NN, its fits
// and its solve, in one launch with no host read.
//
// Stands for the device loop of the JAX package's `register_core`
// (ops/register.py: the `lax.while_loop(cond, body)` behind
// `register_scan`), which the port drove from the host: a few dozen
// operations and one host read an iteration.  The plain version is
// ops/exact_gn.py::exact_gn_reference, that loop (ops/register.py::
// register_core on ops/knn.py's exact 5-NN).
//
// Per lane, up to `iters` iterations while its feature gate holds (live
// corner features > edge_min_valid, live surf > surf_min_valid) and it has
// not converged:
//   1. the world point of every feature slot at the lane's pose, in
//      world_components' order, ((R0 x + R1 y) + R2 z) + t;
//   2. for the corner and the surf set, the query centroid: the mean of all
//      P slots' world points, masked ones too, as ops/knn.py's
//      `query.mean(-2)`, summed in the order of ATen's CUDA reduction (so
//      the centred d2 are the plain k-NN's on the card bit for bit);
//   3. each live feature's exact 5-NN among its kind's live map points, with
//      knn_tile.cuh's centred d2 and (bits, index) keys, ties to the lower
//      index;
//   4. the line and plane fits of ops/correspondence.py::_from_knn
//      (gn_tile.cuh's corner_fit / surf_fit in kXla mode, all five
//      neighbours taken, d5max the k-NN's own largest d2) and the point's
//      Jacobian row.  A point whose five d2 are not all below 1 m^2 fails
//      the 5th-NN gate, and the plain version adds exact zeros for it; so
//      does the kernel, by skipping its fit.  That covers NaN and the
//      no-neighbour slots of a map with fewer than five live points (d2
//      3e38 in `knn`, whichever index, 0 or the lowest masked slot, fills
//      them): their coordinates never reach a sum;
//   5. the 28 sums of G = J J^T in a fixed order (warp reduce-scatter, the
//      warps in order, the CTAs in rank order through distributed shared
//      memory), so every CTA holds bitwise the same G;
//   6. gn_step.cuh's step_warp: the converged cyclic Jacobi, the projector
//      at the lane's iteration 0, the update and the convergence test.
//
// Layouts (ops/exact_gn.py checks them): pose [B, 6]; corner features
// cxyz [B, Pc, 3], cmask [B, Pc] (bool), surf likewise; the maps cmap
// [Mc, 3] / cmmask [Mc] shared by every lane (stride 0) or [B, Mc, 3] /
// [B, Mc] one a lane (stride Mc), surf likewise; scratch int32 [B, Pc + Ps
// + Mc + Ms], the lane's four compacted lists; stat [B, 16] out, gn_round's
// slots ([0:6] pose, [6] iterations, [7] converged, [8] is_degenerate, [9]
// feature gate, [10] n_corr, the rest 0).  nn_idx / nn_d2 [B, Pc + Ps, 5]
// (int32, float32; null in the solve): a diagnostic, the first iteration's
// neighbours of each live feature, the map index (-1 for a no-neighbour
// slot) and d2 (3e38 there); a dead feature's rows are left as they are.
//
// Design.  Once a launch, the cluster compacts the lane's live features and
// live map points into scratch, each rank a contiguous share of the slots
// (counts exchanged through distributed shared memory, so the lists keep
// slot order and a map point's list position orders it as its index does).
// Each CTA takes a contiguous 1/C of the live corner and of the live surf
// features.  A query is held by a group of G threads (a power of two up to
// 32, the widest that fits the CTA's share into one round of kSlots query
// slots), kQpt queries a thread as independent chains; the map's live list
// streams through a shared-memory tile of knn_tile.cuh's kTile points,
// centred on the set's centroid as it is staged (the map does not have to
// fit: a crop can fill 65536 surf slots), thread g of a group scanning
// every G-th point in index order (TopK::push_in_order), and the group's
// lists merge by key through shuffles.  The group's first thread then fits
// its points and adds their rows.  No grid-wide barrier: B lanes are B
// clusters.
//
// Bound.  Operations: 8 fp32 operations a (live query, live map point)
// pair an iteration, as knn_stream.cu's, over 67 TFLOP/s (the fits add
// ~0.3% at the SLAM step's shapes).  The pairs are the work, ~2.5e7 an
// iteration at phase 8's 6500 live features and 4400 live map points, and
// one cluster spans at most 16 of 132 SMs: a lane's iteration is bound by
// its cluster's issue rate, not by the card's.
//
// Built without FMA contraction (kernels.SOURCE_FLAGS): the plain version's
// norms, d2, fits and rows are separate PyTorch operations, each rounded.

#include <cooperative_groups.h>

#include "gn_tile.cuh"
#include "gn_step.cuh"

namespace fbpr {
namespace {
namespace knn {
#include "knn_tile.cuh"
}  // namespace knn

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 16;           // above 8: a non-portable size
constexpr int kExThreads = 256;           // a CTA's threads
constexpr int kExWarps = kExThreads / 32;
constexpr int kQpt = 2;                   // queries a thread
constexpr int kSlots = kQpt * kExThreads;  // query slots a CTA a round
constexpr int kNn = 5;
// the lists compacted once a launch: corner and surf features, then the
// corner and surf maps' live points
constexpr int kLists = 4;
// groups of partial sums (ATen's CTAs an output) a query centroid takes:
// more than 512 comes only past 2^21 feature slots a lane (kernels.py
// refuses)
constexpr int kMaxGroups = 512;

struct ExactArgs {
  const float* pose;          // [B, 6]
  const float* fxyz[2];       // corner [B, Pc, 3], surf [B, Ps, 3]
  const uint8_t* fmask[2];    // [B, Pc], [B, Ps]
  const float* map[2];        // [Mc, 3] or [B, Mc, 3]; surf likewise
  const uint8_t* mmask[2];    // [Mc] or [B, Mc]; surf likewise
  long long mstride[2];       // points between two lanes' maps (0: shared)
  int P[2];                   // Pc, Ps
  int M[2];                   // Mc, Ms
  int* scratch;               // [B, Pc + Ps + Mc + Ms]
  float* stat;                // [B, 16]
  int* nn_idx;                // [B, Pc + Ps, 5] or null
  float* nn_d2;               // [B, Pc + Ps, 5] or null
  int mean_S[2], mean_H[2];    // corner, surf: the centroid's order
  float mean_factor[2];
  int B, iters, min_corr, edge_min_valid, surf_min_valid, C;
  float eig_thresh, conv_rot_deg, conv_trans_cm;
};

struct Query {
  float fx, fy, fz;   // the lidar point
  float xw, yw, zw;   // the world point
  float qx, qy, qz;   // the world point centred on the set's centroid
  float qn;           // |q - c|^2
  int p;              // feature slot
  bool ok;
};

// Rank r of C takes [n r / C, n (r + 1) / C) of n items.
__device__ __forceinline__ void share(int n, int rank, int C, int& lo,
                                      int& hi) {
  lo = (int)((long long)n * rank / C);
  hi = (int)((long long)n * (rank + 1) / C);
}

// Warp w's contiguous span [wlo, whi) of [lo, hi), spans in warp order.
__device__ __forceinline__ void warp_span(int lo, int hi, int warp, int& wlo,
                                          int& whi) {
  const int span = ((hi - lo + kExThreads - 1) / kExThreads) * 32;
  wlo = min(lo + warp * span, hi);
  whi = min(wlo + span, hi);
}

__device__ __forceinline__ void world_point(const volatile float* fr,
                                            float fx, float fy, float fz,
                                            float& xw, float& yw, float& zw) {
  xw = fr[0] * fx + fr[1] * fy + fr[2] * fz + fr[kT];
  yw = fr[3] * fx + fr[4] * fy + fr[5] * fz + fr[kT + 1];
  zw = fr[6] * fx + fr[7] * fy + fr[8] * fz + fr[kT + 2];
}

// The live slots (mask != 0) of each of the lane's lists, in slot order,
// into out[l][0..tot[l]): each rank of the cluster compacts its share of
// the slots at the offset its lower ranks' counts give.  All threads of
// the cluster call it; on return every CTA can read all of every list.
__device__ void compact_lists(const uint8_t* const (&mask)[kLists],
                              const int (&len)[kLists],
                              int* const (&out)[kLists], int rank, int C,
                              int (*s_wcnt)[kExWarps], int* s_cnt, int* s_off,
                              int* s_tot, int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  for (int l = 0; l < kLists; ++l) {
    int lo, hi, wlo, whi;
    share(len[l], rank, C, lo, hi);
    warp_span(lo, hi, warp, wlo, whi);
    int cnt = 0;
    for (int base = wlo; base < whi; base += 32) {
      const int p = base + lane;
      cnt += __popc(__ballot_sync(kFull, p < whi && mask[l][p] != 0));
    }
    if (lane == 0) s_wcnt[l][warp] = cnt;
  }
  __syncthreads();
  if (tid < kLists) {
    int n = 0;
    for (int w = 0; w < kExWarps; ++w) n += s_wcnt[tid][w];
    s_cnt[tid] = n;
  }
  if (C > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    if (tid < kLists) {
      int o = 0, t = 0;
      for (int r = 0; r < C; ++r) {
        const int c = cluster.map_shared_rank(s_cnt, r)[tid];
        o += r < rank ? c : 0;
        t += c;
      }
      s_off[tid] = o;
      s_tot[tid] = t;
    }
  } else {
    __syncthreads();
    if (tid < kLists) {
      s_off[tid] = 0;
      s_tot[tid] = s_cnt[tid];
    }
  }
  __syncthreads();
  for (int l = 0; l < kLists; ++l) {
    int lo, hi, wlo, whi;
    share(len[l], rank, C, lo, hi);
    warp_span(lo, hi, warp, wlo, whi);
    int o = s_off[l];
    for (int w = 0; w < warp; ++w) o += s_wcnt[l][w];
    for (int base = wlo; base < whi; base += 32) {
      const int p = base + lane;
      const bool live = p < whi && mask[l][p] != 0;
      const unsigned bal = __ballot_sync(kFull, live);
      if (live) out[l][o + __popc(bal & ((1u << lane) - 1u))] = p;
      o += __popc(bal);
    }
  }
  __threadfence();
  if (C > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

// A set's query centroid into cen[0..3): the mean of every slot's world
// point at the frame (masked slots too) in the order of ATen's CUDA
// reduction behind `query.mean(-2)` (Reduce.cuh, MeanOps), so that the
// centred coordinates, and the d2 of every pair, are the plain k-NN's bit
// for bit.  Partial s of S sums points s, s + S, s + 2S, ... in four
// interleaved accumulators, folded ((a0 + a1) + a2) + a3; the partials, in
// groups of H (s = y + H g), fold as a tree (y takes y + off, off = H/2 ..
// 1); with more than one group, y < H sums groups y, y + H, ... in order
// and the same tree folds those; the sum times `factor`.  (S, H, factor)
// from kernels.exact_gn_mean_order.  All threads call it.
__device__ void centroid(const float* F, int P, int S, int H, float factor,
                         const volatile float* fr, float4* buf,
                         float4* gsum, float* cen, int tid) {
  const int G = S / H;
  const int per = (knn::kTile / H) * H;  // whole groups a batch
  for (int s0 = 0; s0 < S; s0 += per) {
    const int n = min(per, S - s0);
    for (int j = tid; j < n; j += kExThreads) {
      float a[4][3];
#pragma unroll
      for (int u = 0; u < 4; ++u) a[u][0] = a[u][1] = a[u][2] = 0.0f;
      int p = s0 + j;
      for (; p + 3 * S < P; p += 4 * S) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float* f = F + 3 * (p + u * S);
          float xw, yw, zw;
          world_point(fr, f[0], f[1], f[2], xw, yw, zw);
          a[u][0] += xw;
          a[u][1] += yw;
          a[u][2] += zw;
        }
      }
#pragma unroll
      for (int u = 0; u < 3; ++u, p += S) {
        if (p >= P) break;
        const float* f = F + 3 * p;
        float xw, yw, zw;
        world_point(fr, f[0], f[1], f[2], xw, yw, zw);
        a[u][0] += xw;
        a[u][1] += yw;
        a[u][2] += zw;
      }
      buf[j] = make_float4(((a[0][0] + a[1][0]) + a[2][0]) + a[3][0],
                           ((a[0][1] + a[1][1]) + a[2][1]) + a[3][1],
                           ((a[0][2] + a[1][2]) + a[2][2]) + a[3][2], 0.0f);
    }
    __syncthreads();
    for (int off = H / 2; off > 0; off >>= 1) {
      for (int j = tid; j < n; j += kExThreads)
        if ((j & (H - 1)) < off) {
          const float4 o = buf[j + off];
          buf[j].x += o.x;
          buf[j].y += o.y;
          buf[j].z += o.z;
        }
      __syncthreads();
    }
    for (int j = tid; j < n / H; j += kExThreads) gsum[s0 / H + j] = buf[j * H];
    __syncthreads();
  }
  if (G > 1) {
    for (int y = tid; y < H; y += kExThreads) {
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int g = y; g < G; g += H) {
        v.x += gsum[g].x;
        v.y += gsum[g].y;
        v.z += gsum[g].z;
      }
      buf[y] = v;
    }
    __syncthreads();
    for (int off = H / 2; off > 0; off >>= 1) {
      for (int y = tid; y < off; y += kExThreads) {
        const float4 o = buf[y + off];
        buf[y].x += o.x;
        buf[y].y += o.y;
        buf[y].z += o.z;
      }
      __syncthreads();
    }
    if (tid == 0) gsum[0] = buf[0];
    __syncthreads();
  }
  if (tid == 0) {
    cen[0] = gsum[0].x * factor;
    cen[1] = gsum[0].y * factor;
    cen[2] = gsum[0].z * factor;
  }
  __syncthreads();
}

// A query's fit and row from its 5-NN (keys: d2 bits, list position); the
// first iteration's neighbours into nn_idx / nn_d2 when given.
template <bool kSurf>
__device__ __forceinline__ void fit_point(float (&acc)[32],
                                          const knn::TopK<kNn>& best,
                                          const Query& q, const float* map,
                                          const int* m,
                                          const volatile float* fr,
                                          int* nn_idx, float* nn_d2) {
  if (nn_idx) {
#pragma unroll
    for (int k = 0; k < kNn; ++k) {
      const bool found = best.idx[k] != knn::kNoKey;
      nn_idx[k] = found ? __ldcg(m + best.idx[k]) : -1;
      nn_d2[k] = found ? __int_as_float(best.bits[k]) : knn::kBig;
    }
  }
  bool near = true;
#pragma unroll
  for (int k = 0; k < kNn; ++k)
    near = near && __int_as_float(best.bits[k]) < 1.0f;
  if (!near) return;  // the 5th-NN gate (kNoKey's bits read as NaN)
  float nx[kNn], ny[kNn], nz[kNn];
#pragma unroll
  for (int k = 0; k < kNn; ++k) {
    const int i = __ldcg(m + best.idx[k]);
    nx[k] = map[3 * i];
    ny[k] = map[3 * i + 1];
    nz[k] = map[3 * i + 2];
  }
  const float d5max = __int_as_float(best.bits[kNn - 1]);  // ascending
  Coef c;
  if constexpr (kSurf)
    c = surf_fit<kNn, true>(nx, ny, nz, 0x1fu, d5max, 1.0f, q.xw, q.yw, q.zw,
                            0.0f);
  else
    c = corner_fit<kNn, true>(nx, ny, nz, 0x1fu, d5max, 1.0f, q.xw, q.yw,
                              q.zw);
  add_row(acc, c, q.fx, q.fy, q.fz, fr);
}

// One kind's share of this CTA: its 1/C of the nq live features in list
// `q`, each one's exact 5-NN among the nm live map points in list `m` of
// `map`, then its fit and row into acc.  cen: the set's centroid.  All
// threads call it (the map streams through `tile` between CTA barriers).
template <bool kSurf>
__device__ void knn_fit(float (&acc)[32], const float* F, const int* q,
                        int nq, const float* map, const int* m, int nm,
                        const float* cen, float4* tile,
                        const volatile float* fr, int rank, int C, int tid,
                        int* nn_idx, float* nn_d2) {
  int lo, hi;
  share(nq, rank, C, lo, hi);
  const int n = hi - lo;
  if (n <= 0) return;  // the same on every thread
  int G = 1;
  while (G < 32 && kSlots / (2 * G) >= n) G *= 2;
  const int per_round = kSlots / G;
  const int g = tid & (G - 1);
  const float cx = cen[0], cy = cen[1], cz = cen[2];
  for (int r0 = lo; r0 < hi; r0 += per_round) {
    Query qs[kQpt];
    knn::TopK<kNn> best[kQpt];
#pragma unroll
    for (int u = 0; u < kQpt; ++u) {
      const int i = r0 + (tid / G) * kQpt + u;
      Query& s = qs[u];
      s.ok = i < hi;
      s.p = s.ok ? __ldcg(q + i) : 0;
      const float* f = F + 3 * s.p;
      s.fx = f[0];
      s.fy = f[1];
      s.fz = f[2];
      world_point(fr, s.fx, s.fy, s.fz, s.xw, s.yw, s.zw);
      s.qx = s.xw - cx;
      s.qy = s.yw - cy;
      s.qz = s.zw - cz;
      s.qn = knn::sq_norm(s.qx, s.qy, s.qz);
      best[u].init();
    }
    const bool any = qs[0].ok;   // a thread's later queries follow its first
    for (int t0 = 0; t0 < nm; t0 += knn::kTile) {
      const int cnt = min(knn::kTile, nm - t0);
      __syncthreads();   // the last tile is read
      for (int j = tid; j < cnt; j += kExThreads) {
        const int i = __ldcg(m + t0 + j);
        const float x = map[3 * i] - cx;
        const float y = map[3 * i + 1] - cy;
        const float z = map[3 * i + 2] - cz;
        tile[j] = make_float4(x, y, z, knn::sq_norm(x, y, z));
      }
      __syncthreads();
      if (!any) continue;
#pragma unroll 2
      for (int e = g; e < cnt; e += G) {
        const float4 mp = tile[e];
#pragma unroll
        for (int u = 0; u < kQpt; ++u) {
          const float cross = qs[u].qx * mp.x + qs[u].qy * mp.y +
                              qs[u].qz * mp.z;
          best[u].push_in_order(
              __float_as_int(knn::clamp0((qs[u].qn + mp.w) - 2.0f * cross)),
              t0 + e);
        }
      }
    }
    // the group's lists into each of its threads' (disjoint keys: exact)
    for (int h = 1; h < G; h <<= 1) {
#pragma unroll
      for (int u = 0; u < kQpt; ++u) {
        int ob[kNn], oi[kNn];
#pragma unroll
        for (int k = 0; k < kNn; ++k) {
          ob[k] = __shfl_xor_sync(kFull, best[u].bits[k], h);
          oi[k] = __shfl_xor_sync(kFull, best[u].idx[k], h);
        }
#pragma unroll
        for (int k = 0; k < kNn; ++k) best[u].push(ob[k], oi[k]);
      }
    }
    if (g != 0) continue;
#pragma unroll
    for (int u = 0; u < kQpt; ++u) {
      if (!qs[u].ok) continue;
      const long long row = (long long)qs[u].p * kNn;
      fit_point<kSurf>(acc, best[u], qs[u], map, m, fr,
                       nn_idx ? nn_idx + row : nullptr,
                       nn_d2 ? nn_d2 + row : nullptr);
    }
  }
}

// One lane a cluster of C CTAs; the grid is B * C CTAs, lane b cluster b.
__global__ void __launch_bounds__(kExThreads, 1) exact_gn_kernel(ExactArgs a) {
  __shared__ float4 s_tile[knn::kTile];
  __shared__ float s_st[kStat];
  __shared__ float s_mp[36];
  __shared__ float s_fr[kFrame];
  __shared__ float s_red[kExWarps][kG];
  __shared__ float s_part[2][kG];  // this CTA's sums, by iteration parity
  __shared__ float s_V[36];
  __shared__ float4 s_gsum[kMaxGroups];
  __shared__ float s_cen[6];
  __shared__ int s_wcnt[kLists][kExWarps];
  __shared__ int s_cnt[kLists];
  __shared__ int s_off[kLists];
  __shared__ int s_tot[kLists];
  __shared__ int s_active;

  const int C = a.C;
  const int b = blockIdx.x / C;
  const int rank = C > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;

  const float* F[2];
  const float* maps[2];
  const uint8_t* masks[kLists];
  int len[kLists];
  int* lists[kLists];
  int* lane_lists =
      a.scratch + (long long)b * (a.P[0] + a.P[1] + a.M[0] + a.M[1]);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    F[k] = a.fxyz[k] + (long long)b * a.P[k] * 3;
    maps[k] = a.map[k] + (long long)b * a.mstride[k] * 3;
    masks[k] = a.fmask[k] + (long long)b * a.P[k];
    masks[2 + k] = a.mmask[k] + (long long)b * a.mstride[k];
    len[k] = a.P[k];
    len[2 + k] = a.M[k];
  }
  lists[0] = lane_lists;
  for (int l = 1; l < kLists; ++l) lists[l] = lists[l - 1] + len[l - 1];
  int* nn_idx[2] = {nullptr, nullptr};
  float* nn_d2[2] = {nullptr, nullptr};
  if (a.nn_idx) {
    const long long row = (long long)b * (a.P[0] + a.P[1]) * kNn;
    nn_idx[0] = a.nn_idx + row;
    nn_idx[1] = nn_idx[0] + (long long)a.P[0] * kNn;
    nn_d2[0] = a.nn_d2 + row;
    nn_d2[1] = nn_d2[0] + (long long)a.P[0] * kNn;
  }

  if (tid < kStat) s_st[tid] = tid < 6 ? a.pose[(long long)b * 6 + tid] : 0.0f;
  if (tid < 36) s_mp[tid] = tid % 7 == 0 ? 1.0f : 0.0f;
  compact_lists(masks, len, lists, rank, C, s_wcnt, s_cnt, s_off, s_tot,
                tid);
  if (tid == 0)
    s_st[9] = s_tot[0] > a.edge_min_valid && s_tot[1] > a.surf_min_valid
                  ? 1.0f
                  : 0.0f;
  __syncthreads();
  if (warp == 0) next_frame(s_st, lane, a.iters > 0, s_fr, &s_active);
  __syncthreads();

  for (int it = 0; it < a.iters; ++it) {
    if (!s_active) break;
#pragma unroll
    for (int k = 0; k < 2; ++k)
      centroid(F[k], a.P[k], a.mean_S[k], a.mean_H[k], a.mean_factor[k],
               s_fr, s_tile, s_gsum, s_cen + 3 * k, tid);
    float acc[32];
#pragma unroll
    for (int m = 0; m < 32; ++m) acc[m] = 0.0f;
    const bool first = it == 0;
    knn_fit<false>(acc, F[0], lists[0], s_tot[0], maps[0], lists[2],
                   s_tot[2], s_cen, s_tile, s_fr, rank, C, tid,
                   first ? nn_idx[0] : nullptr, first ? nn_d2[0] : nullptr);
    knn_fit<true>(acc, F[1], lists[1], s_tot[1], maps[1], lists[3],
                  s_tot[3], s_cen + 3, s_tile, s_fr, rank, C, tid,
                  first ? nn_idx[1] : nullptr, first ? nn_d2[1] : nullptr);
    reduce_scatter28(acc, lane);
    if (lane < kG) s_red[warp][lane] = acc[0];
    __syncthreads();
    float g = 0.0f;
    if (warp == 0 && lane < kG)
      for (int w = 0; w < kExWarps; ++w) g += s_red[w][lane];
    if (C > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      float* part = s_part[it & 1];
      if (warp == 0 && lane < kG) part[lane] = g;
      cluster.sync();
      if (warp == 0 && lane < kG) {
        g = 0.0f;
        for (int r = 0; r < C; ++r) g += cluster.map_shared_rank(part, r)[lane];
      }
    }
    if (warp == 0) {
      step_warp(g, lane, s_st, s_mp, s_V, a.min_corr, a.eig_thresh,
                a.conv_rot_deg, a.conv_trans_cm);
      next_frame(s_st, lane, it + 1 < a.iters, s_fr, &s_active);
    }
    __syncthreads();
  }
  // no CTA leaves while another may still read its shared memory
  if (C > 1) cg::this_cluster().sync();
  if (rank != 0) return;
  if (tid < kStat) a.stat[(long long)b * kStat + tid] = s_st[tid];
}

// Sets the attribute a cluster of more than 8 CTAs needs (once).
cudaError_t allow_large_clusters() {
  static const cudaError_t e = cudaFuncSetAttribute(
      exact_gn_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return e;
}

cudaLaunchConfig_t cluster_config(int grid, int C, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kExThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

cudaError_t launch(const ExactArgs& a, cudaStream_t stream) {
  if (a.C == 1) {
    exact_gn_kernel<<<a.B, kExThreads, 0, stream>>>(a);
    return cudaGetLastError();
  }
  if (a.C > 8) {
    const cudaError_t e = allow_large_clusters();
    if (e != cudaSuccess) return e;
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config(a.B * a.C, a.C, stream, attr);
  const cudaError_t e = cudaLaunchKernelEx(&cfg, exact_gn_kernel, a);
  return e != cudaSuccess ? e : cudaGetLastError();
}

bool valid_cluster(int C) {
  return C >= 1 && C <= kMaxCluster && (C & (C - 1)) == 0;
}

// H a power of two up to a tile, S a multiple of H in at most kMaxGroups
// groups
bool valid_mean_order(int S, int H) {
  return H >= 1 && H <= knn::kTile && (H & (H - 1)) == 0 && S >= H &&
         S % H == 0 && S / H <= kMaxGroups;
}

}  // namespace
}  // namespace fbpr

// One register_scan solve a lane (the layouts above); writes stat [B, 16]
// and, when nn_idx is not null, the first iteration's neighbours.  C: CTAs
// a lane, a power of two up to 16.  (Sc, Hc, fc), (Ss, Hs, fs): the corner
// and the surf centroid's order and factor (centroid()).
extern "C" int fbpr_exact_gn(
    const float* pose, const float* cxyz, const uint8_t* cmask,
    const float* sxyz, const uint8_t* smask, const float* cmap,
    const uint8_t* cmmask, long long cmap_stride, const float* smap,
    const uint8_t* smmask, long long smap_stride, int B, int Pc, int Ps,
    int Mc, int Ms, int iters, int min_corr, float eig_thresh,
    float conv_rot_deg, float conv_trans_cm, int edge_min_valid,
    int surf_min_valid, int* scratch, float* stat, int* nn_idx, float* nn_d2,
    int C, int Sc, int Hc, float fc, int Ss, int Hs, float fs, void* stream) {
  if (!fbpr::valid_cluster(C) || B < 0 || Pc < 1 || Ps < 1 || Mc < 1 ||
      Ms < 1 || iters < 0 || (nn_idx == nullptr) != (nn_d2 == nullptr) ||
      !fbpr::valid_mean_order(Sc, Hc) || !fbpr::valid_mean_order(Ss, Hs))
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  fbpr::ExactArgs a = {};
  a.pose = pose;
  a.fxyz[0] = cxyz;
  a.fxyz[1] = sxyz;
  a.fmask[0] = cmask;
  a.fmask[1] = smask;
  a.map[0] = cmap;
  a.map[1] = smap;
  a.mmask[0] = cmmask;
  a.mmask[1] = smmask;
  a.mstride[0] = cmap_stride;
  a.mstride[1] = smap_stride;
  a.P[0] = Pc;
  a.P[1] = Ps;
  a.M[0] = Mc;
  a.M[1] = Ms;
  a.scratch = scratch;
  a.stat = stat;
  a.nn_idx = nn_idx;
  a.nn_d2 = nn_d2;
  a.B = B;
  a.iters = iters;
  a.min_corr = min_corr;
  a.edge_min_valid = edge_min_valid;
  a.surf_min_valid = surf_min_valid;
  a.C = C;
  a.mean_S[0] = Sc;
  a.mean_H[0] = Hc;
  a.mean_factor[0] = fc;
  a.mean_S[1] = Ss;
  a.mean_H[1] = Hs;
  a.mean_factor[1] = fs;
  a.eig_thresh = eig_thresh;
  a.conv_rot_deg = conv_rot_deg;
  a.conv_trans_cm = conv_trans_cm;
  return (int)fbpr::launch(a, static_cast<cudaStream_t>(stream));
}

// How many clusters of C CTAs can be resident at once
// (cudaOccupancyMaxActiveClusters) into *out.
extern "C" int fbpr_exact_gn_max_clusters(int C, int* out) {
  if (!fbpr::valid_cluster(C)) return (int)cudaErrorInvalidValue;
  if (C > 8) {
    const cudaError_t e = fbpr::allow_large_clusters();
    if (e != cudaSuccess) return (int)e;
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = fbpr::cluster_config(C, C, nullptr, attr);
  return (int)cudaOccupancyMaxActiveClusters(out, fbpr::exact_gn_kernel,
                                             &cfg);
}
