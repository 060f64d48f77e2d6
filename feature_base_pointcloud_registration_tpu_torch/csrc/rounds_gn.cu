// One round of the rounds-structured solver's Gauss-Newton iterations: a
// cluster of C CTAs runs a whole round for one lane.
//
// Replaces the device loop of the JAX package's `register_rounds_core`
// (ops/register.py: the `lax.while_loop(iter_cond, iter_body)` of each
// round inside `lax.scan` over the rounds), which the port drove from the
// host one iteration and one sync at a time.  The plain version is
// ops/rounds_gn.py::rounds_gn_reference, the port's loop body: the
// candidate correspondences of ops/correspondence.py and
// ops/solver.py::gn_step.
//
// Per lane, up to `iters` iterations while the lane is not converged and
// its feature gate holds (the per-lane early exit):
//   1. the point loops of csrc/gn_tile.cuh in its kXla mode: the world
//      point at the lane's pose, candidate d2 with a candidate invalid where
//      the fetch's d2 is >= 1e37, 5-of-K selection, the line and plane
//      fits with their gates, and the 28 sums of G = J J^T (JtJ upper 6x6,
//      Jtb, n_corr), reduced in a fixed order (warp reduce-scatter, then
//      warp 0 adds the warps' sums in warp order, then the CTAs' sums in
//      rank order);
//   2. gn_step's tail on warp 0 (csrc/gn_step.cuh's step_warp): the
//      eigen-solve of JtJ on every iteration by a converged cyclic Jacobi,
//      the projector at the lane's global iteration 0 (stat[6] == 0), the
//      update and the convergence test.
// The caller resets `converged` at each round's start; `iterations` (stat
// [6]) accumulates across rounds; n_corr is the last executed iteration's.
// A lane that does not run is left untouched.
//
// Layouts (ops/rounds_gn.py checks them): stat [B, 16] (gn_round's slots),
// matP [B, 36], featc [B, 4, Pc] / feats [B, 4, Ps] (x, y, z, mask rows),
// candc [3K, B*Pc] / cands [3K, B*Ps] plane-major candidates, cd2 [K, B*Pc]
// / sd2 [K, B*Ps] the fetch's d2, lane b's block the columns
// [b*P, (b+1)*P).  Dead points (mask 0) are skipped through the live list
// (they add exactly 0 in the XLA body); shapes with Pc + Ps > kMaxList run
// the same loops over every point.
//
// Built without FMA contraction (kernels.py SOURCE_FLAGS): each multiply
// and add rounds on its own, as the plain version's operations do.
//
// Launch: B clusters of C CTAs of kThreads (C in 1, 2, 4, 8, 16; the host
// picks it, kernels.py rounds_gn_cluster).  The point loop, ~6000 live
// points of 48 candidate coordinates each on the step shapes, is what
// binds a round at B = 1: one CTA left 131 SMs of 132 idle.  Every CTA of
// lane b's cluster builds the lane's live list (corner, then surf) and
// takes a contiguous 1/C share of it (of the list, not of the index
// range: dead, padded slots are not spread evenly), reduces its 28 sums
// in the CTA's fixed order into its own shared slot, double-buffered by
// the iteration's parity so that one cluster barrier an iteration is
// enough, and after the barrier warp 0 of every CTA reads the C slots
// through distributed shared memory and adds them in rank order.  Every
// CTA then runs the same tail on bitwise the same G: all ranks agree on
// the pose, the frame and the early exit with no atomics and no
// broadcast, and two launches agree bitwise.  Rank 0 writes stat and
// matP; a last cluster barrier keeps each CTA's shared memory alive until
// the others have read it.  At C = 1 there is no cluster barrier and no
// remote read: the kernel does the one-CTA work it did before.
//
// Built with -DFBPR_ROUNDS_PROFILE (chip_smoke.py's diagnostic build, never
// the shipped one), thread 0 of every CTA stamps clock64() around each part
// of an iteration (a barrier is added after the point loop so that its
// stamp is the slowest thread's) and adds the sums into g_prof, which
// fbpr_rounds_gn_profile reads (clock_prof.cuh's global_ns and prof_read).

#include <cooperative_groups.h>

#include "gn_tile.cuh"
#include "gn_step.cuh"

namespace fbpr {
namespace {

#ifdef FBPR_ROUNDS_PROFILE
#define FBPR_PROF
#endif
#include "clock_prof.cuh"

// Sums over every CTA: [0] iterations, [1] point loop, [2] in-CTA
// reduction, [3] cluster combine, [4] tail (step_warp + next_frame) in
// clock64 cycles, [5] the kernel's cycles and [6] its globaltimer ns on
// thread 0, [7] CTAs.
PROF(__device__ unsigned long long g_prof[8];)

namespace cg = cooperative_groups;

constexpr int kMaxCluster = 16;  // above 8: a non-portable cluster size
// Two CTAs an SM up to K=8; K=16 takes one (gn_round.cu's budget).  The
// grid is B * C CTAs; lane b is cluster b.
template <int K>
__global__ void __launch_bounds__(kThreads, K > 8 ? 1 : 2)
rounds_gn_kernel(float* __restrict__ stat, float* __restrict__ matP,
                 const float* __restrict__ featc,
                 const float* __restrict__ feats,
                 const float* __restrict__ candc,
                 const float* __restrict__ cands,
                 const float* __restrict__ cd2,
                 const float* __restrict__ sd2, int B, int Pc, int Ps,
                 int iters, int min_corr, float eig_thresh,
                 float conv_rot_deg, float conv_trans_cm,
                 float min_plane_spread, bool use_list, int C) {
  extern __shared__ uint16_t s_list[];  // live corner, then surf, indices
  __shared__ float s_st[kStat];
  __shared__ float s_mp[36];
  __shared__ float s_fr[kFrame];
  __shared__ float s_red[kWarps][kG];
  __shared__ float s_part[2][kG];  // this CTA's sums, by iteration parity
  __shared__ float s_V[36];
  __shared__ int s_cnt[kWarps];
  __shared__ int s_active;

  const int b = blockIdx.x / C;
  const int rank = C > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
#ifdef FBPR_ROUNDS_PROFILE
  const long long k_c0 = clock64();
  const unsigned long long k_n0 = global_ns();
  long long prof[5] = {0, 0, 0, 0, 0};
#endif
  const float* fc = featc + (int64_t)b * 4 * Pc;
  const float* fs = feats + (int64_t)b * 4 * Ps;
  const int64_t qc = (int64_t)B * Pc, qs = (int64_t)B * Ps;
  const float* cc = candc + (int64_t)b * Pc;
  const float* cs = cands + (int64_t)b * Ps;
  const float* dc = cd2 + (int64_t)b * Pc;
  const float* ds = sd2 + (int64_t)b * Ps;

  if (tid < kStat) s_st[tid] = stat[(int64_t)b * kStat + tid];
  if (tid < 36) s_mp[tid] = matP[(int64_t)b * 36 + tid];
  int nc = Pc, ns = Ps;
  if (use_list) {
    nc = compact_live(fc, Pc, s_list, s_cnt, warp, lane);
    ns = compact_live(fs, Ps, s_list + nc, s_cnt, warp, lane);
  } else {
    __syncthreads();
  }
  // this rank's share [lo, hi) of the list: corner [lo, mid), surf [mid, hi)
  const int lo = (int)((int64_t)(nc + ns) * rank / C);
  const int hi = (int)((int64_t)(nc + ns) * (rank + 1) / C);
  const int mid = min(max(nc, lo), hi);
  if (warp == 0) next_frame(s_st, lane, iters > 0, s_fr, &s_active);
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    if (!s_active) break;
#ifdef FBPR_ROUNDS_PROFILE
    const long long t0 = clock64();
#endif

    float acc[32];
#pragma unroll
    for (int m = 0; m < 32; ++m) acc[m] = 0.0f;
    int c = lo + tid;
    for (; c < mid; c += kThreads)
      add_point<K, false, true>(acc, fc, Pc, cc, dc, qc,
                                use_list ? s_list[c] : c, s_fr,
                                min_plane_spread);
    for (; c < hi; c += kThreads) {
      const int p = use_list ? s_list[c] : c - nc;
      add_point<K, true, true>(acc, fs, Ps, cs, ds, qs, p, s_fr,
                               min_plane_spread);
    }
#ifdef FBPR_ROUNDS_PROFILE
    __syncthreads();
    const long long t1 = clock64();
    long long t2 = t1;
#endif
    reduce_scatter28(acc, lane);
    if (lane < kG) s_red[warp][lane] = acc[0];
    __syncthreads();
    float g = 0.0f;
    if (warp == 0 && lane < kG)
      for (int w = 0; w < kWarps; ++w) g += s_red[w][lane];
#ifdef FBPR_ROUNDS_PROFILE
    if (warp == 0) t2 = clock64();
    long long t3 = t2;
#endif
    if (C > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      float* part = s_part[it & 1];
      if (warp == 0 && lane < kG) part[lane] = g;
      cluster.sync();
      if (warp == 0 && lane < kG) {
        g = 0.0f;
        for (int r = 0; r < C; ++r) g += cluster.map_shared_rank(part, r)[lane];
      }
#ifdef FBPR_ROUNDS_PROFILE
      if (warp == 0) t3 = clock64();
#endif
    }
    if (warp == 0) {
      step_warp(g, lane, s_st, s_mp, s_V, min_corr, eig_thresh,
                conv_rot_deg, conv_trans_cm);
      next_frame(s_st, lane, it + 1 < iters, s_fr, &s_active);
    }
    __syncthreads();
#ifdef FBPR_ROUNDS_PROFILE
    if (tid == 0) {
      const long long t4 = clock64();
      prof[0] += 1;
      prof[1] += t1 - t0;
      prof[2] += t2 - t1;
      prof[3] += t3 - t2;
      prof[4] += t4 - t3;
    }
#endif
  }
  // no CTA leaves while another may still read its s_part
  if (C > 1) cg::this_cluster().sync();
#ifdef FBPR_ROUNDS_PROFILE
  if (tid == 0) {
    for (int i = 0; i < 5; ++i)
      atomicAdd(&g_prof[i], (unsigned long long)prof[i]);
    atomicAdd(&g_prof[5], (unsigned long long)(clock64() - k_c0));
    atomicAdd(&g_prof[6], global_ns() - k_n0);
    atomicAdd(&g_prof[7], 1ull);
  }
#endif
  if (rank != 0) return;
  if (tid < kStat) stat[(int64_t)b * kStat + tid] = s_st[tid];
  if (tid < 36) matP[(int64_t)b * 36 + tid] = s_mp[tid];
}

// The list's bytes at the most points (the launch's shared memory is at
// most this, whatever the shape).
constexpr size_t kListBytes = sizeof(uint16_t) * kMaxList;

// Sets the attribute a cluster of more than 8 CTAs needs (once a kernel).
template <int K>
cudaError_t allow_large_clusters() {
  static const cudaError_t e = cudaFuncSetAttribute(
      rounds_gn_kernel<K>, cudaFuncAttributeNonPortableClusterSizeAllowed,
      1);
  return e;
}

template <int K>
cudaError_t launch(float* stat, float* matP, const float* featc,
                   const float* feats, const float* candc, const float* cands,
                   const float* cd2, const float* sd2, int B, int Pc, int Ps,
                   int iters, int min_corr, float eig_thresh,
                   float conv_rot_deg, float conv_trans_cm,
                   float min_plane_spread, int C, cudaStream_t stream) {
  const bool use_list = (int64_t)Pc + Ps <= kMaxList;
  const size_t smem = use_list ? sizeof(uint16_t) * (Pc + Ps) : 0;
  if (C == 1) {
    rounds_gn_kernel<K><<<B, kThreads, smem, stream>>>(
        stat, matP, featc, feats, candc, cands, cd2, sd2, B, Pc, Ps, iters,
        min_corr, eig_thresh, conv_rot_deg, conv_trans_cm, min_plane_spread,
        use_list, 1);
    return cudaGetLastError();
  }
  if (C > 8) {
    const cudaError_t e = allow_large_clusters<K>();
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, rounds_gn_kernel<K>, stat, matP, featc,
                            feats, candc, cands, cd2, sd2, B, Pc, Ps, iters,
                            min_corr, eig_thresh, conv_rot_deg, conv_trans_cm,
                            min_plane_spread, use_list, C);
}

// cudaOccupancyMaxActiveClusters of C-CTA clusters at the largest list.
template <int K>
cudaError_t max_clusters(int C, int* out) {
  if (C > 8) {
    const cudaError_t e = allow_large_clusters<K>();
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = kListBytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(out, rounds_gn_kernel<K>, &cfg);
}

bool valid_cluster(int C) {
  return C >= 1 && C <= kMaxCluster && (C & (C - 1)) == 0;
}

}  // namespace
}  // namespace fbpr

extern "C" int fbpr_rounds_gn(float* stat, float* matP, const float* featc,
                              const float* feats, const float* candc,
                              const float* cands, const float* cd2,
                              const float* sd2, int B, int Pc, int Ps, int K,
                              int iters, int min_corr, float eig_thresh,
                              float conv_rot_deg, float conv_trans_cm,
                              float min_plane_spread, int C, void* stream) {
  if (!fbpr::valid_cluster(C)) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
#define FBPR_ROUNDS_CASE(KK)                                               \
  case KK:                                                                 \
    e = fbpr::launch<KK>(stat, matP, featc, feats, candc, cands, cd2, sd2, \
                         B, Pc, Ps, iters, min_corr, eig_thresh,           \
                         conv_rot_deg, conv_trans_cm, min_plane_spread, C, \
                         s);                                               \
    break;
  switch (K) {
    FBPR_ROUNDS_CASE(6)
    FBPR_ROUNDS_CASE(8)
    FBPR_ROUNDS_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FBPR_ROUNDS_CASE
  return (int)e;
}

// How many clusters of C CTAs of the K instance can be resident at once
// (cudaOccupancyMaxActiveClusters at the largest list's shared memory)
// into *out; 0 where C is not a cluster size the kernel takes.
extern "C" int fbpr_rounds_gn_max_clusters(int K, int C, int* out) {
  if (!fbpr::valid_cluster(C)) return (int)cudaErrorInvalidValue;
  switch (K) {
    case 6:
      return (int)fbpr::max_clusters<6>(C, out);
    case 8:
      return (int)fbpr::max_clusters<8>(C, out);
    case 16:
      return (int)fbpr::max_clusters<16>(C, out);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

#ifdef FBPR_ROUNDS_PROFILE
// The diagnostic build's sums (g_prof, 8 values) into out; reset != 0
// zeroes them after.  Synchronous.
extern "C" int fbpr_rounds_gn_profile(unsigned long long* out, int reset) {
  return fbpr::prof_read(fbpr::g_prof, out, reset);
}
#endif
