// Fused Gauss-Newton round: one CTA runs a whole solve round for one lane.
//
// Replaces the TPU kernel `_gn_round_kernel` behind `gn_round_pallas` (the
// JAX package's ops/pallas_gn.py; helpers `_jacobi6`, `_sym3_lam_max_mid`,
// `_corr_corner`, `_corr_surf`).  The plain
// version with the same arithmetic is ops/gn_round.py::gn_round_reference.
// The per-point code, the warp reduction, the live list and the frame are
// csrc/gn_tile.cuh's (its kXla = false mode), shared with rounds_gn.cu.
//
// Per lane (one scan), up to `iters` iterations while the lane is not
// converged and its feature gate holds (the per-lane early exit; lanes
// never wait on each other):
//   1. the point loops: the CTA's threads stride over the lane's live corner
//      points, then its live surf points (two loops, so the register peak
//      is the larger body's, not both).  Per point the 5-of-K selection,
//      the line fit (Cardano spectrum, line gate, cross-product
//      eigenvector) or the Householder plane fit, and the Jacobian row
//      J = [Jr, Jp, Jy, nx, ny, nz, -resid, mask], accumulated into the 28
//      entries of G = J J^T the solve reads (JtJ upper 6x6, Jtb, n_corr);
//   2. a fixed-order block reduction: a reduce-scatter of the 28 sums
//      inside each warp (lane m ends with entry m), then warp 0 adds the
//      warps' partial sums in warp order;
//   3. the tail on warp 0, spread over its lanes: at the lane's iteration 0
//      only the cyclic Jacobi (A on every lane, row k of V on lane k) for matP
//      and the degeneracy flag; the (JtJ + 1e-2 I) Gauss-Jordan solve (lane
//      i holds row i), the projection, the update when n_corr >= min_corr,
//      the convergence test (0.05 deg, 0.05 cm), and the next iteration's
//      frame (R and its three angle derivatives; the six sines and cosines
//      on six lanes).  Each element keeps the single-thread arithmetic and
//      order, so the tail's results depend on G alone.
// Two __syncthreads an iteration: the partial sums, then the new frame.
// The Pallas kernel's polynomial arccos (Mosaic has no acos) is acosf here.
//
// Live points only.  At the start of the round the CTA compacts the
// indices of its live points (mask != 0) into a uint16 list in dynamic
// shared memory (a warp-ballot prefix, in point order), and the point loops
// run over the list: no dead point is loaded, and the work is balanced
// whatever the mask's pattern.  Precondition: every candidate of a dead
// point is finite.  A dead point then adds exactly +-0 to each sum (every
// term carries its mask), so skipping it changes nothing; a NaN or inf
// candidate on a dead point would have reached G through 0 * NaN.  The
// port's fetch kernels give sentinel queries zeros.  Shapes with Pc + Ps >
// kMaxList run the same loops over all points, dead ones included.
//
// Bound.  The least work: the mask of every point and the xyz and
// candidates of each live point read once (4 bytes a point and 12 + 12K a
// live one; a dead point's are never read), and ~600 (corner) / ~900
// (surf) fp32 operations a live point and lane-iteration.  A design that
// re-reads every live point's candidates each iteration, as this one does,
// is floored at lane-iterations x live points x (16 + 12K) bytes over the
// memory rate (~125 MB an iteration of all lanes at the main path's round
// 1: more than the 50 MB L2).  Neither binds it: a point is ~1000
// dependent instructions, so the kernel is bound by issue and latency and
// needs many warps an SM to hide them.  At <= 128 registers a thread
// (__launch_bounds__(kThreads, 2), K <= 8) two lanes share an SM and all
// 256 lanes of the main path run in one wave; then the lanes that need the
// most iterations (the per-lane early exit), and at a lane's iteration 0
// the 90 dependent rotations of the Jacobi, set the round's time.

#include "gn_tile.cuh"

namespace fbpr {
namespace {

// r[i] for a lane-dependent i, without indexing registers at run time
template <int N>
__device__ __forceinline__ float pick(const float (&r)[N], int i) {
  float v = r[0];
#pragma unroll
  for (int j = 1; j < N; ++j) v = i == j ? r[j] : v;
  return v;
}

// Warp 0: cyclic Jacobi on the symmetric JtJ (the TPU kernel's _jacobi6)
// -> matP = V diag(lam >= eig_thresh) V^T and the degeneracy flag.  Every
// lane holds all of A and rotates it (no shuffle on the chain of 15 *
// jacobi_sweeps dependent rotations); lane k < 6 holds row k of V.
__device__ void jacobi_warp(float g, int lane, float* st, float* mp,
                            float* scratch, float eig_thresh,
                            int jacobi_sweeps) {
  const int k = lane < 6 ? lane : 5;
  float A[6][6], V[6];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) A[i][j] = g_at(g, i, j);
#pragma unroll
  for (int j = 0; j < 6; ++j) V[j] = k == j ? 1.0f : 0.0f;
  for (int sw = 0; sw < jacobi_sweeps; ++sw) {
#pragma unroll
    for (int p = 0; p < 6; ++p)
#pragma unroll
      for (int q = p + 1; q < 6; ++q) {
        const float apq = A[p][q], app = A[p][p], aqq = A[q][q];
        const bool small = fabsf(apq) < 1e-20f;
        const float tau = (aqq - app) / (2.0f * (small ? 1.0f : apq));
        const float sg = tau > 0.0f ? 1.0f : (tau < 0.0f ? -1.0f : tau);
        float t = sg / (fabsf(tau) + sqrtf(1.0f + tau * tau));
        if (tau == 0.0f) t = 1.0f;
        if (small) t = 0.0f;
        const float c = 1.0f / sqrtf(1.0f + t * t);
        const float s = t * c;
#pragma unroll
        for (int kk = 0; kk < 6; ++kk) {
          const float akp = A[kk][p], akq = A[kk][q];
          A[kk][p] = c * akp - s * akq;
          A[kk][q] = s * akp + c * akq;
        }
#pragma unroll
        for (int kk = 0; kk < 6; ++kk) {
          const float apk = A[p][kk], aqk = A[q][kk];
          A[p][kk] = c * apk - s * aqk;
          A[q][kk] = s * apk + c * aqk;
        }
        const float vkp = V[p], vkq = V[q];
        V[p] = c * vkp - s * vkq;
        V[q] = s * vkp + c * vkq;
      }
  }
  float* sV = scratch;  // V row-major [36]
  if (lane < 6) {
#pragma unroll
    for (int j = 0; j < 6; ++j) sV[lane * 6 + j] = V[j];
  }
  __syncwarp();
  float good[6];
  float isdeg = 0.0f;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    good[i] = A[i][i] >= eig_thresh ? 1.0f : 0.0f;
    isdeg = fmaxf(isdeg, 1.0f - good[i]);
  }
  for (int e = lane; e < 36; e += 32) {
    const int i = e / 6, j = e % 6;
    float pij = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 6; ++kk)
      pij += sV[i * 6 + kk] * good[kk] * sV[j * 6 + kk];
    mp[e] = pij;
  }
  if (lane == 0) st[8] = isdeg;
  __syncwarp();
}

// Warp 0: the iteration's tail.  g: lane m < 28 holds G[m].  Jacobi at the
// lane's iteration 0, Gauss-Jordan (lane i < 6 holds row i of
// [JtJ + 1e-2 I | Jtb]), projection, update, convergence test.
__device__ void solve_warp(float g, int lane, float* st, float* mp,
                           float* scratch, int min_corr, float eig_thresh,
                           float conv_rot_deg, float conv_trans_cm,
                           int jacobi_sweeps) {
  const float n_corr = __shfl_sync(kFull, g, kG - 1);
  const bool enough = n_corr >= (float)min_corr;
  if (st[6] == 0.0f)
    jacobi_warp(g, lane, st, mp, scratch, eig_thresh, jacobi_sweeps);

  // (JtJ + 1e-2 I) x = Jtb, Gauss-Jordan without pivoting (SPD + Tikhonov
  // shift keeps every pivot >= 1e-2)
  const int i = lane < 6 ? lane : 5;
  float A[7];
#pragma unroll
  for (int j = 0; j < 7; ++j) A[j] = g_at(g, i, j) + (i == j ? 1e-2f : 0.0f);
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float Aj[7];
#pragma unroll
    for (int c = 0; c < 7; ++c) Aj[c] = __shfl_sync(kFull, A[c], j);
    const float piv = Aj[j];
    if (i != j) {
      const float f = A[j] / piv;
#pragma unroll
      for (int c = 0; c < 7; ++c) A[c] = A[c] - f * Aj[c];
    }
  }
  float xi = A[6] / pick(A, i);
  float x[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) x[j] = __shfl_sync(kFull, xi, j);
  if (st[8] > 0.0f) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < 6; ++j) acc += mp[i * 6 + j] * x[j];
    xi = acc;
#pragma unroll
    for (int j = 0; j < 6; ++j) x[j] = __shfl_sync(kFull, xi, j);
  }
  const float deg2 = (180.0f / kPi) * (180.0f / kPi);
  const float d_r = sqrtf((x[0] * x[0] + x[1] * x[1] + x[2] * x[2]) * deg2);
  const float d_t = sqrtf((x[3] * x[3] + x[4] * x[4] + x[5] * x[5]) * 1.0e4f);
  const bool conv = enough && d_r < conv_rot_deg && d_t < conv_trans_cm;
  const float ef = enough ? 1.0f : 0.0f;
  __syncwarp();  // every lane has read st[6] and st[8]
  if (lane < 6) st[lane] = st[lane] + ef * xi;
  if (lane == 0) {
    st[6] = st[6] + 1.0f;
    st[7] = conv ? 1.0f : 0.0f;
    st[10] = n_corr;
  }
  __syncwarp();
}

// Two CTAs an SM up to K=8; K=16 does not fit 128 registers a thread and
// takes one CTA an SM without spills.
template <int K>
__global__ void __launch_bounds__(kThreads, K > 8 ? 1 : 2)
gn_round_kernel(float* __restrict__ stat, float* __restrict__ matP,
                const float* __restrict__ featc,
                const float* __restrict__ feats,
                const float* __restrict__ candc,
                const float* __restrict__ cands, int B, int Pc, int Ps,
                int iters, int min_corr, float eig_thresh, float conv_rot_deg,
                float conv_trans_cm, int jacobi_sweeps,
                float min_plane_spread, bool use_list) {
  extern __shared__ uint16_t s_list[];  // live corner, then surf, indices
  __shared__ float s_st[kStat];
  __shared__ float s_mp[36];
  __shared__ float s_fr[kFrame];
  __shared__ float s_red[kWarps][kG];
  __shared__ float s_scratch[36];
  __shared__ int s_cnt[kWarps];
  __shared__ int s_active;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* fc = featc + (int64_t)b * 4 * Pc;
  const float* fs = feats + (int64_t)b * 4 * Ps;
  const int64_t qc = (int64_t)B * Pc, qs = (int64_t)B * Ps;
  const float* cc = candc + (int64_t)b * Pc;
  const float* cs = cands + (int64_t)b * Ps;

  if (tid < kStat) s_st[tid] = stat[(int64_t)b * kStat + tid];
  if (tid < 36) s_mp[tid] = matP[(int64_t)b * 36 + tid];
  int nc = Pc, ns = Ps;
  if (use_list) {
    nc = compact_live(fc, Pc, s_list, s_cnt, warp, lane);
    ns = compact_live(fs, Ps, s_list + nc, s_cnt, warp, lane);
  } else {
    __syncthreads();
  }
  if (warp == 0) next_frame(s_st, lane, iters > 0, s_fr, &s_active);
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    if (!s_active) break;

    float acc[32];
#pragma unroll
    for (int m = 0; m < 32; ++m) acc[m] = 0.0f;
    int c = tid;
    for (; c < nc; c += kThreads)
      add_point<K, false, false>(acc, fc, Pc, cc, nullptr, qc,
                                 use_list ? s_list[c] : c, s_fr,
                                 min_plane_spread);
    for (; c < nc + ns; c += kThreads) {
      const int p = use_list ? s_list[c] : c - nc;
      add_point<K, true, false>(acc, fs, Ps, cs, nullptr, qs, p, s_fr,
                                min_plane_spread);
    }
    reduce_scatter28(acc, lane);
    if (lane < kG) s_red[warp][lane] = acc[0];
    __syncthreads();
    if (warp == 0) {
      float g = 0.0f;
      if (lane < kG)
        for (int w = 0; w < kWarps; ++w) g += s_red[w][lane];
      solve_warp(g, lane, s_st, s_mp, s_scratch, min_corr, eig_thresh,
                 conv_rot_deg, conv_trans_cm, jacobi_sweeps);
      next_frame(s_st, lane, it + 1 < iters, s_fr, &s_active);
    }
    __syncthreads();
  }
  if (tid < kStat) stat[(int64_t)b * kStat + tid] = s_st[tid];
  if (tid < 36) matP[(int64_t)b * 36 + tid] = s_mp[tid];
}

template <int K>
void launch(float* stat, float* matP, const float* featc, const float* feats,
            const float* candc, const float* cands, int B, int Pc, int Ps,
            int iters, int min_corr, float eig_thresh, float conv_rot_deg,
            float conv_trans_cm, int jacobi_sweeps, float min_plane_spread,
            cudaStream_t stream) {
  const bool use_list = (int64_t)Pc + Ps <= kMaxList;
  const size_t smem = use_list ? sizeof(uint16_t) * (Pc + Ps) : 0;
  gn_round_kernel<K><<<B, kThreads, smem, stream>>>(
      stat, matP, featc, feats, candc, cands, B, Pc, Ps, iters, min_corr,
      eig_thresh, conv_rot_deg, conv_trans_cm, jacobi_sweeps,
      min_plane_spread, use_list);
}

}  // namespace
}  // namespace fbpr

extern "C" int fbpr_gn_round(float* stat, float* matP, const float* featc,
                             const float* feats, const float* candc,
                             const float* cands, int B, int Pc, int Ps, int K,
                             int iters, int min_corr, float eig_thresh,
                             float conv_rot_deg, float conv_trans_cm,
                             int jacobi_sweeps, float min_plane_spread,
                             void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FBPR_GN_CASE(KK)                                                   \
  case KK:                                                                 \
    fbpr::launch<KK>(stat, matP, featc, feats, candc, cands, B, Pc, Ps,    \
                     iters, min_corr, eig_thresh, conv_rot_deg,            \
                     conv_trans_cm, jacobi_sweeps, min_plane_spread, s);   \
    break;
  switch (K) {
    FBPR_GN_CASE(6)
    FBPR_GN_CASE(8)
    FBPR_GN_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FBPR_GN_CASE
  return (int)cudaGetLastError();
}
