// One round of the rounds-structured solver's Gauss-Newton iterations: one
// CTA runs a whole round for one lane.
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
//      warp 0 adds the warps' sums in warp order);
//   2. gn_step's tail on warp 0: the symmetric eigen-solve of JtJ on every
//      iteration by cyclic Jacobi run to convergence (a rotation is skipped
//      where |a_pq| <= 1e-7 sqrt(|a_pp a_qq|); the sweeps stop when one
//      rotates nothing, or at kMaxSweeps); x = V diag(1 / lam_safe) V^T Jtb
//      with lam_safe = lam where |lam| > 1e-9, else 1e-9; at the lane's
//      global iteration 0 (stat[6] == 0) matP = V diag(lam >= eig_thresh)
//      V^T and the degeneracy flag; x <- matP x when degenerate; pose += x
//      when n_corr >= min_corr; converged when also |dR| < conv_rot_deg and
//      |dt| < conv_trans_cm.  x and matP do not depend on the order or the
//      signs of the eigenvectors, so the Jacobi stands for
//      torch.linalg.eigh within float noise.  Every lane of warp 0 holds
//      all of A (no shuffle on the chain of dependent rotations); lane
//      k < 6 holds row k of V.
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
// Launch: one CTA of kThreads a lane.  At B = 1 (the step paths) that is
// one SM of the card; spreading a lane over a cluster is later work.

#include "gn_tile.cuh"

namespace fbpr {
namespace {

constexpr int kMaxSweeps = 12;
constexpr float kJacobiTol = 1e-7f;
constexpr float kRadToDeg = 57.29577951308232f;

// Warp 0: eigen-solve of the symmetric JtJ (g: lane m < 28 holds G[m]).
// Returns the eigenvalues in lam (every lane) and V row-major in sV.
__device__ void eigh_warp(float g, int lane, float (&lam)[6], float* sV) {
  const int k = lane < 6 ? lane : 5;
  float A[6][6], V[6];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) A[i][j] = g_at(g, i, j);
#pragma unroll
  for (int j = 0; j < 6; ++j) V[j] = k == j ? 1.0f : 0.0f;
  for (int sw = 0; sw < kMaxSweeps; ++sw) {
    bool rotated = false;
#pragma unroll
    for (int p = 0; p < 6; ++p)
#pragma unroll
      for (int q = p + 1; q < 6; ++q) {
        const float apq = A[p][q], app = A[p][p], aqq = A[q][q];
        if (!(fabsf(apq) > kJacobiTol * sqrtf(fabsf(app * aqq)))) continue;
        rotated = true;
        const float tau = (aqq - app) / (2.0f * apq);
        const float t = (tau >= 0.0f ? 1.0f : -1.0f) /
                        (fabsf(tau) + hypotf(1.0f, tau));
        const float c = 1.0f / sqrtf(1.0f + t * t);
        const float s = t * c;
#pragma unroll
        for (int r = 0; r < 6; ++r) {
          if (r == p || r == q) continue;
          const float arp = A[r][p], arq = A[r][q];
          A[r][p] = A[p][r] = c * arp - s * arq;
          A[r][q] = A[q][r] = s * arp + c * arq;
        }
        A[p][p] = app - t * apq;
        A[q][q] = aqq + t * apq;
        A[p][q] = A[q][p] = 0.0f;
        const float vkp = V[p], vkq = V[q];
        V[p] = c * vkp - s * vkq;
        V[q] = s * vkp + c * vkq;
      }
    if (!rotated) break;
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) lam[i] = A[i][i];
  if (lane < 6) {
#pragma unroll
    for (int j = 0; j < 6; ++j) sV[lane * 6 + j] = V[j];
  }
  __syncwarp();
}

// Warp 0: gn_step's tail (ops/solver.py) for one lane.
__device__ void step_warp(float g, int lane, float* st, float* mp, float* sV,
                          int min_corr, float eig_thresh, float conv_rot_deg,
                          float conv_trans_cm) {
  const float n_corr = __shfl_sync(kFull, g, kG - 1);
  const bool enough = n_corr >= (float)min_corr;
  float lam[6];
  eigh_warp(g, lane, lam, sV);
  float b[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) b[i] = g_at(g, i, 6);
  const int i = lane < 6 ? lane : 5;

  // z = diag(1 / lam_safe) V^T Jtb on lane j = i, then x = V z on lane i
  float zi = 0.0f;
#pragma unroll
  for (int r = 0; r < 6; ++r) zi += sV[r * 6 + i] * b[r];
  float li = lam[0];
#pragma unroll
  for (int j = 1; j < 6; ++j) li = i == j ? lam[j] : li;
  zi = zi / (fabsf(li) > 1e-9f ? li : 1e-9f);
  float xi = 0.0f;
#pragma unroll
  for (int j = 0; j < 6; ++j)
    xi += sV[i * 6 + j] * __shfl_sync(kFull, zi, j);

  if (st[6] == 0.0f) {  // the lane's global iteration 0
    float isdeg = 0.0f;
    float good[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      good[j] = lam[j] >= eig_thresh ? 1.0f : 0.0f;
      isdeg = fmaxf(isdeg, 1.0f - good[j]);
    }
    for (int e = lane; e < 36; e += 32) {
      const int r = e / 6, c = e % 6;
      float pij = 0.0f;
#pragma unroll
      for (int j = 0; j < 6; ++j)
        pij += sV[r * 6 + j] * good[j] * sV[c * 6 + j];
      mp[e] = pij;
    }
    __syncwarp();
    if (lane == 0) st[8] = isdeg;
    __syncwarp();
  }
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
  float dr2 = 0.0f, dt2 = 0.0f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float r = x[j] * kRadToDeg, t = x[3 + j] * 100.0f;
    dr2 += r * r;
    dt2 += t * t;
  }
  const bool conv = enough && sqrtf(dr2) < conv_rot_deg &&
                    sqrtf(dt2) < conv_trans_cm;
  __syncwarp();  // every lane has read st[6] and st[8]
  if (lane < 6 && enough) st[lane] = st[lane] + xi;
  if (lane == 0) {
    st[6] = st[6] + 1.0f;
    st[7] = conv ? 1.0f : 0.0f;
    st[10] = n_corr;
  }
  __syncwarp();
}

// Two CTAs an SM up to K=8; K=16 takes one (gn_round.cu's budget).
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
                 float min_plane_spread, bool use_list) {
  extern __shared__ uint16_t s_list[];  // live corner, then surf, indices
  __shared__ float s_st[kStat];
  __shared__ float s_mp[36];
  __shared__ float s_fr[kFrame];
  __shared__ float s_red[kWarps][kG];
  __shared__ float s_V[36];
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
  if (warp == 0) next_frame(s_st, lane, iters > 0, s_fr, &s_active);
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    if (!s_active) break;

    float acc[32];
#pragma unroll
    for (int m = 0; m < 32; ++m) acc[m] = 0.0f;
    int c = tid;
    for (; c < nc; c += kThreads)
      add_point<K, false, true>(acc, fc, Pc, cc, dc, qc,
                                use_list ? s_list[c] : c, s_fr,
                                min_plane_spread);
    for (; c < nc + ns; c += kThreads) {
      const int p = use_list ? s_list[c] : c - nc;
      add_point<K, true, true>(acc, fs, Ps, cs, ds, qs, p, s_fr,
                               min_plane_spread);
    }
    reduce_scatter28(acc, lane);
    if (lane < kG) s_red[warp][lane] = acc[0];
    __syncthreads();
    if (warp == 0) {
      float g = 0.0f;
      if (lane < kG)
        for (int w = 0; w < kWarps; ++w) g += s_red[w][lane];
      step_warp(g, lane, s_st, s_mp, s_V, min_corr, eig_thresh,
                conv_rot_deg, conv_trans_cm);
      next_frame(s_st, lane, it + 1 < iters, s_fr, &s_active);
    }
    __syncthreads();
  }
  if (tid < kStat) stat[(int64_t)b * kStat + tid] = s_st[tid];
  if (tid < 36) matP[(int64_t)b * 36 + tid] = s_mp[tid];
}

template <int K>
void launch(float* stat, float* matP, const float* featc, const float* feats,
            const float* candc, const float* cands, const float* cd2,
            const float* sd2, int B, int Pc, int Ps, int iters, int min_corr,
            float eig_thresh, float conv_rot_deg, float conv_trans_cm,
            float min_plane_spread, cudaStream_t stream) {
  const bool use_list = (int64_t)Pc + Ps <= kMaxList;
  const size_t smem = use_list ? sizeof(uint16_t) * (Pc + Ps) : 0;
  rounds_gn_kernel<K><<<B, kThreads, smem, stream>>>(
      stat, matP, featc, feats, candc, cands, cd2, sd2, B, Pc, Ps, iters,
      min_corr, eig_thresh, conv_rot_deg, conv_trans_cm, min_plane_spread,
      use_list);
}

}  // namespace
}  // namespace fbpr

extern "C" int fbpr_rounds_gn(float* stat, float* matP, const float* featc,
                              const float* feats, const float* candc,
                              const float* cands, const float* cd2,
                              const float* sd2, int B, int Pc, int Ps, int K,
                              int iters, int min_corr, float eig_thresh,
                              float conv_rot_deg, float conv_trans_cm,
                              float min_plane_spread, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FBPR_ROUNDS_CASE(KK)                                               \
  case KK:                                                                 \
    fbpr::launch<KK>(stat, matP, featc, feats, candc, cands, cd2, sd2, B,  \
                     Pc, Ps, iters, min_corr, eig_thresh, conv_rot_deg,    \
                     conv_trans_cm, min_plane_spread, s);                  \
    break;
  switch (K) {
    FBPR_ROUNDS_CASE(6)
    FBPR_ROUNDS_CASE(8)
    FBPR_ROUNDS_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FBPR_ROUNDS_CASE
  return (int)cudaGetLastError();
}
