// The IMU chain's Levenberg-Marquardt iterations on the card.
//
// Stands for `optimize_imu_chain` of the JAX package (graph/imu_graph.py):
// no Pallas kernel but one compiled device loop, a lax.scan of the LM steps
// (jacfwd residuals and Jacobian blocks of the chain's factors, their
// scatter into a dense H and grad, Jacobi scaling, damping,
// jax.scipy.linalg.solve, accept, lam).  The port's plain version
// (graph/imu_graph.py::optimize_imu_chain_reference) drives the same steps
// from the host as thousands of small launches.
//
//   fbpr_imu_chain_lm      the whole LM in one launch of one CTA (kThreads
//                          threads).  Once a solve: each interval's
//                          whitening factor chol(cov + 1e-10 I) (one thread
//                          an interval) and the cost.  An iteration: every
//                          factor's whitened residuals and Jacobian blocks
//                          (csrc/imu_chain.cuh; one thread a (factor,
//                          column): 30 columns of the IMU and bias factors,
//                          the pose prior's 15 and the init prior's 15 on
//                          the threads of the state-j columns), H's blocks
//                          and grad summed entry by entry in the plain
//                          version's order of additions (no float atomics),
//                          the Jacobi scaling and damping (as
//                          graph/pose_graph.py::_lm_solve_step), the
//                          block-tridiagonal Cholesky and its two solves
//                          (below), the step (0 on inactive states), the
//                          new cost, accept (the factorization held and
//                          the cost fell) and lam.
//                          Writes states [K, 15], the cost and each
//                          iteration's accept flag.
//   fbpr_imu_chain_blocks  chain_factor_blocks: the whitened residuals and
//                          Jacobian blocks at the given states (masked
//                          factors zeroed), one CTA a factor, one thread a
//                          column, from the same device function.
//
// The solve uses H's structure.  Factor k joins states max(k - 1, 0) and k,
// so H is block tridiagonal in 15 x 15 blocks, and so is its Cholesky
// factor: the dense factor has exact zeros outside the band.  The CTA
// factors it a block step at a time, L_kk = chol(A_kk - L_k,k-1
// L_k,k-1^T) and L_k+1,k = A_k+1,k L_kk^-T, with the forward solve L y = b
// inside (chain_factor): warp 0 takes the 30 x 15 panel [A_kk; A_k+1,k] a
// lane a row (a column step is a few shuffles, a square root and a
// division on the dependent path, the row updates on 30 lanes at once),
// 120 threads the Schur update of the next diagonal block, an entry each,
// and the other warps stage the block after next in shared memory
// (ChainSmem).  Warp 0 then solves L^T x = y (chain_backward_warp).  The
// blocks hold many exact zeros, and a zero dividend sends the IEEE
// division to its slow path: every division skips it (dense_lm.cuh's
// divide).  Each entry's subtractions run in the order of the dense
// right-looking factorization (csrc/pose_graph_lm.cu's route A), so the
// factor and the step are that factorization's, bit for bit.  A pivot
// that is not > 0 (NaN too) fails the factorization: a rejected step, as
// cholesky_ex's info != 0 is in the plain version.  The blocks, states,
// whitening factors and factor blocks take 1182 K + 240 floats of global
// scratch the caller allocates (kernels.imu_chain_floats), for every window
// size; only the blocks of the current and the next two steps are staged in
// shared memory.  The CTA has 512 threads, so the iteration's 30 K
// Jacobian columns are one pass at K 16.
//
// Built with -DFBPR_LM_PROFILE (chip_smoke.py's diagnostic build), the
// kernel stamps its stages (dense_lm.cuh's LmProf): 0 the prologue (the
// whitening factors, the first cost), then an iteration's 1 eval_column, 2
// assemble, 3 scale and damp, 4 block Cholesky with the forward solve, 5
// backward solve and step, 6 chain cost and accept, and 7 the epilogue;
// fbpr_imu_chain_lm_profile reads them.
//
// Bound.  Operations (chip_smoke.py's OPS_* and CHAIN_OPS_*, derived
// there): a step is each live factor's residuals once (0.70 kFLOP) and a
// tangent pass a Jacobian column (0.84 kFLOP for each of the IMU and bias
// factors' 30, 0.16 for each of the pose prior's 15), 24 kFLOP a state for
// the blocks of H and grad, 8.1 for a block of the Cholesky, 1.35 for the
// solves, and the new cost: at K = 16 some 1.0 MFLOP a step, ~0.015 us at
// the fp32 rate.  One CTA is latency-bound on the factorization's K
// dependent block steps (the panel's 15 column steps and the Schur update
// each) and the backward solve's K dependent blocks, not on either rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#ifdef FBPR_LM_PROFILE
#define FBPR_PROF
#endif
#include "clock_prof.cuh"
#include "pose_graph.cuh"
#include "dense_lm.cuh"
#include "imu_chain.cuh"

constexpr int kThreads = 512;
constexpr int kFactorFloats = 9 + 135 + 135 + 6 + 90 + 90 + 6 + 90;

// floats of a solve: P, Pn, pin, d, b, grad; the whitening factors; the
// factor blocks (Blocks); H's diagonal and lower blocks
__host__ __device__ constexpr long chain_floats(int K) {
  return 6L * kS * K + 81L * K + static_cast<long>(kFactorFloats) * K
         + kS + kS * kS + 2L * 225 * K;
}
static_assert(chain_floats(1) == 1182 + 240, "kernels.imu_chain_floats");

struct Layout {
  float *P, *Pn, *pin, *d, *b, *grad, *Lw, *Hd, *Hl;
  Blocks blk;
};

__device__ Layout layout(float* p, int K) {
  Layout l;
  const int D = kS * K;
  l.P = p;
  l.Pn = l.P + D;
  l.pin = l.Pn + D;
  l.d = l.pin + D;
  l.b = l.d + D;
  l.grad = l.b + D;
  l.Lw = l.grad + D;
  Blocks& b = l.blk;
  b.r_imu = l.Lw + 81 * K;
  b.Ji = b.r_imu + 9 * K;
  b.Jj = b.Ji + 135 * K;
  b.r_b = b.Jj + 135 * K;
  b.Jbi = b.r_b + 6 * K;
  b.Jbj = b.Jbi + 90 * K;
  b.r_pp = b.Jbj + 90 * K;
  b.Jpp = b.r_pp + 6 * K;
  b.r_0 = b.Jpp + 90 * K;
  b.J_0 = b.r_0 + kS;
  l.Hd = b.J_0 + kS * kS;
  l.Hl = l.Hd + 225 * K;  // block (k, k-1) at k; k = 0 unused
  return l;
}

// einsum("fab,fac->fbc", Ja, Jb)[f, b, c] of blocks [F, no, 15]
__device__ __forceinline__ float outer(const float* Ja, const float* Jb,
                                       int no, int f, int b, int c) {
  const float* x = Ja + f * no * kS;
  const float* y = Jb + f * no * kS;
  float h = 0.0f;
  for (int a = 0; a < no; ++a) h += x[a * kS + b] * y[a * kS + c];
  return h;
}

// einsum("fab,fa->fb", J, r)[f, b]
__device__ __forceinline__ float jtr(const float* J, const float* r, int no,
                                     int f, int b) {
  const float* x = J + f * no * kS;
  const float* y = r + f * no;
  float g = 0.0f;
  for (int a = 0; a < no; ++a) g += x[a * kS + b] * y[a];
  return g;
}

// H's diagonal block k, entry (b, c), in graph/imu_graph.py::_assemble's
// order of additions: per kind (IMU, bias) the (prev, prev) block of
// factor k + 1, at k = 0 that of factor 0, the (k, k) block of factor k,
// at k = 0 factor 0's (prev, k) and (k, prev); then the pose prior's; at
// k = 0 the init prior's J_0^T J_0
__device__ float diag_entry(const Blocks& B, int K, int k, int b, int c) {
  float h = 0.0f;
#pragma unroll 1
  for (int kind = 0; kind < 2; ++kind) {
    const float* Ja = kind ? B.Jbi : B.Ji;
    const float* Jb = kind ? B.Jbj : B.Jj;
    const int no = kind ? 6 : 9;
    if (k + 1 < K) h = h + outer(Ja, Ja, no, k + 1, b, c);
    if (k == 0) h = h + outer(Ja, Ja, no, 0, b, c);
    h = h + outer(Jb, Jb, no, k, b, c);
    if (k == 0) {
      h = h + outer(Ja, Jb, no, 0, b, c);
      h = h + outer(Jb, Ja, no, 0, b, c);
    }
  }
  h = h + outer(B.Jpp, B.Jpp, 6, k, b, c);
  if (k == 0) h = h + outer(B.J_0, B.J_0, kS, 0, b, c);
  return h;
}

// block (k, k - 1), k >= 1: the (k, prev) blocks of factor k
__device__ float low_entry(const Blocks& B, int k, int b, int c) {
  float h = 0.0f;
  h = h + outer(B.Jj, B.Ji, 9, k, b, c);
  h = h + outer(B.Jbj, B.Jbi, 6, k, b, c);
  return h;
}

__device__ float grad_entry(const Blocks& B, int K, int k, int b) {
  float g = 0.0f;
#pragma unroll 1
  for (int kind = 0; kind < 2; ++kind) {
    const float* Ja = kind ? B.Jbi : B.Ji;
    const float* Jb = kind ? B.Jbj : B.Jj;
    const float* r = kind ? B.r_b : B.r_imu;
    const int no = kind ? 6 : 9;
    if (k + 1 < K) g = g + jtr(Ja, r, no, k + 1, b);
    if (k == 0) g = g + jtr(Ja, r, no, 0, b);
    g = g + jtr(Jb, r, no, k, b);
  }
  g = g + jtr(B.Jpp, B.r_pp, 6, k, b);
  if (k == 0) g = g + jtr(B.J_0, B.r_0, kS, 0, b);
  return g;
}

// H's blocks and grad from the factor blocks; ends with a barrier
template <int NT>
__device__ void assemble(const Blocks& B, int K, float* Hd, float* Hl,
                         float* grad) {
  const int nb = 225 * K, ng = kS * K;
  for (int e = threadIdx.x; e < 2 * nb + ng; e += NT) {
    if (e < nb) {
      Hd[e] = diag_entry(B, K, e / 225, e % 225 / kS, e % kS);
    } else if (e < 2 * nb) {
      const int e2 = e - nb, k = e2 / 225;
      if (k > 0) Hl[e2] = low_entry(B, k, e2 % 225 / kS, e2 % kS);
    } else {
      const int e3 = e - 2 * nb;
      grad[e3] = grad_entry(B, K, e3 / kS, e3 % kS);
    }
  }
  __syncthreads();
}

// d = sqrt(max(diag H, 1e-12)) + pin; A = H / (d d^T) + diag(lam + pin) on
// the blocks; b = -grad / d (graph/pose_graph.py::_lm_solve_step's
// scaling, entry by entry as there, blockwise)
template <int NT>
__device__ void scale_damp(float* Hd, float* Hl, int K, const float* grad,
                           const float* pin, float lam, float* d, float* b) {
  const int D = kS * K, tid = threadIdx.x;
  for (int e = tid; e < D; e += NT)
    d[e] = sqrtf(clamp_min_nan(Hd[(e / kS) * 225 + (e % kS) * (kS + 1)],
                               1e-12f)) + pin[e];
  __syncthreads();
  for (int e = tid; e < D; e += NT) b[e] = divide(-grad[e], d[e]);
  for (int e = tid; e < 225 * K; e += NT) {
    const int k = e / 225, i = e % 225 / kS, j = e % kS;
    const int r = kS * k + i, c = kS * k + j;
    float v = divide(Hd[e], d[r] * d[c]);
    if (i == j) v = v + (lam + pin[r]);
    Hd[e] = v;
  }
  for (int e = 225 + tid; e < 225 * K; e += NT) {
    const int k = e / 225, i = e % 225 / kS, j = e % kS;
    Hl[e] = divide(Hl[e], d[kS * k + i] * d[kS * (k - 1) + j]);
  }
  __syncthreads();
}

// The shared memory of the block factorization: the current step's blocks
// (A, X) and the next ones' as scale_damp left them (An, Xn, bn: block m
// at m & 1, staged a step ahead), and the backward solve's two L_kk (Ls)
struct ChainSmem {
  float A[225];       // A_kk less L_k,k-1 L_k,k-1^T (its lower triangle)
  float X[225];       // L_k+1,k
  float An[2][225];   // A_mm
  float Xn[2][225];   // A_m,m-1
  float bn[2][kS];    // b_m
  float bs[2][kS];    // b_m less L_m,m-1 y_m-1
  float Ls[450];
};

// block m's A_mm, A_m,m-1 and b_m into An, Xn and bn at m & 1, on the
// threads t0, t0 + nt, ...
__device__ void stage_block(const float* Hd, const float* Hl, const float* b,
                            int m, ChainSmem& s, int t0, int nt) {
  for (int e = t0; e < 450 + kS; e += nt) {
    if (e < 225)
      s.An[m & 1][e] = Hd[225 * m + e];
    else if (e < 450)
      s.Xn[m & 1][e - 225] = Hl[225 * m + e - 225];
    else
      s.bn[m & 1][e - 450] = b[kS * m + e - 450];
  }
}

// The block-tridiagonal Cholesky of the scaled, damped H (Hd's lower
// triangles become L_kk, Hl's blocks L_k,k-1) with the forward solve L y = b
// (b <- y), on the CTA, a step a block.  Step k:
//  - warp 0 factors the 30 x 15 panel [A_kk; A_k+1,k] column by column, a
//    lane a row (lanes 0-14 the rows of A_kk, lanes 15-29 those of A_k+1,k;
//    lanes 30-31 run on a copy and write nothing): column j's pivot and
//    L_cj shuffled from their lanes, each row updated by its own lane, y_j
//    shuffled to every lane.  So L_k+1,k = A_k+1,k L_kk^-T and b_k+1 less
//    L_k+1,k y_k ride on L_kk's column steps, with no shuffle of their own;
//  - meanwhile the other warps stage block k + 2 in shared memory;
//  - after a barrier, 120 threads take the Schur update A_k+1,k+1 less
//    L_k+1,k L_k+1,k^T, an entry each, its 15 subtractions in column order;
//    a barrier.
// Every entry's subtractions run in the order of the dense right-looking
// factorization (csrc/pose_graph_lm.cu's route A), so the factor and the
// step are that factorization's, bit for bit.  Every thread calls it;
// returns whether it failed (in every thread).  Ends with a barrier.
template <int NT>
__device__ bool chain_factor(float* Hd, float* Hl, int K, float* b,
                             ChainSmem& s, int* flag) {
  const unsigned kAll = 0xffffffffu;
  const int tid = threadIdx.x, lane = tid & 31;
  for (int e = tid; e < 225 + kS; e += NT) {
    if (e < 225)
      s.A[e] = Hd[e];
    else
      s.bs[0][e - 225] = b[e - 225];
  }
  if (K > 1 && tid >= 32) stage_block(Hd, Hl, b, 1, s, tid - 32, NT - 32);
  if (tid == 0) *flag = 0;
  __syncthreads();
  const bool diag = lane < kS;
  const int r = diag ? lane : lane < 2 * kS ? lane - kS : 0;
  bool failed = false;
  for (int k = 0; k < K; ++k) {
    const bool next = k + 1 < K;
    if (tid < 32) {
      const bool low = !diag && next;  // a row of A_k+1,k
      const float* row = low ? s.Xn[(k + 1) & 1] + r * kS : s.A + r * kS;
      float a[kS], bi = low ? s.bn[(k + 1) & 1][r] : s.bs[k & 1][r];
#pragma unroll
      for (int c = 0; c < kS; ++c) a[c] = row[c];
      bool ok = true;  // no exit inside the loop: it stays unrolled
#pragma unroll
      for (int j = 0; j < kS; ++j) {
        const float p = __shfl_sync(kAll, a[j], j);
        ok = ok && p > 0.0f;
        const float l = sqrtf(p);
        // one division a lane: lane j's y_j = b_j / l, the others' L_ij
        const float v = divide(lane == j ? bi : a[j], l);
        const float y = __shfl_sync(kAll, v, j);
        a[j] = lane == j ? l : v;  // lanes < j: above the diagonal, unread
        bi = lane == j ? y : lane > j ? bi - a[j] * y : bi;
#pragma unroll
        for (int c = j + 1; c < kS; ++c) {
          const float lc = __shfl_sync(kAll, a[j], c);
          a[c] = a[c] - a[j] * lc;  // lanes < c: unread
        }
      }
      if (!ok) {
        if (lane == 0) *flag = 1;
      } else if (diag) {
        float* Lk = Hd + 225 * k + lane * kS;
#pragma unroll
        for (int c = 0; c < kS; ++c)
          if (c <= lane) Lk[c] = a[c];
        b[kS * k + lane] = bi;
      } else if (low && lane < 2 * kS) {
        float* Xo = Hl + 225 * (k + 1) + r * kS;
#pragma unroll
        for (int c = 0; c < kS; ++c) {
          s.X[r * kS + c] = a[c];
          Xo[c] = a[c];
        }
        s.bs[(k + 1) & 1][r] = bi;
      }
    } else if (k + 2 < K) {
      stage_block(Hd, Hl, b, k + 2, s, tid - 32, NT - 32);
    }
    __syncthreads();
    failed = *flag != 0;
    if (failed || !next) break;
    if (tid < 225) {
      const int i = tid / kS, j = tid % kS;
      if (j <= i) {
        const float* xi = s.X + i * kS;
        const float* xj = s.X + j * kS;
        float v = s.An[(k + 1) & 1][tid];
#pragma unroll
        for (int c = 0; c < kS; ++c) v = v - xi[c] * xj[c];
        s.A[tid] = v;
      }
    }
    __syncthreads();
  }
  return failed;
}

// L^T x = y (b <- x) with the block factor, on warp 0: every lane keeps
// the current block's x (all 15 entries) and runs its in-block solve with
// L_kk from Ls (two buffers of 225 floats); lane i < 15 takes L_k,k-1^T
// x_k's entry i from its column of L_k,k-1, and the lanes exchange them.
// The next block's L_kk is loaded while block k is solved.
__device__ void chain_backward_warp(const float* Hd, const float* Hl, int K,
                                    float* b, float* Ls) {
  const int lane = threadIdx.x & 31;
  const int i = lane < kS ? lane : 0;
  float xb[kS], pre[8];
#pragma unroll
  for (int c = 0; c < kS; ++c) xb[c] = b[kS * (K - 1) + c];
#pragma unroll
  for (int r = 0; r < 8; ++r)
    if (lane + 32 * r < 225) pre[r] = Hd[225 * (K - 1) + lane + 32 * r];
  for (int k = K - 1; k >= 0; --k) {
    float* S = Ls + 225 * (k & 1);
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if (lane + 32 * r < 225) S[lane + 32 * r] = pre[r];
    float lc[kS], bp = 0.0f;  // column i of L_k,k-1; b_k-1's entry i
    if (k > 0) {
      const float* Lk = Hl + 225 * k;
#pragma unroll
      for (int m = 0; m < kS; ++m) lc[m] = Lk[m * kS + i];
      bp = b[kS * (k - 1) + i];
#pragma unroll
      for (int r = 0; r < 8; ++r)
        if (lane + 32 * r < 225) pre[r] = Hd[225 * (k - 1) + lane + 32 * r];
    }
    __syncwarp();
#pragma unroll
    for (int j = kS - 1; j >= 0; --j) {
      xb[j] = divide(xb[j], S[j * kS + j]);
#pragma unroll
      for (int c = 0; c < j; ++c) xb[c] = xb[c] - S[j * kS + c] * xb[j];
    }
#pragma unroll
    for (int c = 0; c < kS; ++c)
      if (c == lane) b[kS * k + c] = xb[c];
    if (k == 0) break;
#pragma unroll
    for (int m = kS - 1; m >= 0; --m) bp = bp - lc[m] * xb[m];
#pragma unroll
    for (int c = 0; c < kS; ++c)
      xb[c] = __shfl_sync(0xffffffffu, bp, c);
  }
}

// The cost: sum of squared whitened residuals, each kind summed over the
// factors in a fixed order, then IMU + bias + pose prior + init prior as
// graph/imu_graph.py::_cost adds them (every thread gets it)
template <int NT>
__device__ float chain_cost(const ChainData& c, const float* P,
                            const float* Lw, float* red) {
  float s[3] = {0.0f, 0.0f, 0.0f};
  for (int base = 0; base < c.K; base += NT) {
    const int k = base + threadIdx.x;
    float e[3] = {0.0f, 0.0f, 0.0f};
    if (k < c.K) factor_sq(c, P, Lw + 81 * k, k, e);
#pragma unroll
    for (int kind = 0; kind < 3; ++kind) s[kind] += block_sum<NT>(e[kind], red);
  }
  float s0[kS], r0[kS], e0 = 0.0f;
  load_state<float>(P, -1, s0);
  init_prior_res<float>(c, s0, r0);
#pragma unroll
  for (int o = 0; o < kS; ++o) e0 += r0[o] * r0[o];
  return ((s[0] + s[1]) + s[2]) + e0;
}

struct LmArgs {
  ChainData c;
  int iterations;
  float* scratch;     // global scratch of chain_floats(K) floats
  float* out_states;  // [K, 15]
  float* out_cost;    // []
  int* accepts;       // [iterations]
};

__global__ void __launch_bounds__(kThreads, 1) imu_chain_lm_kernel(
    LmArgs a) {
  __shared__ float red[32];
  __shared__ ChainSmem sm;
  __shared__ int failed_flag;
  const ChainData& c = a.c;
  const int K = c.K, D = kS * K, tid = threadIdx.x;
  const Layout l = layout(a.scratch, K);
  LmProf prof;
  prof.start();

  for (int e = tid; e < D; e += kThreads) {
    l.P[e] = c.states[e];
    l.pin[e] = c.state_mask[e / kS] ? 0.0f : 1.0f;
  }
  for (int k = tid; k < K; k += kThreads)
    whiten_factor(c.cov + 81 * k, l.Lw + 81 * k);
  __syncthreads();
  float cost = chain_cost<kThreads>(c, l.P, l.Lw, red);
  float lam = 1e-4f;
  prof.stamp(0);
  for (int it = 0; it < a.iterations; ++it) {
    for (int item = tid; item < 30 * K; item += kThreads) {
      const int k = item / 30;
      eval_column(c, l.P, l.Lw + 81 * k, k, item % 30, l.blk);
    }
    __syncthreads();
    prof.stamp(1);
    assemble<kThreads>(l.blk, K, l.Hd, l.Hl, l.grad);
    prof.stamp(2);
    scale_damp<kThreads>(l.Hd, l.Hl, K, l.grad, l.pin, lam, l.d, l.b);
    prof.stamp(3);
    const bool failed =
        chain_factor<kThreads>(l.Hd, l.Hl, K, l.b, sm, &failed_flag);
    prof.stamp(4);
    if (tid < 32 && !failed) chain_backward_warp(l.Hd, l.Hl, K, l.b, sm.Ls);
    __syncthreads();
    bool accept = false;
    float new_cost = 0.0f;
    if (!failed) {
      for (int e = tid; e < D; e += kThreads)
        l.Pn[e] = l.P[e]
                  + (l.pin[e] == 0.0f ? divide(l.b[e], l.d[e]) : 0.0f);
    }
    prof.stamp(5);
    if (!failed) {
      __syncthreads();
      new_cost = chain_cost<kThreads>(c, l.Pn, l.Lw, red);
      accept = new_cost < cost;
    }
    if (accept) {
      for (int e = tid; e < D; e += kThreads) l.P[e] = l.Pn[e];
      cost = new_cost;
    }
    lam = lm_next_lambda(lam, accept);
    if (tid == 0) a.accepts[it] = accept;
    __syncthreads();
    prof.stamp(6);
  }
  for (int e = tid; e < D; e += kThreads) a.out_states[e] = l.P[e];
  if (tid == 0) *a.out_cost = cost;
  prof.stamp(7);
  prof.finish(a.iterations);
}

__global__ void __launch_bounds__(32) imu_chain_blocks_kernel(
    ChainData c, const float* P, Blocks b) {
  __shared__ float Lk[81];
  const int k = blockIdx.x;
  if (threadIdx.x == 0) whiten_factor(c.cov + 81 * k, Lk);
  __syncthreads();
  if (threadIdx.x < 30) eval_column(c, P, Lk, k, threadIdx.x, b);
}

}  // namespace

#define FBPR_CHAIN_PARAMS                                                    \
  const float *states, const uint8_t *state_mask, const float *dR,          \
      const float *dv, const float *dp, const float *dt,                    \
      const float *dR_dbg, const float *dv_dba, const float *dv_dbg,        \
      const float *dp_dba, const float *dp_dbg, const float *cov,           \
      const float *bias_acc, const float *bias_gyr,                         \
      const uint8_t *preint_mask, const float *pose_meas,                   \
      const float *pose_sigma, const uint8_t *pose_meas_mask,               \
      const float *prior_state, const float *prior_sigma,                   \
      const float *bias_sigma, const float *gravity, int K
#define FBPR_CHAIN_ARGS                                                      \
  ChainData {                                                                \
    states, state_mask, dR, dv, dp, dt, dR_dbg, dv_dba, dv_dbg, dp_dba,     \
        dp_dbg, cov, bias_acc, bias_gyr, preint_mask, pose_meas,            \
        pose_sigma, pose_meas_mask, prior_state, prior_sigma, bias_sigma,   \
        gravity, K                                                           \
  }

extern "C" int fbpr_imu_chain_lm(FBPR_CHAIN_PARAMS, int iterations,
                                 float* scratch, int64_t scratch_floats,
                                 float* out_states, float* out_cost,
                                 int* accepts, void* stream) {
  if (K <= 0 || iterations < 0 || scratch == nullptr
      || scratch_floats < chain_floats(K))
    return static_cast<int>(cudaErrorInvalidValue);
  LmArgs a{FBPR_CHAIN_ARGS, iterations, scratch, out_states, out_cost,
           accepts};
  imu_chain_lm_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

#ifdef FBPR_LM_PROFILE
// The diagnostic build's stage sums (dense_lm.cuh's g_lm_prof, 12
// values) into out; reset != 0 zeroes them after.  Synchronous.
extern "C" int fbpr_imu_chain_lm_profile(unsigned long long* out,
                                         int reset) {
  return prof_read(g_lm_prof, out, reset);
}
#endif

extern "C" int fbpr_imu_chain_blocks(FBPR_CHAIN_PARAMS, const float* at,
                                     float* r_imu, float* Ji, float* Jj,
                                     float* r_b, float* Jbi, float* Jbj,
                                     float* r_pp, float* Jpp, float* r_0,
                                     float* J_0, void* stream) {
  if (K <= 0) return static_cast<int>(cudaErrorInvalidValue);
  Blocks b{r_imu, Ji, Jj, r_b, Jbi, Jbj, r_pp, Jpp, r_0, J_0};
  imu_chain_blocks_kernel<<<K, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      FBPR_CHAIN_ARGS, at, b);
  return static_cast<int>(cudaGetLastError());
}
