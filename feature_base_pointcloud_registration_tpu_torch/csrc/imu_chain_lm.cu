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
//                          the Jacobi scaling and damping of
//                          csrc/dense_lm.cuh, the block-tridiagonal
//                          Cholesky and its two solves (below), the step (0
//                          on inactive states), the new cost, accept (the
//                          factorization held and the cost fell) and lam.
//                          Writes states [K, 15], the cost and each
//                          iteration's accept flag.
//   fbpr_imu_chain_blocks  chain_factor_blocks: the whitened residuals and
//                          Jacobian blocks at the given states (masked
//                          factors zeroed), one CTA a factor, one thread a
//                          column, from the same device function.
//
// The solve uses H's structure.  Factor k joins states max(k - 1, 0) and k,
// so H is block tridiagonal in 15 x 15 blocks, and so is its Cholesky
// factor: the dense factor has exact zeros outside the band.  One warp
// factors it block by block in place, L_kk = chol(A_kk - L_k,k-1
// L_k,k-1^T) and L_k+1,k = A_k+1,k L_kk^-T, each entry's subtractions in
// the order of the dense right-looking factorization (csrc/dense_lm.cuh's
// cholesky_lower), and solves L y = b, L^T x = y the same way.  A pivot
// that is not > 0 (NaN too) fails the factorization: a rejected step, as
// cholesky_ex's info != 0 is in the plain version.  The blocks, states,
// whitening factors and factor blocks take 1182 K + 240 floats of global
// scratch the caller allocates (kernels.imu_chain_floats), for every window
// size.  A shared-memory copy of the same code (up to K 48) ran 4% faster
// at K 16 on an H100 (1.5059 against 1.5682 ms a solve), 0.06 ms of a
// ~72 ms LIO step: one route is kept (PERF.md).
//
// Bound.  Operations (chip_smoke.py's OPS_* and CHAIN_OPS_*, derived
// there): a step is each live factor's residuals once (0.70 kFLOP) and a
// tangent pass a Jacobian column (0.84 kFLOP for each of the IMU and bias
// factors' 30, 0.16 for each of the pose prior's 15), 24 kFLOP a state for
// the blocks of H and grad, 8.1 for a block of the Cholesky, 1.35 for the
// solves, and the new cost: at K = 16 some 1.0 MFLOP a step, ~0.015 us at
// the fp32 rate.  One CTA is latency-bound on the factorization's K
// dependent block steps (~45 warp barriers each) and the solves' 2 x 15 K
// dependent steps, not on either rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#include "pose_graph.cuh"
#include "dense_lm.cuh"
#include "imu_chain.cuh"

constexpr int kThreads = 256;
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
// the blocks; b = -grad / d (csrc/dense_lm.cuh's lm_scale_damp, blockwise)
template <int NT>
__device__ void scale_damp(float* Hd, float* Hl, int K, const float* grad,
                           const float* pin, float lam, float* d, float* b) {
  const int D = kS * K, tid = threadIdx.x;
  for (int e = tid; e < D; e += NT)
    d[e] = sqrtf(clamp_min_nan(Hd[(e / kS) * 225 + (e % kS) * (kS + 1)],
                               1e-12f)) + pin[e];
  __syncthreads();
  for (int e = tid; e < D; e += NT) b[e] = -grad[e] / d[e];
  for (int e = tid; e < 225 * K; e += NT) {
    const int k = e / 225, i = e % 225 / kS, j = e % kS;
    const int r = kS * k + i, c = kS * k + j;
    float v = Hd[e] / (d[r] * d[c]);
    if (i == j) v = v + (lam + pin[r]);
    Hd[e] = v;
  }
  for (int e = 225 + tid; e < 225 * K; e += NT) {
    const int k = e / 225, i = e % 225 / kS, j = e % kS;
    Hl[e] = Hl[e] / (d[kS * k + i] * d[kS * (k - 1) + j]);
  }
  __syncthreads();
}

// The block-tridiagonal Cholesky of the scaled, damped H in place (Hd's
// lower triangles become L_kk, Hl's blocks L_k,k-1), on one warp (every
// lane calls it).  Returns whether it failed (the same answer in every
// lane).
__device__ bool block_cholesky_warp(float* Hd, float* Hl, int K) {
  const int lane = threadIdx.x & 31;
  for (int k = 0; k < K; ++k) {
    float* A = Hd + 225 * k;
    if (k > 0) {
      const float* Lk = Hl + 225 * k;
      // A_kk - L_k,k-1 L_k,k-1^T on the lower triangle, column by column
      for (int e = lane; e < 120; e += 32) {
        int i = 0;
        while ((i + 1) * (i + 2) / 2 <= e) ++i;
        const int j = e - i * (i + 1) / 2;
        float s = A[i * kS + j];
        for (int m = 0; m < kS; ++m) s = s - Lk[i * kS + m] * Lk[j * kS + m];
        A[i * kS + j] = s;
      }
      __syncwarp();
    }
    for (int j = 0; j < kS; ++j) {
      const float p = A[j * kS + j];
      if (!(p > 0.0f)) return true;
      const float l = sqrtf(p);
      if (lane > j && lane < kS) A[lane * kS + j] = A[lane * kS + j] / l;
      __syncwarp();
      if (lane == 0) A[j * kS + j] = l;
      if (lane > j && lane < kS) {
        const float li = A[lane * kS + j];
        for (int c = j + 1; c <= lane; ++c)
          A[lane * kS + c] = A[lane * kS + c] - li * A[c * kS + j];
      }
      __syncwarp();
    }
    if (k + 1 < K) {
      // L_k+1,k = A_k+1,k L_kk^-T: row by row (a lane each), its
      // subtractions column by column
      float* X = Hl + 225 * (k + 1);
      if (lane < kS) {
        for (int c = 0; c < kS; ++c) {
          float v = X[lane * kS + c];
          for (int m = 0; m < c; ++m) v = v - X[lane * kS + m] * A[c * kS + m];
          X[lane * kS + c] = v / A[c * kS + c];
        }
      }
      __syncwarp();
    }
  }
  return false;
}

// b <- (L L^T)^-1 b with the block factor, on one warp
__device__ void block_solve_warp(const float* Hd, const float* Hl, int K,
                                 float* b) {
  const int lane = threadIdx.x & 31;
  for (int k = 0; k < K; ++k) {
    const float* A = Hd + 225 * k;
    float* bk = b + kS * k;
    if (k > 0) {
      const float* Lk = Hl + 225 * k;
      const float* y = bk - kS;
      if (lane < kS) {
        float v = bk[lane];
        for (int m = 0; m < kS; ++m) v = v - Lk[lane * kS + m] * y[m];
        bk[lane] = v;
      }
      __syncwarp();
    }
    for (int j = 0; j < kS; ++j) {
      const float y = bk[j] / A[j * kS + j];
      __syncwarp();
      if (lane == 0) bk[j] = y;
      if (lane > j && lane < kS) bk[lane] = bk[lane] - A[lane * kS + j] * y;
      __syncwarp();
    }
  }
  for (int k = K - 1; k >= 0; --k) {
    const float* A = Hd + 225 * k;
    float* bk = b + kS * k;
    for (int j = kS - 1; j >= 0; --j) {
      const float x = bk[j] / A[j * kS + j];
      __syncwarp();
      if (lane == 0) bk[j] = x;
      if (lane < j) bk[lane] = bk[lane] - A[j * kS + lane] * x;
      __syncwarp();
    }
    if (k > 0) {
      // L_k,k-1^T x_k from block k - 1, columns from the last
      const float* Lk = Hl + 225 * k;
      float* bp = bk - kS;
      if (lane < kS) {
        float v = bp[lane];
        for (int m = kS - 1; m >= 0; --m) v = v - Lk[m * kS + lane] * bk[m];
        bp[lane] = v;
      }
      __syncwarp();
    }
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
  __shared__ int failed_flag;
  const ChainData& c = a.c;
  const int K = c.K, D = kS * K, tid = threadIdx.x;
  const Layout l = layout(a.scratch, K);

  for (int e = tid; e < D; e += kThreads) {
    l.P[e] = c.states[e];
    l.pin[e] = c.state_mask[e / kS] ? 0.0f : 1.0f;
  }
  for (int k = tid; k < K; k += kThreads)
    whiten_factor(c.cov + 81 * k, l.Lw + 81 * k);
  __syncthreads();
  float cost = chain_cost<kThreads>(c, l.P, l.Lw, red);
  float lam = 1e-4f;
  for (int it = 0; it < a.iterations; ++it) {
    for (int item = tid; item < 30 * K; item += kThreads) {
      const int k = item / 30;
      eval_column(c, l.P, l.Lw + 81 * k, k, item % 30, l.blk);
    }
    __syncthreads();
    assemble<kThreads>(l.blk, K, l.Hd, l.Hl, l.grad);
    scale_damp<kThreads>(l.Hd, l.Hl, K, l.grad, l.pin, lam, l.d, l.b);
    if (tid < 32) {
      const bool failed = block_cholesky_warp(l.Hd, l.Hl, K);
      if (!failed) block_solve_warp(l.Hd, l.Hl, K, l.b);
      if (tid == 0) failed_flag = failed;
    }
    __syncthreads();
    const bool failed = failed_flag != 0;
    bool accept = false;
    float new_cost = 0.0f;
    if (!failed) {
      for (int e = tid; e < D; e += kThreads)
        l.Pn[e] = l.P[e] + (l.pin[e] == 0.0f ? l.b[e] / l.d[e] : 0.0f);
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
  }
  for (int e = tid; e < D; e += kThreads) a.out_states[e] = l.P[e];
  if (tid == 0) *a.out_cost = cost;
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
