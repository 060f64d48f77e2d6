// The IMU preintegration and the IMU-rate state propagation on the card.
//
// Stand for `preintegrate` and `propagate_states` of the JAX package
// (imu/preintegration.py): no Pallas kernel but two compiled device loops,
// lax.scans over a masked sample buffer in which a masked slot leaves the
// carry as it is.  The port's plain versions (imu/preintegration.py::
// preintegrate_reference, propagate_states_reference) read the mask on the
// host and drive the serial chain as ~60 small launches a sample.
//
//   fbpr_preintegrate      one CTA (kThreads threads).  In chunks of
//                          kThreads samples: first the state-free terms of
//                          every sample of the chunk, one thread a sample
//                          (`_sample_terms`: the bias-corrected a and w,
//                          Exp(w dt), Jr(w dt), the noise densities over
//                          max(dt, 1e-9)), then the serial chain over the
//                          chunk in buffer order, a masked sample skipped
//                          (the mask read on the device, all threads
//                          branching alike).  A step is `_integrate`'s
//                          arithmetic in its order, three CTA barriers: the
//                          3x3 products of the running state (a thread an
//                          entry), then A cov (a thread an entry of the
//                          9x9), then (A cov) A^T + (B noise) B^T +
//                          int_noise and the bias Jacobians, dv, dp, dt.
//                          dR and dR_dbg are double-buffered.  Writes the
//                          twelve PreintState leaves.
//   fbpr_propagate_states  one CTA: Exp(w dt) of every sample of a chunk in
//                          parallel, then the serial chain of the plain
//                          version's loop body (R Exp(w dt), acc_w = R a +
//                          g, p, v), two barriers a live sample; a masked
//                          sample repeats the state before it.  Writes R
//                          [N, 3, 3], p [N, 3], v [N, 3].
//
// Build without FMA contraction (kernels.SOURCE_FLAGS): the plain
// versions' operations round one by one.
//
// Bound.  Operations (chip_smoke.py's PREINT_OPS_SAMPLE and
// PROPAGATE_OPS_SAMPLE, derived there): 2.03 kFLOP a live sample for the
// preintegration (A cov and (A cov) A^T on A's 36 structural nonzeros,
// (B noise) B^T on B's 27, the 3x3 products, the state-free terms), 0.19
// kFLOP for the propagation; bytes: 29 a sample read, 592
// (preintegration) or 60 a sample (propagation) written.  At N = 20 either
// is far below a microsecond; one CTA is latency-bound on the chain's 3
// (2) dependent CTA barriers a sample.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#include "pose_graph.cuh"
#include "imu_chain.cuh"

constexpr int kThreads = 128;

// [v]x of a 3-vector, row-major (imu/preintegration.py::_hat)
__device__ __forceinline__ void hat(const float v[3], float H[9]) {
  H[0] = 0.0f;
  H[1] = -v[2];
  H[2] = v[1];
  H[3] = v[2];
  H[4] = 0.0f;
  H[5] = -v[0];
  H[6] = -v[1];
  H[7] = v[0];
  H[8] = 0.0f;
}

// imu/preintegration.py::_right_jacobian
__device__ void right_jacobian(const float w[3], float J[9]) {
  const float theta2 = w[0] * w[0] + w[1] * w[1] + w[2] * w[2];
  const float theta = sqrtf(theta2);
  float W[9], W2[9];
  hat(w, W);
  mat_mul(W, W, W2);
  const bool small = theta < 1e-5f;
  const float t2s = small ? 1.0f : theta2;
  const float a = small ? 0.5f : (1.0f - cosf(theta)) / t2s;
  const float b = small ? static_cast<float>(1.0 / 6.0)
                        : (theta - sinf(theta)) / (small ? 1.0f
                                                         : theta2 * theta);
#pragma unroll
  for (int e = 0; e < 9; ++e)
    J[e] = ((e % 4 == 0 ? 1.0f : 0.0f) - a * W[e]) + b * W2[e];
}

struct PreArgs {
  const float *acc, *gyr, *dt;  // [N, 3], [N, 3], [N]
  const uint8_t* mask;          // [N], or null: every sample live
  const float *bias_acc, *bias_gyr;
  float acc_var, gyr_var, int_var;
  int N;
  float *dR, *dv, *dp, *dt_sum, *dR_dbg, *dv_dba, *dv_dbg, *dp_dba, *dp_dbg,
      *cov, *ba_out, *bg_out;
};

// the 9x9 covariance transition A and noise input B of `_integrate`, entry
// by entry (the zero blocks included: they enter the products)
__device__ __forceinline__ float trans_A(int i, int m, const float* dRk,
                                         const float* dR_Ahat, float dt) {
  const int bi = i / 3, bm = m / 3, ii = i % 3, mm = m % 3;
  const float eye = ii == mm ? 1.0f : 0.0f;
  if (bi == 0) return bm == 0 ? dRk[mm * 3 + ii] : 0.0f;
  if (bi == 1)
    return bm == 0 ? (-dR_Ahat[ii * 3 + mm]) * dt : bm == 1 ? eye : 0.0f;
  return bm == 0 ? ((-0.5f * dR_Ahat[ii * 3 + mm]) * dt) * dt
                 : bm == 1 ? eye * dt : eye;
}
__device__ __forceinline__ float noise_B(int i, int m, const float* Jr,
                                         const float* dR, float dt) {
  const int bi = i / 3, bm = m / 3, ii = i % 3, mm = m % 3;
  if (bi == 0) return bm == 0 ? Jr[ii * 3 + mm] * dt : 0.0f;
  if (bm == 0) return 0.0f;
  const float dRdt = dR[ii * 3 + mm] * dt;
  return bi == 1 ? dRdt : (0.5f * dRdt) * dt;
}

__global__ void __launch_bounds__(kThreads) preintegrate_kernel(PreArgs a) {
  // a chunk's state-free terms
  __shared__ float s_a[kThreads][3], s_dRk[kThreads][9], s_Jr[kThreads][9],
      s_noise[kThreads][6], s_dt[kThreads];
  __shared__ uint8_t s_live[kThreads];
  // the running state (dR and dR_dbg double-buffered) and a step's temps
  __shared__ float dR[2][9], dR_dbg[2][9], dv[3], dp[3], dv_dba[9],
      dv_dbg[9], dp_dba[9], dp_dbg[9], cov[81];
  __shared__ float dR_Ahat[9], dR_Ahat_dRdbg[9], dR_a[3], T1[81];
  __shared__ float ba[3], bg[3], dt_sum;
  const int tid = threadIdx.x;
  if (tid < 9) {
    dR[0][tid] = tid % 4 == 0 ? 1.0f : 0.0f;
    dR_dbg[0][tid] = dv_dba[tid] = dv_dbg[tid] = dp_dba[tid] = dp_dbg[tid] =
        0.0f;
  }
  if (tid < 3) {
    dv[tid] = dp[tid] = 0.0f;
    ba[tid] = a.bias_acc[tid];
    bg[tid] = a.bias_gyr[tid];
  }
  if (tid < 81) cov[tid] = 0.0f;
  if (tid == 0) dt_sum = 0.0f;
  __syncthreads();
  int cur = 0;
  for (int base = 0; base < a.N; base += kThreads) {
    const int n = base + tid;
    if (n < a.N) {
      const float d = a.dt[n];
      float w[3], wdt[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        s_a[tid][i] = a.acc[3 * n + i] - ba[i];
        w[i] = a.gyr[3 * n + i] - bg[i];
        wdt[i] = w[i] * d;
      }
      so3_exp<float>(wdt, s_dRk[tid]);
      right_jacobian(wdt, s_Jr[tid]);
      const float dt_safe = clamp_min_(d, 1e-9f);
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        s_noise[tid][i] = a.gyr_var / dt_safe;
        s_noise[tid][3 + i] = a.acc_var / dt_safe;
      }
      s_dt[tid] = d;
      s_live[tid] = a.mask ? (a.mask[n] != 0) : 1;
    }
    __syncthreads();
    const int m = min(kThreads, a.N - base);
    for (int s = 0; s < m; ++s) {
      if (!s_live[s]) continue;
      const float d = s_dt[s];
      const float* av = s_a[s];
      const float* dRk = s_dRk[s];
      const float* R = dR[cur];
      const float* Rdbg = dR_dbg[cur];
      // stage 1: dR Ahat, dR Exp(w dt), dRk^T dR_dbg - Jr dt, dR a
      if (tid < 9) {
        const int i = tid / 3, j = tid % 3;
        float Ah[9];
        hat(av, Ah);
        dR_Ahat[tid] = R[i * 3 + 0] * Ah[0 * 3 + j] + R[i * 3 + 1] * Ah[3 + j]
                       + R[i * 3 + 2] * Ah[6 + j];
        dR[cur ^ 1][tid] = R[i * 3 + 0] * dRk[0 * 3 + j]
                           + R[i * 3 + 1] * dRk[3 + j]
                           + R[i * 3 + 2] * dRk[6 + j];
        dR_dbg[cur ^ 1][tid] = (dRk[0 * 3 + i] * Rdbg[0 * 3 + j]
                                + dRk[1 * 3 + i] * Rdbg[3 + j]
                                + dRk[2 * 3 + i] * Rdbg[6 + j])
                               - s_Jr[s][tid] * d;
      } else if (tid < 12) {
        const int i = tid - 9;
        dR_a[i] = R[i * 3 + 0] * av[0] + R[i * 3 + 1] * av[1]
                  + R[i * 3 + 2] * av[2];
      }
      __syncthreads();
      // stage 2: dR Ahat dR_dbg, A cov
      if (tid < 9) {
        const int i = tid / 3, j = tid % 3;
        dR_Ahat_dRdbg[tid] = dR_Ahat[i * 3 + 0] * Rdbg[0 * 3 + j]
                             + dR_Ahat[i * 3 + 1] * Rdbg[3 + j]
                             + dR_Ahat[i * 3 + 2] * Rdbg[6 + j];
      }
      if (tid < 81) {
        const int i = tid / 9, j = tid % 9;
        float t = 0.0f;
        for (int q = 0; q < 9; ++q)
          t += trans_A(i, q, dRk, dR_Ahat, d) * cov[q * 9 + j];
        T1[tid] = t;
      }
      __syncthreads();
      // stage 3: cov, the bias Jacobians, dv, dp, dt
      if (tid < 81) {
        const int i = tid / 9, j = tid % 9;
        float x = 0.0f, y = 0.0f;
        for (int q = 0; q < 9; ++q)
          x += T1[i * 9 + q] * trans_A(j, q, dRk, dR_Ahat, d);
        for (int q = 0; q < 6; ++q)
          y += (noise_B(i, q, s_Jr[s], R, d) * s_noise[s][q])
               * noise_B(j, q, s_Jr[s], R, d);
        const float e = (i >= 6 && i == j) ? 1.0f : 0.0f;
        cov[tid] = (x + y) + (e * a.int_var) * d;
      }
      if (tid < 9) {
        const float Rd = R[tid], X = dR_Ahat_dRdbg[tid];
        const float va = dv_dba[tid], vg = dv_dbg[tid];
        dp_dba[tid] = (dp_dba[tid] + va * d) - ((0.5f * Rd) * d) * d;
        dp_dbg[tid] = (dp_dbg[tid] + vg * d) - ((0.5f * X) * d) * d;
        dv_dba[tid] = va - Rd * d;
        dv_dbg[tid] = vg - X * d;
      }
      if (tid < 3) {
        const float v = dv[tid];
        dv[tid] = v + dR_a[tid] * d;
        dp[tid] = (dp[tid] + v * d) + ((0.5f * dR_a[tid]) * d) * d;
      }
      if (tid == 0) dt_sum = dt_sum + d;
      cur ^= 1;
      __syncthreads();
    }
    __syncthreads();  // the chunk's terms are read: the next may overwrite
  }
  if (tid < 9) {
    a.dR[tid] = dR[cur][tid];
    a.dR_dbg[tid] = dR_dbg[cur][tid];
    a.dv_dba[tid] = dv_dba[tid];
    a.dv_dbg[tid] = dv_dbg[tid];
    a.dp_dba[tid] = dp_dba[tid];
    a.dp_dbg[tid] = dp_dbg[tid];
  }
  if (tid < 3) {
    a.dv[tid] = dv[tid];
    a.dp[tid] = dp[tid];
    a.ba_out[tid] = ba[tid];
    a.bg_out[tid] = bg[tid];
  }
  if (tid < 81) a.cov[tid] = cov[tid];
  if (tid == 0) *a.dt_sum = dt_sum;
}

struct PropArgs {
  const float *R0, *p0, *v0;        // the NavState before the first sample
  const float *bias_acc, *bias_gyr;  // [3]
  const float *acc, *gyr, *dt;       // [N, 3], [N, 3], [N]
  const uint8_t* mask;               // [N], or null: every sample live
  float neg_gravity;                 // g = (0, 0, -gravity)
  int N;
  float *R, *p, *v;  // [N, 3, 3], [N, 3], [N, 3]
};

__global__ void __launch_bounds__(kThreads) propagate_kernel(PropArgs a) {
  __shared__ float s_dR[kThreads][9], s_a[kThreads][3], s_dt[kThreads];
  __shared__ uint8_t s_live[kThreads];
  __shared__ float R[2][9], p[3], v[3], acc_w[3], ba[3], bg[3];
  const int tid = threadIdx.x;
  if (tid < 9) R[0][tid] = a.R0[tid];
  if (tid < 3) {
    p[tid] = a.p0[tid];
    v[tid] = a.v0[tid];
    ba[tid] = a.bias_acc[tid];
    bg[tid] = a.bias_gyr[tid];
  }
  __syncthreads();
  const float g[3] = {0.0f, 0.0f, a.neg_gravity};
  int cur = 0;
  for (int base = 0; base < a.N; base += kThreads) {
    const int n = base + tid;
    if (n < a.N) {
      const float d = a.dt[n];
      float wdt[3];
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        s_a[tid][i] = a.acc[3 * n + i] - ba[i];
        wdt[i] = (a.gyr[3 * n + i] - bg[i]) * d;
      }
      so3_exp<float>(wdt, s_dR[tid]);
      s_dt[tid] = d;
      s_live[tid] = a.mask ? (a.mask[n] != 0) : 1;
    }
    __syncthreads();
    const int m = min(kThreads, a.N - base);
    for (int s = 0; s < m; ++s) {
      const int n2 = base + s;
      if (s_live[s]) {
        const float d = s_dt[s];
        const float* Rc = R[cur];
        if (tid < 9) {
          const int i = tid / 3, j = tid % 3;
          R[cur ^ 1][tid] = Rc[i * 3 + 0] * s_dR[s][0 * 3 + j]
                            + Rc[i * 3 + 1] * s_dR[s][3 + j]
                            + Rc[i * 3 + 2] * s_dR[s][6 + j];
        } else if (tid < 12) {
          const int i = tid - 9;
          acc_w[i] = (Rc[i * 3 + 0] * s_a[s][0] + Rc[i * 3 + 1] * s_a[s][1]
                      + Rc[i * 3 + 2] * s_a[s][2]) + g[i];
        }
        __syncthreads();
        cur ^= 1;
        if (tid < 3) {
          const float vi = v[tid];
          p[tid] = (p[tid] + vi * d) + ((0.5f * acc_w[tid]) * d) * d;
          v[tid] = vi + acc_w[tid] * d;
          a.p[3 * n2 + tid] = p[tid];
          a.v[3 * n2 + tid] = v[tid];
        }
      } else if (tid < 3) {
        a.p[3 * n2 + tid] = p[tid];
        a.v[3 * n2 + tid] = v[tid];
      }
      if (tid < 9) a.R[9 * n2 + tid] = R[cur][tid];
      __syncthreads();
    }
  }
}

}  // namespace

extern "C" int fbpr_preintegrate(const float* acc, const float* gyr,
                                 const float* dt, const uint8_t* mask,
                                 const float* bias_acc,
                                 const float* bias_gyr, float acc_var,
                                 float gyr_var, float int_var, int N,
                                 float* dR, float* dv, float* dp,
                                 float* dt_sum, float* dR_dbg, float* dv_dba,
                                 float* dv_dbg, float* dp_dba, float* dp_dbg,
                                 float* cov, float* ba_out, float* bg_out,
                                 void* stream) {
  if (N < 0) return static_cast<int>(cudaErrorInvalidValue);
  PreArgs a{acc, gyr, dt, mask, bias_acc, bias_gyr, acc_var, gyr_var,
            int_var, N, dR, dv, dp, dt_sum, dR_dbg, dv_dba, dv_dbg, dp_dba,
            dp_dbg, cov, ba_out, bg_out};
  preintegrate_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fbpr_propagate_states(const float* R0, const float* p0,
                                     const float* v0, const float* bias_acc,
                                     const float* bias_gyr, const float* acc,
                                     const float* gyr, const float* dt,
                                     const uint8_t* mask, float neg_gravity,
                                     int N, float* R, float* p, float* v,
                                     void* stream) {
  if (N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  PropArgs a{R0, p0, v0, bias_acc, bias_gyr, acc, gyr, dt, mask,
             neg_gravity, N, R, p, v};
  propagate_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
