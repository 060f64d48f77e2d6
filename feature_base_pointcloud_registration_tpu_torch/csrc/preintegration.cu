// The IMU preintegration and the IMU-rate state propagation on the card.
//
// Stand for `preintegrate` and `propagate_states` of the JAX package
// (imu/preintegration.py): no Pallas kernel but two compiled device loops,
// lax.scans over a masked sample buffer in which a masked slot leaves the
// carry as it is.  The port's plain versions (imu/preintegration.py::
// preintegrate_reference, propagate_states_reference) read the mask on the
// host and drive the serial chain as ~60 small launches a sample.  Both
// kernels give the bits of the one-CTA design they replaced (three CTA
// barriers a live sample, every 9x9 product over all nine terms), which
// tests/preint_chain.py transcribes beside this design.
//
//   fbpr_preintegrate      one CTA of kWarps warps, a software pipeline
//                          over chunks of kChunk slots with one CTA barrier
//                          a chunk.  Each step of `_integrate` is split by
//                          what it depends on, and each part runs on its own
//                          warp, four chunks in flight:
//     stage 0  (kSfWarp)   a lane a slot: the mask, a ballot and a prefix
//                          count compact the chunk's live slots; a live
//                          lane computes its state-free terms
//                          (`_sample_terms`: a, Exp(w dt), Jr(w dt), the
//                          noise densities) into the chunk's SF row.
//     stage 1  (kRWarp,    the two short chains, a lane an entry, the row
//               kDbgWarp)  of the other factor by shuffles, no barrier:
//                          dR <- dR Exp(w dt) and dR_dbg <- Exp^T dR_dbg -
//                          Jr dt, each recording the state a step reads.
//     stage 2  (kAWarp,    a lane a live sample: from dR_k and dR_dbg_k,
//               kYWarp)    dR [a]x, dR a, X = dR [a]x dR_dbg, the three
//                          3x3 blocks of A's first block column, the 45
//                          structural nonzeros of (B noise) B^T and a flag:
//                          every term that a skipped zero multiplies is
//                          finite.
//     stage 3  (kCovWarp,  the cov chain, the only long one, on one warp:
//               kSumWarp)  a lane (row i, k) of 27 for cov's columns k,
//                          3 + k and 6 + k, one of each column block; cov in
//                          shared memory as (cov[q][k], cov[q][3 + k],
//                          cov[q][6 + k]) float4s, double-buffered, one
//                          __syncwarp a step.  T1 = A cov on A's structure:
//                          5 terms an entry in the parent's q order in
//                          place of 9 (a row of A has 3, 4 or 5 nonzeros;
//                          the rows with fewer take a zero coefficient or
//                          two, so the warp stays converged); T1[i][0..2]
//                          from the row's three lanes (3 shuffles); T1 A^T
//                          at the lane's three columns on their 3, 4 and 5
//                          nonzeros.  Dropping a zero keeps the bits while
//                          what it multiplies is finite: x + (+-0) = x for
//                          a sum started at +0, which is never -0; both
//                          sums start at their first term instead of +0,
//                          which can leave -0 for +0 in T1 or x only, and
//                          those meet nothing but sums that are never -0.
//                          A step whose flag is off or whose T1 is not
//                          finite is done again in the parent's dense order
//                          (a warp vote), so NaN and inf land as before.
//                          The bias Jacobians, dv, dp and dt on 22 lanes of
//                          the sums warp, in the parent's parenthesization.
//                          Rings in shared memory (SF 4 chunks deep, dR 3,
//                          dR_dbg 2, the terms 2); 45 KB, static.
//   fbpr_propagate_states  one CTA: four warps compute Exp(w dt), a and the
//                          mask of a chunk of kPropChunk slots (a thread a
//                          slot) and write out the chunk walked before it,
//                          while warp 0 walks the chunk between: every lane
//                          the same 3-term product of its row of R (by
//                          shuffles) with Exp's column (lanes 0-8, the new
//                          R) or with a (lanes 9-11: acc_w = R a + g from
//                          the same R_k, then p and v), no branch and no
//                          barrier a slot; a masked slot keeps the state
//                          before it.  The states go to shared memory and
//                          out in coalesced runs: R [N, 3, 3], p [N, 3],
//                          v [N, 3].
//
// Build without FMA contraction (kernels.SOURCE_FLAGS): the plain
// versions' operations round one by one.
//
// Bound.  Operations (chip_smoke.py's PREINT_OPS_SAMPLE and
// PROPAGATE_OPS_SAMPLE, derived there): 2.03 kFLOP a live sample for the
// preintegration, 0.19 kFLOP for the propagation; bytes: 29 a sample read,
// 592 (preintegration) or 60 a sample (propagation) written.  Far below a
// microsecond at every buffer (0.000022 ms at 731 live samples), so the
// latency of the dependent chain is the floor.  A cov step's chain, with
// one warp's latencies on an H100 (scripts/warp_latency.py: a dependent
// fadd ~7 cycles, a shuffle ~26, a shared store, __syncwarp and five
// 16-byte shared loads ~63): the loads of cov (63), T1's multiply and 4
// adds (35), the row's shuffles (27), x's multiply and up to 4 adds (35),
// + y and + int_noise (14): ~175 cycles, ~0.09 us a live sample at 1.98
// GHz, ~0.064 ms at 731 live samples.  The propagation's R chain: a
// shuffle, a multiply and 2 adds, ~47 cycles a slot.
//
// Built with -DFBPR_PREINT_PROFILE (chip_smoke.py's diagnostic build), lane
// 0 of every warp of the preintegration sums the clock64 cycles of its own
// stage's work, and fbpr_preintegrate_profile reads them.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#ifdef FBPR_PREINT_PROFILE
#define FBPR_PROF
#endif
#include "clock_prof.cuh"
#include "pose_graph.cuh"
#include "imu_chain.cuh"

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
// by entry (the zero blocks included: the dense steps add them)
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

constexpr int kChunk = 32;     // slots a pipeline chunk: one ballot
constexpr int kWarps = 7;
constexpr int kThreads = kWarps * 32;
enum { kCovWarp, kRWarp, kDbgWarp, kSfWarp, kSumWarp, kAWarp, kYWarp };
// a live sample's state-free row: Exp(w dt) 9, Jr 9, a 3, the gyro and
// accel noise densities, dt; 25 floats (odd: a lane a row, no conflicts)
enum { kSfExp = 0, kSfJr = 9, kSfA = 18, kSfNg = 21, kSfNa = 22, kSfDt = 23,
       kSf = 25 };
// a live sample's terms row (16-byte aligned): A's first block column by
// block, each row padded to 4 (Exp^T, -dR[a]x dt, -0.5 dR[a]x dt dt); the
// cov lanes' (B noise) B^T pairs (lane (i, k): (y[i][k], 0) in the theta
// rows, (y[i][3 + k], y[i][6 + k]) in the others); dt and the flag; X; dR a
enum { kTa = 0, kTy = 36, kTd = 90, kTx = 92, kTdra = 101, kTerm = 104 };
constexpr int kSfSlots = 4, kDrSlots = 3, kDbgSlots = 2, kTermSlots = 2;

struct PreSmem {
  // [buffer][row q][k]: (cov[q][k], cov[q][3 + k], cov[q][6 + k], pad)
  float4 cov[2][9][3];
  float terms[kTermSlots][kChunk][kTerm];
  float sf[kSfSlots][kChunk][kSf];
  float dr[kDrSlots][kChunk][9];
  float dbg[kDbgSlots][kChunk][9];
  int cnt[kSfSlots];  // live samples of a chunk
  PROF(float4 probe[32];)  // the diagnostic build's stamps' stores
};

// The diagnostic build's sums (-DFBPR_PREINT_PROFILE): [0] calls, [1] live
// samples, [2] pipeline steps, [3 + role] the cycles lane 0 of that warp
// spent in its stage's work, [10] the CTA's cycles, [11] its ns, [12] cov
// steps done in the dense order; the propagation's [13] calls, [14] slots,
// [15] the walking warp's cycles; the cov warp's steps split at two stamps
// (each after a shared store of the values it waits for and a __syncwarp,
// which the stamps add): [16] from the step's start to T1 (the loads and A
// cov), [17] to cov' (the shuffles of T1's row, T1 A^T, + y, + int_noise),
// [18] to the next step (the vote, the store, the __syncwarp).
PROF(__device__ unsigned long long g_preint_prof[19];

// lane 0 stamps the clock once the warp has v (a shared store waits for it)
__device__ __forceinline__ void stamp_after(float4* probe, int lane, float4 v,
                                           long long& at) {
  probe[lane] = v;
  __syncwarp();
  at = clock64();
})

__device__ __forceinline__ float comp(const float4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : v.z;
}

// dR [a]x (imu/preintegration.py::_integrate's dR_Ahat)
__device__ __forceinline__ void dr_ahat(const float* R, const float* av,
                                        float dRA[9]) {
  float Ah[9];
  hat(av, Ah);
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      dRA[i * 3 + j] = (R[i * 3 + 0] * Ah[0 * 3 + j] + R[i * 3 + 1] * Ah[3 + j])
                       + R[i * 3 + 2] * Ah[6 + j];
}

__global__ void __launch_bounds__(kThreads) preintegrate_kernel(PreArgs a) {
  __shared__ PreSmem s;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned full = 0xffffffffu;
  const int nchunks = (a.N + kChunk - 1) / kChunk;
  const float ba[3] = {a.bias_acc[0], a.bias_acc[1], a.bias_acc[2]};
  const float bg[3] = {a.bias_gyr[0], a.bias_gyr[1], a.bias_gyr[2]};
  PROF(const long long c_start = clock64();
       const unsigned long long n_start = global_ns();
       unsigned long long busy = 0, live_n = 0, dense_n = 0;
       unsigned long long step_cyc[3] = {0, 0, 0};)

  // the chains' lanes: an entry (i, j) of a 3x3 state (lanes 9-31 shadow
  // entry 0 and store nothing)
  const int e = lane < 9 ? lane : 0, ei = e / 3, ej = e % 3;
  float chain = warp == kRWarp && e % 4 == 0 ? 1.0f : 0.0f;
  // the cov warp's lanes: (row i, k) of 27, for the columns k, 3 + k and
  // 6 + k (one of each column block)
  const bool cact = lane < 27;
  const int cl = cact ? lane : 0, ci = cl / 3, ck = cl % 3;
  const int cbi = ci / 3, cii = ci % 3;
  int cb = 0;
  if (warp == kCovWarp && cact) s.cov[0][ci][ck] = make_float4(0, 0, 0, 0);
  // the sums warp's lanes: dv_dba / dp_dba (0-8), dv_dbg / dp_dbg (9-17),
  // dv / dp (18-20), dt (21)
  float sv = 0.0f, sp = 0.0f;

  for (int it = 0; it < nchunks + 3; ++it) {
    PROF(const long long t0 = clock64();)
    if (warp == kSfWarp && it < nchunks) {
      const int c = it, n = c * kChunk + lane;
      const bool live = n < a.N && (a.mask == nullptr || a.mask[n] != 0);
      const unsigned b = __ballot_sync(full, live);
      if (live) {
        float* row = s.sf[c % kSfSlots][__popc(b & ((1u << lane) - 1u))];
        const float d = a.dt[n];
        float wdt[3];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          row[kSfA + i] = a.acc[3 * n + i] - ba[i];
          wdt[i] = (a.gyr[3 * n + i] - bg[i]) * d;
        }
        so3_exp<float>(wdt, row + kSfExp);
        right_jacobian(wdt, row + kSfJr);
        const float dt_safe = clamp_min_(d, 1e-9f);
        row[kSfNg] = a.gyr_var / dt_safe;
        row[kSfNa] = a.acc_var / dt_safe;
        row[kSfDt] = d;
      }
      if (lane == 0) s.cnt[c % kSfSlots] = __popc(b);
    } else if ((warp == kRWarp || warp == kDbgWarp) && it >= 1
               && it <= nchunks) {
      const int c = it - 1, cnt = s.cnt[c % kSfSlots];
      const float(*sf)[kSf] = s.sf[c % kSfSlots];
      if (warp == kRWarp) {
        // dR <- dR Exp(w dt): row ei of dR from lanes 3 ei .. 3 ei + 2
        float(*dr)[9] = s.dr[c % kDrSlots];
        for (int r = 0; r < cnt; ++r) {
          const float* k = sf[r] + kSfExp;
          if (lane < 9) dr[r][lane] = chain;
          const float r0 = __shfl_sync(full, chain, 3 * ei);
          const float r1 = __shfl_sync(full, chain, 3 * ei + 1);
          const float r2 = __shfl_sync(full, chain, 3 * ei + 2);
          chain = (r0 * k[ej] + r1 * k[3 + ej]) + r2 * k[6 + ej];
        }
      } else {
        // dR_dbg <- Exp^T dR_dbg - Jr dt: column ej from lanes ej, 3 + ej,
        // 6 + ej
        float(*dg)[9] = s.dbg[c % kDbgSlots];
        for (int r = 0; r < cnt; ++r) {
          const float* k = sf[r] + kSfExp;
          if (lane < 9) dg[r][lane] = chain;
          const float g0 = __shfl_sync(full, chain, ej);
          const float g1 = __shfl_sync(full, chain, 3 + ej);
          const float g2 = __shfl_sync(full, chain, 6 + ej);
          chain = ((k[ei] * g0 + k[3 + ei] * g1) + k[6 + ei] * g2)
                  - sf[r][kSfJr + e] * sf[r][kSfDt];
        }
      }
    } else if ((warp == kAWarp || warp == kYWarp) && it >= 2
               && it <= nchunks + 1) {
      const int c = it - 2, r = lane;
      if (r < s.cnt[c % kSfSlots]) {
        const float* f = s.sf[c % kSfSlots][r];
        const float* R = s.dr[c % kDrSlots][r];
        float* t = s.terms[c % kTermSlots][r];
        const float d = f[kSfDt];
        if (warp == kAWarp) {
          const float* G = s.dbg[c % kDbgSlots][r];
          const float* av = f + kSfA;
          float dRA[9];
          dr_ahat(R, av, dRA);
#pragma unroll
          for (int i = 0; i < 3; ++i)
            t[kTdra + i] = (R[i * 3 + 0] * av[0] + R[i * 3 + 1] * av[1])
                           + R[i * 3 + 2] * av[2];
#pragma unroll
          for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 3; ++j) {
              t[kTx + i * 3 + j] = (dRA[i * 3 + 0] * G[0 * 3 + j]
                                    + dRA[i * 3 + 1] * G[3 + j])
                                   + dRA[i * 3 + 2] * G[6 + j];
              // A's first block column (trans_A), a block's rows by 4
              t[kTa + i * 4 + j] = f[kSfExp + j * 3 + i];
              t[kTa + 12 + i * 4 + j] = (-dRA[i * 3 + j]) * d;
              t[kTa + 24 + i * 4 + j] = ((-0.5f * dRA[i * 3 + j]) * d) * d;
            }
        } else {
          // B's nonzeros (noise_B): theta rows Jr dt, v rows dR dt, p rows
          // (0.5 dR dt) dt; each times its noise density, as the parent
          const float ng = f[kSfNg], na = f[kSfNa];
          float Bt[9], Btn[9], Bvp[18], Bvpn[18];
          bool ok = isfinite(d) && isfinite(ng) && isfinite(na)
                    && isfinite(a.int_var);
#pragma unroll
          for (int q = 0; q < 9; ++q) {
            Bt[q] = f[kSfJr + q] * d;
            Btn[q] = Bt[q] * ng;
            const float dRdt = R[q] * d;
            Bvp[q] = dRdt;
            Bvp[9 + q] = (0.5f * dRdt) * d;
            ok = ok && isfinite(Bt[q]) && isfinite(Btn[q]) && isfinite(Bvp[q])
                 && isfinite(Bvp[9 + q]);
          }
#pragma unroll
          for (int q = 0; q < 18; ++q) {
            Bvpn[q] = Bvp[q] * na;
            ok = ok && isfinite(Bvpn[q]);
          }
          // the theta block's 9, then the (v, p) block's 36, each into
          // its cov lane's pair
#pragma unroll
          for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              float y = 0.0f;
#pragma unroll
              for (int q = 0; q < 3; ++q) y += Btn[i * 3 + q] * Bt[k * 3 + q];
              t[kTy + 2 * (i * 3 + k)] = y;
              t[kTy + 2 * (i * 3 + k) + 1] = 0.0f;
            }
#pragma unroll
          for (int i = 0; i < 6; ++i)
#pragma unroll
            for (int j = 0; j < 6; ++j) {
              float y = 0.0f;
#pragma unroll
              for (int q = 0; q < 3; ++q)
                y += Bvpn[i * 3 + q] * Bvp[j * 3 + q];
              t[kTy + 2 * ((3 + i) * 3 + j % 3) + j / 3] = y;
            }
          t[kTd] = d;
          t[kTd + 1] = ok ? 1.0f : 0.0f;
        }
      }
    } else if (warp == kCovWarp && it >= 3) {
      const int c = it - 3, cnt = s.cnt[c % kSfSlots];
      // the 4th and 5th terms of this lane's row of A cov: eye (rows 3-5),
      // eye dt and eye (rows 6-8), zero coefficients above (rows 0-2)
      const float k6 = cbi == 2 ? 1.0f : 0.0f;
      const float ie = ((cbi == 2 && cii == ck) ? 1.0f : 0.0f) * a.int_var;
      for (int r = 0; r < cnt; ++r) {
        PROF(const long long q0 = clock64();)
        const float* t = s.terms[c % kTermSlots][r];
        const float4* cv = &s.cov[cb][0][0];
        const float4 v0 = cv[0 * 3 + ck], v1 = cv[1 * 3 + ck],
                     v2 = cv[2 * 3 + ck], v3 = cv[(3 + cii) * 3 + ck],
                     v6 = cv[(6 + cii) * 3 + ck];
        // this lane's row of A's first block column, A's rows k, 3 + k and
        // 6 + k there, (dt, flag) and its (B noise) B^T pair
        const float4 ar = *reinterpret_cast<const float4*>(
            t + kTa + cbi * 12 + cii * 4);
        const float4 b0 = *reinterpret_cast<const float4*>(t + kTa + ck * 4);
        const float4 b1 =
            *reinterpret_cast<const float4*>(t + kTa + 12 + ck * 4);
        const float4 b2 =
            *reinterpret_cast<const float4*>(t + kTa + 24 + ck * 4);
        const float2 df = *reinterpret_cast<const float2*>(t + kTd);
        const float2 yp = *reinterpret_cast<const float2*>(t + kTy + 2 * cl);
        const float d = df.x;
        const float k3 = cbi == 0 ? 0.0f : cbi == 1 ? 1.0f : d;
        // T1 = A cov at the columns k, 3 + k, 6 + k of row i (the parent's
        // sums start at +0; starting at the first term instead may leave -0
        // for +0 in T1 and x, which changes no bit of cov': x only meets
        // sums that are never -0, or y, which is never -0)
        float T[3], out[3];
#pragma unroll
        for (int e = 0; e < 3; ++e) {
          float x = ar.x * comp(v0, e);
          x += ar.y * comp(v1, e);
          x += ar.z * comp(v2, e);
          x += k3 * comp(v3, e);
          x += k6 * comp(v6, e);
          T[e] = x;
        }
        const bool bad = cact & ((df.y == 0.0f) | !isfinite(T[0])
                                 | !isfinite(T[1]) | !isfinite(T[2]));
        PROF(long long q1, q2;
             stamp_after(s.probe, lane, make_float4(T[0], T[1], T[2], 0.0f),
                         q1);)
        // T1[i][0..2] from the row's three lanes
        const float t0 = __shfl_sync(full, T[0], 3 * ci);
        const float t1 = __shfl_sync(full, T[0], 3 * ci + 1);
        const float t2 = __shfl_sync(full, T[0], 3 * ci + 2);
        // T1 A^T at (i, k), (i, 3 + k), (i, 6 + k): A's rows k, 3 + k and
        // 6 + k have 3, 4 and 5 nonzeros
        float x0 = t0 * b0.x, x1 = t0 * b1.x, x2 = t0 * b2.x;
        x0 += t1 * b0.y;
        x1 += t1 * b1.y;
        x2 += t1 * b2.y;
        x0 += t2 * b0.z;
        x1 += t2 * b1.z;
        x2 += t2 * b2.z;
        x1 += T[1] * 1.0f;
        x2 += T[1] * d;
        x2 += T[2] * 1.0f;
        out[0] = x0 + (cbi == 0 ? yp.x : 0.0f);
        out[1] = x1 + (cbi == 0 ? 0.0f : yp.x);
        out[2] = (x2 + (cbi == 0 ? 0.0f : yp.y)) + ie * d;
        PROF(stamp_after(s.probe, lane,
                         make_float4(out[0], out[1], out[2], 0.0f), q2);)
        if (__any_sync(full, bad)) {
          // the parent's dense order: every q of A and B, zeros included
          PROF(++dense_n;)
          const float* f = s.sf[c % kSfSlots][r];
          const float* dRk = f + kSfExp;
          const float* Jr = f + kSfJr;
          const float* R = s.dr[c % kDrSlots][r];
          float dRA[9], Tq[9];
          dr_ahat(R, f + kSfA, dRA);
#pragma unroll
          for (int e = 0; e < 3; ++e) {
            float x = 0.0f;
#pragma unroll
            for (int q = 0; q < 9; ++q)
              x += trans_A(ci, q, dRk, dRA, d) * comp(cv[q * 3 + ck], e);
            T[e] = x;
          }
#pragma unroll
          for (int q = 0; q < 9; ++q)
            Tq[q] = __shfl_sync(full, T[q / 3], 3 * ci + q % 3);
#pragma unroll
          for (int e = 0; e < 3; ++e) {
            const int j = 3 * e + ck;
            float x = 0.0f, y = 0.0f;
#pragma unroll
            for (int q = 0; q < 9; ++q)
              x += Tq[q] * trans_A(j, q, dRk, dRA, d);
#pragma unroll
            for (int q = 0; q < 6; ++q)
              y += (noise_B(ci, q, Jr, R, d) * f[q < 3 ? kSfNg : kSfNa])
                   * noise_B(j, q, Jr, R, d);
            const float ee = (ci >= 6 && ci == j) ? 1.0f : 0.0f;
            out[e] = (x + y) + (ee * a.int_var) * d;
          }
        }
        if (cact) s.cov[cb ^ 1][ci][ck] = make_float4(out[0], out[1], out[2],
                                                      0.0f);
        cb ^= 1;
        __syncwarp();
        PROF(const long long q3 = clock64();
             step_cyc[0] += q1 - q0; step_cyc[1] += q2 - q1;
             step_cyc[2] += q3 - q2;)
      }
      PROF(live_n += cnt;)
    } else if (warp == kSumWarp && it >= 3) {
      const int c = it - 3, cnt = s.cnt[c % kSfSlots];
      const int toff = lane < 9 ? kTx : lane < 18 ? kTx + lane - 9
                                                  : kTdra + min(lane - 18, 2);
      for (int r = 0; r < cnt; ++r) {
        const float d = s.sf[c % kSfSlots][r][kSfDt];
        const float u = lane < 9 ? s.dr[c % kDrSlots][r][e]
                                 : s.terms[c % kTermSlots][r][toff];
        if (lane < 21) {
          // dp' = (dp + v dt) -+ ((0.5 u) dt) dt, v' = v -+ u dt
          const float t1 = u * d, t2 = ((0.5f * u) * d) * d;
          const float pv = sp + sv * d;
          sp = lane < 18 ? pv - t2 : pv + t2;
          sv = lane < 18 ? sv - t1 : sv + t1;
        } else if (lane == 21) {
          sv = sv + d;
        }
      }
    }
    PROF(busy += clock64() - t0;)
    __syncthreads();
  }

  // the outputs, each from the warp that carries it
  if (warp == kRWarp && lane < 9) a.dR[lane] = chain;
  if (warp == kDbgWarp && lane < 9) a.dR_dbg[lane] = chain;
  if (warp == kCovWarp && cact) {
    const float4 v = s.cov[cb][ci][ck];
    a.cov[ci * 9 + ck] = v.x;
    a.cov[ci * 9 + 3 + ck] = v.y;
    a.cov[ci * 9 + 6 + ck] = v.z;
  }
  if (warp == kSumWarp) {
    if (lane < 9) {
      a.dv_dba[lane] = sv;
      a.dp_dba[lane] = sp;
    } else if (lane < 18) {
      a.dv_dbg[lane - 9] = sv;
      a.dp_dbg[lane - 9] = sp;
    } else if (lane < 21) {
      a.dv[lane - 18] = sv;
      a.dp[lane - 18] = sp;
    } else if (lane == 21) {
      *a.dt_sum = sv;
    }
  }
  if (warp == kSfWarp && lane < 3) {
    a.ba_out[lane] = ba[lane];
    a.bg_out[lane] = bg[lane];
  }
  PROF(if (lane == 0) {
    atomicAdd(&g_preint_prof[3 + warp], busy);
    if (warp == kCovWarp) {
      atomicAdd(&g_preint_prof[0], 1ull);
      atomicAdd(&g_preint_prof[1], live_n);
      atomicAdd(&g_preint_prof[2], static_cast<unsigned long long>(nchunks + 3));
      atomicAdd(&g_preint_prof[10],
                static_cast<unsigned long long>(clock64() - c_start));
      atomicAdd(&g_preint_prof[11], global_ns() - n_start);
      atomicAdd(&g_preint_prof[12], dense_n);
      for (int i = 0; i < 3; ++i) atomicAdd(&g_preint_prof[16 + i], step_cyc[i]);
    }
  })
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

constexpr int kPropChunk = 128;   // slots a chunk: a producer thread each
constexpr int kPropThreads = 32 + kPropChunk;
// a slot's row: Exp(w dt) 9, a 3, dt, live; 15 floats (odd)
enum { kPe = 0, kPa = 9, kPdt = 12, kPlive = 13, kProw = 15 };

__global__ void __launch_bounds__(kPropThreads) propagate_kernel(PropArgs a) {
  // a chunk's rows, and a walked chunk's states (R 9, p 3, v 3) until the
  // producers copy them out
  __shared__ float rows[2][kPropChunk][kProw];
  __shared__ float outs[2][kPropChunk][kProw];
  const int lane = threadIdx.x & 31;
  const bool walker = threadIdx.x < 32;
  const unsigned full = 0xffffffffu;
  const int nchunks = (a.N + kPropChunk - 1) / kPropChunk;
  PROF(unsigned long long busy = 0;)
  // the walker's lanes: 0-8 R[i][j], 9-11 p[i] and v[i]; the row of R a
  // lane multiplies and what it multiplies by: Exp's column j (lanes 0-8)
  // or a (9-11; lanes 12-31 shadow lane 9)
  const int ri = lane < 9 ? lane / 3 : lane < 12 ? lane - 9 : 0;
  const int xo = lane < 9 ? kPe + lane % 3 : kPa, xs = lane < 9 ? 3 : 1;
  // the state: R[i][j] (lanes 0-8), p[i] and v[i] (lanes 9-11), R apart
  // so that the shuffles of the next slot do not wait for p
  float sr = 0.0f, sp = 0.0f, sv = 0.0f;
  if (lane < 9) sr = a.R0[lane];
  else if (lane < 12) {
    sp = a.p0[lane - 9];
    sv = a.v0[lane - 9];
  }
  const float g = ri == 2 ? a.neg_gravity : 0.0f;

  for (int it = 0; it < nchunks + 2; ++it) {
    if (!walker) {
      const int tid = threadIdx.x - 32;
      if (it < nchunks) {
        const int n = it * kPropChunk + tid;
        if (n < a.N) {
          float* row = rows[it & 1][tid];
          const float d = a.dt[n];
          float wdt[3];
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            row[kPa + i] = a.acc[3 * n + i] - a.bias_acc[i];
            wdt[i] = (a.gyr[3 * n + i] - a.bias_gyr[i]) * d;
          }
          so3_exp<float>(wdt, row + kPe);
          row[kPdt] = d;
          row[kPlive] = (a.mask == nullptr || a.mask[n] != 0) ? 1.0f : 0.0f;
        }
      }
      if (it >= 2) {
        // the chunk walked in the last step, out in coalesced runs
        const int base = (it - 2) * kPropChunk;
        const int m = min(kPropChunk, a.N - base);
        const float(*o)[kProw] = outs[it & 1];
        for (int x = tid; x < 9 * m; x += kPropChunk)
          a.R[9 * base + x] = o[x / 9][x % 9];
        for (int x = tid; x < 3 * m; x += kPropChunk) {
          a.p[3 * base + x] = o[x / 3][9 + x % 3];
          a.v[3 * base + x] = o[x / 3][12 + x % 3];
        }
      }
    } else if (it >= 1 && it <= nchunks) {
      PROF(const long long t0 = clock64();)
      const int base = (it - 1) * kPropChunk;
      const int m = min(kPropChunk, a.N - base);
      const float(*rw)[kProw] = rows[(it - 1) & 1];
      float(*o)[kProw] = outs[(it - 1) & 1];
#pragma unroll 4
      for (int s = 0; s < m; ++s) {
        const float* row = rw[s];
        const bool live = row[kPlive] != 0.0f;
        const float d = row[kPdt];
        const float x0 = row[xo], x1 = row[xo + xs], x2 = row[xo + 2 * xs];
        const float r0 = __shfl_sync(full, sr, 3 * ri);
        const float r1 = __shfl_sync(full, sr, 3 * ri + 1);
        const float r2 = __shfl_sync(full, sr, 3 * ri + 2);
        // R Exp(w dt) (lanes 0-8), R a + g, then p and v (lanes 9-11)
        const float prod = (r0 * x0 + r1 * x1) + r2 * x2;
        const float acc_w = prod + g;
        const float pn = (sp + sv * d) + ((0.5f * acc_w) * d) * d;
        const float vn = sv + acc_w * d;
        if (live) {
          sr = prod;
          sp = pn;
          sv = vn;
        }
        if (lane < 12) o[s][lane] = lane < 9 ? sr : sp;
        if (lane >= 9 && lane < 12) o[s][lane + 3] = sv;
      }
      PROF(busy += clock64() - t0;)
    }
    __syncthreads();
  }
  PROF(if (walker && lane == 0) {
    atomicAdd(&g_preint_prof[13], 1ull);
    atomicAdd(&g_preint_prof[14], static_cast<unsigned long long>(a.N));
    atomicAdd(&g_preint_prof[15], busy);
  })
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
  propagate_kernel<<<1, kPropThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

#ifdef FBPR_PREINT_PROFILE
// The diagnostic build's sums (g_preint_prof, 19 values) into out; reset
// != 0 zeroes them after.  Synchronous.
extern "C" int fbpr_preintegrate_profile(unsigned long long* out, int reset) {
  return prof_read(g_preint_prof, out, reset);
}
#endif
