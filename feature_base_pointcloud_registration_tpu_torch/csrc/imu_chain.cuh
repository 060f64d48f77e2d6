// The IMU chain's factors on forward-mode dual numbers: the residuals of
// graph/imu_graph.py (the port's plain version and the JAX package's
// `_imu_residual` with its whitening, `_bias_res`, `_pose_prior_res`,
// `_init_prior_res`), templated on a scalar that is a float (the residual
// alone) or a Dual (value, tangent), on csrc/pose_graph.cuh's Dual,
// euler_to_rot, so3_log, mat_tmul, mat_tvec, clamp_min_, sqrt_ and where_.
//
// As there, a Jacobian column is one evaluation with one unit tangent
// seeded on the differentiated state, each operation is the plain
// version's, in its order, with PyTorch's forward-mode rule for it.  The
// plain version makes every argument of a factor dual (zero tangents but
// the differentiated one), so the chain data enter as lift<T>(x); Python
// scalars and the constants made inside a function (eye, zeros_like, the
// 1.0 of a where) have no tangent and enter as floats.  Added here:
//   linalg.norm  value sqrt(sum w^2); tangent (w . t) / norm, 0 where the
//                norm is 0
//   so3_exp      geom/se3.py::so3_exp: below |w| < 1e-8 the where selects
//                eye, whose tangent is 0.  At the first LM iteration of a
//                correction dbg = bg - bias_gyr is exactly 0, so the
//                plain version's d r_R / d bg through Exp(dR_dbg dbg) is 0
//                there, and so is this one's.
//
// The whitening factor L = chol(cov + 1e-10 I) of an interval is NaN in
// every entry where a pivot is not > 0 (the plain version's
// where(info == 0, L, nan)); residuals and Jacobian columns are whitened
// by forward substitution with it.
//
// Include once per translation unit, after pose_graph.cuh, inside an
// anonymous namespace.

constexpr int kS = 15;  // state: roll, pitch, yaw, p, v, bias_acc, bias_gyr

// The chain data of graph/imu_graph.py::ImuChainData, contiguous float32
// (bool masks as bytes)
struct ChainData {
  const float* states;  // [K, 15]
  const uint8_t* state_mask;
  const float *dR, *dv, *dp, *dt;  // [K, 3, 3], [K, 3], [K, 3], [K]
  const float *dR_dbg, *dv_dba, *dv_dbg, *dp_dba, *dp_dbg;  // [K, 3, 3]
  const float* cov;                                        // [K, 9, 9]
  const float *bias_acc, *bias_gyr;                        // [K, 3]
  const uint8_t* preint_mask;
  const float *pose_meas, *pose_sigma;  // [K, 6]
  const uint8_t* pose_meas_mask;
  const float *prior_state, *prior_sigma;  // [15]
  const float* bias_sigma;                 // [6]
  const float* gravity;                    // []
  int K;
};

// The whitened blocks of graph/imu_graph.py::chain_factor_blocks, in its
// layout: r_imu [K, 9], Ji, Jj [K, 9, 15], r_b [K, 6], Jbi, Jbj [K, 6, 15],
// r_pp [K, 6], Jpp [K, 6, 15], r_0 [15], J_0 [15, 15]
struct Blocks {
  float *r_imu, *Ji, *Jj, *r_b, *Jbi, *Jbj, *r_pp, *Jpp, *r_0, *J_0;
};

template <typename T>
__device__ __forceinline__ void load_state(const float* s, int seed,
                                           T out[kS]);
template <>
__device__ __forceinline__ void load_state<float>(const float* s, int seed,
                                                  float out[kS]) {
#pragma unroll
  for (int c = 0; c < kS; ++c) out[c] = s[c];
}
template <>
__device__ __forceinline__ void load_state<Dual>(const float* s, int seed,
                                                 Dual out[kS]) {
#pragma unroll
  for (int c = 0; c < kS; ++c) out[c] = {s[c], c == seed ? 1.0f : 0.0f};
}

template <typename T>
__device__ __forceinline__ void lift9(const float* p, T out[9]) {
#pragma unroll
  for (int i = 0; i < 9; ++i) out[i] = lift<T>(p[i]);
}

// C = A B of 3x3 row-major matrices
template <typename T>
__device__ __forceinline__ void mat_mul(const T A[9], const T B[9], T C[9]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[i * 3 + j] = A[i * 3 + 0] * B[0 * 3 + j] + A[i * 3 + 1] * B[1 * 3 + j]
                     + A[i * 3 + 2] * B[2 * 3 + j];
}

// y = A x (the plain version's _mv)
template <typename T>
__device__ __forceinline__ void mat_vec(const T A[9], const T x[3], T y[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    y[i] = A[i * 3 + 0] * x[0] + A[i * 3 + 1] * x[1] + A[i * 3 + 2] * x[2];
}

// torch.linalg.norm of a 3-vector
__device__ __forceinline__ float norm3(const float w[3]) {
  return sqrtf(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]);
}
__device__ __forceinline__ Dual norm3(const Dual w[3]) {
  const float n = sqrtf(w[0].v * w[0].v + w[1].v * w[1].v + w[2].v * w[2].v);
  const float dot = w[0].v * w[0].t + w[1].v * w[1].t + w[2].v * w[2].t;
  return {n, n == 0.0f ? 0.0f : dot / n};
}

// geom/se3.py::so3_exp (Rodrigues)
template <typename T>
__device__ __forceinline__ void so3_exp(const T w[3], T R[9]) {
  const T theta = norm3(w);
  const bool small = val(theta) < 1e-8f;
  const T safe = where_(small, lift<T>(1.0f), theta);
  const T k[3] = {w[0] / safe, w[1] / safe, w[2] / safe};
  const T z = lift<T>(0.0f);  // zeros_like: no tangent
  const T K[9] = {z, -k[2], k[1], k[2], z, -k[0], -k[1], k[0], z};
  T KK[9];
  mat_mul(K, K, KK);
  const T s = sin_(theta);
  const T c1 = 1.0f - cos_(theta);
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    const float eye = (e % 4 == 0) ? 1.0f : 0.0f;
    const T r = (s * K[e] + eye) + c1 * KK[e];
    R[e] = where_(small, lift<T>(eye), r);
  }
}

// graph/imu_graph.py::_imu_residual of interval k between states si
// (prev(k)) and sj (k), unwhitened: r_R, r_v, r_p
template <typename T>
__device__ __forceinline__ void imu_res(const ChainData& c, int k,
                                        const T si[kS], const T sj[kS],
                                        T r[9]) {
  T Ri[9], Rj[9];
  euler_to_rot(si[0], si[1], si[2], Ri);
  euler_to_rot(sj[0], sj[1], sj[2], Rj);
  const T gv = lift<T>(*c.gravity);
  const T g[3] = {gv * 0.0f, gv * 0.0f, -gv};
  T dba[3], dbg[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    dba[i] = si[9 + i] - lift<T>(c.bias_acc[3 * k + i]);
    dbg[i] = si[12 + i] - lift<T>(c.bias_gyr[3 * k + i]);
  }
  T M[9], w[3], E[9], dR0[9], dR[9];
  lift9(c.dR_dbg + 9 * k, M);
  mat_vec(M, dbg, w);
  so3_exp(w, E);
  lift9(c.dR + 9 * k, dR0);
  mat_mul(dR0, E, dR);
  T dv[3], dp[3], t1[3], t2[3];
  lift9(c.dv_dba + 9 * k, M);
  mat_vec(M, dba, t1);
  lift9(c.dv_dbg + 9 * k, M);
  mat_vec(M, dbg, t2);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    dv[i] = (lift<T>(c.dv[3 * k + i]) + t1[i]) + t2[i];
  lift9(c.dp_dba + 9 * k, M);
  mat_vec(M, dba, t1);
  lift9(c.dp_dbg + 9 * k, M);
  mat_vec(M, dbg, t2);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    dp[i] = (lift<T>(c.dp[3 * k + i]) + t1[i]) + t2[i];

  const T dt = lift<T>(c.dt[k]);
  T Rij[9], E2[9];
  mat_tmul(Ri, Rj, Rij);   // Ri^T Rj
  mat_tmul(dR, Rij, E2);   // dR^T (Ri^T Rj)
  so3_log(E2, r);
  T x[3], y[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) x[i] = (sj[6 + i] - si[6 + i]) - g[i] * dt;
  mat_tvec(Ri, x, y);
#pragma unroll
  for (int i = 0; i < 3; ++i) r[3 + i] = y[i] - dv[i];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    x[i] = ((sj[3 + i] - si[3 + i]) - si[6 + i] * dt) - ((g[i] * 0.5f) * dt)
           * dt;
  mat_tvec(Ri, x, y);
#pragma unroll
  for (int i = 0; i < 3; ++i) r[6 + i] = y[i] - dp[i];
}

// graph/imu_graph.py::_bias_res of interval k
template <typename T>
__device__ __forceinline__ void bias_res(const ChainData& c, int k,
                                         const T si[kS], const T sj[kS],
                                         T r[6]) {
  const T sq = sqrt_(clamp_min_(lift<T>(c.dt[k]), 1e-6f));
#pragma unroll
  for (int o = 0; o < 6; ++o)
    r[o] = (sj[9 + o] - si[9 + o]) / (sq * lift<T>(c.bias_sigma[o]));
}

// graph/imu_graph.py::_init_prior_res
template <typename T>
__device__ __forceinline__ void init_prior_res(const ChainData& c,
                                               const T s[kS], T r[kS]) {
#pragma unroll
  for (int o = 0; o < kS; ++o)
    r[o] = (s[o] - lift<T>(c.prior_state[o])) / lift<T>(c.prior_sigma[o]);
}

// L = chol(cov + 1e-10 I) (row-major, lower; 81 floats), every entry NaN
// where a pivot is not > 0
__device__ __forceinline__ void whiten_factor(const float* cov, float* L) {
  for (int e = 0; e < 81; ++e) L[e] = 0.0f;
  for (int j = 0; j < 9; ++j) {
    float a = cov[j * 9 + j] + 1e-10f;
    for (int m = 0; m < j; ++m) a = a - L[j * 9 + m] * L[j * 9 + m];
    if (!(a > 0.0f)) {
      for (int e = 0; e < 81; ++e) L[e] = __int_as_float(0x7fc00000);
      return;
    }
    const float l = sqrtf(a);
    L[j * 9 + j] = l;
    for (int i = j + 1; i < 9; ++i) {
      float v = cov[i * 9 + j];
      for (int m = 0; m < j; ++m) v = v - L[i * 9 + m] * L[j * 9 + m];
      L[i * 9 + j] = v / l;
    }
  }
}

// x <- L^-1 x (forward substitution)
__device__ __forceinline__ void whiten9(const float* L, float x[9]) {
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    float v = x[i];
    for (int m = 0; m < i; ++m) v = v - L[i * 9 + m] * x[m];
    x[i] = v / L[i * 9 + i];
  }
}

__device__ __forceinline__ bool imu_live(const ChainData& c, int k) {
  return c.preint_mask[k] != 0 && c.state_mask[k] != 0;
}
__device__ __forceinline__ bool pp_live(const ChainData& c, int k) {
  return c.pose_meas_mask[k] != 0 && c.state_mask[k] != 0;
}

// Column `col` (0..29) of factor k at states P [K, 15], Lk the interval's
// whitening factor: the IMU and bias factors' Jacobian column (col < 15: of
// state prev(k) = max(k - 1, 0), else of state k) and, for col >= 15, the
// pose prior's column col - 15 and, at k = 0, the init prior's; the
// residuals from the threads of column 0 (IMU, bias) and 15 (priors).
// Masked factors are written as zeros.
__device__ __forceinline__ void eval_column(const ChainData& c,
                                            const float* P, const float* Lk,
                                            int k, int col, const Blocks& b) {
  const int kp = k > 0 ? k - 1 : 0;
  const bool of_j = col >= kS;
  const int jc = of_j ? col - kS : col;
  const bool m_imu = imu_live(c, k);
  {
    Dual si[kS], sj[kS];
    load_state<Dual>(P + kS * kp, of_j ? -1 : jc, si);
    load_state<Dual>(P + kS * k, of_j ? jc : -1, sj);
    Dual r[9];
    imu_res<Dual>(c, k, si, sj, r);
    float rv[9], rt[9];
#pragma unroll
    for (int o = 0; o < 9; ++o) {
      rv[o] = r[o].v;
      rt[o] = r[o].t;
    }
    whiten9(Lk, rt);
    float* J = of_j ? b.Jj : b.Ji;
#pragma unroll
    for (int o = 0; o < 9; ++o) J[(k * 9 + o) * kS + jc] = m_imu ? rt[o] : 0.0f;
    if (col == 0) {
      whiten9(Lk, rv);
#pragma unroll
      for (int o = 0; o < 9; ++o) b.r_imu[k * 9 + o] = m_imu ? rv[o] : 0.0f;
    }
    Dual rb[6];
    bias_res<Dual>(c, k, si, sj, rb);
    float* Jb = of_j ? b.Jbj : b.Jbi;
#pragma unroll
    for (int o = 0; o < 6; ++o)
      Jb[(k * 6 + o) * kS + jc] = m_imu ? rb[o].t : 0.0f;
    if (col == 0)
#pragma unroll
      for (int o = 0; o < 6; ++o) b.r_b[k * 6 + o] = m_imu ? rb[o].v : 0.0f;
  }
  if (!of_j) return;
  const bool m_pp = pp_live(c, k);
  Dual rp[6];
  prior_res<Dual>(P + kS * k, c.pose_meas + 6 * k, c.pose_sigma + 6 * k, jc,
                  rp);
#pragma unroll
  for (int o = 0; o < 6; ++o)
    b.Jpp[(k * 6 + o) * kS + jc] = m_pp ? rp[o].t : 0.0f;
  if (jc == 0)
#pragma unroll
    for (int o = 0; o < 6; ++o) b.r_pp[k * 6 + o] = m_pp ? rp[o].v : 0.0f;
  if (k != 0) return;
  Dual s0[kS], r0[kS];
  load_state<Dual>(P, jc, s0);
  init_prior_res<Dual>(c, s0, r0);
#pragma unroll
  for (int o = 0; o < kS; ++o) b.J_0[o * kS + jc] = r0[o].t;
  if (jc == 0)
#pragma unroll
    for (int o = 0; o < kS; ++o) b.r_0[o] = r0[o].v;
}

// The squared whitened residuals of factor k at P, by kind: the IMU, bias
// and pose-prior factors' (0 where masked)
__device__ __forceinline__ void factor_sq(const ChainData& c, const float* P,
                                          const float* Lk, int k,
                                          float e[3]) {
  e[0] = e[1] = e[2] = 0.0f;
  if (imu_live(c, k)) {
    float si[kS], sj[kS], r[9], rb[6];
    load_state<float>(P + kS * (k > 0 ? k - 1 : 0), -1, si);
    load_state<float>(P + kS * k, -1, sj);
    imu_res<float>(c, k, si, sj, r);
    whiten9(Lk, r);
#pragma unroll
    for (int o = 0; o < 9; ++o) e[0] += r[o] * r[o];
    bias_res<float>(c, k, si, sj, rb);
#pragma unroll
    for (int o = 0; o < 6; ++o) e[1] += rb[o] * rb[o];
  }
  if (pp_live(c, k)) {
    float rp[6];
    prior_res<float>(P + kS * k, c.pose_meas + 6 * k, c.pose_sigma + 6 * k,
                     -1, rp);
#pragma unroll
    for (int o = 0; o < 6; ++o) e[2] += rp[o] * rp[o];
  }
}
