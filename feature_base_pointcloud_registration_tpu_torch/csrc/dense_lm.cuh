// The dense core of a Levenberg-Marquardt step, as CTA-cooperative device
// functions on a D x D float32 matrix in shared or global memory (row-major,
// leading dimension ld): the step of graph/pose_graph.py::_lm_solve_step
// and of the JAX package's LM loops (graph/pose_graph.py, and the IMU
// chain's graph/imu_graph.py, whose loop body is the same).
//
//   lm_scale_damp     d = sqrt(max(diag H, 1e-12)) + pin;
//                     A = H / (d d^T) + diag(lam + pin) on the lower
//                     triangle; b = -grad / d
//   cholesky_lower    A = L L^T in place (right-looking, one column a step,
//                     two barriers a column); failed if a pivot is not > 0,
//                     which NaN trips too (the JAX solve's NaN, cholesky_ex's
//                     info != 0)
//   chol_solve_warp   L y = b, then L^T x = y, on one warp
//   block_sum         a sum over the CTA in a fixed order (warp shuffles,
//                     then the warps' sums in warp order): the same inputs
//                     give the same bits, launch after launch
//
// Every thread of the CTA calls each function (chol_solve_warp: every lane
// of one warp).  float32 throughout; the operations round one by one
// (kernels.SOURCE_FLAGS builds without FMA contraction).
//
// Include once per translation unit, inside an anonymous namespace.

template <int NT>
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red is free
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float s = 0.0f;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) s += red[w];
  return s;
}

// torch.clamp(min=): NaN stays NaN
__device__ __forceinline__ float clamp_min_nan(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

template <int NT>
__device__ void lm_scale_damp(float* A, int ld, int D, const float* grad,
                              const float* pin, float lam, float* d,
                              float* b) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < D; i += NT)
    d[i] = sqrtf(clamp_min_nan(A[i * ld + i], 1e-12f)) + pin[i];
  __syncthreads();
  for (int i = tid; i < D; i += NT) b[i] = -grad[i] / d[i];
  for (int i = warp; i < D; i += NT / 32) {
    const float di = d[i];
    for (int j = lane; j <= i; j += 32) {
      float v = A[i * ld + j] / (di * d[j]);
      if (j == i) v = v + (lam + pin[i]);
      A[i * ld + j] = v;
    }
  }
  __syncthreads();
}

// col: D floats of scratch.  Returns whether the factorization failed (the
// same answer in every thread).
template <int NT>
__device__ bool cholesky_lower(float* A, int ld, int D, float* col) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int k = 0; k < D; ++k) {
    const float p = A[k * ld + k];
    if (!(p > 0.0f)) return true;
    const float l = sqrtf(p);
    for (int i = k + 1 + tid; i < D; i += NT) {
      const float v = A[i * ld + k] / l;
      A[i * ld + k] = v;
      col[i] = v;
    }
    __syncthreads();
    if (tid == 0) A[k * ld + k] = l;
    for (int i = k + 1 + warp; i < D; i += NT / 32) {
      const float li = col[i];
      for (int j = k + 1 + lane; j <= i; j += 32)
        A[i * ld + j] = A[i * ld + j] - li * col[j];
    }
    __syncthreads();
  }
  return false;
}

// b <- (L L^T)^-1 b, L the lower triangle (diagonal included) of A
__device__ void chol_solve_warp(const float* A, int ld, int D, float* b) {
  const int lane = threadIdx.x & 31;
  for (int k = 0; k < D; ++k) {
    const float y = b[k] / A[k * ld + k];
    __syncwarp();
    if (lane == 0) b[k] = y;
    for (int i = k + 1 + lane; i < D; i += 32)
      b[i] = b[i] - A[i * ld + k] * y;
    __syncwarp();
  }
  for (int k = D - 1; k >= 0; --k) {
    const float x = b[k] / A[k * ld + k];
    __syncwarp();
    if (lane == 0) b[k] = x;
    for (int i = lane; i < k; i += 32) b[i] = b[i] - A[k * ld + i] * x;
    __syncwarp();
  }
}

// The LM damping after a step: lam * 0.3 (floor 1e-6) if it was accepted,
// lam * 4 (cap 1e6) if not
__device__ __forceinline__ float lm_next_lambda(float lam, bool accept) {
  return accept ? fmaxf(lam * 0.3f, 1e-6f) : fminf(lam * 4.0f, 1e6f);
}
