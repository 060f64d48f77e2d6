// The pieces of a Levenberg-Marquardt step that the card's LM kernels
// share (csrc/pose_graph_lm.cu's route A and csrc/imu_chain_lm.cu: the
// steps of graph/pose_graph.py::_lm_solve_step and of the JAX package's LM
// loops, graph/pose_graph.py and graph/imu_graph.py, whose loop bodies are
// the same):
//
//   block_sum       a sum over the CTA in a fixed order (warp shuffles,
//                   then the warps' sums in warp order): the same inputs
//                   give the same bits, launch after launch
//   divide          x / y with no slow path for a zero x
//   clamp_min_nan   torch.clamp(min=) with NaN kept (the Jacobi scaling's
//                   d = sqrt(max(diag H, 1e-12)) + pin)
//   lm_next_lambda  the damping after a step
//   LmProf          the diagnostic builds' clock64 stage stamps
//                   (clock_prof.cuh)
//
// Every thread of the CTA calls block_sum.  float32 throughout; the
// operations round one by one (kernels.SOURCE_FLAGS builds without FMA
// contraction).
//
// Include once per translation unit, inside an anonymous namespace.
//
// Built with -DFBPR_LM_PROFILE (chip_smoke.py's diagnostic builds of
// pose_graph_lm.cu and imu_chain_lm.cu, never the shipped ones), LmProf
// (clock_prof.cuh's StageClock, which the source includes first) stamps
// clock64() on thread 0 at the end of each stage of an LM solve and adds
// the sums into g_lm_prof, which the source's *_profile entry point reads:
// [0] solves, [1] iterations, [2 + s] the cycles of stage s (kLmStages),
// [10] the kernel's cycles and [11] its globaltimer ns on thread 0.  The
// shipped build compiles every stamp away.

constexpr int kLmStages = 8;

PROF(__device__ unsigned long long g_lm_prof[2 + kLmStages + 2];)

struct LmProf : StageClock<kLmStages> {
  __device__ void finish(int iterations) {
    PROF(StageClock::finish(g_lm_prof, 1ull,
                            static_cast<unsigned long long>(iterations));)
  }
};

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

// x / y, bit for bit, with no zero dividend: a zero x over a positive
// finite y comes back as it is (0 / y keeps x's sign) and the lane divides
// 1 instead.  A zero dividend sends the IEEE division to its slow path,
// ~225 cycles more on an H100 (scripts/warp_latency.py), and the LM
// kernels' matrices hold many exact zeros; every lane divides, so a warp
// does not diverge on it.
__device__ __forceinline__ float divide(float x, float y) {
  const bool keep = x == 0.0f && y > 0.0f && y < INFINITY;
  const float q = (keep ? 1.0f : x) / y;
  return keep ? x : q;
}

// torch.clamp(min=): NaN stays NaN
__device__ __forceinline__ float clamp_min_nan(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// The LM damping after a step: lam * 0.3 (floor 1e-6) if it was accepted,
// lam * 4 (cap 1e6) if not
__device__ __forceinline__ float lm_next_lambda(float lam, bool accept) {
  return accept ? fmaxf(lam * 0.3f, 1e-6f) : fminf(lam * 4.0f, 1e6f);
}
