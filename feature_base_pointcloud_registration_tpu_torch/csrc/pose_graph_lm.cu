// The pose graph's Levenberg-Marquardt iterations on the card.
//
// Stands for `optimize_pose_graph` of the JAX package (graph/pose_graph.py):
// no Pallas kernel but one compiled device loop, a lax.scan of the LM steps
// (jacfwd residuals and Jacobian blocks, their scatter into a dense H and
// grad, Jacobi scaling, damping, jax.scipy.linalg.solve, accept, lam).  The
// port's plain version (graph/pose_graph.py::optimize_pose_graph_reference)
// drives the same steps from the host as hundreds of small launches.
//
// The caller (graph/pose_graph.py) compacts the live poses (active, or an
// endpoint of an unmasked factor) and remaps the factors' endpoints to live
// rows; the other poses' rows of H and grad are zero and their step is 0,
// so the solve over the n live poses is the solve over all K.  D = 6 n.
//
//   fbpr_pose_graph_lm        route A: the whole LM in one launch of one CTA
//                             (kThreads threads), n up to kMaxLive.  H (D x
//                             (D+1) float32, factored in place), grad, the
//                             scaling, the poses and their trial step live in
//                             shared memory.  An iteration: the factors in
//                             chunks (each Jacobian column one thread's
//                             dual-number evaluation, csrc/pose_graph.cuh),
//                             their blocks summed into H and grad factor by
//                             factor in slot order (priors, betweens, GPS;
//                             no float atomics), then csrc/dense_lm.cuh's
//                             scaling, damping, Cholesky and solves, the
//                             step (0 on inactive rows), the new cost from
//                             the residuals, accept (the factorization held
//                             and the cost fell) and lam.  Writes poses [K,
//                             6] (non-live rows copied through), the cost
//                             and each iteration's accept flag.
//   fbpr_pose_graph_assemble  route B, n above kMaxLive: one CTA a live pose
//                             writes its 6 rows of H [D, D] and grad into
//                             global memory from the factors that touch it,
//                             in slot order; at iteration 0 CTA 0 also
//                             writes the cost (state[0]).
//   fbpr_pose_graph_update    route B, after the dense solve (PyTorch's
//                             cholesky_ex / cholesky_solve, which JAX too
//                             runs outside any kernel): one CTA computes the
//                             new cost at poses + dx and applies accept and
//                             lam to poses, state = (cost, lam) and accepts.
//   fbpr_pose_graph_blocks    graph_factor_blocks: each factor's whitened
//                             residual and Jacobian blocks at the given
//                             poses (masked factors zeroed), one thread a
//                             (factor, Jacobian column).
//
// Masked factor slots index pose 0 or nothing: they are skipped by the
// mask, never by the index.  Every sum runs in a fixed order, so two
// launches on the same inputs give the same bits.
//
// Bound.  Operations: a step is ~D^3 / 3 for the Cholesky, 2 D^2 for the
// solves and ~F x 12 x 12 x 6 for the blocks; at D = 192 (the SLAM window)
// some 2.5 MFLOP a step, ~0.3 us at the fp32 rate.  One CTA is latency-
// bound on the Cholesky's D dependent column steps (two CTA barriers each)
// and the solves' 2 D dependent steps, not on either rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#include "pose_graph.cuh"
#include "dense_lm.cuh"

constexpr int kThreads = 512;        // route A and the update kernel
constexpr int kAsmThreads = 256;     // route B's assemble kernel
constexpr int kOptinSmem = 232448;   // bytes a block may opt in to (sm_90)

struct Factors {
  const int* ends;  // [Fp + 2 Fb + Fg]: the endpoint row of each prior,
                    // between (i, then j) and GPS factor
  const float *pm, *ps;
  const uint8_t* pk;  // prior meas, sigma [Fp, 6], mask
  const float *bm, *bs;
  const uint8_t* bk;  // between
  const float *gm, *gs;
  const uint8_t* gk;  // GPS [Fg, 3]
  int Fp, Fb, Fg;
};

// factor kinds: 0 prior (6 residuals, 6 columns), 1 between (6, 12), 2 GPS
// (3, 6)
__host__ __device__ constexpr int n_out(int kind) { return kind == 2 ? 3 : 6; }
__host__ __device__ constexpr int n_col(int kind) {
  return kind == 1 ? 12 : 6;
}

__device__ __forceinline__ int n_slots(const Factors& f, int kind) {
  return kind == 0 ? f.Fp : kind == 1 ? f.Fb : f.Fg;
}
__device__ __forceinline__ bool unmasked(const Factors& f, int kind, int s) {
  return (kind == 0 ? f.pk : kind == 1 ? f.bk : f.gk)[s] != 0;
}
__device__ __forceinline__ int end_i(const Factors& f, int kind, int s) {
  return f.ends[kind == 0 ? s : kind == 1 ? f.Fp + s : f.Fp + 2 * f.Fb + s];
}
__device__ __forceinline__ int end_j(const Factors& f, int kind, int s) {
  return kind == 1 ? f.ends[f.Fp + f.Fb + s] : end_i(f, kind, s);
}

// The whitened residual of factor s (and its Jacobian column `col` when T
// is Dual) at poses P [rows, 6]
template <typename T>
__device__ __forceinline__ void factor_res(const Factors& f, int kind, int s,
                                           const float* P, int col, T r[6]) {
  const int i = end_i(f, kind, s);
  if (kind == 0) {
    prior_res<T>(P + 6 * i, f.pm + 6 * s, f.ps + 6 * s, col, r);
  } else if (kind == 1) {
    btw_res<T>(P + 6 * i, P + 6 * end_j(f, kind, s), f.bm + 6 * s,
               f.bs + 6 * s, col, r);
  } else {
    gps_res<T>(P + 6 * i, f.gm + 3 * s, f.gs + 3 * s, col, r);
  }
}

// The cost: sum of squared whitened residuals, each kind summed in a fixed
// order, then prior + between + GPS as graph/pose_graph.py adds them
template <int NT>
__device__ float total_cost(const Factors& f, const float* P, float* red) {
  float kind_sum[3];
#pragma unroll 1
  for (int kind = 0; kind < 3; ++kind) {
    const int F = n_slots(f, kind);
    float acc = 0.0f;
    for (int base = 0; base < F; base += NT) {
      const int s = base + threadIdx.x;
      float e = 0.0f;
      if (s < F && unmasked(f, kind, s)) {
        float r[6];
        factor_res<float>(f, kind, s, P, -1, r);
        for (int o = 0; o < n_out(kind); ++o) e += r[o] * r[o];
      }
      acc += block_sum<NT>(e, red);
    }
    kind_sum[kind] = acc;
  }
  return kind_sum[0] + kind_sum[1] + kind_sum[2];
}

// Compacts the values of the threads with `use` into list, in thread order;
// returns their count (in every thread)
template <int NT>
__device__ int block_compact(bool use, int value, int* list, int* wcnt) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned b = __ballot_sync(0xffffffffu, use);
  if (lane == 0) wcnt[warp] = __popc(b);
  __syncthreads();
  int off = 0, total = 0;
#pragma unroll
  for (int w = 0; w < NT / 32; ++w) {
    const int c = wcnt[w];
    if (w < warp) off += c;
    total += c;
  }
  if (use) list[off + __popc(b & ((1u << lane) - 1u))] = value;
  __syncthreads();
  return total;
}

// Shared scratch of the assembly: a chunk's Jacobian columns and residuals,
// the compacted slot list, warp counts
template <int NT>
struct AsmScratch {
  static constexpr int kJ = (NT / 6) * 6 * 6 > (NT / 12) * 6 * 12
                                ? (NT / 6) * 6 * 6 : (NT / 12) * 6 * 12;
  static constexpr int kR = (NT / 6) * 6;
  static constexpr int kFloats = kJ + kR + NT + NT / 32;  // + list, wcnt
};

// H and grad (row-major, leading dimension ld) += the blocks of every
// unmasked factor; owner >= 0: only the blocks and grad rows of live row
// `owner` (route B's CTA), and only factors touching it.  H and grad must
// hold their starting values; ends with a barrier.
template <int NT>
__device__ void assemble(const Factors& f, const float* P, float* H, int ld,
                         float* grad, int owner, float* scratch) {
  float* J = scratch;
  float* rb = J + AsmScratch<NT>::kJ;
  int* list = reinterpret_cast<int*>(rb + AsmScratch<NT>::kR);
  int* wcnt = list + NT;
  const int tid = threadIdx.x;
#pragma unroll 1
  for (int kind = 0; kind < 3; ++kind) {
    const int F = n_slots(f, kind), no = n_out(kind), nc = n_col(kind);
    const int chunk = NT / nc;  // factors whose columns one pass evaluates
    for (int base = 0; base < F; base += NT) {
      const int s = base + tid;
      bool use = s < F && unmasked(f, kind, s);
      if (use && owner >= 0)
        use = end_i(f, kind, s) == owner || end_j(f, kind, s) == owner;
      const int n_use = block_compact<NT>(use, s, list, wcnt);
      for (int sub = 0; sub < n_use; sub += chunk) {
        const int m = min(chunk, n_use - sub);
        if (tid < m * nc) {
          const int fi = tid / nc, col = tid % nc;
          Dual r[6];
          factor_res<Dual>(f, kind, list[sub + fi], P, col, r);
          for (int o = 0; o < no; ++o) J[(fi * no + o) * nc + col] = r[o].t;
          if (col == 0)
            for (int o = 0; o < no; ++o) rb[fi * no + o] = r[o].v;
        }
        __syncthreads();
        for (int fi = 0; fi < m; ++fi) {
          const int s2 = list[sub + fi];
          const int ri = end_i(f, kind, s2), rj = end_j(f, kind, s2);
          const float* Jf = J + fi * no * nc;
          const float* rf = rb + fi * no;
          if (tid < 36) {
            const int a = tid / 6, c = tid % 6;
            // einsum("fab,fac->fbc", Ja, Jb) of the blocks (x, y) in the
            // plain version's order: (i, i), (j, j), (i, j), (j, i)
            const int blocks = kind == 1 ? 4 : 1;
            for (int k = 0; k < blocks; ++k) {
              const int ca = (k == 1 || k == 3) ? 6 : 0;  // x's columns
              const int cb = (k == 1 || k == 2) ? 6 : 0;  // y's columns
              const int x = ca ? rj : ri, y = cb ? rj : ri;
              if (owner >= 0 && x != owner) continue;
              float h = 0.0f;
              for (int o = 0; o < no; ++o)
                h += Jf[o * nc + ca + a] * Jf[o * nc + cb + c];
              float* e = H + (x * 6 + a) * ld + y * 6 + c;
              *e = *e + h;
            }
          } else if (tid < 42) {
            const int a = tid - 36;
            for (int k = 0; k < (kind == 1 ? 2 : 1); ++k) {
              const int x = k ? rj : ri;
              if (owner >= 0 && x != owner) continue;
              float g = 0.0f;
              for (int o = 0; o < no; ++o) g += Jf[o * nc + 6 * k + a] * rf[o];
              grad[x * 6 + a] = grad[x * 6 + a] + g;
            }
          }
          __syncthreads();
        }
      }
    }
  }
}

struct LmArgs {
  const float* poses;       // [K, 6]
  const uint8_t* pose_mask; // [K]
  const int64_t* live_idx;  // [n] the pose of each live row
  const int* rowmap;        // [K] the live row of each pose, -1 if none
  Factors f;
  int K, n, iterations;
  float* out_poses;  // [K, 6]
  float* out_cost;   // []
  int* accepts;      // [iterations]
};

// Route A's dynamic shared memory, in floats: A (D x (D+1)), grad, d, b,
// pin, P, P + step, the Cholesky's column, the assembly's scratch, the
// block sums' scratch
__host__ __device__ constexpr long lm_smem_floats(int n) {
  return static_cast<long>(6 * n) * (6 * n + 1) + 7L * (6 * n)
         + AsmScratch<kThreads>::kFloats + 32;
}
constexpr int lm_max_live() {
  int n = 1;
  while (lm_smem_floats(n + 1) * 4 <= kOptinSmem) ++n;
  return n;
}
constexpr int kMaxLive = lm_max_live();
static_assert(kMaxLive == 38, "kernels.POSE_GRAPH_LM_MAX_LIVE");

__global__ void __launch_bounds__(kThreads, 1) pose_graph_lm_kernel(
    LmArgs a) {
  extern __shared__ float smem[];
  const int D = 6 * a.n, ld = D + 1, tid = threadIdx.x;
  float* A = smem;
  float* grad = A + D * ld;
  float* d = grad + D;
  float* b = d + D;
  float* pin = b + D;
  float* P = pin + D;
  float* Pn = P + D;
  float* col = Pn + D;
  float* scratch = col + D;
  float* red = scratch + AsmScratch<kThreads>::kFloats;

  for (int e = tid; e < D; e += kThreads) {
    const int64_t k = a.live_idx[e / 6];
    P[e] = a.poses[k * 6 + e % 6];
    pin[e] = a.pose_mask[k] ? 0.0f : 1.0f;
  }
  __syncthreads();
  float cost = total_cost<kThreads>(a.f, P, red);
  float lam = 1e-4f;
  for (int it = 0; it < a.iterations; ++it) {
    for (int e = tid; e < D * ld; e += kThreads) A[e] = 0.0f;
    for (int e = tid; e < D; e += kThreads) grad[e] = 0.0f;
    __syncthreads();
    assemble<kThreads>(a.f, P, A, ld, grad, -1, scratch);
    lm_scale_damp<kThreads>(A, ld, D, grad, pin, lam, d, b);
    const bool failed = cholesky_lower<kThreads>(A, ld, D, col);
    bool accept = false;
    float new_cost = 0.0f;
    if (!failed) {
      if (tid < 32) chol_solve_warp(A, ld, D, b);
      __syncthreads();
      for (int e = tid; e < D; e += kThreads)
        Pn[e] = P[e] + (pin[e] == 0.0f ? b[e] / d[e] : 0.0f);
      __syncthreads();
      new_cost = total_cost<kThreads>(a.f, Pn, red);
      accept = new_cost < cost;
    }
    if (accept) {
      for (int e = tid; e < D; e += kThreads) P[e] = Pn[e];
      cost = new_cost;
    }
    lam = lm_next_lambda(lam, accept);
    if (tid == 0) a.accepts[it] = accept;
    __syncthreads();
  }
  for (int e = tid; e < a.K * 6; e += kThreads) {
    const int r = a.rowmap[e / 6];
    a.out_poses[e] = r >= 0 ? P[r * 6 + e % 6] : a.poses[e];
  }
  if (tid == 0) *a.out_cost = cost;
}

struct AsmArgs {
  const float* poses;  // [n, 6] the live poses
  Factors f;
  int n, it;
  float* H;      // [D, D]
  float* grad;   // [D]
  float* state;  // [2]: cost, lam
};

__global__ void __launch_bounds__(kAsmThreads) pose_graph_assemble_kernel(
    AsmArgs a) {
  __shared__ float scratch[AsmScratch<kAsmThreads>::kFloats];
  __shared__ float red[32];
  const int D = 6 * a.n, p = blockIdx.x;
  float* rows = a.H + static_cast<size_t>(p) * 6 * D;
  for (int e = threadIdx.x; e < 6 * D; e += kAsmThreads) rows[e] = 0.0f;
  if (threadIdx.x < 6) a.grad[p * 6 + threadIdx.x] = 0.0f;
  __syncthreads();
  assemble<kAsmThreads>(a.f, a.poses, a.H, D, a.grad, p, scratch);
  if (a.it == 0 && p == 0) {
    const float c = total_cost<kAsmThreads>(a.f, a.poses, red);
    if (threadIdx.x == 0) a.state[0] = c;
  }
}

struct UpdArgs {
  float* poses;       // [n, 6] the live poses, updated in place
  const float* dx;    // [D] the step (0 on inactive rows)
  const int* info;    // [] cholesky_ex's info
  Factors f;
  int n, it;
  float* state;  // [2]: cost, lam
  int* accepts;  // [iterations]
};

__global__ void __launch_bounds__(kThreads, 1) pose_graph_update_kernel(
    UpdArgs a) {
  extern __shared__ float Pn[];  // [D]
  __shared__ float red[32];
  const int D = 6 * a.n, tid = threadIdx.x;
  for (int e = tid; e < D; e += kThreads) Pn[e] = a.poses[e] + a.dx[e];
  __syncthreads();
  const float new_cost = total_cost<kThreads>(a.f, Pn, red);
  const float cost = a.state[0], lam = a.state[1];
  const bool accept = *a.info == 0 && new_cost < cost;
  __syncthreads();
  if (accept)
    for (int e = tid; e < D; e += kThreads) a.poses[e] = Pn[e];
  if (tid == 0) {
    a.state[0] = accept ? new_cost : cost;
    a.state[1] = lm_next_lambda(lam, accept);
    a.accepts[a.it] = accept;
  }
}

struct BlkArgs {
  const float* poses;  // [K, 6]
  int K;
  Factors f;  // ends: the factors' pose indices
  float *rp, *Jp, *rb, *Jbi, *Jbj, *rg, *Jg;
};

__global__ void __launch_bounds__(256) pose_graph_blocks_kernel(BlkArgs a) {
  const Factors& f = a.f;
  long t = static_cast<long>(blockIdx.x) * blockDim.x + threadIdx.x;
  int kind = 0;
  for (; kind < 3; ++kind) {
    const long items = static_cast<long>(n_slots(f, kind)) * n_col(kind);
    if (t < items) break;
    t -= items;
  }
  if (kind == 3) return;
  const int nc = n_col(kind), no = n_out(kind);
  const int s = static_cast<int>(t / nc), col = static_cast<int>(t % nc);
  float* r = kind == 0 ? a.rp : kind == 1 ? a.rb : a.rg;
  float* Jc = kind == 0 ? a.Jp : kind == 1 ? (col < 6 ? a.Jbi : a.Jbj) : a.Jg;
  const int c6 = col % 6;
  float rv[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  float jv[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  if (unmasked(f, kind, s)) {
    const int i = end_i(f, kind, s), j = end_j(f, kind, s);
    if (i < 0 || i >= a.K || j < 0 || j >= a.K) {
      for (int o = 0; o < no; ++o) rv[o] = jv[o] = __int_as_float(0x7fc00000);
    } else {
      Dual d[6];
      factor_res<Dual>(f, kind, s, a.poses, col, d);
      for (int o = 0; o < no; ++o) {
        rv[o] = d[o].v;
        jv[o] = d[o].t;
      }
    }
  }
  for (int o = 0; o < no; ++o) Jc[(static_cast<long>(s) * no + o) * 6 + c6] =
      jv[o];
  if (col == 0)
    for (int o = 0; o < no; ++o) r[static_cast<long>(s) * no + o] = rv[o];
}

Factors make_factors(const int* ends, const float* pm, const float* ps,
                     const uint8_t* pk, const float* bm, const float* bs,
                     const uint8_t* bk, const float* gm, const float* gs,
                     const uint8_t* gk, int Fp, int Fb, int Fg) {
  return Factors{ends, pm, ps, pk, bm, bs, bk, gm, gs, gk, Fp, Fb, Fg};
}

}  // namespace

#define FBPR_FACTOR_PARAMS                                                   \
  const int *ends, const float *pm, const float *ps, const uint8_t *pk,      \
      const float *bm, const float *bs, const uint8_t *bk, const float *gm,  \
      const float *gs, const uint8_t *gk, int Fp, int Fb, int Fg
#define FBPR_FACTOR_ARGS ends, pm, ps, pk, bm, bs, bk, gm, gs, gk, Fp, Fb, Fg

extern "C" int fbpr_pose_graph_lm(const float* poses,
                                  const uint8_t* pose_mask,
                                  const int64_t* live_idx, const int* rowmap,
                                  FBPR_FACTOR_PARAMS, int K, int n,
                                  int iterations, float* out_poses,
                                  float* out_cost, int* accepts,
                                  void* stream) {
  if (n <= 0 || n > kMaxLive || iterations < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(lm_smem_floats(n)) * 4;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pose_graph_lm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  LmArgs a{poses, pose_mask, live_idx, rowmap,
           make_factors(FBPR_FACTOR_ARGS), K, n, iterations, out_poses,
           out_cost, accepts};
  pose_graph_lm_kernel<<<1, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fbpr_pose_graph_assemble(const float* poses,
                                        FBPR_FACTOR_PARAMS, int n, float* H,
                                        float* grad, float* state, int it,
                                        void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  AsmArgs a{poses, make_factors(FBPR_FACTOR_ARGS), n, it, H, grad, state};
  pose_graph_assemble_kernel<<<n, kAsmThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fbpr_pose_graph_update(float* poses, const float* dx,
                                      const int* info, FBPR_FACTOR_PARAMS,
                                      int n, float* state, int* accepts,
                                      int it, void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(6 * n) * 4;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        pose_graph_update_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  UpdArgs a{poses, dx, info, make_factors(FBPR_FACTOR_ARGS), n, it, state,
            accepts};
  pose_graph_update_kernel<<<1, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fbpr_pose_graph_blocks(const float* poses, int K,
                                      FBPR_FACTOR_PARAMS, float* rp,
                                      float* Jp, float* rb, float* Jbi,
                                      float* Jbj, float* rg, float* Jg,
                                      void* stream) {
  const long items = 6L * Fp + 12L * Fb + 6L * Fg;
  if (items == 0) return 0;
  BlkArgs a{poses, K, make_factors(FBPR_FACTOR_ARGS), rp, Jp, rb, Jbi, Jbj,
            rg, Jg};
  pose_graph_blocks_kernel<<<static_cast<unsigned>((items + 255) / 256), 256,
                             0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
