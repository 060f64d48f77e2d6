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
//                             (kThreads threads), n up to kMaxLive.  H (a
//                             D x (D+1) float32 array, of which only the
//                             envelope below is written, factored in
//                             place), grad, the scaling, the poses and their
//                             trial step live in shared memory.  Once a
//                             solve: the envelope.  An iteration: the
//                             unmasked factors' Jacobian columns in one
//                             pass (each column one thread's dual-number
//                             evaluation, csrc/pose_graph.cuh; more passes
//                             only past kMaxCols columns), then every
//                             envelope entry of H and every entry of grad
//                             summed by its one owner thread from the
//                             factors that touch it, in slot order
//                             (priors, betweens, GPS; no float atomics, no
//                             barrier a factor); the scaling and damping on
//                             the envelope; the envelope Cholesky with the
//                             forward solve in it and the backward solve
//                             (below); the step (0 on inactive rows), the
//                             new cost from the residuals, accept (the
//                             factorization held and the cost fell) and
//                             lam.  Writes poses [K, 6] (non-live rows
//                             copied through), the cost and each
//                             iteration's accept flag.
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
// Route A's envelope.  H's block (x, y) of live poses is nonzero only where
// x == y or an unmasked between factor joins x and y; the masks and
// endpoints do not change in a solve.  fb[x], the envelope's first block of
// block row x, is the lowest live pose any unmasked between factor couples
// x to (x itself if none).  In the dense right-looking Cholesky every entry
// of a row left of its envelope stays 0.0, so L lies in the envelope: the
// window graph of pipeline/slam.py (a prior, the odometry chain, unary GPS
// factors) is block tridiagonal, a column touching at most 11 rows below
// its diagonal; a loop closure widens the rows of its later pose.  Column k
// (in block q) updates only the rows below it in block q and the rows of
// the blocks p > q with fb[p] <= q (colmask[q]), each entry's subtractions
// in the dense factorization's order, so the envelope holds the dense
// factor's bits.  A block column that updates at most kWarpBlocks later
// blocks runs on warp 0 alone, a lane a row, the block's six columns
// through shuffles and registers and the later rows' entries after them,
// with no CTA barrier; a wider one runs on the whole CTA, a thread a row
// of the block column, then its rank-6 update a row a warp.
// The forward solve L y = b runs inside the factorization (b as one more
// column: y_k once L_kk is known, then b's rows of column k), the backward
// solve L^T x = y on warp 0 block row by block row, each over the
// envelope.  Non-finite H: the
// dense update would carry NaN (0 x inf) outside the envelope, but the
// verdict is the same, since a non-finite entry inside the envelope makes a
// later pivot of its own row NaN or -inf (L_ik^2 subtracted from it) and
// fails the factorization there or earlier in both.
//
// Built with -DFBPR_LM_PROFILE (chip_smoke.py's diagnostic build), route A
// stamps its stages (dense_lm.cuh's LmProf): 0 the prologue (the envelope,
// the first cost), then an iteration's 7 Jacobian columns and 1 the rest
// of the assembly (the compaction, the owners' sums), 2 scaling and damping,
// 3 Cholesky with the forward solve, 4 backward solve and step, 5 new cost
// and accept, and 6 the epilogue; fbpr_pose_graph_lm_profile reads them.
//
// Bound.  Operations: a step is, over the envelope of E entries and D rows,
// sum_k m_k (m_k + 1) / 2 for the Cholesky (m_k the rows column k updates),
// 2 E for the solves and ~F x 12 x 12 x 6 for the blocks; at D = 180 (the
// SLAM window's 30 live poses) some 0.1 MFLOP a step.  One CTA is latency-
// bound on the Cholesky's D dependent column steps (a warp's __syncwarp
// each on the window's chain) and the backward solve's D, not on either
// rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#ifdef FBPR_LM_PROFILE
#define FBPR_PROF
#endif
#include "clock_prof.cuh"
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

constexpr int kMaxCols = 448;     // Jacobian columns of one evaluation pass
constexpr int kMaxPass = kMaxCols / 6;  // factors of one pass, at most
constexpr int kWarpBlocks = 4;    // later blocks a block column may update
                                  // on one warp (6 + 6 x 4 rows, a lane each)
constexpr int kBlocks = 40;       // envelope arrays' room, in live poses
constexpr int kTriPairs = 3 * kWarpBlocks * (6 * kWarpBlocks + 1);
constexpr int kSegs = (6 * kBlocks + 31) / 32;  // a wide column's rows / 32
constexpr int kPanRows = 8 * 6 * kBlocks;  // a wide column's L, 8 a row
constexpr int kPanel = kPanRows + 48;      // and the diagonal block's L, y

// Route A's shared scratch besides H and its vectors, in 4-byte words: the
// envelope (colmask[q]: the blocks p > q with fb[p] <= q, 64-bit; fb; erow,
// the envelope's entries before each block row), the failure flag, the
// compaction's warp counts, the cost's block sums, a window's unmasked
// factors, a pass's factors (endpoints and kind; J and residual offsets),
// its Jacobian columns and residuals, each live pose's factors in the
// pass (inc from inc[ioff[x]] to inc[ioff[x + 1]]), and the warp block
// step's triangle of (u, w) pairs (16 bits each).  The Cholesky's column
// and row list reuse the Jacobian columns' room.
struct Scratch {
  static constexpr int kMask = 0, kFb = 2 * kBlocks, kErow = kFb + kBlocks;
  static constexpr int kFlag = kErow + kBlocks + 1, kWcnt = kFlag + 1;
  static constexpr int kRed = kWcnt + 3 * (kThreads / 32);
  static constexpr int kList = kRed + 32, kEnds = kList + kThreads;
  static constexpr int kOffs = kEnds + kMaxPass, kJ = kOffs + kMaxPass;
  static constexpr int kR = kJ + 6 * kMaxCols, kIoff = kR + kMaxCols;
  static constexpr int kInc = kIoff + kBlocks + 1;
  static constexpr int kTri = kInc + 2 * kMaxPass;
  static constexpr int kWords = kTri + kTriPairs / 2;
};

// Route A's dynamic shared memory, in floats: A (D x (D+1)), grad, d, b,
// pin, P, P + step, the scratch
__host__ __device__ constexpr long lm_smem_floats(int n) {
  return static_cast<long>(6 * n) * (6 * n + 1) + 6L * (6 * n)
         + Scratch::kWords;
}
constexpr int lm_max_live() {
  int n = 1;
  while (lm_smem_floats(n + 1) * 4 <= kOptinSmem) ++n;
  return n;
}
constexpr int kMaxLive = lm_max_live();
static_assert(kMaxLive == 38, "kernels.POSE_GRAPH_LM_MAX_LIVE");
static_assert(kMaxLive <= kBlocks && kBlocks <= 64, "colmask's bits");
static_assert(6 * kMaxLive <= 32 * kSegs,
              "a wide column's rows, kSegs a lane");
static_assert(kPanel + 6 * kMaxLive <= 6 * kMaxCols,
              "the Cholesky's panel and row list in the columns' room");

// A concatenated factor index c (priors, then betweens, then GPS factors,
// each in slot order): its kind and slot
__device__ __forceinline__ int kind_of(const Factors& f, int c) {
  return c < f.Fp ? 0 : c < f.Fp + f.Fb ? 1 : 2;
}
__device__ __forceinline__ int slot_of(const Factors& f, int c) {
  return c < f.Fp ? c : c < f.Fp + f.Fb ? c - f.Fp : c - f.Fp - f.Fb;
}

// A window's compacted factors: np priors, then nb betweens, then GPS
// factors.  Their Jacobian columns, Jacobian floats and residuals before
// list position i, in that order.
struct Window {
  int total, np, nb;
  __device__ int cols(int i) const {
    return 6 * min(i, np) + 12 * min(max(i - np, 0), nb)
           + 6 * max(i - np - nb, 0);
  }
  __device__ int jfloats(int i) const {
    return 36 * min(i, np) + 72 * min(max(i - np, 0), nb)
           + 18 * max(i - np - nb, 0);
  }
  __device__ int rfloats(int i) const {
    return 6 * min(i, np + nb) + 3 * max(i - np - nb, 0);
  }
};

// The unmasked factors among the concatenated indices [base, base + NT),
// into list in order; ends with a barrier
template <int NT>
__device__ Window compact_window(const Factors& f, int base, int* list,
                                 int* wcnt) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = base + tid, kind = kind_of(f, c);
  const bool use = c < f.Fp + f.Fb + f.Fg && unmasked(f, kind, slot_of(f, c));
  const unsigned b = __ballot_sync(0xffffffffu, use);
  const unsigned bp = __ballot_sync(0xffffffffu, use && kind == 0);
  const unsigned bb = __ballot_sync(0xffffffffu, use && kind == 1);
  __syncthreads();  // wcnt is free
  if (lane == 0) {
    wcnt[warp] = __popc(b);
    wcnt[NT / 32 + warp] = __popc(bp);
    wcnt[2 * (NT / 32) + warp] = __popc(bb);
  }
  __syncthreads();
  Window w{0, 0, 0};
  int off = 0;
#pragma unroll
  for (int i = 0; i < NT / 32; ++i) {
    if (i < warp) off += wcnt[i];
    w.total += wcnt[i];
    w.np += wcnt[NT / 32 + i];
    w.nb += wcnt[2 * (NT / 32) + i];
  }
  if (use) list[off + __popc(b & ((1u << lane) - 1u))] = c;
  __syncthreads();
  return w;
}

// Envelope entry e (of erow[n], block rows in order, each row's entries
// left to right) -> (row, column)
__device__ __forceinline__ void envelope_entry(const int* erow,
                                               const int* fb, int n, int e,
                                               int& i, int& j) {
  int lo = 0, hi = n - 1;  // the block row x: erow[x] <= e < erow[x + 1]
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (erow[mid] <= e) lo = mid; else hi = mid - 1;
  }
  const int x = lo, w6 = 6 * (x - fb[x]);
  int rest = e - erow[x], a = 0;
  while (rest >= w6 + a + 1) {  // row a holds w6 + a + 1 entries
    rest -= w6 + a + 1;
    ++a;
  }
  i = 6 * x + a;
  j = 6 * fb[x] + rest;
}

// H's envelope entries and grad from the factors of one pass (ends, offs,
// J, r: m factors), each entry summed by one thread from the factors that
// touch its block row (ioff, inc: built here), in the pass's order, each
// factor's blocks (x, y) in the plain version's order (i, i), (j, j),
// (i, j), (j, i); first: the entries start from 0.  Ends with a barrier.
template <int NT>
__device__ void sum_pass(float* A, int ld, float* grad, int n,
                         const int* fb, const int* erow, const int* ends,
                         const int* offs, const float* J, const float* r,
                         int m, bool first, int* ioff, int* inc) {
  const int n_env = erow[n], D = 6 * n, tid = threadIdx.x;
  for (int x = tid; x < n; x += NT) {
    int cnt = 0;
    for (int fi = 0; fi < m; ++fi) {
      const int ep = ends[fi];
      cnt += (ep & 255) == x || ((ep >> 8) & 255) == x;
    }
    ioff[x + 1] = cnt;
  }
  __syncthreads();
  if (tid == 0) {
    ioff[0] = 0;
    for (int x = 0; x < n; ++x) ioff[x + 1] += ioff[x];
  }
  __syncthreads();
  for (int x = tid; x < n; x += NT) {
    int at = ioff[x];
    for (int fi = 0; fi < m; ++fi) {
      const int ep = ends[fi];
      if ((ep & 255) == x || ((ep >> 8) & 255) == x) inc[at++] = fi;
    }
  }
  __syncthreads();
  for (int e = tid; e < n_env + D; e += NT) {
    if (e < n_env) {
      int i, j;
      envelope_entry(erow, fb, n, e, i, j);
      const int x = i / 6, a = i % 6, y = j / 6, c = j % 6;
      float h = first ? 0.0f : A[i * ld + j];
      for (int t = ioff[x]; t < ioff[x + 1]; ++t) {
        const int fi = inc[t], ep = ends[fi], kind = ep >> 16;
        const int ri = ep & 255, rj = (ep >> 8) & 255;
        if (ri != y && rj != y) continue;
        const float* Jf = J + (offs[fi] & 0xffff);
        const int no = n_out(kind), nc = n_col(kind);
        for (int k = 0; k < (kind == 1 ? 4 : 1); ++k) {
          const int ca = (k == 1 || k == 3) ? 6 : 0;  // x's columns
          const int cb = (k == 1 || k == 2) ? 6 : 0;  // y's columns
          if ((ca ? rj : ri) != x || (cb ? rj : ri) != y) continue;
          float hh = 0.0f;
          for (int o = 0; o < no; ++o)
            hh += Jf[o * nc + ca + a] * Jf[o * nc + cb + c];
          h = h + hh;
        }
      }
      A[i * ld + j] = h;
    } else {
      const int g = e - n_env, x = g / 6, a = g % 6;
      float v = first ? 0.0f : grad[g];
      for (int t = ioff[x]; t < ioff[x + 1]; ++t) {
        const int fi = inc[t], ep = ends[fi], kind = ep >> 16;
        const int ri = ep & 255, rj = (ep >> 8) & 255;
        const float* Jf = J + (offs[fi] & 0xffff);
        const float* rf = r + (offs[fi] >> 16);
        const int no = n_out(kind), nc = n_col(kind);
        for (int k = 0; k < (kind == 1 ? 2 : 1); ++k) {
          if ((k ? rj : ri) != x) continue;
          float gg = 0.0f;
          for (int o = 0; o < no; ++o) gg += Jf[o * nc + 6 * k + a] * rf[o];
          v = v + gg;
        }
      }
      grad[g] = v;
    }
  }
  __syncthreads();
}

// H's envelope and grad at poses P, from 0: the unmasked factors window by
// window (NT concatenated indices), each window's in passes of at most
// kMaxCols Jacobian columns (one thread a column), each pass summed into
// the entries by sum_pass.  Ends with a barrier.
template <int NT>
__device__ void assemble_envelope(const Factors& f, const float* P, float* A,
                                  int ld, float* grad, int n, const int* fb,
                                  const int* erow, int* sw, LmProf& prof) {
  int* list = sw + Scratch::kList;
  int* ends = sw + Scratch::kEnds;
  int* offs = sw + Scratch::kOffs;
  float* J = reinterpret_cast<float*>(sw + Scratch::kJ);
  float* r = reinterpret_cast<float*>(sw + Scratch::kR);
  const int tid = threadIdx.x;
  bool first = true;
  for (int base = 0; base < f.Fp + f.Fb + f.Fg; base += NT) {
    const Window w = compact_window<NT>(f, base, list, sw + Scratch::kWcnt);
    for (int i0 = 0; i0 < w.total;) {
      int i1 = i0 + 1;
      while (i1 < w.total && w.cols(i1 + 1) - w.cols(i0) <= kMaxCols) ++i1;
      const int c = w.cols(i0) + tid;
      if (c < w.cols(i1)) {
        // the list position i of column c, and the column within its factor
        int i, col;
        if (c < 6 * w.np) {
          i = c / 6;
          col = c % 6;
        } else if (c < 6 * w.np + 12 * w.nb) {
          i = w.np + (c - 6 * w.np) / 12;
          col = (c - 6 * w.np) % 12;
        } else {
          i = w.np + w.nb + (c - 6 * w.np - 12 * w.nb) / 6;
          col = (c - 6 * w.np - 12 * w.nb) % 6;
        }
        const int kind = kind_of(f, list[i]), s = slot_of(f, list[i]);
        const int no = n_out(kind), nc = n_col(kind);
        const int jo = w.jfloats(i) - w.jfloats(i0);
        const int ro = w.rfloats(i) - w.rfloats(i0);
        Dual res[6];
        factor_res<Dual>(f, kind, s, P, col, res);
        for (int o = 0; o < no; ++o) J[jo + o * nc + col] = res[o].t;
        if (col == 0) {
          for (int o = 0; o < no; ++o) r[ro + o] = res[o].v;
          ends[i - i0] = end_i(f, kind, s) | end_j(f, kind, s) << 8
                         | kind << 16;
          offs[i - i0] = jo | ro << 16;
        }
      }
      __syncthreads();
      prof.stamp(7);
      sum_pass<NT>(A, ld, grad, n, fb, erow, ends, offs, J, r, i1 - i0,
                   first, sw + Scratch::kIoff, sw + Scratch::kInc);
      first = false;
      i0 = i1;
    }
  }
  if (first)  // no unmasked factor: H and grad are 0
    sum_pass<NT>(A, ld, grad, n, fb, erow, ends, offs, J, r, 0, true,
                 sw + Scratch::kIoff, sw + Scratch::kInc);
}

// d = sqrt(max(diag H, 1e-12)) + pin; A = H / (d d^T) + diag(lam + pin) on
// the envelope; b = -grad / d (graph/pose_graph.py::_lm_solve_step's
// scaling, entry by entry as there); clears the failure flag.  Ends with a
// barrier.
template <int NT>
__device__ void scale_damp_envelope(float* A, int ld, int n, const int* fb,
                                    const int* erow, const float* grad,
                                    const float* pin, float lam, float* d,
                                    float* b, int* flag) {
  const int D = 6 * n, tid = threadIdx.x;
  for (int i = tid; i < D; i += NT)
    d[i] = sqrtf(clamp_min_nan(A[i * ld + i], 1e-12f)) + pin[i];
  if (tid == 0) *flag = 0;
  __syncthreads();
  for (int i = tid; i < D; i += NT) b[i] = divide(-grad[i], d[i]);
  for (int e = tid; e < erow[n]; e += NT) {
    int i, j;
    envelope_entry(erow, fb, n, e, i, j);
    float v = divide(A[i * ld + j], d[i] * d[j]);
    if (j == i) v = v + (lam + pin[i]);
    A[i * ld + j] = v;
  }
  __syncthreads();
}

// idx -> (u, w), w <= u: the idx-th entry of a lower triangle, row by row
__device__ __forceinline__ void tri_entry(int idx, int& u, int& w) {
  u = static_cast<int>((sqrtf(8.0f * idx + 1.0f) - 1.0f) * 0.5f);
  while (u * (u + 1) / 2 > idx) --u;
  while ((u + 1) * (u + 2) / 2 <= idx) ++u;
  w = idx - u * (u + 1) / 2;
}

// The rows of the blocks in mask, ascending, into rl (threads t0, t0 +
// stride, ...)
__device__ __forceinline__ void block_rows(unsigned long long mask, int* rl,
                                           int t0, int stride) {
  for (int p = t0; p < 64; p += stride)
    if ((mask >> p) & 1ull) {
      const int at = 6 * __popcll(mask & ((1ull << p) - 1ull));
      for (int i = 0; i < 6; ++i) rl[at + i] = 6 * p + i;
    }
}

// Block column q of the envelope Cholesky, with b's forward solve, on the
// whole CTA (a wide one: more than kWarpBlocks later blocks, rl's cnt):
// warp 0 factors the diagonal block, lanes 0-5 a row (as block_step_warp);
// then a thread a row of rl's blocks takes the row's six entries of the
// block column (L_rj, j in order: the earlier columns' subtractions, then
// the division) and its entry of b; then the block column's rank-6 update
// of rl's rows, a row a warp, the lanes over its entries, each entry's six
// subtractions in column order.  So every entry's subtractions run in the
// dense column steps' order.  pan: 8 floats a row of rl (its L_r0..5),
// then the diagonal block's L (kPanRows + 0..35) and y (+ 36..41).  Every
// thread calls it; false (in every thread) if a pivot is not > 0.
template <int NT>
__device__ bool block_step_cta(float* A, int ld, float* b, float* pan,
                               const int* rl, int q, int cnt, int* flag) {
  const unsigned kAll = 0xffffffffu;
  const int tid = threadIdx.x, lane = tid & 31, c0 = 6 * q, m = 6 * cnt;
  float* Ld = pan + kPanRows;
  float* Yd = Ld + 36;
  if (tid < 32) {
    const int i = lane < 6 ? lane : 0;  // lanes 6-31 on a copy of row 0
    float a[6], bi = b[c0 + i];
#pragma unroll
    for (int c = 0; c < 6; ++c)
      a[c] = c <= i ? A[(c0 + i) * ld + c0 + c] : 0.0f;
    bool ok = true;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const float p = __shfl_sync(kAll, a[j], j);
      ok = ok && p > 0.0f;
      const float l = sqrtf(p);
      const float v = divide(lane == j ? bi : a[j], l);
      const float y = __shfl_sync(kAll, v, j);
      a[j] = lane == j ? l : v;  // lanes < j: above the diagonal, unread
      bi = lane == j ? y : lane > j ? bi - a[j] * y : bi;
#pragma unroll
      for (int c = j + 1; c < 6; ++c) {
        const float lc = __shfl_sync(kAll, a[j], c);
        a[c] = a[c] - a[j] * lc;  // lanes < c: unread
      }
    }
    if (!ok) {
      if (lane == 0) *flag = 1;
    } else if (lane < 6) {
#pragma unroll
      for (int c = 0; c < 6; ++c) {
        if (c <= lane) A[(c0 + lane) * ld + c0 + c] = a[c];
        Ld[lane * 6 + c] = a[c];
      }
      b[c0 + lane] = bi;
      Yd[lane] = bi;
    }
  }
  __syncthreads();
  if (*flag) return false;
  for (int t = tid; t < m; t += NT) {
    const int r = rl[t];
    float a[6], bi = b[r];
#pragma unroll
    for (int c = 0; c < 6; ++c) a[c] = A[r * ld + c0 + c];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      a[j] = divide(a[j], Ld[j * 6 + j]);
      bi = bi - a[j] * Yd[j];
#pragma unroll
      for (int c = j + 1; c < 6; ++c) a[c] = a[c] - a[j] * Ld[c * 6 + j];
    }
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      A[r * ld + c0 + c] = a[c];
      pan[8 * t + c] = a[c];
    }
    b[r] = bi;
  }
  __syncthreads();
  // the rank-6 update: lane takes the entries (u, w = lane + 32 i), their
  // rows in registers once a block; a row's loads issue before its stores
  int rw[kSegs];
#pragma unroll
  for (int i = 0; i < kSegs; ++i) {
    const int w = lane + 32 * i;
    rw[i] = w < m ? rl[w] : 0;
  }
  for (int u = tid >> 5; u < m; u += NT / 32) {
    float lu[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) lu[j] = pan[8 * u + j];
    float* Ar = A + rl[u] * ld;
    float v[kSegs];
#pragma unroll
    for (int i = 0; i < kSegs; ++i)
      if (lane + 32 * i <= u) v[i] = Ar[rw[i]];
#pragma unroll
    for (int i = 0; i < kSegs; ++i)
      if (lane + 32 * i <= u) {
        const float* lw = pan + 8 * (lane + 32 * i);
        float s = v[i];
#pragma unroll
        for (int j = 0; j < 6; ++j) s = s - lu[j] * lw[j];
        Ar[rw[i]] = s;
      }
  }
  __syncthreads();
  return true;
}

// Block column q of the envelope Cholesky, with b's forward solve, on warp
// 0 (a narrow one: cnt <= kWarpBlocks): lane t < 6 + 6 cnt keeps row R[t]
// (block q's 6 rows, then rl's) of the block column and its entry of b in
// registers.  Column j's pivot and L_cj are shuffled from their lanes and
// each row is updated by its own lane; then each entry (R[u], R[w]) of
// rl's rows, u >= w, takes its 6 subtractions on one lane.  Every lane
// calls it; false if a pivot is not > 0.  tri: the (u, w) of each entry of
// a lower triangle of up to 6 kWarpBlocks rows, row by row (u | w << 8).
__device__ bool block_step_warp(float* A, int ld, float* b, const int* rl,
                                const unsigned short* tri, int q, int cnt) {
  const unsigned kAll = 0xffffffffu;
  const int lane = threadIdx.x & 31, m = 6 + 6 * cnt, c0 = 6 * q;
  const bool own = lane < m;
  const int r = lane < 6 ? c0 + lane : own ? rl[lane - 6] : c0;
  float a[6];
#pragma unroll
  for (int c = 0; c < 6; ++c)
    a[c] = own && (lane >= 6 || c <= lane) ? A[r * ld + c0 + c] : 0.0f;
  float bi = own ? b[r] : 0.0f;
  bool ok = true;  // no exit inside the loop: it stays unrolled
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    const float p = __shfl_sync(kAll, a[j], j);
    ok = ok && p > 0.0f;
    const float l = sqrtf(p);
    // one division a lane: lane j's y_j = b_j / l, the others' L_ij
    const float v = divide(lane == j ? bi : a[j], l);
    const float y = __shfl_sync(kAll, v, j);
    a[j] = lane == j ? l : v;  // lanes < j: above the diagonal, unread
    bi = lane == j ? y : lane > j ? bi - a[j] * y : bi;
#pragma unroll
    for (int c = j + 1; c < 6; ++c) {
      const float lc = __shfl_sync(kAll, a[j], c);
      a[c] = a[c] - a[j] * lc;  // lanes < c: unread
    }
  }
  if (!ok) return false;
  if (own) {
#pragma unroll
    for (int c = 0; c < 6; ++c)
      if (lane >= 6 || c <= lane) A[r * ld + c0 + c] = a[c];
    b[r] = bi;
  }
  const int pairs = 3 * cnt * (6 * cnt + 1);  // (6 cnt)(6 cnt + 1) / 2
  for (int e0 = 0; e0 < pairs; e0 += 32) {
    const int uw = e0 + lane < pairs ? tri[e0 + lane] : 0;
    const int u = uw & 255, w = uw >> 8;
    const int ru = __shfl_sync(kAll, r, 6 + u);
    const int rw = __shfl_sync(kAll, r, 6 + w);
    float s = e0 + lane < pairs ? A[ru * ld + rw] : 0.0f;
#pragma unroll
    for (int k = 0; k < 6; ++k)
      s = s - __shfl_sync(kAll, a[k], 6 + u) * __shfl_sync(kAll, a[k], 6 + w);
    if (e0 + lane < pairs) A[ru * ld + rw] = s;
  }
  __syncwarp();
  return true;
}

// The envelope Cholesky A = L L^T in place with L y = b (b <- y): block
// column by block column, a narrow one on warp 0, a wide one on the CTA.
// Every thread calls it; returns whether it failed (in every thread).
// Ends with a barrier.
template <int NT>
__device__ bool envelope_cholesky(float* A, int ld, int n,
                                  const unsigned long long* colmask,
                                  const unsigned short* tri, float* b,
                                  float* pan, int* rl, int* flag) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  bool failed = false;
  for (int q = 0; q < n; ++q) {
    const unsigned long long mask = colmask[q];
    const int cnt = __popcll(mask);
    if (cnt > kWarpBlocks) {
      __syncthreads();  // warp 0's columns are in place; rl is free
      if (*flag) continue;
      block_rows(mask, rl, tid, NT);
      __syncthreads();
      failed = !block_step_cta<NT>(A, ld, b, pan, rl, q, cnt, flag);
    } else if (warp == 0 && !failed) {
      block_rows(mask, rl, lane, 32);
      __syncwarp();
      failed = !block_step_warp(A, ld, b, rl, tri, q, cnt);
      if (failed && lane == 0) *flag = 1;
    }
  }
  __syncthreads();
  return *flag != 0;
}

// L^T x = y (b <- x) over the envelope, on warp 0 (every lane calls it),
// block row by block row from the last: lanes 0-5 solve the block's
// diagonal block (x_j shuffled from its lane), then the lanes subtract L_qj
// x_j from the envelope's earlier entries of b, j from the last.
__device__ void backward_solve_warp(const float* A, int ld, int n,
                                    const int* fb, float* b) {
  const int lane = threadIdx.x & 31;
  for (int q = n - 1; q >= 0; --q) {
    const int c0 = 6 * q;
    float bv = lane < 6 ? b[c0 + lane] : 0.0f, x[6], mine = 0.0f;
#pragma unroll
    for (int j = 5; j >= 0; --j) {
      x[j] = divide(__shfl_sync(0xffffffffu, bv, j),
                    A[(c0 + j) * ld + c0 + j]);
      if (lane == j) mine = x[j];
      if (lane < j) bv = bv - A[(c0 + j) * ld + c0 + lane] * x[j];
    }
    if (lane < 6) b[c0 + lane] = mine;
    for (int i = 6 * fb[q] + lane; i < c0; i += 32) {
      float v = b[i];
#pragma unroll
      for (int j = 5; j >= 0; --j) v = v - A[(c0 + j) * ld + i] * x[j];
      b[i] = v;
    }
    __syncwarp();
  }
}

__global__ void __launch_bounds__(kThreads, 1) pose_graph_lm_kernel(
    LmArgs a) {
  extern __shared__ __align__(16) float smem[];
  const int n = a.n, D = 6 * n, ld = D + 1, tid = threadIdx.x;
  float* A = smem;
  float* grad = A + D * ld;
  float* d = grad + D;
  float* b = d + D;
  float* pin = b + D;
  float* P = pin + D;
  float* Pn = P + D;
  int* sw = reinterpret_cast<int*>(Pn + D);  // 8-byte aligned: D(D+1) even
  auto* colmask = reinterpret_cast<unsigned long long*>(sw + Scratch::kMask);
  int* fb = sw + Scratch::kFb;
  int* erow = sw + Scratch::kErow;
  int* flag = sw + Scratch::kFlag;
  float* red = reinterpret_cast<float*>(sw + Scratch::kRed);
  float* pan = reinterpret_cast<float*>(sw + Scratch::kJ);
  int* rl = sw + Scratch::kJ + kPanel;
  auto* tri = reinterpret_cast<unsigned short*>(sw + Scratch::kTri);
  LmProf prof;
  prof.start();

  for (int e = tid; e < D; e += kThreads) {
    const int64_t k = a.live_idx[e / 6];
    P[e] = a.poses[k * 6 + e % 6];
    pin[e] = a.pose_mask[k] ? 0.0f : 1.0f;
  }
  // the envelope: every unmasked between factor lowers its later pose's
  // first block to its earlier pose
  for (int x = tid; x < n; x += kThreads) fb[x] = x;
  for (int e = tid; e < kTriPairs; e += kThreads) {
    int u, w;
    tri_entry(e, u, w);
    tri[e] = static_cast<unsigned short>(u | w << 8);
  }
  __syncthreads();
  for (int s = tid; s < a.f.Fb; s += kThreads)
    if (unmasked(a.f, 1, s)) {
      const int i = end_i(a.f, 1, s), j = end_j(a.f, 1, s);
      atomicMin(&fb[max(i, j)], min(i, j));
    }
  __syncthreads();
  for (int q = tid; q < n; q += kThreads) {
    unsigned long long mask = 0ull;
    for (int p = q + 1; p < n; ++p)
      if (fb[p] <= q) mask |= 1ull << p;
    colmask[q] = mask;
  }
  if (tid == 0) {
    erow[0] = 0;
    for (int x = 0; x < n; ++x) erow[x + 1] = erow[x] + 36 * (x - fb[x]) + 21;
  }
  __syncthreads();
  float cost = total_cost<kThreads>(a.f, P, red);
  float lam = 1e-4f;
  prof.stamp(0);
  for (int it = 0; it < a.iterations; ++it) {
    assemble_envelope<kThreads>(a.f, P, A, ld, grad, n, fb, erow, sw, prof);
    prof.stamp(1);
    scale_damp_envelope<kThreads>(A, ld, n, fb, erow, grad, pin, lam, d, b,
                                  flag);
    prof.stamp(2);
    const bool failed = envelope_cholesky<kThreads>(A, ld, n, colmask, tri,
                                                    b, pan, rl, flag);
    prof.stamp(3);
    bool accept = false;
    float new_cost = 0.0f;
    if (!failed) {
      if (tid < 32) backward_solve_warp(A, ld, n, fb, b);
      __syncthreads();
      for (int e = tid; e < D; e += kThreads)
        Pn[e] = P[e] + (pin[e] == 0.0f ? divide(b[e], d[e]) : 0.0f);
      __syncthreads();
    }
    prof.stamp(4);
    if (!failed) {
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
    prof.stamp(5);
  }
  for (int e = tid; e < a.K * 6; e += kThreads) {
    const int r = a.rowmap[e / 6];
    a.out_poses[e] = r >= 0 ? P[r * 6 + e % 6] : a.poses[e];
  }
  if (tid == 0) *a.out_cost = cost;
  prof.stamp(6);
  prof.finish(a.iterations);
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

#ifdef FBPR_LM_PROFILE
// The diagnostic build's stage sums (dense_lm.cuh's g_lm_prof, 12
// values) into out; reset != 0 zeroes them after.  Synchronous.
extern "C" int fbpr_pose_graph_lm_profile(unsigned long long* out,
                                          int reset) {
  return prof_read(g_lm_prof, out, reset);
}
#endif

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
