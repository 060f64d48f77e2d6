// Point-to-point ICP on the card: one cooperative launch an icp_align run.
//
// Stands for the JAX package's `icp_align` (ops/icp.py): no Pallas kernel
// but a compiled device loop, a lax.while_loop whose body runs the streamed
// 1-NN (ops/knn.py's lax.scan) and a weighted Kabsch.  The port's plain
// version (ops/icp.py::icp_align_reference) drives it from the host: a
// Python loop that reads the transform change once an iteration, around
// knn's Python loop over chunks and torch.linalg.svd.
//
//   fbpr_icp  one persistent cooperative launch (cudaLaunchCooperativeKernel;
//             the grid is cudaOccupancyMaxActiveBlocksPerMultiprocessor x
//             the SM count, at most kMaxCtasPerSm CTAs an SM: 264 on an
//             H100) runs every iteration, the final fitness pass,
//             `iterations`, `delta` and `converged`, with no host read.
//             CTA b owns the source rows my_rows(b) (N split over the grid)
//             in every phase.
//
//   Prologue (once a run): a uniform grid of cells over the live target
//   points' bounding box, sized for ~kPerCell live points a cell (at most
//   kMaxDim cells an axis and cell_cap(M) in all): the CTAs' box partials,
//   a count of the points per cell (atomics), CTA 0's exclusive scan, then
//   the points scattered into cell order (x, y, z, index) in the scratch.
//   The order inside a cell is the atomics' and changes no result: the
//   selection is by key.  Where a live target point is not finite or lies
//   kHuge or more from the origin, or no target point is live, no cells are
//   built and every row scans the whole target.
//
//   A trip of the loop, the phases separated by this_grid().sync():
//     NN+C  the centroid c of T src (all N rows, padding included: knn's
//           centre) from the CTAs' partial sums; each row of the CTA on a
//           group of G lanes (G = 32 / 16 / ... so that the CTA's rows fill
//           its 256 threads): the row's exact 1-NN key (below); then the
//           CTA's partial sums of the weights src_mask & (d2 < max_d2) and
//           of d2 w, thread t summing the rows lo + t, lo + t + 256, ...
//           whichever lanes searched them.  If the loop stops here (it ==
//           max_iterations or delta <= eps), the fitness and the outputs
//           are written;
//     M     the normalized weights w / (sum w + 1e-12), partial sums of
//           src wn and of dst[nn] wn (the centroids);
//     H     partial sums of ((src - mu_s) wn)^T (dst[nn] - mu_d): the plain
//           version's two passes;
//     S     H, then one thread a CTA: the 3x3 SVD by one-sided Jacobi
//           (float64), R = V diag(1, 1, det(V U^T)) U^T, t = mu_d - R mu_s,
//           delta = max |T_new - T|; then the rows of T_new src and their
//           partial sums (the next NN's centroid).
//   Every CTA folds the grid's partials in CTA order (grid_sums: the
//   partials, stored value by value, loaded into shared memory at once,
//   then added in that order)
//   and runs the same SVD, so every CTA holds the same T, takes the same
//   branch, and two launches agree bitwise.  A zero H (no correspondence)
//   gives R = I, as the plain version's SVD does.
//
// The 1-NN of a row.  The key of a target point m is knn_tile.cuh's:
// d2_bits on the trip's centred coordinates q' = fl(q - c), m' = fl(m - c),
// K = clamp0(fl(fl(|q'|^2 + |m'|^2) - 2 fl(q'.m'))), the norms and the dot
// in PyTorch's order, no FMA; the row takes the least (bits, index).  The
// row's group starts from its last trip's neighbour (its key computed the
// same way), then visits the cells in shells of growing Chebyshev radius
// around the row's cell: each lane tests a share of the shell's cells and
// the group scans the points of every cell that a point closer than the
// best could lie in, the lanes over its points (TopK<1>::push: cells come
// in no index order, so ties go to the lower index by key).  After a shell
// the lanes' bests are reduced (the least key), and the search stops when
// no point outside the shells can have a smaller key; after kMaxShells
// shells the row scans the whole target instead, as it does where its
// coordinates are not finite or lie kHuge or more from c.
//
// The margin.  With u = 2^-24 and D = |q' - m'|^2 (exact), each product and
// sum rounds once, so |fl(|v|^2) - |v|^2| <= g3 |v|^2 and |fl(q'.m') -
// q'.m'| <= g3 |q'| |m'| (g_n = n u / (1 - n u)); the sum adds u, the
// difference one more rounding:
//     |K - D| <= 7.02 u (|q'|^2 + |m'|^2) + u D,
// so K >= D (1 - 2 u) - 20 u (Rq^2 + Rm^2) with Rq^2 >= |q'|^2 (from the
// row's rounded |q'|^2) and Rm^2 >= |m'|^2 for every live m (from the
// farthest corner of the live box from c).  The centring moves each
// coordinate by at most u of itself, so |q' - m'| >= |q - m| - 2 u (Rq +
// Rm), and |q - m| >= L, the distance (float64, in world coordinates) from
// q to a cell's box or to the faces beyond the shells visited, less the
// binning's float64 rounding (eps).  A cell, or everything beyond a shell,
// is skipped only when
//     (L - 2 u (Rq + Rm) - eps)^2 (1 - 2 u) - 20 u (Rq^2 + Rm^2) > B,
// B the best key so far (the search compares L with the reach sd +
// sqrt((B + sk) / (1 - 2 u)), the same condition solved for L): then every
// point there has a larger key than B and cannot be the least, so the row
// keeps the brute force's neighbour bit for bit.  A row whose weight is 0
// (src_mask false, or no key below max_d2) adds x * 0 to every sum, which
// leaves each sum's bits as they are while x is finite: a masked row skips
// the search (d2 3e38, the
// lowest live target point), and a live row skips what lies beyond
// max_d2 (B = min(B, max_d2)), keeping a finite key.
//
// Bound.  Operations: each trip 8 fp32 operations a (live source row, live
// map point) pair (knn_stream.cu's count; chip_smoke.py also counts the
// pairs the cell search visits) and ~60 a row (the transform, the sums,
// H), over 67 TFLOP/s; bytes: src and dst (13 B a point) read once.  The
// four grid barriers a trip and the one-thread SVD are latency on top.
//
// Built without FMA contraction (kernels.SOURCE_FLAGS), as knn_stream.cu.
// Built with -DFBPR_ICP_PROFILE (chip_smoke.py's diagnostic build), thread
// 0 of every CTA stamps its stages (clock_prof.cuh) and fbpr_icp_profile
// reads their sums.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

#ifdef FBPR_ICP_PROFILE
#define FBPR_PROF
#endif
#include "clock_prof.cuh"
#include "knn_tile.cuh"

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCtasPerSm = 2;
constexpr int kPartials = 20;      // a CTA's sums: centre 3, count, d2 w,
                                   // mu 6, H 9
enum { kPc = 0, kPn = 3, kPmu = 5, kPh = 11 };
constexpr int kBox = 9;            // a CTA's box partial: lo 3, hi 3, live
                                   // points, the lowest live index, bad
constexpr int kStageMax = 320;     // CTAs whose partials grid_sums stages
constexpr int kPerCell = 8;        // live points a cell, aimed at
constexpr int kMaxDim = 1024;      // cells an axis, at most
constexpr int kMaxShells = 4;      // shells before a row scans everything
constexpr float kHuge = 1.0e15f;   // m: keys of points within stay finite
constexpr double kU = 5.9604644775390625e-08;   // 2^-24

// The diagnostic build's stages (-DFBPR_ICP_PROFILE): the prologue, the
// 1-NN, C, M, H, S, the grid barriers, grid_sums, the epilogue.
// g_icp_prof: [0] CTAs, [1] trips (CTA 0), [2 + s] stage s's cycles summed
// over the CTAs, [11] the CTAs' cycles, [12] their globaltimer ns, [13]
// the (row, target point) keys computed, over every trip.
enum { kSpro, kSnn, kSc, kSm, kSh, kSs, kSbar, kSsum, kSepi, kStages };
PROF(__device__ unsigned long long g_icp_prof[2 + kStages + 3];)

struct Plan {
  int grid;
  int lanes;       // G, a row's lanes
  int cell_cap;
  long long scratch_floats;
};

struct IcpArgs {
  const float* src;        // [N, 3]
  const uint8_t* src_mask; // [N]
  const float* dst;        // [M, 3]
  const uint8_t* dst_mask; // [M]
  int N;
  int M;
  int one_chunk;           // M == chunk
  float max_d2;
  int max_iterations;
  double eps;
  int lanes;
  int cell_cap;
  float* scratch;          // plan.scratch_floats
  float* out_T;            // [4, 4]
  float* out_fitness;      // []
  uint8_t* out_converged;  // []
  int* out_iterations;     // []
  float* out_delta;        // []
};

// the scratch's parts
struct Scratch {
  float4* cell_pts;  // [M] live target points in cell order: x, y, z, index
  float* src_t;      // [N, 3] T src
  float* row_d2;     // [N] the row's d2
  int* row_i;        // [N] and neighbour (-1 before the first trip)
  float* part;       // [kPartials, grid]
  float* box;        // [grid, kBox]
  int* cell_start;   // [cell_cap + 1]
  int* cursor;       // [cell_cap] a cell's count, then its next slot
  int* pt_cell;      // [M] a live point's cell
};

__host__ __device__ inline int cell_cap(int M) { return M / 4 + 64; }

__host__ __device__ inline long long scratch_floats(int N, int M, int grid) {
  return 4LL * M + 3LL * N + 2LL * N +
         static_cast<long long>(kPartials + kBox) * grid +
         2LL * cell_cap(M) + 1 + M;
}

__device__ Scratch carve(const IcpArgs& a) {
  Scratch s;
  float* p = a.scratch;
  s.cell_pts = reinterpret_cast<float4*>(p);
  p += 4LL * a.M;
  s.src_t = p;
  p += 3LL * a.N;
  s.row_d2 = p;
  p += a.N;
  s.row_i = reinterpret_cast<int*>(p);
  p += a.N;
  s.part = p;
  p += static_cast<long long>(kPartials) * gridDim.x;
  s.box = p;
  p += static_cast<long long>(kBox) * gridDim.x;
  s.cell_start = reinterpret_cast<int*>(p);
  p += a.cell_cap + 1;
  s.cursor = reinterpret_cast<int*>(p);
  p += a.cell_cap;
  s.pt_cell = reinterpret_cast<int*>(p);
  return s;
}

// The cells, the same in every CTA (shared memory).
struct Index {
  float lo[3], hi[3];   // the live box
  double h[3];          // a cell's size (1 on an axis of one cell)
  double inv[3];        // cells a metre (0 on an axis of one cell)
  double eps;           // the binning's rounding, m
  int n[3];
  int valid;            // cells built
  int first_live;       // the lowest live index (-1: none)
};

// This CTA's rows [lo, hi) of the N rows.
__device__ __forceinline__ void my_rows(int N, int& lo, int& hi) {
  const int per = (N + gridDim.x - 1) / gridDim.x;
  lo = min(N, static_cast<int>(blockIdx.x) * per);
  hi = min(N, lo + per);
}

// Sum each of V values over the CTA's threads (a fixed shuffle tree, then
// the warps in order) into part[(off + v) * gridDim.x + blockIdx.x].
template <int V>
__device__ void block_sums(float (&v)[V], float* red, float* part,
                           int off) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    float x = v[i];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) x += __shfl_down_sync(0xffffffffu, x, d);
    if (lane == 0) red[warp * V + i] = x;
  }
  __syncthreads();
  if (threadIdx.x < V) {
    float s = red[threadIdx.x];
    for (int w = 1; w < kWarps; ++w) s += red[w * V + threadIdx.x];
    part[(off + threadIdx.x) * gridDim.x + blockIdx.x] = s;
  }
  __syncthreads();
}

// Every CTA alike: the V sums over the grid's partials, in CTA order, into
// out (shared memory).  The partials lie value by value (part[(off + v) *
// grid + b]), so the V x grid of them are one contiguous run: every thread
// loads a share into shared memory at once, then thread v < V adds its
// value's in CTA order.
template <int V>
__device__ void grid_sums(const float* part, int off, float* stage,
                          float* out) {
  const int g = gridDim.x;
  const float* src = part + off * g;
  if (g <= kStageMax) {
    for (int k = threadIdx.x; k < g * V; k += kThreads) stage[k] = src[k];
    __syncthreads();
    if (threadIdx.x < V) {
      float s = 0.0f;
#pragma unroll 8
      for (int b = 0; b < g; ++b) s += stage[threadIdx.x * g + b];
      out[threadIdx.x] = s;
    }
  } else if (threadIdx.x < V) {
    float s = 0.0f;
    for (int b = 0; b < g; ++b) s += src[threadIdx.x * g + b];
    out[threadIdx.x] = s;
  }
  __syncthreads();
}

// ---- the cells ----

// The CTA's box partial of the live target points of its slice of the
// target (j in [b * per, (b + 1) * per)): lo, hi (finite points within
// kHuge), the live count, the lowest live index and whether a live point is
// not finite or not within kHuge, into box[blockIdx.x * kBox ...].
__device__ void box_partial(const IcpArgs& a, const Scratch& s, float* fred,
                            int* ired) {
  float lo[3] = {INFINITY, INFINITY, INFINITY};
  float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  int cnt = 0, first = INT_MAX, bad = 0;
  const int per = (a.M + gridDim.x - 1) / gridDim.x;
  const int m_lo = min(a.M, static_cast<int>(blockIdx.x) * per);
  const int m_hi = min(a.M, m_lo + per);
  for (int j = m_lo + threadIdx.x; j < m_hi; j += kThreads) {
    if (!a.dst_mask[j]) continue;
    ++cnt;
    first = min(first, j);
    const float p[3] = {a.dst[3 * j], a.dst[3 * j + 1], a.dst[3 * j + 2]};
    if (!(fabsf(p[0]) < kHuge && fabsf(p[1]) < kHuge &&
          fabsf(p[2]) < kHuge)) {
      bad = 1;
      continue;
    }
    for (int i = 0; i < 3; ++i) {
      lo[i] = fminf(lo[i], p[i]);
      hi[i] = fmaxf(hi[i], p[i]);
    }
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = 16; d > 0; d >>= 1) {
    for (int i = 0; i < 3; ++i) {
      lo[i] = fminf(lo[i], __shfl_xor_sync(0xffffffffu, lo[i], d));
      hi[i] = fmaxf(hi[i], __shfl_xor_sync(0xffffffffu, hi[i], d));
    }
    cnt += __shfl_xor_sync(0xffffffffu, cnt, d);
    first = min(first, __shfl_xor_sync(0xffffffffu, first, d));
    bad |= __shfl_xor_sync(0xffffffffu, bad, d);
  }
  if (lane == 0) {
    for (int i = 0; i < 3; ++i) {
      fred[warp * 6 + i] = lo[i];
      fred[warp * 6 + 3 + i] = hi[i];
    }
    ired[warp * 3] = cnt;
    ired[warp * 3 + 1] = first;
    ired[warp * 3 + 2] = bad;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      for (int i = 0; i < 3; ++i) {
        fred[i] = fminf(fred[i], fred[w * 6 + i]);
        fred[3 + i] = fmaxf(fred[3 + i], fred[w * 6 + 3 + i]);
      }
      ired[0] += ired[w * 3];
      ired[1] = min(ired[1], ired[w * 3 + 1]);
      ired[2] |= ired[w * 3 + 2];
    }
    float* out = s.box + blockIdx.x * kBox;
    for (int i = 0; i < 6; ++i) out[i] = fred[i];
    out[6] = __int_as_float(ired[0]);
    out[7] = __int_as_float(ired[1]);
    out[8] = __int_as_float(ired[2]);
  }
  __syncthreads();
}

// Every CTA alike: the grid's box partials folded (min, max, sums: the
// order changes nothing) and the cells laid over the box, into ix.
__device__ void make_index(const Scratch& s, int cap, float* fred, int* ired,
                           Index& ix) {
  float lo[3] = {INFINITY, INFINITY, INFINITY};
  float hi[3] = {-INFINITY, -INFINITY, -INFINITY};
  int cnt = 0, first = INT_MAX, bad = 0;
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += kThreads) {
    const float* p = s.box + b * kBox;
    for (int i = 0; i < 3; ++i) {
      lo[i] = fminf(lo[i], p[i]);
      hi[i] = fmaxf(hi[i], p[3 + i]);
    }
    cnt += __float_as_int(p[6]);
    first = min(first, __float_as_int(p[7]));
    bad |= __float_as_int(p[8]);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = 16; d > 0; d >>= 1) {
    for (int i = 0; i < 3; ++i) {
      lo[i] = fminf(lo[i], __shfl_xor_sync(0xffffffffu, lo[i], d));
      hi[i] = fmaxf(hi[i], __shfl_xor_sync(0xffffffffu, hi[i], d));
    }
    cnt += __shfl_xor_sync(0xffffffffu, cnt, d);
    first = min(first, __shfl_xor_sync(0xffffffffu, first, d));
    bad |= __shfl_xor_sync(0xffffffffu, bad, d);
  }
  if (lane == 0) {
    for (int i = 0; i < 3; ++i) {
      fred[warp * 6 + i] = lo[i];
      fred[warp * 6 + 3 + i] = hi[i];
    }
    ired[warp * 3] = cnt;
    ired[warp * 3 + 1] = first;
    ired[warp * 3 + 2] = bad;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
      for (int i = 0; i < 3; ++i) {
        fred[i] = fminf(fred[i], fred[w * 6 + i]);
        fred[3 + i] = fmaxf(fred[3 + i], fred[w * 6 + 3 + i]);
      }
      ired[0] += ired[w * 3];
      ired[1] = min(ired[1], ired[w * 3 + 1]);
      ired[2] |= ired[w * 3 + 2];
    }
    const int live = ired[0];
    ix.first_live = live > 0 ? ired[1] : -1;
    ix.valid = live > 0 && !ired[2];
    double e[3], emax = 0.0, mag = 1.0;
    for (int i = 0; i < 3; ++i) {
      ix.lo[i] = fred[i];
      ix.hi[i] = fred[3 + i];
      e[i] = ix.valid ? static_cast<double>(fred[3 + i]) - fred[i] : 0.0;
      emax = fmax(emax, e[i]);
      mag += fabs(static_cast<double>(fred[i])) + e[i];
    }
    // the cell size for ~kPerCell points a cell (a flat axis counted at
    // 1e-3 of the widest), grown until the cells fit cap
    const double flat = fmax(emax * 1e-3, 1e-6);
    double vol = 1.0;
    for (int i = 0; i < 3; ++i) vol *= fmax(e[i], flat);
    double h = cbrt(vol * kPerCell / fmax(static_cast<double>(live), 1.0));
    for (;;) {
      long long total = 1;
      for (int i = 0; i < 3; ++i) {
        const double c = e[i] > 0.0 ? ceil(e[i] / h) : 1.0;
        ix.n[i] = static_cast<int>(
            fmin(fmax(c, 1.0), static_cast<double>(kMaxDim)));
        total *= ix.n[i];
      }
      if (total <= cap) break;
      h *= 1.25;
    }
    for (int i = 0; i < 3; ++i) {
      ix.h[i] = e[i] > 0.0 ? e[i] / ix.n[i] : 1.0;
      ix.inv[i] = e[i] > 0.0 ? ix.n[i] / e[i] : 0.0;
    }
    ix.eps = 1e-9 * mag;
  }
  __syncthreads();
}

// A coordinate's cell on axis i (clamped to the grid).
__device__ __forceinline__ int cell_axis(const Index& ix, int i, float v) {
  double t = (static_cast<double>(v) - ix.lo[i]) * ix.inv[i];
  t = fmin(fmax(t, 0.0), static_cast<double>(ix.n[i] - 1));
  return static_cast<int>(t);
}

__device__ __forceinline__ int cell_of(const Index& ix, float x, float y,
                                       float z) {
  return (cell_axis(ix, 2, z) * ix.n[1] + cell_axis(ix, 1, y)) * ix.n[0] +
         cell_axis(ix, 0, x);
}

// The CTA's live target points of its slice: pt_cell and the cells' counts.
__device__ void count_cells(const IcpArgs& a, const Scratch& s,
                            const Index& ix) {
  const int per = (a.M + gridDim.x - 1) / gridDim.x;
  const int m_lo = min(a.M, static_cast<int>(blockIdx.x) * per);
  const int m_hi = min(a.M, m_lo + per);
  for (int j = m_lo + threadIdx.x; j < m_hi; j += kThreads) {
    if (!a.dst_mask[j]) continue;
    const int id = cell_of(ix, a.dst[3 * j], a.dst[3 * j + 1],
                           a.dst[3 * j + 2]);
    s.pt_cell[j] = id;
    atomicAdd(&s.cursor[id], 1);
  }
}

// CTA 0: cell_start = the exclusive scan of the counts, cursor = cell_start.
__device__ void scan_cells(const Scratch& s, int nc, int* sh) {
  const int per = (nc + kThreads - 1) / kThreads;
  const int c0 = min(nc, static_cast<int>(threadIdx.x) * per);
  const int c1 = min(nc, c0 + per);
  int sum = 0;
  for (int c = c0; c < c1; ++c) sum += s.cursor[c];
  sh[threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int t = 0; t < kThreads; ++t) {
      const int v = sh[t];
      sh[t] = run;
      run += v;
    }
    s.cell_start[nc] = run;
  }
  __syncthreads();
  int run = sh[threadIdx.x];
  for (int c = c0; c < c1; ++c) {
    const int v = s.cursor[c];
    s.cell_start[c] = run;
    s.cursor[c] = run;
    run += v;
  }
}

// The CTA's live target points of its slice into their cells' slots.
__device__ void scatter_cells(const IcpArgs& a, const Scratch& s) {
  const int per = (a.M + gridDim.x - 1) / gridDim.x;
  const int m_lo = min(a.M, static_cast<int>(blockIdx.x) * per);
  const int m_hi = min(a.M, m_lo + per);
  for (int j = m_lo + threadIdx.x; j < m_hi; j += kThreads) {
    if (!a.dst_mask[j]) continue;
    const int pos = atomicAdd(&s.cursor[s.pt_cell[j]], 1);
    s.cell_pts[pos] = make_float4(a.dst[3 * j], a.dst[3 * j + 1],
                                  a.dst[3 * j + 2], __int_as_float(j));
  }
}

// ---- a row's search ----

// The least squared distance (m^2, world coordinates) from q to cell c's
// box; the first and last cell of an axis reach to infinity (clamped
// points).
__device__ __forceinline__ double cell_gap2(const Index& ix,
                                            const int (&c)[3],
                                            const double (&q)[3]) {
  double g2 = 0.0;
  for (int i = 0; i < 3; ++i) {
    double d = 0.0;
    if (c[i] > 0) d = fmax(d, ix.lo[i] + c[i] * ix.h[i] - q[i]);
    if (c[i] < ix.n[i] - 1) {
      d = fmax(d, q[i] - (ix.lo[i] + (c[i] + 1) * ix.h[i]));
    }
    g2 += d * d;
  }
  return g2;
}

// The least distance from q to a cell outside shells 0..sh around cq, in
// L; false where those shells hold every cell.
__device__ __forceinline__ bool beyond(const Index& ix, const int (&cq)[3],
                                       int sh, const double (&q)[3],
                                       double& L) {
  bool any = false;
  L = INFINITY;
  for (int i = 0; i < 3; ++i) {
    if (cq[i] - sh - 1 >= 0) {
      any = true;
      L = fmin(L, q[i] - (ix.lo[i] + (cq[i] - sh) * ix.h[i]));
    }
    if (cq[i] + sh + 1 <= ix.n[i] - 1) {
      any = true;
      L = fmin(L, ix.lo[i] + (cq[i] + sh + 1) * ix.h[i] - q[i]);
    }
  }
  return any;
}

// The distance (m) from q beyond which every point has a larger key than
// B: the margin of the header comment, sd on the distance and sk on the
// key, (L - sd)^2 (1 - 2 u) - sk > B for L - sd > 0, solved for L (+inf
// while there is no B).
__device__ __forceinline__ double reach(double B, double sd, double sk) {
  return sd + sqrt((B + sk) / (1.0 - 2.0 * kU));
}

// The best key as a number (+inf while there is none), at most cut.
__device__ __forceinline__ double bound_of(int bits, double cut) {
  const double B = bits == kNoKey ? INFINITY
                                  : static_cast<double>(__int_as_float(bits));
  return cut < B ? cut : B;
}

// The least key over the group's G lanes, in every lane.
__device__ __forceinline__ void group_min(TopK<1>& best, unsigned gmask,
                                          int G) {
  for (int d = G >> 1; d > 0; d >>= 1) {
    const int ob = __shfl_xor_sync(gmask, best.bits[0], d, G);
    const int oi = __shfl_xor_sync(gmask, best.idx[0], d, G);
    if (key_less(ob, oi, best.bits[0], best.idx[0])) {
      best.bits[0] = ob;
      best.idx[0] = oi;
    }
  }
}

struct Row {
  float qx, qy, qz, qn;   // centred, and |q'|^2
  double q[3];            // world
  int cq[3];              // its cell
  double sd, sk;          // the margin
};

// Shell sh of the row's cells: each lane tests a share of them against
// the reach R (m), then the group scans the points of every cell kept, a
// lane a point (visited counts the lane's keys).
__device__ void visit_shell(const Scratch& s, const Index& ix, const Row& w,
                            int sh, double R, float cx, float cy, float cz,
                            int gl, int G, unsigned gmask, int gbase,
                            TopK<1>& best, int& visited) {
  int l0[3], l1[3];
  for (int i = 0; i < 3; ++i) {
    l0[i] = max(w.cq[i] - sh, 0);
    l1[i] = min(w.cq[i] + sh, ix.n[i] - 1);
  }
  const int nx = l1[0] - l0[0] + 1, nxy = nx * (l1[1] - l0[1] + 1);
  const int count = nxy * (l1[2] - l0[2] + 1);
  for (int t0 = 0; t0 < count; t0 += G) {
    const int t = t0 + gl;
    int cell = -1;
    if (t < count) {
      const int c[3] = {l0[0] + t % nx, l0[1] + (t % nxy) / nx,
                        l0[2] + t / nxy};
      const int cheb = max(abs(c[0] - w.cq[0]),
                           max(abs(c[1] - w.cq[1]), abs(c[2] - w.cq[2])));
      if (cheb == sh) {
        const int id = (c[2] * ix.n[1] + c[1]) * ix.n[0] + c[0];
        if (s.cell_start[id + 1] > s.cell_start[id] &&
            !(cell_gap2(ix, c, w.q) > R * R)) {
          cell = id;
        }
      }
    }
    unsigned keep = (__ballot_sync(gmask, cell >= 0) & gmask) >> gbase;
    while (keep) {
      const int k = __ffs(keep) - 1;
      keep &= keep - 1;
      const int id = __shfl_sync(gmask, cell, gbase + k);
      const int p1 = s.cell_start[id + 1];
      for (int p = s.cell_start[id] + gl; p < p1; p += G) {
        ++visited;
        const float4 m = s.cell_pts[p];
        const float x = m.x - cx, y = m.y - cy, z = m.z - cz;
        best.push(d2_bits(w.qx, w.qy, w.qz, w.qn,
                          make_float4(x, y, z, sq_norm(x, y, z))),
                  __float_as_int(m.w));
      }
    }
  }
}

// The 1-NN (key bits, index) of row r, in every lane of its group: the
// least key over the target, as the brute force finds it (the header
// comment), or for a row of weight 0 a finite stand-in.  Returns the keys
// the lane computed (the diagnostic build counts them).
__device__ int row_nn(const IcpArgs& a, const Scratch& s, const Index& ix,
                      int r, float cx, float cy, float cz, double Rm2,
                      bool cells, int gl, int G, unsigned gmask, int gbase,
                      int& out_b, int& out_i) {
  int visited = 0;
  Row w;
  const float wx = s.src_t[3 * r], wy = s.src_t[3 * r + 1],
              wz = s.src_t[3 * r + 2];
  w.qx = wx - cx;
  w.qy = wy - cy;
  w.qz = wz - cz;
  w.qn = sq_norm(w.qx, w.qy, w.qz);
  TopK<1> best;
  best.init();
  if (cells && fabsf(w.qx) < kHuge && fabsf(w.qy) < kHuge &&
      fabsf(w.qz) < kHuge) {
    if (!a.src_mask[r]) {
      out_b = __float_as_int(kBig);
      out_i = ix.first_live;
      return visited;
    }
    const int j0 = s.row_i[r];
    if (j0 >= 0 && j0 < a.M && a.dst_mask[j0]) {
      ++visited;
      const float x = a.dst[3 * j0] - cx, y = a.dst[3 * j0 + 1] - cy,
                  z = a.dst[3 * j0 + 2] - cz;
      best.push(d2_bits(w.qx, w.qy, w.qz, w.qn,
                        make_float4(x, y, z, sq_norm(x, y, z))),
                j0);
    }
    w.q[0] = wx;
    w.q[1] = wy;
    w.q[2] = wz;
    w.cq[0] = cell_axis(ix, 0, wx);
    w.cq[1] = cell_axis(ix, 1, wy);
    w.cq[2] = cell_axis(ix, 2, wz);
    const double Rq = sqrt(static_cast<double>(w.qn) * (1.0 + 1e-6)) *
                      (1.0 + 1e-6);
    w.sd = 2.0 * kU * (Rq + sqrt(Rm2)) + 2.0 * ix.eps;
    w.sk = 20.0 * kU * (Rq * Rq + Rm2);
    const double cut = a.max_d2;
    bool done = false;
    for (int sh = 0; sh <= kMaxShells; ++sh) {
      // the row's own cell is never pruned: shell 0 waits for no key
      const double R = sh == 0 ? INFINITY
                               : reach(bound_of(best.bits[0], cut), w.sd,
                                       w.sk);
      visit_shell(s, ix, w, sh, R, cx, cy, cz, gl, G, gmask, gbase, best,
                  visited);
      group_min(best, gmask, G);
      double L;
      if (!beyond(ix, w.cq, sh, w.q, L) ||
          L > reach(bound_of(best.bits[0], cut), w.sd, w.sk)) {
        done = true;
        break;
      }
    }
    if (done) {
      // nothing within max_d2: a finite stand-in of weight 0
      const bool none = best.bits[0] == kNoKey;
      out_b = none ? __float_as_int(a.max_d2) : best.bits[0];
      out_i = none ? ix.first_live : best.idx[0];
      return visited;
    }
  }
  // the whole target, as the brute force: masked points at 3e38, a NaN
  // key (kNoKey) never taken
  for (int j = gl; j < a.M; j += G) {
    ++visited;
    const float x = a.dst[3 * j] - cx, y = a.dst[3 * j + 1] - cy,
                z = a.dst[3 * j + 2] - cz;
    const int b = d2_bits(w.qx, w.qy, w.qz, w.qn,
                          make_float4(x, y, z,
                                      a.dst_mask[j] ? sq_norm(x, y, z)
                                                    : -1.0f));
    if (b < kNoKey) best.push(b, j);
  }
  group_min(best, gmask, G);
  int b = best.bits[0], j = best.idx[0];
  no_neighbour_rule(a.one_chunk != 0, b, j);
  out_b = b;
  out_i = j;
  return visited;
}

// geom/se3.py::kabsch's rotation of H (row-major 3x3): H = U S V^T, R = V
// diag(1, 1, det(V U^T)) U^T, by a one-sided Jacobi on H's columns in
// float64 (A V -> U S).  U's columns: the first two by singular value,
// normalized (an axis where a singular value is 0), the third their cross
// product, so R is unique wherever H has rank >= 2; H = 0 gives I.
__device__ void kabsch_rotation(const float* Hf, float* R) {
  double A[3][3], V[3][3];
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      A[i][j] = Hf[3 * i + j];
      V[i][j] = i == j ? 1.0 : 0.0;
    }
  }
  for (int sweep = 0; sweep < 32; ++sweep) {
    bool rotated = false;
    for (int pq = 0; pq < 3; ++pq) {
      const int p = pq == 2 ? 1 : 0, q = pq == 0 ? 1 : 2;
      double alpha = 0.0, beta = 0.0, gamma = 0.0;
      for (int i = 0; i < 3; ++i) {
        alpha += A[i][p] * A[i][p];
        beta += A[i][q] * A[i][q];
        gamma += A[i][p] * A[i][q];
      }
      if (!(fabs(gamma) > 1e-15 * sqrt(alpha * beta))) continue;
      rotated = true;
      const double zeta = (beta - alpha) / (2.0 * gamma);
      const double t = copysign(1.0, zeta) /
                       (fabs(zeta) + sqrt(1.0 + zeta * zeta));
      const double c = 1.0 / sqrt(1.0 + t * t), s = c * t;
      for (int i = 0; i < 3; ++i) {
        const double ap = A[i][p], aq = A[i][q];
        A[i][p] = c * ap - s * aq;
        A[i][q] = s * ap + c * aq;
        const double vp = V[i][p], vq = V[i][q];
        V[i][p] = c * vp - s * vq;
        V[i][q] = s * vp + c * vq;
      }
    }
    if (!rotated) break;
  }
  double sig[3];
  int o[3] = {0, 1, 2};
  for (int j = 0; j < 3; ++j) {
    sig[j] = sqrt(A[0][j] * A[0][j] + A[1][j] * A[1][j] + A[2][j] * A[2][j]);
  }
  // descending, stable
  for (int i = 0; i < 2; ++i) {
    for (int j = 0; j < 2 - i; ++j) {
      if (sig[o[j + 1]] > sig[o[j]]) {
        const int t = o[j];
        o[j] = o[j + 1];
        o[j + 1] = t;
      }
    }
  }
  double U[3][3];   // U[k] = the k-th column
  for (int k = 0; k < 2; ++k) {
    double u[3];
    for (int i = 0; i < 3; ++i) {
      u[i] = sig[o[k]] > 0.0 ? A[i][o[k]] : (i == o[k] ? 1.0 : 0.0);
    }
    if (k == 1) {
      // orthogonal to the first; an axis where the column is (near) 0
      double best[3] = {0.0, 0.0, 0.0}, best_n = -1.0;
      for (int c = -1; c < 3; ++c) {
        double w[3];
        for (int i = 0; i < 3; ++i) w[i] = c < 0 ? u[i] : (i == c ? 1.0 : 0.0);
        const double d = w[0] * U[0][0] + w[1] * U[0][1] + w[2] * U[0][2];
        for (int i = 0; i < 3; ++i) w[i] -= d * U[0][i];
        const double n = sqrt(w[0] * w[0] + w[1] * w[1] + w[2] * w[2]);
        const double scale = c < 0 ? sig[o[1]] : 1.0;
        if (c < 0 && n > 1e-9 * scale && sig[o[1]] > 0.0) {
          for (int i = 0; i < 3; ++i) best[i] = w[i];
          best_n = n;
          break;
        }
        if (c >= 0 && n > best_n + 1e-12) {
          for (int i = 0; i < 3; ++i) best[i] = w[i];
          best_n = n;
        }
      }
      for (int i = 0; i < 3; ++i) u[i] = best[i];
    }
    const double n = sqrt(u[0] * u[0] + u[1] * u[1] + u[2] * u[2]);
    for (int i = 0; i < 3; ++i) U[k][i] = u[i] / n;
  }
  U[2][0] = U[0][1] * U[1][2] - U[0][2] * U[1][1];
  U[2][1] = U[0][2] * U[1][0] - U[0][0] * U[1][2];
  U[2][2] = U[0][0] * U[1][1] - U[0][1] * U[1][0];
  // det(V U^T) = det(V's columns in order o) (det U = 1)
  double Vo[3][3];
  for (int i = 0; i < 3; ++i) {
    for (int k = 0; k < 3; ++k) Vo[i][k] = V[i][o[k]];
  }
  const double det =
      Vo[0][0] * (Vo[1][1] * Vo[2][2] - Vo[1][2] * Vo[2][1]) -
      Vo[0][1] * (Vo[1][0] * Vo[2][2] - Vo[1][2] * Vo[2][0]) +
      Vo[0][2] * (Vo[1][0] * Vo[2][1] - Vo[1][1] * Vo[2][0]);
  const double s3 = det < 0.0 ? -1.0 : 1.0;
  for (int i = 0; i < 3; ++i) {
    for (int j = 0; j < 3; ++j) {
      R[3 * i + j] = static_cast<float>(Vo[i][0] * U[0][j] +
                                        Vo[i][1] * U[1][j] +
                                        s3 * Vo[i][2] * U[2][j]);
    }
  }
}

// The rows [lo, hi) of T src (apply_transform: src @ R^T + t) into src_t,
// and the CTA's partial sums of them (the next NN's centroid).
__device__ void transform_rows(const IcpArgs& a, const Scratch& s,
                               const float* T, float* red, int lo, int hi) {
  float c[3] = {0.0f, 0.0f, 0.0f};
  for (int r = lo + threadIdx.x; r < hi; r += kThreads) {
    const float x = a.src[3 * r], y = a.src[3 * r + 1], z = a.src[3 * r + 2];
    for (int i = 0; i < 3; ++i) {
      const float v = (x * T[4 * i] + y * T[4 * i + 1] + z * T[4 * i + 2]) +
                      T[4 * i + 3];
      s.src_t[3 * r + i] = v;
      c[i] += v;
    }
  }
  block_sums<3>(c, red, s.part, kPc);
}

__global__ void __launch_bounds__(kThreads, kMaxCtasPerSm)
    icp_kernel(IcpArgs a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float stage[kStageMax * 9];
  __shared__ float red[kWarps * 9];
  __shared__ float sums[9];
  __shared__ float T[16];
  __shared__ float Tn[16];
  __shared__ float mu[6];
  __shared__ float ctr[3];
  __shared__ double trip_rm2;   // |m - c|^2 bound of the trip's live points
  __shared__ int trip_cells;    // the trip's rows may search the cells
  __shared__ Index ix;
  __shared__ float fred[kWarps * 6];
  __shared__ int ired[kWarps * 3];
  __shared__ int scan[kThreads];
  StageClock<kStages> prof;
  prof.start();
  PROF(unsigned long long visited = 0;)
  const Scratch s = carve(a);
  int lo, hi;
  my_rows(a.N, lo, hi);
  if (threadIdx.x < 16) T[threadIdx.x] = (threadIdx.x % 5 == 0) ? 1.0f : 0.0f;
  __syncthreads();
  float delta = 1e9f;
  int it = 0;
  // ---- prologue: T = I, the first centroid's partials; the cells ----
  transform_rows(a, s, T, red, lo, hi);
  for (int r = lo + threadIdx.x; r < hi; r += kThreads) s.row_i[r] = -1;
  box_partial(a, s, fred, ired);
  for (int c = blockIdx.x * kThreads + threadIdx.x; c < a.cell_cap;
       c += gridDim.x * kThreads) {
    s.cursor[c] = 0;
  }
  grid.sync();
  make_index(s, a.cell_cap, fred, ired, ix);
  if (ix.valid) {
    count_cells(a, s, ix);
    grid.sync();
    if (blockIdx.x == 0) scan_cells(s, ix.n[0] * ix.n[1] * ix.n[2], scan);
    grid.sync();
    scatter_cells(a, s);
    grid.sync();
  }
  prof.stamp(kSpro);
  const int G = a.lanes;
  const int gl = threadIdx.x & (G - 1);
  const int gbase = (threadIdx.x & 31) & ~(G - 1);
  const unsigned gmask = G == 32 ? 0xffffffffu : ((1u << G) - 1u) << gbase;
  for (;;) {
    // ---- NN: each of the CTA's rows, its 1-NN; C: the sums of w, d2 w ----
    grid_sums<3>(s.part, kPc, stage, sums);
    if (threadIdx.x == 0) {
      double rm2 = 0.0;
      bool near = true;
      for (int i = 0; i < 3; ++i) {
        ctr[i] = sums[i] / static_cast<float>(a.N);
        near = near && fabsf(ctr[i]) < kHuge;
        const double c = ctr[i];
        const double e = fmax(fabs(ix.lo[i] - c), fabs(ix.hi[i] - c));
        rm2 += e * e;
      }
      trip_rm2 = rm2 * (1.0 + 1e-6);
      trip_cells = ix.valid && near;
    }
    __syncthreads();
    prof.stamp(kSsum);
    const float cx = ctr[0], cy = ctr[1], cz = ctr[2];
    for (int r0 = lo; r0 < hi; r0 += kThreads / G) {
      const int r = r0 + static_cast<int>(threadIdx.x) / G;
      if (r >= hi) break;
      int b, j;
      const int keys = row_nn(a, s, ix, r, cx, cy, cz, trip_rm2,
                              trip_cells != 0, gl, G, gmask, gbase, b, j);
      PROF(visited += keys;)
      (void)keys;
      if (gl == 0) {
        s.row_d2[r] = __int_as_float(b);
        s.row_i[r] = j;
      }
    }
    __syncthreads();
    prof.stamp(kSnn);
    {
      float v[2] = {0.0f, 0.0f};
      for (int r = lo + threadIdx.x; r < hi; r += kThreads) {
        const float d2 = s.row_d2[r];
        const float w = (a.src_mask[r] && d2 < a.max_d2) ? 1.0f : 0.0f;
        v[0] += w;
        v[1] += d2 * w;
      }
      block_sums<2>(v, red, s.part, kPn);
    }
    prof.stamp(kSc);
    grid.sync();
    prof.stamp(kSbar);
    grid_sums<2>(s.part, kPn, stage, sums);
    prof.stamp(kSsum);
    const float W = sums[0];
    if (!(it < a.max_iterations && static_cast<double>(delta) > a.eps)) {
      if (blockIdx.x == 0 && threadIdx.x == 0) {
        for (int i = 0; i < 16; ++i) a.out_T[i] = T[i];
        *a.out_fitness = sums[1] / fmaxf(W, 1.0f);
        *a.out_converged = W >= 3.0f ? 1 : 0;
        *a.out_iterations = it;
        *a.out_delta = delta;
      }
      prof.stamp(kSepi);
      PROF(prof.finish(g_icp_prof, 1ull,
                       blockIdx.x == 0 ? static_cast<unsigned long long>(it + 1)
                                       : 0ull);
           atomicAdd(&g_icp_prof[2 + kStages + 2], visited);)
      return;
    }
    // ---- M: the centroids of the normalized weights ----
    const float wsum = W + 1e-12f;
    {
      float v[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (int r = lo + threadIdx.x; r < hi; r += kThreads) {
        const bool m = a.src_mask[r] && s.row_d2[r] < a.max_d2;
        const float wn = (m ? 1.0f : 0.0f) / wsum;
        const int j = s.row_i[r];
        for (int i = 0; i < 3; ++i) {
          v[i] += a.src[3 * r + i] * wn;
          v[3 + i] += a.dst[3 * j + i] * wn;
        }
      }
      block_sums<6>(v, red, s.part, kPmu);
    }
    prof.stamp(kSm);
    grid.sync();
    prof.stamp(kSbar);
    grid_sums<6>(s.part, kPmu, stage, mu);
    prof.stamp(kSsum);
    // ---- H of the centred points ----
    {
      float v[9] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
      for (int r = lo + threadIdx.x; r < hi; r += kThreads) {
        const bool m = a.src_mask[r] && s.row_d2[r] < a.max_d2;
        const float wn = (m ? 1.0f : 0.0f) / wsum;
        const int j = s.row_i[r];
        float p[3], q[3];
        for (int i = 0; i < 3; ++i) {
          p[i] = (a.src[3 * r + i] - mu[i]) * wn;
          q[i] = a.dst[3 * j + i] - mu[3 + i];
        }
        for (int i = 0; i < 3; ++i) {
          for (int k = 0; k < 3; ++k) v[3 * i + k] += p[i] * q[k];
        }
      }
      block_sums<9>(v, red, s.part, kPh);
    }
    prof.stamp(kSh);
    grid.sync();
    prof.stamp(kSbar);
    // ---- S: the rotation, the translation, delta; then T_new src ----
    grid_sums<9>(s.part, kPh, stage, sums);
    prof.stamp(kSsum);
    if (threadIdx.x == 0) {
      float R[9];
      kabsch_rotation(sums, R);
      for (int i = 0; i < 3; ++i) {
        Tn[4 * i] = R[3 * i];
        Tn[4 * i + 1] = R[3 * i + 1];
        Tn[4 * i + 2] = R[3 * i + 2];
        Tn[4 * i + 3] = mu[3 + i] - (R[3 * i] * mu[0] + R[3 * i + 1] * mu[1] +
                                     R[3 * i + 2] * mu[2]);
      }
      Tn[12] = Tn[13] = Tn[14] = 0.0f;
      Tn[15] = 1.0f;
    }
    __syncthreads();
    float dm = 0.0f;
    for (int i = 0; i < 16; ++i) dm = fmaxf(dm, fabsf(Tn[i] - T[i]));
    delta = dm;
    ++it;
    __syncthreads();
    if (threadIdx.x < 16) T[threadIdx.x] = Tn[threadIdx.x];
    __syncthreads();
    transform_rows(a, s, T, red, lo, hi);
    prof.stamp(kSs);
    grid.sync();
    prof.stamp(kSbar);
  }
}

cudaError_t make_plan(int N, int M, Plan* p) {
  int dev = 0, coop = 0, sms = 0, occ = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return rc;
  rc = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (rc != cudaSuccess) return rc;
  if (!coop) return cudaErrorNotSupported;
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return rc;
  rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, icp_kernel,
                                                     kThreads, 0);
  if (rc != cudaSuccess) return rc;
  if (occ < 1) return cudaErrorLaunchOutOfResources;
  p->grid = std::min(occ, kMaxCtasPerSm) * sms;
  // a row's lanes: as many as the CTA's rows leave (a power of two <= 32)
  const int per = (N + p->grid - 1) / p->grid;
  int lanes = 32;
  while (lanes > 1 && per * lanes > kThreads) lanes >>= 1;
  p->lanes = lanes;
  p->cell_cap = cell_cap(M);
  p->scratch_floats = scratch_floats(N, M, p->grid);
  return cudaSuccess;
}

}  // namespace

// out: (grid, lanes a row, cell cap, scratch floats) of a run at N source
// and M map points on the current device; cudaErrorNotSupported where the
// device cannot launch cooperatively.
extern "C" int fbpr_icp_plan(int N, int M, long long* out) {
  if (N < 1 || M < 1) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  const cudaError_t rc = make_plan(N, M, &p);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  out[0] = p.grid;
  out[1] = p.lanes;
  out[2] = p.cell_cap;
  out[3] = p.scratch_floats;
  return static_cast<int>(cudaSuccess);
}

// One icp_align run: src [N, 3], src_mask [N], dst [M, 3], dst_mask [M]
// (M a multiple of chunk); scratch of fbpr_icp_plan's floats (16-byte
// aligned); writes T [4, 4], fitness, converged (uint8), iterations
// (int32), delta.
extern "C" int fbpr_icp(const float* src, const uint8_t* src_mask,
                        const float* dst, const uint8_t* dst_mask, int N,
                        int M, int chunk, float max_d2, int max_iterations,
                        double eps, float* scratch, long long scratch_n,
                        float* out_T, float* out_fitness,
                        uint8_t* out_converged, int* out_iterations,
                        float* out_delta, void* stream) {
  if (N < 1 || M < 1 || chunk < 1 || M % chunk || max_iterations < 0 ||
      reinterpret_cast<uintptr_t>(scratch) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan p;
  cudaError_t rc = make_plan(N, M, &p);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (scratch_n < p.scratch_floats) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  IcpArgs a{src, src_mask, dst, dst_mask, N, M, M == chunk ? 1 : 0,
            max_d2, max_iterations, eps, p.lanes, p.cell_cap, scratch,
            out_T, out_fitness, out_converged, out_iterations, out_delta};
  void* args[] = {&a};
  rc = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(icp_kernel),
                                   dim3(p.grid), dim3(kThreads), args, 0,
                                   static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

#ifdef FBPR_ICP_PROFILE
// The diagnostic build's sums (g_icp_prof, 14 values) into out; reset != 0
// zeroes them after.  Synchronous.
extern "C" int fbpr_icp_profile(unsigned long long* out, int reset) {
  return prof_read(g_icp_prof, out, reset);
}
#endif
