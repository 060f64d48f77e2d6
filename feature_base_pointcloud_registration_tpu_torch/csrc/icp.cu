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
//             the SM count, at most kMaxCtasPerSm CTAs an SM, since every
//             CTA reduces each phase's partial sums) runs every iteration,
//             the final fitness pass, `iterations`, `delta` and
//             `converged`, with no host read.  A trip of the loop, the
//             phases separated by cooperative_groups::this_grid().sync():
//               NN   the centroid of T src (all N rows, padding included:
//                    knn's centre) from the CTAs' partial sums; then work
//                    items of kThreads queries x one slice of the map
//                    (enough slices that the items fill the grid),
//                    each thread the 1-NN key of its query in the slice,
//                    the slice streamed through shared memory centred
//                    (knn_tile.cuh);
//               C    each row's key, the least over the slices (the tie
//                    rule holds across them), the no-neighbour rule; its
//                    weight src_mask & (d2 < max_d2); partial sums of the
//                    weights and of d2 w.  If the loop stops here
//                    (it == max_iterations or delta <= eps), the fitness
//                    and the outputs are written;
//               M    the normalized weights w / (sum w + 1e-12), partial
//                    sums of src wn and of dst[nn] wn (the centroids);
//               H    partial sums of ((src - mu_s) wn)^T (dst[nn] - mu_d):
//                    the plain version's two passes (the one-pass moment
//                    form cancels at world coordinates tens of metres out);
//               S    H, then one thread a CTA: the 3x3 SVD by one-sided
//                    Jacobi (float64), R = V diag(1, 1, det(V U^T)) U^T,
//                    t = mu_d - R mu_s, delta = max |T_new - T|; then the
//                    rows of T_new src and their partial sums (the next
//                    NN's centroid).
//             Every CTA reduces the partial sums of the global scratch in
//             the same fixed order and runs the same SVD, so every CTA
//             holds the same T and takes the same branch, and two launches
//             agree bitwise.  A zero H (no correspondence) gives R = I, as
//             the plain version's SVD does.
//
// Bound.  Operations: each trip 8 fp32 operations a (live source row, live
// map point) pair (knn_stream.cu's count) and ~60 a row (the transform, the
// sums, H), over 67 TFLOP/s; bytes: src and dst (13 B a point) read once.
// At phase 8's 4096 x 16384 the pairs bound it; the 5 grid barriers a trip
// and the one-thread SVD are latency on top.
//
// Built without FMA contraction (kernels.SOURCE_FLAGS), as knn_stream.cu.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

#include "knn_tile.cuh"

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCtasPerSm = 2;
constexpr int kMaxSplits = 64;
constexpr int kSliceAlign = 64;    // map points: a slice's multiple
constexpr int kPartials = 20;      // a CTA's sums: centre 3, count, d2 w,
                                   // mu 6, H 9
enum { kPc = 0, kPn = 3, kPmu = 5, kPh = 11 };

struct Plan {
  int grid;
  int splits;
  int slice;
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
  int splits;
  int slice;
  float* scratch;          // plan.scratch_floats
  float* out_T;            // [4, 4]
  float* out_fitness;      // []
  uint8_t* out_converged;  // []
  int* out_iterations;     // []
  float* out_delta;        // []
};

// the scratch's parts
struct Scratch {
  float* src_t;    // [N, 3] T src
  int* slice_b;    // [splits, N] a slice's best key: bits
  int* slice_i;    // [splits, N] and index
  float* row_d2;   // [N] the row's d2
  int* row_i;      // [N] and neighbour
  float* part;     // [grid, kPartials]
};

__host__ __device__ inline long long scratch_floats(int N, int splits,
                                                    int grid) {
  return 3LL * N + 2LL * splits * N + 2LL * N +
         static_cast<long long>(kPartials) * grid;
}

__device__ Scratch carve(const IcpArgs& a) {
  Scratch s;
  float* p = a.scratch;
  s.src_t = p;
  p += 3LL * a.N;
  s.slice_b = reinterpret_cast<int*>(p);
  p += static_cast<long long>(a.splits) * a.N;
  s.slice_i = reinterpret_cast<int*>(p);
  p += static_cast<long long>(a.splits) * a.N;
  s.row_d2 = p;
  p += a.N;
  s.row_i = reinterpret_cast<int*>(p);
  p += a.N;
  s.part = p;
  return s;
}

// This CTA's rows [lo, hi) of the N rows.
__device__ __forceinline__ void my_rows(int N, int& lo, int& hi) {
  const int per = (N + gridDim.x - 1) / gridDim.x;
  lo = min(N, static_cast<int>(blockIdx.x) * per);
  hi = min(N, lo + per);
}

// Sum each of V values over the CTA's threads (a fixed shuffle tree, then
// the warps in order) into part[blockIdx.x * kPartials + off + v].
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
    part[blockIdx.x * kPartials + off + threadIdx.x] = s;
  }
  __syncthreads();
}

// Every CTA alike: the V sums over the grid's partials, in CTA order, into
// out (shared memory).
template <int V>
__device__ void grid_sums(const float* part, int off, float* out) {
  if (threadIdx.x < V) {
    float s = 0.0f;
    for (int b = 0; b < static_cast<int>(gridDim.x); ++b) {
      s += part[b * kPartials + off + threadIdx.x];
    }
    out[threadIdx.x] = s;
  }
  __syncthreads();
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
  __shared__ float4 tile[kTile];
  __shared__ float red[kWarps * 9];
  __shared__ float sums[9];
  __shared__ float T[16];
  __shared__ float Tn[16];
  __shared__ float mu[6];
  __shared__ float ctr[3];
  const Scratch s = carve(a);
  int lo, hi;
  my_rows(a.N, lo, hi);
  if (threadIdx.x < 16) T[threadIdx.x] = (threadIdx.x % 5 == 0) ? 1.0f : 0.0f;
  __syncthreads();
  float delta = 1e9f;
  int it = 0;
  transform_rows(a, s, T, red, lo, hi);
  grid.sync();
  const int qtiles = (a.N + kThreads - 1) / kThreads;
  const int items = qtiles * a.splits;
  for (;;) {
    // ---- NN: each item's slice, the 1-NN key of its queries ----
    grid_sums<3>(s.part, kPc, sums);
    if (threadIdx.x < 3) {
      ctr[threadIdx.x] = sums[threadIdx.x] / static_cast<float>(a.N);
    }
    __syncthreads();
    const float cx = ctr[0], cy = ctr[1], cz = ctr[2];
    for (int item = blockIdx.x; item < items; item += gridDim.x) {
      const int qt = item / a.splits, sl = item % a.splits;
      const int r = qt * kThreads + threadIdx.x;
      float qx = 0.0f, qy = 0.0f, qz = 0.0f, qn = 0.0f;
      if (r < a.N) {
        qx = s.src_t[3 * r] - cx;
        qy = s.src_t[3 * r + 1] - cy;
        qz = s.src_t[3 * r + 2] - cz;
        qn = sq_norm(qx, qy, qz);
      }
      TopK<1> best;
      best.init();
      const int m_lo = sl * a.slice, m_hi = min(a.M, m_lo + a.slice);
      for (int base = m_lo; base < m_hi; base += kTile) {
        const int n = min(kTile, m_hi - base);
        __syncthreads();
        stage_tile(a.dst, a.dst_mask, base, base + n, cx, cy, cz, tile,
                   threadIdx.x, kThreads);
        __syncthreads();
        for (int j = 0; j < n; ++j) {
          best.push_in_order(d2_bits(qx, qy, qz, qn, tile[j]), base + j);
        }
      }
      if (r < a.N) {
        s.slice_b[static_cast<long long>(sl) * a.N + r] = best.bits[0];
        s.slice_i[static_cast<long long>(sl) * a.N + r] = best.idx[0];
      }
    }
    grid.sync();
    // ---- C: each row's neighbour and weight; the sums of w and d2 w ----
    {
      float v[2] = {0.0f, 0.0f};
      for (int r = lo + threadIdx.x; r < hi; r += kThreads) {
        TopK<1> best;
        best.init();
        for (int sl = 0; sl < a.splits; ++sl) {
          best.push(s.slice_b[static_cast<long long>(sl) * a.N + r],
                    s.slice_i[static_cast<long long>(sl) * a.N + r]);
        }
        int b = best.bits[0], j = best.idx[0];
        no_neighbour_rule(a.one_chunk != 0, b, j);
        const float d2 = __int_as_float(b);
        const float w = (a.src_mask[r] && d2 < a.max_d2) ? 1.0f : 0.0f;
        s.row_d2[r] = d2;
        s.row_i[r] = j;
        v[0] += w;
        v[1] += d2 * w;
      }
      block_sums<2>(v, red, s.part, kPn);
    }
    grid.sync();
    grid_sums<2>(s.part, kPn, sums);
    const float W = sums[0];
    if (!(it < a.max_iterations && static_cast<double>(delta) > a.eps)) {
      if (blockIdx.x == 0 && threadIdx.x == 0) {
        for (int i = 0; i < 16; ++i) a.out_T[i] = T[i];
        *a.out_fitness = sums[1] / fmaxf(W, 1.0f);
        *a.out_converged = W >= 3.0f ? 1 : 0;
        *a.out_iterations = it;
        *a.out_delta = delta;
      }
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
    grid.sync();
    grid_sums<6>(s.part, kPmu, mu);
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
    grid.sync();
    // ---- S: the rotation, the translation, delta; then T_new src ----
    grid_sums<9>(s.part, kPh, sums);
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
    grid.sync();
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
  const int qtiles = (N + kThreads - 1) / kThreads;
  const int splits = std::max(1, std::min(kMaxSplits, p->grid / qtiles));
  int slice = (M + splits - 1) / splits;
  slice = (slice + kSliceAlign - 1) / kSliceAlign * kSliceAlign;
  p->slice = slice;
  p->splits = (M + slice - 1) / slice;
  p->scratch_floats = scratch_floats(N, p->splits, p->grid);
  return cudaSuccess;
}

}  // namespace

// out: (grid, splits, slice, scratch floats) of a run at N source and M map
// points on the current device; cudaErrorNotSupported where the device
// cannot launch cooperatively.
extern "C" int fbpr_icp_plan(int N, int M, long long* out) {
  if (N < 1 || M < 1) return static_cast<int>(cudaErrorInvalidValue);
  Plan p;
  const cudaError_t rc = make_plan(N, M, &p);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  out[0] = p.grid;
  out[1] = p.splits;
  out[2] = p.slice;
  out[3] = p.scratch_floats;
  return static_cast<int>(cudaSuccess);
}

// One icp_align run: src [N, 3], src_mask [N], dst [M, 3], dst_mask [M]
// (M a multiple of chunk); scratch of fbpr_icp_plan's floats; writes T
// [4, 4], fitness, converged (uint8), iterations (int32), delta.
extern "C" int fbpr_icp(const float* src, const uint8_t* src_mask,
                        const float* dst, const uint8_t* dst_mask, int N,
                        int M, int chunk, float max_d2, int max_iterations,
                        double eps, float* scratch, long long scratch_n,
                        float* out_T, float* out_fitness,
                        uint8_t* out_converged, int* out_iterations,
                        float* out_delta, void* stream) {
  if (N < 1 || M < 1 || chunk < 1 || M % chunk || max_iterations < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Plan p;
  cudaError_t rc = make_plan(N, M, &p);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (scratch_n < p.scratch_floats) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  IcpArgs a{src, src_mask, dst, dst_mask, N, M, M == chunk ? 1 : 0,
            max_d2, max_iterations, eps, p.splits, p.slice, scratch,
            out_T, out_fitness, out_converged, out_iterations, out_delta};
  void* args[] = {&a};
  rc = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(icp_kernel),
                                   dim3(p.grid), dim3(kThreads), args, 0,
                                   static_cast<cudaStream_t>(stream));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}
