// Candidate fetch against a row-compacted ("resident") block table.
//
// Replaces the TPU kernel `_resident_kernel` behind `fused_resident_fetch`
// (the JAX package's ops/pallas_fetch.py).  There the compacted table sat
// whole in VMEM and each query's row was a dynamic-slice load.  A block's
// 227 KB of shared memory cannot hold the compact tables of a real map
// (1-8 MB), but the H100's 50 MB L2 holds them many times over: here the
// table is read through the read-only path (__ldg, 16-byte loads) and the
// kernel relies on L2 residency.  No persisting-L2 window is set.
//
// Contract (ops/fetch.py::resident_fetch_reference is the plain version):
//   table [R, 3*W] plane-major rows [x(W) | y(W) | z(W)], FAR=1e9 padding,
//   row R-1 the all-FAR sentinel, W = 128 * NV with NV in 1..4;
//   bcell [Q] int32 compact row ids; qx/qy/qz [Q].
//   d2 [Q, K] ascending, ties -> lowest slot, d2 > 1e17 reported as 3e38;
//   cand [3K, Q] plane-major (x rows 0..K-1, then y, then z).
//   A sentinel query reads no row: d2 = 3e38 and zero coordinates, whatever
//   the rest of its group holds.  An out-of-range id poisons its result
//   with NaN instead of reading out of bounds.
//   d2 = (dx*dx + dy*dy) + dz*dz with explicit round-to-nearest intrinsics,
//   so no FMA contraction: bitwise equal to the eager PyTorch version.
//
// Design, after the TPU kernel.  The unit of work is its group of 32
// queries, one block: a block vote (__syncthreads_or) on "any query of the
// group is live"; a dead group writes its results and reads no row.  In a
// live group a warp owns a query: each lane loads 4*NV slots of each plane
// (float4, coalesced: lane l holds slots 128*i + 4*l + c) and keeps their
// distances in registers, then K passes of a warp arg-min over (d2, slot)
// take the winners in order — the TPU kernel's min / first index / mask
// loop mapped onto a warp.  A per-lane bit mask marks the taken registers.
// The group's results are staged in shared memory so the [Q, K] and [3K, Q]
// writes go out in contiguous runs.
//
// Bound.  Per live query the kernel reads one 1.5-6 KB row from L2 and does
// ~9 operations per slot (distance plus the first compare); the [Q, K]
// outputs (16K bytes per query) go to HBM.  At the main path's shapes the
// byte bound (inputs and outputs once, over 3.35 TB/s) is the larger; the
// K passes over the registers (K * 4*NV compares and 5 shuffles each) are
// what the kernel actually spends, and they are its first target.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 32;  // the TPU kernel's _RESIDENT_GROUP
constexpr float kBig = 3.0e38f;

__device__ __forceinline__ float dist2(float x, float y, float z, float qx,
                                       float qy, float qz) {
  const float dx = __fsub_rn(x, qx);
  const float dy = __fsub_rn(y, qy);
  const float dz = __fsub_rn(z, qz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

template <int K, int NV>
__global__ void __launch_bounds__(kThreads)
resident_fetch_kernel(const float* __restrict__ table, int64_t rows,
                      const int* __restrict__ bcell,
                      const float* __restrict__ qx,
                      const float* __restrict__ qy,
                      const float* __restrict__ qz, int64_t Q,
                      float* __restrict__ d2_out, float* __restrict__ cand) {
  constexpr int W = 128 * NV;
  constexpr int R = 4 * NV;  // slots per lane
  __shared__ float s_d2[kGroup][K];
  __shared__ float s_nn[3][K][kGroup];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t q0 = (int64_t)blockIdx.x * kGroup;
  const int nq = (int)min((int64_t)kGroup, Q - q0);
  const int64_t sentinel = rows - 1;

  int live = 0;
  if (threadIdx.x < nq) live = (int64_t)bcell[q0 + threadIdx.x] != sentinel;
  if (!__syncthreads_or(live)) {
    // dead group: no row read
    for (int t = threadIdx.x; t < kGroup * K; t += kThreads) {
      s_d2[t / K][t % K] = kBig;
      for (int p = 0; p < 3; ++p) s_nn[p][t % K][t / K] = 0.0f;
    }
  } else {
    for (int j = warp; j < nq; j += kWarps) {
      const int64_t q = q0 + j;
      const int64_t row = bcell[q];
      if (row == sentinel || row < 0 || row > sentinel) {
        const bool bad = row != sentinel;
        if (lane < K) {
          s_d2[j][lane] = bad ? NAN : kBig;
          for (int p = 0; p < 3; ++p) s_nn[p][lane][j] = bad ? NAN : 0.0f;
        }
        continue;
      }
      const float* X = table + row * 3 * (int64_t)W;
      const float4* X4 = reinterpret_cast<const float4*>(X);
      const float4* Y4 = X4 + W / 4;
      const float4* Z4 = Y4 + W / 4;
      const float x = qx[q], y = qy[q], z = qz[q];

      float d[R];
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const float4 a = __ldg(X4 + 32 * i + lane);
        const float4 b = __ldg(Y4 + 32 * i + lane);
        const float4 c = __ldg(Z4 + 32 * i + lane);
        d[4 * i + 0] = dist2(a.x, b.x, c.x, x, y, z);
        d[4 * i + 1] = dist2(a.y, b.y, c.y, x, y, z);
        d[4 * i + 2] = dist2(a.z, b.z, c.z, x, y, z);
        d[4 * i + 3] = dist2(a.w, b.w, c.w, x, y, z);
      }

      unsigned taken = 0u;
      float my_d = 0.0f;
      int my_s = 0;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        // this lane's smallest untaken (d2, slot); registers ascend in slot
        float bd = INFINITY;
        int bs = 0x7fffffff;
        int br = -1;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (!((taken >> r) & 1u) && (br < 0 || d[r] < bd)) {
            bd = d[r];
            bs = 128 * (r >> 2) + 4 * lane + (r & 3);
            br = r;
          }
        }
        float md = bd;
        int ms = bs;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float od = __shfl_xor_sync(0xffffffffu, md, off);
          const int os = __shfl_xor_sync(0xffffffffu, ms, off);
          if (od < md || (od == md && os < ms)) {
            md = od;
            ms = os;
          }
        }
        if (br >= 0 && bs == ms) taken |= 1u << br;  // slots are lane-unique
        if (lane == k) {
          my_d = md;
          my_s = ms;
        }
      }
      if (lane < K) {
        s_d2[j][lane] = my_d > 1e17f ? kBig : my_d;
        s_nn[0][lane][j] = __ldg(X + my_s);
        s_nn[1][lane][j] = __ldg(X + W + my_s);
        s_nn[2][lane][j] = __ldg(X + 2 * W + my_s);
      }
    }
  }
  __syncthreads();

  for (int t = threadIdx.x; t < kGroup * K; t += kThreads) {
    const int j = t / K, k = t % K;
    if (j < nq) d2_out[(q0 + j) * K + k] = s_d2[j][k];
  }
  for (int t = threadIdx.x; t < 3 * K * kGroup; t += kThreads) {
    const int r = t / kGroup, j = t % kGroup;
    if (j < nq) cand[(int64_t)r * Q + q0 + j] = s_nn[r / K][r % K][j];
  }
}

template <int K, int NV>
void launch(const float* table, int64_t rows, const int* bcell,
            const float* qx, const float* qy, const float* qz, int64_t Q,
            float* d2, float* cand, cudaStream_t stream) {
  const int64_t blocks = (Q + kGroup - 1) / kGroup;
  resident_fetch_kernel<K, NV><<<(unsigned)blocks, kThreads, 0, stream>>>(
      table, rows, bcell, qx, qy, qz, Q, d2, cand);
}

template <int K>
int launch_w(const float* table, int64_t rows, int W, const int* bcell,
             const float* qx, const float* qy, const float* qz, int64_t Q,
             float* d2, float* cand, cudaStream_t s) {
  switch (W) {
    case 128: launch<K, 1>(table, rows, bcell, qx, qy, qz, Q, d2, cand, s); break;
    case 256: launch<K, 2>(table, rows, bcell, qx, qy, qz, Q, d2, cand, s); break;
    case 384: launch<K, 3>(table, rows, bcell, qx, qy, qz, Q, d2, cand, s); break;
    case 512: launch<K, 4>(table, rows, bcell, qx, qy, qz, Q, d2, cand, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

extern "C" int fbpr_resident_fetch(const float* table, int64_t rows, int W,
                                   const int* bcell, const float* qx,
                                   const float* qy, const float* qz,
                                   int64_t Q, int K, float* d2, float* cand,
                                   void* stream) {
  if (Q <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int rc;
  switch (K) {
    case 6: rc = launch_w<6>(table, rows, W, bcell, qx, qy, qz, Q, d2, cand, s); break;
    case 8: rc = launch_w<8>(table, rows, W, bcell, qx, qy, qz, Q, d2, cand, s); break;
    case 16: rc = launch_w<16>(table, rows, W, bcell, qx, qy, qz, Q, d2, cand, s); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}
