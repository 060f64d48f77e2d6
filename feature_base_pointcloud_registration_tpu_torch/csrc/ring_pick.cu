// Greedy feature picking: one CTA runs the reference's serial pick loops for
// one (scan, ring) window.
//
// Stands for `_ring_pick` of the JAX package (ops/features.py), which is no
// Pallas kernel but one compiled device loop: each greedy pass a
// lax.while_loop of MIS rounds, the first-20 cap a lax.fori_loop, the six
// sector stages a lax.scan, all under jax.jit.  The JAX package rewrote the
// greedy as MIS rounds only because long sequential scans lower to costly
// loops on the TPU.  The port's plain version
// (ops/features.py::ring_pick_reference) runs the same rounds from the host,
// one sync a round.  A CTA runs the reference's own greedy
// (extractFeatures, ref: src/featureExtraction.h:178-294) in shared memory
// instead, so one launch picks every window of a batch with no host sync.
//
// Per window (W slots: curv, col, picked; six sectors sp..ep, sector_ok):
//   1. load curv, the column-gap breaks brk[i] = |col[i] - col[i-1]| > 10,
//      the marks (from picked) and zeroed labels into shared memory;
//   2. for each sector j with sector_ok[j], in order 0..5: pack the slots
//      sp..ep (clipped to the window) as 64-bit words (order-preserving bits
//      of the key, then the slot), the key being curv, or +inf at ep (the
//      reference's std::sort range excludes ep, ref :203 vs :208); -0.0
//      packs as +0.0, as the float comparisons of the plain version see
//      them.  A bitonic sort over the CTA's threads orders them ascending by
//      (key, slot), once a sector;
//   3. thread 0 walks the sorted list.  Corner pass: from its end
//      (descending key, the larger slot first on ties), take a slot that is
//      unmarked with curv > edge_threshold; the 21st such slot ends the pass
//      unmarked (ref :221).  Surf pass (strict only): from its start, take an
//      unmarked slot with curv < surf_threshold.  A pick marks itself and up
//      to 5 neighbours each way, a direction stopping at the first column
//      gap > 10 (ref :227-240) and at the window's ends.
// strict: marks carry across passes and sectors (the reference's serialized
// stream, suppression spilling into the next sector).  fast (strict = 0):
// the corner pass alone, suppression kept inside the sector, so every
// sector starts from `picked` (the port's and JAX's fast mode: one MIS with
// same-sector conflicts, then the first 20 picks a sector).
//
// Bound.  Bytes: each window's curv, col, picked, sector bounds read once
// and its labels written once (~10 B a slot).  The serial walk sets the
// floor, not the bytes: ~2 x 300 dependent shared-memory steps a sector on
// one thread, six sectors in a row.  A window is one CTA, so a batch of
// windows runs its walks side by side on the SMs.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCornerCap = 20;  // corner picks a sector (ref :221)
constexpr int kSuppress = 5;    // neighbours marked each way (ref :227-240)

__device__ __forceinline__ uint64_t sort_word(float key, int slot) {
  uint32_t u = __float_as_uint(key);
  if ((u << 1) == 0) u = 0;  // -0.0 sorts as +0.0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<uint64_t>(u) << 32) | static_cast<uint32_t>(slot);
}

// Mark slot i and its neighbours within [lo, hi], each direction stopping
// at the first column gap > 10.
__device__ __forceinline__ void suppress(uint8_t* marks, const uint8_t* brk,
                                         int i, int lo, int hi) {
  marks[i] = 1;
  for (int l = 1; l <= kSuppress; ++l) {
    int p = i + l;
    if (p > hi || brk[p]) break;
    marks[p] = 1;
  }
  for (int l = 1; l <= kSuppress; ++l) {
    int p = i - l;
    if (p < lo || brk[p + 1]) break;
    marks[p] = 1;
  }
}

__global__ void __launch_bounds__(kThreads)
ring_pick_kernel(const float* __restrict__ curv, const int* __restrict__ col,
                 const uint8_t* __restrict__ picked,
                 const int* __restrict__ sp, const int* __restrict__ ep,
                 const uint8_t* __restrict__ sector_ok, int W, int sort_cap,
                 float edge_threshold, float surf_threshold, int strict,
                 int8_t* __restrict__ label) {
  extern __shared__ __align__(8) unsigned char smem[];
  uint64_t* words = reinterpret_cast<uint64_t*>(smem);          // sort_cap
  float* s_curv = reinterpret_cast<float*>(words + sort_cap);   // W
  uint8_t* brk = reinterpret_cast<uint8_t*>(s_curv + W);        // W
  uint8_t* marks = brk + W;                                     // W
  int8_t* s_label = reinterpret_cast<int8_t*>(marks + W);       // W

  const int64_t base = static_cast<int64_t>(blockIdx.x) * W;
  const int tid = threadIdx.x;
  for (int i = tid; i < W; i += kThreads) {
    s_curv[i] = curv[base + i];
    int d = i > 0 ? col[base + i] - col[base + i - 1] : 0;
    brk[i] = (d > 10 || d < -10) ? 1 : 0;
    marks[i] = picked[base + i] ? 1 : 0;
    s_label[i] = 0;
  }
  __syncthreads();

  const int* sp_w = sp + static_cast<int64_t>(blockIdx.x) * 6;
  const int* ep_w = ep + static_cast<int64_t>(blockIdx.x) * 6;
  const uint8_t* ok_w = sector_ok + static_cast<int64_t>(blockIdx.x) * 6;
  for (int j = 0; j < 6; ++j) {
    const int e = ep_w[j];
    const int lo = max(sp_w[j], 0), hi = min(e, W - 1);
    if (!ok_w[j] || lo > hi) continue;  // uniform over the CTA
    const int n = hi - lo + 1;
    int N = 1;
    while (N < n) N <<= 1;
    for (int k = tid; k < N; k += kThreads) {
      const int s = lo + k;
      words[k] = k < n ? sort_word(s == e ? __int_as_float(0x7f800000)
                                          : s_curv[s], s)
                       : ~0ull;
    }
    __syncthreads();
    for (int size = 2; size <= N; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int i = tid; i < N; i += kThreads) {
          const int p = i ^ stride;
          if (p > i) {
            const uint64_t a = words[i], b = words[p];
            if ((a > b) == ((i & size) == 0)) {
              words[i] = b;
              words[p] = a;
            }
          }
        }
        __syncthreads();
      }
    }
    if (tid == 0) {
      const int slo = strict ? 0 : lo, shi = strict ? W - 1 : hi;
      int taken = 0;
      for (int k = n - 1; k >= 0; --k) {
        const int s = static_cast<int>(words[k] & 0xffffffffu);
        if (!marks[s] && s_curv[s] > edge_threshold) {
          if (++taken > kCornerCap) break;
          s_label[s] = 1;
          suppress(marks, brk, s, slo, shi);
        }
      }
      if (strict) {
        for (int k = 0; k < n; ++k) {
          const int s = static_cast<int>(words[k] & 0xffffffffu);
          if (!marks[s] && s_curv[s] < surf_threshold) {
            s_label[s] = -1;
            suppress(marks, brk, s, 0, W - 1);
          }
        }
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < W; i += kThreads) label[base + i] = s_label[i];
}

}  // namespace

// Dynamic shared memory of one CTA: the sort words (the next power of two
// >= W, so any sector inside the window fits), curv, brk, marks, labels.
static size_t ring_pick_smem(int W, int* sort_cap) {
  int cap = 1;
  while (cap < W) cap <<= 1;
  *sort_cap = cap;
  return static_cast<size_t>(cap) * 8 + static_cast<size_t>(W) * 7;
}

extern "C" int fbpr_ring_pick(const float* curv, const int* col,
                              const uint8_t* picked, const int* sp,
                              const int* ep, const uint8_t* sector_ok,
                              int64_t n_windows, int W, float edge_threshold,
                              float surf_threshold, int strict, int8_t* label,
                              void* stream) {
  if (n_windows <= 0 || W <= 0) return 0;
  int sort_cap = 0;
  const size_t smem = ring_pick_smem(W, &sort_cap);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ring_pick_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ring_pick_kernel<<<static_cast<unsigned>(n_windows), kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      curv, col, picked, sp, ep, sector_ok, W, sort_cap, edge_threshold,
      surf_threshold, strict, label);
  return static_cast<int>(cudaGetLastError());
}
