// Greedy feature picking: one CTA a (scan, ring) window, one warp a sector:
// the six sectors' candidate lists sorted at once, each list walked on a
// warp 32 candidates a step.
//
// Stands for `_ring_pick` of the JAX package (ops/features.py), which is no
// Pallas kernel but one compiled device loop: each greedy pass a
// lax.while_loop of MIS rounds, the first-20 cap a lax.fori_loop, the six
// sector stages a lax.scan, all under jax.jit.  The JAX package rewrote the
// greedy as MIS rounds only because long sequential scans lower to costly
// loops on the TPU.  The port's plain version
// (ops/features.py::ring_pick_reference) runs the same rounds from the host,
// one sync a round.  This kernel runs the reference's own greedy
// (extractFeatures, ref: src/featureExtraction.h:178-294) instead, so one
// launch picks every window of a batch with no host sync.
//
// The reference's greedy, per sector j in order 0..5 (slots sp..ep clipped
// to the window, sector_ok): sort the slots ascending by (key, slot), the
// key being curv, or +inf at ep (the reference's std::sort range excludes
// ep, ref :203 vs :208; -0.0 orders as +0.0, as the plain version's float
// comparisons see it).  Corner pass: from the list's end, take each
// unmarked slot with curv > edge_threshold; the 21st such slot ends the
// pass unmarked (ref :221), so the pass takes at most 20.  Surf pass
// (strict only): from its start, take each unmarked slot with curv <
// surf_threshold.  A pick marks itself and up to 5 neighbours each way, a
// direction stopping at the first column gap > 10 (ref :227-240) and at
// the clip: the window's ends in strict mode (the reference's serialized
// stream, marks carried across passes and sectors), the sector's ends in
// fast mode (strict = 0: the corner pass alone, every sector from
// `picked`; the port's and JAX's fast mode).
//
// Per window:
//   1. load: the column-gap breaks brk[i] = |col[i] - col[i-1]| > 10 as bits
//      (a ballot a 32-slot warp step), the marks from `picked` and zeroed
//      labels as bytes, in shared memory; kBatch steps' loads in flight
//      at once;
//   2. lists, warp j for sector j, all six at once: a pass's list holds only
//      the slots it can take (unmarked at the start and past its
//      threshold; the others it skips in the reference), compacted by
//      ballot as 64-bit sort words: order-preserving bits of the key, then
//      the slot and its marked run [p - back, p + fwd] = {q : |q - p| <= 5,
//      no break between q and p (equal gap-break prefix counts bcum), q
//      inside the clip}, read from the break bits around it (slot << 6 |
//      back << 3 | fwd, so that equal keys still order by slot).  Each list
//      is sorted by a bitonic network whose comparators all put the smaller
//      word at the lower index: up to 512 words in the warp's registers (R
//      = 1..16 a lane, lane-blocked, so that only stages of distance R and
//      more shuffle; 4 in fast mode, whose kernel keeps 40 registers for 8
//      CTAs an SM), a longer list in its slice of shared memory (__syncwarp
//      a stage; the virtual +inf padding to a power of two never moves, so
//      it is not stored);
//   3. walk, 32 candidates a step: lane l holds the step's l-th word (the
//      next step's is loaded before this step's picks) and tests its slot
//      (unmarked?).  The ballot of the live lanes gives the order: the
//      first set lane is the next pick (its run broadcast by one shuffle),
//      and every later lane inside its run is dropped (the reference would
//      find it marked); repeat until the ballot is empty or the corner cap
//      is reached.  The step's picks then store their labels and their
//      runs' marks (bytes, no atomics: all store 1), and __syncwarp before
//      the next step reads marks.  Strict: warp 0 walks the sectors in
//      order, corner pass then surf pass, since the marks chain; it walks
//      sector k once warp k has published its lists (a flag in shared
//      memory), so the other sectors' sorts run beside its walk.  Fast:
//      each sector's suppression stays inside it, so warp j walks sector j
//      right after sorting it, six walks side by side;
//   4. the labels, written once.
// Sectors whose clipped ranges overlap (no ring window has them) cannot
// share the list memory or the marks: then warp 0 builds and walks the
// sectors one after another, as the reference does.
//
// Bound.  Bytes: each window's col, picked and sector bounds read once,
// curv read once inside the sectors, the labels written once (~10 B a
// slot).  At B = 1 (strict) the walk on one warp sets the floor: ~55
// dependent steps and ~260 picks a VLP-16 window (a pick is a find-first,
// a shuffle and a ballot in turn), after sector 0's lists (mostly its surf
// list's sort); at B = 256 (fast) the windows' loads and compaction, side
// by side over the SMs.
//
// Built with -DFBPR_RING_PICK_PROFILE (chip_smoke.py's diagnostic build,
// never the shipped one), thread 0 of every CTA stamps clock64() around the
// load, the list building (in strict mode, its own and its waits for the
// other warps'), the corner and the surf walks (its own; in fast mode warp
// 0 walks sector 0 while the other warps walk theirs) and the tail
// (waiting for the other warps, the label write); lane 0 of each building
// warp stamps its compaction and its sorts; the sums go into g_prof, which
// fbpr_ring_pick_profile reads (clock_prof.cuh's PROF, global_ns and
// prof_read).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

#ifdef FBPR_RING_PICK_PROFILE
#define FBPR_PROF
#endif
#include "clock_prof.cuh"

// Sums over every CTA, clock64 on thread 0: [0] CTAs, [1] load, [2] lists
// (compaction and sort, or waiting for them), [3] corner walks, [4] surf
// walks, [5] tail, [6] the kernel's cycles, [7] its globaltimer ns; on lane
// 0 of each warp that builds a sector's lists: [8] sectors, [9] the
// compaction's cycles, [10] the sorts'.
PROF(__device__ unsigned long long g_prof[11];)

constexpr int kWarps = 6;                // one a sector
constexpr int kThreads = 32 * kWarps;
constexpr int kCornerCap = 20;           // corner picks a sector (ref :221)
constexpr int kSuppress = 5;             // neighbours marked each way
constexpr int kMaxRegs = 16;             // sort words a lane (512 a list)
constexpr int kMaxRegsFast = 4;          // in fast mode (128 a list)
constexpr int kBatch = 8;                // 32-slot loads in flight a warp
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint64_t sort_word(float key, int slot) {
  uint32_t u = __float_as_uint(key);
  if ((u << 1) == 0) u = 0;  // -0.0 sorts as +0.0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<uint64_t>(u) << 32) | static_cast<uint32_t>(slot);
}

__device__ __forceinline__ uint64_t umin64(uint64_t a, uint64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ uint64_t umax64(uint64_t a, uint64_t b) {
  return a < b ? b : a;
}

// A window's state in shared memory.
struct Window {
  const uint32_t* brk;  // column-gap breaks: bit i when |col[i]-col[i-1]|>10
  uint8_t* marks;       // suppressed or picked
  int8_t* lab;          // the labels: 1 corner, -1 surf pick
  int n_words;          // of brk
};

// The slots a pick at p marks: the run [p - back, p + fwd] of slots q with
// |q - p| <= 5, no break between q and p (equal bcum), inside [lo, hi]
// (the reference's suppress loops, ref :227-240), packed as the low 32
// bits of p's sort word: p << 6 | back << 3 | fwd.
__device__ __forceinline__ uint32_t marked_run(const Window& w, int p, int lo,
                                               int hi) {
  // break bits of slots p-4 .. p+5 (bit i = slot p-4+i; outside: none)
  const int a = p - (kSuppress - 1);
  const int wa = a >> 5;
  const uint32_t w0 = wa >= 0 ? w.brk[wa] : 0u;
  const uint32_t w1 = wa + 1 < w.n_words ? w.brk[wa + 1] : 0u;
  const uint32_t b = static_cast<uint32_t>(
      ((static_cast<uint64_t>(w1) << 32) | w0) >> (a & 31));
  const uint32_t back = b & 0x1fu;          // slots p-4 .. p
  const uint32_t fwd = (b >> 5) & 0x1fu;    // slots p+1 .. p+5
  int first = max(lo, p - kSuppress);
  if (back) first = max(first, a + 31 - __clz(back));  // the last break <= p
  int last = min(hi, p + kSuppress);
  if (fwd) last = min(last, p + __ffs(fwd) - 1);       // before the first > p
  return static_cast<uint32_t>(p) << 6 |
         static_cast<uint32_t>(p - first) << 3 |
         static_cast<uint32_t>(last - p);
}

// Sort list[0, m) ascending, m <= 32 R, in the warp's registers.  The
// sorted element e sits in lane e / R, register e % R (blocked, so that
// the network's stages below distance R stay in a lane and only the
// others shuffle; the unsorted input is read lane-striped, which shared
// memory serves without bank conflicts, since its order does not matter).
// Each stage pairs e with e ^ (k - 1) (the flip that merges two sorted
// halves of a k-block) or e ^ d (the half-cleaners), the lower index
// keeping the smaller word.  The stages run as loops, so that the code
// stays small enough for the instruction cache; one copy for each R.
template <int R, int M>
__device__ __forceinline__ void within_lane(uint64_t (&v)[R]) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int q = r ^ M;
    if (q <= r || q >= R) continue;
    const uint64_t x = v[r], y = v[q];
    v[r] = umin64(x, y);
    v[q] = umax64(x, y);
  }
}

// The pairs (r, r ^ mask) inside a lane, mask < R a constant of the stage.
template <int R>
__device__ __forceinline__ void within_lane(uint64_t (&v)[R], int mask) {
  switch (mask) {
    case 1: within_lane<R, 1>(v); break;
    case 2: within_lane<R, 2>(v); break;
    case 3: within_lane<R, 3>(v); break;
    case 4: within_lane<R, 4>(v); break;
    case 7: within_lane<R, 7>(v); break;
    case 8: within_lane<R, 8>(v); break;
    case 15: within_lane<R, 15>(v); break;
  }
}

// Lane pairs (lane, lane ^ mask); on a flip register r meets register
// R - 1 - r.
template <int R, bool kFlip>
__device__ __forceinline__ void across_lanes(uint64_t (&v)[R], int mask,
                                             bool low) {
#pragma unroll
  for (int r = 0; r < (kFlip ? (R + 1) / 2 : R); ++r) {
    const int q = kFlip ? R - 1 - r : r;
    const uint64_t xr = __shfl_xor_sync(kFull, v[q], mask);
    if (q != r) {
      const uint64_t xq = __shfl_xor_sync(kFull, v[r], mask);
      v[q] = low ? umin64(v[q], xq) : umax64(v[q], xq);
    }
    v[r] = low ? umin64(v[r], xr) : umax64(v[r], xr);
  }
}

template <int R>
__device__ __noinline__ void sort_regs(uint64_t* list, int m, int lane) {
  uint64_t v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = r * 32 + lane;
    v[r] = e < m ? list[e] : ~0ull;
  }
  for (int k = 2; k <= 32 * R; k <<= 1) {
    if (k > R)
      across_lanes<R, true>(v, k / R - 1, (lane & (k / (2 * R))) == 0);
    else
      within_lane(v, k - 1);
    for (int d = k >> 2; d >= 1; d >>= 1) {
      if (d >= R)
        across_lanes<R, false>(v, d / R, (lane & (d / R)) == 0);
      else
        within_lane(v, d);
    }
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int e = lane * R + r;
    if (e < m) list[e] = v[r];
  }
  __syncwarp();
}

// The same network on list[0, m) in shared memory, one warp, a __syncwarp a
// stage; comparators reaching past m meet the virtual +inf padding and are
// skipped.
__device__ __noinline__ void sort_shared(uint64_t* list, int m, int lane) {
  int logn = 0;
  while ((1 << logn) < m) ++logn;
  for (int lk = 1; lk <= logn; ++lk) {
    for (int ld = lk - 1; ld >= 0; --ld) {
      const bool flip = ld == lk - 1;
      for (int t = lane; t < (1 << (logn - 1)); t += 32) {
        const int blk = t >> ld, off = t & ((1 << ld) - 1);
        const int i = (blk << (ld + 1)) + off;
        const int p = flip ? (blk << (ld + 1)) + (2 << ld) - 1 - off
                           : i + (1 << ld);
        if (p < m) {
          const uint64_t a = list[i], b = list[p];
          if (b < a) {
            list[i] = b;
            list[p] = a;
          }
        }
      }
      __syncwarp();
    }
  }
}

// Sort list[0, m) on the warp: in registers up to 32 kMaxR words, R the
// least power of two that holds them; in shared memory above.
template <int kMaxR>
__device__ __forceinline__ void sort_list(uint64_t* list, int m, int lane) {
  if (m <= 1) return;
  if (m > 32 * kMaxR) {
    sort_shared(list, m, lane);
    return;
  }
  const int R = (m + 31) / 32;
  if (R == 1) sort_regs<1>(list, m, lane);
  else if (kMaxR >= 2 && R == 2) sort_regs<2>(list, m, lane);
  else if (kMaxR >= 4 && R <= 4) sort_regs<4>(list, m, lane);
  else if (kMaxR >= 8 && R <= 8) sort_regs<8>(list, m, lane);
  else if (kMaxR >= 16) sort_regs<16>(list, m, lane);
}

// One sector's sorted lists: the corner pass's (unmarked, curv > edge) at
// list[0, *mc) and, in strict mode, the surf pass's (unmarked, curv < surf)
// at list[n, n + *ms), n the sector's slots; each word's low half holds its
// slot's marked run inside [clo, chi] (marked_run).
template <bool kStrict>
__device__ __forceinline__ void build_lists(
    const Window& w, const float* __restrict__ curv, int lo, int hi, int e,
    int clo, int chi, float edge, float surf, uint64_t* list, int* mc,
    int* ms, int lane) {
  PROF(const long long t0 = clock64();)
  const int n = hi - lo + 1;
  int nc = 0, ns = 0;
  const unsigned below = (1u << lane) - 1;
  for (int s0 = lo; s0 <= hi; s0 += 32 * kBatch) {
    float c[kBatch];
    bool ok[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {  // the batch's loads first
      const int s = s0 + 32 * u + lane;
      ok[u] = s <= hi && !w.marks[s];
      c[u] = ok[u] ? __ldg(curv + s) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int s = s0 + 32 * u + lane;
      const bool qc = ok[u] && c[u] > edge;
      const bool qs = kStrict && ok[u] && c[u] < surf;
      uint64_t word = 0;
      if (qc || qs)
        word = sort_word(s == e ? __int_as_float(0x7f800000) : c[u],
                         marked_run(w, s, clo, chi));
      const unsigned bc = __ballot_sync(kFull, qc);
      const unsigned bs = __ballot_sync(kFull, qs);
      if (qc) list[nc + __popc(bc & below)] = word;
      if (qs) list[n + ns + __popc(bs & below)] = word;
      nc += __popc(bc);
      ns += __popc(bs);
    }
  }
  __syncwarp();
  PROF(const long long t1 = clock64();)
  sort_list<kStrict ? kMaxRegs : kMaxRegsFast>(list, nc, lane);
  if (kStrict) sort_list<kMaxRegs>(list + n, ns, lane);
  *mc = nc;
  *ms = ns;
#ifdef FBPR_RING_PICK_PROFILE
  if (lane == 0) {
    atomicAdd(&g_prof[8], 1ull);
    atomicAdd(&g_prof[9], static_cast<unsigned long long>(t1 - t0));
    atomicAdd(&g_prof[10], static_cast<unsigned long long>(clock64() - t1));
  }
#endif
}

// One pass over a sorted list of m candidates, 32 a step: the corner pass
// from its end (cap 20, label 1), the surf pass from its start (no cap,
// label -1).  A pick sets its label and marks its run.
template <bool kCorner>
__device__ __forceinline__ void walk(const Window& w, const uint64_t* list,
                                     int m, int lane) {
  int taken = 0;
  // the low half of the t-th candidate's word (slot and run, marked_run);
  // the next step's is loaded before this step's picks
  auto word = [&](int t) {
    return t < m ? static_cast<uint32_t>(list[kCorner ? m - 1 - t : t]) : 0u;
  };
  uint32_t next = word(lane);
  for (int t0 = 0; t0 < m && (!kCorner || taken < kCornerCap); t0 += 32) {
    const uint32_t run = next;
    next = word(t0 + 32 + lane);
    const int s = static_cast<int>(run >> 6);
    const int first = s - static_cast<int>((run >> 3) & 7u);
    const uint32_t span = ((run >> 3) & 7u) + (run & 7u);
    // what a pick of this lane broadcasts: its run, first << 4 | span
    const uint32_t mine = static_cast<uint32_t>(first) << 4 | span;
    unsigned todo = __ballot_sync(kFull, t0 + lane < m && !w.marks[s]);
    unsigned picks = 0;
    while (todo) {
      const int src = __ffs(todo) - 1;
      const uint32_t p = __shfl_sync(kFull, mine, src);
      picks |= 1u << src;
      if (kCorner && ++taken == kCornerCap) break;
      // drop the later lanes inside the pick's run (src included)
      todo &= ~__ballot_sync(kFull, static_cast<uint32_t>(
                                        s - static_cast<int>(p >> 4)) <=
                                        (p & 15u));
    }
    if ((picks >> lane) & 1u) {
      w.lab[s] = kCorner ? 1 : -1;
#pragma unroll
      for (int d = 0; d <= 2 * kSuppress; ++d)
        if (d <= static_cast<int>(span)) w.marks[first + d] = 1;
    }
    __syncwarp();
  }
}

// Fast mode keeps its lists in fewer registers (kMaxRegsFast), so that 8
// CTAs fit an SM: a batch of windows is bound by their loads.  Strict mode
// sorts up to 512 words in registers at 4 CTAs an SM.
template <bool kStrict>
__global__ void __launch_bounds__(kThreads, kStrict ? 4 : 8)
ring_pick_kernel(const float* __restrict__ curv, const int* __restrict__ col,
                 const uint8_t* __restrict__ picked,
                 const int* __restrict__ sp, const int* __restrict__ ep,
                 const uint8_t* __restrict__ sector_ok, int W, int n_words,
                 float edge_threshold, float surf_threshold,
                 int8_t* __restrict__ label) {
  extern __shared__ __align__(8) unsigned char smem[];
  // each sector clipped to the window: lo, hi, ep, active; its corner and
  // surf list lengths; whether its lists are sorted (strict)
  __shared__ int sec[6][4], sizes[6][2];
  __shared__ volatile int ready[6];
  constexpr int stride = kStrict ? 2 : 1;  // list words a slot
  uint64_t* words = reinterpret_cast<uint64_t*>(smem);  // stride * W
  uint32_t* brk = reinterpret_cast<uint32_t*>(words + stride * W);
  uint8_t* marks = reinterpret_cast<uint8_t*>(brk + n_words);
  int8_t* lab = reinterpret_cast<int8_t*>(marks + W);
  const Window w{brk, marks, lab, n_words};

  const int64_t base = static_cast<int64_t>(blockIdx.x) * W;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  PROF(const long long p0 = clock64(); const unsigned long long n0 =
           global_ns(); long long p_list = 0, p_corner = 0, p_surf = 0;)

  // 1. the break bits (32 slots a warp step, kBatch steps' loads at once),
  // the marks from `picked`, the labels zeroed; the sectors
  for (int c0 = warp * kBatch; c0 < n_words; c0 += kWarps * kBatch) {
    int d[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = (c0 + u) * 32 + lane;
      d[u] = i > 0 && i < W ? __ldg(col + base + i) - __ldg(col + base + i - 1)
                            : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const unsigned bb = __ballot_sync(kFull, d[u] > 10 || d[u] < -10);
      if (lane == 0 && c0 + u < n_words) brk[c0 + u] = bb;
    }
  }
  for (int i0 = tid; i0 < W; i0 += kThreads * kBatch) {
    uint8_t m[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      m[u] = i < W ? __ldg(picked + base + i) : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int i = i0 + u * kThreads;
      if (i < W) {
        marks[i] = m[u] != 0;
        lab[i] = 0;
      }
    }
  }
  if (tid < 6) {
    const int64_t j = static_cast<int64_t>(blockIdx.x) * 6 + tid;
    const int lo = max(sp[j], 0), hi = min(ep[j], W - 1);
    sec[tid][0] = lo;
    sec[tid][1] = hi;
    sec[tid][2] = ep[j];
    sec[tid][3] = sector_ok[j] && lo <= hi;
    ready[tid] = 0;
  }
  __syncthreads();
  PROF(const long long p1 = clock64(); const long long p_load = p1 - p0;)
  bool disjoint = true;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i + 1; j < 6; ++j)
      if (sec[i][3] && sec[j][3] && sec[i][0] <= sec[j][1] &&
          sec[j][0] <= sec[i][1])
        disjoint = false;

  // the marked runs clip to the window (strict) or to the sector (fast)
  if (disjoint) {
    // 2. the six sectors' lists at once, warp j for sector j
    const int lo = sec[warp][0], hi = sec[warp][1];
    uint64_t* list = words + stride * lo;
    int mc = 0, ms = 0;
    if (sec[warp][3])
      build_lists<kStrict>(w, curv + base, lo, hi, sec[warp][2], kStrict ? 0 : lo,
                           kStrict ? W - 1 : hi, edge_threshold,
                           surf_threshold, list, &mc, &ms, lane);
    if (!kStrict) {
      // 3. fast: suppression stays in the sector, so each warp walks its own
      PROF(const long long p2 = clock64(); p_list = p2 - p1;)
      if (sec[warp][3]) walk<true>(w, list, mc, lane);
      PROF(p_corner = clock64() - p2;)
    } else {
      // publish the lists; warp 0 walks sector k once they are sorted,
      // while the other warps still sort theirs
      if (lane == 0) {
        sizes[warp][0] = mc;
        sizes[warp][1] = ms;
      }
      __threadfence_block();
      __syncwarp();
      if (lane == 0) ready[warp] = 1;
      // 3. strict: warp 0 walks sector by sector, the marks chain
      if (warp == 0) {
        PROF(long long pt = clock64(); p_list = pt - p1;)
        for (int k = 0; k < 6; ++k) {
          if (!sec[k][3]) continue;
          if (lane == 0) {
            while (!ready[k]) __nanosleep(100);  // yield to the sorts
            __threadfence_block();
          }
          __syncwarp();
          PROF(const long long pw = clock64(); p_list += pw - pt;)
          const uint64_t* lk = words + 2 * sec[k][0];
          walk<true>(w, lk, sizes[k][0], lane);
          PROF(const long long pc = clock64(); p_corner += pc - pw;)
          walk<false>(w, lk + (sec[k][1] - sec[k][0] + 1), sizes[k][1], lane);
          PROF(pt = clock64(); p_surf += pt - pc;)
        }
      }
    }
  } else if (warp == 0) {
    // overlapping sectors: build and walk one after another, as the
    // reference does
    PROF(long long pt = clock64();)
    for (int k = 0; k < 6; ++k) {
      if (!sec[k][3]) continue;
      const int lo = sec[k][0], hi = sec[k][1];
      uint64_t* lk = words + stride * lo;
      int mc, ms;
      build_lists<kStrict>(w, curv + base, lo, hi, sec[k][2], kStrict ? 0 : lo,
                           kStrict ? W - 1 : hi, edge_threshold,
                           surf_threshold, lk, &mc, &ms, lane);
      PROF(long long pc = clock64(); p_list += pc - pt;)
      walk<true>(w, lk, mc, lane);
      PROF(pt = clock64(); p_corner += pt - pc; pc = pt;)
      if (kStrict) walk<false>(w, lk + (hi - lo + 1), ms, lane);
      PROF(pt = clock64(); p_surf += pt - pc;)
    }
  }
  __syncthreads();

  // 4. the labels, written once
  for (int i = tid; i < W; i += kThreads) label[base + i] = lab[i];
#ifdef FBPR_RING_PICK_PROFILE
  if (tid == 0) {
    const long long pe = clock64();
    atomicAdd(&g_prof[0], 1ull);
    atomicAdd(&g_prof[1], static_cast<unsigned long long>(p_load));
    atomicAdd(&g_prof[2], static_cast<unsigned long long>(p_list));
    atomicAdd(&g_prof[3], static_cast<unsigned long long>(p_corner));
    atomicAdd(&g_prof[4], static_cast<unsigned long long>(p_surf));
    atomicAdd(&g_prof[5], static_cast<unsigned long long>(
                              pe - p1 - p_list - p_corner - p_surf));
    atomicAdd(&g_prof[6], static_cast<unsigned long long>(pe - p0));
    atomicAdd(&g_prof[7], global_ns() - n0);
  }
#endif
}

}  // namespace

// Dynamic shared memory of one CTA: the list words (two a slot in strict
// mode, one in fast), the break bits (ceil(W / 32) words), the marks and
// the labels (a byte a slot each).
static size_t ring_pick_smem(int W, int strict, int* n_words) {
  *n_words = (W + 31) / 32;
  return static_cast<size_t>(W) * (8 * (strict ? 2 : 1) + 2) +
         static_cast<size_t>(*n_words) * 4;
}

template <bool kStrict>
static int launch(const float* curv, const int* col, const uint8_t* picked,
                  const int* sp, const int* ep, const uint8_t* sector_ok,
                  int64_t n_windows, int W, float edge_threshold,
                  float surf_threshold, int8_t* label, cudaStream_t stream) {
  int n_words = 0;
  const size_t smem = ring_pick_smem(W, kStrict, &n_words);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        ring_pick_kernel<kStrict>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ring_pick_kernel<kStrict><<<static_cast<unsigned>(n_windows), kThreads,
                              smem, stream>>>(
      curv, col, picked, sp, ep, sector_ok, W, n_words, edge_threshold,
      surf_threshold, label);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int fbpr_ring_pick(const float* curv, const int* col,
                              const uint8_t* picked, const int* sp,
                              const int* ep, const uint8_t* sector_ok,
                              int64_t n_windows, int W, float edge_threshold,
                              float surf_threshold, int strict, int8_t* label,
                              void* stream) {
  if (n_windows <= 0 || W <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return strict ? launch<true>(curv, col, picked, sp, ep, sector_ok,
                               n_windows, W, edge_threshold, surf_threshold,
                               label, st)
                : launch<false>(curv, col, picked, sp, ep, sector_ok,
                                n_windows, W, edge_threshold, surf_threshold,
                                label, st);
}

#ifdef FBPR_RING_PICK_PROFILE
// The diagnostic build's sums (g_prof, 11 values) into out; reset != 0
// zeroes them after.  Synchronous.
extern "C" int fbpr_ring_pick_profile(unsigned long long* out, int reset) {
  return prof_read(g_prof, out, reset);
}
#endif
