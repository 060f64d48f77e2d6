// The clock64 stamps of the kernels' diagnostic builds, in one place
// (rounds_gn.cu -DFBPR_ROUNDS_PROFILE, ring_pick.cu
// -DFBPR_RING_PICK_PROFILE, pose_graph_lm.cu and imu_chain_lm.cu through
// dense_lm.cuh's LmProf -DFBPR_LM_PROFILE, icp.cu -DFBPR_ICP_PROFILE;
// chip_smoke.py builds them, never the shipped library).
//
// A source defines FBPR_PROF when its own flag is set and includes this
// header inside its anonymous namespace (it includes nothing of its own):
//
//   PROF(...)       its arguments in a diagnostic build, nothing in a
//                   shipped one: the shipped build compiles every stamp
//                   away, so its code and its outputs are unchanged
//   global_ns()     the globaltimer, ns
//   StageClock<NS>  NS stage sums on thread 0 of a CTA: stamp(s) waits
//                   for the CTA (a barrier, so that the stamp is the
//                   slowest thread's) and adds the cycles since the last
//                   stamp to stage s; finish(sums, a, b) adds into the
//                   global sums [0] a, [1] b, [2 + s] stage s, [2 + NS]
//                   the CTA's cycles since start(), [3 + NS] its ns
//   prof_read       the host side of a source's *_profile entry point: its
//                   global sums into out, zeroed after if reset

#ifdef FBPR_PROF
#define PROF(...) __VA_ARGS__

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

template <int NS>
struct StageClock {
  long long c0, t, s[NS];
  unsigned long long n0;

  __device__ void start() {
    if (threadIdx.x != 0) return;
    n0 = global_ns();
    c0 = t = clock64();
    for (int i = 0; i < NS; ++i) s[i] = 0;
  }
  __device__ void stamp(int stage) {
    __syncthreads();
    if (threadIdx.x != 0) return;
    const long long now = clock64();
    s[stage] += now - t;
    t = now;
  }
  __device__ void finish(unsigned long long* sums, unsigned long long a,
                         unsigned long long b) {
    __syncthreads();
    if (threadIdx.x != 0) return;
    atomicAdd(&sums[0], a);
    atomicAdd(&sums[1], b);
    for (int i = 0; i < NS; ++i) {
      atomicAdd(&sums[2 + i], static_cast<unsigned long long>(s[i]));
    }
    atomicAdd(&sums[2 + NS], static_cast<unsigned long long>(clock64() - c0));
    atomicAdd(&sums[3 + NS], global_ns() - n0);
  }
};

// Synchronous.
template <int N>
inline int prof_read(unsigned long long (&sums)[N], unsigned long long* out,
                     int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, sums, N * sizeof(*out));
  if (e == cudaSuccess && reset) {
    const unsigned long long zero[N] = {};
    e = cudaMemcpyToSymbol(sums, zero, sizeof(zero));
  }
  return static_cast<int>(e);
}
#else
#define PROF(...)

template <int NS>
struct StageClock {
  __device__ void start() {}
  __device__ void stamp(int) {}
};
#endif
