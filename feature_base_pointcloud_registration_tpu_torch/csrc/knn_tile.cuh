// The exact streamed k-NN selection, shared by csrc/knn_stream.cu and
// csrc/icp.cu (included inside each source's anonymous namespace; includes
// nothing of its own).
//
// The function is ops/knn.py::knn_reference's, on its centred coordinates
// (the query centroid c subtracted from queries and map points alike):
//
//     d2(q, m) = (|q - c|^2 + |m - c|^2) - 2 (q - c) . (m - c)
//
// clamped at 0 (torch.clamp(min=0): NaN stays NaN, -0 becomes +0), 3e38 for
// a masked map point.  A candidate's key is (the float32 bits of d2 as a
// signed int, the map index), compared lexicographically: the plain
// version's int64 key (bits above column), so ties go to the lower index
// wherever the map is split (across a thread's tiles, warps or CTAs).  A
// thread visits its map points in increasing index, so inside one thread a
// strict `<` on the bits alone keeps that rule.
//
// The plain version's chunked merge equals one global selection except for
// the no-neighbour slots (ops/knn.py): with one chunk (M == chunk) a slot
// past the live points holds the lowest masked indices; with more, the
// running best starts at (3e38, 0) x k and wins every tie at 3e38, so such
// a slot holds (3e38, 0).  `no_neighbour_rule` applies the latter.

constexpr float kBig = 3.0e38f;
constexpr int kNoKey = 0x7fffffff;   // above every key of a real candidate
constexpr int kTile = 1024;          // map points staged in shared memory

__device__ __forceinline__ bool key_less(int ab, int ai, int bb, int bi) {
  return ab < bb || (ab == bb && ai < bi);
}

// torch.clamp(d, min=0): positive d kept, NaN kept, everything else +0
__device__ __forceinline__ float clamp0(float d) {
  return d > 0.0f ? d : (d != d ? d : 0.0f);
}

// (p * p).sum(-1) of a centred point, PyTorch's order
__device__ __forceinline__ float sq_norm(float x, float y, float z) {
  return x * x + y * y + z * z;
}

// Stage map points [lo, hi) of `map` (row-major [M, 3]) centred on c into
// `tile` (x, y, z, |m - c|^2; w = -1 for a masked point), thread t of
// nthreads taking points lo + t, lo + t + nthreads, ...  The caller
// synchronizes the block before and after.
__device__ __forceinline__ void stage_tile(const float* __restrict__ map,
                                           const uint8_t* __restrict__ mask,
                                           int lo, int hi, float cx,
                                           float cy, float cz, float4* tile,
                                           int t, int nthreads) {
  for (int j = lo + t; j < hi; j += nthreads) {
    const float x = map[3 * j] - cx;
    const float y = map[3 * j + 1] - cy;
    const float z = map[3 * j + 2] - cz;
    tile[j - lo] = make_float4(x, y, z, mask[j] ? sq_norm(x, y, z) : -1.0f);
  }
}

// The key bits of d2 between a centred query (qx, qy, qz, qn = |q - c|^2)
// and a staged point m.
__device__ __forceinline__ int d2_bits(float qx, float qy, float qz,
                                       float qn, float4 m) {
  if (m.w < 0.0f) return __float_as_int(kBig);
  const float cross = qx * m.x + qy * m.y + qz * m.z;
  return __float_as_int(clamp0((qn + m.w) - 2.0f * cross));
}

// A query's K smallest keys, ascending, in registers (K a compile-time
// constant so the arrays stay in registers).
template <int K>
struct TopK {
  int bits[K];
  int idx[K];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      bits[k] = kNoKey;
      idx[k] = kNoKey;
    }
  }

  // a candidate visited after every key already held (a higher index)
  __device__ __forceinline__ void push_in_order(int b, int j) {
    if (!(b < bits[K - 1])) return;
    bits[K - 1] = b;
    idx[K - 1] = j;
#pragma unroll
    for (int k = K - 1; k > 0; --k) {
      if (bits[k] < bits[k - 1]) {
        const int tb = bits[k], ti = idx[k];
        bits[k] = bits[k - 1];
        idx[k] = idx[k - 1];
        bits[k - 1] = tb;
        idx[k - 1] = ti;
      }
    }
  }

  // any candidate (from another split of the map)
  __device__ __forceinline__ void push(int b, int j) {
    if (!key_less(b, j, bits[K - 1], idx[K - 1])) return;
    bits[K - 1] = b;
    idx[K - 1] = j;
#pragma unroll
    for (int k = K - 1; k > 0; --k) {
      if (key_less(bits[k], idx[k], bits[k - 1], idx[k - 1])) {
        const int tb = bits[k], ti = idx[k];
        bits[k] = bits[k - 1];
        idx[k] = idx[k - 1];
        bits[k - 1] = tb;
        idx[k - 1] = ti;
      }
    }
  }
};

// More than one chunk: a slot at or past 3e38 is the running best's
// initial (3e38, 0).  One chunk: the global selection as it is.
__device__ __forceinline__ void no_neighbour_rule(bool one_chunk, int& bits,
                                                  int& idx) {
  if (!one_chunk && !(bits < __float_as_int(kBig))) {
    bits = __float_as_int(kBig);
    idx = 0;
  }
}
