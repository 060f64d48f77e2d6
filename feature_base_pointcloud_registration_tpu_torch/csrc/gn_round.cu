// Fused Gauss-Newton round: one CTA runs a whole solve round for one lane.
//
// Replaces the TPU kernel `_gn_round_kernel` behind `gn_round_pallas` (the
// JAX package's ops/pallas_gn.py; helpers `_jacobi6`, `_sym3_lam_max_mid`,
// `_corr_corner`, `_corr_surf`).  The plain
// version with the same arithmetic is ops/gn_round.py::gn_round_reference.
//
// Per lane (one scan), up to `iters` iterations while the lane is not
// converged and its feature gate holds (the per-lane early exit; lanes
// never wait on each other):
//   1. the point loops: the CTA's threads stride over the lane's live corner
//      points, then its live surf points (two loops, so the register peak
//      is the larger body's, not both).  Per point the 5-of-K selection,
//      the line fit (Cardano spectrum, line gate, cross-product
//      eigenvector) or the Householder plane fit, and the Jacobian row
//      J = [Jr, Jp, Jy, nx, ny, nz, -resid, mask], accumulated into the 28
//      entries of G = J J^T the solve reads (JtJ upper 6x6, Jtb, n_corr);
//   2. a fixed-order block reduction: a reduce-scatter of the 28 sums
//      inside each warp (lane m ends with entry m), then warp 0 adds the
//      warps' partial sums in warp order;
//   3. the tail on warp 0, spread over its lanes: at the lane's iteration 0
//      only the cyclic Jacobi (A on every lane, row k of V on lane k) for matP
//      and the degeneracy flag; the (JtJ + 1e-2 I) Gauss-Jordan solve (lane
//      i holds row i), the projection, the update when n_corr >= min_corr,
//      the convergence test (0.05 deg, 0.05 cm), and the next iteration's
//      frame (R and its three angle derivatives; the six sines and cosines
//      on six lanes).  Each element keeps the single-thread arithmetic and
//      order, so the tail's results depend on G alone.
// Two __syncthreads an iteration: the partial sums, then the new frame.
// The Pallas kernel's polynomial arccos (Mosaic has no acos) is acosf here.
//
// Live points only.  At the start of the round the CTA compacts the
// indices of its live points (mask != 0) into a uint16 list in dynamic
// shared memory (a warp-ballot prefix, in point order), and the point loops
// run over the list: no dead point is loaded, and the work is balanced
// whatever the mask's pattern.  Precondition: every candidate of a dead
// point is finite.  A dead point then adds exactly +-0 to each sum (every
// term carries its mask), so skipping it changes nothing; a NaN or inf
// candidate on a dead point would have reached G through 0 * NaN.  The
// port's fetch kernels give sentinel queries zeros.  Shapes with Pc + Ps >
// kMaxList run the same loops over all points, dead ones included.
//
// Bound.  The least work: the mask of every point and the xyz and
// candidates of each live point read once (4 bytes a point and 12 + 12K a
// live one; a dead point's are never read), and ~600 (corner) / ~900
// (surf) fp32 operations a live point and lane-iteration.  A design that
// re-reads every live point's candidates each iteration, as this one does,
// is floored at lane-iterations x live points x (16 + 12K) bytes over the
// memory rate (~125 MB an iteration of all lanes at the main path's round
// 1: more than the 50 MB L2).  Neither binds it: a point is ~1000
// dependent instructions, so the kernel is bound by issue and latency and
// needs many warps an SM to hide them.  At <= 128 registers a thread
// (__launch_bounds__(kThreads, 2), K <= 8) two lanes share an SM and all
// 256 lanes of the main path run in one wave; then the lanes that need the
// most iterations (the per-lane early exit), and at a lane's iteration 0
// the 90 dependent rotations of the Jacobi, set the round's time.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kStat = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kG = 28;  // JtJ upper (21) + Jtb (6) + n_corr (1)
constexpr int kMaxList = 20480;  // live-point list: 40 KB of uint16
constexpr unsigned kFull = 0xffffffffu;
constexpr float kBig = 3.0e38f;
constexpr float kPi = 3.14159265358979f;

// Frame in shared memory: R row-major [0, 9), dR/droll [9, 18), dR/dpitch
// [18, 27), dR/dyaw [27, 36), t [36, 39).
constexpr int kFrame = 40;
constexpr int kDr = 9;
constexpr int kT = 36;

struct Coef {
  float ca, cb, cc, resid, mask;
};

__device__ __forceinline__ float clampf(float x, float lo, float hi) {
  // NaN passes through, as jnp.clip / torch.clamp do
  return x < lo ? lo : (x > hi ? hi : x);
}

__device__ void lam_max_mid(float a00, float a01, float a02, float a11,
                            float a12, float a22, float& lmax, float& lmid) {
  const float q = (a00 + a11 + a22) / 3.0f;
  const float b00 = a00 - q, b11 = a11 - q, b22 = a22 - q;
  const float p2 = b00 * b00 + b11 * b11 + b22 * b22 +
                   2.0f * (a01 * a01 + a02 * a02 + a12 * a12);
  const float p6 = p2 / 6.0f;
  const float p = sqrtf(p6 > 0.0f ? p6 : 0.0f);
  const float ps = p > 1e-12f ? p : 1.0f;
  const float c00 = b11 * b22 - a12 * a12;
  const float c01 = a01 * b22 - a12 * a02;
  const float c02 = a01 * a12 - b11 * a02;
  const float det = b00 * c00 - a01 * c01 + a02 * c02;
  const float r = clampf(det / (2.0f * ps * ps * ps), -1.0f, 1.0f);
  const float phi = acosf(r) / 3.0f;
  const float l2 = q + 2.0f * p * cosf(phi);
  const float l0 = q + 2.0f * p * cosf(phi + 2.0f * kPi / 3.0f);
  const float l1 = 3.0f * q - l0 - l2;
  const bool near_diag = p <= 1e-12f;
  lmax = near_diag ? q : l2;
  lmid = near_diag ? q : l1;
}

// 5-of-K selection: iterative min extraction, ties by the lowest row.
template <int K>
__device__ __forceinline__ unsigned select5(const float (&d2)[K],
                                            float& d5max) {
  float m[K];
#pragma unroll
  for (int i = 0; i < K; ++i) m[i] = d2[i];
  unsigned sel = 0;
#pragma unroll
  for (int r = 0; r < 5; ++r) {
    float mn = m[0];
    int idx = 0;
#pragma unroll
    for (int i = 1; i < K; ++i) {
      if (m[i] < mn) {
        mn = m[i];
        idx = i;
      }
    }
    sel |= 1u << idx;
#pragma unroll
    for (int i = 0; i < K; ++i)
      if (i == idx) m[i] = kBig;
  }
  d5max = -INFINITY;
#pragma unroll
  for (int i = 0; i < K; ++i)
    if ((sel >> i) & 1u) d5max = fmaxf(d5max, d2[i]);
  return sel;
}

template <int K>
__device__ __forceinline__ Coef corner_coef(const float (&cx_)[K],
                                            const float (&cy_)[K],
                                            const float (&cz_)[K], float fm,
                                            float xw, float yw, float zw) {
  float d2[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const float dx = cx_[i] - xw, dy = cy_[i] - yw, dz = cz_[i] - zw;
    d2[i] = dx * dx + dy * dy + dz * dz;
  }
  float d5max;
  const unsigned sel = select5<K>(d2, d5max);
  const float gate_nn = fm * (d5max < 1.0f ? 1.0f : 0.0f);

  float sx = 0.f, sy = 0.f, sz = 0.f;
#pragma unroll
  for (int i = 0; i < K; ++i)
    if ((sel >> i) & 1u) {
      sx += cx_[i];
      sy += cy_[i];
      sz += cz_[i];
    }
  const float cx = sx / 5.0f, cy = sy / 5.0f, cz = sz / 5.0f;
  float a00 = 0.f, a01 = 0.f, a02 = 0.f, a11 = 0.f, a12 = 0.f, a22 = 0.f;
#pragma unroll
  for (int i = 0; i < K; ++i)
    if ((sel >> i) & 1u) {
      const float dx = cx_[i] - cx, dy = cy_[i] - cy, dz = cz_[i] - cz;
      a00 += dx * dx;
      a01 += dx * dy;
      a02 += dx * dz;
      a11 += dy * dy;
      a12 += dy * dz;
      a22 += dz * dz;
    }
  a00 /= 5.0f; a01 /= 5.0f; a02 /= 5.0f;
  a11 /= 5.0f; a12 /= 5.0f; a22 /= 5.0f;
  float lmax, lmid;
  lam_max_mid(a00, a01, a02, a11, a12, a22, lmax, lmid);
  const float gate_line = lmax > 3.0f * lmid ? 1.0f : 0.0f;

  // principal eigenvector: largest cross product of rows of (A - lam I)
  const float B00 = a00 - lmax, B11 = a11 - lmax, B22 = a22 - lmax;
  const float c01x = a01 * a12 - a02 * B11, c01y = a02 * a01 - B00 * a12,
              c01z = B00 * B11 - a01 * a01;
  const float c02x = a01 * B22 - a02 * a12, c02y = a02 * a02 - B00 * B22,
              c02z = B00 * a12 - a01 * a02;
  const float c12x = B11 * B22 - a12 * a12, c12y = a12 * a02 - a01 * B22,
              c12z = a01 * a12 - B11 * a02;
  const float n01 = c01x * c01x + c01y * c01y + c01z * c01z;
  const float n02 = c02x * c02x + c02y * c02y + c02z * c02z;
  const float n12 = c12x * c12x + c12y * c12y + c12z * c12z;
  const bool use01 = (n01 >= n02) && (n01 >= n12);
  const bool use02 = !use01 && (n02 >= n12);
  float vx = use01 ? c01x : (use02 ? c02x : c12x);
  float vy = use01 ? c01y : (use02 ? c02y : c12y);
  float vz = use01 ? c01z : (use02 ? c02z : c12z);
  const float nrm = sqrtf(vx * vx + vy * vy + vz * vz);
  if (nrm > 1e-20f) {
    const float inv = 1.0f / nrm;
    vx *= inv;
    vy *= inv;
    vz *= inv;
  } else {
    vx = 1.0f;
    vy = 0.0f;
    vz = 0.0f;
  }

  // point-to-line distance + gradient (ref :1083-1120)
  const float x1 = cx + 0.1f * vx, y1 = cy + 0.1f * vy, z1 = cz + 0.1f * vz;
  const float x2 = cx - 0.1f * vx, y2 = cy - 0.1f * vy, z2 = cz - 0.1f * vz;
  const float d01x = xw - x1, d01y = yw - y1, d01z = zw - z1;
  const float d02x = xw - x2, d02y = yw - y2, d02z = zw - z2;
  const float crx = d01x * d02y - d02x * d01y;
  const float cry = d01x * d02z - d02x * d01z;
  const float crz = d01y * d02z - d02y * d01z;
  const float a012 = sqrtf(crx * crx + cry * cry + crz * crz);
  const float d12x = x1 - x2, d12y = y1 - y2, d12z = z1 - z2;
  const float l12 = sqrtf(d12x * d12x + d12y * d12y + d12z * d12z);
  const float denom = a012 * l12;
  const float safe = denom > 1e-12f ? denom : 1.0f;
  const float la = (d12y * crx + d12z * cry) / safe;
  const float lb = -(d12x * crx - d12z * crz) / safe;
  const float lc = -(d12x * cry + d12y * crz) / safe;
  const float ld2 = a012 / (l12 > 1e-12f ? l12 : 1.0f);
  const float s = 1.0f - 0.9f * fabsf(ld2);
  const float mask = gate_nn * gate_line * (s > 0.1f ? 1.0f : 0.0f) *
                     (denom > 1e-12f ? 1.0f : 0.0f);
  return {s * la * mask, s * lb * mask, s * lc * mask, s * ld2 * mask, mask};
}

__device__ __forceinline__ float safe_pivot(float d) {
  return fabsf(d) > 1e-6f ? d : (d >= 0.0f ? 1e-6f : -1e-6f);
}

template <int K>
__device__ __forceinline__ Coef surf_coef(const float (&sx_)[K],
                                          const float (&sy_)[K],
                                          const float (&sz_)[K], float fm,
                                          float xw, float yw, float zw,
                                          float min_plane_spread) {
  float d2[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const float dx = sx_[i] - xw, dy = sy_[i] - yw, dz = sz_[i] - zw;
    d2[i] = dx * dx + dy * dy + dz * dz;
  }
  float d5max;
  const unsigned sel = select5<K>(d2, d5max);
  const float gate_nn = fm * (d5max < 1.0f ? 1.0f : 0.0f);

  // Householder least squares: argmin ||A n + sel|| over all K rows, with
  // unselected rows zero (A n = -1 on the selected rows)
  float C[3][K], y[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const float sl = ((sel >> i) & 1u) ? 1.0f : 0.0f;
    C[0][i] = sx_[i] * sl;
    C[1][i] = sy_[i] * sl;
    C[2][i] = sz_[i] * sl;
    y[i] = -sl;
  }
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    float v[K];
    float nx2 = 0.f;
#pragma unroll
    for (int i = 0; i < K; ++i) {
      v[i] = i >= j ? C[j][i] : 0.0f;
      nx2 += v[i] * v[i];
    }
    const float alpha = -(v[j] >= 0.0f ? 1.0f : -1.0f) * sqrtf(nx2);
    v[j] -= alpha;
    float vn2 = 0.f;
#pragma unroll
    for (int i = 0; i < K; ++i) vn2 += v[i] * v[i];
    const float inv = vn2 > 1e-30f ? 2.0f / vn2 : 0.0f;
#pragma unroll
    for (int c = j; c < 3; ++c) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < K; ++i) dot += v[i] * C[c][i];
      const float coef = inv * dot;
#pragma unroll
      for (int i = 0; i < K; ++i) C[c][i] -= coef * v[i];
    }
    float dot = 0.f;
#pragma unroll
    for (int i = 0; i < K; ++i) dot += v[i] * y[i];
    const float coefy = inv * dot;
#pragma unroll
    for (int i = 0; i < K; ++i) y[i] -= coefy * v[i];
  }
  const float r00 = C[0][0], r01 = C[1][0], r02 = C[2][0];
  const float r11 = C[1][1], r12 = C[2][1], r22 = C[2][2];
  float n2 = y[2] / safe_pivot(r22);
  float n1 = (y[1] - r12 * n2) / safe_pivot(r11);
  float n0 = (y[0] - r01 * n1 - r02 * n2) / safe_pivot(r00);
  n0 = clampf(n0, -1e6f, 1e6f);
  n1 = clampf(n1, -1e6f, 1e6f);
  n2 = clampf(n2, -1e6f, 1e6f);
  const bool ok_det = fabsf(r00 * r11 * r22) > 1e-5f;

  const float ps = sqrtf(n0 * n0 + n1 * n1 + n2 * n2);
  const bool ps_ok = ps > 1e-12f;
  const float pss = ps_ok ? ps : 1.0f;
  const float pa = n0 / pss, pb = n1 / pss, pc = n2 / pss, pd = 1.0f / pss;

  // all 5 selected neighbours within 0.2 m of the plane (ref :1182-1190)
  float bad = -INFINITY;
#pragma unroll
  for (int i = 0; i < K; ++i)
    if ((sel >> i) & 1u)
      bad = fmaxf(bad, fabsf(pa * sx_[i] + pb * sy_[i] + pc * sz_[i] + pd));
  const bool plane_ok = bad <= 0.2f && ok_det && ps_ok;

  const float pd2 = pa * xw + pb * yw + pc * zw + pd;
  const float sumsq = xw * xw + yw * yw + zw * zw;
  const float s =
      1.0f - 0.9f * fabsf(pd2) / sqrtf(sqrtf(fmaxf(sumsq, 1e-12f)));
  float mask = gate_nn * (plane_ok ? 1.0f : 0.0f) * (s > 0.1f ? 1.0f : 0.0f);
  if (min_plane_spread > 0.0f) {
    float mx = 0.f, my = 0.f, mz = 0.f;
#pragma unroll
    for (int i = 0; i < K; ++i)
      if ((sel >> i) & 1u) {
        mx += sx_[i];
        my += sy_[i];
        mz += sz_[i];
      }
    mx /= 5.0f; my /= 5.0f; mz /= 5.0f;
    float a00 = 0.f, a01 = 0.f, a02 = 0.f, a11 = 0.f, a12 = 0.f, a22 = 0.f;
#pragma unroll
    for (int i = 0; i < K; ++i)
      if ((sel >> i) & 1u) {
        const float dx = sx_[i] - mx, dy = sy_[i] - my, dz = sz_[i] - mz;
        a00 += dx * dx;
        a01 += dx * dy;
        a02 += dx * dz;
        a11 += dy * dy;
        a12 += dy * dz;
        a22 += dz * dz;
      }
    float lmax, lmid;
    lam_max_mid(a00 / 5.0f, a01 / 5.0f, a02 / 5.0f, a11 / 5.0f, a12 / 5.0f,
                a22 / 5.0f, lmax, lmid);
    mask *= sqrtf(fmaxf(lmid, 0.0f)) >= min_plane_spread ? 1.0f : 0.0f;
  }
  return {s * pa * mask, s * pb * mask, s * pc * mask, s * pd2 * mask, mask};
}

// One point's 28 products J J^T added to acc: JtJ upper 6x6 (21), Jtb (6),
// n_corr (1); acc[28..31] stay 0 (the reduce-scatter's padding).  All of
// the point's loads are issued before any use (the mask too), so a thread
// waits for one round trip to memory a point.  `fr` is the frame in shared
// memory, read at each use (volatile) so that it is not held in 39
// registers across the point loop.
template <int K, bool kSurf>
__device__ __forceinline__ void add_point(float (&acc)[32], const float* F,
                                          int P, const float* Cd,
                                          int64_t plane, int p,
                                          const volatile float* fr,
                                          float min_plane_spread) {
  const float fx = F[p], fy = F[P + p], fz = F[2 * P + p];
  const float fm = F[3 * P + p];
  float cx[K], cy[K], cz[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    cx[i] = Cd[(int64_t)i * plane + p];
    cy[i] = Cd[(int64_t)(K + i) * plane + p];
    cz[i] = Cd[(int64_t)(2 * K + i) * plane + p];
  }
  const float xw = fr[0] * fx + fr[1] * fy + fr[2] * fz + fr[kT];
  const float yw = fr[3] * fx + fr[4] * fy + fr[5] * fz + fr[kT + 1];
  const float zw = fr[6] * fx + fr[7] * fy + fr[8] * fz + fr[kT + 2];
  Coef c;
  if constexpr (kSurf)
    c = surf_coef<K>(cx, cy, cz, fm, xw, yw, zw, min_plane_spread);
  else
    c = corner_coef<K>(cx, cy, cz, fm, xw, yw, zw);
  float J[7];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const volatile float* d = fr + kDr + 9 * a;
    const float gx = d[0] * fx + d[1] * fy + d[2] * fz;
    const float gy = d[3] * fx + d[4] * fy + d[5] * fz;
    const float gz = d[6] * fx + d[7] * fy + d[8] * fz;
    J[a] = c.ca * gx + c.cb * gy + c.cc * gz;
  }
  J[3] = c.ca;
  J[4] = c.cb;
  J[5] = c.cc;
  J[6] = -c.resid;
  int m = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 7; ++j) acc[m++] += J[i] * J[j];
  acc[m] += c.mask * c.mask;
}

__device__ __forceinline__ int gidx(int i, int j) {  // i <= j < 7, i < 6
  return i * 7 - i * (i - 1) / 2 + (j - i);
}

// r[i] for a lane-dependent i, without indexing registers at run time
template <int N>
__device__ __forceinline__ float pick(const float (&r)[N], int i) {
  float v = r[0];
#pragma unroll
  for (int j = 1; j < N; ++j) v = i == j ? r[j] : v;
  return v;
}

// Entry (i, j) of the symmetric 6x6 JtJ (j < 6) or Jtb (j == 6) from the
// lane of warp 0 that holds it.
__device__ __forceinline__ float g_at(float g, int i, int j) {
  return __shfl_sync(kFull, g, j < 6 && j < i ? gidx(j, i) : gidx(i, j));
}

// Warp 0: cyclic Jacobi on the symmetric JtJ (the TPU kernel's _jacobi6)
// -> matP = V diag(lam >= eig_thresh) V^T and the degeneracy flag.  Every
// lane holds all of A and rotates it (no shuffle on the chain of 15 *
// jacobi_sweeps dependent rotations); lane k < 6 holds row k of V.
__device__ void jacobi_warp(float g, int lane, float* st, float* mp,
                            float* scratch, float eig_thresh,
                            int jacobi_sweeps) {
  const int k = lane < 6 ? lane : 5;
  float A[6][6], V[6];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) A[i][j] = g_at(g, i, j);
#pragma unroll
  for (int j = 0; j < 6; ++j) V[j] = k == j ? 1.0f : 0.0f;
  for (int sw = 0; sw < jacobi_sweeps; ++sw) {
#pragma unroll
    for (int p = 0; p < 6; ++p)
#pragma unroll
      for (int q = p + 1; q < 6; ++q) {
        const float apq = A[p][q], app = A[p][p], aqq = A[q][q];
        const bool small = fabsf(apq) < 1e-20f;
        const float tau = (aqq - app) / (2.0f * (small ? 1.0f : apq));
        const float sg = tau > 0.0f ? 1.0f : (tau < 0.0f ? -1.0f : tau);
        float t = sg / (fabsf(tau) + sqrtf(1.0f + tau * tau));
        if (tau == 0.0f) t = 1.0f;
        if (small) t = 0.0f;
        const float c = 1.0f / sqrtf(1.0f + t * t);
        const float s = t * c;
#pragma unroll
        for (int kk = 0; kk < 6; ++kk) {
          const float akp = A[kk][p], akq = A[kk][q];
          A[kk][p] = c * akp - s * akq;
          A[kk][q] = s * akp + c * akq;
        }
#pragma unroll
        for (int kk = 0; kk < 6; ++kk) {
          const float apk = A[p][kk], aqk = A[q][kk];
          A[p][kk] = c * apk - s * aqk;
          A[q][kk] = s * apk + c * aqk;
        }
        const float vkp = V[p], vkq = V[q];
        V[p] = c * vkp - s * vkq;
        V[q] = s * vkp + c * vkq;
      }
  }
  float* sV = scratch;  // V row-major [36]
  if (lane < 6) {
#pragma unroll
    for (int j = 0; j < 6; ++j) sV[lane * 6 + j] = V[j];
  }
  __syncwarp();
  float good[6];
  float isdeg = 0.0f;
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    good[i] = A[i][i] >= eig_thresh ? 1.0f : 0.0f;
    isdeg = fmaxf(isdeg, 1.0f - good[i]);
  }
  for (int e = lane; e < 36; e += 32) {
    const int i = e / 6, j = e % 6;
    float pij = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 6; ++kk)
      pij += sV[i * 6 + kk] * good[kk] * sV[j * 6 + kk];
    mp[e] = pij;
  }
  if (lane == 0) st[8] = isdeg;
  __syncwarp();
}

// Warp 0: the iteration's tail.  g: lane m < 28 holds G[m].  Jacobi at the
// lane's iteration 0, Gauss-Jordan (lane i < 6 holds row i of
// [JtJ + 1e-2 I | Jtb]), projection, update, convergence test.
__device__ void solve_warp(float g, int lane, float* st, float* mp,
                           float* scratch, int min_corr, float eig_thresh,
                           float conv_rot_deg, float conv_trans_cm,
                           int jacobi_sweeps) {
  const float n_corr = __shfl_sync(kFull, g, kG - 1);
  const bool enough = n_corr >= (float)min_corr;
  if (st[6] == 0.0f)
    jacobi_warp(g, lane, st, mp, scratch, eig_thresh, jacobi_sweeps);

  // (JtJ + 1e-2 I) x = Jtb, Gauss-Jordan without pivoting (SPD + Tikhonov
  // shift keeps every pivot >= 1e-2)
  const int i = lane < 6 ? lane : 5;
  float A[7];
#pragma unroll
  for (int j = 0; j < 7; ++j) A[j] = g_at(g, i, j) + (i == j ? 1e-2f : 0.0f);
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float Aj[7];
#pragma unroll
    for (int c = 0; c < 7; ++c) Aj[c] = __shfl_sync(kFull, A[c], j);
    const float piv = Aj[j];
    if (i != j) {
      const float f = A[j] / piv;
#pragma unroll
      for (int c = 0; c < 7; ++c) A[c] = A[c] - f * Aj[c];
    }
  }
  float xi = A[6] / pick(A, i);
  float x[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) x[j] = __shfl_sync(kFull, xi, j);
  if (st[8] > 0.0f) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < 6; ++j) acc += mp[i * 6 + j] * x[j];
    xi = acc;
#pragma unroll
    for (int j = 0; j < 6; ++j) x[j] = __shfl_sync(kFull, xi, j);
  }
  const float deg2 = (180.0f / kPi) * (180.0f / kPi);
  const float d_r = sqrtf((x[0] * x[0] + x[1] * x[1] + x[2] * x[2]) * deg2);
  const float d_t = sqrtf((x[3] * x[3] + x[4] * x[4] + x[5] * x[5]) * 1.0e4f);
  const bool conv = enough && d_r < conv_rot_deg && d_t < conv_trans_cm;
  const float ef = enough ? 1.0f : 0.0f;
  __syncwarp();  // every lane has read st[6] and st[8]
  if (lane < 6) st[lane] = st[lane] + ef * xi;
  if (lane == 0) {
    st[6] = st[6] + 1.0f;
    st[7] = conv ? 1.0f : 0.0f;
    st[10] = n_corr;
  }
  __syncwarp();
}

// Warp 0: whether the lane runs another iteration, and if so its frame
// (the sines and cosines on lanes 0..5, the entries on lane 0).
__device__ void next_frame(const float* st, int lane, bool more,
                           float* fr, int* active) {
  const bool act = more && st[7] == 0.0f && st[9] > 0.0f;
  if (lane == 0) *active = act;
  if (!act) return;
  const float a = st[lane < 6 ? lane % 3 : 0];
  const float sc = lane < 3 ? sinf(a) : cosf(a);
  const float sr = __shfl_sync(kFull, sc, 0), cr = __shfl_sync(kFull, sc, 3);
  const float sp = __shfl_sync(kFull, sc, 1), cp = __shfl_sync(kFull, sc, 4);
  const float sy = __shfl_sync(kFull, sc, 2), cy = __shfl_sync(kFull, sc, 5);
  if (lane != 0) return;
  float* r = fr;
  r[0] = cy * cp;
  r[1] = cy * sp * sr - sy * cr;
  r[2] = cy * sp * cr + sy * sr;
  r[3] = sy * cp;
  r[4] = sy * sp * sr + cy * cr;
  r[5] = sy * sp * cr - cy * sr;
  r[6] = -sp;
  r[7] = cp * sr;
  r[8] = cp * cr;
  float* d = fr + kDr;  // dR/droll
  d[0] = 0.0f;
  d[1] = cy * sp * cr + sy * sr;
  d[2] = -cy * sp * sr + sy * cr;
  d[3] = 0.0f;
  d[4] = sy * sp * cr - cy * sr;
  d[5] = -sy * sp * sr - cy * cr;
  d[6] = 0.0f;
  d[7] = cp * cr;
  d[8] = -cp * sr;
  d += 9;  // dR/dpitch
  d[0] = -cy * sp;
  d[1] = cy * cp * sr;
  d[2] = cy * cp * cr;
  d[3] = -sy * sp;
  d[4] = sy * cp * sr;
  d[5] = sy * cp * cr;
  d[6] = -cp;
  d[7] = -sp * sr;
  d[8] = -sp * cr;
  d += 9;  // dR/dyaw
  d[0] = -sy * cp;
  d[1] = -sy * sp * sr - cy * cr;
  d[2] = -sy * sp * cr + cy * sr;
  d[3] = cy * cp;
  d[4] = cy * sp * sr - sy * cr;
  d[5] = cy * sp * cr + sy * sr;
  d[6] = 0.0f;
  d[7] = 0.0f;
  d[8] = 0.0f;
#pragma unroll
  for (int e = 0; e < 3; ++e) fr[kT + e] = st[3 + e];
}

// Compacts the indices of the live points (mask row F[3P..4P) != 0) of one
// feature kind into list[0..n) in point order; returns n.  Each warp
// counts, then writes, one contiguous span; all threads must call it.
__device__ int compact_live(const float* F, int P, uint16_t* list,
                            int* s_cnt, int warp, int lane) {
  const int span = ((P + kThreads - 1) / kThreads) * 32;
  const int lo = warp * span, hi = min(lo + span, P);
  int cnt = 0;
  for (int base = lo; base < hi; base += 32) {
    const int p = base + lane;
    cnt += __popc(__ballot_sync(kFull, p < hi && F[3 * P + p] != 0.0f));
  }
  if (lane == 0) s_cnt[warp] = cnt;
  __syncthreads();
  int off = 0, n = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    off += w < warp ? s_cnt[w] : 0;
    n += s_cnt[w];
  }
  for (int base = lo; base < hi; base += 32) {
    const int p = base + lane;
    const bool live = p < hi && F[3 * P + p] != 0.0f;
    const unsigned b = __ballot_sync(kFull, live);
    if (live) list[off + __popc(b & ((1u << lane) - 1u))] = (uint16_t)p;
    off += __popc(b);
  }
  __syncthreads();  // s_cnt is reused
  return n;
}

// Two CTAs an SM up to K=8; K=16 does not fit 128 registers a thread and
// takes one CTA an SM without spills.
template <int K>
__global__ void __launch_bounds__(kThreads, K > 8 ? 1 : 2)
gn_round_kernel(float* __restrict__ stat, float* __restrict__ matP,
                const float* __restrict__ featc,
                const float* __restrict__ feats,
                const float* __restrict__ candc,
                const float* __restrict__ cands, int B, int Pc, int Ps,
                int iters, int min_corr, float eig_thresh, float conv_rot_deg,
                float conv_trans_cm, int jacobi_sweeps,
                float min_plane_spread, bool use_list) {
  extern __shared__ uint16_t s_list[];  // live corner, then surf, indices
  __shared__ float s_st[kStat];
  __shared__ float s_mp[36];
  __shared__ float s_fr[kFrame];
  __shared__ float s_red[kWarps][kG];
  __shared__ float s_scratch[36];
  __shared__ int s_cnt[kWarps];
  __shared__ int s_active;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* fc = featc + (int64_t)b * 4 * Pc;
  const float* fs = feats + (int64_t)b * 4 * Ps;
  const int64_t qc = (int64_t)B * Pc, qs = (int64_t)B * Ps;
  const float* cc = candc + (int64_t)b * Pc;
  const float* cs = cands + (int64_t)b * Ps;

  if (tid < kStat) s_st[tid] = stat[(int64_t)b * kStat + tid];
  if (tid < 36) s_mp[tid] = matP[(int64_t)b * 36 + tid];
  int nc = Pc, ns = Ps;
  if (use_list) {
    nc = compact_live(fc, Pc, s_list, s_cnt, warp, lane);
    ns = compact_live(fs, Ps, s_list + nc, s_cnt, warp, lane);
  } else {
    __syncthreads();
  }
  if (warp == 0) next_frame(s_st, lane, iters > 0, s_fr, &s_active);
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
    if (!s_active) break;

    float acc[32];
#pragma unroll
    for (int m = 0; m < 32; ++m) acc[m] = 0.0f;
    int c = tid;
    for (; c < nc; c += kThreads)
      add_point<K, false>(acc, fc, Pc, cc, qc, use_list ? s_list[c] : c,
                          s_fr, min_plane_spread);
    for (; c < nc + ns; c += kThreads) {
      const int p = use_list ? s_list[c] : c - nc;
      add_point<K, true>(acc, fs, Ps, cs, qs, p, s_fr, min_plane_spread);
    }

    // reduce-scatter inside the warp: after the step of width h, slot i
    // holds entry i + (the bits of lane above h), so lane m ends with m
#pragma unroll
    for (int h = 16; h >= 1; h >>= 1) {
      const bool upper = lane & h;
#pragma unroll
      for (int i = 0; i < h; ++i) {
        const float send = upper ? acc[i] : acc[i + h];
        const float keep = upper ? acc[i + h] : acc[i];
        acc[i] = keep + __shfl_xor_sync(kFull, send, h);
      }
    }
    if (lane < kG) s_red[warp][lane] = acc[0];
    __syncthreads();
    if (warp == 0) {
      float g = 0.0f;
      if (lane < kG)
        for (int w = 0; w < kWarps; ++w) g += s_red[w][lane];
      solve_warp(g, lane, s_st, s_mp, s_scratch, min_corr, eig_thresh,
                 conv_rot_deg, conv_trans_cm, jacobi_sweeps);
      next_frame(s_st, lane, it + 1 < iters, s_fr, &s_active);
    }
    __syncthreads();
  }
  if (tid < kStat) stat[(int64_t)b * kStat + tid] = s_st[tid];
  if (tid < 36) matP[(int64_t)b * 36 + tid] = s_mp[tid];
}

template <int K>
void launch(float* stat, float* matP, const float* featc, const float* feats,
            const float* candc, const float* cands, int B, int Pc, int Ps,
            int iters, int min_corr, float eig_thresh, float conv_rot_deg,
            float conv_trans_cm, int jacobi_sweeps, float min_plane_spread,
            cudaStream_t stream) {
  const bool use_list = (int64_t)Pc + Ps <= kMaxList;
  const size_t smem = use_list ? sizeof(uint16_t) * (Pc + Ps) : 0;
  gn_round_kernel<K><<<B, kThreads, smem, stream>>>(
      stat, matP, featc, feats, candc, cands, B, Pc, Ps, iters, min_corr,
      eig_thresh, conv_rot_deg, conv_trans_cm, jacobi_sweeps,
      min_plane_spread, use_list);
}

}  // namespace

extern "C" int fbpr_gn_round(float* stat, float* matP, const float* featc,
                             const float* feats, const float* candc,
                             const float* cands, int B, int Pc, int Ps, int K,
                             int iters, int min_corr, float eig_thresh,
                             float conv_rot_deg, float conv_trans_cm,
                             int jacobi_sweeps, float min_plane_spread,
                             void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FBPR_GN_CASE(KK)                                                   \
  case KK:                                                                 \
    launch<KK>(stat, matP, featc, feats, candc, cands, B, Pc, Ps, iters,   \
               min_corr, eig_thresh, conv_rot_deg, conv_trans_cm,          \
               jacobi_sweeps, min_plane_spread, s);                        \
    break;
  switch (K) {
    FBPR_GN_CASE(6)
    FBPR_GN_CASE(8)
    FBPR_GN_CASE(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FBPR_GN_CASE
  return (int)cudaGetLastError();
}
