// Per-point Gauss-Newton code shared by gn_round.cu, rounds_gn.cu and
// exact_gn.cu: one CTA of kThreads threads runs one lane's iterations, its
// threads striding over the lane's live points.
//
//   select5      5-of-K selection, ties by the lowest row;
//   corner_fit   the line fit on five selected rows (Cardano spectrum, line
//                gate, cross-product eigenvector, e_x fallback) and
//                point-to-line coefficients; corner_coef selects, then fits;
//   surf_fit     the 3-reflection Householder plane fit on five selected
//                rows, the 0.2 m plane check, the rank gate and the optional
//                min_plane_spread gate; surf_coef selects, then fits;
//   add_row      one point's Jacobian row J = [Jr, Jp, Jy, nx, ny, nz,
//                -resid, mask] added into the 28 sums of G = J J^T the solve
//                reads (JtJ upper 6x6, Jtb, n_corr); add_point loads a
//                point and its candidates, fits and adds its row;
//   reduce_scatter28  the fixed-order warp reduction of those sums;
//   compact_live the live-point list in shared memory;
//   next_frame   R, its three angle derivatives and t for the next
//                iteration.
//
// Two arithmetic modes, a template flag of the functions that differ:
//   kXla = false  the TPU kernel's (`_gn_round_kernel`, csrc/gn_round.cu):
//                 candidate d2 from the coordinates alone, the plane solve's
//                 pivots floored at +-1e-6 and its normal clipped to 1e6,
//                 coefficients multiplied by the mask;
//   kXla = true   the XLA body of `register_rounds_core`
//                 (ops/correspondence.py::corner_correspondence_cand and
//                 surf_correspondence_cand, csrc/rounds_gn.cu; exact_gn.cu
//                 calls its fits on the exact 5-NN, all five taken): a
//                 candidate whose fetched d2 is >= 1e37 (or NaN) is invalid
//                 and ranks at 3e38, the selection marks taken rows +inf so
//                 that five distinct rows are taken even among invalid
//                 ones, the pivots are floored at 1e-20 without a clip, a
//                 NaN plane residual fails the plane check, and a rejected
//                 point's coefficients are zeroed by selection (whatever
//                 they hold).

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace fbpr {
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

// 5-of-K selection: iterative min extraction, ties by the lowest row.  A
// taken row is marked kBig (kXla: +inf, above the 3e38 of invalid rows).
template <int K, bool kXla>
__device__ __forceinline__ unsigned select5(const float (&d2)[K],
                                            float& d5max) {
  const float kTaken = kXla ? INFINITY : kBig;
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
      if (i == idx) m[i] = kTaken;
  }
  d5max = -INFINITY;
#pragma unroll
  for (int i = 0; i < K; ++i)
    if ((sel >> i) & 1u) d5max = fmaxf(d5max, d2[i]);
  return sel;
}

// Candidate d2 at the world point; kXla: rows not in `valid` at 3e38.
template <int K, bool kXla>
__device__ __forceinline__ void cand_d2(float (&d2)[K], const float (&cx_)[K],
                                        const float (&cy_)[K],
                                        const float (&cz_)[K], unsigned valid,
                                        float xw, float yw, float zw) {
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const float dx = cx_[i] - xw, dy = cy_[i] - yw, dz = cz_[i] - zw;
    d2[i] = dx * dx + dy * dy + dz * dz;
    if constexpr (kXla)
      if (!((valid >> i) & 1u)) d2[i] = kBig;
  }
}

template <bool kXla>
__device__ __forceinline__ Coef masked(float s, float a, float b, float c,
                                       float r, float mask) {
  if constexpr (kXla) {
    if (mask > 0.0f) return {s * a, s * b, s * c, s * r, 1.0f};
    return {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  } else {
    return {s * a * mask, s * b * mask, s * c * mask, s * r * mask, mask};
  }
}

// The line fit on the rows `sel` of the K candidates (five of them), whose
// largest d2 is d5max, and the point-to-line coefficients.
template <int K, bool kXla>
__device__ __forceinline__ Coef corner_fit(const float (&cx_)[K],
                                           const float (&cy_)[K],
                                           const float (&cz_)[K],
                                           unsigned sel, float d5max,
                                           float fm, float xw, float yw,
                                           float zw) {
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
  return masked<kXla>(s, la, lb, lc, ld2, mask);
}

template <int K, bool kXla>
__device__ __forceinline__ Coef corner_coef(const float (&cx_)[K],
                                            const float (&cy_)[K],
                                            const float (&cz_)[K],
                                            unsigned valid, float fm,
                                            float xw, float yw, float zw) {
  float d2[K];
  cand_d2<K, kXla>(d2, cx_, cy_, cz_, valid, xw, yw, zw);
  float d5max;
  const unsigned sel = select5<K, kXla>(d2, d5max);
  return corner_fit<K, kXla>(cx_, cy_, cz_, sel, d5max, fm, xw, yw, zw);
}

__device__ __forceinline__ float safe_pivot(float d) {
  return fabsf(d) > 1e-6f ? d : (d >= 0.0f ? 1e-6f : -1e-6f);
}

template <bool kXla>
__device__ __forceinline__ float plane_pivot(float d) {
  if constexpr (kXla)
    return fabsf(d) > 1e-20f ? d : 1e-20f;
  else
    return safe_pivot(d);
}

// The plane fit on the rows `sel` of the K candidates (five of them), whose
// largest d2 is d5max, and the point-to-plane coefficients.
template <int K, bool kXla>
__device__ __forceinline__ Coef surf_fit(const float (&sx_)[K],
                                         const float (&sy_)[K],
                                         const float (&sz_)[K], unsigned sel,
                                         float d5max, float fm, float xw,
                                         float yw, float zw,
                                         float min_plane_spread) {
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
  float n2 = y[2] / plane_pivot<kXla>(r22);
  float n1 = (y[1] - r12 * n2) / plane_pivot<kXla>(r11);
  float n0 = (y[0] - r01 * n1 - r02 * n2) / plane_pivot<kXla>(r00);
  if constexpr (!kXla) {
    n0 = clampf(n0, -1e6f, 1e6f);
    n1 = clampf(n1, -1e6f, 1e6f);
    n2 = clampf(n2, -1e6f, 1e6f);
  }
  const bool ok_det = fabsf(r00 * r11 * r22) > 1e-5f;

  const float ps = sqrtf(n0 * n0 + n1 * n1 + n2 * n2);
  const bool ps_ok = ps > 1e-12f;
  const float pss = ps_ok ? ps : 1.0f;
  const float pa = n0 / pss, pb = n1 / pss, pc = n2 / pss, pd = 1.0f / pss;

  // all 5 selected neighbours within 0.2 m of the plane (ref :1182-1190)
  bool near_plane;
  if constexpr (kXla) {
    near_plane = true;
#pragma unroll
    for (int i = 0; i < K; ++i)
      if ((sel >> i) & 1u)
        near_plane = near_plane &&
                     fabsf(pa * sx_[i] + pb * sy_[i] + pc * sz_[i] + pd) <=
                         0.2f;
  } else {
    float bad = -INFINITY;
#pragma unroll
    for (int i = 0; i < K; ++i)
      if ((sel >> i) & 1u)
        bad = fmaxf(bad, fabsf(pa * sx_[i] + pb * sy_[i] + pc * sz_[i] + pd));
    near_plane = bad <= 0.2f;
  }
  const bool plane_ok = near_plane && ok_det && ps_ok;

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
  return masked<kXla>(s, pa, pb, pc, pd2, mask);
}

template <int K, bool kXla>
__device__ __forceinline__ Coef surf_coef(const float (&sx_)[K],
                                          const float (&sy_)[K],
                                          const float (&sz_)[K],
                                          unsigned valid, float fm, float xw,
                                          float yw, float zw,
                                          float min_plane_spread) {
  float d2[K];
  cand_d2<K, kXla>(d2, sx_, sy_, sz_, valid, xw, yw, zw);
  float d5max;
  const unsigned sel = select5<K, kXla>(d2, d5max);
  return surf_fit<K, kXla>(sx_, sy_, sz_, sel, d5max, fm, xw, yw, zw,
                           min_plane_spread);
}

// The Jacobian row J = [Jr, Jp, Jy, nx, ny, nz, -resid] of a point with
// coefficients c at lidar point f, added into the 28 sums (the last one
// mask^2, n_corr); `fr` is the frame in shared memory.
__device__ __forceinline__ void add_row(float (&acc)[32], const Coef& c,
                                        float fx, float fy, float fz,
                                        const volatile float* fr) {
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

// One point's 28 products J J^T added to acc: JtJ upper 6x6 (21), Jtb (6),
// n_corr (1); acc[28..31] stay 0 (the reduce-scatter's padding).  All of
// the point's loads are issued before any use (the mask too), so a thread
// waits for one round trip to memory a point.  `fr` is the frame in shared
// memory, read at each use (volatile) so that it is not held in 39
// registers across the point loop.  kXla: D2 is the fetch's d2 plane
// [K, plane] beside the candidates (unread otherwise).
template <int K, bool kSurf, bool kXla>
__device__ __forceinline__ void add_point(float (&acc)[32], const float* F,
                                          int P, const float* Cd,
                                          const float* D2, int64_t plane,
                                          int p, const volatile float* fr,
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
  unsigned valid = 0;
  if constexpr (kXla) {
#pragma unroll
    for (int i = 0; i < K; ++i)
      valid |= (D2[(int64_t)i * plane + p] < 1e37f ? 1u : 0u) << i;
  }
  const float xw = fr[0] * fx + fr[1] * fy + fr[2] * fz + fr[kT];
  const float yw = fr[3] * fx + fr[4] * fy + fr[5] * fz + fr[kT + 1];
  const float zw = fr[6] * fx + fr[7] * fy + fr[8] * fz + fr[kT + 2];
  Coef c;
  if constexpr (kSurf)
    c = surf_coef<K, kXla>(cx, cy, cz, valid, fm, xw, yw, zw,
                           min_plane_spread);
  else
    c = corner_coef<K, kXla>(cx, cy, cz, valid, fm, xw, yw, zw);
  add_row(acc, c, fx, fy, fz, fr);
}

// Reduce-scatter of a thread's 32 sums inside its warp: after the step of
// width h, slot i holds entry i + (the bits of lane above h), so lane m
// ends with the warp's sum of entry m in acc[0].
__device__ __forceinline__ void reduce_scatter28(float (&acc)[32], int lane) {
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
}

__device__ __forceinline__ int gidx(int i, int j) {  // i <= j < 7, i < 6
  return i * 7 - i * (i - 1) / 2 + (j - i);
}

// Entry (i, j) of the symmetric 6x6 JtJ (j < 6) or Jtb (j == 6) from the
// lane of warp 0 that holds it.
__device__ __forceinline__ float g_at(float g, int i, int j) {
  return __shfl_sync(kFull, g, j < 6 && j < i ? gidx(j, i) : gidx(i, j));
}

// Warp 0: whether the lane runs another iteration, and if so its frame
// (the sines and cosines on lanes 0..5, the entries on lane 0).  st is the
// lane's stat vector ([0:6] pose, [7] converged, [9] feature gate).
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

}  // namespace
}  // namespace fbpr
