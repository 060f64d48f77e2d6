// gn_step's tail (ops/solver.py) on warp 0, shared by rounds_gn.cu and
// exact_gn.cu (included after gn_tile.cuh; includes nothing of its own).
//
// step_warp: the symmetric eigen-solve of JtJ by cyclic Jacobi run to
// convergence (eigh_warp: a rotation is skipped where |a_pq| <= 1e-7
// sqrt(|a_pp a_qq|); the sweeps stop when one rotates nothing, or at
// kMaxSweeps), where the plain version calls torch.linalg.eigh; x = V
// diag(1 / lam_safe) V^T Jtb with lam_safe = lam where |lam| > 1e-9, else
// 1e-9; at the lane's iteration 0 (st[6] == 0) matP = V diag(lam >=
// eig_thresh) V^T and the degeneracy flag; x <- matP x when degenerate;
// pose += x when n_corr >= min_corr; converged when also |dR| <
// conv_rot_deg and |dt| < conv_trans_cm.  x and matP do not depend on the
// order or the signs of the eigenvectors, so the Jacobi stands for eigh
// within float noise.  Every lane of warp 0 holds all of A (no shuffle on
// the chain of dependent rotations); lane k < 6 holds row k of V.

#pragma once

namespace fbpr {
namespace {

constexpr int kMaxSweeps = 12;
constexpr float kJacobiTol = 1e-7f;
constexpr float kRadToDeg = 57.29577951308232f;

// Warp 0: eigen-solve of the symmetric JtJ (g: lane m < 28 holds G[m]).
// Returns the eigenvalues in lam (every lane) and V row-major in sV.
__device__ void eigh_warp(float g, int lane, float (&lam)[6], float* sV) {
  const int k = lane < 6 ? lane : 5;
  float A[6][6], V[6];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j) A[i][j] = g_at(g, i, j);
#pragma unroll
  for (int j = 0; j < 6; ++j) V[j] = k == j ? 1.0f : 0.0f;
  for (int sw = 0; sw < kMaxSweeps; ++sw) {
    bool rotated = false;
#pragma unroll
    for (int p = 0; p < 6; ++p)
#pragma unroll
      for (int q = p + 1; q < 6; ++q) {
        const float apq = A[p][q], app = A[p][p], aqq = A[q][q];
        if (!(fabsf(apq) > kJacobiTol * sqrtf(fabsf(app * aqq)))) continue;
        rotated = true;
        const float tau = (aqq - app) / (2.0f * apq);
        const float t = (tau >= 0.0f ? 1.0f : -1.0f) /
                        (fabsf(tau) + hypotf(1.0f, tau));
        const float c = 1.0f / sqrtf(1.0f + t * t);
        const float s = t * c;
#pragma unroll
        for (int r = 0; r < 6; ++r) {
          if (r == p || r == q) continue;
          const float arp = A[r][p], arq = A[r][q];
          A[r][p] = A[p][r] = c * arp - s * arq;
          A[r][q] = A[q][r] = s * arp + c * arq;
        }
        A[p][p] = app - t * apq;
        A[q][q] = aqq + t * apq;
        A[p][q] = A[q][p] = 0.0f;
        const float vkp = V[p], vkq = V[q];
        V[p] = c * vkp - s * vkq;
        V[q] = s * vkp + c * vkq;
      }
    if (!rotated) break;
  }
#pragma unroll
  for (int i = 0; i < 6; ++i) lam[i] = A[i][i];
  if (lane < 6) {
#pragma unroll
    for (int j = 0; j < 6; ++j) sV[lane * 6 + j] = V[j];
  }
  __syncwarp();
}

// Warp 0: gn_step's tail (ops/solver.py) for one lane.
__device__ void step_warp(float g, int lane, float* st, float* mp, float* sV,
                          int min_corr, float eig_thresh, float conv_rot_deg,
                          float conv_trans_cm) {
  const float n_corr = __shfl_sync(kFull, g, kG - 1);
  const bool enough = n_corr >= (float)min_corr;
  float lam[6];
  eigh_warp(g, lane, lam, sV);
  float b[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) b[i] = g_at(g, i, 6);
  const int i = lane < 6 ? lane : 5;

  // z = diag(1 / lam_safe) V^T Jtb on lane j = i, then x = V z on lane i
  float zi = 0.0f;
#pragma unroll
  for (int r = 0; r < 6; ++r) zi += sV[r * 6 + i] * b[r];
  float li = lam[0];
#pragma unroll
  for (int j = 1; j < 6; ++j) li = i == j ? lam[j] : li;
  zi = zi / (fabsf(li) > 1e-9f ? li : 1e-9f);
  float xi = 0.0f;
#pragma unroll
  for (int j = 0; j < 6; ++j)
    xi += sV[i * 6 + j] * __shfl_sync(kFull, zi, j);

  if (st[6] == 0.0f) {  // the lane's global iteration 0
    float isdeg = 0.0f;
    float good[6];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      good[j] = lam[j] >= eig_thresh ? 1.0f : 0.0f;
      isdeg = fmaxf(isdeg, 1.0f - good[j]);
    }
    for (int e = lane; e < 36; e += 32) {
      const int r = e / 6, c = e % 6;
      float pij = 0.0f;
#pragma unroll
      for (int j = 0; j < 6; ++j)
        pij += sV[r * 6 + j] * good[j] * sV[c * 6 + j];
      mp[e] = pij;
    }
    __syncwarp();
    if (lane == 0) st[8] = isdeg;
    __syncwarp();
  }
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
  float dr2 = 0.0f, dt2 = 0.0f;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float r = x[j] * kRadToDeg, t = x[3 + j] * 100.0f;
    dr2 += r * r;
    dt2 += t * t;
  }
  const bool conv = enough && sqrtf(dr2) < conv_rot_deg &&
                    sqrtf(dt2) < conv_trans_cm;
  __syncwarp();  // every lane has read st[6] and st[8]
  if (lane < 6 && enough) st[lane] = st[lane] + xi;
  if (lane == 0) {
    st[6] = st[6] + 1.0f;
    st[7] = conv ? 1.0f : 0.0f;
    st[10] = n_corr;
  }
  __syncwarp();
}

}  // namespace
}  // namespace fbpr
