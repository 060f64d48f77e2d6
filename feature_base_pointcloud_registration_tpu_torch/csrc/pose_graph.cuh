// The pose graph's factors on forward-mode dual numbers: the residuals of
// graph/pose_graph.py (the port's plain version and the JAX package's
// `_prior_res`, `_btw_res`, `_gps_res`), templated on a scalar that is a
// float (the residual alone) or a Dual (value, tangent).
//
// A Jacobian column is one evaluation with one unit tangent seeded on the
// differentiated pose, as `jax.jacfwd` and the plain version's
// `torch.autograd.forward_ad` compute it.  Each operation below is the
// plain version's operation, in its order, with PyTorch's forward-mode
// rule for it (which is JAX's here):
//   a * b        tangent b.t * a.v + a.t * b.v
//   a / b        (a.t - b.t * (a / b)) / b.v
//   cos, sin     t * -sin(v), t * cos(v)
//   atan2(y, x)  (-y.v * x.t + x.v * y.t) / (y.v * y.v + x.v * x.v)
//   asin, acos   t * rsqrt(-v * v + 1), t * -rsqrt(-v * v + 1)
//   sqrt         t / (2 * sqrt(v))
//   clamp        t where lo <= v <= hi (the boundary included), else 0;
//                the value NaN where v is NaN
//   sign         tangent 0
//   where        both parts from the branch it selects
// so the edge cases come out as they do there: acos'(1) is infinite, but
// so3_log's small-angle branch never reads theta's tangent; near pi about a
// coordinate axis sqrt(0) gives the same infinite or NaN entries; a
// gimbal-locked between factor the same non-finite rows.  The primal is
// the same float arithmetic in both instantiations, so a Jacobian thread's
// residual is the residual thread's.  Build without FMA contraction
// (kernels.SOURCE_FLAGS): the plain version's operations round one by one.
//
// Include once per translation unit, inside an anonymous namespace.

struct Dual {
  float v, t;
};

__device__ __forceinline__ float val(float a) { return a; }
__device__ __forceinline__ float val(const Dual& a) { return a.v; }
template <typename T> __device__ __forceinline__ T lift(float v);
template <> __device__ __forceinline__ float lift<float>(float v) { return v; }
template <> __device__ __forceinline__ Dual lift<Dual>(float v) {
  return {v, 0.0f};
}

__device__ __forceinline__ Dual operator+(Dual a, Dual b) {
  return {a.v + b.v, a.t + b.t};
}
__device__ __forceinline__ Dual operator-(Dual a, Dual b) {
  return {a.v - b.v, a.t - b.t};
}
__device__ __forceinline__ Dual operator-(Dual a) { return {-a.v, -a.t}; }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return {a.v * b.v, b.t * a.v + a.t * b.v};
}
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  const float r = a.v / b.v;
  return {r, (a.t - b.t * r) / b.v};
}
// a Python scalar on the other side: no tangent of its own
__device__ __forceinline__ Dual operator*(Dual a, float s) {
  return {a.v * s, a.t * s};
}
__device__ __forceinline__ Dual operator+(Dual a, float s) {
  return {a.v + s, a.t};
}
__device__ __forceinline__ Dual operator-(Dual a, float s) {
  return {a.v - s, a.t};
}
__device__ __forceinline__ Dual operator-(float s, Dual a) {
  return {s - a.v, -a.t};
}

__device__ __forceinline__ float cos_(float a) { return cosf(a); }
__device__ __forceinline__ Dual cos_(Dual a) {
  return {cosf(a.v), a.t * -sinf(a.v)};
}
__device__ __forceinline__ float sin_(float a) { return sinf(a); }
__device__ __forceinline__ Dual sin_(Dual a) {
  return {sinf(a.v), a.t * cosf(a.v)};
}
__device__ __forceinline__ float atan2_(float y, float x) {
  return atan2f(y, x);
}
__device__ __forceinline__ Dual atan2_(Dual y, Dual x) {
  return {atan2f(y.v, x.v),
          ((-y.v) * x.t + x.v * y.t) / (y.v * y.v + x.v * x.v)};
}
__device__ __forceinline__ float asin_(float a) { return asinf(a); }
__device__ __forceinline__ Dual asin_(Dual a) {
  return {asinf(a.v), a.t * rsqrtf((-a.v) * a.v + 1.0f)};
}
__device__ __forceinline__ float acos_(float a) { return acosf(a); }
__device__ __forceinline__ Dual acos_(Dual a) {
  return {acosf(a.v), a.t * -rsqrtf((-a.v) * a.v + 1.0f)};
}
__device__ __forceinline__ float sqrt_(float a) { return sqrtf(a); }
__device__ __forceinline__ Dual sqrt_(Dual a) {
  const float r = sqrtf(a.v);
  return {r, a.t / (2.0f * r)};
}
// torch.clamp: NaN stays NaN; the tangent passes on [lo, hi]
__device__ __forceinline__ float clampv(float v, float lo, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, lo), hi);
}
__device__ __forceinline__ float clamp_(float a, float lo, float hi) {
  return clampv(a, lo, hi);
}
__device__ __forceinline__ Dual clamp_(Dual a, float lo, float hi) {
  return {clampv(a.v, lo, hi), (a.v >= lo && a.v <= hi) ? a.t : 0.0f};
}
__device__ __forceinline__ float clamp_min_(float a, float lo) {
  return isnan(a) ? a : fmaxf(a, lo);
}
__device__ __forceinline__ Dual clamp_min_(Dual a, float lo) {
  return {clamp_min_(a.v, lo), a.v >= lo ? a.t : 0.0f};
}
// torch.sign: (0 < v) - (v < 0), 0 at NaN
__device__ __forceinline__ float signv(float v) {
  return static_cast<float>((0.0f < v) - (v < 0.0f));
}
__device__ __forceinline__ float sign_(float a) { return signv(a); }
__device__ __forceinline__ Dual sign_(Dual a) { return {signv(a.v), 0.0f}; }
template <typename T>
__device__ __forceinline__ T where_(bool c, T a, T b) { return c ? a : b; }

// R = Rz(yaw) Ry(pitch) Rx(roll), row-major (geom/se3.py::euler_to_rot)
template <typename T>
__device__ __forceinline__ void euler_to_rot(T roll, T pitch, T yaw,
                                             T R[9]) {
  const T cr = cos_(roll), sr = sin_(roll);
  const T cp = cos_(pitch), sp = sin_(pitch);
  const T cy = cos_(yaw), sy = sin_(yaw);
  R[0] = cy * cp;
  R[1] = cy * sp * sr - sy * cr;
  R[2] = cy * sp * cr + sy * sr;
  R[3] = sy * cp;
  R[4] = sy * sp * sr + cy * cr;
  R[5] = sy * sp * cr - cy * sr;
  R[6] = -sp;
  R[7] = cp * sr;
  R[8] = cp * cr;
}

// C = A^T B of 3x3 row-major matrices (the plain version's transpose, then
// a batched matmul summed over k in order)
template <typename T>
__device__ __forceinline__ void mat_tmul(const T A[9], const T B[9],
                                         T C[9]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[i * 3 + j] = A[0 * 3 + i] * B[0 * 3 + j] + A[1 * 3 + i] * B[1 * 3 + j]
                     + A[2 * 3 + i] * B[2 * 3 + j];
}

// y = A^T x
template <typename T>
__device__ __forceinline__ void mat_tvec(const T A[9], const T x[3],
                                         T y[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    y[i] = A[0 * 3 + i] * x[0] + A[1 * 3 + i] * x[1] + A[2 * 3 + i] * x[2];
}

// geom/se3.py::so3_log: the axis-angle of R; near theta = pi the axis comes
// from the diagonal
template <typename T>
__device__ __forceinline__ void so3_log(const T R[9], T w[3]) {
  const T trace = R[0] + R[4] + R[8];
  const T cos_t = clamp_((trace - 1.0f) * 0.5f, -1.0f, 1.0f);
  const T theta = acos_(cos_t);
  const T v[3] = {R[7] - R[5], R[2] - R[6], R[3] - R[1]};
  const bool small = val(theta) < 1e-6f;
  const T sin2 = where_(small, lift<T>(1.0f), sin_(theta) * 2.0f);
  const T scale = where_(small, lift<T>(0.5f), theta / sin2);
  const bool near_pi = val(theta) > 3.0f;
  const T den = (1.0f - cos_t) + 1e-12f;
  const T diag[3] = {R[0], R[4], R[8]};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const T axis2 = clamp_min_((diag[i] - cos_t) / den, 0.0f);
    const T w_pi = sqrt_(axis2) * sign_(v[i] + 1e-20f) * theta;
    w[i] = where_(near_pi, w_pi, v[i] * scale);
  }
}

// graph/pose_graph.py::_local_coords: [log(Rm^T R), Rm^T (t - tm)] of pose
// (angles a[0..2], translation a[3..5]) against the measurement m
template <typename T>
__device__ __forceinline__ void local_coords(const T m[6], const T a[6],
                                             T out[6]) {
  T Rm[9], R[9], dR[9];
  euler_to_rot(m[0], m[1], m[2], Rm);
  euler_to_rot(a[0], a[1], a[2], R);
  mat_tmul(Rm, R, dR);
  const T d[3] = {a[3] - m[3], a[4] - m[4], a[5] - m[5]};
  so3_log(dR, out);
  mat_tvec(Rm, d, out + 3);
}

// graph/pose_graph.py::between_residual: the error of T_i^-1 T_j against m
template <typename T>
__device__ __forceinline__ void between_residual(const T pi[6],
                                                 const T pj[6],
                                                 const T m[6], T out[6]) {
  T Ri[9], Rj[9], Rij[9];
  euler_to_rot(pi[0], pi[1], pi[2], Ri);
  euler_to_rot(pj[0], pj[1], pj[2], Rj);
  mat_tmul(Ri, Rj, Rij);
  const T d[3] = {pj[3] - pi[3], pj[4] - pi[4], pj[5] - pi[5]};
  T rel[6];
  // geom/se3.py::rot_to_euler
  rel[0] = atan2_(Rij[7], Rij[8]);
  rel[1] = asin_(clamp_(-Rij[6], -1.0f, 1.0f));
  rel[2] = atan2_(Rij[3], Rij[0]);
  mat_tvec(Ri, d, rel + 3);
  local_coords(m, rel, out);
}

// The three whitened residuals.  Poses and measurements come as floats;
// `col` seeds the unit tangent of a Jacobian column (the prior's and the
// GPS factor's pose: 0..5; a between factor's pose_i: 0..5, pose_j:
// 6..11), -1 none.
template <typename T>
__device__ __forceinline__ void load6(const float* p, int seed, T out[6]);
template <>
__device__ __forceinline__ void load6<float>(const float* p, int seed,
                                             float out[6]) {
#pragma unroll
  for (int c = 0; c < 6; ++c) out[c] = p[c];
}
template <>
__device__ __forceinline__ void load6<Dual>(const float* p, int seed,
                                            Dual out[6]) {
#pragma unroll
  for (int c = 0; c < 6; ++c) out[c] = {p[c], c == seed ? 1.0f : 0.0f};
}

template <typename T>
__device__ __forceinline__ void prior_res(const float* pose,
                                          const float* meas,
                                          const float* sigma, int col,
                                          T r[6]) {
  T p[6], m[6], l[6];
  load6<T>(pose, col, p);
  load6<T>(meas, -1, m);
  local_coords(m, p, l);
#pragma unroll
  for (int o = 0; o < 6; ++o) r[o] = l[o] / lift<T>(sigma[o]);
}

template <typename T>
__device__ __forceinline__ void btw_res(const float* pose_i,
                                        const float* pose_j,
                                        const float* meas,
                                        const float* sigma, int col,
                                        T r[6]) {
  T pi[6], pj[6], m[6], l[6];
  load6<T>(pose_i, col, pi);
  load6<T>(pose_j, col - 6, pj);
  load6<T>(meas, -1, m);
  between_residual(pi, pj, m, l);
#pragma unroll
  for (int o = 0; o < 6; ++o) r[o] = l[o] / lift<T>(sigma[o]);
}

template <typename T>
__device__ __forceinline__ void gps_res(const float* pose, const float* meas,
                                        const float* sigma, int col,
                                        T r[3]) {
  T p[6];
  load6<T>(pose, col, p);
#pragma unroll
  for (int o = 0; o < 3; ++o)
    r[o] = (p[3 + o] - lift<T>(meas[o])) / lift<T>(sigma[o]);
}
