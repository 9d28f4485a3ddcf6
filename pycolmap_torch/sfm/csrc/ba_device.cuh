// Shared device code of the bundle-adjustment kernels (resjac.cu, cost.cu,
// schur.cu): forward-mode dual numbers, the quaternion rotation, the 11
// COLMAP camera distortions templated on the scalar type, the per-model
// residual and Jacobian, the camera policies (one model, or a mixed-model
// bundle's per-observation switch), the robust losses, and the in-block
// reductions.
//
// Layouts (all row-major, f32 unless noted), shared with the plain PyTorch
// versions in pycolmap_torch/sfm/cg_kernel.py:
//   quat  [I, 4] wxyz   trans [I, 3]          intr, ifree [C, NP]
//   img_idx, cam_idx [T, P] int32             xy [2, T, P]   mask [T, P]
//   pts   [3, P]   pfree [P]                  res [2, T, P]
//   J     [2, 9+NP, T, P]: 6 pose | NP intrinsics | 3 point columns
//   vinv  [6, P] packed symmetric (00,01,02,11,12,22)   gpt [3, P]
// resjac.cu gives each thread one track slot of a run of 256 columns of one
// slot row, so every [.., T, P] plane is read and written coalesced along
// P; cost.cu and schur.cu give each thread one or more slots of a tile of
// columns.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define BA_BLOCK 256  // threads per block of resjac.cu and cost.cu

// ---------------------------------------------------------------------------
// forward-mode dual numbers: the distortion derivatives the reference takes
// with jax.jvp (ba_kernels.py:384-387, :459) come from evaluating the same
// templated distortion on Dual instead of float
// ---------------------------------------------------------------------------

struct Dual {
  float v, d;
};

__device__ __forceinline__ Dual mk(float v, float d = 0.f) { return Dual{v, d}; }
__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return {a.v + b.v, a.d + b.d}; }
__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return {a.v - b.v, a.d - b.d}; }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) { return {a.v * b.v, a.d * b.v + a.v * b.d}; }
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  return {a.v / b.v, a.d / b.v - a.v * b.d / (b.v * b.v)};
}
__device__ __forceinline__ Dual operator+(Dual a, float b) { return {a.v + b, a.d}; }
__device__ __forceinline__ Dual operator+(float a, Dual b) { return {a + b.v, b.d}; }
__device__ __forceinline__ Dual operator-(Dual a, float b) { return {a.v - b, a.d}; }
__device__ __forceinline__ Dual operator-(float a, Dual b) { return {a - b.v, -b.d}; }
__device__ __forceinline__ Dual operator*(Dual a, float b) { return {a.v * b, a.d * b}; }
__device__ __forceinline__ Dual operator*(float a, Dual b) { return {a * b.v, a * b.d}; }
__device__ __forceinline__ Dual operator/(Dual a, float b) { return {a.v / b, a.d / b}; }
__device__ __forceinline__ Dual operator/(float a, Dual b) {
  return {a / b.v, -a * b.d / (b.v * b.v)};
}

__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ float val(Dual x) { return x.v; }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ Dual sqrt_(Dual x) {
  float s = sqrtf(x.v);
  return {s, x.d * (0.5f / s)};
}
__device__ __forceinline__ float atan_(float x) { return atanf(x); }
__device__ __forceinline__ Dual atan_(Dual x) { return {atanf(x.v), x.d / (1.f + x.v * x.v)}; }
__device__ __forceinline__ float tan_(float x) { return tanf(x); }
// double: the residual's value path (project64)
__device__ __forceinline__ double val(double x) { return x; }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ double atan_(double x) { return atan(x); }
__device__ __forceinline__ double tan_(double x) { return tan(x); }
__device__ __forceinline__ Dual tan_(Dual x) {
  float t = tanf(x.v);
  return {t, x.d * (1.f + t * t)};
}
template <class S>
__device__ __forceinline__ S sel(bool c, S a, S b) { return c ? a : b; }
template <class S>
__device__ __forceinline__ S one() { return S(1.f); }
template <>
__device__ __forceinline__ Dual one<Dual>() { return Dual{1.f, 0.f}; }

// ---------------------------------------------------------------------------
// camera models (ops/camera_models.py); parameter layout per model
// ---------------------------------------------------------------------------

template <int M> struct Model;
#define BA_MODEL(ID, NP_, TWO_FOCAL)                      \
  template <> struct Model<ID> {                          \
    static constexpr int NP = NP_;                        \
    static constexpr bool two_focal = TWO_FOCAL;          \
    static constexpr int fy = TWO_FOCAL ? 1 : 0;          \
    static constexpr int cx = TWO_FOCAL ? 2 : 1;          \
    static constexpr int cy = TWO_FOCAL ? 3 : 2;          \
  };
BA_MODEL(0, 3, false)   // SIMPLE_PINHOLE
BA_MODEL(1, 4, true)    // PINHOLE
BA_MODEL(2, 4, false)   // SIMPLE_RADIAL
BA_MODEL(3, 5, false)   // RADIAL
BA_MODEL(4, 8, true)    // OPENCV
BA_MODEL(5, 8, true)    // OPENCV_FISHEYE
BA_MODEL(6, 12, true)   // FULL_OPENCV
BA_MODEL(7, 5, true)    // FOV
BA_MODEL(8, 4, false)   // SIMPLE_RADIAL_FISHEYE
BA_MODEL(9, 5, false)   // RADIAL_FISHEYE
BA_MODEL(10, 12, true)  // THIN_PRISM_FISHEYE
#undef BA_MODEL

// the body of every launcher's switch over the 11 model ids
#define BA_FOR_EACH_MODEL(X) \
  X(0) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10)

template <class S, int K0, int NK>
__device__ __forceinline__ void radial_poly(const S* k, S u, S v, S& du, S& dv) {
  S r2 = u * u + v * v;
  S radial = one<S>();
  S rpow = r2;
#pragma unroll
  for (int i = 0; i < NK; ++i) {
    radial = radial + k[K0 + i] * rpow;
    rpow = rpow * r2;
  }
  du = u * radial;
  dv = v * radial;
}

template <class S>
__device__ __forceinline__ void thin_prism(const S* k, S u, S v, S& du, S& dv) {
  S r2 = u * u + v * v;
  S r4 = r2 * r2;
  S r6 = r4 * r2;
  S radial = 1.f + k[4] * r2 + k[5] * r4 + k[8] * r6 + k[9] * r4 * r4;
  du = u * radial + 2.f * k[6] * u * v + k[7] * (r2 + 2.f * u * u) + k[10] * r2;
  dv = v * radial + 2.f * k[7] * u * v + k[6] * (r2 + 2.f * v * v) + k[11] * r2;
}

// Distortion in the normalized plane (ops/ba_math.py _DISTORT_CF).
template <int M, class S>
__device__ __forceinline__ void distort(const S* k, S u, S v, S& du, S& dv) {
  if constexpr (M == 0 || M == 1) {
    du = u;
    dv = v;
  } else if constexpr (M == 2) {
    radial_poly<S, 3, 1>(k, u, v, du, dv);
  } else if constexpr (M == 3) {
    radial_poly<S, 3, 2>(k, u, v, du, dv);
  } else if constexpr (M == 4) {
    S r2 = u * u + v * v;
    S radial = 1.f + k[4] * r2 + k[5] * r2 * r2;
    du = u * radial + 2.f * k[6] * u * v + k[7] * (r2 + 2.f * u * u);
    dv = v * radial + 2.f * k[7] * u * v + k[6] * (r2 + 2.f * v * v);
  } else if constexpr (M == 5) {
    S r = sqrt_(u * u + v * v + 1e-20f);
    S theta = atan_(r);
    S t2 = theta * theta;
    S theta_d = theta * (1.f + t2 * (k[4] + t2 * (k[5] + t2 * (k[6] + t2 * k[7]))));
    S scale = theta_d / r;
    du = u * scale;
    dv = v * scale;
  } else if constexpr (M == 6) {
    S r2 = u * u + v * v;
    S r4 = r2 * r2;
    S r6 = r4 * r2;
    S radial = (1.f + k[4] * r2 + k[5] * r4 + k[8] * r6) /
               (1.f + k[9] * r2 + k[10] * r4 + k[11] * r6);
    du = u * radial + 2.f * k[6] * u * v + k[7] * (r2 + 2.f * u * u);
    dv = v * radial + 2.f * k[7] * u * v + k[6] * (r2 + 2.f * v * v);
  } else if constexpr (M == 7) {
    S omega = k[4];
    S r = sqrt_(u * u + v * v + 1e-20f);
    S tan_half = tan_(0.5f * omega);
    S num = atan_(2.f * r * tan_half);
    S rw = r * omega;
    bool small = fabsf(val(rw)) < 1e-8f;
    bool w_small = fabsf(val(omega)) < 1e-8f;
    S limit = sel(w_small, one<S>(), 2.f * tan_half / sel(w_small, one<S>(), omega));
    S factor = sel(small, limit, num / sel(small, one<S>(), rw));
    du = u * factor;
    dv = v * factor;
  } else {  // 8, 9, 10: equidistant fisheye wrap around a plane distortion
    S r = sqrt_(u * u + v * v + 1e-20f);
    S theta = atan_(r);
    S scale = sel(val(r) > 1e-8f, theta / r, one<S>());
    S uu = u * scale, vv = v * scale;
    if constexpr (M == 8) {
      radial_poly<S, 3, 1>(k, uu, vv, du, dv);
    } else if constexpr (M == 9) {
      radial_poly<S, 3, 2>(k, uu, vv, du, dv);
    } else {
      thin_prism<S>(k, uu, vv, du, dv);
    }
  }
}

// ---------------------------------------------------------------------------
// parameters, projection, robust losses
// ---------------------------------------------------------------------------

// image i's pose from quat [I, 4] and trans [I, 3]
__device__ __forceinline__ void load_qt(const float* quat, const float* trans, int i, float q[4],
                                        float t[3]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) q[c] = __ldg(quat + 4 * i + c);
#pragma unroll
  for (int c = 0; c < 3; ++c) t[c] = __ldg(trans + 3 * i + c);
}

// ops/ba_math.py quat_rotate_cf
__device__ __forceinline__ void quat_rotate(const float q[4], float X0, float X1, float X2,
                                            float& ox, float& oy, float& oz) {
  float w = q[0], x = q[1], y = q[2], z = q[3];
  float tx = 2.f * (y * X2 - z * X1);
  float ty = 2.f * (z * X0 - x * X2);
  float tz = 2.f * (x * X1 - y * X0);
  ox = X0 + w * tx + (y * tz - z * ty);
  oy = X1 + w * ty + (z * tx - x * tz);
  oz = X2 + w * tz + (x * ty - y * tx);
}

// ops/ba_math.py project_cf in double on the f32 parameters: the rotated
// point vr = R X, the camera-frame depth cz, u = x / z, v = y / z (as the
// reference) and the pixel (px, py). The residual is formed from these and
// rounded once: at a converged model it is a fraction of a pixel taken
// between projections of a few hundred pixels, and R X + t cancels terms of
// the scene's size, so f32 arithmetic there loses ~1e-4 px (the f32 plain
// version as much). The Jacobian stays f32, from these values rounded.
template <int M>
__device__ __forceinline__ void project64(const float* k, const float q[4], const float t[3],
                                          float X0, float X1, float X2, double vr[3],
                                          double& cz, double& u, double& v, double& px,
                                          double& py) {
  using Mi = Model<M>;
  const double w = q[0], x = q[1], y = q[2], z = q[3];
  const double tx = 2.0 * (y * X2 - z * X1);
  const double ty = 2.0 * (z * X0 - x * X2);
  const double tz = 2.0 * (x * X1 - y * X0);
  vr[0] = X0 + w * tx + (y * tz - z * ty);
  vr[1] = X1 + w * ty + (z * tx - x * tz);
  vr[2] = X2 + w * tz + (x * ty - y * tx);
  const double cx = vr[0] + t[0], cy = vr[1] + t[1];
  cz = vr[2] + t[2];
  const double z_safe = fabs(cz) < 1e-8 ? 1e-8 : cz;
  u = cx / z_safe;
  v = cy / z_safe;
  double kd[Mi::NP];
#pragma unroll
  for (int j = 0; j < Mi::NP; ++j) kd[j] = k[j];
  double du, dv;
  distort<M, double>(kd, u, v, du, dv);
  px = kd[0] * du + kd[Mi::cx];
  py = kd[Mi::fy] * dv + kd[Mi::cy];
}

// ba_kernels._residual_vals: the masked residual at the given parameters.
template <int M>
__device__ __forceinline__ void residual(const float* k, const float q[4], const float t[3],
                                         float X0, float X1, float X2, float x0, float x1,
                                         float mask, float& rx, float& ry) {
  double vr[3], cz, u, v, px, py;
  project64<M>(k, q, t, X0, X1, X2, vr, cz, u, v, px, py);
  const bool behind = cz <= 1e-8 && mask > 0.f;
  rx = behind ? 1e3f : (float)(px - x0) * mask;
  ry = behind ? 1e3f : (float)(py - x1) * mask;
}

// ba_kernels._bucket_res_and_jac for one observation of model M in a solver
// of NPM intrinsics columns (NPM >= the model's own count): the masked
// residual (rx, ry) and the unweighted Jacobian rows c0, c1 of 9 + NPM
// columns, 6 pose | NPM intrinsics (the model's own, masked by fr; exact
// zeros past them) | 3 point. k, fr: the camera's parameters and free flags.
template <int M, int NPM>
__device__ __forceinline__ void jac_obs(const float* k, const float* fr, const float q[4],
                                        const float tt[3], float X0, float X1, float X2,
                                        float x0, float x1, float m, float pf, float& rx,
                                        float& ry, float* c0, float* c1) {
  using Mi = Model<M>;
  constexpr int NP = Mi::NP;
  double vr[3], czd, ud, vd, pxd, pyd;
  project64<M>(k, q, tt, X0, X1, X2, vr, czd, ud, vd, pxd, pyd);
  const float vx = (float)vr[0], vy = (float)vr[1], vz = (float)vr[2];
  const float inv_z = (float)(1.0 / (fabs(czd) < 1e-8 ? 1e-8 : czd));
  const float u = (float)ud, v = (float)vd;

  Dual kd[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) kd[j] = mk(k[j]);
  Dual du_u, dv_u, du_v, dv_v;
  distort<M, Dual>(kd, mk(u, 1.f), mk(v), du_u, dv_u);
  distort<M, Dual>(kd, mk(u), mk(v, 1.f), du_v, dv_v);
  const float du = du_u.v, dv = dv_u.v;
  const float fx = k[0], fy = k[Mi::fy];

  const bool behind = czd <= 1e-8 && m > 0.f;
  rx = behind ? 1e3f : (float)(pxd - x0) * m;
  ry = behind ? 1e3f : (float)(pyd - x1) * m;
  // column weight: mask, and zero where the constant 1e3 residual replaced
  // the projection
  const float wgt = m * (behind ? 0.f : 1.f);

  // A = d(px,py)/d(u,v); B = A d(u,v)/dXc (2x3 perspective)
  const float A11 = fx * du_u.d, A12 = fx * du_v.d;
  const float A21 = fy * dv_u.d, A22 = fy * dv_v.d;
  const float B1x = A11 * inv_z, B1y = A12 * inv_z;
  const float B1z = -(A11 * u + A12 * v) * inv_z;
  const float B2x = A21 * inv_z, B2y = A22 * inv_z;
  const float B2z = -(A21 * u + A22 * v) * inv_z;

  // rotation (left tangent): dXc/dth = -[RX]x
  c0[0] = -B1y * vz + B1z * vy;  c1[0] = -B2y * vz + B2z * vy;
  c0[1] = B1x * vz - B1z * vx;   c1[1] = B2x * vz - B2z * vx;
  c0[2] = -B1x * vy + B1y * vx;  c1[2] = -B2x * vy + B2y * vx;
  // translation: dXc/dt = I
  c0[3] = B1x; c1[3] = B2x;
  c0[4] = B1y; c1[4] = B2y;
  c0[5] = B1z; c1[5] = B2z;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    c0[a] *= wgt;
    c1[a] *= wgt;
  }
  // intrinsics, masked by intr_free
#pragma unroll
  for (int j = 0; j < NP; ++j) {
    float jx, jy;
    if (j == 0) {
      jx = du;
      jy = Mi::two_focal ? 0.f : dv;
    } else if (Mi::two_focal && j == 1) {
      jx = 0.f;
      jy = dv;
    } else if (j == Mi::cx) {
      jx = 1.f;
      jy = 0.f;
    } else if (j == Mi::cy) {
      jx = 0.f;
      jy = 1.f;
    } else {  // extra parameter: one more dual pass with dk_j = 1
      Dual ek, ev;
      kd[j].d = 1.f;
      distort<M, Dual>(kd, mk(u), mk(v), ek, ev);
      kd[j].d = 0.f;
      jx = fx * ek.d;
      jy = fy * ev.d;
    }
    c0[6 + j] = jx * wgt * fr[j];
    c1[6 + j] = jy * wgt * fr[j];
  }
#pragma unroll
  for (int j = NP; j < NPM; ++j) c0[6 + j] = c1[6 + j] = 0.f;
  // point: dXc/dX = R(q)
  const float w = q[0], qx = q[1], qy = q[2], qz = q[3];
  const float R[3][3] = {
      {1.f - 2.f * (qy * qy + qz * qz), 2.f * (qx * qy - w * qz), 2.f * (qx * qz + w * qy)},
      {2.f * (qx * qy + w * qz), 1.f - 2.f * (qx * qx + qz * qz), 2.f * (qy * qz - w * qx)},
      {2.f * (qx * qz - w * qy), 2.f * (qy * qz + w * qx), 1.f - 2.f * (qx * qx + qy * qy)}};
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    c0[6 + NPM + a] = (B1x * R[0][a] + B1y * R[1][a] + B1z * R[2][a]) * wgt * pf;
    c1[6 + NPM + a] = (B2x * R[0][a] + B2y * R[1][a] + B2z * R[2][a]) * wgt * pf;
  }
}

// ---------------------------------------------------------------------------
// camera policies: the kernels are templated on one of these
// ---------------------------------------------------------------------------

// One camera model for the whole bundle; `models` and `first` are unused.
template <int M>
struct Single {
  static constexpr int NP = Model<M>::NP;
  __device__ static __forceinline__ void jac(int, int, const float* k, const float* fr,
                                             const float q[4], const float tt[3], float X0,
                                             float X1, float X2, float x0, float x1, float m,
                                             float pf, float& rx, float& ry, float* c0,
                                             float* c1) {
    jac_obs<M, NP>(k, fr, q, tt, X0, X1, X2, x0, x1, m, pf, rx, ry, c0, c1);
  }
  __device__ static __forceinline__ void res(int, const float* k, const float q[4],
                                             const float tt[3], float X0, float X1, float X2,
                                             float x0, float x1, float m, float& rx, float& ry) {
    residual<M>(k, q, tt, X0, X1, X2, x0, x1, m, rx, ry);
  }
};

// The model an observation's selector names when the bundle lists it (bit
// id of `models`), else -1. The reference compares the f32 selector plane
// with each listed id.
__device__ __forceinline__ int mixed_model(float s, int models) {
  if (!(s >= 0.f && s < 11.f)) return -1;  // also NaN
  const int id = (int)s;
  if ((float)id != s) return -1;
  return ((models >> id) & 1) ? id : -1;
}

// An observation whose selector names no listed model projects to pixel 0,
// the default of ba_math.img_from_cam_cf's where-chain.
__device__ __forceinline__ void residual_none(const float q[4], const float t[3], float X0,
                                              float X1, float X2, float x0, float x1,
                                              float mask, float& rx, float& ry) {
  float cx, cy, cz;
  quat_rotate(q, X0, X1, X2, cx, cy, cz);
  cz += t[2];
  const bool behind = cz <= 1e-8f && mask > 0.f;
  rx = behind ? 1e3f : (0.f - x0) * mask;
  ry = behind ? 1e3f : (0.f - x1) * mask;
}

// A mixed-model bundle of solver width NPM: the last intrinsics column is
// the camera's model id. Each observation switches at run time into the
// same per-model code as Single<M>; a model is compiled in only where it
// fits the width. In jac an unlisted id takes `first`, the default of
// ba_kernels._bucket_res_and_jac's where-chain.
template <int NPM>
struct Mixed {
  static constexpr int NP = NPM;
  __device__ static __forceinline__ void jac(int models, int first, const float* k,
                                             const float* fr, const float q[4],
                                             const float tt[3], float X0, float X1, float X2,
                                             float x0, float x1, float m, float pf, float& rx,
                                             float& ry, float* c0, float* c1) {
    int id = mixed_model(k[NPM - 1], models);
    if (id < 0) id = first;
    switch (id) {
#define BA_CASE(M)                                                                     \
  case M:                                                                              \
    if constexpr (Model<M>::NP < NPM) {                                                \
      jac_obs<M, NPM>(k, fr, q, tt, X0, X1, X2, x0, x1, m, pf, rx, ry, c0, c1);        \
      return;                                                                          \
    }                                                                                  \
    break;
      BA_FOR_EACH_MODEL(BA_CASE)
#undef BA_CASE
      default:
        break;
    }
    // unreachable for launcher-checked arguments
    rx = ry = 0.f;
#pragma unroll
    for (int c = 0; c < 9 + NPM; ++c) c0[c] = c1[c] = 0.f;
  }
  __device__ static __forceinline__ void res(int models, const float* k, const float q[4],
                                             const float tt[3], float X0, float X1, float X2,
                                             float x0, float x1, float m, float& rx, float& ry) {
    switch (mixed_model(k[NPM - 1], models)) {
#define BA_CASE(M)                                                \
  case M:                                                         \
    if constexpr (Model<M>::NP < NPM) {                           \
      residual<M>(k, q, tt, X0, X1, X2, x0, x1, m, rx, ry);       \
      return;                                                     \
    }                                                             \
    break;
      BA_FOR_EACH_MODEL(BA_CASE)
#undef BA_CASE
      default:
        break;
    }
    residual_none(q, tt, X0, X1, X2, x0, x1, m, rx, ry);
  }
};

// the mixed widths: max(model NP) + 1 over the 11 models
#define BA_FOR_EACH_MIXED_NP(X) X(4) X(5) X(6) X(9) X(13)

// Host check of a mixed launch: every listed model fits the width.
inline bool mixed_args_ok(int np, int models) {
  static const int kNP[11] = {Model<0>::NP, Model<1>::NP, Model<2>::NP, Model<3>::NP,
                              Model<4>::NP, Model<5>::NP, Model<6>::NP, Model<7>::NP,
                              Model<8>::NP, Model<9>::NP, Model<10>::NP};
  if (models <= 0 || models >= (1 << 11)) return false;
  for (int m = 0; m < 11; ++m)
    if (((models >> m) & 1) && kNP[m] >= np) return false;
  return true;
}

// sfm/bundle_adjustment.py _robust_weight / _robust_cost
// loss: 0 TRIVIAL, 1 SOFT_L1, 2 CAUCHY
__device__ __forceinline__ float robust_weight(float sq, int loss, float scale) {
  float s = sq / fmaxf(scale * scale, 1e-12f);
  if (loss == 0) return 1.f;
  if (loss == 1) return powf(1.f + s, -0.25f);
  return 1.f / sqrtf(1.f + s);
}

__device__ __forceinline__ float robust_cost(float sq, int loss, float scale) {
  float sc = fmaxf(scale * scale, 1e-12f);
  float s = sq / sc;
  if (loss == 0) return sq;
  if (loss == 1) return 2.f * sc * (sqrtf(1.f + s) - 1.f);
  return sc * log1pf(s);
}

// ---------------------------------------------------------------------------
// in-block reductions
// ---------------------------------------------------------------------------

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_down_sync(0xffffffffu, x, o);
  return x;
}

// Sum over the block; thread 0 holds the result. Every thread must call it.
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float part[BA_BLOCK / 32];
  x = warp_sum(x);
  int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  if (lane == 0) part[w] = x;
  __syncthreads();
  x = threadIdx.x < BA_BLOCK / 32 ? part[threadIdx.x] : 0.f;
  if (w == 0) x = warp_sum(x);
  return x;
}

// cudaGetErrorString for the Python wrappers; each library defines it once.
#define BA_DEFINE_ERROR_STRING                              \
  extern "C" const char* kernel_error_string(int code) {    \
    return cudaGetErrorString((cudaError_t)code);           \
  }

inline int ba_sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}
