// Shared device code of the bundle-adjustment kernels (resjac.cu, cost.cu,
// schur.cu): forward-mode dual numbers, the quaternion rotation, the 11
// COLMAP camera distortions templated on the scalar type, the robust losses,
// and the in-block reductions and scatters.
//
// Layouts (all row-major, f32 unless noted), shared with the plain PyTorch
// versions in pycolmap_torch/sfm/cg_kernel.py:
//   itab  [I, 7]   quat wxyz | trans          intr, ifree [C, NP]
//   img_idx, cam_idx [T, P] int32             xy [2, T, P]   mask [T, P]
//   pts   [3, P]   pfree [P]                  res [2, T, P]
//   J     [2, 9+NP, T, P]: 6 pose | NP intrinsics | 3 point columns
//   vinv  [6, P] packed symmetric (00,01,02,11,12,22)   gpt [3, P]
// One thread owns one point column p and loops over its T track slots, so
// every [.., T, P] plane is read coalesced along P and per-point sums over
// the track stay in registers.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

#define BA_BLOCK 256  // threads per block; cg_kernel.py sizes partials by it

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

__device__ __forceinline__ void load_pose(const float* itab, int i, float q[4], float t[3]) {
  const float* r = itab + 7 * i;
#pragma unroll
  for (int c = 0; c < 4; ++c) q[c] = __ldg(r + c);
#pragma unroll
  for (int c = 0; c < 3; ++c) t[c] = __ldg(r + 4 + c);
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

// ops/ba_math.py project_cf followed by ba_kernels._residual_vals: the
// masked residual at the given parameters (u = x / z, as the reference).
template <int M>
__device__ __forceinline__ void residual(const float* k, const float q[4], const float t[3],
                                         float X0, float X1, float X2, float x0, float x1,
                                         float mask, float& rx, float& ry) {
  using Mi = Model<M>;
  float cx, cy, cz;
  quat_rotate(q, X0, X1, X2, cx, cy, cz);
  cx += t[0];
  cy += t[1];
  cz += t[2];
  float z_safe = fabsf(cz) < 1e-8f ? 1e-8f : cz;
  float u = cx / z_safe, v = cy / z_safe;
  float du, dv;
  distort<M, float>(k, u, v, du, dv);
  float px = k[0] * du + k[Mi::cx];
  float py = k[Mi::fy] * dv + k[Mi::cy];
  bool behind = cz <= 1e-8f && mask > 0.f;
  rx = behind ? 1e3f : (px - x0) * mask;
  ry = behind ? 1e3f : (py - x1) * mask;
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
// in-block reductions and scatters
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

// Scatter of n values into row `row` of an accumulator; zeros are skipped
// (padded track slots carry all-zero Jacobians and index 0, and would
// otherwise pile their no-op adds onto row 0).
template <int N>
__device__ __forceinline__ void scatter_row(float* acc, int row, int stride, const float* vals) {
  float* r = acc + (size_t)row * stride;
#pragma unroll
  for (int c = 0; c < N; ++c)
    if (vals[c] != 0.f) atomicAdd(r + c, vals[c]);
}

// Flush one pending per-thread camera row (row < 0: nothing pending). When
// every pending lane of the warp holds the same camera (always so with one
// camera, as in the bench), the warp reduces first and one lane adds: N
// atomics per warp instead of 32 N onto the same addresses. All 32 lanes
// must call it.
template <int N>
__device__ __forceinline__ void flush_cam_row(float* acc, int row, int stride, float* vals) {
  unsigned pending = __ballot_sync(0xffffffffu, row >= 0);
  if (pending == 0u) return;
  int lead = __shfl_sync(0xffffffffu, row, __ffs(pending) - 1);
  if (__all_sync(0xffffffffu, row < 0 || row == lead)) {
#pragma unroll
    for (int c = 0; c < N; ++c) vals[c] = warp_sum(row >= 0 ? vals[c] : 0.f);
    if ((threadIdx.x & 31) == 0) scatter_row<N>(acc, lead, stride, vals);
  } else if (row >= 0) {
    scatter_row<N>(acc, row, stride, vals);
  }
}

// cudaGetErrorString for the Python wrappers; each library defines it once.
#define BA_DEFINE_ERROR_STRING                              \
  extern "C" const char* kernel_error_string(int code) {    \
    return cudaGetErrorString((cudaError_t)code);           \
  }

// Shared-memory accumulators above this size use the global-atomic variant.
#define BA_MAX_SMEM_BYTES (160 * 1024)

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
