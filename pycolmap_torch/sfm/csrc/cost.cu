// Robust total cost of one bucket, and the fused LM-step tail
// (point back-substitution + cost at the updated parameters).
//
// Replaces: pycolmap_tpu/sfm/cg_kernel.py cost_bucket (:708; body
// _make_cost_kernel :670) and finish_bucket (:821; body _make_finish_kernel
// :746).
//
// Bound: bytes. cost reads per track slot two indices, xy and mask (20 B)
// plus the point once; finish adds the Jacobian (8 (9+NP) B per slot, 109 MB
// at the bench shape), Vinv and g_pt, and writes the new points. The
// per-slot arithmetic is one projection (and one 2 x (9+NP) contraction in
// finish), far below the f32 rate per byte.
//
// Design: one thread per point column; the per-point sums over the track
// (J_p^T a in finish) stay in registers, and the new point never leaves
// registers between the back-substitution and the cost that uses it. Costs
// reduce in-warp and in-block to one partial per block, written without
// atomics; the wrapper sums the partials with torch.sum, as the reference
// wrapper sums its [8, 128] lane partials (cg_kernel.py:935, :967). The sum
// is deterministic for a given launch shape.
//
// Mixed-model bundles: both kernels on the Mixed<NPM> camera policy
// (ba_device.cuh), one instance per mixed width; each observation's
// residual switches on its camera's selector at run time, and an id that
// names no listed model projects to pixel 0, as the reference's
// where-chain (ba_math.img_from_cam_cf) gives.
#include "ba_device.cuh"

template <class Cam>
__global__ void __launch_bounds__(BA_BLOCK)
cost_kernel(const float* __restrict__ itab, const float* __restrict__ intr,
            const int* __restrict__ img_idx, const int* __restrict__ cam_idx,
            const float* __restrict__ xy, const float* __restrict__ mask,
            const float* __restrict__ pts, int T, int P, int loss, float scale, int models,
            float* __restrict__ partials) {
  constexpr int NP = Cam::NP;
  const int p = blockIdx.x * BA_BLOCK + threadIdx.x;
  const size_t TP = (size_t)T * P;
  float acc = 0.f;
  if (p < P) {
    const float X0 = pts[p], X1 = pts[P + p], X2 = pts[2 * P + p];
    for (int t = 0; t < T; ++t) {
      const size_t o = (size_t)t * P + p;
      const float m = mask[o];
      if (m == 0.f) continue;
      float q[4], tt[3], k[NP];
      load_pose(itab, img_idx[o], q, tt);
      const int ci = cam_idx[o];
#pragma unroll
      for (int j = 0; j < NP; ++j) k[j] = __ldg(intr + ci * NP + j);
      float rx, ry;
      Cam::res(models, k, q, tt, X0, X1, X2, xy[o], xy[TP + o], m, rx, ry);
      acc += robust_cost(rx * rx + ry * ry, loss, scale) * m;
    }
  }
  const float s = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

template <class Cam>
__global__ void __launch_bounds__(BA_BLOCK)
finish_kernel(const float* __restrict__ J, const float* __restrict__ vinv,
              const float* __restrict__ gpt, const int* __restrict__ img_idx,
              const int* __restrict__ cam_idx, const float* __restrict__ xy,
              const float* __restrict__ mask, const float* __restrict__ pts,
              const float* __restrict__ pfree, const float* __restrict__ xpose,
              const float* __restrict__ xintr, const float* __restrict__ nitab,
              const float* __restrict__ nintr, int T, int P, int loss, float scale,
              int models, float* __restrict__ new_pts, float* __restrict__ partials) {
  constexpr int NP = Cam::NP;
  constexpr int NK = 6 + NP;
  constexpr int NJ = 9 + NP;
  const int p = blockIdx.x * BA_BLOCK + threadIdx.x;
  const size_t TP = (size_t)T * P;
  float acc = 0.f;
  if (p < P) {
    // --- back-substitution: dp = Vinv (g_pt - J_p^T J_c x) --------------
    float bt[3] = {0.f, 0.f, 0.f};
    for (int t = 0; t < T; ++t) {
      const size_t o = (size_t)t * P + p;
      const int ii = img_idx[o], ci = cam_idx[o];
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int k = 0; k < NK; ++k) {
        const float xk = k < 6 ? __ldg(xpose + ii * 6 + k) : __ldg(xintr + ci * NP + k - 6);
        a0 += J[(size_t)k * TP + o] * xk;
        a1 += J[(size_t)(NJ + k) * TP + o] * xk;
      }
#pragma unroll
      for (int a = 0; a < 3; ++a)
        bt[a] += J[(size_t)(NK + a) * TP + o] * a0 + J[(size_t)(NJ + NK + a) * TP + o] * a1;
    }
    const float va = vinv[p], vb = vinv[P + p], vc = vinv[2 * P + p];
    const float vd = vinv[3 * P + p], ve = vinv[4 * P + p], vf = vinv[5 * P + p];
    const float r0 = gpt[p] - bt[0], r1 = gpt[P + p] - bt[1], r2 = gpt[2 * P + p] - bt[2];
    const float pf = pfree[p];
    const float X0 = pts[p] - (va * r0 + vb * r1 + vc * r2) * pf;
    const float X1 = pts[P + p] - (vb * r0 + vd * r1 + ve * r2) * pf;
    const float X2 = pts[2 * P + p] - (vc * r0 + ve * r1 + vf * r2) * pf;
    new_pts[p] = X0;
    new_pts[P + p] = X1;
    new_pts[2 * P + p] = X2;

    // --- robust cost at the updated parameters ----------------------------
    for (int t = 0; t < T; ++t) {
      const size_t o = (size_t)t * P + p;
      const float m = mask[o];
      if (m == 0.f) continue;
      float q[4], tt[3], k[NP];
      load_pose(nitab, img_idx[o], q, tt);
      const int ci = cam_idx[o];
#pragma unroll
      for (int j = 0; j < NP; ++j) k[j] = __ldg(nintr + ci * NP + j);
      float rx, ry;
      Cam::res(models, k, q, tt, X0, X1, X2, xy[o], xy[TP + o], m, rx, ry);
      acc += robust_cost(rx * rx + ry * ry, loss, scale) * m;
    }
  }
  const float s = block_sum(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = s;
}

BA_DEFINE_ERROR_STRING

#define BA_COST_LAUNCH(CAM, MODELS)                                                    \
  cost_kernel<CAM><<<blocks, BA_BLOCK, 0, s>>>(itab, intr, img_idx, cam_idx, xy, mask, \
                                               pts, T, P, loss, scale, MODELS, partials);
#define BA_FINISH_LAUNCH(CAM, MODELS)                                                   \
  finish_kernel<CAM><<<blocks, BA_BLOCK, 0, s>>>(J, vinv, gpt, img_idx, cam_idx, xy,    \
                                                 mask, pts, pfree, xpose, xintr, nitab, \
                                                 nintr, T, P, loss, scale, MODELS,      \
                                                 new_pts, partials);

extern "C" int ba_cost(int model, const float* itab, const float* intr, const int* img_idx,
                       const int* cam_idx, const float* xy, const float* mask, const float* pts,
                       int T, int P, int loss, float scale, float* partials, void* stream) {
  const int blocks = (P + BA_BLOCK - 1) / BA_BLOCK;
  cudaStream_t s = (cudaStream_t)stream;
  switch (model) {
#define X(M)                        \
  case M:                           \
    BA_COST_LAUNCH(Single<M>, 0)   \
    break;
    BA_FOR_EACH_MODEL(X)
#undef X
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int ba_finish(int model, const float* J, const float* vinv, const float* gpt,
                         const int* img_idx, const int* cam_idx, const float* xy,
                         const float* mask, const float* pts, const float* pfree,
                         const float* xpose, const float* xintr, const float* nitab,
                         const float* nintr, int T, int P, int loss, float scale,
                         float* new_pts, float* partials, void* stream) {
  const int blocks = (P + BA_BLOCK - 1) / BA_BLOCK;
  cudaStream_t s = (cudaStream_t)stream;
  switch (model) {
#define X(M)                          \
  case M:                             \
    BA_FINISH_LAUNCH(Single<M>, 0)   \
    break;
    BA_FOR_EACH_MODEL(X)
#undef X
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// np, models: as ba_resjac_mixed (an unlisted id projects to pixel 0 here,
// so there is no `first`)
extern "C" int ba_cost_mixed(int np, int models, const float* itab,
                             const float* intr, const int* img_idx, const int* cam_idx,
                             const float* xy, const float* mask, const float* pts, int T,
                             int P, int loss, float scale, float* partials, void* stream) {
  if (!mixed_args_ok(np, models)) return (int)cudaErrorInvalidValue;
  const int blocks = (P + BA_BLOCK - 1) / BA_BLOCK;
  cudaStream_t s = (cudaStream_t)stream;
  switch (np) {
#define X(N)                             \
  case N:                                \
    BA_COST_LAUNCH(Mixed<N>, models)    \
    break;
    BA_FOR_EACH_MIXED_NP(X)
#undef X
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int ba_finish_mixed(int np, int models, const float* J,
                               const float* vinv, const float* gpt, const int* img_idx,
                               const int* cam_idx, const float* xy, const float* mask,
                               const float* pts, const float* pfree, const float* xpose,
                               const float* xintr, const float* nitab, const float* nintr,
                               int T, int P, int loss, float scale, float* new_pts,
                               float* partials, void* stream) {
  if (!mixed_args_ok(np, models)) return (int)cudaErrorInvalidValue;
  const int blocks = (P + BA_BLOCK - 1) / BA_BLOCK;
  cudaStream_t s = (cudaStream_t)stream;
  switch (np) {
#define X(N)                               \
  case N:                                  \
    BA_FINISH_LAUNCH(Mixed<N>, models)    \
    break;
    BA_FOR_EACH_MIXED_NP(X)
#undef X
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
