// Fused robust-weighted residual + analytic Jacobian of one observation
// bucket.
//
// Replaces: pycolmap_tpu/sfm/cg_kernel.py resjac_bucket (:625; body
// _make_resjac_kernel :585), the TPU kernel that evaluates
// ba_kernels._bucket_res_and_jac (:321) times the IRLS weight sqrt(w).
//
// Bound: bytes. Per track slot it reads 4 B of each index, 8 B of xy and 4 B
// of mask, and writes 8 B of residual and 8 (9+NP) B of Jacobian; the
// arithmetic (a projection, three dual-number distortion passes for
// SIMPLE_RADIAL) is a few hundred flops, well under the H100's 67 TFLOP/s
// f32 per byte moved. J dominates: 109 MB at the bench shape.
//
// Design: one thread per point column p loops over the T track slots, so
// every [.., T, P] plane is written coalesced along P and the point's
// coordinates load once. The camera tables ([I, 7], [C, NP]) are tiny and
// read through the read-only cache. The distortion derivatives come from
// the templated distortion evaluated on dual numbers (ba_device.cuh): the
// same quantities the reference takes with jax.jvp, for all 11 models, with
// no second derivation. Padded slots (mask 0) write zeros without
// evaluating the model.
//
// Mixed-model bundles (model_id a tuple in cg_kernel.py): the same kernel
// on the Mixed<NPM> camera policy (ba_device.cuh), one instance per width
// NPM = max(model NP) + 1. Each observation reads its camera's selector
// (the last intrinsics column) and switches at run time into the per-model
// code; J keeps 9 + NPM columns, exact zeros past the model's own
// parameters (the selector's column among them). Lanes of a warp whose
// cameras use different models run their cases one after another.
#include "ba_device.cuh"

template <class Cam>
__global__ void __launch_bounds__(BA_BLOCK)
resjac_kernel(const float* __restrict__ itab, const float* __restrict__ intr,
              const float* __restrict__ ifree, const int* __restrict__ img_idx,
              const int* __restrict__ cam_idx, const float* __restrict__ xy,
              const float* __restrict__ mask, const float* __restrict__ pts,
              const float* __restrict__ pfree, int T, int P, int loss, float scale,
              int models, int first, float* __restrict__ res, float* __restrict__ J) {
  constexpr int NP = Cam::NP;
  constexpr int NJ = 9 + NP;
  const int p = blockIdx.x * BA_BLOCK + threadIdx.x;
  if (p >= P) return;
  const size_t TP = (size_t)T * P;
  const float X0 = pts[p], X1 = pts[P + p], X2 = pts[2 * P + p];
  const float pf = pfree[p];

  for (int t = 0; t < T; ++t) {
    const size_t o = (size_t)t * P + p;
    const float m = mask[o];
    float c0[NJ], c1[NJ];
    float rx = 0.f, ry = 0.f, sw = 0.f;
    if (m != 0.f) {
      float q[4], tt[3], k[NP], fr[NP];
      load_pose(itab, img_idx[o], q, tt);
      const int ci = cam_idx[o];
#pragma unroll
      for (int j = 0; j < NP; ++j) {
        k[j] = __ldg(intr + ci * NP + j);
        fr[j] = __ldg(ifree + ci * NP + j);
      }
      Cam::jac(models, first, k, fr, q, tt, X0, X1, X2, xy[o], xy[TP + o], m, pf, rx, ry,
               c0, c1);
      sw = sqrtf(robust_weight(rx * rx + ry * ry, loss, scale) * m);
    } else {
#pragma unroll
      for (int c = 0; c < NJ; ++c) c0[c] = c1[c] = 0.f;
    }
    res[o] = rx * sw;
    res[TP + o] = ry * sw;
#pragma unroll
    for (int c = 0; c < NJ; ++c) {
      J[(size_t)c * TP + o] = c0[c] * sw;
      J[(size_t)(NJ + c) * TP + o] = c1[c] * sw;
    }
  }
}

BA_DEFINE_ERROR_STRING

#define BA_RESJAC_LAUNCH(CAM, MODELS, FIRST)                                         \
  resjac_kernel<CAM><<<blocks, BA_BLOCK, 0, s>>>(itab, intr, ifree, img_idx, cam_idx, \
                                                 xy, mask, pts, pfree, T, P, loss,   \
                                                 scale, MODELS, FIRST, res, J);

extern "C" int ba_resjac(int model, const float* itab, const float* intr, const float* ifree,
                         const int* img_idx, const int* cam_idx, const float* xy,
                         const float* mask, const float* pts, const float* pfree, int T, int P,
                         int loss, float scale, float* res, float* J, void* stream) {
  const int blocks = (P + BA_BLOCK - 1) / BA_BLOCK;
  cudaStream_t s = (cudaStream_t)stream;
  switch (model) {
#define X(M)                           \
  case M:                              \
    BA_RESJAC_LAUNCH(Single<M>, 0, 0) \
    break;
    BA_FOR_EACH_MODEL(X)
#undef X
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// np: the mixed width (selector column last); models: the listed ids as a
// bit mask; first: the id an observation naming no listed model takes.
extern "C" int ba_resjac_mixed(int np, int models, int first, const float* itab,
                               const float* intr, const float* ifree, const int* img_idx,
                               const int* cam_idx, const float* xy, const float* mask,
                               const float* pts, const float* pfree, int T, int P, int loss,
                               float scale, float* res, float* J, void* stream) {
  if (!mixed_args_ok(np, models) || first < 0 || first > 10 || !((models >> first) & 1))
    return (int)cudaErrorInvalidValue;
  const int blocks = (P + BA_BLOCK - 1) / BA_BLOCK;
  cudaStream_t s = (cudaStream_t)stream;
  switch (np) {
#define X(N)                                     \
  case N:                                        \
    BA_RESJAC_LAUNCH(Mixed<N>, models, first)   \
    break;
    BA_FOR_EACH_MIXED_NP(X)
#undef X
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
