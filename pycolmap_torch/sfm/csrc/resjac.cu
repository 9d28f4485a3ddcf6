// Fused robust-weighted residual + analytic Jacobian of every observation
// bucket of a bundle, in one launch.
//
// Replaces: pycolmap_tpu/sfm/cg_kernel.py resjac_bucket (:625; body
// _make_resjac_kernel :585), the TPU kernel that evaluates
// ba_kernels._bucket_res_and_jac (:321) times the IRLS weight sqrt(w), one
// pallas_call per bucket.
//
// Bound: bytes. Per track slot it reads 4 B of mask, a live slot also 4 B
// of each index and 8 B of xy (its pose, camera row and point come from
// the read-only cache), and every slot writes 8 B of residual and 8 (9+NP)
// B of Jacobian; the arithmetic (a projection, three dual-number
// distortion passes for SIMPLE_RADIAL) is a few hundred flops, well under
// the H100's 67 TFLOP/s f32 per byte moved. J dominates: 109 MB at the
// bench shape.
//
// Design.
// - One launch per res_and_jac call for all buckets, over a table passed
//   by value (ResJacTable, built by cg_kernel.py once per LM solve and
//   shard: the buckets' indices, xy, mask and free flags do not change
//   within a solve; per call only the points' pointers are written). Every
//   bucket's residual [2, T, P] and Jacobian [2, 9+NP, T, P] are views of
//   one output allocation, at the table's offsets.
// - One thread per track slot: a block is (bucket, slot row t, a run of
//   256 consecutive columns), so every output plane is written in runs of
//   1 KB along P whatever T is, and a bucket of long tracks and few
//   columns (the mapper's [32, 2048]: 65,536 slots) spreads over the card
//   instead of giving 2,048 threads up to 32 slots each in series.
// - A live slot (mask != 0) loads its indices and xy, its pose, camera row
//   and point through the read-only cache, and runs Cam::jac (ba_device.cuh)
//   with the residual formed in double. The distortion derivatives come
//   from the templated distortion evaluated on dual numbers: the same
//   quantities the reference takes with jax.jvp, for all 11 models, with
//   no second derivation. A dead slot, and every slot of a padding column,
//   loads only its mask and writes zeros: the Schur kernels stream all of
//   J, and finish relies on J being zero at a masked slot. Threads past P
//   write nothing.
// - Launch bounds: (256) alone. ptxas gives the instances 57-112
//   registers a thread with no spill but RADIAL's Single<3>, 4 bytes at
//   64 registers. (256, 1) removes that spill, but raises Single<2> from
//   57 to 68 registers (4 -> 3 resident blocks per SM) and its time at the
//   bench shape by 1-2%, while the spill costs Single<3> no measurable time
//   (scripts/resjac_launch_bounds.py).
//
// Mixed-model bundles (model_id a tuple in cg_kernel.py): the same kernel
// on the Mixed<NPM> camera policy (ba_device.cuh), one instance per width
// NPM = max(model NP) + 1. Each observation reads its camera's selector
// (the last intrinsics column) and switches at run time into the per-model
// code; J keeps 9 + NPM columns, exact zeros past the model's own
// parameters (the selector's column among them). Lanes of a warp whose
// cameras use different models run their cases one after another.
#include "ba_device.cuh"

constexpr int kResJacCols = BA_BLOCK;  // columns of a block's run, one thread each
constexpr int kResJacMaxBuckets = 16;

// One row of the table (sfm/_cuda.py _ResJacBucket): the bucket's
// operands, where its outputs start in the output allocation (in floats:
// res [2, T, P] at res_off, J [2, 9+NP, T, P] at J_off), its T and P, its
// runs of kResJacCols columns and its first block. Blocks first_block ..
// first_block + T runs - 1 are (t, run) in row-major order.
struct ResJacBucket {
  const int* img;      // [T, P]
  const int* cam;      // [T, P]
  const float* xy;     // [2, T, P]
  const float* mask;   // [T, P]
  const float* pts;    // [3, P], written per call
  const float* pfree;  // [P]
  long long res_off, J_off;
  int T, P, runs, first_block;
};

struct ResJacTable {
  ResJacBucket b[kResJacMaxBuckets];
  int nb, n_blocks;
};

// quat [I, 4], trans [I, 3], intr and ifree [C, NP]; out the allocation
// every bucket's residual and Jacobian are views of.
template <class Cam>
__global__ void __launch_bounds__(kResJacCols)
resjac_kernel(const __grid_constant__ ResJacTable tab, const float* __restrict__ quat,
              const float* __restrict__ trans, const float* __restrict__ intr,
              const float* __restrict__ ifree, int loss, float scale, int models, int first,
              float* __restrict__ out) {
  constexpr int NP = Cam::NP;
  constexpr int NJ = 9 + NP;
  int bi = 0;
  while (bi + 1 < tab.nb && (int)blockIdx.x >= tab.b[bi + 1].first_block) ++bi;
  const ResJacBucket& B = tab.b[bi];
  const int local = (int)blockIdx.x - B.first_block;
  const int t = local / B.runs;
  const int p = (local - t * B.runs) * kResJacCols + (int)threadIdx.x;
  if (p >= B.P) return;
  const size_t TP = (size_t)B.T * B.P;
  const size_t o = (size_t)t * B.P + p;
  float* __restrict__ res = out + B.res_off;
  float* __restrict__ J = out + B.J_off;

  const float m = __ldg(B.mask + o);
  float c0[NJ], c1[NJ];
  float rx = 0.f, ry = 0.f, sw = 0.f;
  if (m != 0.f) {
    float q[4], tt[3], k[NP], fr[NP];
    load_qt(quat, trans, __ldg(B.img + o), q, tt);
    const int ci = __ldg(B.cam + o);
#pragma unroll
    for (int j = 0; j < NP; ++j) {
      k[j] = __ldg(intr + ci * NP + j);
      fr[j] = __ldg(ifree + ci * NP + j);
    }
    const float X0 = __ldg(B.pts + p), X1 = __ldg(B.pts + B.P + p),
                X2 = __ldg(B.pts + 2 * B.P + p);
    Cam::jac(models, first, k, fr, q, tt, X0, X1, X2, __ldg(B.xy + o), __ldg(B.xy + TP + o), m,
             __ldg(B.pfree + p), rx, ry, c0, c1);
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

BA_DEFINE_ERROR_STRING

// The table's contract (cg_kernel.py resjac_table): 1-16 buckets in block
// order, T >= 1, P >= 0, runs = ceil(P / 256), every bucket's blocks
// following the last's, offsets non-negative multiples of 4 floats (16 B);
// the operands non-null.
static bool resjac_table_ok(const ResJacTable& tab) {
  if (tab.nb < 1 || tab.nb > kResJacMaxBuckets || tab.n_blocks < 0) return false;
  long long first = 0;
  for (int i = 0; i < tab.nb; ++i) {
    const ResJacBucket& b = tab.b[i];
    if (b.T < 1 || b.P < 0 || b.runs != (b.P + kResJacCols - 1) / kResJacCols ||
        b.first_block != first || b.res_off < 0 || b.J_off < 0 || (b.res_off & 3) ||
        (b.J_off & 3))
      return false;
    if (!b.img || !b.cam || !b.xy || !b.mask || !b.pts || !b.pfree) return false;
    first += (long long)b.T * b.runs;
  }
  return first == tab.n_blocks;
}

template <class Cam>
static int resjac_launch(const ResJacTable* tab, const float* quat, const float* trans,
                         const float* intr, const float* ifree, int loss, float scale, int models,
                         int first, float* out, cudaStream_t s) {
  if (!resjac_table_ok(*tab) || !quat || !trans || !intr || !ifree || !out)
    return (int)cudaErrorInvalidValue;
  if (tab->n_blocks == 0) return 0;  // no column in any bucket: nothing to write
  resjac_kernel<Cam><<<tab->n_blocks, kResJacCols, 0, s>>>(*tab, quat, trans, intr, ifree, loss,
                                                          scale, models, first, out);
  return (int)cudaGetLastError();
}

extern "C" int ba_resjac(int model, const ResJacTable* tab, const float* quat,
                         const float* trans, const float* intr, const float* ifree, int loss,
                         float scale, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (model) {
#define X(M)                                                                             \
  case M:                                                                                \
    return resjac_launch<Single<M>>(tab, quat, trans, intr, ifree, loss, scale, 0, 0, out, \
                                    s);
    BA_FOR_EACH_MODEL(X)
#undef X
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// np: the mixed width (selector column last); models: the listed ids as a
// bit mask; first: the id an observation naming no listed model takes.
extern "C" int ba_resjac_mixed(int np, int models, int first, const ResJacTable* tab,
                               const float* quat, const float* trans, const float* intr,
                               const float* ifree, int loss, float scale, float* out,
                               void* stream) {
  if (!mixed_args_ok(np, models) || first < 0 || first > 10 || !((models >> first) & 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (np) {
#define X(N)                                                                              \
  case N:                                                                                 \
    return resjac_launch<Mixed<N>>(tab, quat, trans, intr, ifree, loss, scale, models, first, \
                                   out, s);
    BA_FOR_EACH_MIXED_NP(X)
#undef X
    default:
      return (int)cudaErrorInvalidValue;
  }
}
