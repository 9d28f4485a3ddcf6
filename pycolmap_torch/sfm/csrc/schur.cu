// Schur-complement LM preparation and the implicit reduced-camera matvec,
// from an f32 J and from a bf16-packed J.
//
// Replaces: pycolmap_tpu/sfm/cg_kernel.py schur_prepare_bucket (:1088; body
// _make_prepare_kernel :971), cg_matvec_bucket (:183; body _make_kernel
// :127) and cg_matvec16_bucket (:352; body _make_matvec16_kernel :231).
//
// prepare, per point column: the lambda-damped 3x3 point block V = J_p^T J_p
// and its closed-form inverse, g_pt = J_p^T r, and, scattered per image and
// per camera, the Schur-reduced rhs J_c^T (r - J_p V^-1 g_pt), diag(J_c^T J_c)
// and the 21 packed entries of each image's 6x6 SCHUR_JACOBI block
// sum(J_c^T J_c - W V^-1 W^T), W = J_c^T J_p.
// matvec: S x = J_c^T (I - J_p V^-1 J_p^T) J_c x, gathered per observation
// and scattered per image and camera (damping and free masks stay with the
// caller, as in the reference).
//
// Bound: bytes. Both stream J (8 (9+NP) B per track slot, 109 MB at the
// bench shape) and the indices; prepare adds the residual, matvec Vinv. The
// arithmetic is a few hundred flops per slot. This first version reads J
// twice per launch (the per-point sums of the first pass feed the second),
// so it moves about twice the bound's bytes.
//
// Design: one thread per point column, T slots in registers-worth loops.
// Scatters go to block-local shared-memory accumulators ([I, 33] + [C, 2NP]
// floats for prepare: 17 KB at I = 128), then one global atomicAdd per
// nonzero entry per block. Above BA_MAX_SMEM_BYTES a variant adds straight
// into global memory. With one camera (the bench), every observation adds
// into the same camera row: each thread first sums its track's camera
// contributions in registers, then the warp reduces before one lane adds
// (flush_cam_row). Float atomics make the camera sums order-dependent: the
// results vary run to run in the last bits.
//
// matvec16 computes the same S x as matvec from J packed to bf16 in the
// reference's pack_j_bf16 layout [9+NP, 2T, P]: plane k holds column k,
// rows 0..T-1 for residual x and T..2T-1 for residual y, so neighbouring
// threads still read neighbouring p. Each bf16 is widened to f32 exactly
// (its 16 bits are the high half of the f32) and everything accumulates in
// f32, as the reference's body does (J_ref[:].astype(jnp.float32)). Bound:
// bytes, and half the f32 kernel's J stream: 2 (9+NP) 2T P bytes of J16
// (54.5 MB at the bench shape), the two index grids (8.4 MB) and Vinv
// (3.1 MB), ~66 MB or ~0.020 ms at 3.35 TB/s. Design: the f32 kernel's,
// one thread per point column with the same scatters; like it, this first
// version reads J twice.
#include "ba_device.cuh"

constexpr int kImgRows = 33;  // 6 rhs | 6 diag(U) | 21 packed 6x6 block

template <int NP, bool SMEM>
__global__ void __launch_bounds__(BA_BLOCK)
prepare_kernel(const float* __restrict__ J, const float* __restrict__ res,
               const int* __restrict__ img_idx, const int* __restrict__ cam_idx,
               const float* __restrict__ lam_ptr, int T, int P, int I, int C,
               float* __restrict__ vinv, float* __restrict__ gpt,
               float* __restrict__ acc_img, float* __restrict__ acc_cam) {
  constexpr int NK = 6 + NP;
  constexpr int NJ = 9 + NP;
  extern __shared__ float smem[];
  float* aimg = SMEM ? smem : acc_img;
  float* acam = SMEM ? smem + I * kImgRows : acc_cam;
  const int n_img = I * kImgRows, n_cam = C * 2 * NP;
  if (SMEM) {
    for (int i = threadIdx.x; i < n_img + n_cam; i += BA_BLOCK) smem[i] = 0.f;
    __syncthreads();
  }
  const float lam = *lam_ptr;
  const size_t TP = (size_t)T * P;

  for (int base = blockIdx.x * BA_BLOCK; base < P; base += gridDim.x * BA_BLOCK) {
    const int p = base + threadIdx.x;
    int prow = -1;  // pending camera row of this thread
    float pend[2 * NP];
#pragma unroll
    for (int j = 0; j < 2 * NP; ++j) pend[j] = 0.f;
    if (p < P) {
      // --- point block, its damped inverse, and the point gradient ----------
      float V[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, g[3] = {0.f, 0.f, 0.f};
      for (int t = 0; t < T; ++t) {
        const size_t o = (size_t)t * P + p;
        float jp0[3], jp1[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          jp0[a] = J[(size_t)(NK + a) * TP + o];
          jp1[a] = J[(size_t)(NJ + NK + a) * TP + o];
        }
        const float r0 = res[o], r1 = res[TP + o];
        V[0] += jp0[0] * jp0[0] + jp1[0] * jp1[0];
        V[1] += jp0[0] * jp0[1] + jp1[0] * jp1[1];
        V[2] += jp0[0] * jp0[2] + jp1[0] * jp1[2];
        V[3] += jp0[1] * jp0[1] + jp1[1] * jp1[1];
        V[4] += jp0[1] * jp0[2] + jp1[1] * jp1[2];
        V[5] += jp0[2] * jp0[2] + jp1[2] * jp1[2];
#pragma unroll
        for (int a = 0; a < 3; ++a) g[a] += jp0[a] * r0 + jp1[a] * r1;
      }
      V[0] += lam * fmaxf(V[0], 1e-6f);
      V[3] += lam * fmaxf(V[3], 1e-6f);
      V[5] += lam * fmaxf(V[5], 1e-6f);
      const float a_ = V[0], b_ = V[1], c_ = V[2], d_ = V[3], e_ = V[4], f_ = V[5];
      const float iA = d_ * f_ - e_ * e_, iB = c_ * e_ - b_ * f_, iC = b_ * e_ - c_ * d_;
      float det = a_ * iA + b_ * iB + c_ * iC;
      det = fabsf(det) < 1e-12f ? 1e-12f : det;
      const float vi[6] = {iA / det, iB / det, iC / det, (a_ * f_ - c_ * c_) / det,
                           (b_ * c_ - a_ * e_) / det, (a_ * d_ - b_ * b_) / det};
#pragma unroll
      for (int k = 0; k < 6; ++k) vinv[(size_t)k * P + p] = vi[k];
#pragma unroll
      for (int a = 0; a < 3; ++a) gpt[(size_t)a * P + p] = g[a];
      const float z0[3] = {vi[0] * g[0] + vi[1] * g[1] + vi[2] * g[2],
                           vi[1] * g[0] + vi[3] * g[1] + vi[4] * g[2],
                           vi[2] * g[0] + vi[4] * g[1] + vi[5] * g[2]};

      // --- per-image and per-camera rows ----------------------------------
      for (int t = 0; t < T; ++t) {
        const size_t o = (size_t)t * P + p;
        float j0[NJ], j1[NJ];
        bool nz = false;
#pragma unroll
        for (int k = 0; k < NJ; ++k) {
          j0[k] = J[(size_t)k * TP + o];
          j1[k] = J[(size_t)(NJ + k) * TP + o];
          nz |= (j0[k] != 0.f) | (j1[k] != 0.f);
        }
        if (!nz) continue;  // padded slot: every contribution is zero
        const float rm0 = res[o] - (j0[NK] * z0[0] + j0[NK + 1] * z0[1] + j0[NK + 2] * z0[2]);
        const float rm1 = res[TP + o] - (j1[NK] * z0[0] + j1[NK + 1] * z0[1] + j1[NK + 2] * z0[2]);
        float vals[kImgRows];
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          vals[k] = j0[k] * rm0 + j1[k] * rm1;
          vals[6 + k] = j0[k] * j0[k] + j1[k] * j1[k];
        }
        float W[6][3], VW[6][3];
#pragma unroll
        for (int k = 0; k < 6; ++k) {
#pragma unroll
          for (int a = 0; a < 3; ++a) W[k][a] = j0[k] * j0[NK + a] + j1[k] * j1[NK + a];
          VW[k][0] = vi[0] * W[k][0] + vi[1] * W[k][1] + vi[2] * W[k][2];
          VW[k][1] = vi[1] * W[k][0] + vi[3] * W[k][1] + vi[4] * W[k][2];
          VW[k][2] = vi[2] * W[k][0] + vi[4] * W[k][1] + vi[5] * W[k][2];
        }
        int n = 12;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
#pragma unroll
          for (int j = i; j < 6; ++j) {
            vals[n++] = j0[i] * j0[j] + j1[i] * j1[j] -
                        (VW[i][0] * W[j][0] + VW[i][1] * W[j][1] + VW[i][2] * W[j][2]);
          }
        }
        scatter_row<kImgRows>(aimg, img_idx[o], kImgRows, vals);

        const int ci = cam_idx[o];
        if (ci != prow) {
          if (prow >= 0) scatter_row<2 * NP>(acam, prow, 2 * NP, pend);
          prow = ci;
#pragma unroll
          for (int j = 0; j < 2 * NP; ++j) pend[j] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          pend[j] += j0[6 + j] * rm0 + j1[6 + j] * rm1;
          pend[NP + j] += j0[6 + j] * j0[6 + j] + j1[6 + j] * j1[6 + j];
        }
      }
    }
    flush_cam_row<2 * NP>(acam, prow, 2 * NP, pend);
  }
  if (SMEM) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_img; i += BA_BLOCK)
      if (smem[i] != 0.f) atomicAdd(acc_img + i, smem[i]);
    for (int i = threadIdx.x; i < n_cam; i += BA_BLOCK)
      if (smem[n_img + i] != 0.f) atomicAdd(acc_cam + i, smem[n_img + i]);
  }
}

template <int NP, bool SMEM>
__global__ void __launch_bounds__(BA_BLOCK)
matvec_kernel(const float* __restrict__ J, const int* __restrict__ img_idx,
              const int* __restrict__ cam_idx, const float* __restrict__ vinv,
              const float* __restrict__ xpose, const float* __restrict__ xintr, int T,
              int P, int I, int C, float* __restrict__ out_pose,
              float* __restrict__ out_intr) {
  constexpr int NK = 6 + NP;
  constexpr int NJ = 9 + NP;
  extern __shared__ float smem[];
  float* apose = SMEM ? smem : out_pose;
  float* aintr = SMEM ? smem + I * 6 : out_intr;
  const int n_img = I * 6, n_cam = C * NP;
  if (SMEM) {
    for (int i = threadIdx.x; i < n_img + n_cam; i += BA_BLOCK) smem[i] = 0.f;
    __syncthreads();
  }
  const size_t TP = (size_t)T * P;

  for (int base = blockIdx.x * BA_BLOCK; base < P; base += gridDim.x * BA_BLOCK) {
    const int p = base + threadIdx.x;
    int prow = -1;
    float pend[NP];
#pragma unroll
    for (int j = 0; j < NP; ++j) pend[j] = 0.f;
    if (p < P) {
      // --- y = J_p^T J_c x summed over the track; z = Vinv y --------------
      float y[3] = {0.f, 0.f, 0.f};
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
          y[a] += J[(size_t)(NK + a) * TP + o] * a0 + J[(size_t)(NJ + NK + a) * TP + o] * a1;
      }
      const float va = vinv[p], vb = vinv[P + p], vc = vinv[2 * P + p];
      const float vd = vinv[3 * P + p], ve = vinv[4 * P + p], vf = vinv[5 * P + p];
      const float z[3] = {va * y[0] + vb * y[1] + vc * y[2], vb * y[0] + vd * y[1] + ve * y[2],
                          vc * y[0] + ve * y[1] + vf * y[2]};

      // --- d = a - J_p z; scatter J_c^T d -----------------------------------
      for (int t = 0; t < T; ++t) {
        const size_t o = (size_t)t * P + p;
        float j0[NJ], j1[NJ];
        bool nz = false;
#pragma unroll
        for (int k = 0; k < NJ; ++k) {
          j0[k] = J[(size_t)k * TP + o];
          j1[k] = J[(size_t)(NJ + k) * TP + o];
          nz |= (j0[k] != 0.f) | (j1[k] != 0.f);
        }
        if (!nz) continue;
        const int ii = img_idx[o], ci = cam_idx[o];
        float a0 = 0.f, a1 = 0.f;
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          const float xk = k < 6 ? __ldg(xpose + ii * 6 + k) : __ldg(xintr + ci * NP + k - 6);
          a0 += j0[k] * xk;
          a1 += j1[k] * xk;
        }
        const float d0 = a0 - (j0[NK] * z[0] + j0[NK + 1] * z[1] + j0[NK + 2] * z[2]);
        const float d1 = a1 - (j1[NK] * z[0] + j1[NK + 1] * z[1] + j1[NK + 2] * z[2]);
        float vals[6];
#pragma unroll
        for (int k = 0; k < 6; ++k) vals[k] = j0[k] * d0 + j1[k] * d1;
        scatter_row<6>(apose, ii, 6, vals);
        if (ci != prow) {
          if (prow >= 0) scatter_row<NP>(aintr, prow, NP, pend);
          prow = ci;
#pragma unroll
          for (int j = 0; j < NP; ++j) pend[j] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < NP; ++j) pend[j] += j0[6 + j] * d0 + j1[6 + j] * d1;
      }
    }
    flush_cam_row<NP>(aintr, prow, NP, pend);
  }
  if (SMEM) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_img; i += BA_BLOCK)
      if (smem[i] != 0.f) atomicAdd(out_pose + i, smem[i]);
    for (int i = threadIdx.x; i < n_cam; i += BA_BLOCK)
      if (smem[n_img + i] != 0.f) atomicAdd(out_intr + i, smem[n_img + i]);
  }
}

// bf16 -> f32, exact: a bf16 is the high half of an f32
__device__ __forceinline__ float bf16f(unsigned short b) {
  return __uint_as_float((unsigned)b << 16);
}

template <int NP, bool SMEM>
__global__ void __launch_bounds__(BA_BLOCK)
matvec16_kernel(const unsigned short* __restrict__ J16, const int* __restrict__ img_idx,
                const int* __restrict__ cam_idx, const float* __restrict__ vinv,
                const float* __restrict__ xpose, const float* __restrict__ xintr, int T,
                int P, int I, int C, float* __restrict__ out_pose,
                float* __restrict__ out_intr) {
  constexpr int NK = 6 + NP;
  constexpr int NJ = 9 + NP;
  extern __shared__ float smem[];
  float* apose = SMEM ? smem : out_pose;
  float* aintr = SMEM ? smem + I * 6 : out_intr;
  const int n_img = I * 6, n_cam = C * NP;
  if (SMEM) {
    for (int i = threadIdx.x; i < n_img + n_cam; i += BA_BLOCK) smem[i] = 0.f;
    __syncthreads();
  }
  const size_t TP = (size_t)T * P;
  const size_t plane = 2 * TP;  // one column of J16: [2T, P]

  for (int base = blockIdx.x * BA_BLOCK; base < P; base += gridDim.x * BA_BLOCK) {
    const int p = base + threadIdx.x;
    int prow = -1;
    float pend[NP];
#pragma unroll
    for (int j = 0; j < NP; ++j) pend[j] = 0.f;
    if (p < P) {
      // --- y = J_p^T J_c x summed over the track; z = Vinv y --------------
      float y[3] = {0.f, 0.f, 0.f};
      for (int t = 0; t < T; ++t) {
        const size_t o = (size_t)t * P + p;
        const int ii = img_idx[o], ci = cam_idx[o];
        float a0 = 0.f, a1 = 0.f;
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          const float xk = k < 6 ? __ldg(xpose + ii * 6 + k) : __ldg(xintr + ci * NP + k - 6);
          a0 += bf16f(J16[k * plane + o]) * xk;
          a1 += bf16f(J16[k * plane + TP + o]) * xk;
        }
#pragma unroll
        for (int a = 0; a < 3; ++a)
          y[a] += bf16f(J16[(NK + a) * plane + o]) * a0 +
                  bf16f(J16[(NK + a) * plane + TP + o]) * a1;
      }
      const float va = vinv[p], vb = vinv[P + p], vc = vinv[2 * P + p];
      const float vd = vinv[3 * P + p], ve = vinv[4 * P + p], vf = vinv[5 * P + p];
      const float z[3] = {va * y[0] + vb * y[1] + vc * y[2], vb * y[0] + vd * y[1] + ve * y[2],
                          vc * y[0] + ve * y[1] + vf * y[2]};

      // --- d = a - J_p z; scatter J_c^T d -----------------------------------
      for (int t = 0; t < T; ++t) {
        const size_t o = (size_t)t * P + p;
        float j0[NJ], j1[NJ];
        bool nz = false;
#pragma unroll
        for (int k = 0; k < NJ; ++k) {
          j0[k] = bf16f(J16[k * plane + o]);
          j1[k] = bf16f(J16[k * plane + TP + o]);
          nz |= (j0[k] != 0.f) | (j1[k] != 0.f);
        }
        if (!nz) continue;
        const int ii = img_idx[o], ci = cam_idx[o];
        float a0 = 0.f, a1 = 0.f;
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          const float xk = k < 6 ? __ldg(xpose + ii * 6 + k) : __ldg(xintr + ci * NP + k - 6);
          a0 += j0[k] * xk;
          a1 += j1[k] * xk;
        }
        const float d0 = a0 - (j0[NK] * z[0] + j0[NK + 1] * z[1] + j0[NK + 2] * z[2]);
        const float d1 = a1 - (j1[NK] * z[0] + j1[NK + 1] * z[1] + j1[NK + 2] * z[2]);
        float vals[6];
#pragma unroll
        for (int k = 0; k < 6; ++k) vals[k] = j0[k] * d0 + j1[k] * d1;
        scatter_row<6>(apose, ii, 6, vals);
        if (ci != prow) {
          if (prow >= 0) scatter_row<NP>(aintr, prow, NP, pend);
          prow = ci;
#pragma unroll
          for (int j = 0; j < NP; ++j) pend[j] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < NP; ++j) pend[j] += j0[6 + j] * d0 + j1[6 + j] * d1;
      }
    }
    flush_cam_row<NP>(aintr, prow, NP, pend);
  }
  if (SMEM) {
    __syncthreads();
    for (int i = threadIdx.x; i < n_img; i += BA_BLOCK)
      if (smem[i] != 0.f) atomicAdd(out_pose + i, smem[i]);
    for (int i = threadIdx.x; i < n_cam; i += BA_BLOCK)
      if (smem[n_img + i] != 0.f) atomicAdd(out_intr + i, smem[n_img + i]);
  }
}

// Grid of the scatter kernels: a few blocks per SM walk the columns, so the
// per-block flush of the accumulators stays small next to the column work.
static int scatter_blocks(int P) {
  const int need = (P + BA_BLOCK - 1) / BA_BLOCK;
  const int cap = 4 * ba_sm_count();
  return need < cap ? (need > 0 ? need : 1) : cap;
}

// Launch a kernel taking dynamic shared memory of `bytes` (0 for the
// global-atomic variant), raising the opt-in limit above 48 KB first.
template <class K, class... Args>
static int launch_smem(K kernel, int blocks, size_t bytes, cudaStream_t s, Args... args) {
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<blocks, BA_BLOCK, bytes, s>>>(args...);
  return (int)cudaGetLastError();
}

template <int NP>
static int prepare_np(const float* J, const float* res, const int* img_idx, const int* cam_idx,
                      const float* lam, int T, int P, int I, int C, float* vinv, float* gpt,
                      float* acc_img, float* acc_cam, cudaStream_t s) {
  const size_t bytes = (size_t)(I * kImgRows + C * 2 * NP) * sizeof(float);
  const int blocks = scatter_blocks(P);
  if (bytes <= BA_MAX_SMEM_BYTES)
    return launch_smem(prepare_kernel<NP, true>, blocks, bytes, s, J, res, img_idx, cam_idx,
                       lam, T, P, I, C, vinv, gpt, acc_img, acc_cam);
  return launch_smem(prepare_kernel<NP, false>, blocks, 0, s, J, res, img_idx, cam_idx, lam, T,
                     P, I, C, vinv, gpt, acc_img, acc_cam);
}

template <int NP>
static int matvec_np(const float* J, const int* img_idx, const int* cam_idx, const float* vinv,
                     const float* xpose, const float* xintr, int T, int P, int I, int C,
                     float* out_pose, float* out_intr, cudaStream_t s) {
  const size_t bytes = (size_t)(I * 6 + C * NP) * sizeof(float);
  const int blocks = scatter_blocks(P);
  if (bytes <= BA_MAX_SMEM_BYTES)
    return launch_smem(matvec_kernel<NP, true>, blocks, bytes, s, J, img_idx, cam_idx, vinv,
                       xpose, xintr, T, P, I, C, out_pose, out_intr);
  return launch_smem(matvec_kernel<NP, false>, blocks, 0, s, J, img_idx, cam_idx, vinv, xpose,
                     xintr, T, P, I, C, out_pose, out_intr);
}

template <int NP>
static int matvec16_np(const unsigned short* J16, const int* img_idx, const int* cam_idx,
                       const float* vinv, const float* xpose, const float* xintr, int T, int P,
                       int I, int C, float* out_pose, float* out_intr, cudaStream_t s) {
  const size_t bytes = (size_t)(I * 6 + C * NP) * sizeof(float);
  const int blocks = scatter_blocks(P);
  if (bytes <= BA_MAX_SMEM_BYTES)
    return launch_smem(matvec16_kernel<NP, true>, blocks, bytes, s, J16, img_idx, cam_idx, vinv,
                       xpose, xintr, T, P, I, C, out_pose, out_intr);
  return launch_smem(matvec16_kernel<NP, false>, blocks, 0, s, J16, img_idx, cam_idx, vinv,
                     xpose, xintr, T, P, I, C, out_pose, out_intr);
}

// the single-model widths (3 4 5 8 12) and the mixed ones (4 5 6 9 13: the
// widest listed model's count plus the selector column)
#define BA_FOR_EACH_NP(X) X(3) X(4) X(5) X(6) X(8) X(9) X(12) X(13)

BA_DEFINE_ERROR_STRING

// acc_img [I, 33] and acc_cam [C, 2 NP] accumulate: the caller zeroes them
// once and passes them to every bucket's launch.
extern "C" int ba_prepare(int np, const float* J, const float* res, const int* img_idx,
                          const int* cam_idx, const float* lam, int T, int P, int I, int C,
                          float* vinv, float* gpt, float* acc_img, float* acc_cam,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (np) {
#define X(N)                                                                                \
  case N:                                                                                   \
    return prepare_np<N>(J, res, img_idx, cam_idx, lam, T, P, I, C, vinv, gpt, acc_img, \
                         acc_cam, s);
    BA_FOR_EACH_NP(X)
#undef X
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// out_pose [I, 6] and out_intr [C, NP] accumulate across buckets likewise.
extern "C" int ba_matvec(int np, const float* J, const int* img_idx, const int* cam_idx,
                         const float* vinv, const float* xpose, const float* xintr, int T, int P,
                         int I, int C, float* out_pose, float* out_intr, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (np) {
#define X(N)                                                                            \
  case N:                                                                               \
    return matvec_np<N>(J, img_idx, cam_idx, vinv, xpose, xintr, T, P, I, C, out_pose, \
                        out_intr, s);
    BA_FOR_EACH_NP(X)
#undef X
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// J16 [9+NP, 2T, P] bf16 (passed as its raw 16-bit words); otherwise as
// ba_matvec.
extern "C" int ba_matvec16(int np, const unsigned short* J16, const int* img_idx,
                           const int* cam_idx, const float* vinv, const float* xpose,
                           const float* xintr, int T, int P, int I, int C, float* out_pose,
                           float* out_intr, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (np) {
#define X(N)                                                                              \
  case N:                                                                                 \
    return matvec16_np<N>(J16, img_idx, cam_idx, vinv, xpose, xintr, T, P, I, C, out_pose, \
                          out_intr, s);
    BA_FOR_EACH_NP(X)
#undef X
    default:
      return (int)cudaErrorInvalidValue;
  }
}
