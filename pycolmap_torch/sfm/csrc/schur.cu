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
// rows 0..T-1 for residual x and T..2T-1 for residual y. Each bf16 is
// widened to f32 exactly (its 16 bits are the high half of the f32) and
// everything accumulates in f32, as the reference's body does
// (J_ref[:].astype(jnp.float32)). Bound: bytes, each read once: J16
// (2 (9+NP) 2T P bytes, 54.5 MB at the bench shape), the two index grids
// (8.4 MB), Vinv (3.1 MB), x in and S x out: ~66 MB or ~0.020 ms at
// 3.35 TB/s. The first port read J16 twice with 2-byte loads, gathered x
// from global memory per slot, launched once per bucket and flushed each
// of 528 blocks with global atomics into zeroed outputs.
// Design (this version):
// - one launch per call over a table of all buckets (passed by value, built
//   once per LM step by cg_kernel.py); a bucket's columns are cut into tiles
//   of T tile_p <= 256 slots (tile_p 64 at T = 4, 32 at T = 8, 4 at the
//   ladder's longest T = 64), and each block of a persistent grid (up to 8
//   per SM) takes a contiguous run of tiles;
// - each tile (J16 [9+NP, 2T, tile_p], both index grids and Vinv) arrives
//   in shared memory by cp.async, 16 bytes a copy, into one of two stages:
//   the next tile's copy runs under this tile's two passes, and both passes
//   read the staged copy, so J16 is read from memory once. (One TMA bulk
//   copy per 128-byte row fetched the bench's tiles at ~0.7 TB/s and lost
//   to the first port; larger tiles or a third stage lowered the blocks per
//   SM and lost more than they gained.)
// - a thread keeps its slots' indices and J_c x in registers for the
//   second pass; in the per-warp mode below, x is copied into shared
//   memory once per block;
// - lanes sharing a row hand their values to the lowest of them in lane
//   order (warp_scatter), so one lane per distinct row adds, and an
//   atomic add skips a zero (a fixed parameter's column: with one camera
//   these doubled the atomics on its row). Per-warp mode: each warp adds
//   into its own shared accumulator without atomics; the blocks of an
//   8-block cluster add their warps' sums through distributed shared
//   memory in (rank, warp) order, each cluster writes one partial row, and
//   the last cluster to take the ticket adds the rows in cluster order
//   into the outputs. The outputs need no zeroing, no global atomics
//   remain, and S x is the same to the bit from run to run. The other
//   modes add with float atomics.
// - where x and the sums live follows from the shared memory they take
//   (mv16_pick): the first mode that leaves 16 resident warps per SM. The
//   per-warp sums above (blocks of 128 threads) fit 4 blocks per SM up to
//   I 6 + C NP of ~940 floats at NP 4 (about 150 images with one camera:
//   the bench). Next, as the first port did, one shared accumulator per
//   block of 256 threads (shared atomics, one flush of its nonzero entries
//   into zeroed outputs by global atomics, x read from global memory) fits
//   2 blocks per SM up to ~18,900 floats (about 3,100 images). Above that,
//   global atomics. Only the per-warp mode is bit-reproducible.
//   On the H100 the per-warp mode at 3 blocks per SM lost to the block's
//   sums (256 and 1,024 images), and the block's sums at 1 block per SM
//   lost to global atomics (5,120): too few tiles were in flight.
// What still bounds it: the reads of J16 rows 64 bytes at a time from 208
// rows 256 KB apart run at ~1.2-1.3 TB/s on the H100 (a fetch-only variant
// of this kernel, and the first port at the same rate reading J16 twice);
// a tile-contiguous J16 layout would stream.
#include <cooperative_groups.h>

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

// ---------------------------------------------------------------------------
// matvec16: one launch over every bucket, J16 read once through shared memory
// ---------------------------------------------------------------------------

namespace cg = cooperative_groups;

constexpr int kMv16Slots = 256;       // track slots (T x columns) per tile
constexpr int kMv16MaxT = 64;         // the longest bucket: 4-column tiles
constexpr int kMv16MaxBuckets = 8;
constexpr int kMv16Cluster = 8;       // blocks whose sums meet in DSMEM
constexpr int kMv16MaxPerSm = 8;      // resident blocks per SM the grid takes
constexpr int kMv16Stages = 2;        // tiles in shared memory per block

// Where a matvec16 launch keeps x and its sums (mv16_pick chooses): x and
// one accumulator per warp in shared memory,
// summed in a fixed order; one shared accumulator per block (shared
// atomics) flushed by global atomics; global atomics per slot.
enum Mv16Sums { kMv16SumsGlobal = 0, kMv16SumsBlock = 1, kMv16SumsWarps = 2 };
constexpr int kMv16MinWarps = 16;  // resident warps per SM a mode must leave

// Threads per block: 256 for the block's shared sums (its shared memory
// per thread halves and it ran faster at 256 on the H100), 128 otherwise
// (the per-warp sums cost shared memory per warp; the global atomics ran
// faster at 128).
__host__ __device__ constexpr int mv16_threads(int sums) {
  return sums == kMv16SumsBlock ? 256 : 128;
}

// One row of the bucket table (sfm/_cuda.py _Mv16Bucket): the bucket's
// operands, its T and P (P % 8 == 0), its tile width and its first tile.
struct Mv16Bucket {
  const unsigned short* J16;  // [9+NP, 2T, P] bf16
  const int* img;             // [T, P]
  const int* cam;             // [T, P]
  const float* vinv;          // [6, P]
  int T, P, tile_p, first_tile;
};

struct Mv16Table {
  Mv16Bucket b[kMv16MaxBuckets];
  int nb, n_tiles;
};

// A stage holds one tile: J16 [9+NP, 2T, tile_p] bf16, then img and cam
// [T, tile_p] and Vinv [6, tile_p]; T tile_p <= kMv16Slots bounds it.
__host__ __device__ constexpr size_t mv16_stage_bytes(int nj) {
  return (size_t)nj * 2 * kMv16Slots * 2 + 2 * kMv16Slots * 4 + 6 * 128 * 4;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ int mv16_bucket(const Mv16Table& tab, int tile) {
  int bi = 0;
  while (bi + 1 < tab.nb && tile >= tab.b[bi + 1].first_tile) ++bi;
  return bi;
}

// The block puts one tile in flight, 16 bytes a thread and copy (8 for
// J16 in 4-column tiles): NJ 2T rows of J16, T of img and of cam, 6 of
// Vinv, each tile_p columns wide (fewer at a bucket's edge).
template <int NJ, int NT>
__device__ void mv16_fetch(const Mv16Table& tab, int tile, unsigned char* st) {
  const Mv16Bucket& B = tab.b[mv16_bucket(tab, tile)];
  const int T = B.T, P = B.P, TP = B.tile_p;
  const int p0 = (tile - B.first_tile) * TP;
  const int ncol = min(TP, P - p0);
  const int lg = __ffs(TP) - 1;  // tile_p is a power of two
  const int je = lg < 3 ? 2 : 3;  // log2 of the J16 values a copy moves
  const int nj = (NJ * 2 * T) << (lg - je), ni = (2 * T + 6) << (lg - 2);
  unsigned short* sJ = reinterpret_cast<unsigned short*>(st);
  int* sIdx = reinterpret_cast<int*>(st + (size_t)NJ * 2 * T * TP * 2);
  float* sV = reinterpret_cast<float*>(sIdx + 2 * T * TP);
  for (int q = threadIdx.x; q < nj + ni; q += NT) {
    if (q < nj) {  // J16
      const int r = q >> (lg - je), c = (q & ((TP >> je) - 1)) << je;
      if (c >= ncol) continue;
      if (je == 3)
        cp_async16(sJ + r * TP + c, B.J16 + (size_t)r * P + p0 + c);
      else
        cp_async8(sJ + r * TP + c, B.J16 + (size_t)r * P + p0 + c);
    } else {  // img, cam, Vinv: 4 values a copy
      const int q2 = q - nj, r = q2 >> (lg - 2), c = (q2 & ((TP >> 2) - 1)) << 2;
      if (c >= ncol) continue;
      if (r < 2 * T)
        cp_async16(sIdx + r * TP + c,
                   (r < T ? B.img + (size_t)r * P : B.cam + (size_t)(r - T) * P) + p0 + c);
      else
        cp_async16(sV + (r - 2 * T) * TP + c, B.vinv + (size_t)(r - 2 * T) * P + p0 + c);
    }
  }
}

// Add each lane's N values into row `row` (< 0: none) of an accumulator:
// the lanes sharing a row hand their values to the lowest of them, which
// adds them in lane order, so one lane per distinct row adds; when every
// lane with a row has the same one (a camera row, mostly), the warp adds
// by the xor tree of warp_sum, the other lanes giving zeros. The order
// depends only on the rows. ATOMIC false: the warp's own accumulator,
// plain adds; true: one shared by other warps or blocks, float atomics.
// All 32 lanes must call it.
template <int N, bool ATOMIC>
__device__ __forceinline__ void warp_scatter(float* acc, int row, int stride,
                                             const float* vals) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const unsigned rows = __ballot_sync(full, row >= 0);
  if (rows == 0u) return;
  const int first = __shfl_sync(full, row, __ffs(rows) - 1);
  float v[N];
  int dst = row;
  bool adds;
  if (__all_sync(full, row < 0 || row == first)) {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = warp_sum(row >= 0 ? vals[k] : 0.f);
    dst = first;
    adds = lane == 0;
  } else {
    const unsigned peers = __match_any_sync(full, row);
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = vals[k];
    adds = row >= 0 && __ffs(peers) - 1 == lane;
    unsigned todo = adds ? peers & (peers - 1) : 0u;  // the group's other lanes
    while (__any_sync(full, todo != 0u)) {
      const int src = todo ? __ffs(todo) - 1 : lane;
#pragma unroll
      for (int k = 0; k < N; ++k) {
        const float o = __shfl_sync(full, vals[k], src);
        if (todo) v[k] += o;
      }
      todo &= todo - 1u;
    }
  }
  if (adds) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (!ATOMIC)
        acc[dst * stride + k] += v[k];
      else if (v[k] != 0.f)  // a fixed parameter's zero column: no atomic
        atomicAdd(acc + dst * stride + k, v[k]);
    }
  }
}

// S x for every bucket of the table. kMv16SumsWarps: x lives in shared
// memory and each warp sums into its own shared accumulator without
// atomics; the blocks of a cluster add their warps' sums through DSMEM in
// (rank, warp) order, and the last cluster adds the clusters' partial rows
// in cluster order into the outputs (which need no zeroing): S x is the
// same to the bit from run to run. Otherwise x is read from global memory
// and the sums are float atomics, into a block's shared accumulator that
// is flushed into the outputs (kMv16SumsBlock) or into the outputs
// (kMv16SumsGlobal); the caller zeroes the outputs.
template <int NP, int SUMS>
__global__ void __launch_bounds__(mv16_threads(SUMS))
matvec16_kernel(const __grid_constant__ Mv16Table tab, const float* __restrict__ xpose,
                const float* __restrict__ xintr, int I, int C, float* __restrict__ partials,
                int* __restrict__ ticket, float* __restrict__ out_pose,
                float* __restrict__ out_intr) {
  constexpr int NK = 6 + NP;
  constexpr int NJ = 9 + NP;
  constexpr int NT = mv16_threads(SUMS);
  constexpr int W = NT / 32;
  constexpr int MAX_S = kMv16Slots / NT;  // slots per thread
  constexpr size_t kStage = mv16_stage_bytes(NJ);
  extern __shared__ __align__(128) unsigned char mv16_smem[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int n_acc = I * 6 + C * NP;
  float* ybuf = reinterpret_cast<float*>(mv16_smem + kMv16Stages * kStage);  // [G, tile_p, 3]
  constexpr bool kWarps = SUMS == kMv16SumsWarps;
  float* xs = ybuf + NT * 3;      // kWarps: x [n_acc]
  float* acc = kWarps ? xs + n_acc : xs;  // kWarps: [W, n_acc]; kMv16SumsBlock: [n_acc]
  const float* xp = kWarps ? xs : xpose;
  const float* xi = kWarps ? xs + I * 6 : xintr;
  float* apose = SUMS == kMv16SumsGlobal ? out_pose : acc + (kWarps ? warp * n_acc : 0);
  float* aintr = SUMS == kMv16SumsGlobal ? out_intr : apose + I * 6;
  if (kWarps)
    for (int i = tid; i < n_acc; i += NT) xs[i] = i < I * 6 ? xpose[i] : xintr[i - I * 6];
  if (SUMS != kMv16SumsGlobal)
    for (int i = tid; i < (kWarps ? W : 1) * n_acc; i += NT) acc[i] = 0.f;

  // a block takes a contiguous run of tiles (the next ones continue each
  // J16 row where the last ones ended); the next kMv16Stages - 1 are in
  // flight while one is computed
  const int per = (tab.n_tiles + gridDim.x - 1) / gridDim.x;
  const int end = min((blockIdx.x + 1) * per, tab.n_tiles);
  int tile = blockIdx.x * per;
#pragma unroll
  for (int k = 0; k < kMv16Stages - 1; ++k) {
    if (tile + k < end) mv16_fetch<NJ, NT>(tab, tile + k, mv16_smem + k * kStage);
    cp_async_commit();
  }
  for (int it = 0; tile < end; ++it, ++tile) {
    // the stage refilled here was last read before the __syncthreads that
    // ended the previous tile
    const int ahead = tile + kMv16Stages - 1;
    if (ahead < end)
      mv16_fetch<NJ, NT>(tab, ahead, mv16_smem + ((it + kMv16Stages - 1) % kMv16Stages) * kStage);
    cp_async_commit();
    cp_async_wait<kMv16Stages - 1>();  // this thread's copies of this tile are in
    __syncthreads();                   // and every thread's
    const unsigned char* st = mv16_smem + (it % kMv16Stages) * kStage;

    const Mv16Bucket& B = tab.b[mv16_bucket(tab, tile)];
    const int T = B.T, TP = B.tile_p;
    const int lg = __ffs(TP) - 1;
    const int p0 = (tile - B.first_tile) * TP;
    const int G = NT >> lg;  // thread groups: group g takes slots g, g+G, ...
    const int p = tid & (TP - 1), g = tid >> lg;
    const bool on = p0 + p < B.P;
    const int rs = 2 * T * TP;  // elements from one J column to the next
    const unsigned short* sJ = reinterpret_cast<const unsigned short*>(st);
    const int* sImg = reinterpret_cast<const int*>(st + (size_t)NJ * rs * 2);
    const int* sCam = sImg + T * TP;
    const float* sV = reinterpret_cast<const float*>(sCam + T * TP);

    // --- pass 1: a = J_c x per slot, y = J_p^T a over the track ----------
    int ii[MAX_S], ci[MAX_S];
    float a0[MAX_S], a1[MAX_S];
    float y[3] = {0.f, 0.f, 0.f};
#pragma unroll
    for (int s = 0; s < MAX_S; ++s) {
      const int t = g + s * G;
      ii[s] = -1;
      ci[s] = -1;
      a0[s] = 0.f;
      a1[s] = 0.f;
      if (on && t < T) {
        const unsigned short* c0 = sJ + t * TP + p;  // column 0, residual x
        const unsigned short* c1 = c0 + T * TP;      // residual y
        ii[s] = sImg[t * TP + p];
        ci[s] = sCam[t * TP + p];
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          const float xk = k < 6 ? xp[ii[s] * 6 + k] : xi[ci[s] * NP + k - 6];
          s0 += bf16f(c0[k * rs]) * xk;
          s1 += bf16f(c1[k * rs]) * xk;
        }
        a0[s] = s0;
        a1[s] = s1;
#pragma unroll
        for (int a = 0; a < 3; ++a)
          y[a] += bf16f(c0[(NK + a) * rs]) * s0 + bf16f(c1[(NK + a) * rs]) * s1;
      }
    }
    if (G > 1) {  // the groups' sums, added in group order
#pragma unroll
      for (int a = 0; a < 3; ++a) ybuf[tid * 3 + a] = y[a];
      __syncthreads();
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        y[a] = 0.f;
        for (int h = 0; h < G; ++h) y[a] += ybuf[((h << lg) + p) * 3 + a];
      }
    }
    float z[3] = {0.f, 0.f, 0.f};
    if (on) {
      const float va = sV[p], vb = sV[TP + p], vc = sV[2 * TP + p];
      const float vd = sV[3 * TP + p], ve = sV[4 * TP + p], vf = sV[5 * TP + p];
      z[0] = va * y[0] + vb * y[1] + vc * y[2];
      z[1] = vb * y[0] + vd * y[1] + ve * y[2];
      z[2] = vc * y[0] + ve * y[1] + vf * y[2];
    }

    // --- pass 2: d = a - J_p z; scatter J_c^T d ---------------------------
    int prow = -1;  // the camera row whose sums this thread holds
    float pend[NP];
#pragma unroll
    for (int j = 0; j < NP; ++j) pend[j] = 0.f;
#pragma unroll
    for (int s = 0; s < MAX_S; ++s) {
      const int t = g + s * G;
      float d0 = 0.f, d1 = 0.f, vals[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      const unsigned short* c0 = sJ + t * TP + p;
      const unsigned short* c1 = c0 + T * TP;
      if (ii[s] >= 0) {
        d0 = a0[s] - (bf16f(c0[NK * rs]) * z[0] + bf16f(c0[(NK + 1) * rs]) * z[1] +
                      bf16f(c0[(NK + 2) * rs]) * z[2]);
        d1 = a1[s] - (bf16f(c1[NK * rs]) * z[0] + bf16f(c1[(NK + 1) * rs]) * z[1] +
                      bf16f(c1[(NK + 2) * rs]) * z[2]);
#pragma unroll
        for (int k = 0; k < 6; ++k) vals[k] = bf16f(c0[k * rs]) * d0 + bf16f(c1[k * rs]) * d1;
      }
      // a padded slot (all-zero J) has d = 0 and adds nothing
      const bool live = ii[s] >= 0 && (d0 != 0.f || d1 != 0.f);
      warp_scatter<6, !kWarps>(apose, live ? ii[s] : -1, 6, vals);
      const bool flush = live && prow >= 0 && ci[s] != prow;
      if (__any_sync(0xffffffffu, flush)) {
        warp_scatter<NP, !kWarps>(aintr, flush ? prow : -1, NP, pend);
        if (flush) {
#pragma unroll
          for (int j = 0; j < NP; ++j) pend[j] = 0.f;
        }
      }
      if (live) {
        prow = ci[s];
#pragma unroll
        for (int j = 0; j < NP; ++j)
          pend[j] += bf16f(c0[(6 + j) * rs]) * d0 + bf16f(c1[(6 + j) * rs]) * d1;
      }
    }
    warp_scatter<NP, !kWarps>(aintr, prow, NP, pend);
    __syncthreads();  // the stage and ybuf are free again
  }

  if constexpr (SUMS == kMv16SumsBlock) {
    // the block's nonzero sums into the outputs (the loop ended with a
    // __syncthreads; a thread with no tile reads back only its own zeros)
    for (int i = tid; i < n_acc; i += NT)
      if (acc[i] != 0.f) atomicAdd(i < I * 6 ? out_pose + i : out_intr + i - I * 6, acc[i]);
  }
  if constexpr (kWarps) {
    // --- the cluster's sums, then the last cluster's sum of all ----------
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();  // every block's sums are complete
    const int cs = (int)cl.num_blocks(), rank = (int)cl.block_rank();
    const int cid = blockIdx.x / cs, ncl = gridDim.x / cs;
    for (int i = rank * NT + tid; i < n_acc; i += cs * NT) {
      float part[kMv16Cluster * W];  // loaded together, added in (rank, warp) order
#pragma unroll
      for (int r = 0; r < kMv16Cluster; ++r) {
        const float* racc = cl.map_shared_rank(acc, r < cs ? r : 0);
#pragma unroll
        for (int w = 0; w < W; ++w) part[r * W + w] = r < cs ? racc[w * n_acc + i] : 0.f;
      }
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < kMv16Cluster * W; ++k) v += part[k];
      partials[(size_t)cid * n_acc + i] = v;
    }
    __threadfence();
    __shared__ int last;
    cl.sync();  // the cluster's partial row is written and fenced
    if (rank == 0 && tid == 0) last = atomicAdd(ticket, 1) == ncl - 1;
    cl.sync();
    const bool is_last = *cl.map_shared_rank(&last, 0);
    cl.sync();  // rank 0's flag is read before any block leaves
    if (is_last) {
      __threadfence();
      for (int i = rank * NT + tid; i < n_acc; i += cs * NT) {
        // rows loaded 32 at a time, added in cluster order
        float v = 0.f;
        for (int c0 = 0; c0 < ncl; c0 += 32) {
          float row[32];
#pragma unroll
          for (int c = 0; c < 32; ++c)
            row[c] = c0 + c < ncl ? __ldcg(partials + (size_t)(c0 + c) * n_acc + i) : 0.f;
#pragma unroll
          for (int c = 0; c < 32; ++c) v += row[c];
        }
        if (i < I * 6)
          out_pose[i] = v;
        else
          out_intr[i - I * 6] = v;
      }
      if (rank == 0 && tid == 0) *ticket = 0;  // ready for the next launch
    }
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
static auto mv16_kernel_of(int sums) {
  return sums == kMv16SumsWarps   ? &matvec16_kernel<NP, kMv16SumsWarps>
         : sums == kMv16SumsBlock ? &matvec16_kernel<NP, kMv16SumsBlock>
                                  : &matvec16_kernel<NP, kMv16SumsGlobal>;
}

// A matvec16 block's dynamic shared memory in mode `sums` and its resident
// blocks per SM (at most kMv16MaxPerSm), raising the kernel's opt-in limit
// to it; cudaErrorInvalidValue if it exceeds the card's opt-in shared
// memory. The answer is kept per kernel and size.
template <int NP>
static int mv16_config(int I, int C, int sums, size_t* bytes, int* per_sm) {
  constexpr int NJ = 9 + NP;
  const size_t n_acc = (size_t)I * 6 + (size_t)C * NP;
  const int nt = mv16_threads(sums);
  const size_t acc_floats = sums == kMv16SumsWarps   ? (1 + nt / 32) * n_acc
                            : sums == kMv16SumsBlock ? n_acc
                                                     : 0;
  *bytes = kMv16Stages * mv16_stage_bytes(NJ) + nt * 3 * sizeof(float) +
           acc_floats * sizeof(float);
  auto kernel = mv16_kernel_of<NP>(sums);
  static size_t known_bytes[3] = {0, 0, 0};
  static int known_per_sm[3] = {0, 0, 0};
  if (known_bytes[sums] != *bytes) {
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (*bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
    if (e != cudaSuccess) return (int)e;
    int n = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, nt, *bytes);
    if (e != cudaSuccess) return (int)e;
    if (n < 1) return (int)cudaErrorInvalidConfiguration;
    known_per_sm[sums] = n < kMv16MaxPerSm ? n : kMv16MaxPerSm;
    known_bytes[sums] = *bytes;
  }
  *per_sm = known_per_sm[sums];
  return 0;
}

// The mode of a launch at I images and C cameras: the per-warp sums, else
// the block's sums, whichever first leaves kMv16MinWarps resident warps
// per SM, else global atomics. (On the H100 the shared modes ran slower
// than global atomics below that: their shared memory left too few blocks
// to keep the tiles' copies in flight.)
template <int NP>
static int mv16_pick(int I, int C, int* sums, size_t* bytes, int* per_sm) {
  for (int m = kMv16SumsWarps; m > kMv16SumsGlobal; --m) {
    const int err = mv16_config<NP>(I, C, m, bytes, per_sm);
    if (err && err != (int)cudaErrorInvalidValue) return err;
    if (!err && *per_sm * mv16_threads(m) / 32 >= kMv16MinWarps) {
      *sums = m;
      return 0;
    }
  }
  *sums = kMv16SumsGlobal;
  return mv16_config<NP>(I, C, kMv16SumsGlobal, bytes, per_sm);
}

// Launch matvec16 over a bucket table: a persistent grid of the resident
// blocks (a multiple of the cluster size in the per-warp mode), each
// taking a contiguous run of tiles.
template <int NP>
static int matvec16_np(const Mv16Table& tab, const float* xpose, const float* xintr, int I,
                       int C, int sums, float* partials, int max_clusters, int* ticket,
                       float* out_pose, float* out_intr, cudaStream_t s) {
  size_t bytes = 0;
  int per_sm = 0;
  const int err = mv16_config<NP>(I, C, sums, &bytes, &per_sm);
  if (err) return err;
  const bool warps = sums == kMv16SumsWarps;
  const int cs = warps ? kMv16Cluster : 1;
  int blocks = ba_sm_count() * per_sm;
  if (blocks > tab.n_tiles) blocks = tab.n_tiles;
  if (warps && blocks > max_clusters * cs) blocks = max_clusters * cs;
  blocks = blocks / cs * cs;
  if (blocks < cs) blocks = cs;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(mv16_threads(sums));
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, mv16_kernel_of<NP>(sums), tab, xpose, xintr, I, C,
                                     partials, ticket, out_pose, out_intr);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// The table's contract (cg_kernel.py matvec16_table): 1-8 buckets in tile
// order, T <= 64, tile_p a power of two from 4 to 128 with T tile_p <= 256,
// P a multiple of 8, every operand 16-byte aligned.
static bool mv16_table_ok(const Mv16Table& tab) {
  if (tab.nb < 1 || tab.nb > kMv16MaxBuckets || tab.n_tiles < 1) return false;
  int first = 0;
  for (int i = 0; i < tab.nb; ++i) {
    const Mv16Bucket& b = tab.b[i];
    if (b.T < 1 || b.T > kMv16MaxT || b.P < 0 || b.P % 8 || b.tile_p < 4 || b.tile_p > 128 ||
        (b.tile_p & (b.tile_p - 1)) ||
        b.T * b.tile_p > kMv16Slots || b.first_tile != first)
      return false;
    for (const void* q : {(const void*)b.J16, (const void*)b.img, (const void*)b.cam,
                          (const void*)b.vinv})
      if ((size_t)q % 16) return false;
    first += (b.P + b.tile_p - 1) / b.tile_p;
  }
  return first == tab.n_tiles;
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

// One launch of the bf16 matvec over the bucket table `tab`, with x and
// the sums where `sums` says (ba_matvec16_config's answer). kMv16SumsWarps:
// out_pose [I, 6] and out_intr [C, NP] are written whole (no zeroing);
// partials holds max_clusters rows of I 6 + C NP floats and ticket one int
// that is 0 before the launch and after it. Otherwise the outputs
// accumulate, zeroed by the caller; partials and ticket are unused.
extern "C" int ba_matvec16(int np, const Mv16Table* tab, const float* xpose,
                           const float* xintr, int I, int C, int sums, float* partials,
                           int max_clusters, int* ticket, float* out_pose, float* out_intr,
                           void* stream) {
  if (!mv16_table_ok(*tab) || sums < kMv16SumsGlobal || sums > kMv16SumsWarps ||
      (sums == kMv16SumsWarps && (!partials || !ticket || max_clusters < 1)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (np) {
#define X(N)                                                                             \
  case N:                                                                                \
    return matvec16_np<N>(*tab, xpose, xintr, I, C, sums, partials, max_clusters, ticket, \
                          out_pose, out_intr, s);
    BA_FOR_EACH_NP(X)
#undef X
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The mode of a matvec16 launch at width np with I images and C cameras
// (mv16_pick), its dynamic shared memory and resident blocks per SM (the
// stream is unused).
extern "C" int ba_matvec16_config(int np, int I, int C, int* sums, int* bytes,
                                  int* blocks_per_sm, void*) {
  size_t b = 0;
  int err = (int)cudaErrorInvalidValue;
  switch (np) {
#define X(N)                                              \
  case N:                                                 \
    err = mv16_pick<N>(I, C, sums, &b, blocks_per_sm);    \
    break;
    BA_FOR_EACH_NP(X)
#undef X
    default:
      break;
  }
  *bytes = (int)b;
  return err;
}
