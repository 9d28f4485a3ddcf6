// Fused descriptor similarity + running top-2 per query (brute-force
// matcher): the N1 x N2 similarity matrix never reaches device memory.
//
// Replaces: pycolmap_tpu/features/pallas_kernels.py _pallas_top2_impl (:82;
// pallas_call :87, body _top2_kernel :28) and its vmapped batch form
// pallas_top2_batch (:112).
//
// Contract: d1 [B, N1, D], d2 [B, N2, D] f32 (D a multiple of 4), n2 [B]
// int32. For every row r of pair b over the columns c < N2, with
// sim = <d1[b, r], d2[b, c]> where c < n2[b] and -2.0 where not:
// best[b, r] = max sim, idx[b, r] = its lowest column, second[b, r] = the
// largest sim of any other column (an exact duplicate of the best gives
// second == best). The running state starts at (-2, -2, 0), as the
// reference's does, so a row with no valid column gives (-2, -2, 0).
//
// Bound: operations. 2 N1 N2 D flops per pair against reads of
// (N1 + N2) D floats: 17.2 GFLOP and 8.4 MB at 8192 x 8192 x 128, i.e.
// 0.256 ms at 67 TFLOP/s in f32 (no tensor cores here) vs 2.5 us of HBM.
//
// Design: one block of 256 threads per (pair, 64-row tile) walks all
// column tiles of 128. Per tile, the product runs over D in chunks of 32
// held in shared memory, transposed (k-major) so each thread reads its 4
// rows and 8 columns as float4s; each thread keeps a 4 x 8 register tile of
// f32 FMAs (no tensor cores, no library GEMM). A warp covers 4 row groups x
// 8 column groups, so a k step costs it three shared-memory wavefronts
// against 32 FMAs per thread. The tile's epilogue folds the 32 sums into
// per-row (best, second, idx) registers; at the end the 16 threads sharing
// a row merge their states through shared memory.
#include <cuda_runtime.h>

namespace {

constexpr int TM = 64;   // rows per block
constexpr int TN = 128;  // columns per tile
constexpr int KC = 32;   // depth per shared-memory chunk
constexpr int kThreads = 256;
constexpr int RM = 4;    // rows per thread
constexpr int RN = 8;    // columns per thread: 4 at tx*4, 4 at 64 + tx*4
constexpr int kGroups = 16;  // threads sharing a row

struct Top2 {
  float best, second;
  int idx;
};

__device__ __forceinline__ void push(Top2& t, float v, int c) {
  if (v > t.best || (v == t.best && c < t.idx)) {
    t.second = t.best;
    t.best = v;
    t.idx = c;
  } else {
    t.second = fmaxf(t.second, v);
  }
}

__device__ __forceinline__ void merge(Top2& t, const Top2& u) {
  const bool u_wins = u.best > t.best || (u.best == t.best && u.idx < t.idx);
  const float loser = u_wins ? t.best : u.best;
  t.second = fmaxf(loser, fmaxf(t.second, u.second));
  if (u_wins) {
    t.best = u.best;
    t.idx = u.idx;
  }
}

__global__ void __launch_bounds__(kThreads)
top2_kernel(const float* __restrict__ d1, const float* __restrict__ d2,
            const int* __restrict__ n2, int N1, int N2, int D,
            float* __restrict__ best, float* __restrict__ second,
            int* __restrict__ idx) {
  __shared__ __align__(16) float As[KC][TM];
  __shared__ __align__(16) float Bs[KC][TN];
  __shared__ float m_best[TM][kGroups];
  __shared__ float m_second[TM][kGroups];
  __shared__ int m_idx[TM][kGroups];

  const int b = blockIdx.y;
  const int row0 = blockIdx.x * TM;
  const float* A = d1 + (size_t)b * N1 * D;
  const float* Bm = d2 + (size_t)b * N2 * D;
  const int nv = min(n2[b], N2);

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int ty = (warp >> 1) * 4 + (lane >> 3);  // row group 0..15
  const int tx = (warp & 1) * 8 + (lane & 7);    // column group 0..15

  Top2 st[RM];
#pragma unroll
  for (int i = 0; i < RM; ++i) st[i] = {-2.f, -2.f, 0};

  for (int col0 = 0; col0 < N2; col0 += TN) {
    float acc[RM][RN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < D; k0 += KC) {
      // stage A[row0:+64, k0:+32] and B[col0:+128, k0:+32] k-major;
      // consecutive threads take consecutive rows (conflict-free stores)
#pragma unroll
      for (int r = 0; r < (TM * KC / 4) / kThreads; ++r) {
        const int q = tid + r * kThreads;
        const int row = q % TM, kq = q / TM;
        const int gr = row0 + row, gk = k0 + kq * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gr < N1 && gk < D)
          v = __ldg(reinterpret_cast<const float4*>(A + (size_t)gr * D + gk));
        As[kq * 4 + 0][row] = v.x;
        As[kq * 4 + 1][row] = v.y;
        As[kq * 4 + 2][row] = v.z;
        As[kq * 4 + 3][row] = v.w;
      }
#pragma unroll
      for (int r = 0; r < (TN * KC / 4) / kThreads; ++r) {
        const int q = tid + r * kThreads;
        const int col = q % TN, kq = q / TN;
        const int gc = col0 + col, gk = k0 + kq * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gc < N2 && gk < D)
          v = __ldg(reinterpret_cast<const float4*>(Bm + (size_t)gc * D + gk));
        Bs[kq * 4 + 0][col] = v.x;
        Bs[kq * 4 + 1][col] = v.y;
        Bs[kq * 4 + 2][col] = v.z;
        Bs[kq * 4 + 3][col] = v.w;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < KC; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Bs[k][64 + tx * 4]);
        const float av[RM] = {a.x, a.y, a.z, a.w};
        const float bv[RN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
          for (int j = 0; j < RN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

    // fold the tile into the running state, columns in increasing order
#pragma unroll
    for (int j = 0; j < RN; ++j) {
      const int c = col0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + (j - 4));
      if (c >= N2) continue;
#pragma unroll
      for (int i = 0; i < RM; ++i) push(st[i], c < nv ? acc[i][j] : -2.f, c);
    }
  }

  // merge the 16 partial states of each row
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    m_best[ty * 4 + i][tx] = st[i].best;
    m_second[ty * 4 + i][tx] = st[i].second;
    m_idx[ty * 4 + i][tx] = st[i].idx;
  }
  __syncthreads();
  if (tid < TM && row0 + tid < N1) {
    Top2 t = {m_best[tid][0], m_second[tid][0], m_idx[tid][0]};
    for (int g = 1; g < kGroups; ++g)
      merge(t, Top2{m_best[tid][g], m_second[tid][g], m_idx[tid][g]});
    const size_t o = (size_t)b * N1 + row0 + tid;
    best[o] = t.best;
    second[o] = t.second;
    idx[o] = t.idx;
  }
}

}  // namespace

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int match_top2(const float* d1, const float* d2, const int* n2,
                          int B, int N1, int N2, int D, float* best,
                          float* second, int* idx, void* stream) {
  if (D % 4 != 0 || B > 65535) return (int)cudaErrorInvalidValue;
  if (B <= 0 || N1 <= 0) return 0;
  const dim3 grid((N1 + TM - 1) / TM, B);
  top2_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      d1, d2, n2, N1, N2, D, best, second, idx);
  return (int)cudaGetLastError();
}
