// Fused descriptor similarity + running top-2 per query (brute-force
// matcher): the N1 x N2 similarity matrix never reaches device memory.
//
// Replaces: pycolmap_tpu/features/pallas_kernels.py _pallas_top2_impl (:82;
// pallas_call :87, body _top2_kernel :28) and its vmapped batch form
// pallas_top2_batch (:112).
//
// Contract: d1 [B, N1, D], d2 [B, N2, D] f32 (D a multiple of 4, at most
// 160), n2 [B] int32. For every row r of pair b over the columns c < N2,
// with sim = <d1[b, r], d2[b, c]> where c < n2[b] and -2.0 where not:
// best[b, r] = max sim, idx[b, r] = its lowest column, second[b, r] = the
// largest sim of any other column (an exact duplicate of the best gives
// second == best). The running state starts at (-2, -2, 0), as the
// reference's does, so a row with no valid column gives (-2, -2, 0); a
// column past n2[b] would push -2.0, which changes no state that started
// there, so such columns are skipped.
//
// Bound: operations. The products run on the tensor cores in TF32 with
// each operand split in two (3xTF32: hi = rna(x), lo = rna(x - hi),
// hi.hi' + hi.lo' + lo.hi'), 3 x 2 N1 N2 D flops at 495 TFLOP/s: 0.104 ms
// at 8192 x 8192 x 128 (17.18 GFLOP a product); the f32 SIMT figure of the
// first port, 0.256 ms at 67 TFLOP/s, is its yardstick beside it. Reads:
// (N1 + N2) D floats, 8.4 MB or 2.5 us of HBM.
//
// Design: a block of 8 warps owns 128 rows of d1, staged once and split
// once into hi and lo planes in shared memory, and walks a share of the
// valid column tiles (128 columns) of its pair: the column range of a row
// tile is cut into `split` shares (chosen by the caller so that the grid
// fills whole waves of the 132 SMs), and tiles at or past n2[b] are never
// loaded. d2 arrives by cp.async in 32-deep chunks into a ring of 3
// stages, so copies run 2 chunks ahead of the MMAs; each value is split in
// registers as its fragment is loaded. Each warp computes a 64 x 32 tile
// with mma.sync.m16n8k8 TF32 (the larger warp tile loads and splits fewer
// fragments per MMA, which is what bounds the kernel: the instruction slots
// around the MMAs, not the tensor cores): per 8-deep step the three
// products go into a fresh accumulator (small terms first), which is then
// added to the f32 running sum, so the tensor cores' truncating
// accumulation never sees the whole dot product. The tile's epilogue pushes
// its sums into per-row (best, second, idx) registers; the 4 lanes and 4
// warps sharing a row merge theirs, and each block writes its share's
// state. The last block of a row tile to take its ticket merges the shares
// in order (the merge is exact, lowest column winning ties) and writes the
// outputs: still one launch per call.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS_M = 2, WARPS_N = 4;  // the block's 8 warps
constexpr int MT = 4, NT = 4;  // a warp's 16-row and 8-column MMA tiles: 64 x 32
constexpr int BM = WARPS_M * MT * 16;  // rows per block (128)
constexpr int BN = WARPS_N * NT * 8;   // columns per tile (128)
constexpr int KC = 32;  // depth per ring stage
constexpr int NS = 3;   // ring stages
constexpr int kThreads = 32 * WARPS_M * WARPS_N;
constexpr int kMaxD = 160;
constexpr int BSTR = KC + 4;  // floats per staged d2 row: conflict-free fragments

struct Top2 {
  float best, second;
  int idx;
};

// Push one similarity at column c into a running state. A thread's own
// columns arrive in increasing order, so a tie keeps the earlier (lower)
// column and the state moves without branches.
__device__ __forceinline__ void push_next(Top2& t, float v, int c) {
  t.second = fmaxf(t.second, fminf(v, t.best));
  t.idx = v > t.best ? c : t.idx;
  t.best = fmaxf(t.best, v);
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

// round to nearest TF32 (ties away from zero, as cvt.rna.tf32.f32): the
// 13 low mantissa bits rounded into the 10 kept ones
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));  // exact difference
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__host__ __device__ constexpr int padded_depth(int D) { return (D + KC - 1) / KC * KC; }

__host__ __device__ constexpr size_t smem_bytes(int D) {
  return (size_t)2 * BM * (padded_depth(D) + 4) * 4 + (size_t)NS * BN * BSTR * 4;
}

}  // namespace

__global__ void __launch_bounds__(kThreads, 1)
top2_kernel(const float* __restrict__ d1, const float* __restrict__ d2,
            const int* __restrict__ n2, int N1, int N2, int D, int split_n,
            float* __restrict__ best, float* __restrict__ second, int* __restrict__ idx,
            float* __restrict__ part, int* __restrict__ tickets) {
  extern __shared__ __align__(16) float top2_smem[];
  __shared__ float m_best[WARPS_N][BM], m_second[WARPS_N][BM];
  __shared__ int m_idx[WARPS_N][BM];
  __shared__ int last;

  const int Dp = padded_depth(D), AST = Dp + 4;
  uint32_t* sAh = reinterpret_cast<uint32_t*>(top2_smem);  // [BM][AST] hi
  uint32_t* sAl = sAh + BM * AST;                          // [BM][AST] lo
  float* sB = top2_smem + 2 * BM * AST;                    // [NS][BN][BSTR]

  const int b = blockIdx.y, B = gridDim.y;
  const int rt = blockIdx.x / split_n, s = blockIdx.x % split_n;
  const int n_rt = gridDim.x / split_n;
  const int row0 = rt * BM;
  const float* A = d1 + (size_t)b * N1 * D;
  const float* Bm = d2 + (size_t)b * N2 * D;
  const int nv = max(0, min(n2[b], N2));
  const int ctv = (nv + BN - 1) / BN;  // valid column tiles
  const int ct0 = s * ctv / split_n, ct1 = (s + 1) * ctv / split_n;
  const int kcn = Dp / KC;
  const int U = (ct1 - ct0) * kcn;  // ring units: (column tile, depth chunk)

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp % WARPS_M, wn = warp / WARPS_M;  // warp tile: rows wm*MT*16, columns wn*NT*8
  const int g = lane >> 2, t = lane & 3;

  // d2 unit u (column tile ct0 + u / kcn, depth chunk u % kcn) -> stage u % NS
  auto fetch = [&](int u) {
    const int col0 = (ct0 + u / kcn) * BN, k0 = (u % kcn) * KC;
    float* st = sB + (u % NS) * BN * BSTR;
#pragma unroll
    for (int i = 0; i < BN * KC / 4 / kThreads; ++i) {
      const int q = tid + i * kThreads;
      const int r = q / (KC / 4), c4 = (q % (KC / 4)) * 4;
      const int gc = col0 + r, gk = k0 + c4;
      const bool ok = gc < N2 && gk < D;
      cp_async16(st + r * BSTR + c4, ok ? Bm + (size_t)gc * D + gk : Bm, ok);
    }
  };
#pragma unroll
  for (int u = 0; u < NS - 1; ++u) {
    if (u < U) fetch(u);
    cp_async_commit();
  }

  // stage and split this block's rows of d1 once (zero past N1 and D)
  for (int q = tid; q < BM * Dp / 4; q += kThreads) {
    const int r = q / (Dp / 4), k = (q % (Dp / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < N1 && k < D)
      v = __ldg(reinterpret_cast<const float4*>(A + (size_t)(row0 + r) * D + k));
    uint4 h, l;
    split(v.x, h.x, l.x);
    split(v.y, h.y, l.y);
    split(v.z, h.z, l.z);
    split(v.w, h.w, l.w);
    *reinterpret_cast<uint4*>(sAh + r * AST + k) = h;
    *reinterpret_cast<uint4*>(sAl + r * AST + k) = l;
  }

  Top2 st[2 * MT];  // rows wm*MT*16 + mi*16 + h*8 + g, as st[mi*2 + h]
#pragma unroll
  for (int i = 0; i < 2 * MT; ++i) st[i] = {-2.f, -2.f, 0};
  float run[MT][NT][4];

  for (int u = 0; u < U; ++u) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // unit u is in; every warp is done with unit u - 1
    if (u + NS - 1 < U) fetch(u + NS - 1);
    cp_async_commit();
    const int kc = u % kcn;
    const float* sb = sB + (u % NS) * BN * BSTR;
    if (kc == 0) {
#pragma unroll
      for (int mi = 0; mi < MT; ++mi)
#pragma unroll
        for (int ni = 0; ni < NT; ++ni)
#pragma unroll
          for (int j = 0; j < 4; ++j) run[mi][ni][j] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk) {
      const int k = kc * KC + kk * 8;
      uint32_t ah[MT][4], al[MT][4];
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        const int r = (wm * MT + mi) * 16 + g;
        const int o0 = r * AST + k + t, o1 = (r + 8) * AST + k + t;
        ah[mi][0] = sAh[o0];
        ah[mi][1] = sAh[o1];
        ah[mi][2] = sAh[o0 + 4];
        ah[mi][3] = sAh[o1 + 4];
        al[mi][0] = sAl[o0];
        al[mi][1] = sAl[o1];
        al[mi][2] = sAl[o0 + 4];
        al[mi][3] = sAl[o1 + 4];
      }
#pragma unroll
      for (int ni = 0; ni < NT; ++ni) {
        const float* bp = sb + ((wn * NT + ni) * 8 + g) * BSTR + kk * 8 + t;
        uint32_t bh[2], bl[2];
        split(bp[0], bh[0], bl[0]);
        split(bp[4], bh[1], bl[1]);
#pragma unroll
        for (int mi = 0; mi < MT; ++mi) {
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          mma_tf32(c, al[mi], bh);
          mma_tf32(c, ah[mi], bl);
          mma_tf32(c, ah[mi], bh);
#pragma unroll
          for (int j = 0; j < 4; ++j) run[mi][ni][j] += c[j];
        }
      }
    }
    if (kc == kcn - 1) {  // the tile's sums are complete: push its valid columns
      const int col0 = (ct0 + u / kcn) * BN + wn * NT * 8 + 2 * t;
#pragma unroll
      for (int ni = 0; ni < NT; ++ni)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = col0 + ni * 8 + (j & 1);
          if (c < nv) {
#pragma unroll
            for (int mi = 0; mi < MT; ++mi) push_next(st[mi * 2 + (j >> 1)], run[mi][ni][j], c);
          }
        }
    }
  }
  cp_async_wait<0>();

  // merge the 4 lanes of a row, then the WARPS_N warps of a row
#pragma unroll
  for (int i = 0; i < 2 * MT; ++i) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const Top2 o = {__shfl_xor_sync(0xffffffffu, st[i].best, off),
                      __shfl_xor_sync(0xffffffffu, st[i].second, off),
                      __shfl_xor_sync(0xffffffffu, st[i].idx, off)};
      merge(st[i], o);
    }
  }
  if (t == 0) {
#pragma unroll
    for (int i = 0; i < 2 * MT; ++i) {
      const int r = (wm * MT + (i >> 1)) * 16 + (i & 1) * 8 + g;
      m_best[wn][r] = st[i].best;
      m_second[wn][r] = st[i].second;
      m_idx[wn][r] = st[i].idx;
    }
  }
  __syncthreads();
  const int row = row0 + tid;
  Top2 mine = {-2.f, -2.f, 0};
  if (tid < BM) {
    mine = {m_best[0][tid], m_second[0][tid], m_idx[0][tid]};
#pragma unroll
    for (int w = 1; w < WARPS_N; ++w)
      merge(mine, Top2{m_best[w][tid], m_second[w][tid], m_idx[w][tid]});
  }
  const size_t o = (size_t)b * N1 + row;
  if (split_n == 1) {
    if (tid < BM && row < N1) {
      best[o] = mine.best;
      second[o] = mine.second;
      idx[o] = mine.idx;
    }
    return;
  }

  // this share's states, then the last share of the row tile merges all
  const size_t plane = (size_t)split_n * B * N1;  // part: [3][split][B][N1]
  const size_t po = ((size_t)s * B + b) * N1 + row;
  if (tid < BM && row < N1) {
    part[po] = mine.best;
    part[plane + po] = mine.second;
    part[2 * plane + po] = __int_as_float(mine.idx);
  }
  __threadfence();
  __syncthreads();
  int* ticket = tickets + (size_t)b * n_rt + rt;
  if (tid == 0) last = atomicAdd(ticket, 1) == split_n - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid < BM && row < N1) {
    Top2 m = {-2.f, -2.f, 0};
    for (int k = 0; k < split_n; ++k) {
      const size_t q = ((size_t)k * B + b) * N1 + row;
      merge(m, Top2{__ldcg(part + q), __ldcg(part + plane + q),
                    __float_as_int(__ldcg(part + 2 * plane + q))});
    }
    best[o] = m.best;
    second[o] = m.second;
    idx[o] = m.idx;
  }
  if (tid == 0) *ticket = 0;  // ready for the next launch
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// One launch for the batch. split: column shares per row tile (cut by the
// caller, match_kernels.top2_split); part holds 3 split B N1 floats and
// tickets B ceil(N1 / 128) ints that are 0 before and after the launch
// (both unused when split is 1).
extern "C" int match_top2(const float* d1, const float* d2, const int* n2, int B, int N1,
                          int N2, int D, int split, float* best, float* second, int* idx,
                          float* part, int* tickets, void* stream) {
  if (D % 4 != 0 || D < 4 || D > kMaxD || B > 65535 || split < 1 ||
      (split > 1 && (!part || !tickets)))
    return (int)cudaErrorInvalidValue;
  if (B <= 0 || N1 <= 0) return 0;
  const size_t bytes = smem_bytes(D);
  static size_t known = 0;
  if (bytes > known) {
    const cudaError_t e =
        cudaFuncSetAttribute(top2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes(kMaxD));
    if (e != cudaSuccess) return (int)e;
    known = smem_bytes(kMaxD);
  }
  const long long blocks_x = (long long)((N1 + BM - 1) / BM) * split;
  if (blocks_x > 0x7fffffff) return (int)cudaErrorInvalidValue;
  top2_kernel<<<dim3((unsigned)blocks_x, B), kThreads, bytes, (cudaStream_t)stream>>>(
      d1, d2, n2, N1, N2, D, split, best, second, idx, part, tickets);
  return (int)cudaGetLastError();
}

// Resources of the kernel for chip_smoke.py: registers, dynamic shared
// memory at D and resident blocks per SM (the stream is unused).
extern "C" int match_top2_resources(int D, int* regs, int* smem, int* blocks_per_sm, void*) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, top2_kernel);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(top2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem_bytes(kMaxD));
  if (e != cudaSuccess) return (int)e;
  *regs = a.numRegs;
  *smem = (int)(smem_bytes(D) + a.sharedSizeBytes);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, top2_kernel,
                                                            kThreads, smem_bytes(D));
}
