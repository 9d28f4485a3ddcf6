// Gather probe: five index forms of one pattern, out[o] = src[offset(o)].
//
// Replaces: scripts/proto_pallas_gather.py, the Mosaic gather probes
// case_a (pallas_call :66) and bench_a_sized (:164, case_a's function at
// [1024, 512]), case_b (:85), case_b2 (:104), case_c (:125) and case_c2
// (:144).
//
// Contract (the jnp `ref` each case computes; f32 source, int32 indices):
//   kLast  (case_a)  src [R, N], idx [R, M] -> out [R, M]: src[r, idx[r, c]]
//   kRows  (case_b)  src [R, C], idx [M]    -> out [M, C]: src[idx[i], c]
//   kFirst (case_b2) src [R, C], idx [M, C] -> out [M, C]: src[idx[r, c], c]
//   k2d    (case_c)  src [R, C], yi, xi [S] -> out [S]:    src[yi, xi]
//   kFlat  (case_c2) src [N],    idx [S]    -> out [S]:    src[idx]
// Index rules: take_along_axis and take (kLast, kFirst, kFlat) wrap an
// index in [-n, -1] and give NaN for any other index outside [0, n);
// indexing (kRows, k2d) wraps a negative index once and clamps the result
// to [0, n - 1]. No index reads outside src.
//
// Bound: bytes. Each output element reads its index (two for k2d) and one
// source element and writes one float; there is no arithmetic beyond the
// address. At the probe's own shapes (4 KB to 1.5 MB moved) a launch's
// fixed cost of a few microseconds exceeds the byte bound.
//
// Design: one thread per output element, flat over the output, so the
// index reads and the output writes are coalesced; the source reads go
// through the read-only cache (__ldg) and are as scattered as the indices.
// The TPU probes stage whole tiles in VMEM because Mosaic gathers only
// there; Hopper gathers from device memory through L1 / L2, so this kernel
// has no shared-memory staging, TMA or vector loads.
#include <cuda_runtime.h>

constexpr int kBlock = 256;
enum Form { kLast = 0, kRows = 1, kFirst = 2, k2d = 3, kFlat = 4 };

// take_along_axis / take: the index into [0, n), or -1 (the NaN fill)
__device__ __forceinline__ int wrap_fill(int i, int n) {
  if (i < 0) i += n;
  return (i >= 0 && i < n) ? i : -1;
}

// indexing: the index wrapped once and clamped to [0, n - 1]
__device__ __forceinline__ int wrap_clamp(int i, int n) {
  if (i < 0) i += n;
  return min(max(i, 0), n - 1);
}

template <int F>
__global__ void __launch_bounds__(kBlock)
gather_probe_kernel(const float* __restrict__ src, const int* __restrict__ idx,
                    const int* __restrict__ idx2, int rows, int cols,
                    int out_cols, long long total, float* __restrict__ out) {
  const long long o = (long long)blockIdx.x * kBlock + threadIdx.x;
  if (o >= total) return;
  long long off;  // flat source offset, -1 for the NaN fill
  if constexpr (F == kLast) {
    const int j = wrap_fill(idx[o], cols);
    off = j < 0 ? -1 : (o / out_cols) * cols + j;
  } else if constexpr (F == kRows) {
    off = (long long)wrap_clamp(idx[o / out_cols], rows) * cols + o % out_cols;
  } else if constexpr (F == kFirst) {
    const int i = wrap_fill(idx[o], rows);
    off = i < 0 ? -1 : (long long)i * cols + o % out_cols;
  } else if constexpr (F == k2d) {
    off = (long long)wrap_clamp(idx[o], rows) * cols + wrap_clamp(idx2[o], cols);
  } else {
    off = wrap_fill(idx[o], cols);
  }
  out[o] = off < 0 ? __int_as_float(0x7fc00000) : __ldg(src + off);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// form: one of Form. src [rows, cols] f32 (kFlat: rows 1, cols N); idx and
// idx2 int32 (idx2 only for k2d, else null); out holds `total` floats,
// `out_cols` of them per output row (kLast, kRows, kFirst).
extern "C" int gather_probe(int form, const float* src, const int* idx, const int* idx2,
                            int rows, int cols, int out_cols, long long total, float* out,
                            void* stream) {
  if (total <= 0) return 0;
  const long long blocks = (total + kBlock - 1) / kBlock;
  if (rows <= 0 || cols <= 0 || out_cols <= 0 || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (form) {
    case kLast:
      gather_probe_kernel<kLast><<<grid, kBlock, 0, s>>>(src, idx, idx2, rows, cols,
                                                         out_cols, total, out);
      break;
    case kRows:
      gather_probe_kernel<kRows><<<grid, kBlock, 0, s>>>(src, idx, idx2, rows, cols,
                                                         out_cols, total, out);
      break;
    case kFirst:
      gather_probe_kernel<kFirst><<<grid, kBlock, 0, s>>>(src, idx, idx2, rows, cols,
                                                          out_cols, total, out);
      break;
    case k2d:
      gather_probe_kernel<k2d><<<grid, kBlock, 0, s>>>(src, idx, idx2, rows, cols,
                                                       out_cols, total, out);
      break;
    case kFlat:
      gather_probe_kernel<kFlat><<<grid, kBlock, 0, s>>>(src, idx, idx2, rows, cols,
                                                         out_cols, total, out);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
