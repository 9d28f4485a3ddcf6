// Per-keypoint bilinear window sampler of a pair-interleaved gradient
// volume (SIFT orientation, descriptor and affine-shape sampling), one
// launch per sample_windows call.
//
// Replaces: pycolmap_tpu/features/window_sampler.py _sample_windows_pallas
// (:105; body _sampler_kernel :49), reached through its sample_windows
// (:191), whose origin rule runs here in the block (K needs no padding).
//
// Contract: vol [LHp, Wp, NC] f32, the channels of a pixel adjacent; per
// keypoint k a channel base ch0[k] and 256 sample positions ys/xs [K, 256]
// in the [LHp, Wp] planes. The keypoint's window origin is the reference
// wrapper's rule, y0 = clamp(floor(min ys) floor-div 8 * 8, 0, LHp - win_y)
// and x0 = clamp(floor(min xs) floor-div 128 * 128, 0, Wp - win_x).
// out [2, K, 256]: out[c, k, s] is the bilinear sample of channel
// ch0[k] + c at (ys, xs), where a tap outside the window [y0, y0 + win_y) x
// [x0, x0 + win_x) counts zero, as does a channel pair outside the volume.
// The sample is taken at window coordinates ys - y0, xs - x0: exact in f32
// (y0, x0 are integers between 0 and the smallest coordinate, or 0), so
// they equal the reference wrapper's.
//
// Bound: bytes. Per launch it reads the coordinates (2 KB per keypoint),
// the volume pixels the taps touch (data-dependent) and writes 2 KB per
// keypoint; each sample costs ~30 flops, far below the f32 rate per byte.
//
// Design: the TPU kernel DMAs whole windows into VMEM and contracts them
// with tent matrices on the matrix unit, because the TPU has no vector
// gather. Hopper gathers natively, so one block of 128 threads takes one
// keypoint and each thread two neighbouring samples (one float2 load per
// coordinate array, one float2 store per output plane). The block finds
// its window origin with a min-reduction over its 256 samples, so the
// wrapper launches nothing else. A tap's volume address does not depend
// on the origin (oy + floor(ys - oy) = floor(ys)), only its window test
// does, so every tap is issued before the reduction and its latency
// overlaps it; the window test zeroes the taps after. The window lies
// inside the volume (the origin rule clamps it), so a tap outside the
// volume is outside the window and is not read. The volume interleaves the
// channel pair, so a tap of both channels is one 8-byte load from one
// sector, where a channel-major volume needs two loads from two planes
// LHp * Wp floats apart.
#include <cuda_runtime.h>

constexpr int kSamples = 256;  // 16 x 16 grid per keypoint
constexpr int kS = 2;          // samples per thread: one float2 per array
constexpr int kThreads = kSamples / kS;

__device__ __forceinline__ int floor_div(int a, int m) {
  const int q = a / m;
  return (a % m != 0 && a < 0) ? q - 1 : q;
}

// the block's minimum of (y, x), one barrier
template <int kWarps>
__device__ __forceinline__ float2 block_min(float2 v, float2* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v.x = fminf(v.x, __shfl_xor_sync(0xffffffffu, v.x, o));
    v.y = fminf(v.y, __shfl_xor_sync(0xffffffffu, v.y, o));
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float2 m = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i)
    m = make_float2(fminf(m.x, red[i].x), fminf(m.y, red[i].y));
  return m;
}

__global__ void __launch_bounds__(kThreads)
window_sampler_kernel(const float* __restrict__ vol, int NC, int LHp, int Wp,
                      const int* __restrict__ ch0,
                      const float* __restrict__ ys,
                      const float* __restrict__ xs, int K, int win_y,
                      int win_x, float* __restrict__ out) {
  __shared__ float2 red[kThreads / 32];
  const int k = blockIdx.x;
  const size_t o = (size_t)k * kSamples + kS * threadIdx.x;
  const float2 y2 = __ldg(reinterpret_cast<const float2*>(ys + o));
  const float2 x2 = __ldg(reinterpret_cast<const float2*>(xs + o));
  const float py[kS] = {y2.x, y2.y}, px[kS] = {x2.x, x2.y};
  const int c0 = ch0[k];
  const bool pair = c0 >= 0 && c0 + 1 < NC;  // else every tap reads 0
  const bool aligned = ((c0 | NC) & 1) == 0;
  // the taps, before the block's origin is known: a tap's volume address
  // does not depend on it (oy + floor(ys - oy) = floor(ys)), only its
  // window test does, so the gathers overlap the min-reduction
  float2 v[kS][4];
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const int gy0 = (int)floorf(py[s]), gx0 = (int)floorf(px[s]);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int gy = gy0 + (t >> 1), gx = gx0 + (t & 1);
      v[s][t] = make_float2(0.f, 0.f);
      if (pair && gy >= 0 && gy < LHp && gx >= 0 && gx < Wp) {
        const float* q = vol + ((size_t)gy * Wp + gx) * NC + c0;
        if (aligned) {
          v[s][t] = __ldg(reinterpret_cast<const float2*>(q));
        } else {
          v[s][t].x = __ldg(q);
          v[s][t].y = __ldg(q + 1);
        }
      }
    }
  }
  float2 m = make_float2(py[0], px[0]);
#pragma unroll
  for (int s = 1; s < kS; ++s)
    m = make_float2(fminf(m.x, py[s]), fminf(m.y, px[s]));
  m = block_min<kThreads / 32>(m, red);
  const int oy =
      min(max(floor_div((int)floorf(m.x), 8) * 8, 0), LHp - win_y);
  const int ox =
      min(max(floor_div((int)floorf(m.y), 128) * 128, 0), Wp - win_x);
  const float fy0 = (float)oy, fx0 = (float)ox;
  float a[kS], b[kS];
#pragma unroll
  for (int s = 0; s < kS; ++s) {
    const float wy = py[s] - fy0, wx = px[s] - fx0;
    const float fy = floorf(wy), fx = floorf(wx);
    const float dy = wy - fy, dx = wx - fx;
    const int iy = (int)fy, ix = (int)fx;
    float2 acc = make_float2(0.f, 0.f);
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int ty = t >> 1, tx = t & 1;
      const int ry = iy + ty, rx = ix + tx;
      if (ry < 0 || ry >= win_y || rx < 0 || rx >= win_x) continue;
      const float w = (ty ? dy : 1.f - dy) * (tx ? dx : 1.f - dx);
      acc.x += v[s][t].x * w;
      acc.y += v[s][t].y * w;
    }
    a[s] = acc.x;
    b[s] = acc.y;
  }
  *reinterpret_cast<float2*>(out + o) = make_float2(a[0], a[1]);
  *reinterpret_cast<float2*>(out + (size_t)K * kSamples + o) =
      make_float2(b[0], b[1]);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// blocks of window_sampler_kernel resident on one SM (the occupancy the
// ptxas register count allows); the stream is unused
extern "C" int sift_sample_windows_occupancy(int* blocks, void* stream) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, window_sampler_kernel, kThreads, 0);
}

extern "C" int sift_sample_windows(const float* vol, int NC, int LHp, int Wp,
                                   const int* ch0, const float* ys,
                                   const float* xs, int K, int win_y,
                                   int win_x, float* out, void* stream) {
  if (K <= 0) return 0;
  if (win_y > LHp || win_x > Wp || win_y < 2 || win_x < 2)
    return (int)cudaErrorInvalidValue;
  window_sampler_kernel<<<K, kThreads, 0, (cudaStream_t)stream>>>(
      vol, NC, LHp, Wp, ch0, ys, xs, K, win_y, win_x, out);
  return (int)cudaGetLastError();
}
