// Per-keypoint bilinear window sampler of a channel-pair volume (SIFT
// orientation, descriptor and affine-shape sampling).
//
// Replaces: pycolmap_tpu/features/window_sampler.py _sample_windows_pallas
// (:105; body _sampler_kernel :49).
//
// Contract (the reference's): vol [NC, LHp, Wp] f32; per keypoint k a
// channel base ch0[k] and a window origin (y0[k], x0[k]); wy/wx [K, 256] f32
// sample positions in window coordinates. out[k, c, s] is the bilinear
// sample of channel ch0[k] + c at (y0 + wy, x0 + wx), where a tap outside
// [0, win_y) x [0, win_x) of the window counts zero. That rule makes the
// wrapper's padded keypoint rows (coordinates -2.0) and samples left of the
// image vanish; the TPU kernel gets it from its tent weights over the window.
//
// Bound: bytes. Per launch it reads the coordinates (2 KB per keypoint),
// the volume pixels the taps touch (data-dependent: the union of the
// 2 x 4 taps of every sample) and writes 2 KB per keypoint; each sample
// costs ~20 flops, far below the f32 rate per byte.
//
// Design: the TPU kernel DMAs whole [2, win_y, win_x] windows into VMEM and
// contracts them with tent matrices on the matrix unit, because the TPU has
// no vector gather. Hopper gathers natively, so one block of 256 threads
// takes one keypoint, one thread one sample: coalesced coordinate reads and
// output writes, and 8 gathered taps through the read-only cache. A
// keypoint's taps lie within a few dozen rows of one plane, so the
// neighbouring samples' taps share L1/L2 lines.
#include <cuda_runtime.h>

constexpr int kSamples = 256;  // 16 x 16 grid per keypoint

__global__ void __launch_bounds__(kSamples)
window_sampler_kernel(const float* __restrict__ vol, int NC, int LHp, int Wp,
                      const int* __restrict__ ch0, const int* __restrict__ y0,
                      const int* __restrict__ x0, const float* __restrict__ wy,
                      const float* __restrict__ wx, int win_y, int win_x,
                      float* __restrict__ out) {
  const int k = blockIdx.x;
  const int s = threadIdx.x;
  const size_t o = (size_t)k * kSamples + s;
  const float py = wy[o], px = wx[o];
  const int c0 = ch0[k], oy = y0[k], ox = x0[k];
  float acc0 = 0.f, acc1 = 0.f;
  if (c0 >= 0 && c0 + 1 < NC) {  // a channel pair outside the volume reads 0
    const float fy = floorf(py), fx = floorf(px);
    const float dy = py - fy, dx = px - fx;
    const int iy = (int)fy, ix = (int)fx;
    const size_t plane = (size_t)LHp * Wp;
    const float* v0 = vol + (size_t)c0 * plane;
    const float* v1 = v0 + plane;
#pragma unroll
    for (int ty = 0; ty < 2; ++ty) {
#pragma unroll
      for (int tx = 0; tx < 2; ++tx) {
        const int ry = iy + ty, rx = ix + tx;
        const int gy = oy + ry, gx = ox + rx;
        // zero outside the window (the contract) and, as a guard on
        // origins the caller did not clip, outside the volume
        if (ry < 0 || ry >= win_y || rx < 0 || rx >= win_x || gy < 0 ||
            gy >= LHp || gx < 0 || gx >= Wp)
          continue;
        const float w = (ty ? dy : 1.f - dy) * (tx ? dx : 1.f - dx);
        const size_t off = (size_t)gy * Wp + gx;
        acc0 += __ldg(v0 + off) * w;
        acc1 += __ldg(v1 + off) * w;
      }
    }
  }
  float* ok = out + (size_t)k * 2 * kSamples;
  ok[s] = acc0;
  ok[kSamples + s] = acc1;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int sift_sample_windows(const float* vol, int NC, int LHp, int Wp,
                                   const int* ch0, const int* y0, const int* x0,
                                   const float* wy, const float* wx, int K,
                                   int win_y, int win_x, float* out,
                                   void* stream) {
  if (K <= 0) return 0;
  window_sampler_kernel<<<K, kSamples, 0, (cudaStream_t)stream>>>(
      vol, NC, LHp, Wp, ch0, y0, x0, wy, wx, win_y, win_x, out);
  return (int)cudaGetLastError();
}
