// Per-observation parameter gather of one bucket, for both index spaces.
//
// Replaces: pycolmap_tpu/sfm/cg_kernel.py gather_params_bucket (:466; body
// _make_gather_kernel :453), behind its wrappers gather_obs_params (:524)
// and gather_x (:549): out_i[r, t, p] = img_tab[r, img_idx[t, p]] and
// out_c[r, t, p] = cam_tab[r, cam_idx[t, p]], 0 where an index falls
// outside its table (the TPU kernel's chunked lane gather finds no chunk
// there).
//
// Bound: bytes. Each slot reads two 4-byte indices and writes Ri + Rc
// floats; the tables ([Ri, I] and [Rc, C], a few KB) stay in L1 / L2, so
// their reads are cache hits after the first. No arithmetic.
//
// Design: one thread per track slot (t, p), flat over T * P, so the index
// reads and every output plane's writes are coalesced; the table reads go
// through the read-only cache (__ldg). The TPU kernel's 128-lane table
// layout and padding are not needed: the tables come unpadded.
#include <cuda_runtime.h>

constexpr int kGatherBlock = 256;

__global__ void __launch_bounds__(kGatherBlock)
gather_kernel(const float* __restrict__ img_tab, const float* __restrict__ cam_tab,
              const int* __restrict__ img_idx, const int* __restrict__ cam_idx, int Ri, int I,
              int Rc, int C, int TP, float* __restrict__ out_i, float* __restrict__ out_c) {
  const int o = blockIdx.x * kGatherBlock + threadIdx.x;
  if (o >= TP) return;
  const int ii = img_idx[o], ci = cam_idx[o];
  const bool in_i = ii >= 0 && ii < I, in_c = ci >= 0 && ci < C;
  for (int r = 0; r < Ri; ++r)
    out_i[(size_t)r * TP + o] = in_i ? __ldg(img_tab + (size_t)r * I + ii) : 0.f;
  for (int r = 0; r < Rc; ++r)
    out_c[(size_t)r * TP + o] = in_c ? __ldg(cam_tab + (size_t)r * C + ci) : 0.f;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// img_tab [Ri, I], cam_tab [Rc, C] f32; img_idx, cam_idx [T, P] int32 with
// TP = T * P; out_i [Ri, T, P], out_c [Rc, T, P].
extern "C" int ba_gather(const float* img_tab, const float* cam_tab, const int* img_idx,
                         const int* cam_idx, int Ri, int I, int Rc, int C, int TP,
                         float* out_i, float* out_c, void* stream) {
  if (TP <= 0) return 0;
  const int blocks = (TP + kGatherBlock - 1) / kGatherBlock;
  gather_kernel<<<blocks, kGatherBlock, 0, (cudaStream_t)stream>>>(
      img_tab, cam_tab, img_idx, cam_idx, Ri, I, Rc, C, TP, out_i, out_c);
  return (int)cudaGetLastError();
}
