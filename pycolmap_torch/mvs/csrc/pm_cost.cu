// PatchMatch per-view bilateral-NCC window cost of one candidate plane
// field, with the optional geometric-consistency term.
//
// Replaces: pycolmap_tpu/mvs/pm_kernels.py pm_view_costs_pallas (:364,
// pallas_call :412; body _make_kernel :192).
//
// Contract (the reference's, without its source bands): srcs [K, H, W] f32
// source images resampled to the reference size; sdeps [K, H, W] source
// depth maps (geom only, else null); w_off / wr_off [nw, H, W] the bilateral
// window weights and weight * shifted reference; depth [H, W]; normal
// [3, H, W]; stats [3, H, W] = (w_sum, ref_mean, ref_var); params [K, 32]
// view rows (layout in pm_kernels.py); offs [nw, 2] = (dy, dx). For pixel p,
// view k and offset i the offset ray r_q = Kr^-1 (p + 0.5 + offs[i]) warps
// to m = R_k r_q + t_k (n . r_q) / (d (n . r_p)); the source is sampled
// bilinearly at (Ks m / m_z) - 0.5, zero and invalid outside
// [0, W-1) x [0, H-1) or where m_z <= 0. Output cost [K, H, W]:
// 1 - clip(ncc, -1, 1), or 2.0 where the valid weight is at most 20% of
// w_sum; with geom, plus geom_w * min(fwd-bwd reprojection error,
// geom_max_cost) from the source depth map sampled at the center warp.
//
// Bound: operations. Per (pixel, view, offset) sample ~33 f32 operations
// of warp and validity, and ~28 more (bilinear taps, the center and the
// five accumulators) where the sample is valid; per (pixel, offset) ~13 for the
// offset ray and the centered weight. At 960x1280, K = 8, nw = 36 that is
// ~20 GFLOP against ~0.47 GB of inputs and output: ~0.3 ms at 67 TFLOP/s
// against ~0.14 ms at 3.35 TB/s.
//
// Design: the TPU kernel DMAs a per-tile source band into VMEM because the
// TPU has no vector gather, and packs bf16 pairs to halve lane gathers.
// Hopper gathers natively: one thread per pixel loops over the window
// offsets and, for each, over up to 8 views whose five accumulators live
// in registers. So w_off / wr_off are read once per pixel rather than once
// per view, and the view rows sit in shared memory, read as broadcasts. A
// block is a 32 x 8 pixel tile, so its warps' taps fall on a few source
// rows and hit L1; at 960x1280 all eight sources (39 MB) stay in the 50 MB
// L2. More than 8 views take more blocks along z. The sums are taken about
// the reference window mean and each view's first valid sample, so that
// f32 loses no digits to the cancellation in sum w s^2 / W - mean^2.
//
// Rounding: built with -fmad=false (_cuda_build.SOURCE_FLAGS), every
// expression in the plain version's order, so the kernel rounds as the f32
// plain version's separate PyTorch operations do. A cost is ill-conditioned
// in f32 where a sample lies within rounding of the image edge or a plane is
// nearly parallel to its ray; there the f32 result departs from float64 in
// the kernel and the plain version alike, and the two still agree.
#include <cuda_runtime.h>

constexpr int kRow = 32;    // floats per view row
constexpr int kViews = 8;   // views per block
constexpr int kBx = 32, kBy = 8;

// bilinear sample of img [H, W] at (ys, xs); the caller guarantees
// 0 <= xs < W - 1 and 0 <= ys < H - 1
__device__ __forceinline__ float bilinear(const float* __restrict__ img,
                                          int W, float ys, float xs) {
  const float x0 = floorf(xs), y0 = floorf(ys);
  const float dx = xs - x0, dy = ys - y0;
  const float* q = img + (size_t)(int)y0 * W + (int)x0;
  return __ldg(q) * (1.f - dy) * (1.f - dx) + __ldg(q + 1) * (1.f - dy) * dx +
         __ldg(q + W) * dy * (1.f - dx) + __ldg(q + W + 1) * dy * dx;
}

__global__ void __launch_bounds__(kBx * kBy)
pm_cost_kernel(const float* __restrict__ srcs, const float* __restrict__ sdeps,
               const float* __restrict__ w_off,
               const float* __restrict__ wr_off,
               const float* __restrict__ depth,
               const float* __restrict__ normal,
               const float* __restrict__ stats,
               const float* __restrict__ params,
               const float* __restrict__ offs, int K, int H, int W, int nw,
               int geom, float* __restrict__ out) {
  extern __shared__ float sh[];
  float* prm = sh;                  // [kViews, kRow] this block's view rows
  float* off = sh + kViews * kRow;  // [nw, 2]
  const int k0 = blockIdx.z * kViews;
  const int kv = min(kViews, K - k0);
  const int tid = threadIdx.y * kBx + threadIdx.x;
  for (int j = tid; j < kv * kRow; j += kBx * kBy)
    prm[j] = params[(size_t)k0 * kRow + j];
  for (int j = tid; j < 2 * nw; j += kBx * kBy) off[j] = offs[j];
  __syncthreads();

  const int x = blockIdx.x * kBx + threadIdx.x;
  const int y = blockIdx.y * kBy + threadIdx.y;
  if (x >= W || y >= H) return;
  const size_t HW = (size_t)H * W;
  const size_t p = (size_t)y * W + x;
  const float krfx = prm[16], krfy = prm[17], krcx = prm[18], krcy = prm[19];
  const float px = x + 0.5f, py = y + 0.5f;
  const float rpx = (px - krcx) / krfx, rpy = (py - krcy) / krfy;
  const float d = depth[p];
  const float n0 = normal[p], n1 = normal[HW + p], n2 = normal[2 * HW + p];
  const float ndotr = n0 * rpx + n1 * rpy + n2;
  const float denom = d * (fabsf(ndotr) < 1e-6f ? -1e-6f : ndotr);
  const float xmax = (float)(W - 1), ymax = (float)(H - 1);
  // window sums (see pm_kernels.py) about the reference window mean a and
  // each view's first valid sample b: s = sum w (v - b), s2 = sum w
  // (v - b)^2, rs = sum w (ref_q - a)(v - b), r1 = sum w (ref_q - a),
  // wv = sum w, over the valid samples
  const float w_sum = stats[p], a = stats[HW + p];
  const float ref_var = stats[2 * HW + p];
  float b[kViews], s[kViews], s2[kViews], rs[kViews], r1[kViews], wv[kViews];
#pragma unroll
  for (int k = 0; k < kViews; ++k) {
    b[k] = 0.f;
    s[k] = 0.f;
    s2[k] = 0.f;
    rs[k] = 0.f;
    r1[k] = 0.f;
    wv[k] = 1e-9f;
  }
  for (int i = 0; i < nw; ++i) {
    const float dy = off[2 * i], dx = off[2 * i + 1];
    const float w = __ldg(w_off + i * HW + p);
    const float rc = __ldg(wr_off + i * HW + p) - a * w;  // w (ref_q - a)
    const float rqx = (px + dx - krcx) / krfx;
    const float rqy = (py + dy - krcy) / krfy;
    const float scale = (n0 * rqx + n1 * rqy + n2) / denom;
#pragma unroll
    for (int k = 0; k < kViews; ++k) {
      if (k >= kv) break;
      const float* r = prm + k * kRow;
      const float m0 = r[0] * rqx + r[1] * rqy + r[2] + r[9] * scale;
      const float m1 = r[3] * rqx + r[4] * rqy + r[5] + r[10] * scale;
      const float m2 = r[6] * rqx + r[7] * rqy + r[8] + r[11] * scale;
      const float z = fabsf(m2) < 1e-9f ? 1e-9f : m2;
      const float us = r[12] * (m0 / z) + r[14] - 0.5f;
      const float vs = r[13] * (m1 / z) + r[15] - 0.5f;
      if (us >= 0.f && us < xmax && vs >= 0.f && vs < ymax && m2 > 0.f) {
        const float val = bilinear(srcs + (size_t)(k0 + k) * HW, W, vs, us);
        if (wv[k] == 1e-9f) b[k] = val;  // the view's first valid sample
        const float v = val - b[k];
        s[k] += w * v;
        s2[k] += w * v * v;
        rs[k] += rc * v;
        r1[k] += rc;
        wv[k] += w;
      }
    }
  }

  const float scale_c = 1.f / fmaxf(d, 1e-9f);
#pragma unroll
  for (int k = 0; k < kViews; ++k) {
    if (k >= kv) break;
    const float src_mean = s[k] / wv[k];  // minus b
    const float src_var = fmaxf(s2[k] / wv[k] - src_mean * src_mean, 1e-6f);
    const float covar = (rs[k] + b[k] * r1[k]) / wv[k];
    const float ncc = covar / sqrtf(ref_var * src_var);
    float cost = wv[k] > 0.2f * w_sum ? 1.f - fminf(fmaxf(ncc, -1.f), 1.f)
                                      : 2.f;
    if (geom) {
      // forward-backward reprojection error at the center pixel
      const float* r = prm + k * kRow;
      const float c0 = r[0] * rpx + r[1] * rpy + r[2] + r[9] * scale_c;
      const float c1 = r[3] * rpx + r[4] * rpy + r[5] + r[10] * scale_c;
      const float c2 = r[6] * rpx + r[7] * rpy + r[8] + r[11] * scale_c;
      const float zc = fabsf(c2) < 1e-9f ? 1e-9f : c2;
      const float uc = r[12] * (c0 / zc) + r[14];
      const float vc = r[13] * (c1 / zc) + r[15];
      const bool okc = uc - 0.5f >= 0.f && uc - 0.5f < xmax &&
                       vc - 0.5f >= 0.f && vc - 0.5f < ymax && c2 > 0.f;
      const float ds =
          okc ? bilinear(sdeps + (size_t)(k0 + k) * HW, W, vc - 0.5f,
                         uc - 0.5f)
              : 0.f;
      const float bx = r[23] * uc + r[25], by = r[24] * vc + r[26];
      const float d0 = ds * bx - r[9], d1 = ds * by - r[10], d2 = ds - r[11];
      const float X0 = r[0] * d0 + r[3] * d1 + r[6] * d2;
      const float X1 = r[1] * d0 + r[4] * d1 + r[7] * d2;
      const float X2 = r[2] * d0 + r[5] * d1 + r[8] * d2;
      const float zr = X2 < 1e-9f ? 1e-9f : X2;
      const float eu = krfx * (X0 / zr) + krcx - px;
      const float ev = krfy * (X1 / zr) + krcy - py;
      const float err = sqrtf(eu * eu + ev * ev);
      const float gmax = r[22];
      cost += r[21] * (okc && ds > 0.f && X2 > 0.f ? fminf(err, gmax) : gmax);
    }
    out[(size_t)(k0 + k) * HW + p] = cost;
  }
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

extern "C" int pm_view_costs(const float* srcs, const float* sdeps,
                             const float* w_off, const float* wr_off,
                             const float* depth, const float* normal,
                             const float* stats, const float* params,
                             const float* offs, int K, int H, int W, int nw,
                             int geom, float* out, void* stream) {
  if (K <= 0 || H <= 0 || W <= 0) return 0;
  const dim3 block(kBx, kBy);
  const dim3 grid((W + kBx - 1) / kBx, (H + kBy - 1) / kBy,
                  (K + kViews - 1) / kViews);
  const size_t smem = (size_t)(kViews * kRow + 2 * nw) * sizeof(float);
  pm_cost_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      srcs, sdeps, w_off, wr_off, depth, normal, stats, params, offs, K, H, W,
      nw, geom, out);
  return (int)cudaGetLastError();
}
