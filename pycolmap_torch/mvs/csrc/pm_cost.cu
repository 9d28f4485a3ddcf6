// PatchMatch per-view bilateral-NCC window cost of one candidate plane
// field, with the optional geometric-consistency term.
//
// Replaces: pycolmap_tpu/mvs/pm_kernels.py pm_view_costs_pallas (:364,
// pallas_call :412; body _make_kernel :192).
//
// Contract (the reference's, without its source bands): the sources
// [K, H, W] f32 (resampled to the reference size) and, with geom, the
// source depth maps [K, H, W]; w_off / wr_off [nw, H, W] the bilateral window
// weights and weight * shifted reference; depth [H, W]; normal [3, H, W];
// stats [3, H, W] = (w_sum, ref_mean, ref_var); params [K, 32] view rows
// (layout in pm_kernels.py); offs [nw, 2] = (dy, dx). For pixel p, view k
// and offset i the offset ray r_q = Kr^-1 (p + 0.5 + offs[i]) warps to
// m = R_k r_q + t_k (n . r_q) / (d (n . r_p)); the source is sampled
// bilinearly at (Ks m / m_z) - 0.5, zero and invalid outside
// [0, W-1) x [0, H-1) or where m_z <= 0. Output cost [K, H, W]:
// 1 - clip(ncc, -1, 1), or 2.0 where the valid weight is at most 20% of
// w_sum; with geom, plus geom_w * min(fwd-bwd reprojection error,
// geom_max_cost) from the source depth map sampled at the center warp.
// With a parity (0 or 1) only the pixels with (y + x) % 2 == parity are
// evaluated; the others get 2.0.
//
// Bound: operations. Per (pixel, view, offset) sample ~33 f32 operations
// of warp and validity, and ~28 more (bilinear taps, the center and the
// five accumulators) where the sample is valid; per (pixel, offset) ~13 for
// the offset ray and the centered weight. At 960x1280, K = 8, nw = 36 that
// is ~20 GFLOP against ~0.47 GB of inputs and output: ~0.3 ms at 67
// TFLOP/s against ~0.14 ms at 3.35 TB/s. A parity launch does half.
//
// Design: the TPU kernel DMAs a per-tile source band into VMEM because the
// TPU has no vector gather, and packs bf16 pairs to halve lane gathers.
// Hopper gathers natively. The first port kept all 8 views' sums in one
// thread per pixel (108 registers, 16 warps per SM), and its gathers'
// latency, not its arithmetic, set its pace. So:
// - One thread per (pixel, view): a block is 32 pixels of one row times up
//   to 8 views, one warp per view, each thread with its view's six sums.
//   The registers are held to 40 (kMinBlocks) so that 48 warps per SM keep
//   taps in flight.
// - The terms of a (pixel, offset) that every view shares (w, w (ref_q -
//   a), the offset ray r_q and the plane scale: three divisions) are
//   computed once per block into shared memory, one offset per warp in
//   chunks of blockDim.y offsets, so w_off / wr_off are read once per
//   pixel, not once per view.
// - A sample's 2 x 2 footprint is four scalar __ldg of the source. An
//   invalid sample loads the footprint at the origin, so the loads need no
//   branch. (tex2Dgather of CUDA-array copies of the sources took ~11% less
//   time per launch, but the copies, made and freed per PatchMatch call,
//   left whole calls slower as often as faster: PERF.md, section 6.)
// - A parity launch maps its threads to the active pixels only: a thread
//   takes the pixel pair (2j, 2j + 1) of its row, evaluates the active one
//   and writes 2.0 to the other, so no lane of a warp idles.
// The sums are taken about the reference window mean and each view's first
// valid sample, so that f32 loses no digits to the cancellation in
// sum w s^2 / W - mean^2.
//
// Rounding: built with -fmad=false (_cuda_build.SOURCE_FLAGS), every
// expression in the plain version's order, so the kernel rounds as the f32
// plain version's separate PyTorch operations do. A cost is ill-conditioned
// in f32 where a sample lies within rounding of the image edge or a plane is
// nearly parallel to its ray; there the f32 result departs from float64 in
// the kernel and the plain version alike, and the two still agree.
#include <cuda_runtime.h>

constexpr int kRow = 32;     // floats per view row
constexpr int kViews = 8;    // views per block, one warp each
constexpr int kBx = 32;      // pixels of a row per block
constexpr int kTerms = 5;    // shared terms per (pixel, offset)
// resident blocks per SM the registers are held to (40 registers): the
// gathers need the warps more than a thread needs registers
constexpr int kMinBlocks = 6;

// the 2 x 2 footprint at top-left (x0, y0), integers in float, of a
// source plane: (top-left, top-right, bottom-left, bottom-right)
__device__ __forceinline__ float4 footprint(const float* __restrict__ plane,
                                            int W, float x0, float y0) {
  const float* q = plane + (size_t)(int)y0 * W + (int)x0;
  return make_float4(__ldg(q), __ldg(q + 1), __ldg(q + W), __ldg(q + W + 1));
}

// the plain version's bilinear sum of a footprint at fractions (dy, dx)
__device__ __forceinline__ float blend(float4 v, float dy, float dx) {
  return v.x * (1.f - dy) * (1.f - dx) + v.y * (1.f - dy) * dx +
         v.z * dy * (1.f - dx) + v.w * dy * dx;
}

static size_t smem_bytes(int nw) {
  return (size_t)(kViews * kRow + 2 * nw + kTerms * kViews * kBx) *
         sizeof(float);
}

template <bool kParity>
__global__ void __launch_bounds__(kBx * kViews, kMinBlocks)
pm_cost_kernel(const float* __restrict__ srcs, const float* __restrict__ sdeps,
               const float* __restrict__ w_off,
               const float* __restrict__ wr_off,
               const float* __restrict__ depth,
               const float* __restrict__ normal,
               const float* __restrict__ stats,
               const float* __restrict__ params,
               const float* __restrict__ offs, int K, int H, int W, int nw,
               int geom, int parity, float* __restrict__ out) {
  extern __shared__ float prm[];  // [kViews, kRow] view rows
  float* off = prm + kViews * kRow;  // [nw, 2]
  float* term = off + 2 * nw;        // [kTerms, kViews, kBx]: one chunk
  const int k0 = blockIdx.z * kViews;
  const int kv = min(kViews, K - k0);
  const int ny = blockDim.y;
  const int nt = kBx * ny;
  const int lane = threadIdx.x, kl = threadIdx.y;
  const int tid = kl * kBx + lane;
  for (int j = tid; j < kv * kRow; j += nt)
    prm[j] = params[(size_t)k0 * kRow + j];
  for (int j = tid; j < 2 * nw; j += nt) off[j] = offs[j];
  __syncthreads();

  const size_t HW = (size_t)H * W;
  const int y = blockIdx.y;
  int x = blockIdx.x * kBx + lane;
  if (kParity) {
    const int a = (y + parity) & 1;
    const int xo = 2 * x + 1 - a;
    x = 2 * x + a;
    if (kl < kv && xo < W)
      out[(size_t)(k0 + kl) * HW + (size_t)y * W + xo] = 2.f;
  }
  const bool live = x < W;
  const size_t p = (size_t)y * W + (live ? x : 0);
  const float krfx = prm[16], krfy = prm[17], krcx = prm[18], krcy = prm[19];
  const float px = x + 0.5f, py = y + 0.5f;
  const float rpx = (px - krcx) / krfx, rpy = (py - krcy) / krfy;
  const float d = depth[p];
  const float n0 = normal[p], n1 = normal[HW + p], n2 = normal[2 * HW + p];
  const float ndotr = n0 * rpx + n1 * rpy + n2;
  const float denom = d * (fabsf(ndotr) < 1e-6f ? -1e-6f : ndotr);
  const float xmax = (float)(W - 1), ymax = (float)(H - 1);
  const float w_sum = stats[p], a = stats[HW + p];
  const float ref_var = stats[2 * HW + p];
  const bool view = kl < kv && live;
  const float* r = prm + min(kl, kv - 1) * kRow;
  const int kc = min(kl, kv - 1);  // a warp past the block's views: any
  const float* plane = srcs + (size_t)(k0 + kc) * HW;
  float b = 0.f, s = 0.f, s2 = 0.f, rs = 0.f, r1 = 0.f, wv = 1e-9f;
  const int cs = kViews * kBx;  // one term's plane in the chunk
  for (int c0 = 0; c0 < nw; c0 += ny) {
    {  // this warp's offset of the chunk
      const int i = c0 + kl;
      if (i < nw && live) {
        const float dy = off[2 * i], dx = off[2 * i + 1];
        const float w = __ldg(w_off + i * HW + p);
        const float rqx = (px + dx - krcx) / krfx;
        const float rqy = (py + dy - krcy) / krfy;
        const int t = kl * kBx + lane;
        term[t] = w;
        term[cs + t] = __ldg(wr_off + i * HW + p) - a * w;
        term[2 * cs + t] = rqx;
        term[3 * cs + t] = rqy;
        term[4 * cs + t] = (n0 * rqx + n1 * rqy + n2) / denom;
      }
    }
    __syncthreads();
    if (view) {
      const int ni = min(ny, nw - c0);
      for (int u = 0; u < ni; ++u) {
        const int t = u * kBx + lane;
        const float w = term[t], rc = term[cs + t];
        const float rqx = term[2 * cs + t], rqy = term[3 * cs + t];
        const float scale = term[4 * cs + t];
        const float m0 = r[0] * rqx + r[1] * rqy + r[2] + r[9] * scale;
        const float m1 = r[3] * rqx + r[4] * rqy + r[5] + r[10] * scale;
        const float m2 = r[6] * rqx + r[7] * rqy + r[8] + r[11] * scale;
        const float z = fabsf(m2) < 1e-9f ? 1e-9f : m2;
        const float us = r[12] * (m0 / z) + r[14] - 0.5f;
        const float vs = r[13] * (m1 / z) + r[15] - 0.5f;
        const bool ok =
            us >= 0.f && us < xmax && vs >= 0.f && vs < ymax && m2 > 0.f;
        // an invalid sample loads the safe footprint at the origin
        const float fx = ok ? floorf(us) : 0.f, fy = ok ? floorf(vs) : 0.f;
        const float4 v = footprint(plane, W, fx, fy);
        if (ok) {
          const float val = blend(v, vs - fy, us - fx);
          if (wv == 1e-9f) b = val;  // the view's first valid sample
          const float vc = val - b;
          s += w * vc;
          s2 += w * vc * vc;
          rs += rc * vc;
          r1 += rc;
          wv += w;
        }
      }
    }
    __syncthreads();
  }
  if (!view) return;

  const float src_mean = s / wv;  // minus b
  const float src_var = fmaxf(s2 / wv - src_mean * src_mean, 1e-6f);
  const float covar = (rs + b * r1) / wv;
  const float ncc = covar / sqrtf(ref_var * src_var);
  float cost = wv > 0.2f * w_sum ? 1.f - fminf(fmaxf(ncc, -1.f), 1.f) : 2.f;
  if (geom) {
    const float scale_c = 1.f / fmaxf(d, 1e-9f);
    const float c0 = r[0] * rpx + r[1] * rpy + r[2] + r[9] * scale_c;
    const float c1 = r[3] * rpx + r[4] * rpy + r[5] + r[10] * scale_c;
    const float c2 = r[6] * rpx + r[7] * rpy + r[8] + r[11] * scale_c;
    const float zc = fabsf(c2) < 1e-9f ? 1e-9f : c2;
    const float uc = r[12] * (c0 / zc) + r[14];
    const float vc = r[13] * (c1 / zc) + r[15];
    const bool okc = uc - 0.5f >= 0.f && uc - 0.5f < xmax &&
                     vc - 0.5f >= 0.f && vc - 0.5f < ymax && c2 > 0.f;
    float ds = 0.f;
    if (okc) {
      const float us = uc - 0.5f, vs = vc - 0.5f;
      const float ux = floorf(us), uy = floorf(vs);
      ds = blend(footprint(sdeps + (size_t)(k0 + kl) * HW, W, ux, uy),
                 vs - uy, us - ux);
    }
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
  out[(size_t)(k0 + kl) * HW + p] = cost;
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// parity: -1 evaluates every pixel, 0 or 1 the pixels with (y + x) % 2 ==
// parity; sdeps is read only with geom
extern "C" int pm_view_costs(const float* srcs, const float* sdeps,
                             const float* w_off, const float* wr_off,
                             const float* depth, const float* normal,
                             const float* stats, const float* params,
                             const float* offs, int K, int H, int W, int nw,
                             int geom, int parity, float* out, void* stream) {
  if (K <= 0 || H <= 0 || W <= 0) return 0;
  const dim3 block(kBx, min(K, kViews));
  const int cols = parity < 0 ? W : (W + 1) / 2;  // pixels or pairs per row
  const dim3 grid((cols + kBx - 1) / kBx, H, (K + kViews - 1) / kViews);
  const size_t smem = smem_bytes(nw);
  cudaStream_t st = (cudaStream_t)stream;
  if (parity < 0)
    pm_cost_kernel<false><<<grid, block, smem, st>>>(
        srcs, sdeps, w_off, wr_off, depth, normal, stats, params, offs, K, H,
        W, nw, geom, 0, out);
  else
    pm_cost_kernel<true><<<grid, block, smem, st>>>(
        srcs, sdeps, w_off, wr_off, depth, normal, stats, params, offs, K, H,
        W, nw, geom, parity & 1, out);
  return (int)cudaGetLastError();
}

// blocks of the full-field (parity 0) and parity (1) kernels resident on
// one SM, for nw offsets; the stream is unused
extern "C" int pm_cost_occupancy(int parity, int nw, int* blocks,
                                 void* stream) {
  if (parity)
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, pm_cost_kernel<true>, kBx * kViews, smem_bytes(nw));
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, pm_cost_kernel<false>, kBx * kViews, smem_bytes(nw));
}
