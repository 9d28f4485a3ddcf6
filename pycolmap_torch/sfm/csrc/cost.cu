// Robust total cost over all buckets, and the fused LM-step tail (point
// back-substitution + cost at the updated parameters) over all buckets.
//
// Replaces: pycolmap_tpu/sfm/cg_kernel.py cost_bucket (:708; body
// _make_cost_kernel :670) and finish_bucket (:821; body _make_finish_kernel
// :746).
//
// Bound: bytes. cost reads per live track slot (mask != 0) two indices and
// xy (16 B), the mask of every slot (4 B) and each point once; finish adds
// per live slot its Jacobian (8 (9+NP) B: 62.4 MB of the 109 MB bucket at
// the bench shape, whose tracks fill 6 of 8 slots of 100,000 of 131,072
// columns), and per column Vinv, g_pt and the free flag, and writes the new
// points. The per-slot arithmetic is one projection (and one 2 x (9+NP)
// contraction in finish), far below the f32 rate per byte.
//
// Design.
// - One launch per call for all buckets, over a table passed by value
//   (CostTable, built by cg_kernel.py: once per LM step for finish, once
//   per call for cost). Tiles are those of the Schur kernels (T tile_p <=
//   256 slots, tile_p a power of two, 32 at the bench's T = 8), but any
//   bucket width is taken: copies are 4 bytes, so no operand needs more
//   than its own alignment.
// - One thread per track slot of a tile (256 threads), so the bench's
//   1,048,576 slots fill the card; blocks walk tiles with a stride of the
//   grid (the resident blocks), so the blocks in flight read neighbouring
//   columns.
// - Only live slots are read: each thread loads its slot's mask two tiles
//   ahead, and copies its live slot's indices, J row pieces (finish) or
//   point (cost) into shared memory by cp.async one tile ahead, into one
//   of two stages (its xy into registers, also a tile ahead). A dead slot
//   (the bench's slots 6-7, its 31,072 padding columns) issues no load; a
//   tile of padding columns reads its masks and (finish) its per-column
//   values only. Every thread reads back only what it copied, so the ring
//   needs no barrier.
// - finish: each live slot forms a = J_c x (x gathered per image and
//   camera) and J_p^T a; the column's sum over its track is added in slot
//   order by the column's slot-0 thread, which makes the new point (also
//   for a column with no live slot, as the plain version gives it), writes
//   it out and hands it to the column's slot threads through shared
//   memory. Each live slot then takes its residual and robust cost at the
//   updated parameters.
// - The total in a fixed order: each tile's slot costs are summed per warp
//   (shuffle tree) and the eight warp sums in warp order into one partial
//   per tile; the last block to take the ticket adds the partials in tile
//   order (per thread a strided run, then a block tree) and writes the 0-d
//   output. The order depends on the table only, not on the grid, so cost
//   and finish (whose occupancies differ) add the same slot costs alike:
//   finish at x = 0 with every point fixed returns the cost bit for bit,
//   and a call's cost repeats to the bit. The ticket is 0 between launches
//   (the last block resets it); the output needs no zeroing.
//
// A masked slot is not read at all, where the plain versions add its
// J x, which is 0: J is zero wherever the mask is (res_and_jac gives it
// so), so the results agree wherever x is finite.
//
// What still bounds them on the H100: finish reads its live bytes at
// about 1.8 TB/s, half its live-slot bound; the cost, at a quarter of
// its live-slot bound, is held by each tile's instructions and latencies
// rather than by its copies (four stages in flight took the same time).
//
// Mixed-model bundles: both kernels on the Mixed<NPM> camera policy
// (ba_device.cuh), one instance per mixed width; each observation's
// residual switches on its camera's selector at run time, and an id that
// names no listed model projects to pixel 0, as the reference's
// where-chain (ba_math.img_from_cam_cf) gives.
#include "ba_device.cuh"

constexpr int kCostThreads = BA_BLOCK;  // one thread per slot of a tile
constexpr int kCostSlots = 256;         // track slots (T x columns) per tile
constexpr int kCostMaxT = 64;           // the bucket ladder's longest tracks
constexpr int kCostMaxP = 128;          // columns per tile at most
constexpr int kCostMaxBuckets = 16;
constexpr int kCostCols = 13;  // finish's per-column values: Vinv 6 | g_pt 3 | point 3 | free 1
static_assert(kCostThreads == kCostSlots, "one thread per slot");

// One row of the bucket table (sfm/_cuda.py _CostBucket): the bucket's
// operands, its T and P, its tile width and its first tile. finish reads
// J [2, 9+NP, T, P], vinv [6, P], gpt [3, P], pfree [P] and writes new_pts
// [3, P]; cost leaves them null.
struct CostBucket {
  const float* J;
  const float* vinv;
  const float* gpt;
  const int* img;     // [T, P]
  const int* cam;     // [T, P]
  const float* xy;    // [2, T, P]
  const float* mask;  // [T, P]
  const float* pts;   // [3, P]
  const float* pfree;
  float* new_pts;
  int T, P, tile_p, first_tile;
};

struct CostTable {
  CostBucket b[kCostMaxBuckets];
  int nb, n_tiles;
};

// floats of one stage: finish J [2 NJ][256], img and cam [2][256] and the
// per-column values [13][128]; cost img and cam [2][256] and the point of
// each slot [3][256]
template <bool FINISH>
__host__ __device__ constexpr int cost_stage_floats(int nj) {
  return FINISH ? (2 * nj + 2) * kCostSlots + kCostCols * kCostMaxP : 5 * kCostSlots;
}

// dynamic shared memory: two stages, and finish's column sums [3][256] and
// new points [3][128]
template <bool FINISH>
__host__ __device__ constexpr size_t cost_smem_bytes(int nj) {
  return (size_t)4 * (2 * cost_stage_floats<FINISH>(nj) +
                      (FINISH ? 3 * kCostSlots + 3 * kCostMaxP : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// This thread's slot of a tile: bucket bi, column p of the tile (col of
// the bucket), slot g; `mine` when the slot exists, o its offset in a
// [T, P] plane.
struct SlotOf {
  int bi, lg, p, g, col;
  bool on, mine;
  size_t o;
};

__device__ __forceinline__ SlotOf slot_of(const CostTable& tab, int tile) {
  int bi = 0;
  while (bi + 1 < tab.nb && tile >= tab.b[bi + 1].first_tile) ++bi;
  const CostBucket& B = tab.b[bi];
  SlotOf s;
  s.bi = bi;
  s.lg = __ffs(B.tile_p) - 1;
  s.p = threadIdx.x & (B.tile_p - 1);
  s.g = threadIdx.x >> s.lg;
  s.col = (tile - B.first_tile) * B.tile_p + s.p;
  s.on = s.col < B.P;
  s.mine = s.on && s.g < B.T;
  s.o = (size_t)s.g * B.P + s.col;
  return s;
}

// the mask of this thread's slot of a tile (0 where it has none)
__device__ __forceinline__ float slot_mask(const CostTable& tab, int tile) {
  if (tile >= tab.n_tiles) return 0.f;
  const SlotOf s = slot_of(tab, tile);
  return s.mine ? __ldg(tab.b[s.bi].mask + s.o) : 0.f;
}

// Copy what this thread reads of a tile into stage `st`: a live slot's
// indices and J row pieces (finish) or point (cost); in finish the slot-0
// thread of each column also the column's 13 values. A live slot's xy
// comes into registers (xy, used a tile later).
template <int NJ, bool FINISH>
__device__ __forceinline__ void stage_tile(const CostTable& tab, int tile, float m, float* st,
                                           float2& xy) {
  constexpr int NT = kCostThreads;
  const SlotOf s = slot_of(tab, tile);
  const CostBucket& B = tab.b[s.bi];
  const int tid = threadIdx.x;
  int* sIdx = reinterpret_cast<int*>(st + (FINISH ? 2 * NJ * NT : 0));
  if (m != 0.f) {  // 0 unless the slot exists
    xy.x = __ldg(B.xy + s.o);
    xy.y = __ldg(B.xy + (size_t)B.T * B.P + s.o);
    cp_async4(sIdx + tid, B.img + s.o);
    cp_async4(sIdx + NT + tid, B.cam + s.o);
    if constexpr (FINISH) {
      const size_t plane = (size_t)B.T * B.P;  // J row r = residual * NJ + column
#pragma unroll
      for (int r = 0; r < 2 * NJ; ++r) cp_async4(st + r * NT + tid, B.J + r * plane + s.o);
    } else {
      float* sPt = st + 2 * NT;
#pragma unroll
      for (int a = 0; a < 3; ++a) cp_async4(sPt + a * NT + tid, B.pts + (size_t)a * B.P + s.col);
    }
  }
  if constexpr (FINISH) {
    if (s.on && s.g == 0) {
      float* sCol = st + (2 * NJ + 2) * NT + s.p;
      const size_t P = B.P;
#pragma unroll
      for (int v = 0; v < 6; ++v) cp_async4(sCol + v * kCostMaxP, B.vinv + v * P + s.col);
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        cp_async4(sCol + (6 + a) * kCostMaxP, B.gpt + a * P + s.col);
        cp_async4(sCol + (9 + a) * kCostMaxP, B.pts + a * P + s.col);
      }
      cp_async4(sCol + 12 * kCostMaxP, B.pfree + s.col);
    }
  }
}

// The robust cost of one live slot at point X and the given parameters
// (quat [I, 4], trans [I, 3], intr [C, NP]); cost and finish share it, so
// at the same inputs they give the same bits.
template <class Cam>
__device__ __forceinline__ float slot_cost(const float* quat, const float* trans,
                                           const float* intr, int models, int ii, int ci,
                                           float X0, float X1, float X2, float x0, float x1,
                                           float m, int loss, float scale) {
  constexpr int NP = Cam::NP;
  float q[4], tt[3], k[NP];
  load_qt(quat, trans, ii, q, tt);
#pragma unroll
  for (int j = 0; j < NP; ++j) k[j] = __ldg(intr + ci * NP + j);
  float rx, ry;
  Cam::res(models, k, q, tt, X0, X1, X2, x0, x1, m, rx, ry);
  return robust_cost(rx * rx + ry * ry, loss, scale) * m;
}

// The body of both kernels over the table (see the note at the top).
// quat, trans, intr: the parameters the cost is taken at (finish: the
// updated ones); xpose [I, 6], xintr [C, NP]: finish's CG solution.
// partials: one float per tile; ticket: 0 before and after; out: 0-d.
template <class Cam, bool FINISH>
__device__ __forceinline__ void cost_tiles(const CostTable& tab, const float* __restrict__ quat,
                                           const float* __restrict__ trans,
                                           const float* __restrict__ intr,
                                           const float* __restrict__ xpose,
                                           const float* __restrict__ xintr, int loss,
                                           float scale, int models,
                                           float* __restrict__ partials,
                                           int* __restrict__ ticket, float* __restrict__ out) {
  constexpr int NP = Cam::NP, NK = 6 + NP, NJ = 9 + NP;
  constexpr int NT = kCostThreads, W = NT / 32;
  constexpr int kStage = cost_stage_floats<FINISH>(NJ);
  extern __shared__ __align__(16) float cost_smem[];
  float* ybuf = cost_smem + 2 * kStage;  // finish: [3][NT] column sums
  float* xbuf = ybuf + 3 * NT;           // finish: [3][kCostMaxP] new points
  __shared__ float wsum[2][W];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int step = gridDim.x;

  // the masks run two tiles ahead, the copies and xy one
  int tile = blockIdx.x;
  float m_cur = slot_mask(tab, tile);
  float2 xy_cur = make_float2(0.f, 0.f), xy_nxt = xy_cur;
  if (tile < tab.n_tiles) stage_tile<NJ, FINISH>(tab, tile, m_cur, cost_smem, xy_cur);
  cp_async_commit();
  float m_nxt = slot_mask(tab, tile + step);
  for (int it = 0; tile < tab.n_tiles; ++it, tile += step) {
    const int next = tile + step;
    if (next < tab.n_tiles)
      stage_tile<NJ, FINISH>(tab, next, m_nxt, cost_smem + ((it + 1) & 1) * kStage, xy_nxt);
    cp_async_commit();
    const float m_after = slot_mask(tab, next + step);
    cp_async_wait1();  // this thread's copies of this tile are in
    const float* st = cost_smem + (it & 1) * kStage;

    const SlotOf s = slot_of(tab, tile);
    const CostBucket& B = tab.b[s.bi];
    const float m = m_cur;
    const bool live = m != 0.f;
    const int* sIdx = reinterpret_cast<const int*>(st + (FINISH ? 2 * NJ * NT : 0));
    int ii = 0, ci = 0;
    if (live) {
      ii = sIdx[tid];
      ci = sIdx[NT + tid];
    }
    float X0, X1, X2;
    if constexpr (FINISH) {
      // --- back-substitution: X = pts - Vinv (g_pt - J_p^T J_c x) pf ----
      float y0 = 0.f, y1 = 0.f, y2 = 0.f;
      if (live) {
        const float* c0 = st + tid;    // J column 0, residual x
        const float* c1 = c0 + NJ * NT;  // residual y
        float a0 = 0.f, a1 = 0.f;
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          const float xk = k < 6 ? __ldg(xpose + ii * 6 + k) : __ldg(xintr + ci * NP + k - 6);
          a0 += c0[k * NT] * xk;
          a1 += c1[k * NT] * xk;
        }
        y0 = c0[NK * NT] * a0 + c1[NK * NT] * a1;
        y1 = c0[(NK + 1) * NT] * a0 + c1[(NK + 1) * NT] * a1;
        y2 = c0[(NK + 2) * NT] * a0 + c1[(NK + 2) * NT] * a1;
      }
      ybuf[tid] = y0;
      ybuf[NT + tid] = y1;
      ybuf[2 * NT + tid] = y2;
      __syncthreads();
      if (s.on && s.g == 0) {  // the column's slots' sums, in slot order
        float b0 = 0.f, b1 = 0.f, b2 = 0.f;
        for (int h = 0; h < B.T; ++h) {
          const int q = (h << s.lg) + s.p;
          b0 += ybuf[q];
          b1 += ybuf[NT + q];
          b2 += ybuf[2 * NT + q];
        }
        const float* c = st + (2 * NJ + 2) * NT + s.p;
        const float va = c[0], vb = c[kCostMaxP], vc = c[2 * kCostMaxP];
        const float vd = c[3 * kCostMaxP], ve = c[4 * kCostMaxP], vf = c[5 * kCostMaxP];
        const float r0 = c[6 * kCostMaxP] - b0, r1 = c[7 * kCostMaxP] - b1,
                    r2 = c[8 * kCostMaxP] - b2;
        const float pf = c[12 * kCostMaxP];
        const float n0 = c[9 * kCostMaxP] - (va * r0 + vb * r1 + vc * r2) * pf;
        const float n1 = c[10 * kCostMaxP] - (vb * r0 + vd * r1 + ve * r2) * pf;
        const float n2 = c[11 * kCostMaxP] - (vc * r0 + ve * r1 + vf * r2) * pf;
        xbuf[s.p] = n0;
        xbuf[kCostMaxP + s.p] = n1;
        xbuf[2 * kCostMaxP + s.p] = n2;
        const size_t P = B.P;
        B.new_pts[s.col] = n0;
        B.new_pts[P + s.col] = n1;
        B.new_pts[2 * P + s.col] = n2;
      }
      __syncthreads();
      X0 = xbuf[s.p];
      X1 = xbuf[kCostMaxP + s.p];
      X2 = xbuf[2 * kCostMaxP + s.p];
    } else {
      const float* sPt = st + 2 * NT;
      X0 = sPt[tid];
      X1 = sPt[NT + tid];
      X2 = sPt[2 * NT + tid];
    }

    // --- the tile's partial: slot costs per warp, warps in order --------
    float c = 0.f;
    if (live)
      c = slot_cost<Cam>(quat, trans, intr, models, ii, ci, X0, X1, X2, xy_cur.x, xy_cur.y, m,
                         loss, scale);
    c = warp_sum(c);
    if (lane == 0) wsum[it & 1][warp] = c;
    __syncthreads();
    if (tid == 0) {
      float v = 0.f;
#pragma unroll
      for (int w = 0; w < W; ++w) v += wsum[it & 1][w];
      partials[tile] = v;
    }
    m_cur = m_nxt;
    m_nxt = m_after;
    xy_cur = xy_nxt;
  }

  // --- the last block adds the partials in tile order ------------------
  __shared__ int last;
  __syncthreads();
  if (tid == 0) {
    __threadfence();  // this block's partials are visible before its ticket
    last = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  }
  __syncthreads();
  if (last) {
    __threadfence();
    const int n = tab.n_tiles;
    float v = 0.f;
    for (int i0 = 0; i0 < n; i0 += 8 * NT) {  // loaded 8 at a time, added in order
      float q[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * NT + tid;
        q[u] = i < n ? __ldcg(partials + i) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) v += q[u];
    }
    v = block_sum(v);
    if (tid == 0) {
      *out = v;
      *ticket = 0;  // ready for the next launch
    }
  }
}

template <class Cam>
__global__ void __launch_bounds__(kCostThreads, 3)
cost_kernel(const __grid_constant__ CostTable tab, const float* __restrict__ quat,
            const float* __restrict__ trans, const float* __restrict__ intr, int loss, float scale,
            int models, float* __restrict__ partials, int* __restrict__ ticket,
            float* __restrict__ out) {
  cost_tiles<Cam, false>(tab, quat, trans, intr, nullptr, nullptr, loss, scale, models, partials,
                         ticket, out);
}

template <class Cam>
__global__ void __launch_bounds__(kCostThreads, 2)
finish_kernel(const __grid_constant__ CostTable tab, const float* __restrict__ quat,
              const float* __restrict__ trans, const float* __restrict__ intr,
              const float* __restrict__ xpose, const float* __restrict__ xintr, int loss,
              float scale, int models, float* __restrict__ partials, int* __restrict__ ticket,
              float* __restrict__ out) {
  cost_tiles<Cam, true>(tab, quat, trans, intr, xpose, xintr, loss, scale, models, partials,
                        ticket, out);
}

BA_DEFINE_ERROR_STRING

// The table's contract (cg_kernel.py cost_table): 1-16 buckets in tile
// order, T 1..64, tile_p a power of two of at most 128 with T tile_p <=
// 256, any P >= 0; the operands the kernel reads or writes non-null.
static bool cost_table_ok(const CostTable& tab, bool finish) {
  if (tab.nb < 1 || tab.nb > kCostMaxBuckets || tab.n_tiles < 0) return false;
  int first = 0;
  for (int i = 0; i < tab.nb; ++i) {
    const CostBucket& b = tab.b[i];
    if (b.T < 1 || b.T > kCostMaxT || b.P < 0 || b.tile_p < 1 || b.tile_p > kCostMaxP ||
        (b.tile_p & (b.tile_p - 1)) || b.T * b.tile_p > kCostSlots || b.first_tile != first)
      return false;
    if (!b.img || !b.cam || !b.xy || !b.mask || !b.pts) return false;
    if (finish && (!b.J || !b.vinv || !b.gpt || !b.pfree || !b.new_pts)) return false;
    first += (b.P + b.tile_p - 1) / b.tile_p;
  }
  return first == tab.n_tiles;
}

// The resident blocks per SM of a kernel instance (its dynamic shared
// memory limit raised once).
template <class Cam, bool FINISH>
static int cost_occupancy(const void* kernel, int* per_sm) {
  static int known = 0;
  if (known == 0) {
    const size_t bytes = cost_smem_bytes<FINISH>(9 + Cam::NP);
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
    int n = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kCostThreads, bytes);
    if (e != cudaSuccess) return (int)e;
    if (n < 1) return (int)cudaErrorInvalidConfiguration;
    known = n;
  }
  *per_sm = known;
  return 0;
}

// A kernel instance's resident blocks per SM and dynamic shared memory.
template <class Cam, bool FINISH>
static int cost_config(int* per_sm, int* bytes) {
  *bytes = (int)cost_smem_bytes<FINISH>(9 + Cam::NP);
  const void* kernel =
      FINISH ? (const void*)&finish_kernel<Cam> : (const void*)&cost_kernel<Cam>;
  return cost_occupancy<Cam, FINISH>(kernel, per_sm);
}

// One launch over the table: a grid of the resident blocks, at most one
// per tile (at least one, which writes 0 for a table without tiles).
template <class Cam, bool FINISH>
static int cost_launch(const CostTable* tab, const float* quat, const float* trans,
                       const float* intr, const float* xpose, const float* xintr, int loss,
                       float scale, int models, float* partials, int* ticket, float* out,
                       cudaStream_t s) {
  if (!cost_table_ok(*tab, FINISH) || !quat || !trans || !intr || !partials || !ticket || !out ||
      (FINISH && (!xpose || !xintr)))
    return (int)cudaErrorInvalidValue;
  int per_sm = 0, smem = 0;
  const int err = cost_config<Cam, FINISH>(&per_sm, &smem);
  if (err) return err;
  int blocks = ba_sm_count() * per_sm;
  if (blocks > tab->n_tiles) blocks = tab->n_tiles;
  if (blocks < 1) blocks = 1;
  const size_t bytes = cost_smem_bytes<FINISH>(9 + Cam::NP);
  if constexpr (FINISH)
    finish_kernel<Cam><<<blocks, kCostThreads, bytes, s>>>(*tab, quat, trans, intr, xpose, xintr,
                                                           loss, scale, models, partials, ticket,
                                                           out);
  else
    cost_kernel<Cam><<<blocks, kCostThreads, bytes, s>>>(*tab, quat, trans, intr, loss, scale,
                                                         models, partials, ticket, out);
  return (int)cudaGetLastError();
}

// cost: quat [I, 4], trans [I, 3], intr [C, NP] (NP the model's count);
// partials one float per tile of `tab`, ticket 0 before and after; out the
// 0-d total.
extern "C" int ba_cost(int model, const CostTable* tab, const float* quat, const float* trans,
                       const float* intr, int loss, float scale, float* partials, int* ticket,
                       float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (model) {
#define X(M)                                                                                 \
  case M:                                                                                    \
    return cost_launch<Single<M>, false>(tab, quat, trans, intr, nullptr, nullptr, loss,     \
                                         scale, 0, partials, ticket, out, s);
    BA_FOR_EACH_MODEL(X)
#undef X
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// finish: as cost at the updated parameters, with the CG solution xpose
// [I, 6] and xintr [C, NP]; the new points go to the table's new_pts.
extern "C" int ba_finish(int model, const CostTable* tab, const float* quat, const float* trans,
                         const float* intr, const float* xpose, const float* xintr, int loss,
                         float scale, float* partials, int* ticket, float* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (model) {
#define X(M)                                                                                  \
  case M:                                                                                     \
    return cost_launch<Single<M>, true>(tab, quat, trans, intr, xpose, xintr, loss, scale, 0, \
                                        partials, ticket, out, s);
    BA_FOR_EACH_MODEL(X)
#undef X
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// np, models: as ba_resjac_mixed (an unlisted id projects to pixel 0 here,
// so there is no `first`)
extern "C" int ba_cost_mixed(int np, int models, const CostTable* tab, const float* quat,
                             const float* trans, const float* intr, int loss, float scale,
                             float* partials, int* ticket, float* out, void* stream) {
  if (!mixed_args_ok(np, models)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (np) {
#define X(N)                                                                                 \
  case N:                                                                                    \
    return cost_launch<Mixed<N>, false>(tab, quat, trans, intr, nullptr, nullptr, loss,      \
                                        scale, models, partials, ticket, out, s);
    BA_FOR_EACH_MIXED_NP(X)
#undef X
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int ba_finish_mixed(int np, int models, const CostTable* tab, const float* quat,
                               const float* trans, const float* intr, const float* xpose,
                               const float* xintr, int loss, float scale, float* partials,
                               int* ticket, float* out, void* stream) {
  if (!mixed_args_ok(np, models)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (np) {
#define X(N)                                                                                  \
  case N:                                                                                     \
    return cost_launch<Mixed<N>, true>(tab, quat, trans, intr, xpose, xintr, loss, scale,    \
                                       models, partials, ticket, out, s);
    BA_FOR_EACH_MIXED_NP(X)
#undef X
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The resident blocks per SM and dynamic shared memory of cost (finish 0)
// or finish (1) for model `id` (mixed 0) or at mixed width `id` (mixed 1);
// the stream is unused.
extern "C" int ba_cost_config(int finish, int mixed, int id, int* blocks_per_sm, int* bytes,
                              void*) {
  if (!mixed) {
    switch (id) {
#define X(M)                                                                      \
  case M:                                                                         \
    return finish ? cost_config<Single<M>, true>(blocks_per_sm, bytes)            \
                  : cost_config<Single<M>, false>(blocks_per_sm, bytes);
      BA_FOR_EACH_MODEL(X)
#undef X
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  switch (id) {
#define X(N)                                                                      \
  case N:                                                                         \
    return finish ? cost_config<Mixed<N>, true>(blocks_per_sm, bytes)             \
                  : cost_config<Mixed<N>, false>(blocks_per_sm, bytes);
    BA_FOR_EACH_MIXED_NP(X)
#undef X
    default:
      return (int)cudaErrorInvalidValue;
  }
}
