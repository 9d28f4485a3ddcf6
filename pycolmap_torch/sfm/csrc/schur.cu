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
// matvec16 computes the same S x from J packed to bf16 in the reference's
// pack_j_bf16 layout [9+NP, 2T, P]: plane k holds column k, rows 0..T-1 for
// residual x and T..2T-1 for residual y. Each bf16 is widened to f32
// exactly (its 16 bits are the high half of the f32) and everything
// accumulates in f32, as the reference's body does.
//
// Bound: bytes, each operand read once. J (4 or 2 bytes a value, 8 (9+NP)
// or 4 (9+NP) bytes a track slot: 109 or 54.5 MB at the bench shape), the
// two index grids (8.4 MB), prepare's residual (8.4 MB) or the matvec's
// Vinv (3.1 MB), and the per-point and per-image outputs: ~0.039 ms for
// prepare, ~0.036 for the f32 matvec and ~0.020 for matvec16 at 3.35 TB/s.
// The arithmetic is a few hundred flops per slot.
//
// Design: the three kernels share one machinery.
// - One launch per call over a table of all buckets (TileTable, passed by
//   value, built by cg_kernel.py: once per LM step for the matvecs, once
//   per call for prepare). A bucket's columns are cut into tiles of T
//   tile_p <= 256 slots, tile_p a power of two from 4 to 128 (64 at T = 4,
//   32 at T = 8, 4 at the ladder's longest T = 64); each block of a
//   persistent grid takes a contiguous run of tiles.
// - Each tile (its J rows, both index grids, and Vinv or the residual)
//   arrives in shared memory by cp.async, 16 bytes a copy (8 for bf16 J in
//   4-column tiles), into one of two stages: the next tile's copy runs
//   under this tile's two passes, and both passes read the staged copy, so
//   J is read from memory once. Every column of a tile lies whole in it.
//   (One TMA bulk copy per 128-byte row fetched matvec16's tiles at
//   ~0.7 TB/s; larger tiles or a third stage lowered the blocks per SM and
//   lost more than they gained. f32 tiles of 128 slots, the stage bytes of
//   matvec16's, fetched 64-byte row pieces and ran the f32 matvec 9%
//   slower than 256-slot tiles.)
// - Pass 1 sums over each column's track (the matvec's y = J_p^T J_c x;
//   prepare's V and g_pt), the threads of one column adding their parts in
//   slot order; pass 2 scatters per slot (the matvec's 6 image and NP
//   camera values; prepare's 33 image and 2 NP camera values).
// - Lanes sharing a row hand their values to one lane (scatter_plan), so
//   one lane per distinct row adds, and an atomic add skips a zero (a
//   fixed parameter's column: with one camera these doubled the atomics on
//   its row).
// - Where the sums live follows from the shared memory they take
//   (tile_pick). Fixed order: the accumulators are added without atomics
//   (the matvecs: one per warp, x in shared memory too; prepare: one per
//   block, its warps taking turns over groups of values), the blocks of an
//   8-block cluster add theirs through distributed shared memory in a fixed
//   order, each cluster writes one partial row, and the last cluster to
//   take the ticket adds the rows in cluster order into the outputs: the
//   outputs need no zeroing, no atomics remain, and the result is the same
//   to the bit from run to run. The grid holds only as many clusters as the
//   card keeps resident at once (a cluster lies within one GPC: 62 of
//   matvec16's 66 at the bench, 30 of prepare's 33; the rest ran as a
//   second wave and cost matvec16 15%). Block: one shared accumulator per
//   block (shared atomics, which are compare-and-swap loops on the H100),
//   flushed by global atomics into zeroed outputs (the matvecs only).
//   Global: global atomics per row. The matvecs take the first mode that
//   leaves 16 resident warps per SM (on the H100 matvec16's per-warp mode
//   at 3 blocks per SM lost to the block's sums, and the block's sums at 1
//   block per SM to global atomics); prepare takes the fixed order wherever
//   its 33 I + 2 C NP floats and its rhs, 6 I + C NP doubles, fit.
// What still bounds them: the reads of J rows 64-128 bytes at a time from
// rows a plane apart run at ~1.2-1.7 TB/s on the H100 (a fetch-only
// variant of matvec16); a tile-contiguous J layout would stream. Prepare's
// turns (eight per tile, a __syncthreads each) take about half its time.
#include <cooperative_groups.h>

#include <type_traits>

#include "ba_device.cuh"

namespace cg = cooperative_groups;

constexpr int kImgRows = 33;        // prepare: 6 rhs | 6 diag(U) | 21 packed 6x6 block
constexpr int kTileSlots = 256;     // track slots (T x columns) per tile
constexpr int kTileMaxT = 64;       // the longest bucket: 4-column tiles
constexpr int kTileMaxP = 128;      // columns per tile at most
constexpr int kTileMaxBuckets = 8;
constexpr int kTileCluster = 8;     // blocks whose sums meet in DSMEM
constexpr int kTileMaxPerSm = 8;    // resident blocks per SM the grid takes
constexpr int kTileStages = 2;      // tiles in shared memory per block

// The three kernels over a tile table.
enum TileKind { kMatvec16 = 0, kMatvec = 1, kPrepare = 2 };
// Where a launch keeps its sums (tile_pick chooses). Fixed: shared
// accumulators added without atomics and summed across blocks in a fixed
// order (the matvecs: one per warp; prepare: one per block, its warps
// taking turns); block: one shared accumulator per block (shared atomics)
// flushed by global atomics (the matvecs only); global: global atomics.
enum TileSums { kSumsGlobal = 0, kSumsBlock = 1, kSumsFixed = 2 };
constexpr int kMinWarps = 16;  // resident warps per SM a mode must leave

// bytes of one J value
__host__ __device__ constexpr int tile_esize(int kind) { return kind == kMatvec16 ? 2 : 4; }

// Threads per block. matvec16: 256 for the block's shared sums (its
// shared memory per thread halves and it ran faster at 256 on the H100),
// 128 otherwise (its fixed order sums per warp, in shared memory per warp;
// the global atomics ran faster at 128). The f32 kernels: one thread per
// slot of a tile in every mode (their stages are twice matvec16's: at 128
// threads the f32 matvec's fixed order would leave 8 warps per SM).
__host__ __device__ constexpr int tile_threads(int kind, int sums) {
  return kind != kMatvec16 ? kTileSlots : sums == kSumsBlock ? 256 : 128;
}

// One row of the bucket table (sfm/_cuda.py _TileBucket): the bucket's
// operands, its T and P (P % 8 == 0), its tile width and its first tile.
// matvec16 reads J as bf16 [9+NP, 2T, P], the others as f32
// [2, 9+NP, T, P]; the matvecs read vinv, prepare reads res and writes
// vinv and gpt.
struct TileBucket {
  const void* J;
  const float* res;  // [2, T, P]
  const int* img;    // [T, P]
  const int* cam;    // [T, P]
  float* vinv;       // [6, P]
  float* gpt;        // [3, P]
  int T, P, tile_p, first_tile;
};

struct TileTable {
  TileBucket b[kTileMaxBuckets];
  int nb, n_tiles;
};

// A stage holds one tile: J [2 (9+NP) T, tile_p], then img and cam
// [T, tile_p], then Vinv [6, tile_p] or prepare's residual [2T, tile_p];
// T tile_p <= kTileSlots bounds it.
__host__ __device__ constexpr size_t tile_stage_bytes(int kind, int nj) {
  return (size_t)2 * nj * kTileSlots * tile_esize(kind) + (size_t)2 * kTileSlots * 4 +
         (kind == kPrepare ? (size_t)2 * kTileSlots * 4 : (size_t)6 * kTileMaxP * 4);
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

// a J value as f32: a bf16 is the high half of an f32 (exact)
__device__ __forceinline__ float ldj(unsigned short b) { return __uint_as_float((unsigned)b << 16); }
__device__ __forceinline__ float ldj(float v) { return v; }

template <int KIND>
using TileElem = typename std::conditional<KIND == kMatvec16, unsigned short, float>::type;

__device__ __forceinline__ int tile_bucket(const TileTable& tab, int tile) {
  int bi = 0;
  while (bi + 1 < tab.nb && tile >= tab.b[bi + 1].first_tile) ++bi;
  return bi;
}

// The block puts one tile in flight, 16 bytes a thread and copy (8 for
// bf16 J in 4-column tiles): 2 NJ T rows of J, T of img and of cam, then 6
// of Vinv or 2T of the residual, each tile_p columns wide (fewer at a
// bucket's edge).
template <int KIND, int NJ, int NT>
__device__ void tile_fetch(const TileTable& tab, int tile, unsigned char* st) {
  using E = TileElem<KIND>;
  constexpr int LES = KIND == kMatvec16 ? 1 : 2;  // log2 of a J value's bytes
  const TileBucket& B = tab.b[tile_bucket(tab, tile)];
  const int T = B.T, P = B.P, TP = B.tile_p;
  const int p0 = (tile - B.first_tile) * TP;
  const int ncol = min(TP, P - p0);
  const int lg = __ffs(TP) - 1;  // tile_p is a power of two, at least 4
  const bool j16 = KIND != kMatvec16 || lg >= 3;  // 16-byte copies of J
  const int je = (j16 ? 4 : 3) - LES;  // log2 of the J values a copy moves
  constexpr int ie = 2;                // 4 values of 4 bytes a copy
  const int nx = KIND == kPrepare ? 2 * T : 6;
  const int nj = (2 * NJ * T) << (lg - je), ni = (2 * T + nx) << (lg - ie);
  E* sJ = reinterpret_cast<E*>(st);
  int* sIdx = reinterpret_cast<int*>(st + (size_t)2 * NJ * T * TP * sizeof(E));
  float* sX = reinterpret_cast<float*>(sIdx + 2 * T * TP);
  const E* J = static_cast<const E*>(B.J);
  const float* X = KIND == kPrepare ? B.res : B.vinv;
  for (int q = threadIdx.x; q < nj + ni; q += NT) {
    if (q < nj) {  // J
      const int r = q >> (lg - je), c = (q & ((TP >> je) - 1)) << je;
      if (c >= ncol) continue;
      if (j16)
        cp_async16(sJ + r * TP + c, J + (size_t)r * P + p0 + c);
      else
        cp_async8(sJ + r * TP + c, J + (size_t)r * P + p0 + c);
    } else {  // img, cam, then Vinv or the residual
      const int q2 = q - nj, r = q2 >> (lg - ie), c = (q2 & ((TP >> ie) - 1)) << ie;
      if (c >= ncol) continue;
      void* dst;
      const void* src;
      if (r < 2 * T) {
        dst = sIdx + r * TP + c;
        src = (r < T ? B.img + (size_t)r * P : B.cam + (size_t)(r - T) * P) + p0 + c;
      } else {
        dst = sX + (r - 2 * T) * TP + c;
        src = X + (size_t)(r - 2 * T) * P + p0 + c;
      }
      cp_async16(dst, src);
    }
  }
}

// How a warp adds its lanes' values into their rows (< 0: none), decided
// once per set of rows (warp_scatter): the lanes sharing a row hand their
// values to the lowest of them, which adds them in lane order (HANDOFF),
// so one lane per distinct row adds; when every lane with a row has the
// same one (a camera row, mostly) the warp sums by warp_sum's tree, the
// other lanes giving zeros (ONE_ROW), and when a few rows hold large
// groups (two cameras in alternate lanes) by one butterfly sum per row
// (FEW_ROWS). The order depends only on the rows.
enum ScatterHow { kScatterNone, kScatterOneRow, kScatterFewRows, kScatterHandoff };

struct ScatterPlan {
  int dst;          // the row this lane adds into
  unsigned peers;   // HANDOFF: the lanes of this lane's row
  unsigned leads;   // FEW_ROWS: the lowest lane of each row
  bool adds;        // this lane adds
  int how;          // ScatterHow, the same in every lane
};

// All 32 lanes must call it.
__device__ __forceinline__ ScatterPlan scatter_plan(int row) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  ScatterPlan s{row, 0u, 0u, false, kScatterNone};
  const unsigned rows = __ballot_sync(full, row >= 0);
  if (rows == 0u) return s;
  const int first = __shfl_sync(full, row, __ffs(rows) - 1);
  if (__all_sync(full, row < 0 || row == first)) {
    s.dst = first;
    s.adds = lane == 0;
    s.how = kScatterOneRow;
    return s;
  }
  s.peers = __match_any_sync(full, row);
  s.adds = row >= 0 && __ffs(s.peers) - 1 == lane;
  s.leads = __ballot_sync(full, s.adds);
  const unsigned largest = __reduce_max_sync(full, row >= 0 ? __popc(s.peers) : 0u);
  // a butterfly per row costs 5 shuffles a value, the hand-off one per
  // lane of the largest group but its first
  s.how = 5u * __popc(s.leads) < largest - 1u ? kScatterFewRows : kScatterHandoff;
  return s;
}

// Add each lane's N values (the first n of them) into its row `row` of an
// accumulator as planned. ATOMIC false: the warp's own accumulator, or one
// no other warp adds into meanwhile, plain adds (into float or, widening
// each sum of the warp, double entries); true: one shared by other warps
// or blocks, float atomics. All 32 lanes must call it.
template <int N, bool ATOMIC, class T = float>
__device__ __forceinline__ void scatter_apply(T* acc, const ScatterPlan& s, int row,
                                              int stride, const float* vals, int n = N) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  float v[N];
  if (s.how == kScatterNone) return;
  if (s.how == kScatterOneRow) {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = warp_sum(row >= 0 ? vals[k] : 0.f);
  } else if (s.how == kScatterFewRows) {
    for (unsigned todo = s.leads; todo; todo &= todo - 1u) {
      const int first_lane = __ffs(todo) - 1;
      const int r = __shfl_sync(full, row, first_lane);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        float t = row == r ? vals[k] : 0.f;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(full, t, o);
        if (lane == first_lane) v[k] = t;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < N; ++k) v[k] = vals[k];
    unsigned todo = s.adds ? s.peers & (s.peers - 1) : 0u;  // the group's other lanes
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
  if (s.adds) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (k >= n)
        break;
      if constexpr (!ATOMIC)
        acc[s.dst * stride + k] += (T)v[k];
      else if (v[k] != 0.f)  // a fixed parameter's zero column: no atomic
        atomicAdd(acc + s.dst * stride + k, v[k]);
    }
  }
}

// scatter_apply<N, false, double> for values whose rows are few (a
// camera's): where one row or a few hold the warp's lanes, each value is
// summed over the lanes in double and added at once (a double per value
// held across the values cost the widest instances their registers);
// otherwise as scatter_apply, the warp's float sums added in double.
template <int N>
__device__ __forceinline__ void scatter_apply_wide(double* acc, const ScatterPlan& s, int row,
                                                   int stride, const float* vals) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  if (s.how == kScatterOneRow) {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      double t = row >= 0 ? (double)vals[k] : 0.0;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) t += __shfl_down_sync(full, t, o);
      if (s.adds) acc[s.dst * stride + k] += t;
    }
  } else if (s.how == kScatterFewRows) {
    for (unsigned todo = s.leads; todo; todo &= todo - 1u) {
      const int first_lane = __ffs(todo) - 1;
      const int r = __shfl_sync(full, row, first_lane);
#pragma unroll
      for (int k = 0; k < N; ++k) {
        double t = row == r ? (double)vals[k] : 0.0;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(full, t, o);
        if (lane == first_lane) acc[r * stride + k] += t;
      }
    }
  } else {
    scatter_apply<N, false, double>(acc, s, row, stride, vals);
  }
}

// scatter_plan and scatter_apply for one set of values.
template <int N, bool ATOMIC>
__device__ __forceinline__ void warp_scatter(float* acc, int row, int stride, const float* vals) {
  const ScatterPlan s = scatter_plan(row);
  scatter_apply<N, ATOMIC>(acc, s, row, stride, vals);
}

// Add each lane's nonzero N values into row `row` (< 0: none) of an
// accumulator in device memory by float atomics (no hand-off).
template <int N>
__device__ __forceinline__ void lane_atomics(float* acc, int row, int stride, const float* vals) {
  if (row >= 0) {
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (vals[k] != 0.f) atomicAdd(acc + row * stride + k, vals[k]);
  }
}

// The end of a launch whose sums live in shared memory. Block mode: the
// block's nonzero sums into the outputs by global atomics. Fixed mode: the
// blocks of a cluster add their W accumulators each (acc [W, n_acc])
// through DSMEM in (rank, accumulator) order into one partial row per
// cluster; the last cluster to take the ticket adds the rows in cluster
// order and writes the outputs whole. Entries below n0 go to out0, the
// rest to out1. The tile loop must have ended with a __syncthreads.
template <int SUMS, int NT, int W>
__device__ __forceinline__ void tile_finish(const float* acc, int n_acc, int n0,
                                            float* __restrict__ partials, int* __restrict__ ticket,
                                            float* __restrict__ out0, float* __restrict__ out1) {
  const int tid = threadIdx.x;
  if constexpr (SUMS == kSumsBlock) {
    // a thread with no tile reads back only its own zeros
    for (int i = tid; i < n_acc; i += NT)
      if (acc[i] != 0.f) atomicAdd(i < n0 ? out0 + i : out1 + i - n0, acc[i]);
  }
  if constexpr (SUMS == kSumsFixed) {
    cg::cluster_group cl = cg::this_cluster();
    cl.sync();  // every block's sums are complete
    const int cs = (int)cl.num_blocks(), rank = (int)cl.block_rank();
    const int cid = blockIdx.x / cs, ncl = gridDim.x / cs;
    for (int i = rank * NT + tid; i < n_acc; i += cs * NT) {
      float part[kTileCluster * W];  // loaded together, added in (rank, acc) order
#pragma unroll
      for (int r = 0; r < kTileCluster; ++r) {
        const float* racc = cl.map_shared_rank(acc, r < cs ? r : 0);
#pragma unroll
        for (int w = 0; w < W; ++w) part[r * W + w] = r < cs ? racc[w * n_acc + i] : 0.f;
      }
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < kTileCluster * W; ++k) v += part[k];
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
        if (i < n0)
          out0[i] = v;
        else
          out1[i - n0] = v;
      }
      if (rank == 0 && tid == 0) *ticket = 0;  // ready for the next launch
    }
  }
}

// S x for every bucket of the table, from bf16 J (matvec16) or f32 J
// (matvec). kSumsFixed: x lives in shared memory and each warp sums into
// its own shared accumulator without atomics (tile_finish adds them in a
// fixed order; the outputs need no zeroing). Otherwise x is read from
// global memory and the sums are float atomics, into a block's shared
// accumulator that is flushed into the outputs (kSumsBlock) or into the
// outputs (kSumsGlobal); the caller zeroes the outputs.
template <int KIND, int NP, int SUMS>
__device__ __forceinline__ void matvec_tiles(const TileTable& tab, const float* __restrict__ xpose,
                                             const float* __restrict__ xintr, int I, int C,
                                             float* __restrict__ partials, int* __restrict__ ticket,
                                             float* __restrict__ out_pose,
                                             float* __restrict__ out_intr) {
  using E = TileElem<KIND>;
  constexpr int NK = 6 + NP;
  constexpr int NJ = 9 + NP;
  constexpr int NT = tile_threads(KIND, SUMS);
  constexpr int W = NT / 32;
  constexpr int MAX_S = kTileSlots / NT;  // slots per thread
  constexpr size_t kStage = tile_stage_bytes(KIND, NJ);
  extern __shared__ __align__(128) unsigned char tile_smem[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int n_acc = I * 6 + C * NP;
  float* ybuf = reinterpret_cast<float*>(tile_smem + kTileStages * kStage);  // [G, tile_p, 3]
  constexpr bool kFixed = SUMS == kSumsFixed;
  float* xs = ybuf + NT * 3;              // kFixed: x [n_acc]
  float* acc = kFixed ? xs + n_acc : xs;  // kFixed: [W, n_acc]; kSumsBlock: [n_acc]
  const float* xp = kFixed ? xs : xpose;
  const float* xi = kFixed ? xs + I * 6 : xintr;
  float* apose = SUMS == kSumsGlobal ? out_pose : acc + (kFixed ? warp * n_acc : 0);
  float* aintr = SUMS == kSumsGlobal ? out_intr : apose + I * 6;
  if (kFixed)
    for (int i = tid; i < n_acc; i += NT) xs[i] = i < I * 6 ? xpose[i] : xintr[i - I * 6];
  if (SUMS != kSumsGlobal)
    for (int i = tid; i < (kFixed ? W : 1) * n_acc; i += NT) acc[i] = 0.f;

  // a block takes a contiguous run of tiles (the next ones continue each J
  // row where the last ones ended); the next kTileStages - 1 are in flight
  // while one is computed
  const int per = (tab.n_tiles + gridDim.x - 1) / gridDim.x;
  const int end = min((blockIdx.x + 1) * per, tab.n_tiles);
  int tile = blockIdx.x * per;
#pragma unroll
  for (int k = 0; k < kTileStages - 1; ++k) {
    if (tile + k < end) tile_fetch<KIND, NJ, NT>(tab, tile + k, tile_smem + k * kStage);
    cp_async_commit();
  }
  for (int it = 0; tile < end; ++it, ++tile) {
    // the stage refilled here was last read before the __syncthreads that
    // ended the previous tile
    const int ahead = tile + kTileStages - 1;
    if (ahead < end)
      tile_fetch<KIND, NJ, NT>(tab, ahead,
                               tile_smem + ((it + kTileStages - 1) % kTileStages) * kStage);
    cp_async_commit();
    cp_async_wait<kTileStages - 1>();  // this thread's copies of this tile are in
    __syncthreads();                   // and every thread's
    const unsigned char* st = tile_smem + (it % kTileStages) * kStage;

    const TileBucket& B = tab.b[tile_bucket(tab, tile)];
    const int T = B.T, TP = B.tile_p;
    const int lg = __ffs(TP) - 1;
    const int p0 = (tile - B.first_tile) * TP;
    const int G = NT >> lg;  // thread groups: group g takes slots g, g+G, ...
    const int p = tid & (TP - 1), g = tid >> lg;
    const bool on = p0 + p < B.P;
    // elements from one J column to the next, and from residual x's row to
    // residual y's: bf16 [NJ, 2T, TP], f32 [2, NJ, T, TP]
    const int rs = KIND == kMatvec16 ? 2 * T * TP : T * TP;
    const int ry = KIND == kMatvec16 ? T * TP : NJ * T * TP;
    const E* sJ = reinterpret_cast<const E*>(st);
    const int* sImg = reinterpret_cast<const int*>(st + (size_t)2 * NJ * T * TP * sizeof(E));
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
        const E* c0 = sJ + t * TP + p;  // column 0, residual x
        const E* c1 = c0 + ry;          // residual y
        ii[s] = sImg[t * TP + p];
        ci[s] = sCam[t * TP + p];
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int k = 0; k < NK; ++k) {
          const float xk = k < 6 ? xp[ii[s] * 6 + k] : xi[ci[s] * NP + k - 6];
          s0 += ldj(c0[k * rs]) * xk;
          s1 += ldj(c1[k * rs]) * xk;
        }
        a0[s] = s0;
        a1[s] = s1;
#pragma unroll
        for (int a = 0; a < 3; ++a)
          y[a] += ldj(c0[(NK + a) * rs]) * s0 + ldj(c1[(NK + a) * rs]) * s1;
      }
    }
    if (G > 1) {  // the groups' sums, added in group order
#pragma unroll
      for (int a = 0; a < 3; ++a) ybuf[tid * 3 + a] = y[a];
      __syncthreads();
      y[0] = y[1] = y[2] = 0.f;
      for (int h = 0; h < G; ++h) {
        const float q0 = ybuf[((h << lg) + p) * 3], q1 = ybuf[((h << lg) + p) * 3 + 1],
                    q2 = ybuf[((h << lg) + p) * 3 + 2];
        y[0] += q0;
        y[1] += q1;
        y[2] += q2;
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
      const E* c0 = sJ + t * TP + p;
      const E* c1 = c0 + ry;
      if (ii[s] >= 0) {
        d0 = a0[s] - (ldj(c0[NK * rs]) * z[0] + ldj(c0[(NK + 1) * rs]) * z[1] +
                      ldj(c0[(NK + 2) * rs]) * z[2]);
        d1 = a1[s] - (ldj(c1[NK * rs]) * z[0] + ldj(c1[(NK + 1) * rs]) * z[1] +
                      ldj(c1[(NK + 2) * rs]) * z[2]);
#pragma unroll
        for (int k = 0; k < 6; ++k) vals[k] = ldj(c0[k * rs]) * d0 + ldj(c1[k * rs]) * d1;
      }
      // a padded slot (all-zero J) has d = 0 and adds nothing
      const bool live = ii[s] >= 0 && (d0 != 0.f || d1 != 0.f);
      warp_scatter<6, !kFixed>(apose, live ? ii[s] : -1, 6, vals);
      const bool flush = live && prow >= 0 && ci[s] != prow;
      if (__any_sync(0xffffffffu, flush)) {
        warp_scatter<NP, !kFixed>(aintr, flush ? prow : -1, NP, pend);
        if (flush) {
#pragma unroll
          for (int j = 0; j < NP; ++j) pend[j] = 0.f;
        }
      }
      if (live) {
        prow = ci[s];
#pragma unroll
        for (int j = 0; j < NP; ++j)
          pend[j] += ldj(c0[(6 + j) * rs]) * d0 + ldj(c1[(6 + j) * rs]) * d1;
      }
    }
    warp_scatter<NP, !kFixed>(aintr, prow, NP, pend);
    __syncthreads();  // the stage and ybuf are free again
  }
  tile_finish<SUMS, NT, W>(acc, n_acc, I * 6, partials, ticket, out_pose, out_intr);
}

template <int NP, int SUMS>
__global__ void __launch_bounds__(tile_threads(kMatvec16, SUMS))
matvec16_kernel(const __grid_constant__ TileTable tab, const float* __restrict__ xpose,
                const float* __restrict__ xintr, int I, int C, float* __restrict__ partials,
                int* __restrict__ ticket, float* __restrict__ out_pose,
                float* __restrict__ out_intr) {
  matvec_tiles<kMatvec16, NP, SUMS>(tab, xpose, xintr, I, C, partials, ticket, out_pose,
                                    out_intr);
}

template <int NP, int SUMS>
__global__ void __launch_bounds__(tile_threads(kMatvec, SUMS))
matvec_kernel(const __grid_constant__ TileTable tab, const float* __restrict__ xpose,
              const float* __restrict__ xintr, int I, int C, float* __restrict__ partials,
              int* __restrict__ ticket, float* __restrict__ out_pose,
              float* __restrict__ out_intr) {
  matvec_tiles<kMatvec, NP, SUMS>(tab, xpose, xintr, I, C, partials, ticket, out_pose, out_intr);
}

// The end of a fixed-order prepare launch: tile_finish's sums for every
// image and camera value but the rhs, which the blocks keep in double
// (dacc [I 6 + C NP]) and which are summed the same way in double. The
// cluster's partial rows go to `partials`: floats [ncl, n_acc] (their rhs
// entries unused), then, from an 8-byte boundary, doubles [ncl, n_rhs];
// the last cluster adds the rows in cluster order and writes the outputs
// whole, each rhs rounded once to float.
template <int NP>
__device__ __forceinline__ void prepare_finish(const float* acc, const double* dacc, int I, int C,
                                               float* __restrict__ partials,
                                               int* __restrict__ ticket,
                                               float* __restrict__ out_img,
                                               float* __restrict__ out_cam) {
  constexpr int NT = kTileSlots, NC = 2 * NP;
  const int tid = threadIdx.x;
  const int n_img = I * kImgRows, n_acc = n_img + C * NC, n_rhs = I * 6 + C * NP;
  cg::cluster_group cl = cg::this_cluster();
  cl.sync();  // every block's sums are complete
  const int cs = (int)cl.num_blocks(), rank = (int)cl.block_rank();
  const int cid = blockIdx.x / cs, ncl = gridDim.x / cs;
  double* dpart = reinterpret_cast<double*>(partials + (((size_t)ncl * n_acc + 1) & ~(size_t)1));
  // a rhs entry of the float layout (its sums live in dacc)
  auto is_rhs = [&](int i) { return i < n_img ? i % kImgRows < 6 : (i - n_img) % NC < NP; };
  for (int i = rank * NT + tid; i < n_acc; i += cs * NT) {
    if (is_rhs(i)) continue;
    float part[kTileCluster];  // loaded together, added in rank order
#pragma unroll
    for (int r = 0; r < kTileCluster; ++r)
      part[r] = r < cs ? cl.map_shared_rank(acc, r)[i] : 0.f;
    float v = 0.f;
#pragma unroll
    for (int r = 0; r < kTileCluster; ++r) v += part[r];
    partials[(size_t)cid * n_acc + i] = v;
  }
  for (int i = rank * NT + tid; i < n_rhs; i += cs * NT) {
    double part[kTileCluster];
#pragma unroll
    for (int r = 0; r < kTileCluster; ++r)
      part[r] = r < cs ? cl.map_shared_rank(dacc, r)[i] : 0.0;
    double v = 0.0;
#pragma unroll
    for (int r = 0; r < kTileCluster; ++r) v += part[r];
    dpart[(size_t)cid * n_rhs + i] = v;
  }
  __threadfence();
  __shared__ int last;
  cl.sync();  // the cluster's partial rows are written and fenced
  if (rank == 0 && tid == 0) last = atomicAdd(ticket, 1) == ncl - 1;
  cl.sync();
  const bool is_last = *cl.map_shared_rank(&last, 0);
  cl.sync();  // rank 0's flag is read before any block leaves
  if (!is_last) return;
  __threadfence();
  for (int i = rank * NT + tid; i < n_acc; i += cs * NT) {
    if (is_rhs(i)) continue;
    float v = 0.f;  // rows loaded 32 at a time, added in cluster order
    for (int c0 = 0; c0 < ncl; c0 += 32) {
      float row[32];
#pragma unroll
      for (int c = 0; c < 32; ++c)
        row[c] = c0 + c < ncl ? __ldcg(partials + (size_t)(c0 + c) * n_acc + i) : 0.f;
#pragma unroll
      for (int c = 0; c < 32; ++c) v += row[c];
    }
    if (i < n_img)
      out_img[i] = v;
    else
      out_cam[i - n_img] = v;
  }
  for (int i = rank * NT + tid; i < n_rhs; i += cs * NT) {
    double v = 0.0;  // rows loaded 8 at a time, added in cluster order
    for (int c0 = 0; c0 < ncl; c0 += 8) {
      double row[8];
#pragma unroll
      for (int c = 0; c < 8; ++c)
        row[c] = c0 + c < ncl ? __ldcg(dpart + (size_t)(c0 + c) * n_rhs + i) : 0.0;
#pragma unroll
      for (int c = 0; c < 8; ++c) v += row[c];
    }
    if (i < I * 6)
      out_img[(i / 6) * kImgRows + i % 6] = (float)v;
    else
      out_cam[((i - I * 6) / NP) * NC + (i - I * 6) % NP] = (float)v;
  }
  if (rank == 0 && tid == 0) *ticket = 0;  // ready for the next launch
}

// The LM preparation for every bucket of the table: per column Vinv and
// g_pt (written to the table's vinv and gpt), per slot the 33 image and
// 2 NP camera values into acc_img [I, 33] and acc_cam [C, 2 NP]. One
// thread per slot of a tile (256), at most 128 registers, so that two
// blocks keep 16 warps per SM; from NP 8 one block per SM, whose 158-227
// registers spill nothing (at 128 the double rhs spilled 80-184 bytes a
// thread and ran phase 16's width 9 in 0.372 ms on an H100, one block
// 0.331, the float rhs 0.197 at two). kSumsFixed: one shared accumulator per
// block; a slot's values form 8 groups (image values 0-5, 6-11, ..., 30-32,
// the camera's rhs and its diagonal), and in step i of 8 warp w adds group
// (w + i) % 8 of its lanes' slots, handed to one lane per row
// (warp_scatter, plain adds), a __syncthreads between steps: no two warps
// add into one entry at once, no atomics remain, and every entry's adds
// come in a fixed order (prepare_finish then sums the blocks' accumulators
// in a fixed order and writes the outputs whole). The image and camera
// rhs, J_c^T (r - J_p V^-1 g_pt), are summed in double (a camera's over
// the warp too, the image's from each warp's float sums): at a converged
// model they are near-zero sums of terms that runs of neighbouring slots
// share in sign, and a block's float partial sums of them lost ~1e-4 of
// the result (a radial parameter's rhs at the mapper's operands of two
// camera models). kSumsGlobal: each lane's
// nonzero values by global atomics into outputs the caller zeroes. (Shared
// float atomics are compare-and-swap loops on the H100: with them the
// image rows took 0.13 of 0.22 ms at the bench.)
template <int NP, int SUMS>
__global__ void __launch_bounds__(kTileSlots, NP >= 8 ? 1 : kMinWarps * 32 / kTileSlots)
prepare_kernel(const __grid_constant__ TileTable tab, const float* __restrict__ lam_ptr, int I,
               int C, float* __restrict__ partials, int* __restrict__ ticket,
               float* __restrict__ acc_img, float* __restrict__ acc_cam) {
  static_assert(SUMS != kSumsBlock, "prepare sums in a fixed order or by global atomics");
  constexpr int NK = 6 + NP;
  constexpr int NJ = 9 + NP;
  constexpr int NC = 2 * NP;  // camera values: NP rhs | NP diag(U)
  constexpr int NT = kTileSlots;  // one slot a thread
  constexpr size_t kStage = tile_stage_bytes(kPrepare, NJ);
  constexpr bool kFixed = SUMS == kSumsFixed;
  static_assert(NT / 32 == 8, "the fixed order takes turns over 8 warps");
  extern __shared__ __align__(128) unsigned char tile_smem[];
  const int tid = threadIdx.x, warp = tid >> 5;
  const int n_img = I * kImgRows, n_acc = n_img + C * NC;
  // [G, tile_p, 12]: V's 6 floats, then g_pt's 3 doubles
  float* ybuf = reinterpret_cast<float*>(tile_smem + kTileStages * kStage);
  float* acc = ybuf + NT * 12;  // kFixed: [n_acc]
  // kFixed: the rhs in double [I 6 + C NP], from an 8-byte boundary
  double* dacc = reinterpret_cast<double*>(acc + ((n_acc + 1) & ~1));
  float* aimg = kFixed ? acc : acc_img;
  float* acam = kFixed ? acc + n_img : acc_cam;
  if (kFixed) {
    for (int i = tid; i < n_acc; i += NT) acc[i] = 0.f;
    for (int i = tid; i < I * 6 + C * NP; i += NT) dacc[i] = 0.0;
  }
  const float lam = *lam_ptr;

  const int per = (tab.n_tiles + gridDim.x - 1) / gridDim.x;
  const int end = min((blockIdx.x + 1) * per, tab.n_tiles);
  int tile = blockIdx.x * per;
#pragma unroll
  for (int k = 0; k < kTileStages - 1; ++k) {
    if (tile + k < end) tile_fetch<kPrepare, NJ, NT>(tab, tile + k, tile_smem + k * kStage);
    cp_async_commit();
  }
  for (int it = 0; tile < end; ++it, ++tile) {
    const int ahead = tile + kTileStages - 1;
    if (ahead < end)
      tile_fetch<kPrepare, NJ, NT>(tab, ahead,
                                   tile_smem + ((it + kTileStages - 1) % kTileStages) * kStage);
    cp_async_commit();
    cp_async_wait<kTileStages - 1>();
    __syncthreads();
    const unsigned char* st = tile_smem + (it % kTileStages) * kStage;

    const TileBucket& B = tab.b[tile_bucket(tab, tile)];
    const int T = B.T, TP = B.tile_p;
    const int lg = __ffs(TP) - 1;
    const int p0 = (tile - B.first_tile) * TP;
    const int G = NT >> lg;  // thread groups: group g takes slot g
    const int p = tid & (TP - 1), g = tid >> lg;
    const bool on = p0 + p < B.P;
    const bool mine = on && g < T;  // this thread's slot
    const int rs = T * TP, ry = NJ * T * TP;  // f32 [2, NJ, T, TP]
    const float* sJ = reinterpret_cast<const float*>(st);
    const int* sImg = reinterpret_cast<const int*>(st + (size_t)2 * NJ * T * TP * 4);
    const int* sCam = sImg + T * TP;
    const float* sRes = reinterpret_cast<const float*>(sCam + T * TP);  // [2T, TP]
    const float* c0 = sJ + g * TP + p;  // column 0, residual x
    const float* c1 = c0 + ry;          // residual y

    // --- pass 1: V = J_p^T J_p and g_pt = J_p^T r over the track ----------
    // g_pt sums in double (the products of two floats are exact there): at
    // a converged model it is the near-zero sum of terms J r of hundreds,
    // where f32 sums lose ~1e-4 (the f32 plain version as much); it is
    // rounded once, to the f32 it is written as
    float V[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f}, gp[3];
    double gd[3] = {0.0, 0.0, 0.0};
    if (mine) {
      float jp0[3], jp1[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        jp0[a] = c0[(NK + a) * rs];
        jp1[a] = c1[(NK + a) * rs];
      }
      const float r0 = sRes[g * TP + p], r1 = sRes[(T + g) * TP + p];
      V[0] = jp0[0] * jp0[0] + jp1[0] * jp1[0];
      V[1] = jp0[0] * jp0[1] + jp1[0] * jp1[1];
      V[2] = jp0[0] * jp0[2] + jp1[0] * jp1[2];
      V[3] = jp0[1] * jp0[1] + jp1[1] * jp1[1];
      V[4] = jp0[1] * jp0[2] + jp1[1] * jp1[2];
      V[5] = jp0[2] * jp0[2] + jp1[2] * jp1[2];
#pragma unroll
      for (int a = 0; a < 3; ++a) gd[a] = (double)jp0[a] * r0 + (double)jp1[a] * r1;
    }
    if (G > 1) {  // the column's slots' sums, added in slot order
#pragma unroll
      for (int k = 0; k < 6; ++k) ybuf[tid * 12 + k] = V[k];
      double* yd = reinterpret_cast<double*>(ybuf + tid * 12 + 6);
#pragma unroll
      for (int a = 0; a < 3; ++a) yd[a] = gd[a];
      __syncthreads();
      float v[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      double w[3] = {0.0, 0.0, 0.0};
      for (int h = 0; h < min(G, T); ++h) {  // independent loads, then adds
        const float* yh = ybuf + ((h << lg) + p) * 12;
        float q[6];
#pragma unroll
        for (int k = 0; k < 6; ++k) q[k] = yh[k];
        const double* qd = reinterpret_cast<const double*>(yh + 6);
        const double q6 = qd[0], q7 = qd[1], q8 = qd[2];
#pragma unroll
        for (int k = 0; k < 6; ++k) v[k] += q[k];
        w[0] += q6;
        w[1] += q7;
        w[2] += q8;
      }
#pragma unroll
      for (int k = 0; k < 6; ++k) V[k] = v[k];
#pragma unroll
      for (int a = 0; a < 3; ++a) gd[a] = w[a];
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) gp[a] = (float)gd[a];
    // the damped block and its closed-form inverse; every thread of the
    // column computes the same values
    V[0] += lam * fmaxf(V[0], 1e-6f);
    V[3] += lam * fmaxf(V[3], 1e-6f);
    V[5] += lam * fmaxf(V[5], 1e-6f);
    const float a_ = V[0], b_ = V[1], c_ = V[2], d_ = V[3], e_ = V[4], f_ = V[5];
    const float iA = d_ * f_ - e_ * e_, iB = c_ * e_ - b_ * f_, iC = b_ * e_ - c_ * d_;
    float det = a_ * iA + b_ * iB + c_ * iC;
    det = fabsf(det) < 1e-12f ? 1e-12f : det;
    const float vi[6] = {iA / det, iB / det, iC / det, (a_ * f_ - c_ * c_) / det,
                         (b_ * c_ - a_ * e_) / det, (a_ * d_ - b_ * b_) / det};
    if (on && g == 0) {
      const int P = B.P;
#pragma unroll
      for (int k = 0; k < 6; ++k) B.vinv[(size_t)k * P + p0 + p] = vi[k];
#pragma unroll
      for (int a = 0; a < 3; ++a) B.gpt[(size_t)a * P + p0 + p] = gp[a];
    }
    const float z0[3] = {vi[0] * gp[0] + vi[1] * gp[1] + vi[2] * gp[2],
                         vi[1] * gp[0] + vi[3] * gp[1] + vi[4] * gp[2],
                         vi[2] * gp[0] + vi[4] * gp[1] + vi[5] * gp[2]};

    // --- pass 2: the slot's image and camera values -------------------------
    int ii = -1, ci = -1;
    float vals[kImgRows], cv[NC];
#pragma unroll
    for (int k = 0; k < kImgRows; ++k) vals[k] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) cv[j] = 0.f;
    if (mine) {
      float j0[NJ], j1[NJ];
      bool nz = false;
#pragma unroll
      for (int k = 0; k < NJ; ++k) {
        j0[k] = c0[k * rs];
        j1[k] = c1[k * rs];
        nz |= (j0[k] != 0.f) | (j1[k] != 0.f);
      }
      if (nz) {  // a padded or masked slot (all-zero J) adds nothing
        ii = sImg[g * TP + p];
        ci = sCam[g * TP + p];
        const float rm0 =
            sRes[g * TP + p] - (j0[NK] * z0[0] + j0[NK + 1] * z0[1] + j0[NK + 2] * z0[2]);
        const float rm1 =
            sRes[(T + g) * TP + p] - (j1[NK] * z0[0] + j1[NK + 1] * z0[1] + j1[NK + 2] * z0[2]);
#pragma unroll
        for (int k = 0; k < 6; ++k) {
          vals[k] = j0[k] * rm0 + j1[k] * rm1;
          vals[6 + k] = j0[k] * j0[k] + j1[k] * j1[k];
        }
        float Wm[6][3], VW[6][3];
#pragma unroll
        for (int k = 0; k < 6; ++k) {
#pragma unroll
          for (int a = 0; a < 3; ++a) Wm[k][a] = j0[k] * j0[NK + a] + j1[k] * j1[NK + a];
          VW[k][0] = vi[0] * Wm[k][0] + vi[1] * Wm[k][1] + vi[2] * Wm[k][2];
          VW[k][1] = vi[1] * Wm[k][0] + vi[3] * Wm[k][1] + vi[4] * Wm[k][2];
          VW[k][2] = vi[2] * Wm[k][0] + vi[4] * Wm[k][1] + vi[5] * Wm[k][2];
        }
        int n = 12;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
#pragma unroll
          for (int j = i; j < 6; ++j) {
            vals[n++] = j0[i] * j0[j] + j1[i] * j1[j] -
                        (VW[i][0] * Wm[j][0] + VW[i][1] * Wm[j][1] + VW[i][2] * Wm[j][2]);
          }
        }
#pragma unroll
        for (int j = 0; j < NP; ++j) {
          cv[j] = j0[6 + j] * rm0 + j1[6 + j] * rm1;
          cv[NP + j] = j0[6 + j] * j0[6 + j] + j1[6 + j] * j1[6 + j];
        }
      }
    }
    if constexpr (kFixed) {
      const ScatterPlan pimg = scatter_plan(ii), pcam = scatter_plan(ci);
#pragma unroll 1
      for (int i = 0; i < 8; ++i) {  // the warps' turns
        const int grp = (warp + i) & 7;
        if (grp == 0) {  // the image's rhs, summed in double
          scatter_apply<6, false, double>(dacc, pimg, ii, 6, vals);
        } else if (grp == 6) {  // the camera's rhs, summed in double
          scatter_apply_wide<NP>(dacc + I * 6, pcam, ci, NP, cv);
        } else if (grp < 6) {  // image values 6 grp .. 6 grp + 5 (30..32 in the last)
          float v[6];
#pragma unroll
          for (int k = 0; k < 6; ++k) {
            float x = 0.f;
#pragma unroll
            for (int q = 0; q < 6; ++q)
              if (6 * q + k < kImgRows && grp == q) x = vals[6 * q + k];
            v[k] = x;
          }
          scatter_apply<6, false>(aimg + 6 * grp, pimg, ii, kImgRows, v, grp < 5 ? 6 : 3);
        } else {  // the camera's diagonal
          float v[NP];
#pragma unroll
          for (int j = 0; j < NP; ++j) v[j] = cv[NP + j];
          scatter_apply<NP, false>(acam + NP, pcam, ci, NC, v);
        }
        __syncthreads();
      }
    } else {
      lane_atomics<kImgRows>(aimg, ii, kImgRows, vals);
      warp_scatter<NC, true>(acam, ci, NC, cv);
      __syncthreads();  // the stage and ybuf are free again
    }
  }
  if constexpr (kFixed)
    prepare_finish<NP>(acc, dacc, I, C, partials, ticket, acc_img, acc_cam);
}

// the kernel of a kind, width and mode
template <int KIND, int NP, int SUMS>
static const void* tile_kernel() {
  if constexpr (KIND == kMatvec16)
    return (const void*)&matvec16_kernel<NP, SUMS>;
  else if constexpr (KIND == kMatvec)
    return (const void*)&matvec_kernel<NP, SUMS>;
  else if constexpr (SUMS == kSumsBlock)
    return nullptr;  // prepare has no block mode
  else
    return (const void*)&prepare_kernel<NP, SUMS>;
}

template <int KIND, int NP>
static const void* tile_kernel_of(int sums) {
  return sums == kSumsFixed   ? tile_kernel<KIND, NP, kSumsFixed>()
         : sums == kSumsBlock ? tile_kernel<KIND, NP, kSumsBlock>()
                              : tile_kernel<KIND, NP, kSumsGlobal>();
}

// A block's dynamic shared memory in mode `sums`: the stages, the groups'
// per-thread sums (3 floats for a matvec; 6 floats and 3 doubles, 12
// floats' room, for prepare) and the
// accumulators (the matvecs' fixed order also holds x).
template <int KIND, int NP>
static size_t tile_smem_bytes(int I, int C, int sums) {
  const bool prep = KIND == kPrepare;
  const size_t n_acc =
      prep ? (size_t)I * kImgRows + (size_t)C * 2 * NP : (size_t)I * 6 + (size_t)C * NP;
  const int nt = tile_threads(KIND, sums);
  size_t acc_floats = sums == kSumsFixed   ? (prep ? 1 : nt / 32 + 1) * n_acc
                      : sums == kSumsBlock ? n_acc
                                           : 0;
  if (prep && sums == kSumsFixed)  // the rhs in double, from an 8-byte boundary
    acc_floats = ((n_acc + 1) & ~(size_t)1) + 2 * ((size_t)I * 6 + (size_t)C * NP);
  return kTileStages * tile_stage_bytes(KIND, 9 + NP) + (size_t)nt * (prep ? 12 : 3) * 4 +
         acc_floats * 4;
}

// A block's dynamic shared memory in mode `sums`, its resident blocks per
// SM (at most kTileMaxPerSm) and, in the fixed mode, the clusters of
// kTileCluster blocks the card holds at once (a cluster lies within one
// GPC, so fewer than blocks per SM x SMs / kTileCluster can be resident;
// a grid of more would run its last clusters in a second wave), raising
// the kernel's opt-in limit to it; cudaErrorInvalidValue if it exceeds the
// card's opt-in shared memory. The answer is kept per kernel and size.
template <int KIND, int NP>
static int tile_config(int I, int C, int sums, size_t* bytes, int* per_sm, int* clusters) {
  *bytes = tile_smem_bytes<KIND, NP>(I, C, sums);
  const void* kernel = tile_kernel_of<KIND, NP>(sums);
  if (!kernel) return (int)cudaErrorInvalidValue;
  static size_t known_bytes[3] = {0, 0, 0};
  static int known_per_sm[3] = {0, 0, 0}, known_clusters[3] = {0, 0, 0};
  if (known_bytes[sums] != *bytes) {
    int dev = 0, optin = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (*bytes > (size_t)optin) return (int)cudaErrorInvalidValue;
    cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
    if (e != cudaSuccess) return (int)e;
    int n = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, tile_threads(KIND, sums),
                                                      *bytes);
    if (e != cudaSuccess) return (int)e;
    if (n < 1) return (int)cudaErrorInvalidConfiguration;
    int ncl = 0;
    if (sums == kSumsFixed) {
      cudaLaunchConfig_t cfg = {};
      cfg.gridDim = dim3(kTileCluster);
      cfg.blockDim = dim3(tile_threads(KIND, sums));
      cfg.dynamicSmemBytes = *bytes;
      cudaLaunchAttribute attr[1];
      attr[0].id = cudaLaunchAttributeClusterDimension;
      attr[0].val.clusterDim.x = kTileCluster;
      attr[0].val.clusterDim.y = 1;
      attr[0].val.clusterDim.z = 1;
      cfg.attrs = attr;
      cfg.numAttrs = 1;
      e = cudaOccupancyMaxActiveClusters(&ncl, kernel, &cfg);
      if (e != cudaSuccess) return (int)e;
      if (ncl < 1) return (int)cudaErrorInvalidConfiguration;
    }
    known_per_sm[sums] = n < kTileMaxPerSm ? n : kTileMaxPerSm;
    known_clusters[sums] = ncl;
    known_bytes[sums] = *bytes;
  }
  *per_sm = known_per_sm[sums];
  *clusters = known_clusters[sums];
  return 0;
}

// The mode of a launch at I images and C cameras. The matvecs: the fixed
// order, else the block's sums, whichever first leaves kMinWarps resident
// warps per SM, else global atomics (on the H100 matvec16's shared modes
// ran slower than global atomics below that: their shared memory left too
// few blocks to keep the tiles' copies in flight). Prepare: the fixed
// order wherever its accumulator fits, else global atomics (its 33
// contended atomics a slot took 0.39 ms at 1,024 images, the fixed order
// at one block per SM 0.22).
template <int KIND, int NP>
static int tile_pick(int I, int C, int* sums, size_t* bytes, int* per_sm, int* clusters) {
  for (int m = kSumsFixed; m > kSumsGlobal; --m) {
    const int err = tile_config<KIND, NP>(I, C, m, bytes, per_sm, clusters);
    if (err && err != (int)cudaErrorInvalidValue) return err;
    if (!err && (KIND == kPrepare || *per_sm * tile_threads(KIND, m) / 32 >= kMinWarps)) {
      *sums = m;
      return 0;
    }
  }
  *sums = kSumsGlobal;
  return tile_config<KIND, NP>(I, C, kSumsGlobal, bytes, per_sm, clusters);
}

// Launch a kernel over a tile table: a persistent grid of the resident
// blocks (in the fixed mode the resident clusters), each taking a
// contiguous run of tiles. `args` follow the table.
template <int KIND, int NP, class... Args>
static int tile_launch(const TileTable& tab, int I, int C, int sums, int max_clusters,
                       cudaStream_t s, Args... args) {
  size_t bytes = 0;
  int per_sm = 0, clusters = 0;
  const int err = tile_config<KIND, NP>(I, C, sums, &bytes, &per_sm, &clusters);
  if (err) return err;
  const bool fixed = sums == kSumsFixed;
  const int cs = fixed ? kTileCluster : 1;
  int blocks = ba_sm_count() * per_sm;
  if (blocks > tab.n_tiles) blocks = tab.n_tiles;
  if (fixed && clusters < max_clusters) max_clusters = clusters;
  if (fixed && blocks > max_clusters * cs) blocks = max_clusters * cs;
  blocks = blocks / cs * cs;
  if (blocks < cs) blocks = cs;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(tile_threads(KIND, sums));
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  void* params[] = {(void*)&tab, (void*)&args...};
  cudaError_t e = cudaLaunchKernelExC(&cfg, tile_kernel_of<KIND, NP>(sums), params);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// The table's contract (cg_kernel.py tile_table): 1-8 buckets in tile
// order, T <= 64, tile_p a power of two from 4 to 128 with T tile_p <= 256,
// P a multiple of 8, every operand the kind reads or writes 16-byte
// aligned.
static bool tile_table_ok(const TileTable& tab, int kind) {
  if (tab.nb < 1 || tab.nb > kTileMaxBuckets || tab.n_tiles < 1) return false;
  int first = 0;
  for (int i = 0; i < tab.nb; ++i) {
    const TileBucket& b = tab.b[i];
    if (b.T < 1 || b.T > kTileMaxT || b.P < 0 || b.P % 8 || b.tile_p < 4 ||
        b.tile_p > kTileMaxP || (b.tile_p & (b.tile_p - 1)) ||
        b.T * b.tile_p > kTileSlots || b.first_tile != first)
      return false;
    const void* ops[] = {b.J, b.img, b.cam, b.vinv, kind == kPrepare ? b.res : nullptr,
                         kind == kPrepare ? b.gpt : nullptr};
    for (const void* q : ops)
      if ((size_t)q % 16) return false;
    first += (b.P + b.tile_p - 1) / b.tile_p;
  }
  return first == tab.n_tiles;
}

// the single-model widths (3 4 5 8 12) and the mixed ones (4 5 6 9 13: the
// widest listed model's count plus the selector column)
#define BA_FOR_EACH_NP(X) X(3) X(4) X(5) X(6) X(8) X(9) X(12) X(13)

BA_DEFINE_ERROR_STRING

static bool tile_args_ok(const TileTable* tab, int kind, int sums, const float* partials,
                         int max_clusters, const int* ticket) {
  return tile_table_ok(*tab, kind) && sums >= kSumsGlobal && sums <= kSumsFixed &&
         (sums != kSumsFixed || (partials && ticket && max_clusters >= 1));
}

// One launch of a matvec over the bucket table `tab` (bf16 J for
// matvec16, f32 J for matvec), with x and the sums where `sums` says
// (ba_tile_config's answer). kSumsFixed: out_pose [I, 6] and out_intr
// [C, NP] are written whole (no zeroing); partials holds max_clusters rows
// of I 6 + C NP floats and ticket one int that is 0 before the launch and
// after it. Otherwise the outputs accumulate, zeroed by the caller;
// partials and ticket are unused.
template <int KIND>
static int matvec_launch(int np, const TileTable* tab, const float* xpose, const float* xintr,
                         int I, int C, int sums, float* partials, int max_clusters, int* ticket,
                         float* out_pose, float* out_intr, void* stream) {
  if (!tile_args_ok(tab, KIND, sums, partials, max_clusters, ticket))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (np) {
#define X(N)                                                                               \
  case N:                                                                                  \
    return tile_launch<KIND, N>(*tab, I, C, sums, max_clusters, s, xpose, xintr, I, C,     \
                                partials, ticket, out_pose, out_intr);
    BA_FOR_EACH_NP(X)
#undef X
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int ba_matvec16(int np, const TileTable* tab, const float* xpose, const float* xintr,
                           int I, int C, int sums, float* partials, int max_clusters, int* ticket,
                           float* out_pose, float* out_intr, void* stream) {
  return matvec_launch<kMatvec16>(np, tab, xpose, xintr, I, C, sums, partials, max_clusters,
                                  ticket, out_pose, out_intr, stream);
}

extern "C" int ba_matvec(int np, const TileTable* tab, const float* xpose, const float* xintr,
                         int I, int C, int sums, float* partials, int max_clusters, int* ticket,
                         float* out_pose, float* out_intr, void* stream) {
  return matvec_launch<kMatvec>(np, tab, xpose, xintr, I, C, sums, partials, max_clusters,
                                ticket, out_pose, out_intr, stream);
}

// One launch of the LM preparation over `tab` (f32 J and residuals in,
// each bucket's vinv and gpt written whole); lam is a device scalar.
// acc_img [I, 33] and acc_cam [C, 2 NP] as a matvec's outputs: written
// whole in the fixed order (partials: max_clusters rows of 33 I + 2 C NP
// floats and, after them from an 8-byte boundary, max_clusters rows of
// 6 I + C NP doubles), else accumulated into zeroed outputs.
extern "C" int ba_prepare(int np, const TileTable* tab, const float* lam, int I, int C, int sums,
                          float* partials, int max_clusters, int* ticket, float* acc_img,
                          float* acc_cam, void* stream) {
  if (!tile_args_ok(tab, kPrepare, sums, partials, max_clusters, ticket))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (np) {
#define X(N)                                                                                   \
  case N:                                                                                      \
    return tile_launch<kPrepare, N>(*tab, I, C, sums, max_clusters, s, lam, I, C, partials, \
                                    ticket, acc_img, acc_cam);
    BA_FOR_EACH_NP(X)
#undef X
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The mode of a launch of kernel `kind` (0 matvec16, 1 matvec, 2 prepare)
// at width np with I images and C cameras (tile_pick), its dynamic shared
// memory, resident blocks per SM and, in the fixed mode, resident clusters
// (the stream is unused).
extern "C" int ba_tile_config(int kind, int np, int I, int C, int* sums, int* bytes,
                              int* blocks_per_sm, int* clusters, void*) {
  size_t b = 0;
  int err = (int)cudaErrorInvalidValue;
  switch (np) {
#define X(N)                                                                 \
  case N:                                                                    \
    if (kind == kMatvec16)                                                   \
      err = tile_pick<kMatvec16, N>(I, C, sums, &b, blocks_per_sm, clusters);          \
    else if (kind == kMatvec)                                                \
      err = tile_pick<kMatvec, N>(I, C, sums, &b, blocks_per_sm, clusters);            \
    else if (kind == kPrepare)                                               \
      err = tile_pick<kPrepare, N>(I, C, sums, &b, blocks_per_sm, clusters);           \
    break;
    BA_FOR_EACH_NP(X)
#undef X
    default:
      break;
  }
  *bytes = (int)b;
  return err;
}
