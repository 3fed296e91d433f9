// Grouped (ragged) matmul for the dropless MoE on Hopper (sm_90a): three
// kernels over the sorted, tile-aligned layout of ops/moe.py's
// dropless_layout (tokens sorted by expert, each expert's run starting at
// a multiple of the row tile bm, tile_expert[t] naming the owner of row
// tile t, non-decreasing).
//
//   K5 gmm      replaces `_gmm_kernel` (the JAX package's ops/gmm.py:71,
//      pallas_call at :135):      y[t]  = x[t] @ w[te[t]]
//   K6 gmm_dxt  replaces `_gmm_dxt_kernel` (:144, call :210):
//                                 dx[t] = dy[t] @ w[te[t]]^T, w read in its
//                                 stored [E, D, F] layout (no transposed copy)
//   K7 tgmm     replaces `_tgmm_kernel` (:219, call :295):
//                                 dw[e] = sum_{t: te[t] = e} x[t]^T dy[t]
//
// bf16 runs on warp-specialised wgmma kernels fed by TMA (hopper.cuh):
// gmm_rows_wgmma<kFwd> for K5, gmm_rows_wgmma<kDxt> for K6 and tgmm_wgmma
// for K7, each with its note below.  f32 runs on the template gmm_kernel
// (FMAs in the mma.sync accumulator layout, no TF32, so the f32
// tolerances hold).
//
// They compute what the TPU kernels compute, with the same rounding
// points: products accumulate in f32 and round once, y to x's type, dx to
// dy's type, dw (summed over the expert's whole run) to x's type.  An
// expert that owns no row tile gets dw = 0 exactly (the reference zeroes
// those rows after its kernel, ops/gmm.py:304-307).
//
// Live rows.  K5 and K6 take an optional group_sizes [E] (int32, on the
// device): how many rows of each expert's run hold routed tokens; the
// rest of the run is padding.  With it, rows at or past their expert's
// count are written as exact zeros (what the reference's products of the
// zero pad rows give), and a 128-row tile with no live row is neither
// loaded nor multiplied: the layout's per-expert padding and its E * bm
// tail rows (more than 99% of the rows of a four-request decode step)
// cost only their zeros' stores.  Without it every row is computed, as
// the reference does.  K7 sums every row of the run (pad rows of x are
// zero).
//
// Bound: operations.  At the MoE flagship's training shape (G = B*S = 8192
// tokens, top-2, D = 1024, F = 4096, E = 8) the layout holds 16,384 routed
// rows in NP = 18,432; each launch does 2 * 16,384 * 1024 * 4096 =
// 137.4 Gflop of routed work (154.6 over NP): 0.139 ms at 989 Tflop/s
// bf16 dense, against about 235 MB of operands (0.070 ms at 3.35 TB/s).
//
// The f32 template.  GPU blocks run in no order, so every block owns one
// 128 x 128 output tile and loops over the whole reduction itself:
//  - K5 and K6: one block per (128-row tile, 128-column tile).  bm is a
//    multiple of 128, so a block's rows never straddle two experts; the
//    block reads its expert from tile_expert in device memory (no host
//    synchronisation anywhere) and loops over D (K5) or F (K6).
//  - K7: one block per (expert, 128-row tile of D, 128-column tile of F).
//    It finds its expert's contiguous run of row tiles in tile_expert,
//    loops over the run's rows with the sum in f32 registers, and writes
//    once: no atomics, bit-reproducible, and an absent expert's run is
//    empty, so it writes zeros.
//  - Eight warps, 2 x 4, each own a 64 x 32 piece of the tile.  Operand
//    tiles of depth 32 stream through a 3-stage cp.async ring in shared
//    memory (rows padded by 16 bytes against bank conflicts, ragged edges
//    zero-filled); each warp sums with FMAs in the accumulator layout of
//    mma.sync m16n8k16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;  // 8 warps: 2 (rows) x 4 (columns)
constexpr int kBM = 128;       // output rows per block
constexpr int kBN = 128;       // output columns per block
constexpr int kBK = 32;        // reduction depth per stage
constexpr int kStages = 3;

enum Mode { kFwd = 0, kDxt = 1, kTgmm = 2 };

struct GmmArgs {
  const void* a;  // x (K5, K7) or dy (K6): [N, D] or [N, F]
  const void* b;  // w (K5, K6): [E, D, F], or dy (K7): [N, F]
  const int* te;  // [N / bm]
  const int* counts;  // K5, K6: live rows of each expert's run [E], or null
  void* out;      // y [N, F], dx [N, D] or dw [E, D, F]
  int N, D, F, E, bm;
};

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// Warp-level 16x8x16 product c += A.B in the mma.sync accumulator layout:
// lane (g = lane / 4, t = lane % 4) holds c[0], c[1] at row g, columns
// 2t, 2t+1 and c[2], c[3] at row g + 8.  Element (m, k) of A is
// a[m * am + k * ak], element (k, n) of B is b[k * bk + n * bn]; one of
// each pair of strides is 1.
template <typename T>
struct Mma;

// f32: the accumulator layout computed with FMAs from shared memory.
template <>
struct Mma<float> {
  struct A {
    const float* p0;
    const float* p1;
    int ak;
  };
  struct B {
    const float* p0;
    const float* p1;
    int bk;
  };
  static __device__ __forceinline__ void load_a(A& f, const float* a, int am,
                                                int ak) {
    const int g = (threadIdx.x & 31) >> 2;
    f.p0 = a + g * am;
    f.p1 = a + (g + 8) * am;
    f.ak = ak;
  }
  static __device__ __forceinline__ void load_b(B& f, const float* b, int bk,
                                                int bn) {
    const int t = threadIdx.x & 3;
    f.p0 = b + (2 * t) * bn;
    f.p1 = b + (2 * t + 1) * bn;
    f.bk = bk;
  }
  static __device__ __forceinline__ void mma(float c[4], const A& a,
                                             const B& b) {
#pragma unroll 4
    for (int k = 0; k < 16; ++k) {
      const float x0 = a.p0[k * a.ak], x1 = a.p1[k * a.ak];
      const float y0 = b.p0[k * b.bk], y1 = b.p1[k * b.bk];
      c[0] = fmaf(x0, y0, c[0]);
      c[1] = fmaf(x0, y1, c[1]);
      c[2] = fmaf(x1, y0, c[2]);
      c[3] = fmaf(x1, y1, c[3]);
    }
  }
};

// Asynchronous 16-byte copies into shared memory (cp.async): a source
// that is not live is not read and its destination is zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   shared_addr(dst)),
               "l"(src), "r"(live ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// An R x C block of a row-major matrix (row stride ld elements) starting
// at src into shared memory with row stride LD.  Rows at or past r_live
// and 16-byte chunks at or past column c_live are zero; dead chunks name
// `base` (a valid address) and read nothing.
template <typename T, int R, int C, int LD>
__device__ __forceinline__ void load_block(T* dst, const T* src,
                                           const T* base, long long ld,
                                           int r_live, int c_live) {
  constexpr int V = 16 / sizeof(T), CH = C / V;
  for (int i = threadIdx.x; i < R * CH; i += kThreads) {
    const int r = i / CH, c = (i - r * CH) * V;
    const bool live = r < r_live && c < c_live;
    cp_async16(dst + r * LD + c, live ? src + r * ld + c : base, live);
  }
}

// The first row of the run of expert e that holds row tile t (tile_expert
// is non-decreasing, so the run is contiguous).
__device__ __forceinline__ int run_start(const GmmArgs& a, int t, int e) {
  while (t > 0 && min(max(a.te[t - 1], 0), a.E - 1) == e) --t;
  return t * a.bm;
}

// With counts: the live rows of the 128-row output tile at row m0 of
// expert e's run, which starts at row `start`: the rows before the
// expert's count, at most 128.  The tile's other rows are written as
// zeros, and a tile with none is neither loaded nor multiplied.
__device__ __forceinline__ int live_rows(const GmmArgs& a, int e, int start,
                                         int m0) {
  const int live = a.counts[e] - (m0 - start);
  return live <= 0 ? 0 : min(live, kBM);
}

// Shared-memory tiles of one stage.  A is stored [m][k] (K5, K6) or
// [k][m] (K7's x); B is stored [k][n] (K5's w, K7's dy) or [n][k] (K6's
// w, read in its stored layout).
template <typename T, int MODE>
struct Tiles {
  static constexpr int V = 16 / sizeof(T);
  static constexpr bool a_km = MODE == kTgmm;
  static constexpr bool b_nk = MODE == kDxt;
  static constexpr int LDA = a_km ? kBM + V : kBK + V;
  static constexpr int LDB = b_nk ? kBK + V : kBN + V;
  static constexpr int A_ELEMS = a_km ? kBK * LDA : kBM * LDA;
  static constexpr int B_ELEMS = b_nk ? kBN * LDB : kBK * LDB;
  static constexpr int STAGE = A_ELEMS + B_ELEMS;
  static constexpr size_t bytes = (size_t)kStages * STAGE * sizeof(T);
};

template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads) gmm_kernel(const GmmArgs a) {
  using L = Tiles<T, MODE>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const T* A = static_cast<const T*>(a.a);
  const T* B = static_cast<const T*>(a.b);
  T* out = static_cast<T*>(a.out);
  const long long D = a.D, F = a.F;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  // the block's expert, output matrix (M x NC), reduction range and live
  // output rows
  int e, M, NC, k_begin, k_end, live = kBM;
  if (MODE == kTgmm) {
    e = blockIdx.z;
    M = a.D;
    NC = a.F;
    out += (long long)e * D * F;
    // the expert's run of row tiles (tile_expert is non-decreasing);
    // empty when the expert owns none, and then the block writes zeros
    const int tiles = a.N / a.bm;
    int first = tiles, last = -1;
    for (int t = 0; t < tiles; ++t) {
      const int owner = min(max(a.te[t], 0), a.E - 1);
      if (owner == e) {
        first = min(first, t);
        last = t;
      }
    }
    k_begin = first * a.bm;
    k_end = (last + 1) * a.bm;
  } else {
    e = min(max(a.te[m0 / a.bm], 0), a.E - 1);
    M = a.N;
    NC = MODE == kFwd ? a.F : a.D;
    if (a.counts != nullptr)
      live = live_rows(a, e, run_start(a, m0 / a.bm, e), m0);
    k_begin = 0;
    k_end = live > 0 ? (MODE == kFwd ? a.D : a.F) : 0;
  }
  const int nk = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;
  const T* W = B + (long long)e * D * F;

  auto load_stage = [&](int buf, int kt) {
    T* As = smem + buf * L::STAGE;
    T* Bs = As + L::A_ELEMS;
    const int k0 = k_begin + kt * kBK;
    if (MODE == kFwd) {
      load_block<T, kBM, kBK, L::LDA>(As, A + m0 * D + k0, A, D, a.N - m0,
                                      a.D - k0);
      load_block<T, kBK, kBN, L::LDB>(Bs, W + k0 * F + n0, B, F, a.D - k0,
                                      a.F - n0);
    } else if (MODE == kDxt) {
      load_block<T, kBM, kBK, L::LDA>(As, A + m0 * F + k0, A, F, a.N - m0,
                                      a.F - k0);
      load_block<T, kBN, kBK, L::LDB>(Bs, W + n0 * F + k0, B, F, a.D - n0,
                                      a.F - k0);
    } else {
      load_block<T, kBK, kBM, L::LDA>(As, A + k0 * D + m0, A, D, k_end - k0,
                                      a.D - m0);
      load_block<T, kBK, kBN, L::LDB>(Bs, B + k0 * F + n0, B, F, k_end - k0,
                                      a.F - n0);
    }
  };

  const int warp = threadIdx.x >> 5, wm = warp >> 2, wn = warp & 3;
  float c[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[i][j][0] = c[i][j][1] = c[i][j][2] = c[i][j][3] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage kt landed; stage kt - 1's buffer is free
    const int nxt = kt + kStages - 1;
    if (nxt < nk) load_stage(nxt % kStages, nxt);
    cp_async_commit();
    const T* As = smem + (kt % kStages) * L::STAGE;
    const T* Bs = As + L::A_ELEMS;
#pragma unroll
    for (int k16 = 0; k16 < kBK; k16 += 16) {
      typename Mma<T>::A fa[4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int m = wm * 64 + mt * 16;
        if (L::a_km)
          Mma<T>::load_a(fa[mt], As + k16 * L::LDA + m, 1, L::LDA);
        else
          Mma<T>::load_a(fa[mt], As + m * L::LDA + k16, L::LDA, 1);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = wn * 32 + nt * 8;
        typename Mma<T>::B fb;
        if (L::b_nk)
          Mma<T>::load_b(fb, Bs + n * L::LDB + k16, 1, L::LDB);
        else
          Mma<T>::load_b(fb, Bs + k16 * L::LDB + n, L::LDB, 1);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) Mma<T>::mma(c[mt][nt], fa[mt], fb);
      }
    }
  }
  cp_async_wait<0>();

  // f32 sums rounded once to the output type; rows past the live ones 0
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int row = m0 + wm * 64 + mt * 16 + g;
    const bool keep0 = row - m0 < live, keep1 = row + 8 - m0 < live;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn * 32 + nt * 8 + 2 * t4;
      if (col >= NC) continue;
      if (row < M)
        store2(out + (long long)row * NC + col, keep0 ? c[mt][nt][0] : 0.f,
               keep0 ? c[mt][nt][1] : 0.f);
      if (row + 8 < M)
        store2(out + (long long)(row + 8) * NC + col,
               keep1 ? c[mt][nt][2] : 0.f, keep1 ? c[mt][nt][3] : 0.f);
    }
  }
}

// ------------------------------------------------- K7, bf16: wgmma + TMA
//
// A persistent grid (one block per SM at most) walks the work items
// (expert, 128-row tile of D, 256-column tile of F), experts in order of
// decreasing run length, so a skewed router's heavy experts start first
// and the light ones fill the tail.  384 threads: warpgroup 0 is the
// producer (one thread starts every TMA load), warpgroups 1 and 2 each own
// 64 rows of the dW tile.  A stage is 64 rows of the expert's run: x^T
// (two [64][64] boxes, MN-major) and dy (four boxes, MN-major), through a
// 4-stage ring of full/empty mbarriers that runs on across work items, so
// the next item's loads overlap this item's last products and its
// epilogue.  Each consumer keeps its 64 x 256 f32 sum of the whole run in
// registers (m64n256k16 wgmma, both transpose bits set), keeps one group
// of products in flight while it waits for the next stage, and rounds
// once to x's type.  No split-K, no atomics on dW: runs are
// bit-reproducible.  Ragged D/F edges load as zeros (TMA) and are clipped
// on the store; a box wholly past D or F is not loaded at all.

constexpr int kTgRows = 128;     // dW rows (of D) per work item: 2 x 64
constexpr int kTgCols = 256;     // dW columns (of F) per work item
constexpr int kTgDepth = 64;     // x/dy rows per stage
constexpr int kTgStages = 4;
constexpr int kTgThreads = 384;  // producer + two consumer warpgroups
constexpr uint32_t kTgBox = kTgDepth * 128;  // one [64][64] bf16 box
constexpr uint32_t kTgA = (kTgRows / 64) * kTgBox;              // x^T
constexpr uint32_t kTgStage = kTgA + (kTgCols / 64) * kTgBox;   // + dy
constexpr uint32_t kTgBar = kTgStages * kTgStage;
constexpr size_t kMaxSmem = 232448;

// ring, full and empty barriers, then each expert's first and last row
// tile and the experts' order, one int each
size_t tgmm_smem_bytes(int E) {
  return kTgBar + 16 * kTgStages + 3 * sizeof(int) * (size_t)E + 1024;
}

struct TgItem {
  int e, m0, n0, row_begin, row_end;
};

// Work item i: the expert of rank i / (tiles per expert) by run length,
// its tile of dW, and the rows of its run (empty for an absent expert).
__device__ __forceinline__ TgItem tg_item(int i, const GmmArgs& a,
                                          const int* first, const int* last,
                                          const int* order) {
  const int n_tiles = (a.F + kTgCols - 1) / kTgCols;
  const int per_expert = n_tiles * ((a.D + kTgRows - 1) / kTgRows);
  TgItem it;
  it.e = order[i / per_expert];
  const int rem = i % per_expert;
  it.m0 = (rem / n_tiles) * kTgRows;
  it.n0 = (rem % n_tiles) * kTgCols;
  it.row_begin = first[it.e] * a.bm;
  it.row_end = (last[it.e] + 1) * a.bm;
  return it;
}

__global__ void __launch_bounds__(kTgThreads, 1)
    tgmm_wgmma(const __grid_constant__ CUtensorMap tm_x,
               const __grid_constant__ CUtensorMap tm_dy, const GmmArgs a) {
  extern __shared__ __align__(1024) unsigned char smem_tg[];
  // swizzled boxes start on 1024-byte boundaries
  const uint32_t raw = hopper::smem_u32(smem_tg);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t full = base + kTgBar, empty = full + 8 * kTgStages;
  int* first = reinterpret_cast<int*>(smem_tg + (base - raw) + kTgBar +
                                      16 * kTgStages);
  int* last = first + a.E;
  int* order = last + a.E;
  const int tiles = a.N / a.bm;

  for (int e = threadIdx.x; e < a.E; e += blockDim.x) {
    first[e] = tiles;
    last[e] = -1;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kTgStages; ++s) {
      hopper::mbar_init(full + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, 8);  // every consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  // each expert's contiguous run of row tiles (tile_expert is
  // non-decreasing); none for an expert that owns no tile
  for (int t = threadIdx.x; t < tiles; t += blockDim.x) {
    const int owner = min(max(a.te[t], 0), a.E - 1);
    atomicMin(first + owner, t);
    atomicMax(last + owner, t);
  }
  __syncthreads();
  // experts by decreasing run length, the lower index first on a tie
  for (int e = threadIdx.x; e < a.E; e += blockDim.x) {
    const int len = max(0, last[e] - first[e] + 1);
    int rank = 0;
    for (int o = 0; o < a.E; ++o) {
      const int lo = max(0, last[o] - first[o] + 1);
      rank += lo > len || (lo == len && o < e);
    }
    order[rank] = e;
  }
  __syncthreads();

  const int items = a.E * ((a.D + kTgRows - 1) / kTgRows) *
                    ((a.F + kTgCols - 1) / kTgCols);
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------------------------------------------- producer
    hopper::reg_dealloc<40>();
    if (threadIdx.x == 0) {
      int kt = 0;  // stages started so far: the ring's position and phase
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        const TgItem it = tg_item(i, a, first, last, order);
        int boxes = 0;
        for (int x = 0; x < kTgRows / 64; ++x) boxes += it.m0 + 64 * x < a.D;
        for (int x = 0; x < kTgCols / 64; ++x) boxes += it.n0 + 64 * x < a.F;
        for (int k0 = it.row_begin; k0 < it.row_end; k0 += kTgDepth, ++kt) {
          const int s = kt % kTgStages;
          const uint32_t st = base + s * kTgStage, bar = full + 8 * s;
          hopper::mbar_wait(empty + 8 * s, ((kt / kTgStages) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(bar, boxes * kTgBox);
          for (int x = 0; x < kTgRows / 64; ++x)
            if (it.m0 + 64 * x < a.D)
              hopper::tma_load_2d(st + x * kTgBox, &tm_x, bar, it.m0 + 64 * x,
                                  k0);
          for (int x = 0; x < kTgCols / 64; ++x)
            if (it.n0 + 64 * x < a.F)
              hopper::tma_load_2d(st + kTgA + x * kTgBox, &tm_dy, bar,
                                  it.n0 + 64 * x, k0);
        }
      }
    }
  } else {
    // ---------------------------------------------------- consumers
    hopper::reg_alloc<232>();
    const int w = wg - 1, tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    bf16* out = static_cast<bf16*>(a.out);
    int kt = 0;
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
      const TgItem it = tg_item(i, a, first, last, order);
      float acc[128];
#pragma unroll
      for (int j = 0; j < 128; ++j) acc[j] = 0.f;
      int held = -1;  // the stage whose products may still be running
      for (int k0 = it.row_begin; k0 < it.row_end; k0 += kTgDepth, ++kt) {
        const int s = kt % kTgStages;
        const uint32_t st = base + s * kTgStage;
        hopper::mbar_wait(full + 8 * s, (kt / kTgStages) & 1);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kTgDepth / 16; ++kk) {
          hopper::wgmma_m64n256_ss<1, 1>(
              acc, hopper::desc_sw128(st + w * kTgBox + kk * 2048, kTgBox, 1024),
              hopper::desc_sw128(st + kTgA + kk * 2048, kTgBox, 1024), 1);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // the previous stage's products are done
        if (held >= 0 && lane == 0) hopper::mbar_arrive(empty + 8 * held);
        held = s;
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      if (held >= 0 && lane == 0) hopper::mbar_arrive(empty + 8 * held);

      // the f32 sum over the whole run, rounded once to x's type
      const int row = it.m0 + 64 * w + 16 * warp + g;
      bf16* dst = out + (long long)it.e * a.D * a.F;
#pragma unroll
      for (int c = 0; c < 32; ++c) {
        const int col = it.n0 + 8 * c + 2 * t4;
        if (col >= a.F) continue;
        if (row < a.D)
          store2(dst + (long long)row * a.F + col, acc[4 * c], acc[4 * c + 1]);
        if (row + 8 < a.D)
          store2(dst + (long long)(row + 8) * a.F + col, acc[4 * c + 2],
                 acc[4 * c + 3]);
      }
    }
  }
}

int launch_tgmm_wgmma(const GmmArgs& a, cudaStream_t stream) {
  // with no rows nothing is loaded: the maps then name dW, which holds a
  // row of either width
  const cuuint64_t rows = a.N > 0 ? (cuuint64_t)a.N : 1;
  const void* x = a.N > 0 ? a.a : a.out;
  const void* dy = a.N > 0 ? a.b : a.out;
  const cuuint64_t x_dims[2] = {(cuuint64_t)a.D, rows};
  const cuuint64_t x_stride[1] = {(cuuint64_t)a.D * sizeof(bf16)};
  const cuuint64_t dy_dims[2] = {(cuuint64_t)a.F, rows};
  const cuuint64_t dy_stride[1] = {(cuuint64_t)a.F * sizeof(bf16)};
  const cuuint32_t box[2] = {64, kTgDepth};
  CUtensorMap tx, tdy;
  int err = hopper::encode_bf16(&tx, x, 2, x_dims, x_stride, box);
  if (err == 0) err = hopper::encode_bf16(&tdy, dy, 2, dy_dims, dy_stride, box);
  if (err != 0) return err;
  const size_t smem = tgmm_smem_bytes(a.E);
  const int sms = hopper::num_sms();
  if (smem > kMaxSmem || sms <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      tgmm_wgmma, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int items =
      a.E * ((a.D + kTgRows - 1) / kTgRows) * ((a.F + kTgCols - 1) / kTgCols);
  tgmm_wgmma<<<items < sms ? items : sms, kTgThreads, smem, stream>>>(tx, tdy,
                                                                     a);
  return (int)cudaGetLastError();
}

// --------------------------------------------- K5 and K6, bf16: wgmma + TMA
//
// gmm_rows_wgmma<MODE>: y = x . w[e] (K5, kFwd) or dx = dy . w[e]^T (K6,
// kDxt), one output tile of 128 rows x 256 columns per work item.  bm is
// a multiple of 128, so an item's rows never straddle two experts; the
// item's expert comes from tile_expert in device memory (no host
// synchronisation).  A persistent grid (one block per SM at most) walks
// the items row-tile-major with the column tiles innermost, so the items
// in flight cover a few consecutive row tiles, mostly of one expert, and
// every column tile of them: they share the expert's weights and their
// own rows in L2.  384 threads: warpgroup 0 is the producer (one thread
// starts every TMA load), warpgroups 1 and 2 each own 64 rows of the
// tile.  A stage is 64 deep in the reduction (D for K5, F for K6): the
// item's rows of x or dy as one [128][64] box from a 2-D map over [N, D]
// or [N, F] (the A operand, K-major), and four [64 d][64 f] boxes of w[e]
// from a 3-D map over [E, D, F], so a box that runs past D loads zeros
// and not the next expert's rows.  K5 reads those boxes as B = [64 d]
// [256 f], MN-major (like K7's dy); K6 reads them as 256 rows of d, each
// 64 f deep, K-major: w in its stored layout, the four boxes back to back
// at 1024 bytes per 8 rows.  The stages run through a 4-stage ring of
// full/empty mbarriers that runs on across items, so the next item's
// loads overlap this item's last products and its epilogue.  Each
// consumer keeps its 64 x 256 f32 sum in registers (m64n256k16), keeps
// one stage of products in flight while it waits for the next, and rounds
// once to the output's type.  Its epilogue writes the tile in two halves
// of 128 columns into a 128-byte-swizzled staging buffer (conflict-free)
// that TMA stores, so the global writes run under the next item's
// products instead of holding the tensor cores.  Ragged D/F edges load
// as zeros and are clipped by the TMA store; a box wholly past the
// output's width is neither loaded nor stored.  With counts, an item with
// no live row loads nothing and multiplies nothing, and stores zeros
// (live_rows).

constexpr int kRwRows = 128;     // output rows per work item: 2 x 64
constexpr int kRwCols = 256;     // output columns per work item
constexpr int kRwDepth = 64;     // reduction depth per stage
constexpr int kRwStages = 4;
constexpr int kRwThreads = 384;  // producer + two consumer warpgroups
constexpr uint32_t kRwBox = 64 * 128;   // one [64][64] bf16 box
constexpr uint32_t kRwA = 2 * kRwBox;   // the A rows: [128][64]
constexpr uint32_t kRwStage = kRwA + (kRwCols / 64) * kRwBox;  // + w
constexpr uint32_t kRwOut = 2 * kRwBox;  // a consumer's staging: [64][128]
constexpr uint32_t kRwBar = kRwStages * kRwStage + 2 * kRwOut;

// ring, the consumers' staging, full and empty barriers, then each
// expert's first row tile
size_t rows_smem_bytes(int E) {
  return kRwBar + 16 * kRwStages + sizeof(int) * (size_t)E + 1024;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// stages of one item's reduction
template <int MODE>
__device__ __forceinline__ int rw_stages(const GmmArgs& a) {
  return MODE == kFwd ? (a.D + kRwDepth - 1) / kRwDepth
                      : (a.F + kRwDepth - 1) / kRwDepth;
}

struct RwItem {
  int m0, n0, e, live;
};

// Work item i: its output tile, its expert and its live rows.
template <int MODE>
__device__ __forceinline__ RwItem rw_item(int i, const GmmArgs& a,
                                          const int* first) {
  const int n_tiles = ((MODE == kFwd ? a.F : a.D) + kRwCols - 1) / kRwCols;
  RwItem it;
  it.m0 = (i / n_tiles) * kRwRows;
  it.n0 = (i % n_tiles) * kRwCols;
  it.e = min(max(a.te[it.m0 / a.bm], 0), a.E - 1);
  it.live = a.counts == nullptr
                ? kRwRows
                : live_rows(a, it.e, first[it.e] * a.bm, it.m0);
  return it;
}

template <int MODE>
__global__ void __launch_bounds__(kRwThreads, 1)
    gmm_rows_wgmma(const __grid_constant__ CUtensorMap tm_a,
                   const __grid_constant__ CUtensorMap tm_w,
                   const __grid_constant__ CUtensorMap tm_out,
                   const GmmArgs a) {
  extern __shared__ __align__(1024) unsigned char smem_rw[];
  // swizzled boxes start on 1024-byte boundaries
  const uint32_t raw = hopper::smem_u32(smem_rw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t full = base + kRwBar, empty = full + 8 * kRwStages;
  int* first = reinterpret_cast<int*>(smem_rw + (base - raw) + kRwBar +
                                      16 * kRwStages);
  const int tiles = a.N / a.bm;

  for (int e = threadIdx.x; e < a.E; e += blockDim.x) first[e] = tiles;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRwStages; ++s) {
      hopper::mbar_init(full + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, 8);  // every consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();
  // the first row tile of each expert's run (tile_expert is
  // non-decreasing), where live_rows counts the run's rows from
  for (int t = threadIdx.x; t < tiles; t += blockDim.x)
    atomicMin(first + min(max(a.te[t], 0), a.E - 1), t);
  __syncthreads();

  const int nc = MODE == kFwd ? a.F : a.D;  // output columns
  const int items = (a.N / kRwRows) * ((nc + kRwCols - 1) / kRwCols);
  const int nk = rw_stages<MODE>(a);
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------------------------------------------- producer
    hopper::reg_dealloc<40>();
    if (threadIdx.x == 0) {
      int kt = 0;  // stages started so far: the ring's position and phase
      for (int i = blockIdx.x; i < items; i += gridDim.x) {
        const RwItem it = rw_item<MODE>(i, a, first);
        if (it.live == 0) continue;
        int boxes = 0;
        for (int x = 0; x < kRwCols / 64; ++x) boxes += it.n0 + 64 * x < nc;
        for (int k = 0; k < nk; ++k, ++kt) {
          const int s = kt % kRwStages, k0 = k * kRwDepth;
          const uint32_t st = base + s * kRwStage, bar = full + 8 * s;
          hopper::mbar_wait(empty + 8 * s, ((kt / kRwStages) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(bar, kRwA + boxes * kRwBox);
          hopper::tma_load_2d(st, &tm_a, bar, k0, it.m0);
          for (int x = 0; x < kRwCols / 64; ++x) {
            const int n = it.n0 + 64 * x;
            if (n >= nc) continue;
            if (MODE == kFwd)  // B = w[e][k0:k0+64][n:n+64], MN-major
              hopper::tma_load_3d(st + kRwA + x * kRwBox, &tm_w, bar, n, k0,
                                  it.e);
            else  // B^T = w[e][n:n+64][k0:k0+64], K-major
              hopper::tma_load_3d(st + kRwA + x * kRwBox, &tm_w, bar, k0, n,
                                  it.e);
          }
        }
      }
    }
  } else {
    // ---------------------------------------------------- consumers
    hopper::reg_alloc<232>();
    const int w = wg - 1, tid = threadIdx.x & 127;
    const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t4 = lane & 3;
    const uint32_t staging = base + kRwStages * kRwStage + w * kRwOut;
    int kt = 0;
    for (int i = blockIdx.x; i < items; i += gridDim.x) {
      const RwItem it = rw_item<MODE>(i, a, first);
      float acc[128];
#pragma unroll
      for (int j = 0; j < 128; ++j) acc[j] = 0.f;
      if (it.live > 0) {
        int held = -1;  // the stage whose products may still be running
        for (int k = 0; k < nk; ++k, ++kt) {
          const int s = kt % kRwStages;
          const uint32_t st = base + s * kRwStage;
          hopper::mbar_wait(full + 8 * s, (kt / kRwStages) & 1);
          hopper::wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kRwDepth / 16; ++kk) {
            // A: this warpgroup's 64 rows, 16 deep (32 bytes a k step)
            const uint64_t da =
                hopper::desc_sw128(st + w * kRwBox + kk * 32, 16, 1024);
            if (MODE == kFwd)  // B: 16 rows of d (2048 bytes a k step)
              hopper::wgmma_m64n256_ss<0, 1>(
                  acc, da,
                  hopper::desc_sw128(st + kRwA + kk * 2048, kRwBox, 1024), 1);
            else  // B: 256 rows of d, 16 deep in f
              hopper::wgmma_m64n256_ss<0, 0>(
                  acc, da, hopper::desc_sw128(st + kRwA + kk * 32, 16, 1024),
                  1);
          }
          hopper::wgmma_commit();
          hopper::wgmma_wait<1>();  // the previous stage's products are done
          if (held >= 0 && lane == 0) hopper::mbar_arrive(empty + 8 * held);
          held = s;
        }
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        if (held >= 0 && lane == 0) hopper::mbar_arrive(empty + 8 * held);
      }

      // the f32 sums rounded once to the output's type, rows past the
      // live ones zero, staged and stored by TMA half by half: row r of a
      // [64][64] box holds its 16-byte chunk j at chunk j ^ (r % 8), and
      // r % 8 = g for both of the thread's rows
      const int r = 16 * warp + g;  // the thread's first row of the 64
      const bool keep0 = 64 * w + r < it.live;
      const bool keep1 = 64 * w + r + 8 < it.live;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        // the previous store has read the staging buffer
        if (tid == 0) hopper::bulk_wait_read<0>();
        hopper::named_sync(1 + w, 128);
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int c = 16 * h + j;  // 8-column chunk of the tile
          const uint32_t at = staging + (j >> 3) * kRwBox + r * 128 +
                              (((j & 7) ^ g) << 4) + 4 * t4;
          hopper::st_shared_b32(at, keep0 ? pack_bf16(acc[4 * c],
                                                      acc[4 * c + 1])
                                          : 0u);
          hopper::st_shared_b32(at + 8 * 128,
                                keep1 ? pack_bf16(acc[4 * c + 2],
                                                  acc[4 * c + 3])
                                      : 0u);
        }
        hopper::fence_proxy_async();
        hopper::named_sync(1 + w, 128);
        if (tid == 0) {
          for (int b = 0; b < 2; ++b) {
            const int col = it.n0 + 128 * h + 64 * b;
            if (col < nc)
              hopper::tma_store_2d(&tm_out, staging + b * kRwBox, col,
                                   it.m0 + 64 * w);
          }
          hopper::bulk_commit();
        }
      }
    }
    if (tid == 0) hopper::bulk_wait<0>();
  }
}

template <int MODE>
int launch_rows_wgmma(const GmmArgs& a, cudaStream_t stream) {
  // A = x [N, D] (K5) or dy [N, F] (K6); w [E, D, F] as a 3-D map, so
  // boxes past D or F load zeros
  const int K = MODE == kFwd ? a.D : a.F;
  const cuuint64_t a_dims[2] = {(cuuint64_t)K, (cuuint64_t)a.N};
  const cuuint64_t a_stride[1] = {(cuuint64_t)K * sizeof(bf16)};
  const cuuint32_t a_box[2] = {64, kRwRows};
  const cuuint64_t w_dims[3] = {(cuuint64_t)a.F, (cuuint64_t)a.D,
                                (cuuint64_t)a.E};
  const cuuint64_t w_stride[2] = {(cuuint64_t)a.F * sizeof(bf16),
                                  (cuuint64_t)a.D * a.F * sizeof(bf16)};
  const cuuint32_t w_box[3] = {64, 64, 1};
  // the output: y [N, F] (K5) or dx [N, D] (K6), stored in [64][64] boxes
  const int nc = MODE == kFwd ? a.F : a.D;
  const cuuint64_t o_dims[2] = {(cuuint64_t)nc, (cuuint64_t)a.N};
  const cuuint64_t o_stride[1] = {(cuuint64_t)nc * sizeof(bf16)};
  const cuuint32_t o_box[2] = {64, 64};
  CUtensorMap ta, tw, to;
  int err = hopper::encode_bf16(&ta, a.a, 2, a_dims, a_stride, a_box);
  if (err == 0) err = hopper::encode_bf16(&tw, a.b, 3, w_dims, w_stride, w_box);
  if (err == 0) err = hopper::encode_bf16(&to, a.out, 2, o_dims, o_stride, o_box);
  if (err != 0) return err;
  const size_t smem = rows_smem_bytes(a.E);
  const int sms = hopper::num_sms();
  if (smem > kMaxSmem || sms <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      gmm_rows_wgmma<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int items = (a.N / kRwRows) * ((nc + kRwCols - 1) / kRwCols);
  gmm_rows_wgmma<MODE><<<items < sms ? items : sms, kRwThreads, smem,
                         stream>>>(ta, tw, to, a);
  return (int)cudaGetLastError();
}

int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename T, int MODE>
int launch(const GmmArgs& a, cudaStream_t stream) {
  constexpr size_t smem = Tiles<T, MODE>::bytes;
  auto kernel = gmm_kernel<T, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid;
  if (MODE == kTgmm)
    grid = dim3(cdiv(a.F, kBN), cdiv(a.D, kBM), a.E);
  else
    grid = dim3(cdiv(MODE == kFwd ? a.F : a.D, kBN), a.N / kBM);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int MODE>
int dispatch(const void* pa, const void* pb, const void* te,
             const void* counts, void* out, int N, int D, int F, int E,
             int bm, int is_bf16, void* stream) {
  if (N < 0 || D <= 0 || F <= 0 || E <= 0 || bm <= 0 || bm % kBM != 0 ||
      N % bm != 0 || D % 8 != 0 || F % 8 != 0)
    return (int)cudaErrorInvalidValue;
  GmmArgs a;
  a.a = pa;
  a.b = pb;
  a.te = static_cast<const int*>(te);
  a.counts = static_cast<const int*>(counts);
  a.out = out;
  a.N = N;
  a.D = D;
  a.F = F;
  a.E = E;
  a.bm = bm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (MODE == kTgmm) {
    // bf16 K7 is tgmm_wgmma, f32 the template
    return is_bf16 ? launch_tgmm_wgmma(a, s) : launch<float, kTgmm>(a, s);
  } else {
    // bf16 K5 and K6 are gmm_rows_wgmma, f32 the template
    if (N == 0) return (int)cudaSuccess;
    return is_bf16 ? launch_rows_wgmma<MODE>(a, s) : launch<float, MODE>(a, s);
  }
}

}  // namespace

extern "C" {

// Each entry launches one kernel on `stream` and returns
// cudaGetLastError() (0 = ok), or the failed tensor-map encode's code
// (hopper.cuh).  Operands are contiguous and start on 16-byte boundaries,
// bf16 when is_bf16 != 0 else f32; tile_expert is int32 [N / bm] with bm
// a multiple of 128; D and F are multiples of 8.  group_sizes (K5, K6) is
// int32 [E], the live rows of each expert's run, or null for all rows.

int tfos_gmm(const void* x, const void* w, const void* tile_expert,
             const void* group_sizes, void* y, int N, int D, int F, int E,
             int bm, int is_bf16, void* stream) {
  return dispatch<kFwd>(x, w, tile_expert, group_sizes, y, N, D, F, E, bm,
                        is_bf16, stream);
}

int tfos_gmm_dxt(const void* dy, const void* w, const void* tile_expert,
                 const void* group_sizes, void* dx, int N, int D, int F,
                 int E, int bm, int is_bf16, void* stream) {
  return dispatch<kDxt>(dy, w, tile_expert, group_sizes, dx, N, D, F, E, bm,
                        is_bf16, stream);
}

int tfos_tgmm(const void* x, const void* dy, const void* tile_expert,
              void* dw, int N, int D, int F, int E, int bm, int is_bf16,
              void* stream) {
  return dispatch<kTgmm>(x, dy, tile_expert, nullptr, dw, N, D, F, E, bm,
                         is_bf16, stream);
}

}  // extern "C"
