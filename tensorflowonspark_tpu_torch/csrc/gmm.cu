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
//               bf16: tgmm_wgmma (wgmma fed by TMA, below); f32: the
//               mma.sync template
//
// They compute what the TPU kernels compute, with the same rounding
// points: products accumulate in f32 and round once, y to x's type, dx to
// dy's type, dw (summed over the expert's whole run) to x's type.  An
// expert that owns no row tile gets dw = 0 exactly (the reference zeroes
// those rows after its kernel, ops/gmm.py:304-307).
//
// Bound: operations.  At the MoE flagship's training shape (G = B*S = 8192
// tokens, top-2, D = 1024, F = 4096, E = 8) the layout holds 16,384 routed
// rows in NP = 18,432; each launch does 2 * 16,384 * 1024 * 4096 =
// 137.4 Gflop of routed work (154.6 over NP): 0.139 ms at 989 Tflop/s
// bf16 dense, against about 235 MB of operands (0.070 ms at 3.35 TB/s).
//
// Design.  The TPU kernels walk a sequential grid with the row tiles
// innermost, so a weight block stays resident across an expert's tiles
// and K7 carries its sum in VMEM scratch from tile to tile, flushing at
// the run's last one.  GPU blocks run in no order, so every block owns one
// 128 x 128 output tile and loops over the whole reduction itself:
//  - K5 and K6: one block per (128-row tile, 128-column tile).  bm is a
//    multiple of 128, so a block's rows never straddle two experts; the
//    block reads its expert from tile_expert in device memory (no host
//    synchronisation anywhere) and loops over D (K5) or F (K6).
//  - K7: one block per (expert, 128-row tile of D, 128-column tile of F).
//    It finds its expert's contiguous run of row tiles in tile_expert,
//    loops over the run's rows with the sum in f32 registers, and writes
//    once: no atomics, bit-reproducible, and an absent expert's run is
//    empty, so it writes zeros.  At the flagship 8 x 8 x 32 = 2048 output
//    tiles fill the 132 SMs.
//  - Eight warps, 2 x 4, each own a 64 x 32 piece of the tile.  Operand
//    tiles of depth 32 stream through a 3-stage cp.async ring in shared
//    memory (rows padded by 16 bytes against bank conflicts, ragged edges
//    zero-filled).  bf16 runs on the tensor cores: mma.sync m16n8k16 (bf16
//    in, f32 accumulate) with ldmatrix fragments, .trans where an operand
//    is stored with the reduction dimension outermost (K5's and K7's w/dy
//    tiles, K7's x tile).  f32 computes the same accumulator layout with
//    FMAs (no TF32), so the f32 tolerances hold.
// The list above describes the mma.sync template, which keeps K5 and K6
// in both types and K7 in f32; bf16 K7 is tgmm_wgmma, with its own note.
// Later work toward the bound: K5 and K6 on the wgmma/TMA machinery of
// hopper.cuh, and skipping the layout's all-pad tail tiles.

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

template <>
struct Mma<bf16> {
  struct A {
    uint32_t r[4];
  };
  struct B {
    uint32_t r[2];
  };
  // One ldmatrix.x4 of the four 8x8 quarters (quarter j = lane / 8 covers
  // rows 8 * (j & 1) and k 8 * (j >> 1)).  Stored [m][k] (ak == 1): lane
  // l addresses row l % 8 of its quarter.  Stored [k][m] (am == 1): lane
  // l addresses k row l % 8 of its quarter, and .trans hands each lane
  // the (m, k) pairs the fragment wants.
  static __device__ __forceinline__ void load_a(A& f, const bf16* a, int am,
                                                int ak) {
    const int lane = threadIdx.x & 31, r = lane & 7, j = lane >> 3;
    if (ak == 1) {
      const bf16* p = a + (r + 8 * (j & 1)) * am + 8 * (j >> 1);
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, "
          "[%4];\n"
          : "=r"(f.r[0]), "=r"(f.r[1]), "=r"(f.r[2]), "=r"(f.r[3])
          : "r"(shared_addr(p)));
    } else {
      const bf16* p = a + (r + 8 * (j >> 1)) * ak + 8 * (j & 1);
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
          "[%4];\n"
          : "=r"(f.r[0]), "=r"(f.r[1]), "=r"(f.r[2]), "=r"(f.r[3])
          : "r"(shared_addr(p)));
    }
  }
  // B stored [n][k] (bk == 1): ldmatrix.x2 of the two k halves; stored
  // [k][n] (bn == 1): the transposing ldmatrix.x2.trans
  static __device__ __forceinline__ void load_b(B& f, const bf16* b, int bk,
                                                int bn) {
    const int lane = threadIdx.x & 31, r = lane & 7, j = (lane >> 3) & 1;
    if (bk == 1) {
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
          : "=r"(f.r[0]), "=r"(f.r[1])
          : "r"(shared_addr(b + r * bn + 8 * j)));
    } else {
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
          : "=r"(f.r[0]), "=r"(f.r[1])
          : "r"(shared_addr(b + (r + 8 * j) * bk)));
    }
  }
  static __device__ __forceinline__ void mma(float c[4], const A& a,
                                             const B& b) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
        "{%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a.r[0]), "r"(a.r[1]), "r"(a.r[2]), "r"(a.r[3]), "r"(b.r[0]),
          "r"(b.r[1]));
  }
};

// f32: the same accumulator layout computed with FMAs from shared memory.
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

  // the block's expert, output matrix (M x NC) and reduction range
  int e, M, NC, k_begin, k_end;
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
    k_begin = 0;
    k_end = MODE == kFwd ? a.D : a.F;
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

  // f32 sums rounded once to the output type
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int row = m0 + wm * 64 + mt * 16 + g;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + wn * 32 + nt * 8 + 2 * t4;
      if (col >= NC) continue;
      if (row < M)
        store2(out + (long long)row * NC + col, c[mt][nt][0], c[mt][nt][1]);
      if (row + 8 < M)
        store2(out + (long long)(row + 8) * NC + col, c[mt][nt][2],
               c[mt][nt][3]);
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
int dispatch(const void* pa, const void* pb, const void* te, void* out, int N,
             int D, int F, int E, int bm, int is_bf16, void* stream) {
  if (N < 0 || D <= 0 || F <= 0 || E <= 0 || bm <= 0 || bm % kBM != 0 ||
      N % bm != 0 || D % 8 != 0 || F % 8 != 0)
    return (int)cudaErrorInvalidValue;
  GmmArgs a;
  a.a = pa;
  a.b = pb;
  a.te = static_cast<const int*>(te);
  a.out = out;
  a.N = N;
  a.D = D;
  a.F = F;
  a.E = E;
  a.bm = bm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if constexpr (MODE == kTgmm) {
    // bf16 K7 is tgmm_wgmma; the mma.sync template keeps f32
    return is_bf16 ? launch_tgmm_wgmma(a, s) : launch<float, kTgmm>(a, s);
  } else {
    if (N == 0) return (int)cudaSuccess;
    return is_bf16 ? launch<bf16, MODE>(a, s) : launch<float, MODE>(a, s);
  }
}

}  // namespace

extern "C" {

// Each entry launches one kernel on `stream` and returns
// cudaGetLastError() (0 = ok).  Operands are contiguous, bf16 when
// is_bf16 != 0 else f32; tile_expert is int32 [N / bm] with bm a multiple
// of 128; D and F are multiples of 8.

int tfos_gmm(const void* x, const void* w, const void* tile_expert, void* y,
             int N, int D, int F, int E, int bm, int is_bf16, void* stream) {
  return dispatch<kFwd>(x, w, tile_expert, y, N, D, F, E, bm, is_bf16,
                        stream);
}

int tfos_gmm_dxt(const void* dy, const void* w, const void* tile_expert,
                 void* dx, int N, int D, int F, int E, int bm, int is_bf16,
                 void* stream) {
  return dispatch<kDxt>(dy, w, tile_expert, dx, N, D, F, E, bm, is_bf16,
                        stream);
}

int tfos_tgmm(const void* x, const void* dy, const void* tile_expert,
              void* dw, int N, int D, int F, int E, int bm, int is_bf16,
              void* stream) {
  return dispatch<kTgmm>(x, dy, tile_expert, dw, N, D, F, E, bm, is_bf16,
                         stream);
}

}  // extern "C"
