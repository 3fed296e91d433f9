// Flash attention forward and backward for Hopper (sm_90a).
//
//   K2 flash_fwd_wgmma (bf16) and flash_fwd_kernel (f32) replace
//      `_fwd_kernel` (the JAX package's ops/flash_attention.py:132,
//      pallas_call at :409): O and lse.
//   K3 flash_dq_wgmma (bf16) and flash_dq_kernel (f32) replace
//      `_dq_kernel` (:198, call :491): dQ.
//   K4 flash_dkv_wgmma (bf16) and flash_dkv_kernel (f32) replace
//      `_dkv_kernel` (:256, call :523): dK, dV.
//
// They compute what the TPU kernels compute, with the same rounding
// points: logits s = scale * q.k in f32 with a finite -1e30 mask; the
// forward keeps a running max m, normaliser l and an f32 accumulator per
// query row, rounds p = exp(s - m) to v's type before P.V, and writes
// O = acc / max(l, 1e-30) in q's type and lse = m + log(max(l, 1e-30))
// in f32.  The backward recomputes p = exp(s - lse), takes
// delta = rowsum(f32 dO * f32 O) from the caller, forms
// ds = p * (dp - delta) * scale in f32, and rounds p to dO's type before
// P^T.dO and ds to k's/q's type before dS.K and dS^T.Q.
//
// Layout: q and dO are [B, S, H, D], k and v [B, S, Hkv, D], each read
// from its (batch, sequence, head) strides with a unit last stride, so
// the model's projections are used as they are (the reference swaps
// axes to [B, H, S, D] first).  O and dQ are written contiguous
// [B, S, H, D], dK and dV [B, S, Hkv, D], lse and delta are f32
// [B, H, S].  H = G * Hkv: query head h reads kv head h / G.
//
// q_offset (the reference's, `_causal_mask` :74 and `_block_relevant`
// :94): local query row r sits at global position q_offset + r against
// keys 0..S-1, as ring attention's chunk at ring distance m does with
// q_offset = m * S_local.  Rows are bounded locally (r < S) and masked
// on their global position; every tile range and "needs a mask" test
// takes the offset.  Under a window an offset chunk has rows that see no
// key and keys no row sees: such a row's lse is -1e30 and its O finite
// (merge_partial weighs it 0), such a key's dK and dV are exact zeros.
// K2 in bf16 writes O in f32 on request (out_f32: ring partials taken
// straight from the accumulator).
//
// Bound: operations.  One causal product at the flagship training shape
// (B=8, H=8, S=2048, D=128) is B*H*S^2*D = 3.44e10 flop (2 per
// multiply-add over the S(S+1)/2 visible pairs); K2 does 2 products
// (QK^T, PV: 0.069 ms at 989 Tflop/s bf16 dense), K3 3 (QK^T, dO.V^T,
// dS.K: 0.104 ms), K4 4 (KQ^T, V.dO^T, P^T.dO, dS^T.Q: 0.139 ms).  K2
// moves about 135 MB (q, k, v read, O written: 0.040 ms at 3.35 TB/s),
// so all three sit well above the card's 295 flop/byte ridge.
//
// Design.  The TPU grid streams kv blocks through a sequential trailing
// grid dimension with the softmax state in VMEM scratch; GPU blocks run
// in no order, so each block owns one output tile and loops over the
// tiles it needs itself, with the state in registers.  No atomics
// anywhere, so every run is bit-reproducible.
//  - bf16 (K2 flash_fwd_wgmma, K3 flash_dq_wgmma, K4 flash_dkv_wgmma):
//    warp-specialised wgmma kernels fed by TMA (hopper.cuh); see their
//    own notes below.
//  - f32 (flash_fwd_kernel, flash_dq_kernel, flash_dkv_kernel): the
//    mma.sync accumulator layout computed with FMAs (no TF32), so the
//    f32 tolerances hold.  K2 and K3: one block per (q tile of 64 rows,
//    head, batch); the loop runs over the key tiles from the first one
//    the window can touch to the diagonal (causal) or the last (non-
//    causal).  Tiles outside are skipped, not masked (the reference's
//    _block_relevant/banding).  K4: one block per (key tile of 64 rows,
//    kv head, batch), looping over the G query heads of the kv head and
//    the q tiles from the diagonal to the window's end; dK and dV
//    accumulate in f32 registers over the whole group and are written
//    once, cast once: the group sum happens inside the kernel (the
//    reference writes per-q-head f32 partials and sums them outside,
//    :563-566).  Each of the 4 warps owns 16 rows of the block's 64-row
//    tile; the tiles are staged in shared memory with 16-byte cp.async
//    copies, rows padded by 16 bytes against bank conflicts, and the
//    ragged tail past S is zero-filled and masked.
// Later work toward the bound: for the bf16 K2, 64-key tiles, so that the
// next tile's Q.K^T can be in flight during a softmax (see its note);
// for K3 and K4, the next tile's products in flight during the
// elementwise work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;  // 4 warps x 16 rows = one 64-row tile
constexpr int kBM = 64;        // query rows per tile
constexpr int kBN = 64;        // key rows per tile

struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  void* out;
  float* lse_out;
  void* dq;
  void* dk;
  void* dv;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;  // dO
  int B, S, H, Hkv;
  float scale;
  int causal, window;
  // global position of local query row 0 (keys start at 0): ring
  // attention's chunk at ring distance m sits m * S_local ahead of the
  // keys it visits
  int q_offset;
  int out_f32;  // K2, bf16: write O in f32 (ring partials)
};

template <typename T>
struct Vec {
  static constexpr int kN = 16 / sizeof(T);  // elements per 16 bytes
};

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Warp-level 16x8x16 product c += A.B in the mma.sync accumulator layout,
// for f32 computed with FMAs from shared memory (no TF32): lane (g = lane
// / 4, t = lane % 4) holds c[0], c[1] at row g, columns 2t, 2t+1 and
// c[2], c[3] at row g + 8.  Element (m, k) of A is a[m * am + k * ak],
// element (k, n) of B is b[k * bk + n * bn].
template <typename T>
struct Mma;

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

// c[16 x 8*NT] += A[16 x K] . B[K x 8*NT] for one warp (strides as Mma).
template <typename T, int NT, int K>
__device__ __forceinline__ void warp_gemm(float (&c)[NT][4], const T* a,
                                          int am, int ak, const T* b, int bk,
                                          int bn) {
#pragma unroll
  for (int k0 = 0; k0 < K; k0 += 16) {
    typename Mma<T>::A fa;
    Mma<T>::load_a(fa, a + k0 * ak, am, ak);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      typename Mma<T>::B fb;
      Mma<T>::load_b(fb, b + k0 * bk + 8 * n * bn, bk, bn);
      Mma<T>::mma(c[n], fa, fb);
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) c[n][0] = c[n][1] = c[n][2] = c[n][3] = 0.f;
}

// Asynchronous copies into shared memory (cp.async): a source that is
// not live is not read and its destination is zero-filled.  A thread's
// copies form a group at cp_async_commit; cp_async_wait<N> returns once
// at most N of its groups are still in flight (a __syncthreads after it
// makes every thread's copies visible to the block).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool live) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   shared_addr(dst)),
               "l"(src), "r"(live ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool live) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   shared_addr(dst)),
               "l"(src), "r"(live ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows [row0, row0 + ROWS) of one head into a [ROWS][D + VEC] shared
// tile, 16 bytes per copy; rows at or past S are zero.
template <typename T, int ROWS, int D>
__device__ __forceinline__ void load_tile(T* dst, const T* src, long long ss,
                                          int row0, int S) {
  constexpr int V = Vec<T>::kN, C = D / V, LD = D + V;
  for (int i = threadIdx.x; i < ROWS * C; i += kThreads) {
    const int r = i / C, c = i - r * C;
    const bool live = row0 + r < S;
    cp_async16(dst + r * LD + c * V,
               live ? src + (long long)(row0 + r) * ss + c * V : src, live);
  }
}

// Entries [row0, row0 + kBM) of one head's f32 row vector (lse, delta).
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int S) {
  for (int x = threadIdx.x; x < kBM; x += kThreads) {
    const bool live = row0 + x < S;
    cp_async4(dst + x, live ? src + row0 + x : src, live);
  }
}

// Whether key kpos is visible to local query row `row`: both inside S,
// and the key neither after the row's global position q_off + row
// (causal) nor at or behind its window's horizon.  q_off is a.q_offset,
// or a constant 0 in the Hopper kernels' zero-offset instantiations.
__device__ __forceinline__ bool visible(int row, int kpos, const FlashArgs& a,
                                        int q_off) {
  if (row >= a.S || kpos >= a.S) return false;
  const int qpos = q_off + row;
  if (a.causal && kpos > qpos) return false;
  if (a.window > 0 && kpos <= qpos - a.window) return false;
  return true;
}

// Key tiles of KEYS keys that the local query rows [q0, q0 + ROWS) can
// see: from the first the window can touch to the diagonal (causal) or
// the last.  lo > hi when they see none (an offset chunk behind the
// window's horizon).
template <int ROWS, int KEYS>
__device__ __forceinline__ void key_range(int q0, const FlashArgs& a,
                                          int q_off, int& lo, int& hi) {
  // the rows' global positions
  const int first = q_off + q0;
  const int last = q_off + min(a.S, q0 + ROWS) - 1;
  const int k_hi = a.causal ? min(a.S - 1, last) : a.S - 1;
  const int k_lo =
      (a.causal && a.window > 0) ? max(0, first - a.window + 1) : 0;
  hi = k_hi / KEYS;
  lo = k_lo <= k_hi ? k_lo / KEYS : hi + 1;
}

// Query tiles of ROWS local rows that can see the keys [k0, k0 + KEYS):
// from the diagonal (causal) or the first to the window's end or the
// last.  lo > hi when none can.
template <int KEYS, int ROWS>
__device__ __forceinline__ void query_range(int k0, const FlashArgs& a,
                                            int q_off, int& lo, int& hi) {
  const int k_last = min(a.S, k0 + KEYS) - 1;
  const int r_lo = a.causal ? max(0, k0 - q_off) : 0;
  const int r_hi = (a.causal && a.window > 0)
                       ? min(a.S - 1, k_last + a.window - 1 - q_off)
                       : a.S - 1;
  lo = r_lo / ROWS;
  hi = r_lo <= r_hi ? r_hi / ROWS : lo - 1;
}

// The f32 kernels' tiles
__device__ __forceinline__ void key_tiles(int q0, const FlashArgs& a, int& lo,
                                          int& hi) {
  key_range<kBM, kBN>(q0, a, a.q_offset, lo, hi);
}
__device__ __forceinline__ void query_tiles(int k0, const FlashArgs& a,
                                            int& lo, int& hi) {
  query_range<kBN, kBM>(k0, a, a.q_offset, lo, hi);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <typename T, int D>
struct Smem {
  static constexpr int LD = D + Vec<T>::kN;     // [64][D] tiles
  static constexpr int LDP = kBN + Vec<T>::kN;  // [64][64] tiles
  static constexpr size_t tile = (size_t)kBM * LD * sizeof(T);
  static constexpr size_t ptile = (size_t)kBM * LDP * sizeof(T);
  static constexpr size_t fwd = 3 * tile + ptile;
  static constexpr size_t dq = 4 * tile + ptile;
  static constexpr size_t dkv = 4 * tile + 2 * ptile + 2 * kBM * sizeof(float);
};

// ---------------------------------------------------------------- K2

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const FlashArgs a) {
  constexpr int LD = Smem<T, D>::LD, LDP = Smem<T, D>::LDP, NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sK = sQ + kBM * LD;
  T* sV = sK + kBN * LD;
  T* sP = sV + kBN * LD;

  const int q0 = blockIdx.x * kBM, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const T* sQw = sQ + warp * 16 * LD;
  T* sPw = sP + warp * 16 * LDP;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};

  float o[NT][4];
  zero(o);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  int j_lo, j_hi;
  key_tiles(q0, a, j_lo, j_hi);
  if (j_lo <= j_hi) {
    load_tile<T, kBM, D>(sQ, q, a.q_ss, q0, a.S);
    load_tile<T, kBN, D>(sK, k, a.k_ss, j_lo * kBN, a.S);
    cp_async_commit();
  }

  // K and V stream through one buffer each, staggered: V_j lands while
  // Q.K_j^T runs, K_{j+1} while P.V_j runs
  for (int j = j_lo; j <= j_hi; ++j) {
    const int k0 = j * kBN;
    cp_async_wait<0>();
    __syncthreads();  // K_j visible; every warp is done with V_{j-1}
    load_tile<T, kBN, D>(sV, v, a.v_ss, k0, a.S);
    cp_async_commit();

    float s[8][4];
    zero(s);
    warp_gemm<T, 8, D>(s, sQw, LD, 1, sK, 1, LD);  // Q.K^T

    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * n + 2 * t + (e & 1);
        const float x =
            visible(row[e >> 1], col, a, a.q_offset) ? s[n][e] * a.scale
                                                     : kNegInf;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - m[e >> 1]);
        sum[e >> 1] += p;
        s[n][e] = p;
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    // p rounded to the value type, this warp's 16 rows
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      store2(sPw + g * LDP + 8 * n + 2 * t, s[n][0], s[n][1]);
      store2(sPw + (g + 8) * LDP + 8 * n + 2 * t, s[n][2], s[n][3]);
    }
    cp_async_wait<0>();
    __syncthreads();  // V_j and P visible; every warp is done with K_j
    if (j < j_hi) {
      load_tile<T, kBN, D>(sK, k, a.k_ss, k0 + kBN, a.S);
      cp_async_commit();
    }
    warp_gemm<T, NT, kBN>(o, sPw, LDP, 1, sV, LD, 1);  // P.V
  }

  T* out = static_cast<T*>(a.out);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= a.S) continue;
    const float l_safe = fmaxf(l[r], 1e-30f);
    T* dst = out + (((long long)b * a.S + row[r]) * a.H + h) * D;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      store2(dst + 8 * n + 2 * t, o[n][2 * r] / l_safe,
             o[n][2 * r + 1] / l_safe);
    }
    if (t == 0) {
      a.lse_out[((long long)b * a.H + h) * a.S + row[r]] = m[r] + logf(l_safe);
    }
  }
}

// ------------------------------------------------- K2, bf16: wgmma + TMA
//
// One block per (head, batch, 128-row q tile), 384 threads: warpgroup 0
// is the producer (one thread starts every TMA load), warpgroups 1 and 2
// each own 64 query rows.  Q lands once; K and V tiles of 128 keys stream
// through a 2-stage ring each (full/empty mbarrier pairs), so the next
// tiles load while the current ones are used.  S = Q.K^T is a wgmma with
// both operands in shared memory (K-major); P is rounded to bf16 straight
// from the S accumulator into the register A operand of O += P.V (V is
// MN-major: the transpose bit).  Key tiles run from the diagonal down, so
// the masked tiles come first; only the diagonal, the window's edge and
// the ragged tail are masked.  The q tiles run heaviest first across the
// whole grid (the slowest grid dimension counts down), which shortens the
// causal tail.  Nothing but O, m and l is carried from one key tile to
// the next: at D = 128 one tile's O, S and P fill most of the consumers'
// registers, and a loop that kept the next tile's Q.K^T in flight during
// a softmax spilled.
// Exponentials are ex2.approx of the logits scaled by scale * log2(e) in
// one FFMA (lse 1e-5 of the plain version's on the card).

constexpr int kWgRows = 128;    // query rows per block (2 x 64)
constexpr int kWgKeys = 128;    // keys per K/V tile
constexpr int kWgStages = 2;    // depth of the K and V rings
constexpr int kWgThreads = 384;  // producer + two consumer warpgroups
constexpr uint32_t kWgBox = kWgKeys * 128;  // one [128][64] bf16 box
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
struct FwdWgSmem {
  static constexpr int kBoxes = D / 64;  // 64-wide boxes across D
  static constexpr uint32_t kTile = kBoxes * kWgBox;  // [128][D]
  static constexpr uint32_t kQ = 0;
  static constexpr uint32_t kK = kQ + kTile;
  static constexpr uint32_t kV = kK + kWgStages * kTile;
  static constexpr uint32_t kBar = kV + kWgStages * kTile;
  // barriers: Q full, then per stage K full, V full, K empty, V empty
  static constexpr size_t bytes = kBar + 8 * (1 + 4 * kWgStages) + 1024;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// S = Q.K^T of one key tile over D, 16 columns a step, both operands
// K-major: sQw is the warpgroup's 64 rows of the Q boxes, sKs the tile's
// K boxes.  One commit group.
template <int D>
__device__ __forceinline__ void fwd_start_qk(float (&sc)[64], uint32_t sQw,
                                             uint32_t sKs) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = (kk >> 2) * kWgBox + (kk & 3) * 32;
    hopper::wgmma_m64n128_ss<0, 0>(sc, hopper::desc_sw128(sQw + off, 16, 1024),
                                   hopper::desc_sw128(sKs + off, 16, 1024),
                                   kk > 0);
  }
  hopper::wgmma_commit();
}

// O += P.V of one key tile: P from registers (four per 16 keys), the
// tile's V boxes at sVs, MN-major.  One commit group.
template <int D>
__device__ __forceinline__ void fwd_start_pv(float (&o)[D / 2],
                                             const uint32_t (&p)[32],
                                             uint32_t sVs) {
#pragma unroll
  for (int kk = 0; kk < kWgKeys / 16; ++kk) {
    const uint64_t dv = hopper::desc_sw128(sVs + kk * 2048, kWgBox, 1024);
    if constexpr (D == 128)
      hopper::wgmma_m64n128_rs<1>(o, p + 4 * kk, dv, 1);
    else
      hopper::wgmma_m64n64_rs<1>(o, p + 4 * kk, dv, 1);
  }
  hopper::wgmma_commit();
}

// 2^x on the MUFU unit (ex2.approx.ftz: about 2 ulp, subnormal results
// flushed to 0, which rounds to 0 in bf16 and in l's f32 sum anyway)
__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one S tile (a warpgroup's 64 rows, the first at
// global position g0 = q_off + its local row, keys from k0, accumulator
// layout), in place: masked
// only where some pair of the tile is not visible; the row max m (of the
// raw logits q.k) and sum l updated, the rescale of O in alpha, and
// sc = exp(scale * (S - m)) in f32, computed as
// 2^(S * scale * log2(e) - m * scale * log2(e)) with one FFMA and one ex2
// an element.
template <bool OFF>
__device__ __forceinline__ void fwd_softmax(float (&sc)[64], float (&m)[2],
                                            float (&l)[2],
                                            float (&alpha)[2], int k0, int g0,
                                            int q_off, const int (&row)[2],
                                            int t, float scale_log2,
                                            const FlashArgs& a) {
  const bool masked = k0 + kWgKeys > a.S ||
                      (a.causal && k0 + kWgKeys - 1 > g0) ||
                      (a.window > 0 && k0 <= g0 + 63 - a.window);
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    const int rr = (e >> 1) & 1;
    if (masked &&
        !visible(row[rr], k0 + 8 * (e >> 2) + 2 * t + (e & 1), a, q_off))
      sc[e] = kNegInf;
    mx[rr] = fmaxf(mx[rr], sc[e]);
  }
  float sum[2] = {0.f, 0.f}, ms[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]));
    alpha[r] = ex2_approx((m[r] - m_new) * scale_log2);
    m[r] = m_new;
    // an offset chunk's row that has seen no key yet (behind the window)
    // keeps m = -1e30: its masked p must be 0, not 2^(the rounding residue
    // of -1e30 * scale * log2(e)); without an offset every row below S
    // sees its own key in the first tile
    ms[r] = (OFF && m_new == kNegInf) ? 0.f : m_new * scale_log2;
  }
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    const float pe = ex2_approx(fmaf(sc[e], scale_log2, -ms[(e >> 1) & 1]));
    sum[(e >> 1) & 1] += pe;
    sc[e] = pe;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(sum[r]);
}

// p rounded to v's type as the A fragments of P.V: element pairs of the
// S accumulator, four registers per 16 keys.
__device__ __forceinline__ void fwd_pack_p(const float (&sc)[64],
                                           uint32_t (&p)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) p[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
}

// One row r (0 or 1) of the thread's O accumulator, times inv, in the
// output's type (bf16, or f32 for ring partials).
template <int D, typename T>
__device__ __forceinline__ void fwd_store_row(T* dst, const float (&o)[D / 2],
                                              int r, int t, float inv) {
#pragma unroll
  for (int c = 0; c < D / 8; ++c)
    store2(dst + 8 * c + 2 * t, o[4 * c + 2 * r] * inv,
           o[4 * c + 2 * r + 1] * inv);
}

// OFF: instantiated with a query offset; the zero-offset instantiation
// folds every offset term away.
template <int D, bool OFF>
__global__ void __launch_bounds__(kWgThreads, 1)
    flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const FlashArgs a) {
  using L = FwdWgSmem<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // swizzled boxes start on 1024-byte boundaries
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base + L::kQ, sK = base + L::kK, sV = base + L::kV;
  const uint32_t q_full = base + L::kBar;
  const uint32_t k_full = q_full + 8, v_full = k_full + 8 * kWgStages;
  const uint32_t k_empty = v_full + 8 * kWgStages;
  const uint32_t v_empty = k_empty + 8 * kWgStages;

  const int nq = (a.S + kWgRows - 1) / kWgRows;
  const int q0 = (nq - 1 - (int)blockIdx.z) * kWgRows;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / (a.H / a.Hkv);
  // key tiles: from the first the window can touch to the diagonal
  // (causal) or the last; walked from the top down
  const int q_off = OFF ? a.q_offset : 0;
  int j_lo, j_hi;
  key_range<kWgRows, kWgKeys>(q0, a, q_off, j_lo, j_hi);
  const int n_tiles = j_hi - j_lo + 1;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kWgStages; ++s) {
      hopper::mbar_init(k_full + 8 * s, 1);
      hopper::mbar_init(v_full + 8 * s, 1);
      hopper::mbar_init(k_empty + 8 * s, 8);  // every consumer warp
      hopper::mbar_init(v_empty + 8 * s, 8);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------------------------------------------- producer
    hopper::reg_dealloc<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(q_full, L::kTile);
      for (int x = 0; x < L::kBoxes; ++x)
        hopper::tma_load_4d(sQ + x * kWgBox, &tm_q, q_full, 64 * x, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kWgStages, k0 = (j_hi - it) * kWgKeys;
        const uint32_t free_parity = ((it / kWgStages) & 1) ^ 1;
        hopper::mbar_wait(k_empty + 8 * s, free_parity);
        hopper::mbar_arrive_expect_tx(k_full + 8 * s, L::kTile);
        for (int x = 0; x < L::kBoxes; ++x)
          hopper::tma_load_4d(sK + s * L::kTile + x * kWgBox, &tm_k,
                              k_full + 8 * s, 64 * x, k0, hk, b);
        hopper::mbar_wait(v_empty + 8 * s, free_parity);
        hopper::mbar_arrive_expect_tx(v_full + 8 * s, L::kTile);
        for (int x = 0; x < L::kBoxes; ++x)
          hopper::tma_load_4d(sV + s * L::kTile + x * kWgBox, &tm_v,
                              v_full + 8 * s, 64 * x, k0, hk, b);
      }
    }
  } else {
    // ---------------------------------------------------- consumers
    hopper::reg_alloc<240>();
    const int tid = threadIdx.x & 127, warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r0 = q0 + 64 * (wg - 1);  // this warpgroup's first row
    const int g0 = q_off + r0;          // and its global position
    const int row[2] = {r0 + 16 * warp + g, r0 + 16 * warp + g + 8};
    const uint32_t sQw = sQ + (wg - 1) * 64 * 128;  // its rows of each box
    constexpr int NO = D / 2;  // the m64nD accumulator of O
    float o[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
    const float scale_log2 = a.scale * kLog2e;

    auto release = [&](uint32_t bar) {  // one arrival per warp
      if (lane == 0) hopper::mbar_arrive(bar);
    };

    hopper::mbar_wait(q_full, 0);
    for (int it = 0; it < n_tiles; ++it) {
      const int s = it % kWgStages, k0 = (j_hi - it) * kWgKeys;
      const uint32_t parity = (it / kWgStages) & 1;
      float sc[64];
      hopper::mbar_wait(k_full + 8 * s, parity);
      hopper::wgmma_fence();
      fwd_start_qk<D>(sc, sQw, sK + s * L::kTile);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      release(k_empty + 8 * s);

      float alpha[2];
      fwd_softmax<OFF>(sc, m, l, alpha, k0, g0, q_off, row, t, scale_log2,
                       a);
#pragma unroll
      for (int i = 0; i < NO; ++i) o[i] *= alpha[(i >> 1) & 1];
      uint32_t p[32];
      fwd_pack_p(sc, p);

      hopper::mbar_wait(v_full + 8 * s, parity);
      hopper::wgmma_fence();
      fwd_start_pv<D>(o, p, sV + s * L::kTile);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(o);
      hopper::fence_regs(p);
      release(v_empty + 8 * s);
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= a.S) continue;
      const float l_safe = fmaxf(l[r], 1e-30f), inv = 1.f / l_safe;
      const long long at = (((long long)b * a.S + row[r]) * a.H + h) * D;
      if (a.out_f32)
        fwd_store_row<D>(static_cast<float*>(a.out) + at, o, r, t, inv);
      else
        fwd_store_row<D>(static_cast<bf16*>(a.out) + at, o, r, t, inv);
      // a row that sees no key (O = 0) keeps the plain version's lse of
      // -1e30 (m is the raw logit here, scaled only now)
      if (t == 0) {
        a.lse_out[((long long)b * a.H + h) * a.S + row[r]] =
            (OFF && m[r] == kNegInf) ? kNegInf : m[r] * a.scale + logf(l_safe);
      }
    }
  }
}

// ---------------------------------------------------------------- K3

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dq_kernel(const FlashArgs a) {
  constexpr int LD = Smem<T, D>::LD, LDP = Smem<T, D>::LDP, NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sQ = reinterpret_cast<T*>(smem);
  T* sdO = sQ + kBM * LD;
  T* sK = sdO + kBM * LD;
  T* sV = sK + kBN * LD;
  T* sDS = sV + kBN * LD;

  const int q0 = blockIdx.x * kBM, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* dout = static_cast<const T*>(a.dout) + b * a.o_sb + h * a.o_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const T* sQw = sQ + warp * 16 * LD;
  const T* sdOw = sdO + warp * 16 * LD;
  T* sDSw = sDS + warp * 16 * LDP;
  const int row[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  float lse[2], delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long i = ((long long)b * a.H + h) * a.S + row[r];
    lse[r] = row[r] < a.S ? a.lse_in[i] : 0.f;
    delta[r] = row[r] < a.S ? a.delta[i] : 0.f;
  }

  float dq[NT][4];
  zero(dq);
  int j_lo, j_hi;
  key_tiles(q0, a, j_lo, j_hi);
  if (j_lo <= j_hi) {
    load_tile<T, kBM, D>(sQ, q, a.q_ss, q0, a.S);
    load_tile<T, kBM, D>(sdO, dout, a.o_ss, q0, a.S);
    load_tile<T, kBN, D>(sV, v, a.v_ss, j_lo * kBN, a.S);
    cp_async_commit();
    load_tile<T, kBN, D>(sK, k, a.k_ss, j_lo * kBN, a.S);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();  // Q, dO and the first V visible
  }

  // K and V stream through one buffer each, staggered: K_j lands while
  // dO.V_j^T runs, V_{j+1} while Q.K_j^T and dS.K_j run
  for (int j = j_lo; j <= j_hi; ++j) {
    const int k0 = j * kBN;
    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    warp_gemm<T, 8, D>(dp, sdOw, LD, 1, sV, 1, LD);  // dO.V^T
    cp_async_wait<0>();
    __syncthreads();  // K_j visible; every warp is done with V_j
    if (j < j_hi) {
      load_tile<T, kBN, D>(sV, v, a.v_ss, k0 + kBN, a.S);
      cp_async_commit();
    }
    warp_gemm<T, 8, D>(s, sQw, LD, 1, sK, 1, LD);  // Q.K^T
#pragma unroll
    for (int n = 0; n < 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = k0 + 8 * n + 2 * t + (e & 1);
        const float x =
            visible(row[r], col, a, a.q_offset) ? s[n][e] * a.scale : kNegInf;
        const float p = expf(x - lse[r]);
        s[n][e] = p * (dp[n][e] - delta[r]) * a.scale;
      }
    }
    // ds rounded to k's type, this warp's 16 rows
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      store2(sDSw + g * LDP + 8 * n + 2 * t, s[n][0], s[n][1]);
      store2(sDSw + (g + 8) * LDP + 8 * n + 2 * t, s[n][2], s[n][3]);
    }
    __syncwarp();
    warp_gemm<T, NT, kBN>(dq, sDSw, LDP, 1, sK, LD, 1);  // dS.K
    cp_async_wait<0>();
    __syncthreads();  // V_{j+1} visible; every warp is done with K_j
    if (j < j_hi) {
      load_tile<T, kBN, D>(sK, k, a.k_ss, k0 + kBN, a.S);
      cp_async_commit();
    }
  }

  T* out = static_cast<T*>(a.dq);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= a.S) continue;
    T* dst = out + (((long long)b * a.S + row[r]) * a.H + h) * D;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      store2(dst + 8 * n + 2 * t, dq[n][2 * r], dq[n][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------- K4

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_dkv_kernel(const FlashArgs a) {
  constexpr int LD = Smem<T, D>::LD, LDP = Smem<T, D>::LDP, NT = D / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  T* sK = reinterpret_cast<T*>(smem);
  T* sV = sK + kBN * LD;
  T* sQ = sV + kBN * LD;
  T* sdO = sQ + kBM * LD;
  T* sP = sdO + kBM * LD;
  T* sDS = sP + kBN * LDP;
  float* sLse = reinterpret_cast<float*>(sDS + kBN * LDP);
  float* sDelta = sLse + kBM;

  const int k0 = blockIdx.x * kBN, hk = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const T* sKw = sK + warp * 16 * LD;
  const T* sVw = sV + warp * 16 * LD;
  T* sPw = sP + warp * 16 * LDP;
  T* sDSw = sDS + warp * 16 * LDP;
  const int key[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};

  float dk[NT][4], dv[NT][4];
  zero(dk);
  zero(dv);
  int i_lo, i_hi;
  query_tiles(k0, a, i_lo, i_hi);
  // steps walk the G query heads of the kv head, q tiles inner
  const int nq = i_hi - i_lo + 1, steps = G * nq;
  const T* q_b = static_cast<const T*>(a.q) + b * a.q_sb;
  const T* dout_b = static_cast<const T*>(a.dout) + b * a.o_sb;
  auto load_q = [&](int it) {  // Q tile and lse of step `it`
    const int h = hk * G + it / nq, q0 = (i_lo + it % nq) * kBM;
    load_tile<T, kBM, D>(sQ, q_b + h * a.q_sh, a.q_ss, q0, a.S);
    load_rows(sLse, a.lse_in + ((long long)b * a.H + h) * a.S, q0, a.S);
    cp_async_commit();
  };
  auto load_do = [&](int it) {  // dO tile and delta of step `it`
    const int h = hk * G + it / nq, q0 = (i_lo + it % nq) * kBM;
    load_tile<T, kBM, D>(sdO, dout_b + h * a.o_sh, a.o_ss, q0, a.S);
    load_rows(sDelta, a.delta + ((long long)b * a.H + h) * a.S, q0, a.S);
    cp_async_commit();
  };
  if (steps > 0) {
    load_tile<T, kBN, D>(sK, k, a.k_ss, k0, a.S);
    load_tile<T, kBN, D>(sV, v, a.v_ss, k0, a.S);
    load_q(0);
    load_do(0);
    cp_async_wait<1>();
    __syncthreads();  // K, V, the first Q and lse visible
  }

  // Q and dO stream through one buffer each, staggered: dO lands while
  // K.Q^T runs, the next Q while P^T.dO runs
  for (int it = 0; it < steps; ++it) {
    {
      const int q0 = (i_lo + it % nq) * kBM;
      // transposed scores: rows are this warp's keys, columns the q tile
      float st[8][4], dpt[8][4];
      zero(st);
      zero(dpt);
      warp_gemm<T, 8, D>(st, sKw, LD, 1, sQ, 1, LD);  // K.Q^T
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + 2 * t + (e & 1);
          const float x =
              visible(q0 + c, key[e >> 1], a, a.q_offset) ? st[n][e] * a.scale
                                                          : kNegInf;
          st[n][e] = expf(x - sLse[c]);
        }
        // p rounded to dO's type
        store2(sPw + g * LDP + 8 * n + 2 * t, st[n][0], st[n][1]);
        store2(sPw + (g + 8) * LDP + 8 * n + 2 * t, st[n][2], st[n][3]);
      }
      cp_async_wait<0>();
      __syncthreads();  // dO and delta visible
      warp_gemm<T, 8, D>(dpt, sVw, LD, 1, sdO, 1, LD);  // V.dO^T
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + 2 * t + (e & 1);
          dpt[n][e] = st[n][e] * (dpt[n][e] - sDelta[c]) * a.scale;
        }
        // ds rounded to q's type
        store2(sDSw + g * LDP + 8 * n + 2 * t, dpt[n][0], dpt[n][1]);
        store2(sDSw + (g + 8) * LDP + 8 * n + 2 * t, dpt[n][2], dpt[n][3]);
      }
      __syncwarp();
      warp_gemm<T, NT, kBM>(dk, sDSw, LDP, 1, sQ, LD, 1);  // dS^T.Q
    }
    __syncthreads();  // every warp is done with Q and lse
    if (it + 1 < steps) load_q(it + 1);
    warp_gemm<T, NT, kBM>(dv, sPw, LDP, 1, sdO, LD, 1);  // P^T.dO
    cp_async_wait<0>();
    __syncthreads();  // the next Q visible; every warp is done with dO
    if (it + 1 < steps) load_do(it + 1);
  }

  T* dk_out = static_cast<T*>(a.dk);
  T* dv_out = static_cast<T*>(a.dv);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= a.S) continue;
    const long long off = (((long long)b * a.S + key[r]) * a.Hkv + hk) * D;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      store2(dk_out + off + 8 * n + 2 * t, dk[n][2 * r], dk[n][2 * r + 1]);
      store2(dv_out + off + 8 * n + 2 * t, dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

// ------------------------------------------- K3 and K4, bf16: wgmma + TMA
//
// flash_dq_wgmma (K3) and flash_dkv_wgmma (K4) replace `_dq_kernel` and
// `_dkv_kernel` of the JAX package's ops/flash_attention.py (:198 and
// :256, pallas_call at :491 and :523) for bf16.  Bound: operations (3 and
// 4 causal products, 0.104 and 0.139 ms at the flagship training shape).
// Each keeps the reference's orientation, so that both products that
// consume P or dS take it as a register A operand straight from the
// accumulator of the product that made it, and neither goes through
// shared memory:
//  - K3: one block per (128-row q tile, head, batch); the q tiles run
//    heaviest first across the grid, as K2's do.  Q and dO land once;
//    K and V tiles of 64 keys stream through a 3-stage full/empty ring
//    from the diagonal down.  Per key tile each consumer warpgroup (64 q
//    rows) forms S = Q.K^T and dP = dO.V^T (m64n64, both operands
//    K-major), p and ds in f32 registers, and dQ += dS.K with dS packed
//    to bf16 A fragments and K read MN-major.  The dQ product of one tile
//    runs while the next tile's S and dP are issued.
//  - K4: one block per (128-key tile, kv head, batch); the key tiles run
//    lowest (heaviest under causality) first.  K and V land once; Q and
//    dO tiles of 64 rows stream with their lse and delta (1-D f32 maps:
//    entries past the array load as zeros, entries of the next head's
//    row meet a masked column) over the G query heads of the kv head and
//    the q tiles from the diagonal to the window's end.  Per step each
//    consumer warpgroup (64 keys) forms S^T = K.Q^T and dP^T = V.dO^T,
//    p^T and ds^T, and dV += P^T.dO and dK += dS^T.Q (dO and Q read
//    MN-major).  dK and dV sum the whole GQA group in f32 registers and
//    are written once.
// 384 threads: warpgroup 0 produces (one thread starts every TMA load),
// warpgroups 1 and 2 consume, and setmaxnreg gives the consumers 240
// registers: K4 at D = 128 holds dK and dV (64 registers each), S^T and
// dP^T (32 each) and the packed P^T and dS^T (16 each).  ptxas reports
// 168 registers (the 384-thread launch bound) and allocates the code
// after setmaxnreg.inc within 240, but only where no __trap can follow:
// with the watchdog's wait in the consumers, K4 spilled 528 B at D = 128
// and 24 B at D = 64, and K3's products were serialised.  So the
// consumers wait without the watchdog (mbar_wait_spin) and the producer,
// once every tile is loaded, waits with it for the consumers' last
// releases (mbar_drain): a lost wake-up still traps
// (chip_smoke.phase_register_probe shows both effects on a small loop).
// A warpgroup skips a streamed tile none of whose pairs is visible to its
// 64 rows, and masks only the diagonal, the window's edge and the ragged
// tail.  Exponentials are
// ex2.approx of the logits scaled by scale * log2(e) minus lse * log2(e)
// in one FFMA.  The epilogue rounds once, writes the warpgroup's rows
// into its own rows of the Q (K3) or K and V (K4) boxes, 128-byte
// swizzled, and stores them by TMA through maps whose S extent clips a
// ragged tail.  No atomics: every run is bit-reproducible.

constexpr int kBwRows = 128;       // the block's own rows: 2 x 64
constexpr int kBwStep = 64;        // rows of a streamed tile
constexpr int kBwStages = 3;       // depth of the streamed ring
constexpr int kBwThreads = 384;    // producer + two consumer warpgroups
constexpr uint32_t kOwnBox = kBwRows * 128;   // one [128][64] bf16 box
constexpr uint32_t kStepBox = kBwStep * 128;  // one [64][64] bf16 box

template <int D>
struct BwdSmem {
  static constexpr int kBoxes = D / 64;                // 64-wide boxes of D
  static constexpr uint32_t kOwn = kBoxes * kOwnBox;   // [128][D]
  static constexpr uint32_t kStep = kBoxes * kStepBox;  // [64][D]
  // the two own tiles (Q, dO in K3; K, V in K4), then the ring; a stage
  // holds two streamed tiles and, in K4, lse and delta (256 B each)
  static constexpr uint32_t kRing = 2 * kOwn;
  static constexpr uint32_t kRows = 2 * kStep;  // lse, delta in a stage
  static constexpr uint32_t kStage = 2 * kStep + 1024;
  static constexpr uint32_t kBar = kRing + kBwStages * kStage;
  // barriers: own tiles full, then per stage full and empty
  static constexpr size_t bytes = kBar + 8 * (1 + 2 * kBwStages) + 1024;
};

// d[64 x 64] = A.B^T over D, both operands K-major: sA is the
// warpgroup's 64 rows of the own [128][D] boxes, sB a streamed [64][D]
// tile.  No commit.
template <int D>
__device__ __forceinline__ void bw_start_ab(float (&d)[32], uint32_t sA,
                                            uint32_t sB) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t c = (kk & 3) * 32;
    hopper::wgmma_m64n64_ss<0, 0>(
        d, hopper::desc_sw128(sA + (kk >> 2) * kOwnBox + c, 16, 1024),
        hopper::desc_sw128(sB + (kk >> 2) * kStepBox + c, 16, 1024), kk > 0);
  }
}

// d[64 x D] += A.B over 64 rows of B: A from registers (four per 16
// rows), B a streamed [64][D] tile read MN-major.  No commit.
template <int D>
__device__ __forceinline__ void bw_start_rs(float (&d)[D / 2],
                                            const uint32_t (&x)[16],
                                            uint32_t sB) {
#pragma unroll
  for (int kk = 0; kk < kBwStep / 16; ++kk) {
    const uint64_t db = hopper::desc_sw128(sB + kk * 2048, kStepBox, 1024);
    if constexpr (D == 128)
      hopper::wgmma_m64n128_rs<1>(d, x + 4 * kk, db, 1);
    else
      hopper::wgmma_m64n64_rs<1>(d, x + 4 * kk, db, 1);
  }
}

// The f32 sums of a warpgroup's 64 rows, rounded to bf16, into its own
// rows of the [128][64] boxes at `stage` (128-byte swizzle: row r holds
// its 16-byte chunk j at chunk j ^ (r % 8), and r % 8 = g for both of
// the thread's rows).
template <int D>
__device__ __forceinline__ void bw_stage_out(const float (&d)[D / 2],
                                             uint32_t stage, int warp, int g,
                                             int t) {
  const int r = 16 * warp + g;
#pragma unroll
  for (int c = 0; c < D / 8; ++c) {
    const uint32_t at =
        stage + (c >> 3) * kOwnBox + r * 128 + (((c & 7) ^ g) << 4) + 4 * t;
    hopper::st_shared_b32(at, pack_bf16(d[4 * c], d[4 * c + 1]));
    hopper::st_shared_b32(at + 8 * 128, pack_bf16(d[4 * c + 2], d[4 * c + 3]));
  }
}

template <int D, bool OFF>
__global__ void __launch_bounds__(kBwThreads, 1)
    flash_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do,
                   const __grid_constant__ CUtensorMap tm_dq,
                   const FlashArgs a) {
  using L = BwdSmem<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // swizzled boxes start on 1024-byte boundaries
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sQ = base, sdO = base + L::kOwn, ring = base + L::kRing;
  const uint32_t own_full = base + L::kBar;
  const uint32_t full = own_full + 8, empty = full + 8 * kBwStages;

  const int nq = (a.S + kBwRows - 1) / kBwRows;
  const int q0 = (nq - 1 - (int)blockIdx.z) * kBwRows;
  const int h = blockIdx.x, b = blockIdx.y, hk = h / (a.H / a.Hkv);
  // key tiles: from the first the window can touch to the diagonal
  // (causal) or the last; walked from the top down
  const int q_off = OFF ? a.q_offset : 0;
  int j_lo, j_hi;
  key_range<kBwRows, kBwStep>(q0, a, q_off, j_lo, j_hi);
  const int n_tiles = j_hi - j_lo + 1;

  if (threadIdx.x == 0) {
    hopper::mbar_init(own_full, 1);
    for (int s = 0; s < kBwStages; ++s) {
      hopper::mbar_init(full + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, 8);  // every consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------------------------------------------- producer
    hopper::reg_dealloc<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(own_full, 2 * L::kOwn);
      for (int x = 0; x < L::kBoxes; ++x) {
        hopper::tma_load_4d(sQ + x * kOwnBox, &tm_q, own_full, 64 * x, q0, h,
                            b);
        hopper::tma_load_4d(sdO + x * kOwnBox, &tm_do, own_full, 64 * x, q0,
                            h, b);
      }
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % kBwStages, k0 = (j_hi - it) * kBwStep;
        const uint32_t st = ring + s * L::kStage, bar = full + 8 * s;
        hopper::mbar_wait(empty + 8 * s, ((it / kBwStages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(bar, 2 * L::kStep);
        for (int x = 0; x < L::kBoxes; ++x) {
          hopper::tma_load_4d(st + x * kStepBox, &tm_k, bar, 64 * x, k0, hk,
                              b);
          hopper::tma_load_4d(st + L::kStep + x * kStepBox, &tm_v, bar, 64 * x,
                              k0, hk, b);
        }
      }
      hopper::mbar_drain(empty, kBwStages, n_tiles);
    }
    return;
  }
  // ---------------------------------------------------- consumers
  hopper::reg_alloc<240>();
  const int w = wg - 1, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int r0 = q0 + 64 * w;  // this warpgroup's first row
  const int g0 = q_off + r0;  // and its global position
  const int row[2] = {r0 + 16 * warp + g, r0 + 16 * warp + g + 8};
  const uint32_t sQw = sQ + w * 64 * 128, sdOw = sdO + w * 64 * 128;
  const float scale_log2 = a.scale * kLog2e;
  float lse2[2], dlt[2];  // lse * log2(e) and delta of the two rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long i = ((long long)b * a.H + h) * a.S + row[r];
    lse2[r] = row[r] < a.S ? a.lse_in[i] * kLog2e : 0.f;
    dlt[r] = row[r] < a.S ? a.delta[i] : 0.f;
  }
  constexpr int NQ = D / 2;  // the m64nD accumulator of dQ
  float dq[NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) dq[i] = 0.f;
  uint32_t ds[16] = {};  // dS of the tile whose dQ product may run
  int held = -1;         // that tile's stage

  hopper::mbar_wait_spin(own_full, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kBwStages, k0 = (j_hi - it) * kBwStep;
    const uint32_t st = ring + s * L::kStage;
    hopper::mbar_wait_spin(full + 8 * s, (it / kBwStages) & 1);
    // no pair of this tile is visible to the warpgroup's rows
    if (r0 >= a.S || (a.causal && k0 > g0 + 63) ||
        (a.window > 0 && k0 + kBwStep - 1 <= g0 - a.window)) {
      if (lane == 0) hopper::mbar_arrive(empty + 8 * s);
      continue;
    }
    float sc[32], dp[32];
    hopper::wgmma_fence();
    bw_start_ab<D>(sc, sQw, st);            // S = Q.K^T
    bw_start_ab<D>(dp, sdOw, st + L::kStep);  // dP = dO.V^T
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();  // and the previous tile's dQ product
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);
    hopper::fence_regs(ds);
    if (held >= 0 && lane == 0) hopper::mbar_arrive(empty + 8 * held);

    const bool masked = k0 + kBwStep > a.S ||
                        (a.causal && k0 + kBwStep - 1 > g0) ||
                        (a.window > 0 && k0 <= g0 + 63 - a.window);
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = i & 1, col = k0 + 8 * (i >> 1) + 2 * t;
      float p0 = ex2_approx(fmaf(sc[2 * i], scale_log2, -lse2[r]));
      float p1 = ex2_approx(fmaf(sc[2 * i + 1], scale_log2, -lse2[r]));
      if (masked) {
        if (!visible(row[r], col, a, q_off)) p0 = 0.f;
        if (!visible(row[r], col + 1, a, q_off)) p1 = 0.f;
      }
      // ds rounded to k's type
      ds[i] = pack_bf16(p0 * (dp[2 * i] - dlt[r]) * a.scale,
                        p1 * (dp[2 * i + 1] - dlt[r]) * a.scale);
    }
    hopper::wgmma_fence();
    bw_start_rs<D>(dq, ds, st);  // dQ += dS.K
    hopper::wgmma_commit();
    held = s;
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(dq);
  hopper::fence_regs(ds);
  if (held >= 0 && lane == 0) hopper::mbar_arrive(empty + 8 * held);

  // dQ rounded once, staged in this warpgroup's rows of the Q boxes
  // (its products are done with them) and stored by TMA
  if (r0 < a.S) {
    bw_stage_out<D>(dq, sQw, warp, g, t);
    hopper::fence_proxy_async();
    hopper::named_sync(1 + w, 128);
    if (tid == 0) {
      for (int x = 0; x < L::kBoxes; ++x)
        hopper::tma_store_4d(&tm_dq, sQw + x * kOwnBox, 64 * x, r0, h, b);
      hopper::bulk_commit();
      hopper::bulk_wait_read<0>();  // the staging read before the exit
    }
  }
}

template <int D, bool OFF>
__global__ void __launch_bounds__(kBwThreads, 1)
    flash_dkv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_lse,
                    const __grid_constant__ CUtensorMap tm_delta,
                    const __grid_constant__ CUtensorMap tm_dk,
                    const __grid_constant__ CUtensorMap tm_dv,
                    const FlashArgs a) {
  using L = BwdSmem<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sK = base, sV = base + L::kOwn, ring = base + L::kRing;
  const uint32_t own_full = base + L::kBar;
  const uint32_t full = own_full + 8, empty = full + 8 * kBwStages;
  // the ring's lse and delta, as the consumers read them
  const unsigned char* ring_ptr = smem_raw + (ring - raw);

  const int k0 = blockIdx.z * kBwRows;
  const int hk = blockIdx.x, b = blockIdx.y, G = a.H / a.Hkv;
  // q tiles: from the diagonal (causal) or the first to the window's end
  // or the last; the steps walk the G query heads, q tiles inner
  const int q_off = OFF ? a.q_offset : 0;
  int i_lo, i_hi;
  query_range<kBwRows, kBwStep>(k0, a, q_off, i_lo, i_hi);
  const int nq = i_hi - i_lo + 1, steps = G * nq;

  if (threadIdx.x == 0) {
    hopper::mbar_init(own_full, 1);
    for (int s = 0; s < kBwStages; ++s) {
      hopper::mbar_init(full + 8 * s, 1);
      hopper::mbar_init(empty + 8 * s, 8);  // every consumer warp
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------------------------------------------- producer
    hopper::reg_dealloc<24>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(own_full, 2 * L::kOwn);
      for (int x = 0; x < L::kBoxes; ++x) {
        hopper::tma_load_4d(sK + x * kOwnBox, &tm_k, own_full, 64 * x, k0, hk,
                            b);
        hopper::tma_load_4d(sV + x * kOwnBox, &tm_v, own_full, 64 * x, k0, hk,
                            b);
      }
      for (int it = 0; it < steps; ++it) {
        const int s = it % kBwStages, h = hk * G + it / nq;
        const int q0 = (i_lo + it % nq) * kBwStep;
        const uint32_t st = ring + s * L::kStage, bar = full + 8 * s;
        const int row0 = (b * a.H + h) * a.S + q0;  // in [B, H, S]
        hopper::mbar_wait(empty + 8 * s, ((it / kBwStages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(bar, 2 * L::kStep + 2 * 256);
        for (int x = 0; x < L::kBoxes; ++x) {
          hopper::tma_load_4d(st + x * kStepBox, &tm_q, bar, 64 * x, q0, h, b);
          hopper::tma_load_4d(st + L::kStep + x * kStepBox, &tm_do, bar,
                              64 * x, q0, h, b);
        }
        hopper::tma_load_1d(st + L::kRows, &tm_lse, bar, row0);
        hopper::tma_load_1d(st + L::kRows + 256, &tm_delta, bar, row0);
      }
      hopper::mbar_drain(empty, kBwStages, steps);
    }
    return;
  }
  // ---------------------------------------------------- consumers
  hopper::reg_alloc<240>();
  const int w = wg - 1, tid = threadIdx.x & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int kw0 = k0 + 64 * w;  // this warpgroup's first key
  const int key[2] = {kw0 + 16 * warp + g, kw0 + 16 * warp + g + 8};
  const uint32_t sKw = sK + w * 64 * 128, sVw = sV + w * 64 * 128;
  const float scale_log2 = a.scale * kLog2e;
  constexpr int NK = D / 2;  // the m64nD accumulators of dK and dV
  float dk[NK], dv[NK];
#pragma unroll
  for (int i = 0; i < NK; ++i) dk[i] = dv[i] = 0.f;

  hopper::mbar_wait_spin(own_full, 0);
  for (int it = 0; it < steps; ++it) {
    const int s = it % kBwStages, q0 = (i_lo + it % nq) * kBwStep;
    const int gq0 = q_off + q0;  // the tile's first global row
    const uint32_t st = ring + s * L::kStage;
    hopper::mbar_wait_spin(full + 8 * s, (it / kBwStages) & 1);
    // no pair of this step is visible to the warpgroup's keys
    if (kw0 >= a.S || (a.causal && gq0 + kBwStep - 1 < kw0) ||
        (a.window > 0 && gq0 - (kw0 + 63) >= a.window)) {
      if (lane == 0) hopper::mbar_arrive(empty + 8 * s);
      continue;
    }
    float sc[32], dp[32];
    hopper::wgmma_fence();
    bw_start_ab<D>(sc, sKw, st);            // S^T = K.Q^T
    bw_start_ab<D>(dp, sVw, st + L::kStep);  // dP^T = V.dO^T
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);

    const bool masked = q0 + kBwStep > a.S || kw0 + 64 > a.S ||
                        (a.causal && gq0 < kw0 + 63) ||
                        (a.window > 0 && gq0 + kBwStep - 1 - kw0 >= a.window);
    const float* lse = reinterpret_cast<const float*>(
        ring_ptr + s * L::kStage + L::kRows);
    const float* delta = lse + 64;
    uint32_t pt[16], ds[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = i & 1, c = 8 * (i >> 1) + 2 * t;  // column in the tile
      const float2 l = *reinterpret_cast<const float2*>(lse + c);
      const float2 dl = *reinterpret_cast<const float2*>(delta + c);
      float p0 = ex2_approx(fmaf(sc[2 * i], scale_log2, -l.x * kLog2e));
      float p1 = ex2_approx(fmaf(sc[2 * i + 1], scale_log2, -l.y * kLog2e));
      if (masked) {
        if (!visible(q0 + c, key[r], a, q_off)) p0 = 0.f;
        if (!visible(q0 + c + 1, key[r], a, q_off)) p1 = 0.f;
      }
      // p rounded to dO's type, ds to q's
      pt[i] = pack_bf16(p0, p1);
      ds[i] = pack_bf16(p0 * (dp[2 * i] - dl.x) * a.scale,
                        p1 * (dp[2 * i + 1] - dl.y) * a.scale);
    }
    hopper::wgmma_fence();
    bw_start_rs<D>(dv, pt, st + L::kStep);  // dV += P^T.dO
    bw_start_rs<D>(dk, ds, st);             // dK += dS^T.Q
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(dk);
    hopper::fence_regs(dv);
    hopper::fence_regs(pt);
    hopper::fence_regs(ds);
    if (lane == 0) hopper::mbar_arrive(empty + 8 * s);
  }

  // dK and dV rounded once, staged in this warpgroup's rows of the K
  // and V boxes (its products are done with them) and stored by TMA
  if (kw0 < a.S) {
    bw_stage_out<D>(dk, sKw, warp, g, t);
    bw_stage_out<D>(dv, sVw, warp, g, t);
    hopper::fence_proxy_async();
    hopper::named_sync(1 + w, 128);
    if (tid == 0) {
      for (int x = 0; x < L::kBoxes; ++x) {
        hopper::tma_store_4d(&tm_dk, sKw + x * kOwnBox, 64 * x, kw0, hk, b);
        hopper::tma_store_4d(&tm_dv, sVw + x * kOwnBox, 64 * x, kw0, hk, b);
      }
      hopper::bulk_commit();
      hopper::bulk_wait_read<0>();  // the staging read before the exit
    }
  }
}

// ------------------------------------------------------------ launches

enum Which { kFwd, kDq, kDkv };

// Lets `kernel` take `bytes` of dynamic shared memory.
template <typename Kernel>
int set_smem(Kernel kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// A tensor map of a [B, S, H, D] operand read from its strides as (D, S,
// H, B), boxes of [rows][64]; rows at or past S load as zeros and are
// not stored.
int encode_bshd(CUtensorMap* map, const void* p, int B, int S, int H, int D,
                long long sb, long long ss, long long sh, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * sizeof(bf16),
                                 (cuuint64_t)sh * sizeof(bf16),
                                 (cuuint64_t)sb * sizeof(bf16)};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  return hopper::encode_bf16(map, p, 4, dims, strides, box);
}

template <int D>
int launch_fwd_wgmma(const FlashArgs& a, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = encode_bshd(&tq, a.q, a.B, a.S, a.H, D, a.q_sb, a.q_ss, a.q_sh,
                        kWgRows);
  if (err == 0)
    err = encode_bshd(&tk, a.k, a.B, a.S, a.Hkv, D, a.k_sb, a.k_ss, a.k_sh,
                      kWgKeys);
  if (err == 0)
    err = encode_bshd(&tv, a.v, a.B, a.S, a.Hkv, D, a.v_sb, a.v_ss, a.v_sh,
                      kWgKeys);
  if (err != 0) return err;
  constexpr size_t smem = FwdWgSmem<D>::bytes;
  int e = a.q_offset ? set_smem(flash_fwd_wgmma<D, true>, smem)
                     : set_smem(flash_fwd_wgmma<D, false>, smem);
  if (e != 0) return e;
  const dim3 grid(a.H, a.B, (a.S + kWgRows - 1) / kWgRows);
  if (a.q_offset)
    flash_fwd_wgmma<D, true><<<grid, kWgThreads, smem, stream>>>(tq, tk, tv,
                                                                  a);
  else
    flash_fwd_wgmma<D, false><<<grid, kWgThreads, smem, stream>>>(tq, tk, tv,
                                                                   a);
  return (int)cudaGetLastError();
}

// The bf16 backward maps: q, k, v and dO with the rows of their role
// (the block's own 128 or a streamed 64), dQ or dK/dV as [64][64] store
// boxes, lse and delta as 1-D f32 maps over [B, H, S].
template <int D>
int launch_dq_wgmma(const FlashArgs& a, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo, tdq;
  const long long hd = (long long)a.H * D;
  int err = encode_bshd(&tq, a.q, a.B, a.S, a.H, D, a.q_sb, a.q_ss, a.q_sh,
                        kBwRows);
  if (err == 0)
    err = encode_bshd(&tk, a.k, a.B, a.S, a.Hkv, D, a.k_sb, a.k_ss, a.k_sh,
                      kBwStep);
  if (err == 0)
    err = encode_bshd(&tv, a.v, a.B, a.S, a.Hkv, D, a.v_sb, a.v_ss, a.v_sh,
                      kBwStep);
  if (err == 0)
    err = encode_bshd(&tdo, a.dout, a.B, a.S, a.H, D, a.o_sb, a.o_ss, a.o_sh,
                      kBwRows);
  if (err == 0)
    err = encode_bshd(&tdq, a.dq, a.B, a.S, a.H, D, a.S * hd, hd, D, kBwStep);
  if (err != 0) return err;
  constexpr size_t smem = BwdSmem<D>::bytes;
  int e = a.q_offset ? set_smem(flash_dq_wgmma<D, true>, smem)
                     : set_smem(flash_dq_wgmma<D, false>, smem);
  if (e != 0) return e;
  const dim3 grid(a.H, a.B, (a.S + kBwRows - 1) / kBwRows);
  if (a.q_offset)
    flash_dq_wgmma<D, true><<<grid, kBwThreads, smem, stream>>>(
        tq, tk, tv, tdo, tdq, a);
  else
    flash_dq_wgmma<D, false><<<grid, kBwThreads, smem, stream>>>(
        tq, tk, tv, tdo, tdq, a);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv_wgmma(const FlashArgs& a, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo, tlse, tdelta, tdk, tdv;
  const long long hd = (long long)a.Hkv * D;
  const cuuint64_t rows = (cuuint64_t)a.B * a.H * a.S;
  int err = encode_bshd(&tq, a.q, a.B, a.S, a.H, D, a.q_sb, a.q_ss, a.q_sh,
                        kBwStep);
  if (err == 0)
    err = encode_bshd(&tk, a.k, a.B, a.S, a.Hkv, D, a.k_sb, a.k_ss, a.k_sh,
                      kBwRows);
  if (err == 0)
    err = encode_bshd(&tv, a.v, a.B, a.S, a.Hkv, D, a.v_sb, a.v_ss, a.v_sh,
                      kBwRows);
  if (err == 0)
    err = encode_bshd(&tdo, a.dout, a.B, a.S, a.H, D, a.o_sb, a.o_ss, a.o_sh,
                      kBwStep);
  if (err == 0) err = hopper::encode_f32_1d(&tlse, a.lse_in, rows, kBwStep);
  if (err == 0) err = hopper::encode_f32_1d(&tdelta, a.delta, rows, kBwStep);
  if (err == 0)
    err = encode_bshd(&tdk, a.dk, a.B, a.S, a.Hkv, D, a.S * hd, hd, D,
                      kBwStep);
  if (err == 0)
    err = encode_bshd(&tdv, a.dv, a.B, a.S, a.Hkv, D, a.S * hd, hd, D,
                      kBwStep);
  if (err != 0) return err;
  constexpr size_t smem = BwdSmem<D>::bytes;
  int e = a.q_offset ? set_smem(flash_dkv_wgmma<D, true>, smem)
                     : set_smem(flash_dkv_wgmma<D, false>, smem);
  if (e != 0) return e;
  const dim3 grid(a.Hkv, a.B, (a.S + kBwRows - 1) / kBwRows);
  if (a.q_offset)
    flash_dkv_wgmma<D, true><<<grid, kBwThreads, smem, stream>>>(
        tq, tk, tv, tdo, tlse, tdelta, tdk, tdv, a);
  else
    flash_dkv_wgmma<D, false><<<grid, kBwThreads, smem, stream>>>(
        tq, tk, tv, tdo, tlse, tdelta, tdk, tdv, a);
  return (int)cudaGetLastError();
}

// The mma.sync kernels, f32 only: K2, K3 and K4.
template <int D>
int launch(Which which, const FlashArgs& a, cudaStream_t stream) {
  using T = float;
  void (*kernel)(const FlashArgs);
  size_t smem;
  dim3 grid;
  if (which == kFwd) {
    kernel = flash_fwd_kernel<T, D>;
    smem = Smem<T, D>::fwd;
    grid = dim3((a.S + kBM - 1) / kBM, a.H, a.B);
  } else if (which == kDq) {
    kernel = flash_dq_kernel<T, D>;
    smem = Smem<T, D>::dq;
    grid = dim3((a.S + kBM - 1) / kBM, a.H, a.B);
  } else {
    kernel = flash_dkv_kernel<T, D>;
    smem = Smem<T, D>::dkv;
    grid = dim3((a.S + kBN - 1) / kBN, a.Hkv, a.B);
  }
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int dispatch(Which which, const FlashArgs& a, int D, int is_bf16,
             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (a.Hkv <= 0 || a.H % a.Hkv != 0) return (int)cudaErrorInvalidValue;
  if (is_bf16 && which == kFwd) {
    if (D == 64) return launch_fwd_wgmma<64>(a, s);
    if (D == 128) return launch_fwd_wgmma<128>(a, s);
  } else if (is_bf16 && which == kDq) {
    if (D == 64) return launch_dq_wgmma<64>(a, s);
    if (D == 128) return launch_dq_wgmma<128>(a, s);
  } else if (is_bf16) {
    if (D == 64) return launch_dkv_wgmma<64>(a, s);
    if (D == 128) return launch_dkv_wgmma<128>(a, s);
  } else {
    if (D == 64) return launch<64>(which, a, s);
    if (D == 128) return launch<128>(which, a, s);
  }
  return (int)cudaErrorInvalidValue;
}

FlashArgs make_args(int B, int S, int H, int Hkv, float scale, int causal,
                    int window, int q_offset) {
  FlashArgs a = {};
  a.B = B;
  a.S = S;
  a.H = H;
  a.Hkv = Hkv;
  a.scale = scale;
  a.causal = causal;
  a.window = window;
  a.q_offset = q_offset;
  return a;
}

FlashArgs bwd_args(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   long long q_sb, long long q_ss, long long q_sh,
                   long long k_sb, long long k_ss, long long k_sh,
                   long long v_sb, long long v_ss, long long v_sh,
                   long long o_sb, long long o_ss, long long o_sh, int B,
                   int S, int H, int Hkv, float scale, int causal,
                   int window, int q_offset) {
  FlashArgs a = make_args(B, S, H, Hkv, scale, causal, window, q_offset);
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse_in = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.q_sb = q_sb, a.q_ss = q_ss, a.q_sh = q_sh;
  a.k_sb = k_sb, a.k_ss = k_ss, a.k_sh = k_sh;
  a.v_sb = v_sb, a.v_ss = v_ss, a.v_sh = v_sh;
  a.o_sb = o_sb, a.o_ss = o_ss, a.o_sh = o_sh;
  return a;
}

}  // namespace

extern "C" {

// Each entry launches one kernel on `stream` and returns
// cudaGetLastError() (0 = ok).  Operands are bf16 when is_bf16 != 0,
// else f32; D is 64 or 128.  Strides are in elements, (batch, sequence,
// head) for q, k, v and dO, whose last stride is 1 and whose rows start
// 16-byte aligned.  Outputs are contiguous: out and dq [B, S, H, D], dk
// and dv [B, S, Hkv, D], lse [B, H, S] f32; lse and delta inputs are
// contiguous f32 [B, H, S].  q_offset >= 0 is the global position of
// query row 0 (keys start at 0); out is f32 when out_f32 != 0, else
// the operands' type.

int tfos_flash_fwd(const void* q, const void* k, const void* v, void* out,
                   void* lse, long long q_sb, long long q_ss, long long q_sh,
                   long long k_sb, long long k_ss, long long k_sh,
                   long long v_sb, long long v_ss, long long v_sh, int B,
                   int S, int H, int Hkv, int D, float scale, int causal,
                   int window, int q_offset, int out_f32, int is_bf16,
                   void* stream) {
  if (q_offset < 0) return (int)cudaErrorInvalidValue;
  FlashArgs a = make_args(B, S, H, Hkv, scale, causal, window, q_offset);
  a.out_f32 = out_f32;
  a.q = q;
  a.k = k;
  a.v = v;
  a.out = out;
  a.lse_out = static_cast<float*>(lse);
  a.q_sb = q_sb, a.q_ss = q_ss, a.q_sh = q_sh;
  a.k_sb = k_sb, a.k_ss = k_ss, a.k_sh = k_sh;
  a.v_sb = v_sb, a.v_ss = v_ss, a.v_sh = v_sh;
  return dispatch(kFwd, a, D, is_bf16, stream);
}

int tfos_flash_dq(const void* q, const void* k, const void* v,
                  const void* dout, const void* lse, const void* delta,
                  void* dq, long long q_sb, long long q_ss, long long q_sh,
                  long long k_sb, long long k_ss, long long k_sh,
                  long long v_sb, long long v_ss, long long v_sh,
                  long long o_sb, long long o_ss, long long o_sh, int B, int S,
                  int H, int Hkv, int D, float scale, int causal, int window,
                  int q_offset, int is_bf16, void* stream) {
  if (q_offset < 0) return (int)cudaErrorInvalidValue;
  FlashArgs a = bwd_args(q, k, v, dout, lse, delta, q_sb, q_ss, q_sh, k_sb,
                         k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, B, S,
                         H, Hkv, scale, causal, window, q_offset);
  a.dq = dq;
  return dispatch(kDq, a, D, is_bf16, stream);
}

int tfos_flash_dkv(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dk, void* dv, long long q_sb, long long q_ss,
                   long long q_sh, long long k_sb, long long k_ss,
                   long long k_sh, long long v_sb, long long v_ss,
                   long long v_sh, long long o_sb, long long o_ss,
                   long long o_sh, int B, int S, int H, int Hkv, int D,
                   float scale, int causal, int window, int q_offset,
                   int is_bf16, void* stream) {
  if (q_offset < 0) return (int)cudaErrorInvalidValue;
  FlashArgs a = bwd_args(q, k, v, dout, lse, delta, q_sb, q_ss, q_sh, k_sb,
                         k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, B, S,
                         H, Hkv, scale, causal, window, q_offset);
  a.dk = dk;
  a.dv = dv;
  return dispatch(kDkv, a, D, is_bf16, stream);
}

}  // extern "C"
