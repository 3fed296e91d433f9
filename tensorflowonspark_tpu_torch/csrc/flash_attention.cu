// Flash attention forward and backward for Hopper (sm_90a): three kernels.
//
//   K2 flash_fwd_wgmma (bf16) and flash_fwd_kernel (f32) replace
//      `_fwd_kernel` (the JAX package's ops/flash_attention.py:132,
//      pallas_call at :409): O and lse.
//   K3 flash_dq_kernel   replaces `_dq_kernel` (:198, call :491): dQ.
//   K4 flash_dkv_kernel  replaces `_dkv_kernel` (:256, call :523): dK, dV.
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
// tiles it needs itself, with the state in registers:
//  - K2 in bf16 (flash_fwd_wgmma, below): warp-specialised wgmma fed by
//    TMA; see its own note.  The rest of this list describes the
//    mma.sync kernels: K2 in f32, K3 and K4 in both types.
//  - K2 and K3: one block per (q tile of 64 rows, head, batch); the loop
//    runs over the key tiles from the first one the window can touch to
//    the diagonal (causal) or the last (non-causal).  Tiles outside are
//    skipped, not masked (the reference's _block_relevant/banding).
//  - K4: one block per (key tile of 64 rows, kv head, batch), looping
//    over the G query heads of the kv head and the q tiles from the
//    diagonal to the window's end.  dK and dV accumulate in f32 registers
//    over the whole group and are written once, cast once: the group sum
//    happens inside the kernel (the reference writes per-q-head f32
//    partials and sums them outside, :563-566).  No atomics anywhere, so
//    every run is bit-reproducible.
//  - The products run on the tensor cores for bf16: mma.sync m16n8k16
//    (bf16 in, f32 accumulate), fragments read from shared memory with
//    ldmatrix (.trans where the operand is stored k-major).  For
//    f32 the same per-thread accumulator layout is computed with FMAs
//    (no TF32), so the f32 tolerances hold.  Each of the 4 warps owns 16
//    rows of the block's 64-row tile; the Q (or K) tile and each streamed
//    K/V (or Q/dO) tile are staged in shared memory with 16-byte loads,
//    rows padded by 16 bytes against bank conflicts, and the ragged tail
//    past S is zero-filled and masked.
// Later work toward the bound: K3 and K4 on the same wgmma/TMA machinery
// (hopper.cuh); for K2, 64-key tiles, so that the next tile's Q.K^T fits
// in the registers beside a softmax (see the bf16 K2's note).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

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

// Warp-level 16x8x16 product c += A.B in the mma.sync accumulator layout:
// lane (g = lane / 4, t = lane % 4) holds c[0], c[1] at row g, columns
// 2t, 2t+1 and c[2], c[3] at row g + 8.  Element (m, k) of A is
// a[m * am + k * ak], element (k, n) of B is b[k * bk + n * bn].
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
  // A is read along k (ak == 1 at every call site): one ldmatrix.x4 of
  // the four 8x8 quarters, lane l addressing row l % 8 of quarter l / 8
  static __device__ __forceinline__ void load_a(A& f, const bf16* a, int am,
                                                int ak) {
    const int lane = threadIdx.x & 31, r = lane & 7, j = lane >> 3;
    const bf16* p = a + (r + 8 * (j & 1)) * am + 8 * (j >> 1) * ak;
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(f.r[0]), "=r"(f.r[1]), "=r"(f.r[2]), "=r"(f.r[3])
        : "r"(shared_addr(p)));
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

__device__ __forceinline__ bool visible(int qpos, int kpos,
                                        const FlashArgs& a) {
  if (qpos >= a.S || kpos >= a.S) return false;
  if (a.causal && kpos > qpos) return false;
  if (a.window > 0 && kpos <= qpos - a.window) return false;
  return true;
}

// Key tiles a q tile starting at q0 needs: from the first the window can
// touch to the diagonal (causal) or the last.
__device__ __forceinline__ void key_tiles(int q0, const FlashArgs& a, int& lo,
                                          int& hi) {
  const int q_last = min(a.S, q0 + kBM) - 1;
  hi = a.causal ? q_last / kBN : (a.S - 1) / kBN;
  lo = (a.causal && a.window > 0) ? max(0, q0 - a.window + 1) / kBN : 0;
}

// Q tiles a key tile starting at k0 needs: from the diagonal (causal) or
// the first to the window's end or the last.
__device__ __forceinline__ void query_tiles(int k0, const FlashArgs& a,
                                            int& lo, int& hi) {
  const int k_last = min(a.S, k0 + kBN) - 1;
  lo = a.causal ? k0 / kBM : 0;
  hi = (a.causal && a.window > 0) ? min(a.S - 1, k_last + a.window - 1) / kBM
                                  : (a.S - 1) / kBM;
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
  load_tile<T, kBM, D>(sQ, q, a.q_ss, q0, a.S);
  load_tile<T, kBN, D>(sK, k, a.k_ss, j_lo * kBN, a.S);
  cp_async_commit();

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
            visible(row[e >> 1], col, a) ? s[n][e] * a.scale : kNegInf;
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
// the next: ptxas allocates the consumers within the 168 registers of
// the 384-thread launch bound (setmaxnreg moves registers at run time,
// not in the allocation), and at D = 128 one tile's O, S and P fill
// them, so the next tile's Q.K^T cannot be in flight during a softmax.
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

// The online softmax of one S tile (a warpgroup's 64 rows from r0, keys
// from k0, accumulator layout), in place: masked only where some pair of
// the tile is not visible; the row max m (of the raw logits q.k) and
// sum l updated, the rescale of O in alpha, and sc = exp(scale * (S -
// m)) in f32, computed as 2^(S * scale * log2(e) - m * scale * log2(e))
// with one FFMA and one ex2 an element.
__device__ __forceinline__ void fwd_softmax(float (&sc)[64], float (&m)[2],
                                            float (&l)[2],
                                            float (&alpha)[2], int k0, int r0,
                                            const int (&row)[2], int t,
                                            float scale_log2,
                                            const FlashArgs& a) {
  const bool masked = k0 + kWgKeys > a.S ||
                      (a.causal && k0 + kWgKeys - 1 > r0) ||
                      (a.window > 0 && k0 <= r0 + 63 - a.window);
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    const int rr = (e >> 1) & 1;
    if (masked && !visible(row[rr], k0 + 8 * (e >> 2) + 2 * t + (e & 1), a))
      sc[e] = kNegInf;
    mx[rr] = fmaxf(mx[rr], sc[e]);
  }
  float sum[2] = {0.f, 0.f}, ms[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]));
    alpha[r] = ex2_approx((m[r] - m_new) * scale_log2);
    m[r] = m_new;
    ms[r] = m_new * scale_log2;
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

template <int D>
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
  const int q_last = min(a.S, q0 + kWgRows) - 1;
  const int j_hi = a.causal ? q_last / kWgKeys : (a.S - 1) / kWgKeys;
  const int j_lo =
      (a.causal && a.window > 0) ? max(0, q0 - a.window + 1) / kWgKeys : 0;
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
      fwd_softmax(sc, m, l, alpha, k0, r0, row, t, scale_log2, a);
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

    bf16* out = static_cast<bf16*>(a.out);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      if (row[r] >= a.S) continue;
      const float l_safe = fmaxf(l[r], 1e-30f), inv = 1.f / l_safe;
      bf16* dst = out + (((long long)b * a.S + row[r]) * a.H + h) * D;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) {
        store2(dst + 8 * c + 2 * t, o[4 * c + 2 * r] * inv,
               o[4 * c + 2 * r + 1] * inv);
      }
      if (t == 0) {
        a.lse_out[((long long)b * a.H + h) * a.S + row[r]] =
            m[r] * a.scale + logf(l_safe);
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
  load_tile<T, kBM, D>(sQ, q, a.q_ss, q0, a.S);
  load_tile<T, kBM, D>(sdO, dout, a.o_ss, q0, a.S);
  load_tile<T, kBN, D>(sV, v, a.v_ss, j_lo * kBN, a.S);
  cp_async_commit();
  load_tile<T, kBN, D>(sK, k, a.k_ss, j_lo * kBN, a.S);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();  // Q, dO and the first V visible

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
        const float x = visible(row[r], col, a) ? s[n][e] * a.scale : kNegInf;
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
  load_tile<T, kBN, D>(sK, k, a.k_ss, k0, a.S);
  load_tile<T, kBN, D>(sV, v, a.v_ss, k0, a.S);
  load_q(0);
  load_do(0);
  cp_async_wait<1>();
  __syncthreads();  // K, V, the first Q and lse visible

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
              visible(q0 + c, key[e >> 1], a) ? st[n][e] * a.scale : kNegInf;
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

// ------------------------------------------------------------ launches

enum Which { kFwd, kDq, kDkv };

// A tensor map of q, k or v read from its strides as (D, S, H, B), boxes
// of [128 rows][64]; rows at or past S load as zeros.
int encode_bshd(CUtensorMap* map, const void* p, int B, int S, int H, int D,
                long long sb, long long ss, long long sh) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * sizeof(bf16),
                                 (cuuint64_t)sh * sizeof(bf16),
                                 (cuuint64_t)sb * sizeof(bf16)};
  const cuuint32_t box[4] = {64, kWgRows, 1, 1};
  return hopper::encode_bf16(map, p, 4, dims, strides, box);
}

template <int D>
int launch_fwd_wgmma(const FlashArgs& a, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  int err = encode_bshd(&tq, a.q, a.B, a.S, a.H, D, a.q_sb, a.q_ss, a.q_sh);
  if (err == 0)
    err = encode_bshd(&tk, a.k, a.B, a.S, a.Hkv, D, a.k_sb, a.k_ss, a.k_sh);
  if (err == 0)
    err = encode_bshd(&tv, a.v, a.B, a.S, a.Hkv, D, a.v_sb, a.v_ss, a.v_sh);
  if (err != 0) return err;
  constexpr size_t smem = FwdWgSmem<D>::bytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_wgmma<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.H, a.B, (a.S + kWgRows - 1) / kWgRows);
  flash_fwd_wgmma<D><<<grid, kWgThreads, smem, stream>>>(tq, tk, tv, a);
  return (int)cudaGetLastError();
}

// The mma.sync kernels: K2 in f32 (bf16 K2 is flash_fwd_wgmma), K3 and K4.
template <typename T, int D>
int launch(Which which, const FlashArgs& a, cudaStream_t stream) {
  void (*kernel)(const FlashArgs);
  size_t smem;
  dim3 grid;
  if (which == kFwd) {
    if constexpr (std::is_same<T, bf16>::value) {
      return (int)cudaErrorInvalidValue;
    } else {
      kernel = flash_fwd_kernel<T, D>;
    }
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
  } else if (is_bf16) {
    if (D == 64) return launch<bf16, 64>(which, a, s);
    if (D == 128) return launch<bf16, 128>(which, a, s);
  } else {
    if (D == 64) return launch<float, 64>(which, a, s);
    if (D == 128) return launch<float, 128>(which, a, s);
  }
  return (int)cudaErrorInvalidValue;
}

FlashArgs make_args(int B, int S, int H, int Hkv, float scale, int causal,
                    int window) {
  FlashArgs a = {};
  a.B = B;
  a.S = S;
  a.H = H;
  a.Hkv = Hkv;
  a.scale = scale;
  a.causal = causal;
  a.window = window;
  return a;
}

FlashArgs bwd_args(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   long long q_sb, long long q_ss, long long q_sh,
                   long long k_sb, long long k_ss, long long k_sh,
                   long long v_sb, long long v_ss, long long v_sh,
                   long long o_sb, long long o_ss, long long o_sh, int B,
                   int S, int H, int Hkv, float scale, int causal,
                   int window) {
  FlashArgs a = make_args(B, S, H, Hkv, scale, causal, window);
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
// contiguous f32 [B, H, S].

int tfos_flash_fwd(const void* q, const void* k, const void* v, void* out,
                   void* lse, long long q_sb, long long q_ss, long long q_sh,
                   long long k_sb, long long k_ss, long long k_sh,
                   long long v_sb, long long v_ss, long long v_sh, int B,
                   int S, int H, int Hkv, int D, float scale, int causal,
                   int window, int is_bf16, void* stream) {
  FlashArgs a = make_args(B, S, H, Hkv, scale, causal, window);
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
                  int is_bf16, void* stream) {
  FlashArgs a = bwd_args(q, k, v, dout, lse, delta, q_sb, q_ss, q_sh, k_sb,
                         k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, B, S,
                         H, Hkv, scale, causal, window);
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
                   float scale, int causal, int window, int is_bf16,
                   void* stream) {
  FlashArgs a = bwd_args(q, k, v, dout, lse, delta, q_sb, q_ss, q_sh, k_sb,
                         k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, B, S,
                         H, Hkv, scale, causal, window);
  a.dk = dk;
  a.dv = dv;
  return dispatch(kDkv, a, D, is_bf16, stream);
}

}  // extern "C"
