// Paged single-token decode attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `_paged_kernel` in
// the JAX package's ops/paged_attention.py (entry point
// `paged_attention`, pallas_call at :296).  It computes, for each slot b
// and query head h,
//
//   out[b, h, :] = softmax_j(scale * q[b,h].K[b,j,h/G] (* ks)) . (V (* vs))
//
// over positions j in [max(0, len_b - window), len_b) (or [0, len_b)
// when window == 0), where position j of slot b lives at
// pool[table[b, j / T], j % T] and G = H / Hkv query heads share one kv
// head.  int8 pools take f32 scale pools [P, T, Hkv, 1] that multiply
// the logits (K) and the probabilities (V), the factored identities of
// dot_attention.  Softmax and accumulation are f32 with a finite -1e30
// mask; the output has q's type.
//
// Bound: memory.  The kernel must read every live page of every kv
// head once: sum_b ceil(len_b / T) * T * Hkv * D * 2 * itemsize bytes
// (plus the scale pages, q and the output); its arithmetic is
// 4 * B * H * len * D f32 operations, far below the card's rate for
// those bytes.  The bound is those bytes / 3.35 TB/s (H100 SXM).
//
// Design (first, simple, correct): one thread block per (slot, kv
// head).  The TPU grid walks (slot, page) sequentially carrying the
// online-softmax state in VMEM scratch; here a loop inside the block
// walks the slot's pages instead, the block reads its own block-table
// entries (no scalar prefetch), and the running max, normaliser and
// [G, D] f32 accumulator live in shared memory.  The loop starts at the
// first page the window can touch, so pages behind the horizon are
// skipped rather than masked.  Each [T, D] K and V tile is staged once
// in shared memory and shared by all G query heads of the kv head, so
// every live page is read from device memory once per kv head.
//
// Later work to approach the bound: split the page loop over several
// blocks ("flash-decoding") so more than B * Hkv blocks fill the 132
// SMs (the flagship decode has 8 * 8 = 64), double-buffer the page
// tiles with cp.async or TMA, and load 16 bytes per thread.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}

// The TPU kernel rounds the probabilities to the value type before the
// P.V product (p.astype(v.dtype), v converted to q's type); so does this.
template <typename T>
__device__ __forceinline__ float round_as(float x) { return x; }
template <>
__device__ __forceinline__ float round_as<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Shared memory, in floats: q and acc [G, D], K and V tiles [T, D],
// probabilities [G, T], K and V scales [T], running max, normaliser and
// rescale factor [G].
__host__ __device__ inline size_t smem_floats(int G, int D, int T) {
  return 2 * (size_t)G * D + 2 * (size_t)T * D + (size_t)G * T + 2 * (size_t)T +
         3 * (size_t)G;
}

template <typename QT, typename KT, bool SCALES>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const QT* __restrict__ q, const KT* __restrict__ k_pool,
    const KT* __restrict__ v_pool, const float* __restrict__ k_scale,
    const float* __restrict__ v_scale, const int* __restrict__ tables,
    const int* __restrict__ lengths, QT* __restrict__ out, int H, int Hkv,
    int D, int P, int T, int NB, float scale, int window) {
  extern __shared__ float smem[];
  const int G = H / Hkv;
  const int b = blockIdx.x;
  const int hk = blockIdx.y;
  float* s_q = smem;
  float* s_acc = s_q + G * D;
  float* s_k = s_acc + G * D;
  float* s_v = s_k + T * D;
  float* s_p = s_v + T * D;
  float* s_ks = s_p + G * T;
  float* s_vs = s_ks + T;
  float* s_m = s_vs + T;
  float* s_l = s_m + G;
  float* s_alpha = s_l + G;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = kThreads >> 5;
  // the G query heads of kv head hk are contiguous: q[b, hk*G:(hk+1)*G, :]
  const size_t q_off = ((size_t)b * H + (size_t)hk * G) * D;

  for (int i = tid; i < G * D; i += kThreads) {
    s_q[i] = to_f32(q[q_off + i]);
    s_acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    s_m[g] = kNegInf;
    s_l[g] = 0.f;
  }

  const int len = lengths[b];
  int n_pages = (len + T - 1) / T;
  if (n_pages > NB) n_pages = NB;
  int first = 0;
  if (window > 0 && len - window > 0) {
    // first page with base + T > len - window
    first = (len - window) / T;
  }

  for (int j = first; j < n_pages; ++j) {
    __syncthreads();  // the previous page's readers are done with the tiles
    int page = tables[(size_t)b * NB + j];
    page = min(max(page, 0), P - 1);
    // row (page, t, hk) of the [P, T, Hkv, D] pool starts at
    // ((page * T + t) * Hkv + hk) * D
    const size_t row0 = (size_t)page * T * Hkv + hk;
    for (int i = tid; i < T * D; i += kThreads) {
      const int t = i / D;
      const int d = i - t * D;
      const size_t off = (row0 + (size_t)t * Hkv) * D + d;
      s_k[i] = to_f32(k_pool[off]);
      s_v[i] = to_f32(v_pool[off]);
    }
    if (SCALES) {
      for (int t = tid; t < T; t += kThreads) {
        s_ks[t] = k_scale[row0 + (size_t)t * Hkv];
        s_vs[t] = v_scale[row0 + (size_t)t * Hkv];
      }
    }
    __syncthreads();

    // logits: one warp per (query head, position) pair, lanes split D
    const int base = j * T;
    for (int pair = warp; pair < G * T; pair += nwarps) {
      const int g = pair / T;
      const int t = pair - g * T;
      float dot = 0.f;
      for (int d = lane; d < D; d += 32) dot += s_q[g * D + d] * s_k[t * D + d];
      for (int o = 16; o > 0; o >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, o);
      if (lane == 0) {
        const int pos = base + t;
        const bool keep = pos < len && (window <= 0 || pos >= len - window);
        float logit = dot;
        if (SCALES) logit *= s_ks[t];
        logit *= scale;
        s_p[pair] = keep ? logit : kNegInf;
      }
    }
    __syncthreads();

    // online softmax state, one thread per query head
    for (int g = tid; g < G; g += kThreads) {
      const float m_prev = s_m[g];
      float m_cur = kNegInf;
      for (int t = 0; t < T; ++t) m_cur = fmaxf(m_cur, s_p[g * T + t]);
      const float m_new = fmaxf(m_prev, m_cur);
      const float alpha = expf(m_prev - m_new);
      float sum = 0.f;
      for (int t = 0; t < T; ++t) {
        float p = expf(s_p[g * T + t] - m_new);
        sum += p;
        if (SCALES) p *= s_vs[t];
        s_p[g * T + t] = round_as<QT>(p);
      }
      s_l[g] = alpha * s_l[g] + sum;
      s_m[g] = m_new;
      s_alpha[g] = alpha;
    }
    __syncthreads();

    // acc[g, d] = acc[g, d] * alpha[g] + sum_t p[g, t] * V[t, d]
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D;
      const int d = i - g * D;
      const float* pg = s_p + g * T;
      float acc = s_acc[i] * s_alpha[g];
      for (int t = 0; t < T; ++t) acc += pg[t] * s_v[t * D + d];
      s_acc[i] = acc;
    }
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kThreads) {
    store_out(&out[q_off + i], s_acc[i] / s_l[i / D]);
  }
}

template <typename QT, typename KT, bool SCALES>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* k_scale, const void* v_scale, const void* tables,
           const void* lengths, void* out, int B, int H, int Hkv, int D, int P,
           int T, int NB, float scale, int window, cudaStream_t stream) {
  const size_t smem = smem_floats(H / Hkv, D, T) * sizeof(float);
  auto kernel = paged_decode_kernel<QT, KT, SCALES>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(B, Hkv);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k_pool),
      static_cast<const KT*>(v_pool), static_cast<const float*>(k_scale),
      static_cast<const float*>(v_scale), static_cast<const int*>(tables),
      static_cast<const int*>(lengths), static_cast<QT*>(out), H, Hkv, D, P,
      T, NB, scale, window);
  return (int)cudaGetLastError();
}

template <typename QT>
int launch_q(const void* q, const void* k_pool, const void* v_pool,
             const void* k_scale, const void* v_scale, const void* tables,
             const void* lengths, void* out, int B, int H, int Hkv, int D,
             int P, int T, int NB, float scale, int window, int kv_int8,
             cudaStream_t stream) {
  const bool scales = k_scale != nullptr;
  if (kv_int8) {
    return scales ? launch<QT, int8_t, true>(q, k_pool, v_pool, k_scale,
                                             v_scale, tables, lengths, out, B,
                                             H, Hkv, D, P, T, NB, scale,
                                             window, stream)
                  : launch<QT, int8_t, false>(q, k_pool, v_pool, k_scale,
                                              v_scale, tables, lengths, out, B,
                                              H, Hkv, D, P, T, NB, scale,
                                              window, stream);
  }
  return scales ? launch<QT, QT, true>(q, k_pool, v_pool, k_scale, v_scale,
                                       tables, lengths, out, B, H, Hkv, D, P,
                                       T, NB, scale, window, stream)
                : launch<QT, QT, false>(q, k_pool, v_pool, k_scale, v_scale,
                                        tables, lengths, out, B, H, Hkv, D, P,
                                        T, NB, scale, window, stream);
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = ok).
// q and out are [B, H, D] (f32 when q_bf16 == 0, bf16 otherwise); the
// pools are [P, T, Hkv, D] of q's type, or int8 when kv_int8 != 0; the
// scale pools are f32 [P, T, Hkv, 1] or both null; tables are int32
// [B, NB] and lengths int32 [B].  Every array is contiguous.
int tfos_paged_attention(const void* q, const void* k_pool,
                         const void* v_pool, const void* k_scale,
                         const void* v_scale, const void* tables,
                         const void* lengths, void* out, int B, int H, int Hkv,
                         int D, int P, int T, int NB, float scale, int window,
                         int q_bf16, int kv_int8, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16) {
    return launch_q<__nv_bfloat16>(q, k_pool, v_pool, k_scale, v_scale,
                                   tables, lengths, out, B, H, Hkv, D, P, T,
                                   NB, scale, window, kv_int8, s);
  }
  return launch_q<float>(q, k_pool, v_pool, k_scale, v_scale, tables, lengths,
                         out, B, H, Hkv, D, P, T, NB, scale, window, kv_int8,
                         s);
}

}  // extern "C"
