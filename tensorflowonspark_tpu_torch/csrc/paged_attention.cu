// Paged single-token decode attention for Hopper (sm_90a), split over the
// pages of each slot ("flash-decoding").
//
// Replaces the TPU kernel `_paged_kernel` in
// the JAX package's ops/paged_attention.py (:143; entry point
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
// mask; p (times the v scale) is rounded to the value type (q's type)
// before P.V, as the reference's p3.astype(v.dtype); the output has q's
// type.
//
// Bound: memory.  The kernel must read every live page of every kv
// head once: sum_b ceil(len_b / T) * T * Hkv * D * 2 * itemsize bytes
// (plus the scale pages, q, the output, tables and lengths; the count of
// chip_smoke.bytes_and_flops); its arithmetic is 4 * B * H * len * D f32
// operations, far below the card's rate for those bytes.  The bound is
// those bytes / 3.35 TB/s (H100 SXM).
//
// Design.
// - Grid (split, kv head, slot).  The host picks the split count from B,
//   Hkv, NB and the SM count (ops/paged_attention.num_splits: at least 4
//   blocks per SM and at most 8 pages a split over a full table, so that
//   blocks of a few pages balance ragged lengths; at most NB, and at
//   most the pages a window can touch); it never reads the lengths.
//   Each block computes its slot's live page range [first, ceil(len/T))
//   (first = the window's first page) and takes the contiguous share
//   [first + s*live/S, first + (s+1)*live/S); a share may be empty.
// - Pipelined loads.  A ring of up to 4 page stages of K and V (and
//   their scale rows) in shared memory, in the stored type, filled by
//   cp.async of 16 bytes a thread (8 or 4 where a head-dim row's bytes
//   or the pools' alignment do not allow 16; element copies where not
//   even 4) with commit/wait groups, stages-1 pages ahead of the page
//   being read.  A page's block-table entry is read one load ahead; the
//   page index is clamped into [0, P).
// - Math in registers.  Each warp owns rows (tokens) of the page, four
//   at a time; each lane owns EPL consecutive elements of D.  q of the
//   block's heads sits in registers (f32); logits are lane dot products
//   reduced with shuffles; every warp runs its own online softmax (m, l
//   and an [heads, EPL] f32 accumulator per lane), so a page costs two
//   __syncthreads and no shared-memory traffic for the math.  The warps'
//   states merge once, in warp order, into shared memory at the end.
//   Up to 8 query heads ride in registers at once; a GQA group larger
//   than that is taken in chunks of 8 heads, the pages streamed again
//   for each chunk.
// - Combine.  A block writes its split's (m, l, acc) to an f32
//   workspace; a second kernel of the same call forms
//   out = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s in a fixed
//   order (no atomics: repeats are bit-identical).  With one split the
//   first kernel writes out directly.  An empty share writes m = -1e30,
//   l = 0 and a zero accumulator, which weigh 0 in the combine.
//
// Shared memory (mirrored by ops/paged_attention._kernel_geometry): the
// ring, stages * round128(2 * T * row + 8 * T) bytes with row = D *
// itemsize rounded up to max(16, EPL * itemsize), then q and the merged
// accumulator [G, D] f32 and m, l [G] f32.
//
// Later work: TMA for the page tiles (its maps are bf16-only today) and
// clusters whose blocks share a slot's pages across its kv heads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowGroup = 4;      // rows a warp scores together
constexpr int kMaxStages = 4;
constexpr int kRingBudget = 64 * 1024;
constexpr int kMaxSmem = 232448;  // a block's shared memory on Hopper
constexpr int kMaxSplits = 256;

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

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// N elements of a shared-memory row, widened to f32, in one or two
// vector loads (p is aligned to N elements).
template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* p, float (&out)[N]) {
  const Vec<T, N> x = *reinterpret_cast<const Vec<T, N>*>(p);
#pragma unroll
  for (int i = 0; i < N; ++i) out[i] = to_f32(x.v[i]);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(BYTES)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Wait until at most `pending` of this thread's cp.async groups are in
// flight (pending < kMaxStages <= 8).
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  switch (pending) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* ks;  // null without scale pools
  const float* vs;
  const int* tables;
  const int* lengths;
  void* out;
  float* ws_acc;  // [B, H, splits, D] when splits > 1
  float* ws_ml;   // [B, H, splits, 2]: m, l
  int B, H, Hkv, D, P, T, NB, window, splits;
  int stages, row_bytes, stage_bytes, vec;
  float scale;
};

// Copy the K and V rows (and scale rows) of kv head hk of `page` into a
// ring stage: T rows of D elements, each row `row_bytes` apart.
template <typename KT>
__device__ __forceinline__ void load_page(const Args& a, int hk, int page,
                                          unsigned char* stage) {
  const int tid = threadIdx.x;
  const size_t row0 = (size_t)page * a.T * a.Hkv + hk;  // row (page, 0, hk)
  const size_t hstride = (size_t)a.Hkv * a.D;           // elements per token
  const KT* kp = static_cast<const KT*>(a.k) + row0 * a.D;
  const KT* vp = static_cast<const KT*>(a.v) + row0 * a.D;
  unsigned char* ks = stage;
  unsigned char* vs = stage + (size_t)a.T * a.row_bytes;
  const int data_bytes = a.D * (int)sizeof(KT);
  if (a.vec > 0) {
    const int per_row = data_bytes / a.vec;
    const int n = a.T * per_row;
    for (int i = tid; i < n; i += kThreads) {
      const int r = i / per_row;
      const int off = (i - r * per_row) * a.vec;
      const unsigned char* ksrc =
          reinterpret_cast<const unsigned char*>(kp + r * hstride) + off;
      const unsigned char* vsrc =
          reinterpret_cast<const unsigned char*>(vp + r * hstride) + off;
      unsigned char* kd = ks + r * a.row_bytes + off;
      unsigned char* vd = vs + r * a.row_bytes + off;
      if (a.vec == 16) {
        cp_async<16>(kd, ksrc);
        cp_async<16>(vd, vsrc);
      } else if (a.vec == 8) {
        cp_async<8>(kd, ksrc);
        cp_async<8>(vd, vsrc);
      } else {
        cp_async<4>(kd, ksrc);
        cp_async<4>(vd, vsrc);
      }
    }
  } else {
    // rows whose bytes are not a multiple of 4: element copies
    const int n = a.T * a.D;
    for (int i = tid; i < n; i += kThreads) {
      const int r = i / a.D;
      const int d = i - r * a.D;
      reinterpret_cast<KT*>(ks + r * a.row_bytes)[d] = kp[r * hstride + d];
      reinterpret_cast<KT*>(vs + r * a.row_bytes)[d] = vp[r * hstride + d];
    }
  }
  if (a.ks != nullptr) {
    float* kscale = reinterpret_cast<float*>(vs + (size_t)a.T * a.row_bytes);
    float* vscale = kscale + a.T;
    for (int r = tid; r < a.T; r += kThreads) {
      cp_async<4>(kscale + r, a.ks + row0 + (size_t)r * a.Hkv);
      cp_async<4>(vscale + r, a.vs + row0 + (size_t)r * a.Hkv);
    }
  }
}

// One block: slot blockIdx.z, kv head blockIdx.y, split blockIdx.x.
// EPL: elements of D per lane (D <= 32 * EPL); HB: query heads held in
// registers at once (at least min(G, 8)).
template <typename QT, typename KT, int EPL, int HB>
__global__ void __launch_bounds__(kThreads)
    paged_decode_split(const Args a) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int split = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int G = a.H / a.Hkv;
  const int nh = min(G, HB);
  const int chunks = (G + nh - 1) / nh;
  const int D = a.D;
  const int T = a.T;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool scales = a.ks != nullptr;

  // this split's share of the slot's live pages
  const int len = a.lengths[b];
  const int n_pages = max(min((len + T - 1) / T, a.NB), 0);
  const int first =
      (a.window > 0 && len - a.window > 0) ? (len - a.window) / T : 0;
  const int live = max(n_pages - first, 0);
  const int lo = first + (int)((long long)split * live / a.splits);
  const int hi = first + (int)((long long)(split + 1) * live / a.splits);
  const int np = hi - lo;
  const int units = np * chunks;  // (head chunk, page) pairs

  unsigned char* ring = smem;
  float* s_q = reinterpret_cast<float*>(smem + (size_t)a.stages * a.stage_bytes);
  float* s_acc = s_q + G * D;
  float* s_m = s_acc + G * D;
  float* s_l = s_m + G;

  const size_t q_off = ((size_t)b * a.H + (size_t)hk * G) * D;
  const QT* q = static_cast<const QT*>(a.q);
  for (int i = tid; i < G * D; i += kThreads) {
    s_q[i] = to_f32(q[q_off + i]);
    s_acc[i] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    s_m[g] = kNegInf;
    s_l[g] = 0.f;
  }
  // zero the pad of every row: lanes read whole vectors of EPL elements
  const int data_bytes = D * (int)sizeof(KT);
  const int pad = a.row_bytes - data_bytes;
  if (pad > 0) {
    const int n = a.stages * 2 * T * pad;
    for (int i = tid; i < n; i += kThreads) {
      const int row = i / pad;  // over stages x {K, V} x T
      const int st = row / (2 * T);
      const int rr = row - st * 2 * T;
      ring[(size_t)st * a.stage_bytes + (size_t)rr * a.row_bytes + data_bytes +
           (i - row * pad)] = 0;
    }
  }

  const int* table = a.tables + (size_t)b * a.NB;
  auto page_of = [&](int x) {  // unit x -> its clamped page index
    const int j = lo + x % np;
    return min(max(table[j], 0), a.P - 1);
  };
  int next_load = 0;
  int next_page = units > 0 ? page_of(0) : 0;
  auto issue = [&]() {
    if (next_load < units) {
      load_page<KT>(a, hk, next_page,
                    ring + (size_t)(next_load % a.stages) * a.stage_bytes);
      ++next_load;
      if (next_load < units) next_page = page_of(next_load);
    }
    cp_async_commit();
  };
  for (int s = 0; s < a.stages - 1; ++s) issue();

  const bool lane_on = lane * EPL < D;
  float qr[HB][EPL];
  float acc[HB][EPL];
  float m[HB];
  float l[HB];
  __syncthreads();  // s_q, s_acc, s_m, s_l and the pads are written

  for (int u = 0; u < units; ++u) {
    const int c = u / np;
    const int j = lo + (u - c * np);
    if (u == c * np) {  // first page of head chunk c
#pragma unroll
      for (int h = 0; h < HB; ++h) {
        const int gh = c * nh + h;
        m[h] = kNegInf;
        l[h] = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          const int d = lane * EPL + e;
          qr[h][e] = (h < nh && gh < G && d < D) ? s_q[gh * D + d] : 0.f;
          acc[h][e] = 0.f;
        }
      }
    }
    issue();
    cp_async_wait_pending(a.stages - 1);
    __syncthreads();  // page u is in stage u % stages for every thread

    const unsigned char* stage = ring + (size_t)(u % a.stages) * a.stage_bytes;
    const KT* ks = reinterpret_cast<const KT*>(stage);
    const KT* vs = reinterpret_cast<const KT*>(stage + (size_t)T * a.row_bytes);
    const float* kscale =
        reinterpret_cast<const float*>(stage + (size_t)2 * T * a.row_bytes);
    const float* vscale = kscale + T;
    const int row_elems = a.row_bytes / (int)sizeof(KT);
    const int base = j * T;

    for (int r0 = warp * kRowGroup; r0 < T; r0 += kWarps * kRowGroup) {
      float s[kRowGroup][HB];
      bool keep[kRowGroup];
#pragma unroll
      for (int i = 0; i < kRowGroup; ++i) {
        const int r = r0 + i;
        const int pos = base + r;
        keep[i] = r < T && pos < len && (a.window <= 0 || pos >= len - a.window);
        float kv[EPL];
        if (keep[i] && lane_on) {
          load_vec<KT, EPL>(ks + r * row_elems + lane * EPL, kv);
        } else {
#pragma unroll
          for (int e = 0; e < EPL; ++e) kv[e] = 0.f;
        }
#pragma unroll
        for (int h = 0; h < HB; ++h) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) dot += qr[h][e] * kv[e];
          s[i][h] = dot;
        }
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
        for (int i = 0; i < kRowGroup; ++i) {
#pragma unroll
          for (int h = 0; h < HB; ++h) {
            s[i][h] += __shfl_xor_sync(0xffffffffu, s[i][h], o);
          }
        }
      }
      // every lane holds the same logits now
#pragma unroll
      for (int i = 0; i < kRowGroup; ++i) {
        const float ksc = (scales && keep[i]) ? kscale[r0 + i] : 1.f;
#pragma unroll
        for (int h = 0; h < HB; ++h) {
          float logit = s[i][h];
          if (scales) logit *= ksc;
          logit *= a.scale;
          s[i][h] = keep[i] ? logit : kNegInf;
        }
      }
#pragma unroll
      for (int h = 0; h < HB; ++h) {
        float m_new = m[h];
#pragma unroll
        for (int i = 0; i < kRowGroup; ++i) m_new = fmaxf(m_new, s[i][h]);
        const float alpha = expf(m[h] - m_new);
        m[h] = m_new;
        l[h] *= alpha;
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[h][e] *= alpha;
      }
#pragma unroll
      for (int i = 0; i < kRowGroup; ++i) {
        if (!keep[i]) continue;
        const int r = r0 + i;
        float vv[EPL];
        if (lane_on) {
          load_vec<KT, EPL>(vs + r * row_elems + lane * EPL, vv);
        } else {
#pragma unroll
          for (int e = 0; e < EPL; ++e) vv[e] = 0.f;
        }
        const float vsc = scales ? vscale[r] : 1.f;
#pragma unroll
        for (int h = 0; h < HB; ++h) {
          const float p = expf(s[i][h] - m[h]);
          l[h] += p;
          float pv = p;
          if (scales) pv *= vsc;
          pv = round_as<QT>(pv);
#pragma unroll
          for (int e = 0; e < EPL; ++e) acc[h][e] += pv * vv[e];
        }
      }
    }
    __syncthreads();  // stage u % stages may be refilled

    if (u - c * np == np - 1) {
      // last page of head chunk c: merge the warps' states, in warp order
      for (int w = 0; w < kWarps; ++w) {
        if (warp == w) {
#pragma unroll
          for (int h = 0; h < HB; ++h) {
            const int gh = c * nh + h;
            if (h < nh && gh < G) {
              const float M = s_m[gh];
              const float Mn = fmaxf(M, m[h]);
              const float a0 = expf(M - Mn);
              const float a1 = expf(m[h] - Mn);
#pragma unroll
              for (int e = 0; e < EPL; ++e) {
                const int d = lane * EPL + e;
                if (d < D) s_acc[gh * D + d] = s_acc[gh * D + d] * a0 + acc[h][e] * a1;
              }
              __syncwarp();
              if (lane == 0) {
                s_l[gh] = s_l[gh] * a0 + l[h] * a1;
                s_m[gh] = Mn;
              }
            }
          }
        }
        __syncthreads();
      }
    }
  }
  cp_async_wait<0>();  // no copy may outlive the block (none is pending)

  const int h0 = hk * G;
  if (a.splits == 1) {
    QT* out = static_cast<QT*>(a.out);
    for (int i = tid; i < G * D; i += kThreads) {
      store_out(&out[q_off + i], s_acc[i] / s_l[i / D]);
    }
  } else {
    for (int i = tid; i < G * D; i += kThreads) {
      const int g = i / D;
      const int d = i - g * D;
      a.ws_acc[(((size_t)b * a.H + h0 + g) * a.splits + split) * D + d] = s_acc[i];
    }
    for (int g = tid; g < G; g += kThreads) {
      float* ml = a.ws_ml + (((size_t)b * a.H + h0 + g) * a.splits + split) * 2;
      ml[0] = s_m[g];
      ml[1] = s_l[g];
    }
  }
}

// One block per (slot, query head): the splits' partial states, weighed
// by e^(m_s - M), summed.  Warp w sums splits w, w + 8, ... (lanes over
// D, four elements each); the warps' sums are added in warp order.
constexpr int kCombineThreads = 256;
constexpr int kCombineWarps = kCombineThreads / 32;

template <typename QT>
__global__ void __launch_bounds__(kCombineThreads)
    paged_combine(const Args a) {
  __shared__ float s_w[kMaxSplits];
  __shared__ float s_red[kCombineWarps];
  __shared__ float s_part[kCombineWarps][256];
  const int bh = blockIdx.x;
  const int S = a.splits;
  const int D = a.D;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* ml = a.ws_ml + (size_t)bh * S * 2;
  // M = max_s m_s
  float M = kNegInf;
  for (int s = tid; s < S; s += kCombineThreads) M = fmaxf(M, ml[2 * s]);
  for (int o = 16; o > 0; o >>= 1) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
  if (lane == 0) s_red[warp] = M;
  __syncthreads();
  M = s_red[0];
  for (int w = 1; w < kCombineWarps; ++w) M = fmaxf(M, s_red[w]);
  for (int s = tid; s < S; s += kCombineThreads) s_w[s] = expf(ml[2 * s] - M);
  __syncthreads();
  float L = 0.f;
  for (int s = 0; s < S; ++s) L += s_w[s] * ml[2 * s + 1];
  const float* acc = a.ws_acc + (size_t)bh * S * D;
  for (int d0 = 0; d0 < D; d0 += 128) {
    float part[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s = warp; s < S; s += kCombineWarps) {
      const float w = s_w[s];
      const float* row = acc + (size_t)s * D + d0;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int d = lane * 4 + e;
        if (d0 + d < D) part[e] += w * row[d];
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) s_part[warp][lane * 4 + e] = part[e];
    __syncthreads();
    QT* out = static_cast<QT*>(a.out) + (size_t)bh * D + d0;
    for (int d = tid; d < 128 && d0 + d < D; d += kCombineThreads) {
      float A = 0.f;
      for (int w = 0; w < kCombineWarps; ++w) A += s_part[w][d];
      store_out(&out[d], A / L);
    }
    __syncthreads();
  }
}

__host__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Ring and shared-memory geometry; returns the block's shared memory in
// bytes (0 when one stage does not fit).
inline int geometry(int G, int D, int T, int itemsize, int* row_bytes,
                    int* stage_bytes, int* stages) {
  const int epl = D <= 128 ? 4 : 8;
  const int align = 16 > epl * itemsize ? 16 : epl * itemsize;
  *row_bytes = round_up(D * itemsize, align);
  *stage_bytes = round_up(2 * T * *row_bytes + 8 * T, 128);
  const int fixed = 8 * G * D + 8 * G;
  int n = kRingBudget / *stage_bytes;
  const int room = (kMaxSmem - fixed) / *stage_bytes;
  if (n > room) n = room;
  if (n > kMaxStages) n = kMaxStages;
  if (n < 1) n = 1;
  *stages = n;
  const int smem = n * *stage_bytes + fixed;
  return smem <= kMaxSmem ? smem : 0;
}

template <typename QT, typename KT, int EPL, int HB>
int launch(const Args& a, int smem, cudaStream_t stream) {
  auto kernel = paged_decode_split<QT, KT, EPL, HB>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(a.splits, a.Hkv, a.B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return (int)err;
  paged_combine<QT><<<a.B * a.H, kCombineThreads, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename QT, typename KT>
int launch_shape(const Args& a, int smem, cudaStream_t stream) {
  const int G = a.H / a.Hkv;
  if (a.D <= 128) {
    if (G == 1) return launch<QT, KT, 4, 1>(a, smem, stream);
    if (G <= 4) return launch<QT, KT, 4, 4>(a, smem, stream);
    return launch<QT, KT, 4, 8>(a, smem, stream);
  }
  if (G == 1) return launch<QT, KT, 8, 1>(a, smem, stream);
  if (G <= 4) return launch<QT, KT, 8, 4>(a, smem, stream);
  return launch<QT, KT, 8, 8>(a, smem, stream);
}

bool aligned(const void* p, int bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

}  // namespace

extern "C" {

// Launches the split kernel (and, for splits > 1, the combine) on
// `stream`; returns cudaGetLastError() (0 = ok), or
// cudaErrorInvalidValue for a geometry the kernel does not take.
// q and out are [B, H, D] (f32 when q_bf16 == 0, bf16 otherwise); the
// pools are [P, T, Hkv, D] of q's type, or int8 when kv_int8 != 0; the
// scale pools are f32 [P, T, Hkv, 1] or both null; tables are int32
// [B, NB] and lengths int32 [B]; ws_acc is f32 [B, H, splits, D] and
// ws_ml f32 [B, H, splits, 2] (both unused, and may be null, when
// splits == 1).  Every array is contiguous.
int tfos_paged_attention(const void* q, const void* k_pool,
                         const void* v_pool, const void* k_scale,
                         const void* v_scale, const void* tables,
                         const void* lengths, void* out, void* ws_acc,
                         void* ws_ml, int B, int H, int Hkv, int D, int P,
                         int T, int NB, float scale, int window, int splits,
                         int q_bf16, int kv_int8, void* stream) {
  if (B <= 0 || Hkv <= 0 || H % Hkv != 0 || D < 1 || D > 256 || T < 1 ||
      T > 64 || P < 1 || NB < 1 || splits < 1 || splits > kMaxSplits ||
      (splits > 1 && (ws_acc == nullptr || ws_ml == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const int itemsize = kv_int8 ? 1 : (q_bf16 ? 2 : 4);
  Args a;
  a.q = q;
  a.k = k_pool;
  a.v = v_pool;
  a.ks = static_cast<const float*>(k_scale);
  a.vs = static_cast<const float*>(v_scale);
  a.tables = static_cast<const int*>(tables);
  a.lengths = static_cast<const int*>(lengths);
  a.out = out;
  a.ws_acc = static_cast<float*>(ws_acc);
  a.ws_ml = static_cast<float*>(ws_ml);
  a.B = B;
  a.H = H;
  a.Hkv = Hkv;
  a.D = D;
  a.P = P;
  a.T = T;
  a.NB = NB;
  a.window = window;
  a.splits = splits;
  a.scale = scale;
  const int smem = geometry(H / Hkv, D, T, itemsize, &a.row_bytes,
                            &a.stage_bytes, &a.stages);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  a.vec = 0;
  for (int v = 16; v >= 4; v /= 2) {
    if ((D * itemsize) % v == 0 && aligned(k_pool, v) && aligned(v_pool, v)) {
      a.vec = v;
      break;
    }
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (q_bf16) {
    return kv_int8 ? launch_shape<__nv_bfloat16, int8_t>(a, smem, s)
                   : launch_shape<__nv_bfloat16, __nv_bfloat16>(a, smem, s);
  }
  return kv_int8 ? launch_shape<float, int8_t>(a, smem, s)
                 : launch_shape<float, float>(a, smem, s);
}

}  // extern "C"
