// Hopper (sm_90a) machinery shared by the port's wgmma kernels: TMA tensor
// maps, loads and stores, mbarrier rings, wgmma descriptors and products,
// and register rebalancing between warpgroups.  Written out by hand; no
// CUTLASS or CuTe.
//
// Conventions used by every kernel that includes this header:
//  - Operand tiles are bf16 and land in shared memory through TMA with the
//    128-byte swizzle: one box is [rows][64] (128 bytes a row), and a box
//    starts on a 1024-byte boundary (one swizzle atom is 8 rows x 128 B).
//    f32 row vectors (the flash backward's lse and delta) land unswizzled
//    through 1-D maps.
//  - A K-major operand (the reduction dimension contiguous in memory)
//    walks its 16-element k steps by adding 32 bytes to the descriptor's
//    start address inside the 128-byte row; 8-row groups are 1024 bytes
//    apart (SBO).  An MN-major operand (the output dimension contiguous)
//    walks its k steps by 16 rows (2048 bytes); its 8-row k groups are
//    1024 bytes apart (SBO) and its 64-wide MN blocks one box apart (LBO).
//  - Accumulators are f32 in the wgmma register layout: in warp w of the
//    warpgroup, lane (g = lane / 4, t = lane % 4) holds, for each
//    8-column chunk c, d[4c], d[4c+1] at row 16w + g, columns 8c + 2t,
//    8c + 2t + 1 and d[4c+2], d[4c+3] at row 16w + g + 8.  A register A
//    fragment of one k step is the same layout over 16 columns, packed to
//    bf16 pairs (the mma.sync m16n8k16 A fragment of each warp).
//
// Host side: tensor maps are encoded for each launch from the pointers
// and strides the wrappers pass, through cuTensorMapEncodeTiled reached
// with cudaGetDriverEntryPoint (no -lcuda).  A failed encode returns a
// non-zero code that the C entry hands back to its wrapper, which raises.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

// ------------------------------------------------------------ host side

// returned when cuTensorMapEncodeTiled cannot be found
constexpr int kNoEncodeEntry = 900;
// a failed encode returns kEncodeFailed + its CUresult
constexpr int kEncodeFailed = 1000;

inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled_entry() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// A bf16 tensor map of `rank` dimensions, innermost first: extents
// `dims`, byte strides of dims 1.. in `strides` (multiples of 16), box
// `box` (box[0] <= 64 for the 128-byte swizzle).  Elements outside the
// extents load as zeros.  0 on success.
inline int encode_bf16(CUtensorMap* map, const void* base, int rank,
                       const cuuint64_t* dims, const cuuint64_t* strides,
                       const cuuint32_t* box) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled_entry();
  if (encode == nullptr) return kNoEncodeEntry;
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                      const_cast<void*>(base), dims, strides, box, unit,
                      CU_TENSOR_MAP_INTERLEAVE_NONE,
                      CU_TENSOR_MAP_SWIZZLE_128B,
                      CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)r;
}

// A 1-D f32 tensor map over `n` contiguous floats, boxes of `box`
// elements (box * 4 a multiple of 16), no swizzle: elements at or past n
// load as zeros.  0 on success.
inline int encode_f32_1d(CUtensorMap* map, const void* base, cuuint64_t n,
                         cuuint32_t box) {
  PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled_entry();
  if (encode == nullptr) return kNoEncodeEntry;
  const cuuint64_t dims[1] = {n};
  const cuuint64_t strides[1] = {4};  // not read for rank 1
  const cuuint32_t boxes[1] = {box};
  const cuuint32_t unit[1] = {1};
  CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1,
                      const_cast<void*>(base), dims, strides, boxes, unit,
                      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                      CU_TENSOR_MAP_L2_PROMOTION_NONE,
                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + (int)r;
}

inline int num_sms() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  return n;
}

// ---------------------------------------------------------- device side

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// mbarriers (addresses in the shared window, 8-byte aligned)

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// after one thread has initialised the barriers, before the block syncs:
// makes the initialisation visible to the async proxy (TMA) as well
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// one arrival that also announces `bytes` of TMA traffic on this phase
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// a wait longer than this is a lost wake-up (a wrong phase bit or a
// byte count that never arrives): trap, so the launch fails instead of
// hanging the card
constexpr uint64_t kWatchdogNs = 4000000000ull;

// Wait for the completion of the barrier's phase of parity `parity`: a
// fresh barrier is in phase 0, so waiting on parity 1 passes at once
// (the "previous" phase counts as complete).
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (global_ns() - t0 > kWatchdogNs) __trap();
  }
}

// The same wait without the watchdog, for code after setmaxnreg.inc: a
// possible __trap there makes ptxas ignore setmaxnreg and allocate such
// code within the launch bound (168 registers at 384 threads), so a
// loop that needs more spills (chip_smoke.phase_register_probe).  A
// kernel whose consumers wait this way has its producer wait, with the
// watchdog, for the consumers' release of every tile it loaded
// (mbar_drain), so a lost wake-up still traps.
__device__ __forceinline__ void mbar_wait_spin(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// For a ring of `stages` empty barriers at `empty` (8 bytes apart) that
// has carried `n` tiles: wait until the consumers released the last
// tile of each stage.
__device__ __forceinline__ void mbar_drain(uint32_t empty, int stages, int n) {
  for (int it = n > stages ? n - stages : 0; it < n; ++it)
    mbar_wait(empty + 8 * (it % stages), (it / stages) & 1);
}

// TMA tile loads into shared memory, completing `bar`'s transaction count

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// TMA tile stores from shared memory, in bulk groups of the issuing thread

__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], "
      "[%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group "
      "[%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// until at most N of the thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}
// until at most N of the thread's bulk groups are still running
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}
// after threads wrote shared memory that a TMA store will read
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// barrier `id` (1..15; 0 is __syncthreads) over `threads` threads
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void st_shared_b32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// register rebalancing: every thread of the warpgroup executes it

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}
template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

// wgmma ordering

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads of accumulators (or reuse of an A
// fragment's registers) across a wgmma wait: call after the wait.
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int R>
__device__ __forceinline__ void fence_regs(uint32_t (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// Shared-memory matrix descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

#define TFOS_F8(d, i)                                                   \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define TFOS_F32(d, i) \
  TFOS_F8(d, i), TFOS_F8(d, i + 8), TFOS_F8(d, i + 16), TFOS_F8(d, i + 24)

#define TFOS_REGS_32                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "       \
  "%8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31}"
#define TFOS_REGS_64                        \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "       \
  "%8, %9, %10, %11, %12, %13, %14, %15, "  \
  "%16, %17, %18, %19, %20, %21, %22, %23, " \
  "%24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, " \
  "%40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, " \
  "%56, %57, %58, %59, %60, %61, %62, %63}"
#define TFOS_REGS_128                                   \
  "{%0, %1, %2, %3, %4, %5, %6, %7, "                   \
  "%8, %9, %10, %11, %12, %13, %14, %15, "              \
  "%16, %17, %18, %19, %20, %21, %22, %23, "            \
  "%24, %25, %26, %27, %28, %29, %30, %31, "            \
  "%32, %33, %34, %35, %36, %37, %38, %39, "            \
  "%40, %41, %42, %43, %44, %45, %46, %47, "            \
  "%48, %49, %50, %51, %52, %53, %54, %55, "            \
  "%56, %57, %58, %59, %60, %61, %62, %63, "            \
  "%64, %65, %66, %67, %68, %69, %70, %71, "            \
  "%72, %73, %74, %75, %76, %77, %78, %79, "            \
  "%80, %81, %82, %83, %84, %85, %86, %87, "            \
  "%88, %89, %90, %91, %92, %93, %94, %95, "            \
  "%96, %97, %98, %99, %100, %101, %102, %103, "        \
  "%104, %105, %106, %107, %108, %109, %110, %111, "    \
  "%112, %113, %114, %115, %116, %117, %118, %119, "    \
  "%120, %121, %122, %123, %124, %125, %126, %127}"

// d[64 x N] (+)= A . B, bf16 in, f32 accumulate, both operands in shared
// memory; TA / TB are the transpose bits (1 = MN-major).  scale_d = 0
// overwrites d instead of adding to it.

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n64_ss(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TFOS_REGS_32
      ", %32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : TFOS_F32(d, 0)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n128_ss(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TFOS_REGS_64
      ", %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : TFOS_F32(d, 0), TFOS_F32(d, 32)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_m64n256_ss(float (&d)[128], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " TFOS_REGS_128
      ", %128, %129, p, 1, 1, %131, %132;\n"
      "}\n"
      : TFOS_F32(d, 0), TFOS_F32(d, 32), TFOS_F32(d, 64), TFOS_F32(d, 96)
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// d[64 x N] += A . B with A in registers (four bf16 pairs of one k step,
// K-major by definition) and B in shared memory (TB as above).

template <int TB>
__device__ __forceinline__ void wgmma_m64n64_rs(float (&d)[32],
                                                const uint32_t* a,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " TFOS_REGS_32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : TFOS_F32(d, 0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_m64n128_rs(float (&d)[64],
                                                 const uint32_t* a,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " TFOS_REGS_64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : TFOS_F32(d, 0), TFOS_F32(d, 32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d),
        "n"(TB));
}

}  // namespace hopper
