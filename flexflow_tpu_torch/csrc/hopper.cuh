// Hopper (sm_90a) primitives for the port's kernels, in raw PTX: mbarriers,
// TMA tile loads, wgmma shared-memory descriptors and the m64n64k16 wgmma
// products with float32 accumulators.
//
// Conventions the kernels rely on:
//  - A "tile" is R rows of 64 16-bit values (128 bytes a row), loaded by TMA
//    with 128-byte swizzle, so it must start on a 1024-byte boundary.  A
//    tile with a head dim of 128 is stored as two such column halves, one
//    after the other.
//  - wgmma accumulators: thread t of a warpgroup (warp w = t / 32, lane l)
//    holds, for j = 0..7, d[4j + e] at row 16 w + l / 4 + 8 (e / 2) and
//    column 8 j + 2 (l % 4) + e % 2 of the 64 x 64 result.  That is also
//    the layout of a register A operand, 16 columns (two j) at a time.
//  - The host looks up cuTensorMapEncodeTiled through the CUDA runtime's
//    entry-point query, so nothing links against libcuda.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// --- mbarriers ------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// make the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// one arrival that also announces `bytes` of TMA traffic for this phase
__device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try(uint32_t addr, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(addr), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait for the completion of the phase of parity `parity`.  A wait that
// lasts 2^35 cycles (about 17 s) can only be a lost arrival: trap, so the
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  if (mbar_try(addr, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try(addr, parity))
    if (clock64() - t0 > (1LL << 35)) __trap();
}

// 2^x on the special-function unit (about 2 ulp; exp2(-inf) = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// --- TMA ------------------------------------------------------------------

// Load the box at coordinates (c0, c1, c2, c3) of a 4-D tensor map into
// shared memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// --- wgmma descriptors ----------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle: start address, leading
// and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t desc128(const void* p, uint32_t lbo,
                                            uint32_t sbo) {
  uint64_t d = (smem_u32(p) & 0x3FFFF) >> 4;
  d |= (uint64_t)((lbo >> 4) & 0x3FFF) << 16;
  d |= (uint64_t)((sbo >> 4) & 0x3FFF) << 32;
  d |= (uint64_t)1 << 62;  // SWIZZLE_128B
  return d;
}

// K-major operand (the reduction runs along a row): rows [row0, row0 + 64)
// of an R-row tile, reduction step kk (16 columns) of its head dim.
template <int R>
__device__ __forceinline__ uint64_t desc_k(const uint8_t* tile, int row0,
                                           int kk) {
  return desc128(tile + (kk / 4) * R * 128 + row0 * 128 + (kk % 4) * 32, 16,
                 1024);
}

// MN-major operand (the reduction runs down the rows, N along a row):
// reduction step kk (16 rows) of an R-row tile, column half `half`.
template <int R>
__device__ __forceinline__ uint64_t desc_mn(const uint8_t* tile, int kk,
                                            int half) {
  return desc128(tile + half * R * 128 + kk * 16 * 128, R * 128, 1024);
}

// --- wgmma ----------------------------------------------------------------

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving reads or writes of accumulators across the
// asynchronous products
__device__ __forceinline__ void fence_regs(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64, f32) = or += A B; A and B from shared memory, both K-major
template <typename T>
__device__ void wgmma_ss(float (&d)[32], uint64_t a, uint64_t b, int acc);
// d += A B; A from registers (4 x 32 bits a thread), B from shared memory,
// MN-major
template <typename T>
__device__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b);

#define FF_D32                                                              \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define FF_ACC32(d)                                                         \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

#define FF_WGMMA(T, TY)                                                     \
  template <>                                                               \
  __device__ __forceinline__ void wgmma_ss<T>(float(&d)[32], uint64_t a,    \
                                              uint64_t b, int acc) {        \
    asm volatile(                                                           \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                        \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " FF_D32  \
        ", %32, %33, p, 1, 1, 0, 0;\n}\n"                                   \
        : FF_ACC32(d)                                                       \
        : "l"(a), "l"(b), "r"(acc));                                        \
  }                                                                         \
  template <>                                                               \
  __device__ __forceinline__ void wgmma_rs<T>(                              \
      float(&d)[32], const uint32_t(&a)[4], uint64_t b) {                   \
    asm volatile(                                                           \
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                        \
        "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " FF_D32  \
        ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                     \
        : FF_ACC32(d)                                                       \
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));      \
  }

FF_WGMMA(__nv_bfloat16, "bf16")
FF_WGMMA(__half, "f16")

#undef FF_WGMMA
#undef FF_ACC32
#undef FF_D32

// two floats rounded to T and packed (lo in the low half)
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A operand of reduction step kk from a 64 x 64 accumulator (columns
// [16 kk, 16 kk + 16)), rounded to T.
template <typename T>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&p)[32],
                                         int kk) {
  a[0] = pack2<T>(p[8 * kk + 0], p[8 * kk + 1]);
  a[1] = pack2<T>(p[8 * kk + 2], p[8 * kk + 3]);
  a[2] = pack2<T>(p[8 * kk + 4], p[8 * kk + 5]);
  a[3] = pack2<T>(p[8 * kk + 6], p[8 * kk + 7]);
}

// --- host: tensor maps ----------------------------------------------------

using EncodeTiledFn = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                   cuuint32_t, void*, const cuuint64_t*,
                                   const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave,
                                   CUtensorMapSwizzle, CUtensorMapL2promotion,
                                   CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up once through the runtime
inline EncodeTiledFn encode_tiled() {
  static const EncodeTiledFn fn = []() -> EncodeTiledFn {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiledFn>(p);
  }();
  return fn;
}

// The map of an (n, s, h, d) tensor of 16-bit values read in place: dims
// (d, h, s, n) innermost first, a box of 64 columns x 1 head x `rows` rows
// x 1 batch, 128-byte swizzle.  Coordinates past s or d read as zeros.
// d must be a multiple of 8 and `base` 16-byte aligned.
inline bool encode_rows(CUtensorMap* map, const void* base, bool bf16, int n,
                        int s, int h, int d, int rows) {
  const EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t es = 2;
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)h, (cuuint64_t)s,
                              (cuuint64_t)n};
  const cuuint64_t strides[3] = {d * es, (cuuint64_t)h * d * es,
                                 (cuuint64_t)s * h * d * es};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map,
            bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16,
            4, const_cast<void*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
