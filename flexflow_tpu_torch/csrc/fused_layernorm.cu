// Fused LayerNorm(+residual) for Hopper (sm_90a).
//
// Replaces the TPU kernel flexflow_tpu/ops/pallas_norm.py::_ln_kernel and
// _ln_res_kernel (reached through fused_layernorm -> _call).  It computes
// what they compute: per row of the last axis, xf = x (+ res) in float32,
// the mean, the population variance (ddof 0) as the mean of (xf - mean)^2,
// y = (xf - mean) * rsqrt(var + eps) * scale + bias, written as float32.
// The multiplies and the add of the epilogue are rounded one at a time
// (no fused multiply-add), in the plain version's order.
//
// Design: one warp per row, 4 rows per block.  The warp reads its row of x
// (and res) once, with consecutive lanes on consecutive elements, adds them
// in float32 and keeps the sum row in shared memory; the mean and then the
// variance are warp-shuffle reductions over that cached row, and the
// normalised row is written from it.  So device memory sees one read of x
// (and res), one write of y and the two d-vectors, which the L2 cache holds
// for all rows.
//
// Bound: memory.  At BERT-base, 16 x 512 rows of d = 768, x in bf16 and y
// in f32: 8192 x 768 x (2 + 4) B = 37.7 MB, 11.3 us at 3.35 TB/s.  The
// arithmetic is about 8 operations per element, far below the card's rate.
// Scalar 2- or 4-byte loads are the simple first step; 16-byte vector
// loads and several rows per warp for small d are the next.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;  // rows per block

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(32 * WARPS)
    layernorm_kernel(const T* __restrict__ x, const T* __restrict__ res,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias, float* __restrict__ y,
                     long long rows, int d, float eps) {
  extern __shared__ float buf[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const long long r = (long long)blockIdx.x * WARPS + warp;
  if (r >= rows) return;  // whole warps leave together
  float* xs = buf + (size_t)warp * d;
  const T* xr = x + r * d;
  const T* rr = res ? res + r * d : nullptr;

  float sum = 0.f;
  for (int c = lane; c < d; c += 32) {
    float v = to_f(xr[c]);
    if (rr) v = __fadd_rn(v, to_f(rr[c]));
    xs[c] = v;
    sum += v;
  }
  const float mean = __fdiv_rn(warp_sum(sum), (float)d);
  float sq = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float t = __fsub_rn(xs[c], mean);
    sq = __fadd_rn(sq, __fmul_rn(t, t));
  }
  const float var = __fdiv_rn(warp_sum(sq), (float)d);
  const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));
  float* yr = y + r * d;
  for (int c = lane; c < d; c += 32) {
    const float t = __fmul_rn(__fsub_rn(xs[c], mean), rstd);
    yr[c] = __fadd_rn(__fmul_rn(t, scale[c]), bias[c]);
  }
}

template <typename T>
cudaError_t launch(const void* x, const void* res, const void* scale,
                   const void* bias, void* y, long long rows, int d,
                   float eps, cudaStream_t s) {
  auto kern = layernorm_kernel<T>;
  const size_t smem = sizeof(float) * (size_t)WARPS * d;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long blocks = (rows + WARPS - 1) / WARPS;
  kern<<<(unsigned)blocks, 32 * WARPS, smem, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(res),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<float*>(y), rows, d, eps);
  return cudaGetLastError();
}

}  // namespace

// x (rows, d) contiguous, dtype 0 float32, 1 bfloat16, 2 float16; res null
// or (rows, d) of x's dtype; scale and bias float32 (d,); y float32
// (rows, d).  1 <= d <= 14336 (four rows of d floats fit shared memory).
// Launches on `stream` of `device`; returns cudaGetLastError() (0 on
// success).
extern "C" int ff_fused_layernorm(const void* x, const void* res,
                                  const void* scale, const void* bias,
                                  void* y, int dtype, long long rows, int d,
                                  float eps, int device, void* stream) {
  if (d < 1 || d > 14336 || rows < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch<float>(x, res, scale, bias, y, rows, d, eps, s);
    case 1:
      return (int)launch<__nv_bfloat16>(x, res, scale, bias, y, rows, d, eps,
                                        s);
    case 2:
      return (int)launch<__half>(x, res, scale, bias, y, rows, d, eps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
