// NHWC max-pool forward for Hopper (sm_90a).
//
// Replaces the TPU kernel flexflow_tpu/ops/pallas_pool.py::_fwd_kernel
// (reached through pallas_max_pool_nhwc).  It computes what that kernel
// computes, not a block-by-block copy of it: y[n, oh, ow, c] is the max
// over the kh x kw window at (oh*sh - ph, ow*sw - pw); positions in the
// padding count as the dtype's finite minimum (finfo(dtype).min, as the
// Pallas kernel pads), and a NaN anywhere in the window makes the result
// NaN (jnp.maximum semantics; fmaxf would drop it).  The window is walked
// row-major, the order of the Pallas kernel's max tree, so the selected
// value is bit-equal to the plain PyTorch version in every dtype.
// The output size uses floor arithmetic; trailing rows and columns that
// no window covers are never read.
//
// Layout: x is (N, H, W, C) with C fastest — torch.channels_last memory
// under the logical NCHW shape.  One thread computes one output element,
// c fastest, so the 32 threads of a warp read 32 neighbouring channels of
// the same pixel: every load of a window position is coalesced.
//
// Bound: memory.  The kernel must read x once and write y once; the
// k*k re-reads of overlapping windows hit L1/L2.  For AlexNet's three
// 3x3/s2 pools in bf16 at batch 64 that is 25.7+6.0 MB, 17.9+4.2 MB and
// 5.5+1.2 MB, i.e. about 31.7, 22.1 and 6.7 MB: divide by the device
// memory bandwidth of the card (3.35 TB/s on an H100 SXM) for the bound.
// Design for that bound, kept simple in this first version: coalesced
// scalar loads and stores, no shared memory.  16-byte vector loads over
// channels and a shared-memory tile are the next steps.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <float.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

// finfo(dtype).min: the finite lowest value of each storage type
template <typename T> __device__ __forceinline__ T lowest();
template <> __device__ __forceinline__ float lowest<float>() {
  return -FLT_MAX;
}
template <> __device__ __forceinline__ __nv_bfloat16 lowest<__nv_bfloat16>() {
  return __ushort_as_bfloat16((unsigned short)0xFF7Fu);
}
template <> __device__ __forceinline__ __half lowest<__half>() {
  return __ushort_as_half((unsigned short)0xFBFFu);
}

template <typename T>
__global__ void max_pool_nhwc_kernel(const T* __restrict__ x,
                                     T* __restrict__ y, int h, int w, int c,
                                     int oh, int ow, int kh, int kw, int sh,
                                     int sw, int ph, int pw, int64_t total) {
  const T pad = lowest<T>();
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t idx = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
       idx < total; idx += step) {
    const int ci = (int)(idx % c);
    int64_t rest = idx / c;
    const int owi = (int)(rest % ow);
    rest /= ow;
    const int ohi = (int)(rest % oh);
    const int64_t ni = rest / oh;
    const T* xn = x + ni * h * w * c + ci;
    const int h0 = ohi * sh - ph;
    const int w0 = owi * sw - pw;
    T best = pad;
    float bestf = 0.0f;
    bool first = true;
    for (int i = 0; i < kh; ++i) {
      const int hi = h0 + i;
      const bool row_in = hi >= 0 && hi < h;
      for (int j = 0; j < kw; ++j) {
        const int wi = w0 + j;
        const T v = (row_in && wi >= 0 && wi < w)
                        ? xn[((int64_t)hi * w + wi) * c]
                        : pad;
        const float vf = to_float(v);
        // maximum(best, v): NaN wins and stays; otherwise the larger
        if (first || (!isnan(bestf) && (isnan(vf) || vf > bestf))) {
          best = v;
          bestf = vf;
        }
        first = false;
      }
    }
    y[idx] = best;
  }
}

template <typename T>
cudaError_t launch(const void* x, void* y, int n, int h, int w, int c,
                   int oh, int ow, int kh, int kw, int sh, int sw, int ph,
                   int pw, cudaStream_t stream) {
  const int64_t total = (int64_t)n * oh * ow * c;
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > 2147483647) blocks = 2147483647;
  max_pool_nhwc_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), h, w, c, oh, ow, kh,
      kw, sh, sw, ph, pw, total);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  Launches on `stream`
// (a cudaStream_t) on device `device`, allocates nothing, does not
// synchronise, and returns cudaGetLastError() after the launch.
extern "C" int ff_max_pool_nhwc(const void* x, void* y, int dtype, int n,
                                int h, int w, int c, int oh, int ow, int kh,
                                int kw, int sh, int sw, int ph, int pw,
                                int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch<float>(x, y, n, h, w, c, oh, ow, kh, kw, sh, sw,
                                ph, pw, s);
    case 1:
      return (int)launch<__nv_bfloat16>(x, y, n, h, w, c, oh, ow, kh, kw,
                                        sh, sw, ph, pw, s);
    case 2:
      return (int)launch<__half>(x, y, n, h, w, c, oh, ow, kh, kw, sh, sw,
                                 ph, pw, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
