// NHWC max-pool forward and backward for Hopper (sm_90a).
//
// Forward.  Replaces the TPU kernel
// flexflow_tpu/ops/pallas_pool.py::_fwd_kernel (reached through
// pallas_max_pool_nhwc).  It computes what that kernel computes, not a
// block-by-block copy of it: y[n, oh, ow, c] is the max
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

// Backward.  Replaces the TPU kernel
// flexflow_tpu/ops/pallas_pool.py::_bwd_kernel (reached through _pool_bwd,
// the VJP of pallas_max_pool_nhwc).  It computes what that kernel computes:
// dx[n, h, w, c] is the sum of g[n, oh, ow, c] over the windows (oh, ow)
// whose FIRST row-major position equal to the window's max is (h, w).
// The max is recomputed as the forward selects it (pad = finfo.min, NaN
// wins), and "equal" is the Pallas kernel's float compare wv == y, so a
// window whose max is NaN routes no gradient, -0.0 equals +0.0, and a
// window whose max is a pad value routes its gradient into the padding,
// where it is dropped.  Positions no window covers get 0.
//
// Design: two passes in one call, with no atomics.
//  1. One thread per output window (c fastest, coalesced as in the
//     forward) finds the window's first-match argmax once and writes its
//     row-major offset i * kw + j as int16 (-1 when the max is NaN) into
//     a scratch tensor the size of g.  With the forward's strict ">"
//     update, the last position that updated the running max is the
//     first position equal to the final max, so one pass over the window
//     finds it.
//  2. A gather: one thread per input element (c fastest) walks the
//     window offsets (i, j) in ascending row-major order; for each offset
//     that puts the element inside a window it reads that window's
//     argmax and, on a match, adds the window's g.  The sum is kept in
//     the storage type and rounded after every add, acc = T(float(acc) +
//     float(g)), in that ascending (i, j) order: the Pallas kernel
//     accumulates each stride phase in g's dtype in the same order (every
//     contribution to one input position lands in the same phase plane),
//     so dx is bit-equal to the plain version in bf16 and f16 as well as
//     f32.
//
// Bound: memory.  Read x once, read g once, write dx once.  For AlexNet's
// three pools in bf16 at batch 64 that is 57.35 MB, 39.99 MB and
// 12.26 MB: 17.1, 11.9 and 3.7 us at 3.35 TB/s, 32.7 us per training
// step.  The argmax scratch adds a write and about 2.25 reads of 2 bytes
// per window for 3x3/s2 (the window re-reads of pass 1 hit L1/L2, as in
// the forward).  Finding the argmax in the gather instead would redo each
// window for each of the k*k elements it covers: 9x the window loads.
// 16-byte vector loads over channels are the next step for both passes.

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

// float -> storage type, round to nearest even (as torch rounds the
// result of a bf16 or f16 add)
template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <> __device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half_rn(v);
}

// Window offset (row-major, i * kw + j) of the first position equal to
// the max of the window at (h0, w0), selected as the forward kernel
// selects; -1 when the max is NaN (no position compares equal to it).
template <typename T>
__device__ __forceinline__ int window_argmax(const T* __restrict__ xn, int h,
                                             int w, int c, int h0, int w0,
                                             int kh, int kw) {
  const T pad = lowest<T>();
  float bestf = 0.0f;
  int arg = -1;
  for (int i = 0; i < kh; ++i) {
    const int hi = h0 + i;
    const bool row_in = hi >= 0 && hi < h;
    for (int j = 0; j < kw; ++j) {
      const int wi = w0 + j;
      const T v = (row_in && wi >= 0 && wi < w)
                      ? xn[((int64_t)hi * w + wi) * c]
                      : pad;
      const float vf = to_float(v);
      if (arg < 0 || (!isnan(bestf) && (isnan(vf) || vf > bestf))) {
        bestf = vf;
        arg = i * kw + j;
      }
    }
  }
  return isnan(bestf) ? -1 : arg;
}

// Both passes index in I: int32_t when the tensors allow it, since a
// 64-bit division is a long software sequence on the card.

// Pass 1 of the backward: each output window's first-match argmax.
template <typename T, typename I>
__global__ void max_pool_nhwc_argmax_kernel(const T* __restrict__ x,
                                            int16_t* __restrict__ arg,
                                            int h, int w, int c, int oh,
                                            int ow, int kh, int kw, int sh,
                                            int sw, int ph, int pw,
                                            I total) {
  const I step = (I)gridDim.x * blockDim.x;
  for (I idx = (I)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += step) {
    const int ci = (int)(idx % c);
    I rest = idx / c;
    const int owi = (int)(rest % ow);
    rest /= ow;
    const int ohi = (int)(rest % oh);
    const I ni = rest / oh;
    arg[idx] = (int16_t)window_argmax(x + ni * h * w * c + ci, h, w, c,
                                      ohi * sh - ph, owi * sw - pw, kh, kw);
  }
}

// Pass 2 of the backward: the ordered gather into dx.
template <typename T, typename I>
__global__ void max_pool_nhwc_bwd_kernel(const int16_t* __restrict__ arg,
                                         const T* __restrict__ g,
                                         T* __restrict__ dx, int h, int w,
                                         int c, int oh, int ow, int kh,
                                         int kw, int sh, int sw, int ph,
                                         int pw, I total) {
  const I step = (I)gridDim.x * blockDim.x;
  for (I idx = (I)blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += step) {
    const int ci = (int)(idx % c);
    I rest = idx / c;
    const int wi = (int)(rest % w);
    rest /= w;
    const int hi = (int)(rest % h);
    const I obase = rest / h * oh * ow * c + ci;
    const int hp = hi + ph;  // padded coordinates of this element
    const int wp = wi + pw;
    // the offsets that put this element in a window are i = hp % sh,
    // hp % sh + sh, ..., in window rows hp / sh, hp / sh - 1, ...
    // (likewise for j): ascending (i, j), the Pallas accumulation order
    T acc = from_float<T>(0.0f);
    for (int i = hp % sh, ohi = hp / sh; i < kh && ohi >= 0;
         i += sh, --ohi) {
      if (ohi >= oh) continue;
      for (int j = wp % sw, owi = wp / sw; j < kw && owi >= 0;
           j += sw, --owi) {
        if (owi >= ow) continue;
        const I o = obase + ((I)ohi * ow + owi) * c;
        if (arg[o] == i * kw + j) {
          acc = from_float<T>(to_float(acc) + to_float(g[o]));
        }
      }
    }
    dx[idx] = acc;
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

template <typename T, typename I>
cudaError_t launch_bwd_as(const void* x, const void* g, void* dx, void* arg,
                          int n, int h, int w, int c, int oh, int ow, int kh,
                          int kw, int sh, int sw, int ph, int pw,
                          cudaStream_t stream) {
  const int threads = 256;
  const int64_t total_out = (int64_t)n * oh * ow * c;
  int64_t blocks = (total_out + threads - 1) / threads;
  if (blocks > 2147483647) blocks = 2147483647;
  max_pool_nhwc_argmax_kernel<T, I>
      <<<(unsigned)blocks, threads, 0, stream>>>(
          static_cast<const T*>(x), static_cast<int16_t*>(arg), h, w, c, oh,
          ow, kh, kw, sh, sw, ph, pw, (I)total_out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int64_t total_in = (int64_t)n * h * w * c;
  blocks = (total_in + threads - 1) / threads;
  if (blocks > 2147483647) blocks = 2147483647;
  max_pool_nhwc_bwd_kernel<T, I><<<(unsigned)blocks, threads, 0, stream>>>(
      static_cast<const int16_t*>(arg), static_cast<const T*>(g),
      static_cast<T*>(dx), h, w, c, oh, ow, kh, kw, sh, sw, ph, pw,
      (I)total_in);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* g, void* dx, void* arg,
                       int n, int h, int w, int c, int oh, int ow, int kh,
                       int kw, int sh, int sw, int ph, int pw,
                       cudaStream_t stream) {
  // int32 indices while every index, plus one grid stride, stays below
  // 2^31
  const int64_t in_px = (int64_t)h * w, out_px = (int64_t)oh * ow;
  const int64_t most = (int64_t)n * c * (in_px > out_px ? in_px : out_px);
  if (most <= 1073741823)
    return launch_bwd_as<T, int32_t>(x, g, dx, arg, n, h, w, c, oh, ow, kh,
                                     kw, sh, sw, ph, pw, stream);
  return launch_bwd_as<T, int64_t>(x, g, dx, arg, n, h, w, c, oh, ow, kh,
                                   kw, sh, sw, ph, pw, stream);
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

// The backward: x is the forward's input, g the gradient of its output
// (both NHWC, same dtype code), dx the gradient of x (NHWC, written in
// full), arg an int16 scratch of g's element count (kh * kw < 32768).
// Same conventions as ff_max_pool_nhwc; the two passes run in order on
// `stream`.
extern "C" int ff_max_pool_nhwc_bwd(const void* x, const void* g, void* dx,
                                    void* arg, int dtype, int n, int h,
                                    int w, int c, int oh, int ow, int kh,
                                    int kw, int sh, int sw, int ph, int pw,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_bwd<float>(x, g, dx, arg, n, h, w, c, oh, ow, kh,
                                    kw, sh, sw, ph, pw, s);
    case 1:
      return (int)launch_bwd<__nv_bfloat16>(x, g, dx, arg, n, h, w, c, oh,
                                            ow, kh, kw, sh, sw, ph, pw, s);
    case 2:
      return (int)launch_bwd<__half>(x, g, dx, arg, n, h, w, c, oh, ow, kh,
                                     kw, sh, sw, ph, pw, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
