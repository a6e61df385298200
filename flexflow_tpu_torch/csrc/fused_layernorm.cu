// Fused LayerNorm(+residual) for Hopper (sm_90a).
//
// Replaces the TPU kernel flexflow_tpu/ops/pallas_norm.py::_ln_kernel and
// _ln_res_kernel (reached through fused_layernorm -> _call).  It computes
// what they compute: per row of the last axis, xf = x (+ res) in float32,
// the mean, the population variance (ddof 0) as the mean of (xf - mean)^2
// (two passes over the row), y = (xf - mean) * rsqrt(var + eps) * scale +
// bias.  The multiplies and the add of the epilogue are rounded one at a
// time (no fused multiply-add), in the plain version's order.  y is stored
// as float32 (the TPU kernel's contract) or as x's bf16/f16 type, rounded
// once to nearest even as Tensor.to() rounds, so the narrow form equals the
// float32 form followed by a cast, bit for bit.
//
// Design.  The row lives in registers: a thread holds NV vectors of VEC
// values of one row as float32 (NV from the plan, compiled for 1, 2, 3, 4,
// 6 and 8; at most MAX_VALUES values), loaded as 16-byte vectors (8
// bf16/f16 or 4 f32) when every pointer is 16-byte aligned and a row is a
// whole number of them, else as single elements (VEC 1, NV MAX_VALUES)
// through the same code.  Each thread issues all its loads before its
// first reduction; a thread holding at most 16 values loads its scale and
// bias with them, so their latency hides behind the reductions.  A row's
// TPR threads (a power of two) are consecutive: below 32 several rows
// share a warp and reduce with xor shuffles inside their group; at 32 and
// above a row takes whole warps, which reduce by shuffles and then through
// MAX_WARPS floats of static shared memory.  No dynamic shared memory, so
// no attribute to set before a launch, and no device switch unless the
// caller's device is not current.
//
// Plan (ops/cuda_norm.py::launch_plan, which passes vec, nv, tpr and rpb
// here).  TPR starts at the least power of two that keeps a thread within
// MAX_VALUES and doubles, up to MAX_THREADS, while a thread holds more
// than one vector and either the rows times TPR do not half fill the card
// (its SMs x 1024 threads) or a thread holds more than 4 vectors.  A block
// is one row, or a warp's worth of rows narrower than a warp.  NV is the
// fewest compiled vectors that hold a thread's share, rounded up to a
// power of two when the output is wider than the input.  So a decode
// step's 16 rows of 768 bf16 take 128 threads a row, one vector a thread,
// in 16 blocks; BERT-base's 8192 bf16 rows a warp a row, 3 vectors a
// thread (compiled for 4 with float32 out), in 8192 blocks; its float32
// rows 2 warps a row, 3 vectors a thread.  The rule follows the plan
// sweep in chip_smoke.py (PERF.md), not a model: on an H100 one warp a
// row beats 2 to 8 warps at 8192 bf16 rows (10-40%), while float32 rows
// run 7% faster on 2 warps holding 3 vectors than on one holding 6; and a
// thread compiled for 4 vectors holding 3 stores float32 9% faster than
// one compiled for 3, while at 2 warps a row of float32 in, 4 is 40%
// slower than 3.  Every d from 1 to 14336 fits: 14336 values over 512
// threads is 28 a thread.
//
// Bound: memory.  Each input byte read once, each output byte written
// once: at BERT-base (16 x 512 rows of 768, bf16 in) 8192 x 768 x (2 + 4)
// B = 37.7 MB with f32 out, 11.3 us at 3.35 TB/s; 8192 x 768 x (2 + 2) B =
// 25.2 MB with bf16 out, 7.5 us; float32 in and out 50.3 MB, 15.0 us.
// The arithmetic is about 8 operations an element, far below the card's
// rate.  A decode step's 16 rows move 24 KB: there the bound is the
// launch itself, which chip_smoke.py times as an empty kernel
// (ff_fused_layernorm_empty) on the same grid.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int MAX_VALUES = 32;   // float32 values of a row one thread holds
constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int MAX_D = 14336;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename O>
__device__ __forceinline__ O from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half_rn(v);
}

// VEC consecutive values at p as float32: 16-byte loads when VEC values
// fill one or more of them (p is then 16-byte aligned), else one by one
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p,
                                         float* out) {
  if constexpr (VEC * sizeof(T) < 16) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) out[i] = to_f(p[i]);
  } else {
    constexpr int PER = 16 / sizeof(T);
#pragma unroll
    for (int c = 0; c < VEC / PER; ++c) {
      const uint4 raw = reinterpret_cast<const uint4*>(p)[c];
      const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < PER; ++i) out[c * PER + i] = to_f(t[i]);
    }
  }
}

template <typename O, int VEC>
__device__ __forceinline__ void store_vec(O* __restrict__ p,
                                          const float* v) {
  if constexpr (VEC * sizeof(O) < 16) {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = from_f<O>(v[i]);
  } else {
    constexpr int PER = 16 / sizeof(O);
#pragma unroll
    for (int c = 0; c < VEC / PER; ++c) {
      uint4 raw;
      O* o = reinterpret_cast<O*>(&raw);
#pragma unroll
      for (int i = 0; i < PER; ++i) o[i] = from_f<O>(v[c * PER + i]);
      reinterpret_cast<uint4*>(p)[c] = raw;
    }
  }
}

// The sum of s over the tpr threads of a row.  Every thread of the block
// calls it (rows past the end with zeros): the shuffles take the full
// warp, and a row of whole warps meets at __syncthreads.
__device__ __forceinline__ float row_sum(float s, int tpr, float* part) {
  const int width = tpr < 32 ? tpr : 32;
  for (int off = width / 2; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (tpr <= 32) return s;
  const int warps = tpr / 32;
  const int first = (int)(threadIdx.x / tpr) * warps;
  if (threadIdx.x % 32 == 0) part[threadIdx.x / 32] = s;
  __syncthreads();
  s = 0.f;
  for (int w = 0; w < warps; ++w) s += part[first + w];
  return s;
}

template <typename T, typename O, int VEC, int NV, bool RES>
__global__ void __launch_bounds__(MAX_THREADS)
    layernorm_kernel(const T* __restrict__ x, const T* __restrict__ res,
                     const float* __restrict__ scale,
                     const float* __restrict__ bias, O* __restrict__ y,
                     long long rows, int d, int tpr, float eps) {
  // a thread holding few values loads its scale and bias with its row,
  // so their latency hides behind the reductions
  constexpr bool EARLY = NV * VEC <= 16;
  __shared__ float part[2][MAX_WARPS];
  const int nvec = d / VEC;
  const int t = threadIdx.x % tpr;
  const long long r =
      (long long)blockIdx.x * (blockDim.x / tpr) + threadIdx.x / tpr;
  const bool live = r < rows;
  const size_t row = (size_t)r * d;

  // thread t holds the row's vectors t, t + tpr, t + 2 tpr, ...
  float v[NV][VEC];
  float sc[EARLY ? NV : 1][VEC], bi[EARLY ? NV : 1][VEC];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = t + i * tpr;
    if (live && c < nvec) {
      load_vec<T, VEC>(x + row + (size_t)c * VEC, v[i]);
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k) v[i][k] = 0.f;
    }
  }
  if constexpr (RES) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = t + i * tpr;
      if (live && c < nvec) {
        float rv[VEC];
        load_vec<T, VEC>(res + row + (size_t)c * VEC, rv);
#pragma unroll
        for (int k = 0; k < VEC; ++k) v[i][k] = __fadd_rn(v[i][k], rv[k]);
      }
    }
  }
  if constexpr (EARLY) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = t + i * tpr;
      if (live && c < nvec) {
        load_vec<float, VEC>(scale + (size_t)c * VEC, sc[i]);
        load_vec<float, VEC>(bias + (size_t)c * VEC, bi[i]);
      }
    }
  }

  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int k = 0; k < VEC; ++k) sum = __fadd_rn(sum, v[i][k]);
  const float mean = __fdiv_rn(row_sum(sum, tpr, part[0]), (float)d);

  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    if (t + i * tpr < nvec) {
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float e = __fsub_rn(v[i][k], mean);
        sq = __fadd_rn(sq, __fmul_rn(e, e));
      }
    }
  }
  const float var = __fdiv_rn(row_sum(sq, tpr, part[1]), (float)d);
  const float rstd = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(var, eps)));

#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = t + i * tpr;
    if (live && c < nvec) {
      const float* s = sc[EARLY ? i : 0];
      const float* b = bi[EARLY ? i : 0];
      if constexpr (!EARLY) {
        load_vec<float, VEC>(scale + (size_t)c * VEC, sc[0]);
        load_vec<float, VEC>(bias + (size_t)c * VEC, bi[0]);
      }
      float o[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float n = __fmul_rn(__fsub_rn(v[i][k], mean), rstd);
        o[k] = __fadd_rn(__fmul_rn(n, s[k]), b[k]);
      }
      store_vec<O, VEC>(y + row + (size_t)c * VEC, o);
    }
  }
}

__global__ void empty_kernel() {}

template <typename T, typename O, int VEC, int NV>
cudaError_t launch(const void* x, const void* res, const void* scale,
                   const void* bias, void* y, long long rows, int d,
                   int tpr, int rpb, float eps, cudaStream_t s) {
  const unsigned blocks = (unsigned)((rows + rpb - 1) / rpb);
  const T* xt = static_cast<const T*>(x);
  const T* rt = static_cast<const T*>(res);
  const float* sc = static_cast<const float*>(scale);
  const float* bi = static_cast<const float*>(bias);
  O* yt = static_cast<O*>(y);
  if (res)
    layernorm_kernel<T, O, VEC, NV, true><<<blocks, tpr * rpb, 0, s>>>(
        xt, rt, sc, bi, yt, rows, d, tpr, eps);
  else
    layernorm_kernel<T, O, VEC, NV, false><<<blocks, tpr * rpb, 0, s>>>(
        xt, rt, sc, bi, yt, rows, d, tpr, eps);
  return cudaGetLastError();
}

// Vectors a thread holds: the plan's nv, compiled for 1, 2, 3, 4, 6 and 8
// (within MAX_VALUES) on the 16-byte path and for MAX_VALUES on the
// element path.
template <typename T, typename O>
cudaError_t launch_vec(const void* x, const void* res, const void* scale,
                       const void* bias, void* y, long long rows, int d,
                       int vec, int nv, int tpr, int rpb, float eps,
                       cudaStream_t s) {
  constexpr int WIDE = 16 / sizeof(T);
#define FF_LN_LAUNCH(V, N) \
  launch<T, O, V, N>(x, res, scale, bias, y, rows, d, tpr, rpb, eps, s)
  if (vec == 1) return FF_LN_LAUNCH(1, MAX_VALUES);
  switch (nv) {
    case 1: return FF_LN_LAUNCH(WIDE, 1);
    case 2: return FF_LN_LAUNCH(WIDE, 2);
    case 3: return FF_LN_LAUNCH(WIDE, 3);
    case 4: return FF_LN_LAUNCH(WIDE, 4);
    default: break;
  }
  if constexpr (8 * WIDE <= MAX_VALUES) {
    if (nv == 6) return FF_LN_LAUNCH(WIDE, 6);
    if (nv == 8) return FF_LN_LAUNCH(WIDE, 8);
  }
#undef FF_LN_LAUNCH
  return cudaErrorInvalidValue;  // plan_ok refuses it first
}

// The plan's own checks: the kernel trusts them.
bool plan_ok(int itemsize, long long rows, int d, int vec, int nv, int tpr,
             int rpb) {
  if (d < 1 || d > MAX_D || rows < 1) return false;
  if (vec != 1 && vec != 16 / itemsize) return false;
  if (d % vec != 0) return false;
  if (tpr < 1 || tpr > MAX_THREADS || (tpr & (tpr - 1)) != 0) return false;
  if (rpb < 1 || tpr * rpb > MAX_THREADS || (tpr * rpb) % 32 != 0)
    return false;
  if ((rows + rpb - 1) / rpb > 0x7fffffffLL) return false;
  if (vec == 1 ? nv != MAX_VALUES
               : (nv < 1 || nv > 8 || nv == 5 || nv == 7 ||
                  nv * vec > MAX_VALUES))
    return false;
  return (d / vec + tpr - 1) / tpr <= nv;
}

cudaError_t use_device(int device) {
  int cur = -1;
  cudaError_t err = cudaGetDevice(&cur);
  if (err != cudaSuccess) return err;
  return cur == device ? cudaSuccess : cudaSetDevice(device);
}

}  // namespace

// x (rows, d) contiguous, dtype 0 float32, 1 bfloat16, 2 float16; res
// null or (rows, d) of x's dtype; scale and bias float32 (d,); y (rows, d)
// of out_dtype: 0 (float32) or x's dtype.  vec, tpr, rpb: the launch plan
// (values a vector, vectors a thread, threads a row, rows a block);
// vec > 1 needs every
// pointer 16-byte aligned and d * itemsize a multiple of 16, which the
// caller checks.  1 <= d <= 14336.  Launches on `stream` of `device`;
// returns cudaGetLastError() (0 on success).
extern "C" int ff_fused_layernorm(const void* x, const void* res,
                                  const void* scale, const void* bias,
                                  void* y, int dtype, int out_dtype,
                                  long long rows, int d, int vec, int nv,
                                  int tpr, int rpb, float eps, int device,
                                  void* stream) {
  static const int itemsize[3] = {4, 2, 2};
  if (dtype < 0 || dtype > 2 || (out_dtype != 0 && out_dtype != dtype) ||
      !plan_ok(itemsize[dtype], rows, d, vec, nv, tpr, rpb))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype * 3 + out_dtype) {
    case 0:
      return (int)launch_vec<float, float>(x, res, scale, bias, y, rows, d,
                                           vec, nv, tpr, rpb, eps, s);
    case 3:
      return (int)launch_vec<__nv_bfloat16, float>(
          x, res, scale, bias, y, rows, d, vec, nv, tpr, rpb, eps, s);
    case 4:
      return (int)launch_vec<__nv_bfloat16, __nv_bfloat16>(
          x, res, scale, bias, y, rows, d, vec, nv, tpr, rpb, eps, s);
    case 6:
      return (int)launch_vec<__half, float>(x, res, scale, bias, y, rows, d,
                                            vec, nv, tpr, rpb, eps, s);
    case 8:
      return (int)launch_vec<__half, __half>(x, res, scale, bias, y, rows,
                                             d, vec, nv, tpr, rpb, eps, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// An empty kernel on the same grid (blocks of `threads`), for the launch
// floor the kernel is timed against; returns cudaGetLastError().
extern "C" int ff_fused_layernorm_empty(long long blocks, int threads,
                                        int device, void* stream) {
  if (blocks < 1 || blocks > 0x7fffffffLL || threads < 1 ||
      threads > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return (int)err;
  empty_kernel<<<(unsigned)blocks, threads, 0,
                 static_cast<cudaStream_t>(stream)>>>();
  return cudaGetLastError();
}
