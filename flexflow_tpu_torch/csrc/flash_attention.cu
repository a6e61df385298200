// Flash attention, forward and backward, for Hopper (sm_90a).
//
// Replaces the TPU kernel reached through
// flexflow_tpu/ops/attention.py::_flash_attention, which calls
// jax.experimental.pallas.ops.tpu.flash_attention: its forward kernel and
// its backward's dkv and dq kernels.  It computes what those compute, not a
// block-by-block copy: O = softmax(scale * Q K^T [causal mask]) V with the
// softmax statistics in float32, and the gradients of Q, K and V.
//
// Layout: q (n, sq, h, d), k and v (n, sk, h, d), o and the gradients the
// same, contiguous: the port's own layout, read in place, so no transpose
// is needed around the kernel.  f32, bf16 or f16 in and out; everything
// inside is float32.  The causal mask is the plain version's: key position
// > query position gets the finite -1e30 (positions count from 0 in both
// sequences).  Keys past sk and queries past sq in a ragged last tile are
// masked, so no length needs to be a multiple of the tile.  The forward
// writes O in the storage type and the row log-sum-exp lse = m + log(l)
// (natural log, f32, (n, h, sq)) for the backward.  The backward is
// FlashAttention-2's split, in order on one stream and without atomics, so
// two calls on the same inputs give the same bits: Dvec = rowsum(dO * O);
// dK and dV per key tile; dQ per query tile.  P is rounded to the storage
// type before the P V and P^T dO products, as the plain version rounds its
// probabilities to v's dtype, and dS before the dK and dQ products.
//
// Bound, at BERT-base (n, s, h, d) = (16, 512, 12, 64) in bf16: the forward
// does 2 products, 4 n h s^2 d = 12.9 GFLOP (13.0 us at 989 TFLOP/s), and
// must move q, k, v, o = 50.3 MB (15.0 us at 3.35 TB/s): bytes bound it.
// The backward needs 5 products (S, dP = dO V^T, dV = P^T dO, dK = dS^T Q,
// dQ = dS K), 32.2 GFLOP (32.6 us), and moves about 101 MB (30.0 us):
// operations bound it.  Causal runs need half the operations.
//
// Two routes.  float32 runs scalar float32 FMAs from shared memory (tiles
// in float32, each thread owning 4 rows x 8 columns of a 64x64 product):
// full float32 products, as the plain version computes them.  bf16 and f16
// run Hopper's tensor-core path, built from hopper.cuh:
//  - Blocks of 160 threads: one consumer warpgroup that owns the block's 64
//    rows, and one producer warp.  The producer loads the block's own tile
//    once by TMA, then streams 64-row tiles of the other operands through a
//    ring of shared-memory stages (2 to 4), each with a "full" mbarrier
//    (TMA bytes) and an "empty" one (one arrival per consumer warp), so
//    loads run ahead of the products.  Several blocks share an SM (at d 64:
//    4 forward, 2 dK/dV, 3 dQ), and their warpgroups take turns on the
//    tensor cores.
//  - TMA reads one head's rows straight from the (n, s, h, d) layout: a
//    4-D tensor map over (d, h, s, n) with a box of 64 columns x 1 head x
//    64 rows, 128-byte swizzle (so the products read shared memory without
//    bank conflicts).  Rows past s and columns past d arrive as zeros; a
//    head dim of 128 is two 64-column halves.  TMA needs d a multiple of 8
//    and 16-byte aligned operands: the wrapper pads and copies the rare
//    operands that are not (ops/cuda_attention.py::kernel_operands).
//  - Products are wgmma m64n64k16 with float32 accumulators.  Score-shaped
//    products (S = Q K^T, dP = dO V^T and their transposes) read both
//    operands from shared memory, K-major.  The products with P or dS take
//    them from registers, converted from the accumulator layout to the A
//    operand's and rounded, and read the second operand (V, dO, Q, K) from
//    its row-major tile as an MN-major operand: no tile is ever staged
//    transposed.
//  - The online softmax runs in registers on scores pre-scaled by
//    scale * log2(e), with the special-function unit's exp2; lse is
//    converted back to natural log.  Dvec is a separate small kernel.
// The backward does 7 products where 5 suffice: the dQ kernel recomputes S
// and dP, which the dK/dV kernel also computes.  That buys a dQ without
// atomics (bit-equal repeats) and without a round trip of dS through
// memory.  Measured on the H100 and not kept: two consumer warpgroups per
// block (fewer, larger blocks: slower), overlapping a tile's softmax with
// the next tile's S product inside a warpgroup (more registers, fewer
// blocks an SM: slower), and register reallocation (setmaxnreg) to fit a
// third dK/dV block.  Not yet tried: a persistent grid, products wider than
// 64 columns, and TMA stores of the outputs.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int BQ = 64;        // query rows per tile
constexpr int BK = 64;        // key rows per tile
constexpr int THREADS = 128;  // 4 warps
constexpr int LP = BK + 1;    // padded row of a 64-wide tile in shared memory
constexpr float MASKED = -1e30f;  // the plain version's finite mask value

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }

// v rounded to the storage type T and back (what .to(v.dtype) does)
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// Stage rows [r0, r0 + 64) of a (rows, h, d) sequence (base points at
// element [0, head, 0]) into a 64 x (D + 1) float tile; rows past nrows and
// columns past d are zero.  Consecutive threads read consecutive columns.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* base, int r0,
                                          int nrows, long long row_stride,
                                          int d) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += THREADS) {
    const int r = idx / D, c = idx % D;
    float val = 0.f;
    if (r0 + r < nrows && c < d)
      val = to_f(base[(long long)(r0 + r) * row_stride + c]);
    dst[r * (D + 1) + c] = val;
  }
}

// acc[i][j] = sum_t A[(rg*4 + i), t] * B[(cg + 8*j), t] over t < D: the
// 4 x 8 share of a 64 x 64 product of two row-major (D + 1)-padded tiles.
template <int D>
__device__ __forceinline__ void tile_dot(float (&acc)[4][8], const float* A,
                                         const float* B, int rg, int cg) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int t = 0; t < D; ++t) {
    float a[4], b[8];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(rg * 4 + i) * (D + 1) + t];
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = B[(cg + 8 * j) * (D + 1) + t];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// reductions over the 8 lanes that share a row (lanes 8k .. 8k+7)
__device__ __forceinline__ float row_max8(float v) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float row_sum8(float v) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * ((size_t)(BQ + 2 * BK) * (D + 1) + BQ * LP);
}
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * ((size_t)4 * 64 * (D + 1) + 2 * 64 * LP + 2 * 64);
}
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * ((size_t)4 * 64 * (D + 1) + 64 * LP + 2 * 64);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int h, int sq, int sk, int d,
                     float scale, int causal) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;
  constexpr int DJ = D / 8;
  float* Qs = smem;
  float* Ks = Qs + BQ * LD;
  float* Vs = Ks + BK * LD;
  float* Ps = Vs + BK * LD;

  const int bh = blockIdx.y;
  const int nb = bh / h, hh = bh % h;
  const int q0 = blockIdx.x * BQ;
  const int rg = threadIdx.x / 8, cg = threadIdx.x % 8;
  const long long row = (long long)h * d;
  const T* qb = q + ((long long)nb * sq * h + hh) * d;
  const T* kb = k + ((long long)nb * sk * h + hh) * d;
  const T* vb = v + ((long long)nb * sk * h + hh) * d;

  load_tile<T, D>(Qs, qb, q0, sq, row, d);

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  int n_kt = (sk + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tile<T, D>(Ks, kb, k0, sk, row, d);
    load_tile<T, D>(Vs, vb, k0, sk, row, d);
    __syncthreads();

    float s[4][8];
    tile_dot<D>(s, Qs, Ks, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + rg * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + cg + 8 * j;
        float x = s[i][j] * scale;
        if (kpos >= sk)
          x = -INFINITY;  // past the sequence: contributes exactly 0
        else if (causal && kpos > qpos)
          x = MASKED;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = fmaxf(m[i], row_max8(mx));
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        psum += p;
        Ps[(rg * 4 + i) * LP + cg + 8 * j] = round_to<T>(p);
      }
      l[i] = l[i] * corr + row_sum8(psum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(rg * 4 + i) * LP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = Vs[c * LD + cg + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

  T* ob = o + ((long long)nb * sq * h + hh) * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + rg * 4 + i;
    if (qpos >= sq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = cg + 8 * j;
      if (c < d) ob[(long long)qpos * row + c] = from_f<T>(acc[i][j] * inv);
    }
    if (cg == 0) lse[(long long)bh * sq + qpos] = m[i] + logf(l[i]);
  }
}

// Dvec[(n*h + head) * sq + qpos] = sum_c dO[n, qpos, head, c] * O[...]:
// one warp per (n, qpos, head) row, rows in memory order.
template <typename T>
__global__ void flash_bwd_dot_kernel(const T* __restrict__ o,
                                     const T* __restrict__ dout,
                                     float* __restrict__ dvec,
                                     long long rows, int h, int sq, int d) {
  const long long r =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (r >= rows) return;  // whole warps leave together
  const T* orow = o + r * d;
  const T* grow = dout + r * d;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc += to_f(orow[c]) * to_f(grow[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const long long nb = r / ((long long)sq * h);
    const int rem = (int)(r % ((long long)sq * h));
    const int qpos = rem / h, hh = rem % h;
    dvec[(nb * h + hh) * sq + qpos] = acc;
  }
}

// Stage lse and Dvec of query rows [q0, q0 + 64) (0 past sq).
__device__ __forceinline__ void load_stats(float* lse_s, float* d_s,
                                           const float* lse,
                                           const float* dvec, long long off,
                                           int q0, int sq) {
  for (int r = threadIdx.x; r < 64; r += THREADS) {
    const bool in = q0 + r < sq;
    lse_s[r] = in ? lse[off + q0 + r] : 0.f;
    d_s[r] = in ? dvec[off + q0 + r] : 0.f;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ dvec, T* __restrict__ dk,
                         T* __restrict__ dv, int h, int sq, int sk, int d,
                         float scale, int causal) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;
  constexpr int DJ = D / 8;
  float* Ks = smem;
  float* Vs = Ks + 64 * LD;
  float* Qs = Vs + 64 * LD;
  float* Gs = Qs + 64 * LD;  // dO
  float* Ps = Gs + 64 * LD;  // P^T tile, unrounded, [key][query]
  float* Ss = Ps + 64 * LP;  // dS^T tile, [key][query]
  float* lse_s = Ss + 64 * LP;
  float* d_s = lse_s + 64;

  const int bh = blockIdx.y;
  const int nb = bh / h, hh = bh % h;
  const int k0 = blockIdx.x * BK;
  const int rg = threadIdx.x / 8, cg = threadIdx.x % 8;
  const long long row = (long long)h * d;
  const long long qoff = ((long long)nb * sq * h + hh) * d;
  const long long koff = ((long long)nb * sk * h + hh) * d;

  load_tile<T, D>(Ks, k + koff, k0, sk, row, d);
  load_tile<T, D>(Vs, v + koff, k0, sk, row, d);

  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // query tiles wholly before this key tile are fully masked when causal
  const int n_qt = (sq + BQ - 1) / BQ;
  for (int qt = causal ? k0 / BQ : 0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();
    load_tile<T, D>(Qs, q + qoff, q0, sq, row, d);
    load_tile<T, D>(Gs, dout + qoff, q0, sq, row, d);
    load_stats(lse_s, d_s, lse, dvec, (long long)bh * sq, q0, sq);
    __syncthreads();

    float s[4][8];
    tile_dot<D>(s, Ks, Qs, rg, cg);  // s[key i][query j]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kpos = k0 + rg * 4 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qc = cg + 8 * j, qpos = q0 + qc;
        float p = 0.f;
        if (qpos < sq && kpos < sk && !(causal && kpos > qpos))
          p = expf(s[i][j] * scale - lse_s[qc]);
        Ps[(rg * 4 + i) * LP + qc] = p;
      }
    }
    tile_dot<D>(s, Vs, Gs, rg, cg);  // dP^T[key i][query j]
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int qc = cg + 8 * j;
        const int at = (rg * 4 + i) * LP + qc;
        Ss[at] = Ps[at] * (s[i][j] - d_s[qc]);
      }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < BQ; ++c) {
      float p[4], ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = round_to<T>(Ps[(rg * 4 + i) * LP + c]);
        ds[i] = Ss[(rg * 4 + i) * LP + c];
      }
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float g = Gs[c * LD + cg + 8 * j];
        const float qq = Qs[c * LD + cg + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_acc[i][j] = fmaf(p[i], g, dv_acc[i][j]);
          dk_acc[i][j] = fmaf(ds[i], qq, dk_acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + rg * 4 + i;
    if (kpos >= sk) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = cg + 8 * j;
      if (c >= d) continue;
      const long long at = koff + (long long)kpos * row + c;
      dk[at] = from_f<T>(dk_acc[i][j] * scale);
      dv[at] = from_f<T>(dv_acc[i][j]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ dvec, T* __restrict__ dq,
                        int h, int sq, int sk, int d, float scale,
                        int causal) {
  extern __shared__ float smem[];
  constexpr int LD = D + 1;
  constexpr int DJ = D / 8;
  float* Qs = smem;
  float* Gs = Qs + 64 * LD;  // dO
  float* Ks = Gs + 64 * LD;
  float* Vs = Ks + 64 * LD;
  float* Ss = Vs + 64 * LD;  // dS tile, [query][key]
  float* lse_s = Ss + 64 * LP;
  float* d_s = lse_s + 64;

  const int bh = blockIdx.y;
  const int nb = bh / h, hh = bh % h;
  const int q0 = blockIdx.x * BQ;
  const int rg = threadIdx.x / 8, cg = threadIdx.x % 8;
  const long long row = (long long)h * d;
  const long long qoff = ((long long)nb * sq * h + hh) * d;
  const long long koff = ((long long)nb * sk * h + hh) * d;

  load_tile<T, D>(Qs, q + qoff, q0, sq, row, d);
  load_tile<T, D>(Gs, dout + qoff, q0, sq, row, d);
  load_stats(lse_s, d_s, lse, dvec, (long long)bh * sq, q0, sq);

  float dq_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) dq_acc[i][j] = 0.f;

  int n_kt = (sk + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    load_tile<T, D>(Ks, k + koff, k0, sk, row, d);
    load_tile<T, D>(Vs, v + koff, k0, sk, row, d);
    __syncthreads();

    float s[4][8], dp[4][8];
    tile_dot<D>(s, Qs, Ks, rg, cg);   // s[query i][key j]
    tile_dot<D>(dp, Gs, Vs, rg, cg);  // dP[query i][key j]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = rg * 4 + i, qpos = q0 + qr;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = k0 + cg + 8 * j;
        float ds = 0.f;
        if (qpos < sq && kpos < sk && !(causal && kpos > qpos))
          ds = expf(s[i][j] * scale - lse_s[qr]) * (dp[i][j] - d_s[qr]);
        Ss[qr * LP + cg + 8 * j] = ds;
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = Ss[(rg * 4 + i) * LP + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float kk = Ks[c * LD + cg + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq_acc[i][j] = fmaf(ds[i], kk, dq_acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + rg * 4 + i;
    if (qpos >= sq) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      const int c = cg + 8 * j;
      if (c < d)
        dq[qoff + (long long)qpos * row + c] = from_f<T>(dq_acc[i][j] * scale);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 and f16: TMA into an mbarrier ring, wgmma (see the note at the top).

using hopper::acc_to_a;
using hopper::exp2_approx;
using hopper::desc_k;
using hopper::desc_mn;
using hopper::fence_regs;
using hopper::mbar_arrive;
using hopper::mbar_arrive_tx;
using hopper::mbar_wait;
using hopper::wg_commit;
using hopper::wg_fence;
using hopper::wg_wait;

constexpr int WG = 128;              // threads of the consumer warpgroup
constexpr int TC_THREADS = WG + 32;  // and one producer warp
constexpr int BN = 64;               // rows of every tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// ring stages, as many as leave room for the blocks an SM runs at once:
// at d 64, 4 forward, 2 dK/dV and 3 dQ blocks; at d 128, 2 forward blocks
// and 1 of each backward kernel (the launch bounds say the same, so the
// compiler gives each block the registers that leaves)
constexpr int FWD_STAGES = 2;
constexpr int DQ_STAGES = 3;
template <int D>
__host__ __device__ constexpr int dkv_stages() { return D == 64 ? 4 : 3; }

template <int D>
constexpr size_t fwd_tc_smem() {
  return 1024 + (size_t)BN * D * 2 + (size_t)FWD_STAGES * 2 * BN * D * 2 +
         (1 + 2 * FWD_STAGES) * 8;
}
template <int D>
constexpr size_t dkv_tc_smem() {
  return 1024 + (size_t)2 * BN * D * 2 +
         (size_t)dkv_stages<D>() * (2 * BN * D * 2 + 2 * BN * 4) +
         (1 + 2 * dkv_stages<D>()) * 8;
}
template <int D>
constexpr size_t dq_tc_smem() {
  return 1024 + (size_t)2 * BN * D * 2 +
         (size_t)DQ_STAGES * 2 * BN * D * 2 +
         (1 + 2 * DQ_STAGES) * 8;
}

// the first 1024-byte boundary of dynamic shared memory (128-byte swizzle
// repeats every 1024 bytes, and TMA and wgmma must agree on its phase)
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (hopper::smem_u32(p) & 1023)) & 1023);
}

// TMA of rows [row0, row0 + 64) of one head into a tile: D / 64 column
// halves of 64 x 128 bytes, one box each
template <int D>
__device__ __forceinline__ void load_rows(uint8_t* dst, const CUtensorMap* map,
                                          uint64_t* bar, int head, int row0,
                                          int batch) {
#pragma unroll
  for (int hf = 0; hf < D / 64; ++hf)
    hopper::tma_load_4d(dst + hf * BN * 128, map, bar, hf * 64, head, row0,
                        batch);
}

// row max and row sum over the 4 lanes that share a row
__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Write rows r0 and r0 + 8 of a warpgroup's 64 x D accumulator, times
// `mul[r]`, to out[row][c] (row stride `stride`) where row < nrows and
// c < d.  Each thread writes pairs of columns.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* out, long long stride,
                                           const float (&acc)[D / 64][32],
                                           int row0, int nrows, int d,
                                           const float (&mul)[2], int c0) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= nrows) continue;
    T* dst = out + row * stride;
#pragma unroll
    for (int hf = 0; hf < D / 64; ++hf)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 64 * hf + 8 * j + c0;
        if (c < d)
          *reinterpret_cast<uint32_t*>(dst + c) = hopper::pack2<T>(
              acc[hf][4 * j + 2 * r] * mul[r],
              acc[hf][4 * j + 2 * r + 1] * mul[r]);
      }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(TC_THREADS, D == 64 ? 4 : 2)
    flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        T* __restrict__ o, float* __restrict__ lse, int h,
                        int sq, int sk, int d, float scale_log2, int causal) {
  constexpr int NH = D / 64;
  constexpr int NS = FWD_STAGES;
  constexpr uint32_t KV = BN * D * 2;  // bytes of one K or V tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);
  uint8_t* Ks = Qs + BN * D * 2;
  uint8_t* Vs = Ks + NS * KV;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + NS * KV);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + NS;

  const int bh = blockIdx.y, nb = bh / h, hh = bh % h;
  const int q0 = blockIdx.x * BN;
  int n_kt = (sk + BN - 1) / BN;
  if (causal) n_kt = min(n_kt, (q0 + BN - 1) / BN + 1);

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= WG) {
    // the producer warp: one lane keeps the ring full
    if (threadIdx.x == WG) {
      mbar_arrive_tx(q_full, BN * D * 2);
      load_rows<D>(Qs, &q_map, q_full, hh, q0, nb);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % NS;
        mbar_wait(&empty[s], ((kt / NS) & 1) ^ 1);
        mbar_arrive_tx(&full[s], 2 * KV);
        load_rows<D>(Ks + s * KV, &k_map, &full[s], hh, kt * BN, nb);
        load_rows<D>(Vs + s * KV, &v_map, &full[s], hh, kt * BN, nb);
      }
    }
    return;
  }

  // the consumer warpgroup: query rows [q0, q0 + 64)
  const int t = threadIdx.x, lane = t % 32;
  const int r0 = 16 * (t / 32) + lane / 4;  // rows r0 and r0 + 8
  const int c0 = 2 * (lane % 4);            // columns 8 j + c0 + {0, 1}
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[NH][32];
#pragma unroll
  for (int hf = 0; hf < NH; ++hf)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[hf][i] = 0.f;

  mbar_wait(q_full, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % NS;
    const uint8_t* Kt = Ks + s * KV;
    const uint8_t* Vt = Vs + s * KV;
    mbar_wait(&full[s], (kt / NS) & 1);

    float sc[32];  // S = Q K^T, rows: queries, columns: keys
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_ss<T>(sc, desc_k<BN>(Qs, 0, kk),
                          desc_k<BN>(Kt, 0, kk), kk > 0);
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);

    const int k0 = kt * BN;
    const bool edge = k0 + BN > sk || (causal && k0 + BN - 1 > q0);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = sc[i] * scale_log2;
      if (edge) {
        const int kpos = k0 + 8 * (i / 4) + c0 + (i & 1);
        const int qpos = q0 + r0 + 8 * ((i >> 1) & 1);
        if (kpos >= sk)
          x = -INFINITY;  // past the sequence: contributes exactly 0
        else if (causal && kpos > qpos)
          x = MASKED;
      }
      sc[i] = x;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], x);
    }
    float corr[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      corr[r] = exp2_approx(m[r] - m_new);
      m[r] = m_new;
      l[r] *= corr[r];  // this lane's share; the row sum is taken at the end
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = exp2_approx(sc[i] - m[(i >> 1) & 1]);
      sc[i] = p;
      l[(i >> 1) & 1] += p;
    }
#pragma unroll
    for (int hf = 0; hf < NH; ++hf)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[hf][i] *= corr[(i >> 1) & 1];
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a<T>(pa[kk], sc, kk);

    // O += round(P) V, V read MN-major from its [key][d] tile
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int hf = 0; hf < NH; ++hf)
        hopper::wgmma_rs<T>(acc[hf], pa[kk], desc_mn<BN>(Vt, kk, hf));
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int hf = 0; hf < NH; ++hf) fence_regs(acc[hf]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    inv[r] = 1.f / l[r];
  }
  const long long stride = (long long)h * d;
  store_rows<T, D>(o + ((long long)nb * sq * h + hh) * d + q0 * stride,
                   stride, acc, r0, sq - q0, d, inv, c0);
  if (lane % 4 == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = q0 + r0 + 8 * r;
      if (qpos < sq)
        lse[(long long)bh * sq + qpos] = (m[r] + log2f(l[r])) * LN2;
    }
  }
}

// dK and dV of the block's 64 keys: the consumer warpgroup walks the
// 64-query tiles, with Q, dO and their rows' lse and Dvec streaming through
// the ring.
template <typename T, int D>
__global__ void __launch_bounds__(TC_THREADS, D == 64 ? 2 : 1)
    flash_bwd_dkv_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const __grid_constant__ CUtensorMap do_map,
                            const float* __restrict__ lse,
                            const float* __restrict__ dvec,
                            T* __restrict__ dk, T* __restrict__ dv, int h,
                            int sq, int sk, int d, float scale,
                            float scale_log2, int causal) {
  constexpr int NH = D / 64;
  constexpr int NS = dkv_stages<D>();
  constexpr uint32_t QT = BN * D * 2;  // bytes of one Q or dO tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Ks = align1024(smem_raw);
  uint8_t* Vs = Ks + BN * D * 2;
  uint8_t* Qs = Vs + BN * D * 2;
  uint8_t* Gs = Qs + NS * QT;  // dO
  float* lse_s = reinterpret_cast<float*>(Gs + NS * QT);  // lse * log2(e)
  float* dvec_s = lse_s + NS * BN;
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(dvec_s + NS * BN);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + NS;

  const int bh = blockIdx.y, nb = bh / h, hh = bh % h;
  const int k0 = blockIdx.x * BN;
  // causal: query tiles wholly before these keys see none of them
  const int qt0 = causal ? k0 / BN : 0;
  const int n_qt = (sq + BN - 1) / BN;
  const long long stat = (long long)bh * sq;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  if (threadIdx.x >= WG) {
    // the producer warp: the statistics by all lanes, the tiles by one
    if (lane == 0) {
      mbar_arrive_tx(kv_full, 2 * BN * D * 2);
      load_rows<D>(Ks, &k_map, kv_full, hh, k0, nb);
      load_rows<D>(Vs, &v_map, kv_full, hh, k0, nb);
    }
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int it = qt - qt0, s = it % NS, q0 = qt * BN;
      mbar_wait(&empty[s], ((it / NS) & 1) ^ 1);
      for (int i = lane; i < BN; i += 32) {
        const bool in = q0 + i < sq;
        lse_s[s * BN + i] = in ? lse[stat + q0 + i] * LOG2E : 0.f;
        dvec_s[s * BN + i] = in ? dvec[stat + q0 + i] : 0.f;
      }
      __syncwarp();
      if (lane == 0) {
        mbar_arrive_tx(&full[s], 2 * QT);
        load_rows<D>(Qs + s * QT, &q_map, &full[s], hh, q0, nb);
        load_rows<D>(Gs + s * QT, &do_map, &full[s], hh, q0, nb);
      }
    }
    return;
  }

  // the consumer warpgroup: keys [k0, k0 + 64); its products are
  // transposed (rows: keys, columns: queries)
  const int t = threadIdx.x;
  const int r0 = 16 * (t / 32) + lane / 4;
  const int c0 = 2 * (lane % 4);
  float dk_acc[NH][32], dv_acc[NH][32];
#pragma unroll
  for (int hf = 0; hf < NH; ++hf)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[hf][i] = dv_acc[hf][i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int qt = qt0; qt < n_qt; ++qt) {
    const int it = qt - qt0, s = it % NS, q0 = qt * BN;
    const uint8_t* Qt = Qs + s * QT;
    const uint8_t* Gt = Gs + s * QT;
    const float* ls = lse_s + s * BN;
    const float* ds_ = dvec_s + s * BN;
    mbar_wait(&full[s], (it / NS) & 1);

    float st[32], dpt[32];  // S^T = K Q^T and dP^T = V dO^T
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_ss<T>(st, desc_k<BN>(Ks, 0, kk),
                          desc_k<BN>(Qt, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_ss<T>(dpt, desc_k<BN>(Vs, 0, kk),
                          desc_k<BN>(Gt, 0, kk), kk > 0);
    wg_commit();
    wg_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    const bool edge = q0 + BN > sq || (causal && k0 + 63 > q0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int qc = 8 * (i / 4) + c0 + (i & 1);
      float p = exp2_approx(st[i] * scale_log2 - ls[qc]);
      if (edge) {
        const int kpos = k0 + r0 + 8 * ((i >> 1) & 1), qpos = q0 + qc;
        if (qpos >= sq || (causal && kpos > qpos)) p = 0.f;
      }
      st[i] = p;
      dpt[i] = p * (dpt[i] - ds_[qc]);  // dS^T
    }
    uint32_t pa[4][4], sa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      acc_to_a<T>(pa[kk], st, kk);
      acc_to_a<T>(sa[kk], dpt, kk);
    }

    // dV += round(P^T) dO and dK += round(dS^T) Q, dO and Q read MN-major
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int hf = 0; hf < NH; ++hf) {
        hopper::wgmma_rs<T>(dv_acc[hf], pa[kk], desc_mn<BN>(Gt, kk, hf));
        hopper::wgmma_rs<T>(dk_acc[hf], sa[kk], desc_mn<BN>(Qt, kk, hf));
      }
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int hf = 0; hf < NH; ++hf) {
      fence_regs(dv_acc[hf]);
      fence_regs(dk_acc[hf]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const long long stride = (long long)h * d;
  const long long base = ((long long)nb * sk * h + hh) * d + k0 * stride;
  const float by_scale[2] = {scale, scale}, one[2] = {1.f, 1.f};
  store_rows<T, D>(dk + base, stride, dk_acc, r0, sk - k0, d, by_scale, c0);
  store_rows<T, D>(dv + base, stride, dv_acc, r0, sk - k0, d, one, c0);
}

// dQ of the block's 64 queries: the consumer warpgroup walks the 64-key
// tiles, with K and V streaming through the ring.
template <typename T, int D>
__global__ void __launch_bounds__(TC_THREADS, D == 64 ? 3 : 1)
    flash_bwd_dq_tc_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const __grid_constant__ CUtensorMap do_map,
                           const float* __restrict__ lse,
                           const float* __restrict__ dvec,
                           T* __restrict__ dq, int h, int sq, int sk, int d,
                           float scale, float scale_log2, int causal) {
  constexpr int NH = D / 64;
  constexpr int NS = DQ_STAGES;
  constexpr uint32_t KV = BN * D * 2;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* Qs = align1024(smem_raw);
  uint8_t* Gs = Qs + BN * D * 2;  // dO
  uint8_t* Ks = Gs + BN * D * 2;
  uint8_t* Vs = Ks + NS * KV;
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(Vs + NS * KV);
  uint64_t* full = qd_full + 1;
  uint64_t* empty = full + NS;

  const int bh = blockIdx.y, nb = bh / h, hh = bh % h;
  const int q0 = blockIdx.x * BN;
  int n_kt = (sk + BN - 1) / BN;
  if (causal) n_kt = min(n_kt, (q0 + BN - 1) / BN + 1);

  if (threadIdx.x == 0) {
    hopper::mbar_init(qd_full, 1);
    for (int s = 0; s < NS; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 4);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= WG) {
    if (threadIdx.x == WG) {
      mbar_arrive_tx(qd_full, 2 * BN * D * 2);
      load_rows<D>(Qs, &q_map, qd_full, hh, q0, nb);
      load_rows<D>(Gs, &do_map, qd_full, hh, q0, nb);
      for (int kt = 0; kt < n_kt; ++kt) {
        const int s = kt % NS;
        mbar_wait(&empty[s], ((kt / NS) & 1) ^ 1);
        mbar_arrive_tx(&full[s], 2 * KV);
        load_rows<D>(Ks + s * KV, &k_map, &full[s], hh, kt * BN, nb);
        load_rows<D>(Vs + s * KV, &v_map, &full[s], hh, kt * BN, nb);
      }
    }
    return;
  }

  const int t = threadIdx.x, lane = t % 32;
  const int r0 = 16 * (t / 32) + lane / 4;
  const int c0 = 2 * (lane % 4);
  const long long stat = (long long)bh * sq;
  float lse2[2], dvr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = q0 + r0 + 8 * r;
    lse2[r] = qpos < sq ? lse[stat + qpos] * LOG2E : 0.f;
    dvr[r] = qpos < sq ? dvec[stat + qpos] : 0.f;
  }
  float dq_acc[NH][32];
#pragma unroll
  for (int hf = 0; hf < NH; ++hf)
#pragma unroll
    for (int i = 0; i < 32; ++i) dq_acc[hf][i] = 0.f;

  mbar_wait(qd_full, 0);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int s = kt % NS;
    const uint8_t* Kt = Ks + s * KV;
    const uint8_t* Vt = Vs + s * KV;
    mbar_wait(&full[s], (kt / NS) & 1);

    float sc[32], dp[32];  // S = Q K^T and dP = dO V^T
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_ss<T>(sc, desc_k<BN>(Qs, 0, kk),
                          desc_k<BN>(Kt, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      hopper::wgmma_ss<T>(dp, desc_k<BN>(Gs, 0, kk),
                          desc_k<BN>(Vt, 0, kk), kk > 0);
    wg_commit();
    wg_wait<0>();
    fence_regs(sc);
    fence_regs(dp);

    const int k0 = kt * BN;
    const bool edge = k0 + BN > sk || (causal && k0 + BN - 1 > q0);
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int r = (i >> 1) & 1;
      float p = exp2_approx(sc[i] * scale_log2 - lse2[r]);
      if (edge) {
        const int kpos = k0 + 8 * (i / 4) + c0 + (i & 1);
        const int qpos = q0 + r0 + 8 * r;
        if (kpos >= sk || (causal && kpos > qpos)) p = 0.f;
      }
      dp[i] = p * (dp[i] - dvr[r]);  // dS
    }
    uint32_t sa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a<T>(sa[kk], dp, kk);

    // dQ += round(dS) K, K read MN-major from its [key][d] tile
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int hf = 0; hf < NH; ++hf)
        hopper::wgmma_rs<T>(dq_acc[hf], sa[kk], desc_mn<BN>(Kt, kk, hf));
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int hf = 0; hf < NH; ++hf) fence_regs(dq_acc[hf]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  const long long stride = (long long)h * d;
  const float by_scale[2] = {scale, scale};
  store_rows<T, D>(dq + ((long long)nb * sq * h + hh) * d + q0 * stride,
                   stride, dq_acc, r0, sq - q0, d, by_scale, c0);
}

template <typename T, int D>
cudaError_t launch_fwd(const void* q, const void* k, const void* v, void* o,
                       void* lse, int n, int h, int sq, int sk, int d,
                       float scale, int causal, cudaStream_t s) {
  auto kern = flash_fwd_kernel<T, D>;
  const size_t smem = fwd_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((sq + BQ - 1) / BQ, n * h);
  kern<<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      h, sq, sk, d, scale, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd(const void* q, const void* k, const void* v,
                       const void* o, const void* lse, const void* dout,
                       void* dq, void* dk, void* dv, void* dvec, int n, int h,
                       int sq, int sk, int d, float scale, int causal,
                       cudaStream_t s) {
  const long long rows = (long long)n * sq * h;
  const int per_block = 8;  // warps
  flash_bwd_dot_kernel<T><<<(unsigned)((rows + per_block - 1) / per_block),
                            32 * per_block, 0, s>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<float*>(dvec), rows, h, sq, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkv = flash_bwd_dkv_kernel<T, D>;
  err = cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dkv_smem<D>());
  if (err != cudaSuccess) return err;
  dkv<<<dim3((sk + BK - 1) / BK, n * h), THREADS, dkv_smem<D>(), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dvec),
      static_cast<T*>(dk), static_cast<T*>(dv), h, sq, sk, d, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dqk = flash_bwd_dq_kernel<T, D>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dq_smem<D>());
  if (err != cudaSuccess) return err;
  dqk<<<dim3((sq + BQ - 1) / BQ, n * h), THREADS, dq_smem<D>(), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dvec),
      static_cast<T*>(dq), h, sq, sk, d, scale, causal);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T>
constexpr bool is_bf16() {
  return std::is_same<T, __nv_bfloat16>::value;
}

// Dvec[(n*h + head) * sq + qpos] = sum_c dO[n, qpos, head, c] * O[...] for
// the 16-bit route (d a multiple of 8): 8 lanes share a row, each summing
// 16-byte chunks, so a warp reads 4 whole rows of d 64 at a time.
constexpr int DOT_LANES = 8;

template <typename T>
__global__ void flash_bwd_dot_tc_kernel(const T* __restrict__ o,
                                        const T* __restrict__ dout,
                                        float* __restrict__ dvec,
                                        long long rows, int h, int sq,
                                        int d) {
  const long long r =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / DOT_LANES;
  const int part = threadIdx.x % DOT_LANES;
  const bool in = r < rows;  // every lane stays for the shuffles
  const uint4* orow = reinterpret_cast<const uint4*>(o + r * d);
  const uint4* grow = reinterpret_cast<const uint4*>(dout + r * d);
  float acc = 0.f;
  for (int c = part; in && c < d / 8; c += DOT_LANES) {
    const uint4 a = orow[c], b = grow[c];
    const T* ea = reinterpret_cast<const T*>(&a);
    const T* eb = reinterpret_cast<const T*>(&b);
#pragma unroll
    for (int i = 0; i < 8; ++i) acc = fmaf(to_f(ea[i]), to_f(eb[i]), acc);
  }
#pragma unroll
  for (int off = DOT_LANES / 2; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off, DOT_LANES);
  if (in && part == 0) {
    const long long nb = r / ((long long)sq * h);
    const int rem = (int)(r % ((long long)sq * h));
    const int qpos = rem / h, hh = rem % h;
    dvec[(nb * h + hh) * sq + qpos] = acc;
  }
}

template <typename T, int D>
cudaError_t launch_fwd_tc(const void* q, const void* k, const void* v,
                          void* o, void* lse, int n, int h, int sq, int sk,
                          int d, float scale, int causal, cudaStream_t s) {
  CUtensorMap qm, km, vm;
  if (!hopper::encode_rows(&qm, q, is_bf16<T>(), n, sq, h, d, BN) ||
      !hopper::encode_rows(&km, k, is_bf16<T>(), n, sk, h, d, BN) ||
      !hopper::encode_rows(&vm, v, is_bf16<T>(), n, sk, h, d, BN))
    return cudaErrorInvalidValue;
  auto kern = flash_fwd_tc_kernel<T, D>;
  const size_t smem = fwd_tc_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kern<<<dim3((sq + BN - 1) / BN, n * h), TC_THREADS, smem, s>>>(
      qm, km, vm, static_cast<T*>(o), static_cast<float*>(lse), h, sq, sk, d,
      scale * LOG2E, causal);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd_tc(const void* q, const void* k, const void* v,
                          const void* o, const void* lse, const void* dout,
                          void* dq, void* dk, void* dv, void* dvec, int n,
                          int h, int sq, int sk, int d, float scale,
                          int causal, cudaStream_t s) {
  CUtensorMap qm, km, vm, gm;
  if (!hopper::encode_rows(&qm, q, is_bf16<T>(), n, sq, h, d, BN) ||
      !hopper::encode_rows(&km, k, is_bf16<T>(), n, sk, h, d, BN) ||
      !hopper::encode_rows(&vm, v, is_bf16<T>(), n, sk, h, d, BN) ||
      !hopper::encode_rows(&gm, dout, is_bf16<T>(), n, sq, h, d, BN))
    return cudaErrorInvalidValue;

  const long long rows = (long long)n * sq * h;
  const long long threads = rows * DOT_LANES;
  flash_bwd_dot_tc_kernel<T><<<(unsigned)((threads + 255) / 256), 256, 0,
                               s>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<float*>(dvec), rows, h, sq, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dkv = flash_bwd_dkv_tc_kernel<T, D>;
  err = cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dkv_tc_smem<D>());
  if (err != cudaSuccess) return err;
  dkv<<<dim3((sk + BN - 1) / BN, n * h), TC_THREADS, dkv_tc_smem<D>(), s>>>(
      qm, km, vm, gm, static_cast<const float*>(lse),
      static_cast<const float*>(dvec), static_cast<T*>(dk),
      static_cast<T*>(dv), h, sq, sk, d, scale, scale * LOG2E, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dqk = flash_bwd_dq_tc_kernel<T, D>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dq_tc_smem<D>());
  if (err != cudaSuccess) return err;
  dqk<<<dim3((sq + BN - 1) / BN, n * h), TC_THREADS, dq_tc_smem<D>(), s>>>(
      qm, km, vm, gm, static_cast<const float*>(lse),
      static_cast<const float*>(dvec), static_cast<T*>(dq), h, sq, sk, d,
      scale, scale * LOG2E, causal);
  return cudaGetLastError();
}

// What TMA needs of a 16-bit operand: a head dim that is a multiple of 8
// (16-byte row strides) and a 16-byte aligned start.  The wrapper copies
// operands that are not so before the call.
bool tma_ready(int d, std::initializer_list<const void*> ptrs) {
  if (d % 8 != 0) return false;
  for (const void* p : ptrs)
    if (!aligned16(p)) return false;
  return true;
}

// float32 runs the scalar kernels (full float32 products); bf16 and f16
// the TMA and wgmma kernels
template <typename T>
cudaError_t dispatch_fwd(const void* q, const void* k, const void* v,
                         void* o, void* lse, int n, int h, int sq, int sk,
                         int d, float scale, int causal, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value) {
    if (d <= 64)
      return launch_fwd<T, 64>(q, k, v, o, lse, n, h, sq, sk, d, scale,
                               causal, s);
    return launch_fwd<T, 128>(q, k, v, o, lse, n, h, sq, sk, d, scale,
                              causal, s);
  } else {
    if (!tma_ready(d, {q, k, v})) return cudaErrorInvalidValue;
    if (d <= 64)
      return launch_fwd_tc<T, 64>(q, k, v, o, lse, n, h, sq, sk, d, scale,
                                  causal, s);
    return launch_fwd_tc<T, 128>(q, k, v, o, lse, n, h, sq, sk, d, scale,
                                 causal, s);
  }
}

template <typename T>
cudaError_t dispatch_bwd(const void* q, const void* k, const void* v,
                         const void* o, const void* lse, const void* dout,
                         void* dq, void* dk, void* dv, void* dvec, int n,
                         int h, int sq, int sk, int d, float scale,
                         int causal, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value) {
    if (d <= 64)
      return launch_bwd<T, 64>(q, k, v, o, lse, dout, dq, dk, dv, dvec, n,
                               h, sq, sk, d, scale, causal, s);
    return launch_bwd<T, 128>(q, k, v, o, lse, dout, dq, dk, dv, dvec, n, h,
                              sq, sk, d, scale, causal, s);
  } else {
    if (!tma_ready(d, {q, k, v, dout})) return cudaErrorInvalidValue;
    if (d <= 64)
      return launch_bwd_tc<T, 64>(q, k, v, o, lse, dout, dq, dk, dv, dvec,
                                  n, h, sq, sk, d, scale, causal, s);
    return launch_bwd_tc<T, 128>(q, k, v, o, lse, dout, dq, dk, dv, dvec, n,
                                 h, sq, sk, d, scale, causal, s);
  }
}

}  // namespace

// Forward.  q (n, sq, h, d), k and v (n, sk, h, d), o (n, sq, h, d), all
// contiguous and of one dtype (0 float32, 1 bfloat16, 2 float16); lse
// (n, h, sq) float32.  1 <= d <= 128, sq, sk >= 1; for bf16 and f16, d a
// multiple of 8 and q, k, v 16-byte aligned.  Launches on `stream` of
// `device` and returns cudaGetLastError() (0 on success).
extern "C" int ff_flash_attention_fwd(const void* q, const void* k,
                                      const void* v, void* o, void* lse,
                                      int dtype, int n, int h, int sq, int sk,
                                      int d, float scale, int causal,
                                      int device, void* stream) {
  if (d < 1 || d > 128) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)dispatch_fwd<float>(q, k, v, o, lse, n, h, sq, sk, d, scale,
                                      causal, s);
    case 1:
      return (int)dispatch_fwd<__nv_bfloat16>(q, k, v, o, lse, n, h, sq, sk,
                                              d, scale, causal, s);
    case 2:
      return (int)dispatch_fwd<__half>(q, k, v, o, lse, n, h, sq, sk, d,
                                       scale, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Backward.  q, k, v, o and lse as the forward took and wrote them, dout the
// gradient of o (n, sq, h, d, contiguous, o's dtype and, for bf16 and f16,
// 16-byte aligned); writes dq, dk and dv (the shapes and dtype of q, k and
// v).  dvec is a float32 scratch of n * h * sq elements.  The three kernels
// run in order on `stream`.
extern "C" int ff_flash_attention_bwd(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* lse, const void* dout,
                                      void* dq, void* dk, void* dv,
                                      void* dvec, int dtype, int n, int h,
                                      int sq, int sk, int d, float scale,
                                      int causal, int device, void* stream) {
  if (d < 1 || d > 128) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)dispatch_bwd<float>(q, k, v, o, lse, dout, dq, dk, dv, dvec,
                                      n, h, sq, sk, d, scale, causal, s);
    case 1:
      return (int)dispatch_bwd<__nv_bfloat16>(q, k, v, o, lse, dout, dq, dk,
                                              dv, dvec, n, h, sq, sk, d,
                                              scale, causal, s);
    case 2:
      return (int)dispatch_bwd<__half>(q, k, v, o, lse, dout, dq, dk, dv,
                                       dvec, n, h, sq, sk, d, scale, causal,
                                       s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
