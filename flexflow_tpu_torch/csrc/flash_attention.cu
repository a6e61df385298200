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
// same, contiguous: the port's own layout, read in place with a row stride
// of h * d elements, so no transpose is needed around the kernel.  f32, bf16
// or f16 in and out; everything inside is float32.  The causal mask is the
// plain version's: key position > query position gets the finite -1e30
// (positions count from 0 in both sequences).  Keys past sk and queries past
// sq in a ragged last tile are masked, so no length needs to be a multiple
// of the tile.
//
// Forward (ff_flash_attention_fwd).  One block of 128 threads per (n*h,
// 64-query tile).  The query tile is staged in shared memory once; the block
// walks the 64-key tiles of K and V, staged in shared memory in turn, with
// the online softmax: running row max m, running sum l of exp(s - m), and an
// unnormalised accumulator rescaled by exp(m_old - m_new) at every tile.  A
// causal run stops at the last tile that touches the diagonal.  P is rounded
// to the storage type before the P V product, as the plain version rounds
// its probabilities to v's dtype (identity in f32).  The row statistics
// never leave the lanes of one warp that share a row (warp shuffles).  It
// writes O in the storage type and the row log-sum-exp lse = m + log(l)
// (f32, (n, h, sq)) for the backward.
//
// Backward (ff_flash_attention_bwd), FlashAttention-2's split, three kernels
// in order on one stream, no atomics (the result does not change from run to
// run):
//  1. Dvec = rowsum(dO * O) per query row (one warp per row);
//  2. one block per (n*h, 64-key tile) walks the query tiles, recomputes
//     P = exp(scale * K Q^T - lse) and dP = V dO^T, and accumulates
//     dV += round(P) dO and dK += dS Q in registers, dS = P * (dP - Dvec);
//  3. one block per (n*h, 64-query tile) walks the key tiles and
//     accumulates dQ += dS K the same way.
// dK and dQ are scaled by `scale` once at the end.
//
// Two routes share that structure.  float32 runs scalar float32 FMAs from
// shared memory (tiles in float32, each thread owning 4 rows x 8 columns of
// a 64x64 product): full float32 products, as the plain version computes
// them.  bf16 and f16 run the tensor cores (mma.sync m16n8k16, float32
// accumulators, each warp owning 16 rows), with the tiles in the storage
// type; there dS is rounded to the storage type before the dK and dQ
// products, as FlashAttention-2 does.
//
// Bound, at BERT-base (n, s, h, d) = (16, 512, 12, 64) in bf16: the forward
// does 4 n h s^2 d = 12.9 GFLOP (13.0 us at 989 TFLOP/s) and must move
// q, k, v, o = 50.3 MB (15.0 us at 3.35 TB/s): bytes bound it.  The backward
// needs about 2.5x the forward's operations, 32.2 GFLOP (32.6 us), and
// moves about 101 MB (30.0 us): operations bound it.  Causal runs need half
// the operations.  This version is written to be right and simple: no
// software pipelining of the tile loads (each block waits for its own
// loads), scalar or 16-byte loads through registers rather than TMA, and
// the backward recomputes S and dP in both the dK/dV and the dQ kernels.
// wgmma with TMA loads into a pipelined ring is the next step.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float v) {
  return __float2half(v);
}

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
// bf16 and f16: the same three steps on the tensor cores, mma.sync
// m16n8k16 with float32 accumulators.  Tiles are staged in shared memory in
// the storage type, rows padded by 8 elements so the fragment loads hit 32
// distinct banks; operands a product reads along the key (or query) axis
// are staged transposed.  Each of the 4 warps owns 16 rows of the 64-row
// tile, so row statistics are shuffles among the 4 lanes of a row.  The
// score tile's accumulators are reused in registers as the A operand of
// the next product (P V, P^T dO, dS^T Q, dS K), rounded to the storage
// type on the way, as the plain version rounds P to v's dtype.

constexpr int LT = 64 + 8;  // pitch of a transposed (D x 64) tile

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);
template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo,
                                                        float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// c += a b for one 16x8x16 tile: a row-major 16x16, b column-major 16x8
template <typename T>
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma<__nv_bfloat16>(float (&c)[4],
                                                   const uint32_t (&a)[4],
                                                   uint32_t b0,
                                                   uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma<__half>(float (&c)[4],
                                            const uint32_t (&a)[4],
                                            uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage rows [r0, r0 + 64) of a (rows, h, d) sequence into a 64 x D tile
// of pitch `pitch` (row-major) or, when `trans`, into a D x 64 tile of
// pitch LT (dst[c * LT + r]).  Zero past nrows and past d.  With `vec`
// (d a multiple of 8 and 16-byte aligned pointers) each thread moves 8
// elements per load.
template <typename T, int D>
__device__ __forceinline__ void stage(T* dst, int pitch, bool trans,
                                      const T* base, int r0, int nrows,
                                      long long row_stride, int d,
                                      bool vec) {
  if (vec) {
    constexpr int C8 = D / 8;
    for (int idx = threadIdx.x; idx < 64 * C8; idx += THREADS) {
      const int r = idx / C8, c = (idx % C8) * 8;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < nrows && c < d)
        val = *reinterpret_cast<const uint4*>(
            base + (long long)(r0 + r) * row_stride + c);
      if (!trans) {
        *reinterpret_cast<uint4*>(dst + r * pitch + c) = val;
      } else {
        const T* e = reinterpret_cast<const T*>(&val);
#pragma unroll
        for (int i = 0; i < 8; ++i) dst[(c + i) * LT + r] = e[i];
      }
    }
  } else {
    const T zero = from_f<T>(0.f);
    for (int idx = threadIdx.x; idx < 64 * D; idx += THREADS) {
      const int r = idx / D, c = idx % D;
      T val = zero;
      if (r0 + r < nrows && c < d)
        val = base[(long long)(r0 + r) * row_stride + c];
      if (!trans)
        dst[r * pitch + c] = val;
      else
        dst[c * LT + r] = val;
    }
  }
}

// The A fragment of rows [row0, row0 + 16) x columns [k0, k0 + 16) of a
// row-major tile of pitch `pitch`.
template <typename T>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const T* tile,
                                       int pitch, int row0, int k0, int g,
                                       int tig) {
  const T* p = tile + (row0 + g) * pitch + k0 + tig * 2;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * pitch);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * pitch + 8);
}

// acc[j] = A(rows [row0, row0+16) of `a_tile`) . B^T over D, for the 8
// column tiles j of `b_tile` (64 rows, each giving one output column):
// the 16 x 64 share of a 64 x 64 product of two row-major tiles.
template <typename T, int D>
__device__ __forceinline__ void tile_mma(float (&acc)[8][4], const T* a_tile,
                                         const T* b_tile, int pitch,
                                         int row0, int g, int tig) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D; kk += 16) {
    uint32_t a[4];
    frag_a<T>(a, a_tile, pitch, row0, kk, g, tig);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const T* p = b_tile + (j * 8 + g) * pitch + kk + tig * 2;
      mma<T>(acc[j], a, ld32(p), ld32(p + 8));
    }
  }
}

// out[n] += P . B over 64 keys (or queries), P the 16 x 64 score-shaped
// accumulators of this warp (rounded to T), B the transposed D x 64 tile.
template <typename T, int D>
__device__ __forceinline__ void acc_pb(float (&out)[D / 8][4],
                                       const float (&p)[8][4],
                                       const T* bt, int g, int tig) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const uint32_t a[4] = {pack2<T>(p[2 * t][0], p[2 * t][1]),
                           pack2<T>(p[2 * t][2], p[2 * t][3]),
                           pack2<T>(p[2 * t + 1][0], p[2 * t + 1][1]),
                           pack2<T>(p[2 * t + 1][2], p[2 * t + 1][3])};
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const T* q = bt + (n * 8 + g) * LT + t * 16 + tig * 2;
      mma<T>(out[n], a, ld32(q), ld32(q + 8));
    }
  }
}

template <int D>
constexpr size_t mma_fwd_smem() {
  return 2 * ((size_t)2 * 64 * (D + 8) + (size_t)D * LT);
}
template <int D>
constexpr size_t mma_dkv_smem() {
  return 2 * ((size_t)4 * 64 * (D + 8) + (size_t)2 * D * LT) +
         sizeof(float) * 2 * 64;
}
template <int D>
constexpr size_t mma_dq_smem() {
  return 2 * ((size_t)4 * 64 * (D + 8) + (size_t)D * LT) +
         sizeof(float) * 2 * 64;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, T* __restrict__ o,
                         float* __restrict__ lse, int h, int sq, int sk,
                         int d, float scale, int causal, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LQ = D + 8;
  constexpr int DN = D / 8;
  T* Qs = reinterpret_cast<T*>(smem_raw);  // 64 x LQ
  T* Ks = Qs + 64 * LQ;                    // 64 x LQ
  T* Vt = Ks + 64 * LQ;                    // D x LT

  const int bh = blockIdx.y;
  const int nb = bh / h, hh = bh % h;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int row0 = warp * 16;
  const long long row = (long long)h * d;
  const long long qoff = ((long long)nb * sq * h + hh) * d;
  const long long koff = ((long long)nb * sk * h + hh) * d;

  stage<T, D>(Qs, LQ, false, q + qoff, q0, sq, row, d, vec);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  int n_kt = (sk + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    stage<T, D>(Ks, LQ, false, k + koff, k0, sk, row, d, vec);
    stage<T, D>(Vt, LT, true, v + koff, k0, sk, row, d, vec);
    __syncthreads();

    float s[8][4];
    tile_mma<T, D>(s, Qs, Ks, LQ, row0, g, tig);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = q0 + row0 + g + (e >> 1) * 8;
        const int kpos = k0 + j * 8 + tig * 2 + (e & 1);
        float x = s[j][e] * scale;
        if (kpos >= sk)
          x = -INFINITY;
        else if (causal && kpos > qpos)
          x = MASKED;
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float corr[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v2 = mx[r];
      v2 = fmaxf(v2, __shfl_xor_sync(0xffffffffu, v2, 1));
      v2 = fmaxf(v2, __shfl_xor_sync(0xffffffffu, v2, 2));
      const float m_new = fmaxf(m[r], v2);
      corr[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[j][e] - m[e >> 1]);
        s[j][e] = p;
        psum[e >> 1] += p;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float v2 = psum[r];
      v2 += __shfl_xor_sync(0xffffffffu, v2, 1);
      v2 += __shfl_xor_sync(0xffffffffu, v2, 2);
      l[r] = l[r] * corr[r] + v2;
    }
#pragma unroll
    for (int n = 0; n < DN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
    acc_pb<T, D>(acc, s, Vt, g, tig);
  }

  T* ob = o + qoff;
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qpos = q0 + row0 + g + (e >> 1) * 8;
      const int c = n * 8 + tig * 2 + (e & 1);
      if (qpos < sq && c < d)
        ob[(long long)qpos * row + c] = from_f<T>(acc[n][e] / l[e >> 1]);
    }
  if (tig == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = q0 + row0 + g + r * 8;
      if (qpos < sq) lse[(long long)bh * sq + qpos] = m[r] + logf(l[r]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dkv_mma_kernel(const T* __restrict__ q,
                             const T* __restrict__ k,
                             const T* __restrict__ v,
                             const T* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ dvec,
                             T* __restrict__ dk, T* __restrict__ dv, int h,
                             int sq, int sk, int d, float scale, int causal,
                             int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LQ = D + 8;
  constexpr int DN = D / 8;
  T* Ks = reinterpret_cast<T*>(smem_raw);  // 64 x LQ, [key][d]
  T* Vs = Ks + 64 * LQ;                    // 64 x LQ, [key][d]
  T* Qs = Vs + 64 * LQ;                    // 64 x LQ, [query][d]
  T* Gs = Qs + 64 * LQ;                    // 64 x LQ, dO [query][d]
  T* Qt = Gs + 64 * LQ;                    // D x LT, [d][query]
  T* Gt = Qt + D * LT;                     // D x LT, dO [d][query]
  float* lse_s = reinterpret_cast<float*>(Gt + D * LT);
  float* d_s = lse_s + 64;

  const int bh = blockIdx.y;
  const int nb = bh / h, hh = bh % h;
  const int k0 = blockIdx.x * BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int row0 = warp * 16;  // this warp's keys within the tile
  const long long row = (long long)h * d;
  const long long qoff = ((long long)nb * sq * h + hh) * d;
  const long long koff = ((long long)nb * sk * h + hh) * d;

  stage<T, D>(Ks, LQ, false, k + koff, k0, sk, row, d, vec);
  stage<T, D>(Vs, LQ, false, v + koff, k0, sk, row, d, vec);

  float dk_acc[DN][4], dv_acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  const int n_qt = (sq + BQ - 1) / BQ;
  for (int qt = causal ? k0 / BQ : 0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ;
    __syncthreads();
    stage<T, D>(Qs, LQ, false, q + qoff, q0, sq, row, d, vec);
    stage<T, D>(Gs, LQ, false, dout + qoff, q0, sq, row, d, vec);
    stage<T, D>(Qt, LT, true, q + qoff, q0, sq, row, d, vec);
    stage<T, D>(Gt, LT, true, dout + qoff, q0, sq, row, d, vec);
    load_stats(lse_s, d_s, lse, dvec, (long long)bh * sq, q0, sq);
    __syncthreads();

    float p[8][4], ds[8][4];
    tile_mma<T, D>(p, Ks, Qs, LQ, row0, g, tig);   // S^T[key][query]
    tile_mma<T, D>(ds, Vs, Gs, LQ, row0, g, tig);  // dP^T[key][query]
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + row0 + g + (e >> 1) * 8;
        const int qc = j * 8 + tig * 2 + (e & 1), qpos = q0 + qc;
        float pv = 0.f;
        if (qpos < sq && kpos < sk && !(causal && kpos > qpos))
          pv = expf(p[j][e] * scale - lse_s[qc]);
        p[j][e] = pv;
        ds[j][e] = pv * (ds[j][e] - d_s[qc]);
      }
    acc_pb<T, D>(dv_acc, p, Gt, g, tig);   // dV += round(P)^T dO
    acc_pb<T, D>(dk_acc, ds, Qt, g, tig);  // dK += dS^T Q
  }

#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int kpos = k0 + row0 + g + (e >> 1) * 8;
      const int c = n * 8 + tig * 2 + (e & 1);
      if (kpos < sk && c < d) {
        const long long at = koff + (long long)kpos * row + c;
        dk[at] = from_f<T>(dk_acc[n][e] * scale);
        dv[at] = from_f<T>(dv_acc[n][e]);
      }
    }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_mma_kernel(const T* __restrict__ q,
                            const T* __restrict__ k,
                            const T* __restrict__ v,
                            const T* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ dvec,
                            T* __restrict__ dq, int h, int sq, int sk, int d,
                            float scale, int causal, int vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int LQ = D + 8;
  constexpr int DN = D / 8;
  T* Qs = reinterpret_cast<T*>(smem_raw);  // 64 x LQ, [query][d]
  T* Gs = Qs + 64 * LQ;                    // 64 x LQ, dO [query][d]
  T* Ks = Gs + 64 * LQ;                    // 64 x LQ, [key][d]
  T* Vs = Ks + 64 * LQ;                    // 64 x LQ, [key][d]
  T* Kt = Vs + 64 * LQ;                    // D x LT, [d][key]
  float* lse_s = reinterpret_cast<float*>(Kt + D * LT);
  float* d_s = lse_s + 64;

  const int bh = blockIdx.y;
  const int nb = bh / h, hh = bh % h;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tig = lane & 3;
  const int row0 = warp * 16;
  const long long row = (long long)h * d;
  const long long qoff = ((long long)nb * sq * h + hh) * d;
  const long long koff = ((long long)nb * sk * h + hh) * d;

  stage<T, D>(Qs, LQ, false, q + qoff, q0, sq, row, d, vec);
  stage<T, D>(Gs, LQ, false, dout + qoff, q0, sq, row, d, vec);
  load_stats(lse_s, d_s, lse, dvec, (long long)bh * sq, q0, sq);

  float dq_acc[DN][4];
#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq_acc[n][e] = 0.f;

  int n_kt = (sk + BK - 1) / BK;
  if (causal) n_kt = min(n_kt, (q0 + BQ - 1) / BK + 1);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();
    stage<T, D>(Ks, LQ, false, k + koff, k0, sk, row, d, vec);
    stage<T, D>(Vs, LQ, false, v + koff, k0, sk, row, d, vec);
    stage<T, D>(Kt, LT, true, k + koff, k0, sk, row, d, vec);
    __syncthreads();

    float s[8][4], ds[8][4];
    tile_mma<T, D>(s, Qs, Ks, LQ, row0, g, tig);   // S[query][key]
    tile_mma<T, D>(ds, Gs, Vs, LQ, row0, g, tig);  // dP[query][key]
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qr = row0 + g + (e >> 1) * 8, qpos = q0 + qr;
        const int kpos = k0 + j * 8 + tig * 2 + (e & 1);
        float dsv = 0.f;
        if (qpos < sq && kpos < sk && !(causal && kpos > qpos))
          dsv = expf(s[j][e] * scale - lse_s[qr]) * (ds[j][e] - d_s[qr]);
        ds[j][e] = dsv;
      }
    acc_pb<T, D>(dq_acc, ds, Kt, g, tig);  // dQ += dS K
  }

#pragma unroll
  for (int n = 0; n < DN; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int qpos = q0 + row0 + g + (e >> 1) * 8;
      const int c = n * 8 + tig * 2 + (e & 1);
      if (qpos < sq && c < d)
        dq[qoff + (long long)qpos * row + c] =
            from_f<T>(dq_acc[n][e] * scale);
    }
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

template <typename T, int D>
cudaError_t launch_fwd_mma(const void* q, const void* k, const void* v,
                           void* o, void* lse, int n, int h, int sq, int sk,
                           int d, float scale, int causal, cudaStream_t s) {
  auto kern = flash_fwd_mma_kernel<T, D>;
  const size_t smem = mma_fwd_smem<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int vec = d % 8 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v);
  dim3 grid((sq + BQ - 1) / BQ, n * h);
  kern<<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      h, sq, sk, d, scale, causal, vec);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd_mma(const void* q, const void* k, const void* v,
                           const void* o, const void* lse, const void* dout,
                           void* dq, void* dk, void* dv, void* dvec, int n,
                           int h, int sq, int sk, int d, float scale,
                           int causal, cudaStream_t s) {
  const long long rows = (long long)n * sq * h;
  const int per_block = 8;  // warps
  flash_bwd_dot_kernel<T><<<(unsigned)((rows + per_block - 1) / per_block),
                            32 * per_block, 0, s>>>(
      static_cast<const T*>(o), static_cast<const T*>(dout),
      static_cast<float*>(dvec), rows, h, sq, d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int vec = d % 8 == 0 && aligned16(q) && aligned16(k) &&
                  aligned16(v) && aligned16(dout);

  auto dkv = flash_bwd_dkv_mma_kernel<T, D>;
  err = cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)mma_dkv_smem<D>());
  if (err != cudaSuccess) return err;
  dkv<<<dim3((sk + BK - 1) / BK, n * h), THREADS, mma_dkv_smem<D>(), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dvec),
      static_cast<T*>(dk), static_cast<T*>(dv), h, sq, sk, d, scale, causal,
      vec);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  auto dqk = flash_bwd_dq_mma_kernel<T, D>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)mma_dq_smem<D>());
  if (err != cudaSuccess) return err;
  dqk<<<dim3((sq + BQ - 1) / BQ, n * h), THREADS, mma_dq_smem<D>(), s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dvec),
      static_cast<T*>(dq), h, sq, sk, d, scale, causal, vec);
  return cudaGetLastError();
}

// float32 runs the scalar kernels (full float32 products); bf16 and f16
// the tensor-core kernels
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
    if (d <= 64)
      return launch_fwd_mma<T, 64>(q, k, v, o, lse, n, h, sq, sk, d, scale,
                                   causal, s);
    return launch_fwd_mma<T, 128>(q, k, v, o, lse, n, h, sq, sk, d, scale,
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
    if (d <= 64)
      return launch_bwd_mma<T, 64>(q, k, v, o, lse, dout, dq, dk, dv, dvec,
                                   n, h, sq, sk, d, scale, causal, s);
    return launch_bwd_mma<T, 128>(q, k, v, o, lse, dout, dq, dk, dv, dvec,
                                  n, h, sq, sk, d, scale, causal, s);
  }
}

}  // namespace

// Forward.  q (n, sq, h, d), k and v (n, sk, h, d), o (n, sq, h, d), all
// contiguous and of one dtype (0 float32, 1 bfloat16, 2 float16); lse
// (n, h, sq) float32.  1 <= d <= 128, sq, sk >= 1.  Launches on `stream`
// of `device` and returns cudaGetLastError() (0 on success).
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
// gradient of o (n, sq, h, d, contiguous, o's dtype); writes dq, dk and dv
// (the shapes and dtype of q, k and v).  dvec is a float32 scratch of
// n * h * sq elements.  The three kernels run in order on `stream`.
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
