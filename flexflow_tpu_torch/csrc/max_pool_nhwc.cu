// NHWC max-pool forward and backward for Hopper (sm_90a).
//
// Layout: x is (N, H, W, C) with C fastest — torch.channels_last memory
// under the logical NCHW shape — and so are y, g and dx.  Every access
// moves VEC neighbouring channels of one pixel at once, VEC * sizeof(T)
// bytes: VEC is a template parameter (8, 4, 2 or 1 for bf16/f16; 4, 2 or
// 1 for f32) that the wrapper picks as the widest for which C is a
// multiple of VEC and every pointer is aligned to VEC * sizeof(T), so
// AlexNet's pools move 16 bytes a thread and an odd C or an unaligned
// view takes a narrower instance of the same kernel.  The selection and
// the arithmetic are done per lane, exactly as the scalar code did.
//
// Index math is 32-bit: every division, and a pixel's place in a row; a
// row's offset is 64-bit, made once per row, so an image or a tensor of
// 2^31 elements or more is taken.
//
// Semantics (both kernels bit-equal to the plain PyTorch versions in
// ops/cuda_pool.py, in f32, bf16 and f16): a window at (oh*sh - ph,
// ow*sw - pw) is walked row-major; positions in the padding count as the
// dtype's finite minimum (finfo(dtype).min, as the Pallas kernel pads);
// the running max takes a position when it is NaN or strictly larger, and
// keeps a NaN once it has one (jnp.maximum semantics; fmaxf would drop
// it), so the selected position is the FIRST row-major position equal to
// the max, -0.0 equal to +0.0, and a zero max keeps the sign of the
// first zero.  The output size uses floor arithmetic; trailing rows and
// columns that no window covers are never read.
//
// Forward.  Replaces the TPU kernel
// flexflow_tpu/ops/pallas_pool.py::_fwd_kernel (reached through
// pallas_max_pool_nhwc).  Bound: memory — read x once, write y once: for
// AlexNet's three 3x3/s2 pools in bf16 at batch 64, 31.7, 22.1 and
// 6.7 MB, 18.0 us at the H100 SXM's 3.35 TB/s.  Design: the grid runs
// over (n * oh output rows) x (runs of kFwdRun output pixels, channel
// vectors), channel vectors fastest, so a warp reads whole pixels with
// 16-byte loads; the divisions that split a thread's index are made
// once per thread (the grid's y dimension splits the images into chunks
// whose threads an int counts).  A thread loads the input columns of its
// run's windows once per window row, up to kFwdCols at a time so that
// their loads are in flight together, and updates every window that
// covers a column, so a column that neighbouring windows share (for
// 3x3/s2, a window's last column is the next one's first) is loaded
// once.  The strict walk is taken two lanes a word for bf16/f16 (see
// "Packed lanes" below): the kernel was first latency-bound (one load
// in flight a thread) and then bound by the instruction count of
// lane-by-lane float compares.
//
// Backward.  Replaces the TPU kernel
// flexflow_tpu/ops/pallas_pool.py::_bwd_kernel (reached through _pool_bwd,
// the VJP of pallas_max_pool_nhwc).  It computes what that kernel
// computes: dx[n, h, w, c] is the sum of g[n, oh, ow, c] over the windows
// (oh, ow) whose first row-major position equal to the window's max is
// (h, w).  A window whose max is NaN routes no gradient, and one whose
// max lies in the padding routes its gradient there, where it is dropped.
// Positions no window covers get 0.
//
// Bound: memory — read x once, read g once, write dx once: 57.35, 39.99
// and 12.26 MB for AlexNet's three pools in bf16 at batch 64, 32.7 us.
// Design: one launch, one fused pass per tile, nothing in device memory
// but x, g and dx (the Pallas kernel's own design: "HBM sees exactly one
// read of x/g and one write of dx").  A block owns a tile (image n, a
// band of band_rows input rows by band_cols input columns, a slice of
// chan_vecs channel vectors):
//  1. it stages into shared memory, with cp.async, the input pixels that
//     the windows covering its tile read (the halo of the edge windows
//     included; padding is written as finfo.min) and those windows' g;
//  2. it finds each window's first-match argmax in shared memory, a
//     row-major window offset i * kw + j per lane (-1 when the max is
//     NaN), kept in shared memory as int8 when kh * kw <= 127, else as
//     int16;
//  3. it gathers dx for its own pixels: for each window offset (i, j) that
//     puts the element inside a window, in ascending (i, j), it adds the
//     window's g when the window's argmax is (i, j), in the storage type,
//     rounded after every add, acc = T(float(acc) + float(g)).  The
//     Pallas kernel accumulates each stride phase in g's dtype in that
//     same order (every contribution to one input position lands in the
//     same phase plane), so dx is bit-equal to the plain version in bf16
//     and f16 as well as f32.  It stores dx with VEC-wide stores.
// A window on a tile's edge is staged and solved by both neighbouring
// blocks: a little compute and an L2 read of the halo, no extra
// device-memory traffic when the neighbours run together.  The wrapper
// sizes the tile (cuda_pool.backward_plan: 48 KB of shared memory, four
// blocks an SM; a band spans whole rows unless they do not fit or make
// too few blocks to fill the card; a window too large for 48 KB takes up
// to the card's 227 KB, a narrower VEC past that, and the window path
// below past that) and passes
// its shared-memory size, which the launch checks against
// tile_smem_bytes.  Each block is chan_vecs * (224 / chan_vecs) threads,
// a thread keeping one channel vector across the passes, and each pass
// walks its plane of pixels as `walk` says, so no pass divides per
// element and narrow rows leave no lane idle.  A 3x3 window (the zoo's
// pools) is compiled in (K = 3): its loops unroll and their
// shared-memory loads go out together.  No atomics: every dx element has
// one owner.
//
// Backward for large windows (the window path).  A tile stages every
// input pixel that the windows covering it read: about (2k - 1)^2 pixels
// for a k x k window at stride 1, so past about 120 x 120 in f32 (170 x
// 170 in bf16/f16) not even a tile of one pixel and one channel fits the
// card's 227 KB, and past 32767 window positions the int16 offsets
// overflow.  The JAX package trains such windows through XLA's
// reduce_window.  Here they take two launches with no shared memory,
// chosen by shape on the host (cuda_pool.backward_route):
//  1. argmax: one thread per (image, output pixel, channel vector) scans
//     its window row-major from device memory with the rule above and
//     writes each lane's offset i * kw + j (-1 for a NaN max) as int32 to
//     a scratch tensor shaped like g, which the wrapper allocates.  A run
//     of padding holds one value, so only its first position can take the
//     max: a window row outside the image costs one compare, not kw.
//  2. gather: one thread per (image, input pixel, channel vector) walks
//     the windows that cover its pixel in ascending (i, j) and adds g
//     where the window's offset is its own, rounding in the storage type
//     after every add (GradSum, as the tiled pass does): bit-equal to the
//     plain version in f32, bf16 and f16.
// Bound: memory, as the tiled pass (read x and g, write dx), plus the
// scratch (4 bytes per element of g, written and read once); no model of
// the zoo has such a window, so this path was made right and simple, not
// fast.  Chunking a window through shared memory would keep the scratch
// out of device memory but needs a running max carried across chunks and
// a second walk for the gather; two plain launches were taken instead.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_pipeline.h>
#include <float.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#include <algorithm>
#include <type_traits>

namespace {

// output pixels one forward thread computes along a row, and the input
// columns it loads together (a 3x3/s2 run reads 7)
constexpr int kFwdRun = 3;
constexpr int kFwdCols = 7;
// threads of a forward block, and at most of a backward block: 224
// threads of 72 registers leave room for 4 backward blocks an SM
constexpr int kThreads = 256;
constexpr int kBwdThreads = 224;

struct Geom {
  int n, h, w, c, oh, ow, kh, kw, sh, sw, ph, pw;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }

// float -> storage type, round to nearest even (as torch rounds the
// result of a bf16 or f16 add); exact for a value of the storage type
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
// the bits of finfo(dtype).min and of -inf of a 16-bit type
template <typename T> __host__ __device__ constexpr uint32_t lowest_bits() {
  return std::is_same<T, __half>::value ? 0xFBFFu : 0xFF7Fu;
}
template <typename T> __host__ __device__ constexpr uint32_t neg_inf_bits() {
  return std::is_same<T, __half>::value ? 0xFC00u : 0xFF80u;
}

// VEC neighbouring channels of one pixel: one access of VEC * sizeof(E)
// bytes
template <typename E, int VEC>
struct alignas(sizeof(E) * VEC) Vec {
  E v[VEC];
};

// The running max of one lane: take v when it is NaN or strictly larger,
// and never leave a NaN.  Started at -inf, the first position always
// wins (a -inf there keeps the same bits).
__device__ __forceinline__ bool takes(float best, float v) {
  return !isnan(best) && (isnan(v) || v > best);
}

// Packed lanes.  For bf16 and f16 at VEC >= 2 both kernels work on
// 32-bit words: two lanes a word for values (the bf16x2/f16x2 compare,
// max that keeps NaN and add instructions) and, in the backward with
// int8 offsets, four a word for offsets (byte-wise compares): far fewer
// instructions than the lane-by-lane float code, which the kernels run
// otherwise.  A bf16x2/f16x2 add rounds the exact sum once,
// which equals torch's float add rounded to the storage type: two values
// of a 16-bit type whose exponents differ by more than the float
// mantissa allows for an exact sum differ so much that the smaller
// cannot move the larger to a rounding midpoint.
template <typename T> struct Pair;
template <> struct Pair<__nv_bfloat16> { using type = __nv_bfloat162; };
template <> struct Pair<__half> { using type = __half2; };

template <typename T>
__device__ __forceinline__ typename Pair<T>::type as_pair(uint32_t u) {
  typename Pair<T>::type p;
  memcpy(&p, &u, 4);
  return p;
}
template <typename P> __device__ __forceinline__ uint32_t as_word(P p) {
  uint32_t u;
  memcpy(&u, &p, 4);
  return u;
}
// NaN if either lane is NaN, else the larger (the sign of a zero is not
// used: the argmax compares with ==)
template <typename T>
__device__ __forceinline__ uint32_t max2_nan(uint32_t a, uint32_t b) {
  return as_word(__hmax2_nan(as_pair<T>(a), as_pair<T>(b)));
}
// The running max of two lanes: each lane of `best` becomes the NaN-
// keeping max of best and v unless that equals best as a float, so a
// lane changes where takes() would take v (v NaN or larger, best not
// NaN) and on a tie, -0.0 and +0.0 included, keeps its own bits (the
// bf16x2/f16x2 max may return either zero)
template <typename T>
__device__ __forceinline__ uint32_t take2(uint32_t best, uint32_t v) {
  const uint32_t m = max2_nan<T>(best, v);
  const uint32_t keep = __heq2_mask(as_pair<T>(m), as_pair<T>(best));
  return (best & keep) | (m & ~keep);
}
// 0xffff in each lane where a == b as floats (-0.0 == +0.0, NaN != NaN)
template <typename T>
__device__ __forceinline__ uint32_t eq2_mask(uint32_t a, uint32_t b) {
  return __heq2_mask(as_pair<T>(a), as_pair<T>(b));
}
template <typename T>
__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  return as_word(__hadd2(as_pair<T>(a), as_pair<T>(b)));
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 1)
    max_pool_nhwc_kernel(const T* __restrict__ x, T* __restrict__ y,
                         Geom g, int runs, int chunk) {
  // thread -> (image of the chunk blockIdx.y, output row, run of kFwdRun
  // pixels, channel vector): four divisions per thread, none per element
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int cvn = g.c / VEC;
  const int per_row = runs * cvn;
  const int n0 = blockIdx.y * chunk;
  if (idx >= min(chunk, g.n - n0) * g.oh * per_row) return;
  const int row = idx / per_row;
  const int rest = idx - row * per_row;
  const int run = rest / cvn;
  const int cv = rest - run * cvn;
  const int img = row / g.oh;
  const int ni = n0 + img;
  const int ohi = row - img * g.oh;
  const T* xn = x + (int64_t)ni * g.h * g.w * g.c + cv * VEC;
  const int ow0 = run * kFwdRun;
  T* yp = y + (((int64_t)ni * g.oh + ohi) * g.ow + ow0) * g.c + cv * VEC;
  const int nv = min(kFwdRun, g.ow - ow0);  // outputs of this run
  const int h0 = ohi * g.sh - g.ph;
  const int w0 = ow0 * g.sw - g.pw;
  const int ncols = (nv - 1) * g.sw + g.kw;  // input columns they read

  // bf16/f16 at VEC >= 2: two lanes a word (take2); otherwise lane by
  // lane in float
  constexpr bool kPacked = sizeof(T) == 2 && VEC >= 2;
  constexpr int W = kPacked ? VEC / 2 : VEC;  // words or lanes
  using Word = typename std::conditional<kPacked, uint32_t, float>::type;
  using U = Vec<Word, W>;
  Word pad, neg;  // finfo.min and -inf, per word or lane
  if constexpr (kPacked) {
    pad = lowest_bits<T>() * 0x10001u;
    neg = neg_inf_bits<T>() * 0x10001u;
  } else {
    pad = to_float(lowest<T>());
    neg = -INFINITY;
  }
  U best[kFwdRun];
#pragma unroll
  for (int u = 0; u < kFwdRun; ++u)
#pragma unroll
    for (int k = 0; k < W; ++k) best[u].v[k] = neg;

  for (int i = 0; i < g.kh; ++i) {
    const int hi = h0 + i;
    const bool row_in = hi >= 0 && hi < g.h;
    const T* xr = xn + (row_in ? (int64_t)hi * g.w * g.c : 0);
    for (int q0 = 0; q0 < ncols; q0 += kFwdCols) {
      // up to kFwdCols columns of the row loaded together, so their
      // loads are in flight at once
      U p[kFwdCols];
#pragma unroll
      for (int t = 0; t < kFwdCols; ++t) {
        const int wi = w0 + q0 + t;
        if (row_in && q0 + t < ncols && wi >= 0 && wi < g.w) {
          if constexpr (kPacked) {
            p[t] = *reinterpret_cast<const U*>(xr + (int64_t)wi * g.c);
          } else {
            const Vec<T, VEC> v = *reinterpret_cast<const Vec<T, VEC>*>(
                xr + (int64_t)wi * g.c);
#pragma unroll
            for (int l = 0; l < VEC; ++l) p[t].v[l] = to_float(v.v[l]);
          }
        } else {
#pragma unroll
          for (int k = 0; k < W; ++k) p[t].v[k] = pad;
        }
      }
#pragma unroll
      for (int t = 0; t < kFwdCols; ++t) {
        const int q = q0 + t;
        // window u of the run has column q at offset j = q - u * sw
#pragma unroll
        for (int u = 0; u < kFwdRun; ++u) {
          if (q < ncols && u < nv &&
              (unsigned)(q - u * g.sw) < (unsigned)g.kw) {
#pragma unroll
            for (int k = 0; k < W; ++k) {
              if constexpr (kPacked) {
                best[u].v[k] = take2<T>(best[u].v[k], p[t].v[k]);
              } else if (takes(best[u].v[k], p[t].v[k])) {
                best[u].v[k] = p[t].v[k];
              }
            }
          }
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < kFwdRun; ++u) {
    if (u < nv) {
      if constexpr (kPacked) {
        *reinterpret_cast<U*>(yp + u * g.c) = best[u];
      } else {
        Vec<T, VEC> o;
#pragma unroll
        for (int l = 0; l < VEC; ++l) o.v[l] = from_float<T>(best[u].v[l]);
        *reinterpret_cast<Vec<T, VEC>*>(yp + u * g.c) = o;
      }
    }
  }
}

__host__ __device__ __forceinline__ size_t align16(size_t b) {
  return (b + 15) / 16 * 16;
}

__host__ __device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

// The backward's tile: band_rows input rows by band_cols input columns
// by chan_vecs channel vectors; bands * col_bands * slices tiles an
// image.  max_wr and max_wc bound the window rows and columns that cover
// a tile, so the shared-memory carve-up is the same in every block.
struct Tile {
  int band_rows, band_cols, chan_vecs, bands, col_bands, slices, max_wr,
      max_wc;
};

// windows o of `out` along one axis with o * s in an interval of
// band + k - 2 positions: those that cover a band of `band` positions
__host__ __device__ __forceinline__ int tile_windows(int band, int k, int s,
                                                     int out) {
  const int nw = (band + k - 2) / s + 1;
  return nw < out ? nw : out;
}

// Shared memory of one block, in bytes: staged x, staged g, argmax
// offsets (A each).  ops/cuda_pool.py::backward_smem_bytes is the same
// formula; the launch refuses a size the wrapper computed otherwise.
template <typename T>
__host__ __device__ __forceinline__ size_t tile_x_bytes(const Geom& g,
                                                        const Tile& t,
                                                        int vec) {
  const int rows = (t.max_wr - 1) * g.sh + g.kh;
  const int cols = (t.max_wc - 1) * g.sw + g.kw;
  return align16((size_t)rows * cols * t.chan_vecs * vec * sizeof(T));
}
template <typename T>
__host__ __device__ __forceinline__ size_t tile_g_bytes(const Geom& g,
                                                        const Tile& t,
                                                        int vec) {
  return align16((size_t)t.max_wr * t.max_wc * t.chan_vecs * vec *
                 sizeof(T));
}
template <typename T, typename A>
size_t tile_smem_bytes(const Geom& g, const Tile& t, int vec) {
  return tile_x_bytes<T>(g, t, vec) + tile_g_bytes<T>(g, t, vec) +
         (size_t)t.max_wr * t.max_wc * t.chan_vecs * vec * sizeof(A);
}

// The windows along one axis that cover input positions [a0, a1): lo ..
// lo + n - 1, which read input positions x0 .. x0 + len - 1.
struct Span {
  int lo, n, x0, len;
};

__device__ __forceinline__ Span covering(int a0, int a1, int k, int s,
                                         int p, int out) {
  Span sp;
  sp.lo = max(0, floor_div(a0 + p - k + s, s));
  sp.n = max(0, min(out - 1, (a1 - 1 + p) / s) - sp.lo + 1);
  sp.x0 = sp.lo * s - p;
  sp.len = sp.n > 0 ? (sp.n - 1) * s + k : 0;
  return sp;
}

// One VEC-wide element from device memory into shared memory, in flight
// until async_wait_all(); a 2-byte element (VEC 1 of bf16/f16), which
// cp.async does not take, is copied directly.
template <int BYTES>
__device__ __forceinline__ void copy_to_shared(void* dst, const void* src) {
  if constexpr (BYTES >= 4) {
    __pipeline_memcpy_async(dst, src, BYTES);
  } else {
    *static_cast<uint16_t*>(dst) = *static_cast<const uint16_t*>(src);
  }
}

__device__ __forceinline__ void async_wait_all() {
  __pipeline_commit();
  __pipeline_wait_prior(0);
}

// The argmax offsets of VEC lanes as (VEC + 3) / 4 words of bytes.
template <int VEC>
__device__ __forceinline__ void load_offsets(const int8_t* p,
                                             uint32_t (&w)[(VEC + 3) / 4]) {
  if constexpr (VEC >= 4) {
    const Vec<uint32_t, VEC / 4> v =
        *reinterpret_cast<const Vec<uint32_t, VEC / 4>*>(p);
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) w[i] = v.v[i];
  } else {
    w[0] = *reinterpret_cast<const uint16_t*>(p);
  }
}
template <int VEC>
__device__ __forceinline__ void store_offsets(
    int8_t* p, const uint32_t (&w)[(VEC + 3) / 4]) {
  if constexpr (VEC >= 4) {
    Vec<uint32_t, VEC / 4> v;
#pragma unroll
    for (int i = 0; i < VEC / 4; ++i) v.v[i] = w[i];
    *reinterpret_cast<Vec<uint32_t, VEC / 4>*>(p) = v;
  } else {
    *reinterpret_cast<uint16_t*>(p) = (uint16_t)w[0];
  }
}

// Window argmax of one channel vector: `win` is the window's first
// position in shared memory, `step` the distance between two columns,
// `row_step` between two rows.  With the window known at compile time
// (K x K) the loops unroll and the loads go out together; K = 0 keeps
// them as loops over kh and kw.
// Writes each lane's first row-major offset equal to the lane's max, -1
// where the max is NaN.
template <typename T, int VEC, typename A, int K>
__device__ __forceinline__ void window_argmax(const T* win, int step,
                                              int row_step, int kh, int kw,
                                              A* out) {
  using V = Vec<T, VEC>;
  if constexpr (sizeof(T) == 2 && VEC >= 2 && sizeof(A) == 1) {
    constexpr int W = VEC / 2, AW = (VEC + 3) / 4;
    using U = Vec<uint32_t, W>;
    // the max of each lane, NaN winning
    U m = *reinterpret_cast<const U*>(win);
#pragma unroll (K > 0 ? K : 1)
    for (int i = 0; i < kh; ++i)
#pragma unroll (K > 0 ? K : 1)
      for (int j = (i == 0); j < kw; ++j) {
        const U v = *reinterpret_cast<const U*>(win + i * row_step +
                                                j * step);
#pragma unroll
        for (int k = 0; k < W; ++k) m.v[k] = max2_nan<T>(m.v[k], v.v[k]);
      }
    // the first position equal to it: walk backwards, the last match wins
    uint32_t arg[AW];
#pragma unroll
    for (int a = 0; a < AW; ++a) arg[a] = 0xffffffffu;
#pragma unroll (K > 0 ? K : 1)
    for (int i = kh - 1; i >= 0; --i)
#pragma unroll (K > 0 ? K : 1)
      for (int j = kw - 1; j >= 0; --j) {
        const U v = *reinterpret_cast<const U*>(win + i * row_step +
                                                j * step);
        const uint32_t kk = (uint32_t)(i * kw + j) * 0x01010101u;
#pragma unroll
        for (int a = 0; a < AW; ++a) {
          // lanes 4a .. 4a + 3: one byte each from two lane-pair masks
          const uint32_t e0 = eq2_mask<T>(v.v[2 * a], m.v[2 * a]);
          const uint32_t e1 =
              2 * a + 1 < W ? eq2_mask<T>(v.v[2 * a + 1], m.v[2 * a + 1]) : 0u;
          const uint32_t eb = __byte_perm(e0, e1, 0x6420);
          arg[a] = (arg[a] & ~eb) | (kk & eb);
        }
      }
    store_offsets<VEC>(reinterpret_cast<int8_t*>(out), arg);
  } else {
    float best[VEC];
    int arg[VEC];
#pragma unroll
    for (int l = 0; l < VEC; ++l) {
      best[l] = -INFINITY;
      arg[l] = 0;
    }
#pragma unroll (K > 0 ? K : 1)
    for (int i = 0; i < kh; ++i) {
#pragma unroll (K > 0 ? K : 1)
      for (int j = 0; j < kw; ++j) {
        const V p =
            *reinterpret_cast<const V*>(win + i * row_step + j * step);
        const int k = i * kw + j;
#pragma unroll
        for (int l = 0; l < VEC; ++l) {
          const float v = to_float(p.v[l]);
          if (takes(best[l], v)) {
            best[l] = v;
            arg[l] = k;
          }
        }
      }
    }
    Vec<A, VEC> o;
#pragma unroll
    for (int l = 0; l < VEC; ++l) o.v[l] = (A)(isnan(best[l]) ? -1 : arg[l]);
    *reinterpret_cast<Vec<A, VEC>*>(out) = o;
  }
}

// The accumulator of one dx vector: add g's lanes whose window argmax
// is offset k, in the storage type, rounding after every add.
template <typename T, int VEC, typename A>
struct GradSum {
  static constexpr bool kPacked =
      sizeof(T) == 2 && VEC >= 2 && sizeof(A) == 1;
  // packed: VEC / 2 words of two lanes; else one float per lane
  uint32_t w[kPacked ? VEC / 2 : 1];
  float f[kPacked ? 1 : VEC];

  __device__ __forceinline__ GradSum() {
#pragma unroll
    for (int i = 0; i < (kPacked ? VEC / 2 : 1); ++i) w[i] = 0u;
#pragma unroll
    for (int i = 0; i < (kPacked ? 1 : VEC); ++i) f[i] = 0.0f;
  }

  __device__ __forceinline__ void add(const A* a, const T* g, int k) {
    if constexpr (kPacked) {
      constexpr int AW = (VEC + 3) / 4;
      uint32_t aw[AW];
      load_offsets<VEC>(reinterpret_cast<const int8_t*>(a), aw);
      const Vec<uint32_t, VEC / 2> gv =
          *reinterpret_cast<const Vec<uint32_t, VEC / 2>*>(g);
      const uint32_t kk = (uint32_t)k * 0x01010101u;
#pragma unroll
      for (int q = 0; q < AW; ++q) {
        const uint32_t eq = __vcmpeq4(aw[q], kk);  // 0xff per match
        // the byte masks of lanes 4q .. 4q + 3 widened to 16 bits
        w[2 * q] = add2<T>(w[2 * q], gv.v[2 * q] & __byte_perm(eq, 0, 0x1100));
        if (2 * q + 1 < VEC / 2)
          w[2 * q + 1] = add2<T>(w[2 * q + 1],
                                 gv.v[2 * q + 1] & __byte_perm(eq, 0, 0x3322));
      }
    } else {
      const Vec<A, VEC> av = *reinterpret_cast<const Vec<A, VEC>*>(a);
      const Vec<T, VEC> gv = *reinterpret_cast<const Vec<T, VEC>*>(g);
#pragma unroll
      for (int l = 0; l < VEC; ++l)
        if (av.v[l] == k)
          f[l] = to_float(from_float<T>(f[l] + to_float(gv.v[l])));
    }
  }

  __device__ __forceinline__ void store(T* dst) const {
    if constexpr (kPacked) {
      Vec<uint32_t, VEC / 2> o;
#pragma unroll
      for (int i = 0; i < VEC / 2; ++i) o.v[i] = w[i];
      *reinterpret_cast<Vec<uint32_t, VEC / 2>*>(dst) = o;
    } else {
      Vec<T, VEC> o;
#pragma unroll
      for (int l = 0; l < VEC; ++l) o.v[l] = from_float<T>(f[l]);
      *reinterpret_cast<Vec<T, VEC>*>(dst) = o;
    }
  }
};

// How a thread walks a rows x cols plane of pixels with px pixel lanes:
// rows r0, r0 + dr, ... and columns c0, c0 + dc, ...  A plane at least px
// wide is walked row by row, px columns apart; a narrower one takes
// px / cols rows at once, a thread keeping its column, so no lane idles
// for want of columns.  Lanes past the last whole row get column `cols`,
// that is, nothing; so does every lane of a plane with no columns.
struct Walk {
  int r0, dr, c0, dc;
};

__device__ __forceinline__ Walk walk(int p0, int px, int cols) {
  if (cols <= 0) return {0, 1, 0, 1};
  if (cols >= px) return {0, 1, p0, px};
  const int rows = px / cols, r = p0 / cols;
  if (r >= rows) return {0, rows, cols, cols};
  return {r, rows, p0 - r * cols, cols};
}

// K > 0: the window is K x K, known at compile time; K = 0: g's kh x kw.
// Four blocks an SM: ptxas then gives the unrolled 3x3 gather up to 72
// registers (at 256 threads it caps them at 64 and spills).
template <typename T, int VEC, typename A, int K>
__global__ void __launch_bounds__(kBwdThreads, 4)
    max_pool_nhwc_bwd_kernel(const T* __restrict__ x,
                             const T* __restrict__ gr, T* __restrict__ dx,
                             Geom g, Tile t) {
  using V = Vec<T, VEC>;
  const int kh = K ? K : g.kh, kw = K ? K : g.kw;
  extern __shared__ __align__(16) unsigned char smem[];
  const int cs = t.chan_vecs;
  T* xs = reinterpret_cast<T*>(smem);
  T* gs = reinterpret_cast<T*>(smem + tile_x_bytes<T>(g, t, VEC));
  A* as = reinterpret_cast<A*>(smem + tile_x_bytes<T>(g, t, VEC) +
                               tile_g_bytes<T>(g, t, VEC));

  // block -> (image, channel slice, band of columns, band of rows)
  int b = blockIdx.x;
  const int band = b % t.bands;
  b /= t.bands;
  const int cband = b % t.col_bands;
  b /= t.col_bands;
  const int slice = b % t.slices;
  const int ni = b / t.slices;
  const int h0 = band * t.band_rows, h1 = min(h0 + t.band_rows, g.h);
  const int w0 = cband * t.band_cols, w1 = min(w0 + t.band_cols, g.w);
  // the windows that cover the tile's pixels, by rows and by columns;
  // the staged x is rw.len rows of cl.len pixels, g and the argmax
  // offsets rw.n rows of cl.n windows
  Span rw = covering(h0, h1, g.kh, g.sh, g.ph, g.oh);
  Span cl = covering(w0, w1, g.kw, g.sw, g.pw, g.ow);
  if (rw.n == 0 || cl.n == 0) rw.n = rw.len = cl.n = cl.len = 0;

  // a thread keeps one channel vector; px pixel lanes share a pass
  const int cv = threadIdx.x % cs;
  const int p0 = threadIdx.x / cs;
  const int px = blockDim.x / cs;
  const int cvg = slice * cs + cv;  // channel vector in the tensor
  const bool active = cvg * VEC < g.c;
  const int64_t row_x = (int64_t)g.w * g.c;  // elements of an x row
  const int64_t row_g = (int64_t)g.ow * g.c;
  const T* xn = x + (int64_t)ni * g.h * row_x + cvg * VEC;

  // 1. stage x (padding as finfo.min) and g
  if (active) {
    V padv;
#pragma unroll
    for (int l = 0; l < VEC; ++l) padv.v[l] = lowest<T>();
    const Walk wsx = walk(p0, px, cl.len);
    for (int r = wsx.r0; r < rw.len; r += wsx.dr) {
      const int hx = rw.x0 + r;
      const bool row_in = hx >= 0 && hx < g.h;
      const T* xr = xn + (row_in ? hx * row_x : 0);
      for (int col = wsx.c0; col < cl.len; col += wsx.dc) {
        T* dst = xs + ((r * cl.len + col) * cs + cv) * VEC;
        const int wx = cl.x0 + col;
        if (row_in && wx >= 0 && wx < g.w)
          copy_to_shared<sizeof(V)>(dst, xr + (int64_t)wx * g.c);
        else
          *reinterpret_cast<V*>(dst) = padv;
      }
    }
    const T* gn = gr + (int64_t)ni * g.oh * row_g + cvg * VEC;
    const Walk wg = walk(p0, px, cl.n);
    for (int r = wg.r0; r < rw.n; r += wg.dr) {
      const T* grow = gn + (rw.lo + r) * row_g;
      for (int oc = wg.c0; oc < cl.n; oc += wg.dc)
        copy_to_shared<sizeof(V)>(gs + ((r * cl.n + oc) * cs + cv) * VEC,
                                  grow + (int64_t)(cl.lo + oc) * g.c);
    }
  }
  async_wait_all();
  __syncthreads();

  // 2. each window's first-match argmax, per lane
  if (active) {
    const Walk wa = walk(p0, px, cl.n);
    for (int r = wa.r0; r < rw.n; r += wa.dr)
      for (int oc = wa.c0; oc < cl.n; oc += wa.dc)
        window_argmax<T, VEC, A, K>(
            xs + ((r * g.sh * cl.len + oc * g.sw) * cs + cv) * VEC,
            cs * VEC, cl.len * cs * VEC, kh, kw,
            as + ((r * cl.n + oc) * cs + cv) * VEC);
  }
  __syncthreads();

  // 3. the ordered gather into the tile's dx pixels
  if (active) {
    T* dxn = dx + (int64_t)ni * g.h * row_x + cvg * VEC;
    const Walk wd = walk(p0, px, w1 - w0);
    const int dq = wd.dc / g.sw, dr = wd.dc - dq * g.sw;
    for (int hx = h0 + wd.r0; hx < h1; hx += wd.dr) {
      // the offsets that put this row in a window are i = hp % sh,
      // hp % sh + sh, ..., in window rows hp / sh, hp / sh - 1, ...
      // (likewise for columns): ascending (i, j), the Pallas order
      const int hp = hx + g.ph;
      const int i0 = hp % g.sh, oh0 = hp / g.sh;
      const int wp = w0 + wd.c0 + g.pw;
      int j0 = wp % g.sw, ow0 = wp / g.sw;
      T* dxr = dxn + hx * row_x;
      for (int wx = w0 + wd.c0; wx < w1; wx += wd.dc) {
        GradSum<T, VEC, A> acc;
        // at most kh (kw) steps: bounded loops that unroll when K > 0;
        // a window that covers the pixel is one of the tile's
#pragma unroll (K > 0 ? K : 1)
        for (int ti = 0; ti < kh; ++ti) {
          const int i = i0 + ti * g.sh, ohi = oh0 - ti;
          if (i >= kh || ohi < 0) break;
          if (ohi >= g.oh) continue;
          const int rbase = (ohi - rw.lo) * cl.n - cl.lo;
#pragma unroll (K > 0 ? K : 1)
          for (int tj = 0; tj < kw; ++tj) {
            const int j = j0 + tj * g.sw, owi = ow0 - tj;
            if (j >= kw || owi < 0) break;
            if (owi >= g.ow) continue;
            const int o = ((rbase + owi) * cs + cv) * VEC;
            acc.add(as + o, gs + o, i * kw + j);
          }
        }
        acc.store(dxr + (int64_t)wx * g.c);
        j0 += dr;
        ow0 += dq;
        if (j0 >= g.sw) {
          j0 -= g.sw;
          ++ow0;
        }
      }
    }
  }
}

// One lane of the window path's argmax: take v at offset k by the rule
// of takes().
__device__ __forceinline__ void take_at(float& best, int& arg, float v,
                                        int k) {
  if (takes(best, v)) {
    best = v;
    arg = k;
  }
}

// The window path's argmax: thread -> (image of the chunk blockIdx.y,
// output pixel, channel vector).  arg is shaped like g.  Both window
// kernels name one block an SM as their floor: under a bare
// __launch_bounds__(kThreads) ptxas capped several instances at 40 to 64
// registers and spilled.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 1)
    max_pool_nhwc_window_argmax_kernel(const T* __restrict__ x,
                                       int32_t* __restrict__ arg, Geom g,
                                       int chunk) {
  using V = Vec<T, VEC>;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int cvn = g.c / VEC;
  const int per_image = g.oh * g.ow * cvn;
  const int n0 = blockIdx.y * chunk;
  if (idx >= min(chunk, g.n - n0) * per_image) return;
  const int img = idx / per_image;
  const int rest = idx - img * per_image;
  const int pix = rest / cvn;
  const int cv = rest - pix * cvn;
  const int ohi = pix / g.ow, owi = pix - ohi * g.ow;
  const int ni = n0 + img;
  const int h0 = ohi * g.sh - g.ph, w0 = owi * g.sw - g.pw;
  // the window's columns inside the image: j in [jlo, jhi)
  const int jlo = max(0, -w0), jhi = min(g.kw, g.w - w0);
  const T* xn = x + (int64_t)ni * g.h * g.w * g.c + cv * VEC;
  const float pad = to_float(lowest<T>());
  float best[VEC];
  int a[VEC];
#pragma unroll
  for (int l = 0; l < VEC; ++l) {
    best[l] = -INFINITY;
    a[l] = 0;
  }
  for (int i = 0; i < g.kh; ++i) {
    const int hi = h0 + i, k0 = i * g.kw;
    if (hi < 0 || hi >= g.h || jlo >= jhi) {  // a row of padding
#pragma unroll
      for (int l = 0; l < VEC; ++l) take_at(best[l], a[l], pad, k0);
      continue;
    }
    if (jlo > 0) {  // padding before the image's columns
#pragma unroll
      for (int l = 0; l < VEC; ++l) take_at(best[l], a[l], pad, k0);
    }
    const T* xr = xn + ((int64_t)hi * g.w + w0) * g.c;
    int j = jlo;
    // four columns loaded together, so their loads are in flight at once
    for (; j + 4 <= jhi; j += 4) {
      V v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u)
        v[u] = *reinterpret_cast<const V*>(xr + (int64_t)(j + u) * g.c);
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int l = 0; l < VEC; ++l)
          take_at(best[l], a[l], to_float(v[u].v[l]), k0 + j + u);
    }
    for (; j < jhi; ++j) {
      const V v = *reinterpret_cast<const V*>(xr + (int64_t)j * g.c);
#pragma unroll
      for (int l = 0; l < VEC; ++l)
        take_at(best[l], a[l], to_float(v.v[l]), k0 + j);
    }
    if (jhi < g.kw) {  // padding after them
#pragma unroll
      for (int l = 0; l < VEC; ++l) take_at(best[l], a[l], pad, k0 + jhi);
    }
  }
  Vec<int32_t, VEC> o;
#pragma unroll
  for (int l = 0; l < VEC; ++l) o.v[l] = isnan(best[l]) ? -1 : a[l];
  *reinterpret_cast<Vec<int32_t, VEC>*>(
      arg + (((int64_t)ni * g.oh + ohi) * g.ow + owi) * g.c + cv * VEC) = o;
}

// The window path's gather: thread -> (image of the chunk blockIdx.y,
// input pixel, channel vector).
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 1)
    max_pool_nhwc_window_gather_kernel(const int32_t* __restrict__ arg,
                                       const T* __restrict__ gr,
                                       T* __restrict__ dx, Geom g,
                                       int chunk) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  const int cvn = g.c / VEC;
  const int per_image = g.h * g.w * cvn;
  const int n0 = blockIdx.y * chunk;
  if (idx >= min(chunk, g.n - n0) * per_image) return;
  const int img = idx / per_image;
  const int rest = idx - img * per_image;
  const int pix = rest / cvn;
  const int cv = rest - pix * cvn;
  const int hx = pix / g.w, wx = pix - hx * g.w;
  const int ni = n0 + img;
  // the windows that cover the pixel: rows oh0 .. oh1, columns ow0 .. ow1;
  // a higher window row or column puts it at a lower offset i or j, so
  // both walk down for ascending (i, j), the Pallas order
  const int hp = hx + g.ph, wp = wx + g.pw;
  const int oh1 = min(hp / g.sh, g.oh - 1);
  const int oh0 = max(0, floor_div(hp - g.kh + g.sh, g.sh));
  const int ow1 = min(wp / g.sw, g.ow - 1);
  const int ow0 = max(0, floor_div(wp - g.kw + g.sw, g.sw));
  const int64_t gn = (int64_t)ni * g.oh * g.ow * g.c + cv * VEC;
  GradSum<T, VEC, int32_t> acc;
  for (int ohi = oh1; ohi >= oh0; --ohi) {
    const int ki = (hp - ohi * g.sh) * g.kw;  // i * kw
    const int64_t row = gn + (int64_t)ohi * g.ow * g.c;
    for (int owi = ow1; owi >= ow0; --owi) {
      const int64_t o = row + (int64_t)owi * g.c;
      acc.add(arg + o, gr + o, ki + (wp - owi * g.sw));
    }
  }
  acc.store(dx + ((int64_t)ni * g.h * g.w + pix) * g.c + cv * VEC);
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// A grid of kThreads-thread blocks over n images of per_image threads
// each: the grid's y dimension walks chunks of images that an int counts.
cudaError_t image_grid(int64_t per_image, int n, dim3* grid, int* chunk) {
  if (per_image > 2147483647) return cudaErrorInvalidValue;
  *chunk = (int)std::min<int64_t>(n, 2147483647 / per_image);
  const int chunks = (n + *chunk - 1) / *chunk;
  if (chunks > 65535) return cudaErrorInvalidConfiguration;
  *grid = dim3(
      (unsigned)(((int64_t)*chunk * per_image + kThreads - 1) / kThreads),
      (unsigned)chunks);
  return cudaSuccess;
}

template <typename T, int VEC>
cudaError_t launch_fwd(const void* x, void* y, const Geom& g,
                       cudaStream_t stream) {
  if (g.c % VEC || !aligned(x, VEC * sizeof(T)) ||
      !aligned(y, VEC * sizeof(T)))
    return cudaErrorInvalidValue;
  const int runs = (g.ow + kFwdRun - 1) / kFwdRun;
  dim3 grid;
  int chunk;
  const cudaError_t err =
      image_grid((int64_t)g.oh * runs * (g.c / VEC), g.n, &grid, &chunk);
  if (err != cudaSuccess) return err;
  max_pool_nhwc_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), g, runs, chunk);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_window(const void* x, const void* gr, void* dx,
                          void* arg, const Geom& g, cudaStream_t stream) {
  const size_t vb = VEC * sizeof(T);
  // window offsets must fit the int32 scratch
  if (g.c % VEC || !aligned(x, vb) || !aligned(gr, vb) || !aligned(dx, vb) ||
      !aligned(arg, VEC * sizeof(int32_t)) ||
      (int64_t)g.kh * g.kw > 2147483647)
    return cudaErrorInvalidValue;
  dim3 grid;
  int chunk;
  cudaError_t err =
      image_grid((int64_t)g.oh * g.ow * (g.c / VEC), g.n, &grid, &chunk);
  if (err != cudaSuccess) return err;
  max_pool_nhwc_window_argmax_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<int32_t*>(arg), g, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  err = image_grid((int64_t)g.h * g.w * (g.c / VEC), g.n, &grid, &chunk);
  if (err != cudaSuccess) return err;
  max_pool_nhwc_window_gather_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(arg), static_cast<const T*>(gr),
      static_cast<T*>(dx), g, chunk);
  return cudaGetLastError();
}

template <typename T, int VEC, typename A, int K>
cudaError_t launch_bwd_as(const void* x, const void* gr, void* dx,
                          const Geom& g, int band_rows, int band_cols,
                          int chan_vecs, int smem_bytes,
                          cudaStream_t stream) {
  const size_t vb = VEC * sizeof(T);
  const int cvn = g.c / VEC;
  if (g.c % VEC || !aligned(x, vb) || !aligned(gr, vb) ||
      !aligned(dx, vb) || band_rows < 1 || band_cols < 1 ||
      chan_vecs < 1 || chan_vecs > kBwdThreads)
    return cudaErrorInvalidValue;
  Tile t;
  t.band_rows = band_rows;
  t.band_cols = band_cols;
  t.chan_vecs = chan_vecs < cvn ? chan_vecs : cvn;
  t.bands = (g.h + band_rows - 1) / band_rows;
  t.col_bands = (g.w + band_cols - 1) / band_cols;
  t.slices = (cvn + t.chan_vecs - 1) / t.chan_vecs;
  t.max_wr = tile_windows(band_rows, g.kh, g.sh, g.oh);
  t.max_wc = tile_windows(band_cols, g.kw, g.sw, g.ow);
  const int64_t blocks = (int64_t)g.n * t.bands * t.col_bands * t.slices;
  if (blocks > 2147483647) return cudaErrorInvalidConfiguration;
  const size_t smem = tile_smem_bytes<T, A>(g, t, VEC);
  if (smem != (size_t)smem_bytes) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      max_pool_nhwc_bwd_kernel<T, VEC, A, K>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int threads = t.chan_vecs * (kBwdThreads / t.chan_vecs);
  max_pool_nhwc_bwd_kernel<T, VEC, A, K><<<(unsigned)blocks, threads, smem,
                                        stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(gr),
      static_cast<T*>(dx), g, t);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t launch_bwd(const void* x, const void* gr, void* dx,
                       const Geom& g, const int (&tile)[4],
                       cudaStream_t stream) {
  // 3x3 windows (the zoo's pools) with their size compiled in; window
  // offsets as int8 while they fit, -1 marking a NaN max
  if (g.kh == 3 && g.kw == 3)
    return launch_bwd_as<T, VEC, int8_t, 3>(x, gr, dx, g, tile[0], tile[1],
                                            tile[2], tile[3], stream);
  if (g.kh * g.kw <= 127)
    return launch_bwd_as<T, VEC, int8_t, 0>(x, gr, dx, g, tile[0], tile[1],
                                            tile[2], tile[3], stream);
  if (g.kh * g.kw <= 32767)
    return launch_bwd_as<T, VEC, int16_t, 0>(x, gr, dx, g, tile[0], tile[1],
                                             tile[2], tile[3], stream);
  return cudaErrorInvalidValue;
}

// The same kernel template at VEC = vec (16 bytes at most).
template <typename T>
cudaError_t fwd_vec(int vec, const void* x, void* y, const Geom& g,
                    cudaStream_t s) {
  switch (vec) {
    case 1: return launch_fwd<T, 1>(x, y, g, s);
    case 2: return launch_fwd<T, 2>(x, y, g, s);
    case 4: return launch_fwd<T, 4>(x, y, g, s);
    case 8:
      if constexpr (sizeof(T) == 2) return launch_fwd<T, 8>(x, y, g, s);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t bwd_vec(int vec, const void* x, const void* gr, void* dx,
                    const Geom& g, const int (&tile)[4], cudaStream_t s) {
  switch (vec) {
    case 1: return launch_bwd<T, 1>(x, gr, dx, g, tile, s);
    case 2: return launch_bwd<T, 2>(x, gr, dx, g, tile, s);
    case 4: return launch_bwd<T, 4>(x, gr, dx, g, tile, s);
    case 8:
      if constexpr (sizeof(T) == 2)
        return launch_bwd<T, 8>(x, gr, dx, g, tile, s);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

template <typename T>
cudaError_t window_vec(int vec, const void* x, const void* gr, void* dx,
                       void* arg, const Geom& g, cudaStream_t s) {
  switch (vec) {
    case 1: return launch_window<T, 1>(x, gr, dx, arg, g, s);
    case 2: return launch_window<T, 2>(x, gr, dx, arg, g, s);
    case 4: return launch_window<T, 4>(x, gr, dx, arg, g, s);
    case 8:
      if constexpr (sizeof(T) == 2)
        return launch_window<T, 8>(x, gr, dx, arg, g, s);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16; vec: channels per
// access (8, 4, 2 or 1, at most 16 bytes), which must divide c and align
// every pointer.  Launches on `stream` (a cudaStream_t) on device
// `device`, allocates nothing, does not synchronise, and returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue, without a
// launch, for arguments the kernel does not take).
extern "C" int ff_max_pool_nhwc(const void* x, void* y, int dtype, int vec,
                                int n, int h, int w, int c, int oh, int ow,
                                int kh, int kw, int sh, int sw, int ph,
                                int pw, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geom g{n, h, w, c, oh, ow, kh, kw, sh, sw, ph, pw};
  switch (dtype) {
    case 0: return (int)fwd_vec<float>(vec, x, y, g, s);
    case 1: return (int)fwd_vec<__nv_bfloat16>(vec, x, y, g, s);
    case 2: return (int)fwd_vec<__half>(vec, x, y, g, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The backward, in one launch: x is the forward's input, g the gradient
// of its output (both NHWC, same dtype code), dx the gradient of x (NHWC,
// written in full).  band_rows, band_cols and chan_vecs size a block's
// tile and smem_bytes is its shared memory
// (ops/cuda_pool.py::backward_plan), which must equal tile_smem_bytes
// and fit the device.  Same conventions as ff_max_pool_nhwc.
extern "C" int ff_max_pool_nhwc_bwd(const void* x, const void* g, void* dx,
                                    int dtype, int vec, int band_rows,
                                    int band_cols, int chan_vecs,
                                    int smem_bytes, int n, int h, int w,
                                    int c, int oh, int ow, int kh, int kw,
                                    int sh, int sw, int ph, int pw,
                                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geom geo{n, h, w, c, oh, ow, kh, kw, sh, sw, ph, pw};
  const int tile[4] = {band_rows, band_cols, chan_vecs, smem_bytes};
  switch (dtype) {
    case 0: return (int)bwd_vec<float>(vec, x, g, dx, geo, tile, s);
    case 1: return (int)bwd_vec<__nv_bfloat16>(vec, x, g, dx, geo, tile, s);
    case 2: return (int)bwd_vec<__half>(vec, x, g, dx, geo, tile, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The backward for windows no tile holds, in two launches (the window
// path): arg is an int32 scratch shaped like g (NHWC), written by the
// first launch and read by the second.  Same conventions as
// ff_max_pool_nhwc.
extern "C" int ff_max_pool_nhwc_bwd_window(const void* x, const void* g,
                                           void* dx, void* arg, int dtype,
                                           int vec, int n, int h, int w,
                                           int c, int oh, int ow, int kh,
                                           int kw, int sh, int sw, int ph,
                                           int pw, int device,
                                           void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Geom geo{n, h, w, c, oh, ow, kh, kw, sh, sw, ph, pw};
  switch (dtype) {
    case 0: return (int)window_vec<float>(vec, x, g, dx, arg, geo, s);
    case 1:
      return (int)window_vec<__nv_bfloat16>(vec, x, g, dx, arg, geo, s);
    case 2: return (int)window_vec<__half>(vec, x, g, dx, arg, geo, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
