"""NHWC max pool, forward and backward: the CUDA kernels' wrappers, their
plain versions and the autograd function that pairs them.

Counterpart of ``flexflow_tpu/ops/pallas_pool.py::pallas_max_pool_nhwc``
and its VJP ``_pool_bwd``.  Both kernels are in ``csrc/max_pool_nhwc.cu``;
its source note gives the designs and the memory bounds.  The forward
reads 16-byte channel vectors and walks each thread's run of windows
column by column; the backward is one launch of one fused tile pass
(stage x and g in shared memory, find each window's argmax there, gather
dx), with no scratch in device memory, or, for a window that no tile
holds, the window path: an argmax launch into an int32 scratch and a
gather launch.  The choices made on the host are plain functions here:
:func:`vector_width` (channels per access, from C, the dtype and the
pointers' alignment), :func:`backward_plan` (the backward's tile: a band
of rows and columns and a channel slice) and :func:`backward_route`
(the tile or the window path).

Every function takes and returns logical NCHW tensors.  The kernels read
NHWC, which torch spells as ``torch.channels_last`` memory format under
the NCHW shape, so the CUDA path requires a channels-last input and
returns a channels-last output.  Semantics follow the Pallas kernels:
padding counts as ``finfo(dtype).min``, a NaN in a window propagates,
the output size uses floor arithmetic, and the gradient of a window goes
to its first row-major position equal to the max (none when the max is
NaN).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Iterator, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .. import kernels

# the widest access of the kernels: 16 bytes of channels
VECTOR_BYTES = 16
# the backward's tile (see backward_plan): the shared memory a block
# should take (of the budgets 24 to 72 KB, 48 KB gave the shortest time
# for AlexNet's three pools on an H100, four blocks an SM) and the most
# it can take on an H100 (opt-in); the most channel vectors of a slice
# (a block of at most 224 threads keeps at least 7 pixel lanes); the
# least bytes of a pixel a slice reads (two 32-byte sectors); the most
# rows of a band; and the blocks that fill the card (two for each of an
# H100's 132 SMs)
BWD_SMEM_BUDGET = 48 * 1024
BWD_SMEM_MAX = 232448
BWD_MAX_CHAN_VECS = 32
BWD_MIN_PIXEL_BYTES = 64
BWD_MAX_BAND_ROWS = 16
BWD_MIN_BLOCKS = 264
# the most window positions the tiled backward's int16 offsets hold
BWD_TILE_MAX_WINDOW = 32767
_INT32_MAX = 2 ** 31 - 1


def out_hw(h: int, w: int, kernel, stride, padding) -> Tuple[int, int]:
    oh = (h + 2 * padding[0] - kernel[0]) // stride[0] + 1
    ow = (w + 2 * padding[1] - kernel[1]) // stride[1] + 1
    return oh, ow


def pad_value(dtype: torch.dtype):
    """The dtype's lowest finite value — the Pallas kernel's pad."""
    if dtype.is_floating_point:
        return torch.finfo(dtype).min
    return torch.iinfo(dtype).min


def window_slices(xp: torch.Tensor, kernel, stride,
                  out: Tuple[int, int]) -> Iterator[torch.Tensor]:
    """``xp[:, :, i + t*sh, j + u*sw]`` for t < oh, u < ow, one view per
    window offset (i, j) in row-major order, over padded NCHW ``xp``."""
    (kh, kw), (sh, sw), (oh, ow) = kernel, stride, out
    for i in range(kh):
        for j in range(kw):
            yield xp[:, :, i:i + (oh - 1) * sh + 1:sh,
                     j:j + (ow - 1) * sw + 1:sw]


def _padded_max(x: torch.Tensor, kernel, stride, padding):
    """Pad NCHW ``x`` with the dtype's lowest value and walk the k*k
    strided window views in row-major order, taking a view's value where
    it is NaN or larger and the max so far is not NaN: the Pallas
    kernel's max tree (``jnp.maximum``), with the sign of a zero max
    that of the first zero.  Returns (padded x, y)."""
    n, c, h, w = x.shape
    oh, ow = out_hw(h, w, kernel, stride, padding)
    if oh <= 0 or ow <= 0:
        raise ValueError(f"pool window {kernel} does not fit a "
                         f"{h}x{w} input with padding {padding}")
    ph, pw = padding
    xp = F.pad(x, (pw, pw, ph, ph), value=pad_value(x.dtype))
    y = None
    for win in window_slices(xp, kernel, stride, (oh, ow)):
        y = win if y is None else torch.where(
            (win > y) | (torch.isnan(win) & ~torch.isnan(y)), win, y)
    return xp, y


def max_pool_nhwc_reference(x: torch.Tensor, kernel, stride,
                            padding) -> torch.Tensor:
    """The plain version of the forward (see :func:`_padded_max`).
    Accepts any padding (unlike ``F.max_pool2d``) and any dtype."""
    _, y = _padded_max(x, kernel, stride, padding)
    return y.contiguous(memory_format=torch.channels_last)


def max_pool_nhwc_backward_reference(x: torch.Tensor, g: torch.Tensor,
                                     kernel, stride,
                                     padding) -> torch.Tensor:
    """The plain backward, the Pallas ``_bwd_kernel`` in torch ops:
    recompute y over the padded window views, then walk the offsets in
    row-major order with a ``claimed`` mask so each window's gradient
    goes to its first position equal to the max, adding it into a zero,
    padded dx in ``g``'s dtype in that order.  Padding is sliced off at
    the end, so what lands there is dropped."""
    xp, y = _padded_max(x, kernel, stride, padding)
    if g.shape != y.shape:
        raise ValueError(f"gradient shape {tuple(g.shape)} does not match "
                         f"the pool output {tuple(y.shape)}")
    n, c, h, w = x.shape
    oh, ow = y.shape[2:]
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, padding
    dxp = torch.zeros(xp.shape, dtype=g.dtype, device=g.device)
    claimed = torch.zeros(y.shape, dtype=torch.bool, device=y.device)
    zero = torch.zeros((), dtype=g.dtype, device=g.device)
    for k, win in enumerate(window_slices(xp, kernel, stride, (oh, ow))):
        i, j = divmod(k, kw)
        m = (win == y) & ~claimed
        claimed |= m
        dxp[:, :, i:i + (oh - 1) * sh + 1:sh,
            j:j + (ow - 1) * sw + 1:sw] += torch.where(m, g, zero)
    dx = dxp[:, :, ph:ph + h, pw:pw + w]
    return dx.to(x.dtype).contiguous(memory_format=torch.channels_last)


def vector_width(c: int, itemsize: int, *ptrs: int) -> int:
    """Channels per kernel access: the widest of 16 bytes (8 bf16/f16 or
    4 f32), 8, 4, 2 or 1 channels such that ``c`` is a multiple of it and
    every pointer is aligned to its bytes.  Each pixel of a channels-last
    tensor then starts aligned too."""
    vec = VECTOR_BYTES // itemsize
    while vec > 1 and (c % vec
                       or any(p % (vec * itemsize) for p in ptrs)):
        vec //= 2
    return vec


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def _tile_windows(band: int, k: int, s: int, out: int) -> int:
    """The most windows along one axis that cover a band of ``band``
    positions."""
    return min(out, (band + k - 2) // s + 1)


def backward_smem_bytes(band_rows: int, band_cols: int, chan_vecs: int,
                        vec: int, itemsize: int, out: Tuple[int, int],
                        kernel, stride) -> int:
    """Shared memory of one backward block: the x its windows read,
    their g and their int8 (int16 past 127 window positions) argmax
    offsets.  ``csrc/max_pool_nhwc.cu::tile_smem_bytes`` is the same
    formula, and the launch refuses a size that differs from it."""
    (oh, ow), (kh, kw), (sh, sw) = out, kernel, stride
    wr = _tile_windows(band_rows, kh, sh, oh)
    wc = _tile_windows(band_cols, kw, sw, ow)
    chans = chan_vecs * vec
    arg = 1 if kh * kw <= 127 else 2
    return (_align16(((wr - 1) * sh + kh) * ((wc - 1) * sw + kw) * chans
                     * itemsize)
            + _align16(wr * wc * chans * itemsize) + wr * wc * chans * arg)


def _staged(size: int, out: int, band: int, k: int, s: int,
            p: int) -> Tuple[int, int]:
    """Along one axis of ``size`` input positions in bands of ``band``:
    the x positions and the windows that the bands stage, summed (each
    band stages every window that covers it)."""
    x_pos = windows = 0
    for a0 in range(0, size, band):
        a1 = min(a0 + band, size)
        lo = max(0, -(-(a0 + p - k + 1) // s))
        nw = max(0, min(out - 1, (a1 - 1 + p) // s) - lo + 1)
        x_pos += (nw - 1) * s + k if nw else 0
        windows += nw
    return x_pos, windows


def _split_lengths(size: int, step: int):
    """Band lengths that split ``size`` positions into 1, 2, 3, ...
    near-equal bands, each a multiple of ``step``."""
    return sorted({min(size, -(-(-(-size // parts)) // step) * step)
                   for parts in range(1, -(-size // step) + 1)},
                  reverse=True)


class BackwardPlan(NamedTuple):
    vec: int           # channels per access
    band_rows: int     # input rows a block owns
    band_cols: int     # input columns a block owns
    chan_vecs: int     # channel vectors of a block's slice
    smem_bytes: int    # shared memory of a block
    blocks: int        # blocks of the launch


@functools.lru_cache(maxsize=256)
def backward_plan(n: int, c: int, h: int, w: int, kernel, stride,
                  padding, itemsize: int, vec: int) -> BackwardPlan:
    """The backward kernel's tile: a band of input rows (a multiple of
    the row stride, at most ``BWD_MAX_BAND_ROWS``) by a band of columns
    (whole rows, or near-equal parts of a row) by a slice of channel
    vectors (balanced slices of at most ``BWD_MAX_CHAN_VECS``), at
    ``vec`` channels per access or, when no tile of that width fits the
    card's ``BWD_SMEM_MAX``, a narrower one.  Among the tiles that fit,
    it prefers, in order: ``BWD_SMEM_BUDGET`` or less; slices that read
    at least ``BWD_MIN_PIXEL_BYTES`` of a pixel; at least
    ``BWD_MIN_BLOCKS`` blocks (or, when none makes that many, the most);
    whole rows; the fewest x and g positions staged per position of the
    tensors (the halo of the edge windows); then the widest slice, the
    tallest band and the widest band of columns.  Raises ValueError when
    a window is so large that no tile fits the card (such a window takes
    the window path, :func:`backward_route`).  Cached: a training
    step asks for the same few shapes every time."""
    oh, ow = out_hw(h, w, kernel, stride, padding)
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, padding
    top = max(sh, min(-(-h // sh) * sh, BWD_MAX_BAND_ROWS // sh * sh))
    bands = {b: _staged(h, oh, b, kh, sh, ph) for b in range(sh, top + 1, sh)}
    cols = {bc: _staged(w, ow, bc, kw, sw, pw)
            for bc in _split_lengths(w, sw)}
    best = None
    v = vec
    while v >= 1:
        cvn = c // v
        least = min(cvn, max(1, BWD_MIN_PIXEL_BYTES // (v * itemsize)))
        for cv in {-(-cvn // k) for k in range(1, cvn + 1)}:
            if cv > BWD_MAX_CHAN_VECS:
                continue
            for band, (xr, gr) in bands.items():
                for bc, (xc, gc) in cols.items():
                    smem = backward_smem_bytes(band, bc, cv, v, itemsize,
                                               (oh, ow), kernel, stride)
                    if smem > BWD_SMEM_MAX:
                        continue
                    blocks = (n * -(-h // band) * -(-w // bc)
                              * -(-cvn // cv))
                    key = (smem > BWD_SMEM_BUDGET, cv < least,
                           -min(blocks, BWD_MIN_BLOCKS), bc < w,
                           (xr * xc + gr * gc) / (h * w + oh * ow), -cv,
                           -band, -bc)
                    if best is None or key < best[0]:
                        best = (key, BackwardPlan(v, band, bc, cv, smem,
                                                  blocks))
        if best is not None:
            return best[1]
        v //= 2
    raise ValueError(
        f"max_pool_nhwc_backward: no tile of {kernel} windows at stride "
        f"{stride} fits the kernel's {BWD_SMEM_MAX} bytes of shared memory")


class WindowPlan(NamedTuple):
    """The backward's window path, for a window that no tile holds: an
    argmax launch writes each window's offset to an int32 scratch shaped
    like g, then a gather launch builds dx from it."""
    vec: int   # channels per access


@functools.lru_cache(maxsize=256)
def backward_route(n: int, c: int, h: int, w: int, kernel, stride,
                   padding, itemsize: int, vec: int):
    """The backward's route for a CUDA tensor: :func:`backward_plan`'s
    tile, or a :class:`WindowPlan` when the window has more positions
    than the tile's int16 offsets hold (``BWD_TILE_MAX_WINDOW``) or no
    tile of it fits the card's shared memory.  Chosen by shape alone,
    so it runs (and is tested) without a card."""
    if kernel[0] * kernel[1] > BWD_TILE_MAX_WINDOW:
        return WindowPlan(vec)
    try:
        return backward_plan(n, c, h, w, kernel, stride, padding, itemsize,
                             vec)
    except ValueError:   # no tile fits
        return WindowPlan(vec)


def _geometry(fn: str, x: torch.Tensor, kernel, stride, padding):
    """Check what the kernels take; returns (dtype code, (oh, ow))."""
    if x.dim() != 4:
        raise ValueError(f"{fn}: want a 4-D tensor, got shape "
                         f"{tuple(x.shape)}")
    code = kernels.DTYPE_CODES.get(x.dtype)
    if code is None:
        raise TypeError(f"{fn} kernel takes float32, bfloat16 or float16, "
                        f"got {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{fn} kernel needs a channels_last contiguous "
                         f"tensor")
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, padding
    if min(kh, kw, sh, sw) < 1 or min(ph, pw) < 0:
        raise ValueError(f"bad pool geometry kernel={kernel} "
                         f"stride={stride} padding={padding}")
    n, c, h, w = x.shape
    oh, ow = out_hw(h, w, kernel, stride, padding)
    if oh <= 0 or ow <= 0:
        raise ValueError(f"pool window {kernel} does not fit a "
                         f"{h}x{w} input with padding {padding}")
    if max(x.shape) > _INT32_MAX:
        raise ValueError(f"{fn} kernel takes sizes of 32 bits; "
                         f"{tuple(x.shape)} is too large")
    return code, (oh, ow)


def max_pool_nhwc(x: torch.Tensor, kernel, stride,
                  padding) -> torch.Tensor:
    """Max pool of a logical NCHW tensor held channels-last.

    A CUDA tensor launches the kernel (f32, bf16 or f16, channels-last)
    or raises; a CPU tensor takes :func:`max_pool_nhwc_reference`.
    ``max_pool_nhwc.launches`` counts the kernel launches."""
    if x.device.type == "cpu":
        return max_pool_nhwc_reference(x, kernel, stride, padding)
    if x.device.type != "cuda":
        raise ValueError(f"max_pool_nhwc: unsupported device {x.device}")
    code, (oh, ow) = _geometry("max_pool_nhwc", x, kernel, stride, padding)
    n, c, h, w = x.shape
    y = torch.empty((n, c, oh, ow), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    if y.numel() == 0:
        return y
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, padding
    vec = vector_width(c, x.element_size(), x.data_ptr(), y.data_ptr())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _library().ff_max_pool_nhwc(
        x.data_ptr(), y.data_ptr(), code, vec, n, h, w, c, oh, ow, kh, kw,
        sh, sw, ph, pw, x.device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"max_pool_nhwc kernel launch failed: CUDA "
                           f"error {err}")
    max_pool_nhwc.launches += 1
    max_pool_nhwc.last_vec = vec
    return y


max_pool_nhwc.launches = 0
max_pool_nhwc.last_vec = None   # the channels per access of the last launch


def max_pool_nhwc_backward(x: torch.Tensor, g: torch.Tensor, kernel,
                           stride, padding) -> torch.Tensor:
    """Gradient of :func:`max_pool_nhwc` with respect to ``x``, given the
    gradient ``g`` of its output.

    CUDA tensors launch the backward kernels on the route of
    :func:`backward_route` (the tiled kernel, one launch; or the window
    path, two) or raise; CPU tensors take
    :func:`max_pool_nhwc_backward_reference`.  ``g`` may come in any
    memory format (the gradient that flows back through a
    reshape is NCHW-contiguous): it is made channels-last here.  The
    result is channels-last.  ``max_pool_nhwc_backward.launches`` counts
    the calls that launched, ``tile_launches`` and ``window_launches``
    those of each route, and ``last_plan`` holds the last call's route
    (a BackwardPlan or a WindowPlan)."""
    if x.device.type == "cpu" and g.device.type == "cpu":
        return max_pool_nhwc_backward_reference(x, g, kernel, stride,
                                                padding)
    if x.device.type != "cuda" or g.device != x.device:
        raise ValueError(f"max_pool_nhwc_backward: unsupported devices "
                         f"{x.device} and {g.device}")
    code, (oh, ow) = _geometry("max_pool_nhwc_backward", x, kernel, stride,
                               padding)
    n, c, h, w = x.shape
    if tuple(g.shape) != (n, c, oh, ow) or g.dtype != x.dtype:
        raise ValueError(f"gradient {tuple(g.shape)} {g.dtype} does not "
                         f"match the pool output {(n, c, oh, ow)} "
                         f"{x.dtype}")
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, padding
    if kh * kw > _INT32_MAX:
        raise ValueError(f"max_pool_nhwc_backward kernels keep window "
                         f"offsets in int32; a {kh}x{kw} window is too big")
    g = g.contiguous(memory_format=torch.channels_last)
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    if dx.numel() == 0:
        return dx
    plan = backward_route(n, c, h, w, tuple(kernel), tuple(stride),
                          tuple(padding), x.element_size(),
                          vector_width(c, x.element_size(), x.data_ptr(),
                                       g.data_ptr(), dx.data_ptr()))
    dev = x.device.index or 0
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if isinstance(plan, WindowPlan):
        # freed on return: the allocator reuses it only for work queued
        # on this stream after the two launches
        arg = torch.empty((n, oh, ow, c), dtype=torch.int32,
                          device=x.device)
        err = _library().ff_max_pool_nhwc_bwd_window(
            x.data_ptr(), g.data_ptr(), dx.data_ptr(), arg.data_ptr(), code,
            plan.vec, n, h, w, c, oh, ow, kh, kw, sh, sw, ph, pw, dev,
            stream)
    else:
        err = _library().ff_max_pool_nhwc_bwd(
            x.data_ptr(), g.data_ptr(), dx.data_ptr(), code, plan.vec,
            plan.band_rows, plan.band_cols, plan.chan_vecs, plan.smem_bytes,
            n, h, w, c, oh, ow, kh, kw, sh, sw, ph, pw, dev, stream)
    if err != 0:
        raise RuntimeError(f"max_pool_nhwc_backward kernel launch failed: "
                           f"CUDA error {err}")
    max_pool_nhwc_backward.launches += 1
    if isinstance(plan, WindowPlan):
        max_pool_nhwc_backward.window_launches += 1
    else:
        max_pool_nhwc_backward.tile_launches += 1
    max_pool_nhwc_backward.last_plan = plan
    return dx


max_pool_nhwc_backward.launches = 0
max_pool_nhwc_backward.tile_launches = 0
max_pool_nhwc_backward.window_launches = 0
max_pool_nhwc_backward.last_plan = None   # the route of the last launch


class MaxPoolNHWC(torch.autograd.Function):
    """The max pool with the backward kernel as its gradient, the
    counterpart of ``pallas_max_pool_nhwc``'s ``custom_vjp``."""

    @staticmethod
    def forward(ctx, x, kernel, stride, padding):
        ctx.geometry = (kernel, stride, padding)
        ctx.save_for_backward(x)
        return max_pool_nhwc(x, kernel, stride, padding)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return (max_pool_nhwc_backward(x, g.to(x.dtype), *ctx.geometry),
                None, None, None)


def max_pool_nhwc_autograd(x: torch.Tensor, kernel, stride,
                           padding) -> torch.Tensor:
    """:func:`max_pool_nhwc` that autograd can differentiate.  When no
    gradient is wanted (no grad mode, inference mode, or an ``x`` that
    does not require it) it is the plain call and saves nothing."""
    if torch.is_grad_enabled() and x.requires_grad:
        return MaxPoolNHWC.apply(x, tuple(kernel), tuple(stride),
                                 tuple(padding))
    return max_pool_nhwc(x, kernel, stride, padding)


def _library() -> ctypes.CDLL:
    lib = kernels.load("max_pool_nhwc")
    if lib.ff_max_pool_nhwc.argtypes is None:
        # the forward's argtypes are set last: once another thread sees
        # them, every function is declared
        for fn, n_ptr, n_int in ((lib.ff_max_pool_nhwc_bwd_window, 4, 15),
                                 (lib.ff_max_pool_nhwc_bwd, 3, 19),
                                 (lib.ff_max_pool_nhwc, 2, 15)):
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * n_ptr
                           + [ctypes.c_int] * n_int + [ctypes.c_void_p])
    return lib
