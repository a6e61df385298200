"""NHWC max pool, forward and backward: the CUDA kernels' wrappers, their
plain versions and the autograd function that pairs them.

Counterpart of ``flexflow_tpu/ops/pallas_pool.py::pallas_max_pool_nhwc``
and its VJP ``_pool_bwd``.  Both kernels are in ``csrc/max_pool_nhwc.cu``;
its source note gives the designs and the memory bounds.

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
from typing import Iterator, Tuple

import torch
import torch.nn.functional as F

from .. import kernels


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
    """Pad NCHW ``x`` with the dtype's lowest value and take
    ``torch.maximum`` over the k*k strided window views in row-major
    order — the Pallas kernel's max tree.  Returns (padded x, y)."""
    n, c, h, w = x.shape
    oh, ow = out_hw(h, w, kernel, stride, padding)
    if oh <= 0 or ow <= 0:
        raise ValueError(f"pool window {kernel} does not fit a "
                         f"{h}x{w} input with padding {padding}")
    ph, pw = padding
    xp = F.pad(x, (pw, pw, ph, ph), value=pad_value(x.dtype))
    y = None
    for win in window_slices(xp, kernel, stride, (oh, ow)):
        y = win if y is None else torch.maximum(y, win)
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
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _library().ff_max_pool_nhwc(
        x.data_ptr(), y.data_ptr(), code, n, h, w, c, oh, ow, kh, kw, sh,
        sw, ph, pw, x.device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"max_pool_nhwc kernel launch failed: CUDA "
                           f"error {err}")
    max_pool_nhwc.launches += 1
    return y


max_pool_nhwc.launches = 0


def max_pool_nhwc_backward(x: torch.Tensor, g: torch.Tensor, kernel,
                           stride, padding) -> torch.Tensor:
    """Gradient of :func:`max_pool_nhwc` with respect to ``x``, given the
    gradient ``g`` of its output.

    CUDA tensors launch the backward kernel (two passes: each window's
    argmax into an int16 scratch, then the ordered gather) or raise; CPU
    tensors take :func:`max_pool_nhwc_backward_reference`.  ``g`` may
    come in any memory format (the gradient that flows back through a
    reshape is NCHW-contiguous): it is made channels-last here.  The
    result is channels-last.  ``max_pool_nhwc_backward.launches`` counts
    the kernel launches."""
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
    if kh * kw > 32767:
        raise ValueError(f"max_pool_nhwc_backward kernel keeps window "
                         f"offsets in int16; a {kh}x{kw} window is too big")
    g = g.contiguous(memory_format=torch.channels_last)
    dx = torch.empty_like(x, memory_format=torch.channels_last)
    if dx.numel() == 0:
        return dx
    # each window's argmax offset, written by the kernel's first pass
    arg = torch.empty_like(g, dtype=torch.int16,
                           memory_format=torch.channels_last)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _library().ff_max_pool_nhwc_bwd(
        x.data_ptr(), g.data_ptr(), dx.data_ptr(), arg.data_ptr(), code, n,
        h, w, c, oh, ow, kh, kw, sh, sw, ph, pw, x.device.index or 0,
        stream)
    if err != 0:
        raise RuntimeError(f"max_pool_nhwc_backward kernel launch failed: "
                           f"CUDA error {err}")
    max_pool_nhwc_backward.launches += 1
    return dx


max_pool_nhwc_backward.launches = 0


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
        # them, both functions are declared
        for fn, n_ptr in ((lib.ff_max_pool_nhwc_bwd, 4),
                          (lib.ff_max_pool_nhwc, 2)):
            fn.restype = ctypes.c_int
            fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 14
                           + [ctypes.c_void_p])
    return lib
