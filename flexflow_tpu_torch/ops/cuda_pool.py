"""NHWC max-pool forward: the CUDA kernel's wrapper and its plain version.

Counterpart of ``flexflow_tpu/ops/pallas_pool.py::pallas_max_pool_nhwc``
(forward only; the backward kernel comes with the training slice).  The
kernel is ``csrc/max_pool_nhwc.cu``; its source note gives the design
and the memory bound.

Both functions take and return logical NCHW tensors.  The kernel reads
NHWC, which torch spells as ``torch.channels_last`` memory format under
the NCHW shape, so the CUDA path requires a channels-last input and
returns a channels-last output.  Semantics follow the Pallas kernel:
padding counts as ``finfo(dtype).min``, a NaN in a window propagates,
and the output size uses floor arithmetic.
"""

from __future__ import annotations

import ctypes
from typing import Iterator, Tuple

import torch
import torch.nn.functional as F

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


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


def max_pool_nhwc_reference(x: torch.Tensor, kernel, stride,
                            padding) -> torch.Tensor:
    """The plain version: pad with the dtype's lowest value and take
    ``torch.maximum`` over the k*k strided window views in row-major
    order — the Pallas kernel's max tree.  Accepts any padding (unlike
    ``F.max_pool2d``) and any dtype."""
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
    return y.contiguous(memory_format=torch.channels_last)


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
    if x.dim() != 4:
        raise ValueError(f"max_pool_nhwc: want a 4-D tensor, got shape "
                         f"{tuple(x.shape)}")
    code = _DTYPE_CODES.get(x.dtype)
    if code is None:
        raise TypeError(f"max_pool_nhwc kernel takes float32, bfloat16 "
                        f"or float16, got {x.dtype}")
    if not x.is_contiguous(memory_format=torch.channels_last):
        raise ValueError("max_pool_nhwc kernel needs a channels_last "
                         "contiguous tensor")
    n, c, h, w = x.shape
    (kh, kw), (sh, sw), (ph, pw) = kernel, stride, padding
    if min(kh, kw, sh, sw) < 1 or min(ph, pw) < 0:
        raise ValueError(f"bad pool geometry kernel={kernel} "
                         f"stride={stride} padding={padding}")
    oh, ow = out_hw(h, w, kernel, stride, padding)
    if oh <= 0 or ow <= 0:
        raise ValueError(f"pool window {kernel} does not fit a "
                         f"{h}x{w} input with padding {padding}")
    y = torch.empty((n, c, oh, ow), dtype=x.dtype, device=x.device,
                    memory_format=torch.channels_last)
    if y.numel() == 0:
        return y
    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.ff_max_pool_nhwc(
        x.data_ptr(), y.data_ptr(), code, n, h, w, c, oh, ow, kh, kw, sh,
        sw, ph, pw, x.device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"max_pool_nhwc kernel launch failed: CUDA "
                           f"error {err}")
    max_pool_nhwc.launches += 1
    return y


max_pool_nhwc.launches = 0


def _library() -> ctypes.CDLL:
    from .. import kernels

    lib = kernels.load("max_pool_nhwc")
    fn = lib.ff_max_pool_nhwc
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p]
                       + [ctypes.c_int] * 14 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib
