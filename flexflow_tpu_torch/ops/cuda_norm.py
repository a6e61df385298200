"""Fused LayerNorm(+residual): the CUDA kernel's wrapper, its plain
version and the autograd function around them.

Counterpart of ``flexflow_tpu/ops/pallas_norm.py::fused_layernorm``.  The
kernel is in ``csrc/fused_layernorm.cu``; its source note gives the
design and the memory bound.  The JAX package has no backward kernel
here (its VJP differentiates the plain math), so neither has the port:
:class:`FusedLayerNorm` recomputes its gradient through
:func:`fused_layernorm_reference`.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import kernels

MAX_D = 14336   # four rows of d floats fit the kernel's shared memory


def fused_layernorm_reference(x: torch.Tensor, res: Optional[torch.Tensor],
                              scale: torch.Tensor, bias: torch.Tensor,
                              eps: float) -> torch.Tensor:
    """The plain version, ``_ln_reference``'s math: promote to float32,
    add ``res``, mean and population variance (ddof 0) over the last
    axis, ``rsqrt(var + eps)``, scale and bias; a float32 result."""
    xf = x.to(torch.float32)
    if res is not None:
        xf = xf + res.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return y * scale + bias


def fused_layernorm(x: torch.Tensor, res: Optional[torch.Tensor],
                    scale: torch.Tensor, bias: torch.Tensor,
                    eps: float) -> torch.Tensor:
    """LayerNorm(x [+ res]) * scale + bias over the last axis, float32
    out.  A CUDA ``x`` launches the kernel (f32, bf16 or f16 ``x`` and
    ``res`` of one dtype, float32 ``scale``/``bias``) or raises; a CPU
    ``x`` takes :func:`fused_layernorm_reference`.
    ``fused_layernorm.launches`` counts the kernel launches."""
    if x.device.type == "cpu":
        return fused_layernorm_reference(x, res, scale, bias, eps)
    if x.device.type != "cuda":
        raise ValueError(f"fused_layernorm: unsupported device {x.device}")
    code = kernels.DTYPE_CODES.get(x.dtype)
    if code is None:
        raise TypeError(f"fused_layernorm kernel takes float32, bfloat16 or "
                        f"float16, got {x.dtype}")
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"fused_layernorm: want a non-empty tensor, got "
                         f"shape {tuple(x.shape)}")
    d = x.shape[-1]
    if d > MAX_D:
        raise ValueError(f"fused_layernorm kernel takes rows of at most "
                         f"{MAX_D} elements, got {d}")
    if res is not None and (res.shape != x.shape or res.dtype != x.dtype
                            or res.device != x.device):
        raise ValueError(f"residual {tuple(res.shape)} {res.dtype} does "
                         f"not match x {tuple(x.shape)} {x.dtype}")
    for name, t in (("scale", scale), ("bias", bias)):
        if (tuple(t.shape) != (d,) or t.dtype != torch.float32
                or t.device != x.device):
            raise ValueError(f"fused_layernorm: {name} must be float32 "
                             f"({d},) on {x.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    x = x.contiguous()
    res = res.contiguous() if res is not None else None
    scale, bias = scale.contiguous(), bias.contiguous()
    y = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _library().ff_fused_layernorm(
        x.data_ptr(), res.data_ptr() if res is not None else None,
        scale.data_ptr(), bias.data_ptr(), y.data_ptr(), code,
        x.numel() // d, d, float(eps), x.device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"fused_layernorm kernel launch failed: CUDA "
                           f"error {err}")
    fused_layernorm.launches += 1
    return y


fused_layernorm.launches = 0


def layernorm_float64(x: torch.Tensor, res: Optional[torch.Tensor],
                      scale: torch.Tensor, bias: torch.Tensor,
                      eps: float) -> torch.Tensor:
    """The same function in float64, rounded to float32 at the end: the
    yardstick both the kernel and the plain version are measured
    against, since they reduce in other orders."""
    f64 = torch.float64
    xf = x.to(f64) + (res.to(f64) if res is not None else 0.0)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) / torch.sqrt(var + eps) * scale.to(f64) + bias.to(f64)
    return y.to(torch.float32)


def ulp_distance(y: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest difference between two float32 tensors in units of
    the last place of max(|ref|, 1) over the whole tensor.  The scale is
    the tensor's and not each element's: y = t * scale + bias rounds
    intermediates as large as the largest outputs, so an output that
    cancels to near 0 keeps errors of that size."""
    mag = max(float(ref.abs().max()), 1.0)
    spacing = 2.0 ** (math.floor(math.log2(mag)) - 23)
    return float((y - ref).abs().max()) / spacing


class FusedLayerNorm(torch.autograd.Function):
    """The kernel forward; the backward differentiates the plain version
    (the JAX package's ``_fused_bwd``)."""

    @staticmethod
    def forward(ctx, x, res, scale, bias, eps):
        ctx.eps = eps
        ctx.has_res = res is not None
        ctx.save_for_backward(x, res if res is not None else x, scale, bias)
        return fused_layernorm(x, res, scale, bias, eps)

    @staticmethod
    def backward(ctx, g):
        x, res, scale, bias = ctx.saved_tensors
        args = (x, res if ctx.has_res else None, scale, bias)
        leaves = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(args, ctx.needs_input_grad[:4])]
        wanted = [t for t in leaves if t is not None and t.requires_grad]
        if not wanted:
            return None, None, None, None, None
        with torch.enable_grad():
            y = fused_layernorm_reference(*leaves, ctx.eps)
        grads = iter(torch.autograd.grad(y, wanted, g))
        return (*[next(grads) if t is not None and t.requires_grad
                  else None for t in leaves], None)


def fused_layernorm_autograd(x: torch.Tensor, res: Optional[torch.Tensor],
                             scale: torch.Tensor, bias: torch.Tensor,
                             eps: float) -> torch.Tensor:
    """:func:`fused_layernorm` that autograd can differentiate.  When no
    gradient is wanted it is the plain call and saves nothing."""
    wants = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, res, scale, bias))
    if wants:
        return FusedLayerNorm.apply(x, res, scale, bias, float(eps))
    return fused_layernorm(x, res, scale, bias, eps)


def _library() -> ctypes.CDLL:
    lib = kernels.load("fused_layernorm")
    fn = lib.ff_fused_layernorm
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5
                       + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                          ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    return lib
