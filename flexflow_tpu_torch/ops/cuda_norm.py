"""Fused LayerNorm(+residual): the CUDA kernel's wrapper, its launch plan,
its plain version and the autograd function around them.

Counterpart of ``flexflow_tpu/ops/pallas_norm.py::fused_layernorm``.  The
kernel is in ``csrc/fused_layernorm.cu``; its source note gives the
design, the plan's rule and the memory bound.  The JAX package has no
backward kernel here (its VJP differentiates the plain math), so neither
has the port: :class:`FusedLayerNorm` recomputes its gradient through
:func:`fused_layernorm_reference`.

``out_dtype`` is float32 (the TPU kernel's contract) or x's own dtype:
the kernel then rounds each float32 result once to nearest even, as
``Tensor.to`` does, so the narrow output equals the float32 one cast,
bit for bit, and a bf16 LayerNorm op is one launch with no cast after it.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from .. import kernels
from ..parallel.sharding import refuse_dtensor

MAX_D = 14336        # rows up to this width fit MAX_THREADS x MAX_VALUES
MAX_VALUES = 32      # float32 values of a row one thread holds (registers)
MAX_THREADS = 512    # threads of a block (and of a row)
FILL_THREADS_PER_SM = 1024   # half of an SM's 2048 threads
H100_SMS = 132       # the H100 SXM's SMs: the plan's count off the card
MAX_HELD = 4         # 16-byte vectors a thread holds at many rows


NV_CHOICES = (1, 2, 3, 4, 6, 8)   # vectors a thread, compiled in the kernel


class LaunchPlan(NamedTuple):
    vec: int      # elements a load (16 bytes' worth, or 1)
    nv: int       # vectors a thread holds (MAX_VALUES single elements)
    tpr: int      # threads a row, a power of two
    rpb: int      # rows a block
    blocks: int


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


@functools.lru_cache(maxsize=1024)
def launch_plan(rows: int, d: int, itemsize: int, out_itemsize: int,
                aligned: bool, sms: int = H100_SMS) -> LaunchPlan:
    """The kernel's grid for ``rows`` rows of ``d`` elements of
    ``itemsize`` bytes, stored as ``out_itemsize`` bytes, on a card of
    ``sms`` SMs.  16-byte vectors when every pointer is 16-byte aligned
    (``aligned``) and a row is whole vectors, else single elements.
    Threads a row: the least power of two that keeps a thread within
    ``MAX_VALUES`` values, doubled up to ``MAX_THREADS`` while a thread
    holds more than one vector and either the rows do not half fill the
    card (``sms`` x ``FILL_THREADS_PER_SM`` threads) or a thread holds
    more than ``MAX_HELD`` vectors.  A block is one row, or a warp's
    worth of rows narrower than a warp.  Vectors a thread: the fewest
    the kernel is compiled for (``NV_CHOICES``) that hold its share, or
    the least power of two when the output is wider than the input.
    The rule is what ``chip_smoke.py``'s plan sweep measured fastest on
    an H100 (``PERF.md``)."""
    vec = 16 // itemsize if aligned and (d * itemsize) % 16 == 0 else 1
    nvec = d // vec
    tpr = _pow2_at_least(-(-nvec // (MAX_VALUES // vec)))
    while tpr < nvec and tpr < MAX_THREADS and (
            rows * tpr < sms * FILL_THREADS_PER_SM
            or (vec > 1 and -(-nvec // tpr) > MAX_HELD)):
        tpr *= 2
    rpb = max(1, 32 // tpr)
    per = -(-nvec // tpr)
    if vec == 1:
        nv = MAX_VALUES
    elif out_itemsize > itemsize:
        nv = _pow2_at_least(per)
    else:
        nv = min(n for n in NV_CHOICES if n >= per)
    return LaunchPlan(vec, nv, tpr, rpb, -(-rows // rpb))


@functools.lru_cache(maxsize=None)
def _sm_count(dev: int) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def fused_layernorm_reference(x: torch.Tensor, res: Optional[torch.Tensor],
                              scale: torch.Tensor, bias: torch.Tensor,
                              eps: float,
                              out_dtype: torch.dtype = torch.float32
                              ) -> torch.Tensor:
    """The plain version, ``_ln_reference``'s math: promote to float32,
    add ``res``, mean and population variance (ddof 0) over the last
    axis, ``rsqrt(var + eps)``, scale and bias; then one cast to
    ``out_dtype``."""
    xf = x.to(torch.float32)
    if res is not None:
        xf = xf + res.to(torch.float32)
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, unbiased=False)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * scale + bias).to(out_dtype)


def _check(x, res, scale, bias) -> int:
    """x's dtype code for the kernel; raises on what it does not take."""
    code = kernels.DTYPE_CODES.get(x.dtype)
    if code is None:
        raise TypeError(f"fused_layernorm kernel takes float32, bfloat16 or "
                        f"float16, got {x.dtype}")
    d = x.shape[-1] if x.dim() else 0
    if not 1 <= d <= MAX_D or x.numel() == 0:
        raise ValueError(f"fused_layernorm kernel takes a non-empty tensor "
                         f"with rows of 1 to {MAX_D} elements, got shape "
                         f"{tuple(x.shape)}")
    dev = x.get_device()
    if res is not None and (res.shape != x.shape or res.dtype != x.dtype
                            or res.get_device() != dev):
        raise ValueError(f"residual {tuple(res.shape)} {res.dtype} on "
                         f"{res.device} does not match x {tuple(x.shape)} "
                         f"{x.dtype} on {x.device}")
    for name, t in (("scale", scale), ("bias", bias)):
        if (t.dtype != torch.float32 or t.get_device() != dev
                or t.shape != (d,)):
            raise ValueError(f"fused_layernorm: {name} must be float32 "
                             f"({d},) on {x.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    return code


def fused_layernorm(x: torch.Tensor, res: Optional[torch.Tensor],
                    scale: torch.Tensor, bias: torch.Tensor, eps: float,
                    out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """LayerNorm(x [+ res]) * scale + bias over the last axis, stored as
    ``out_dtype`` (float32 or x's dtype).  A CUDA ``x`` launches the
    kernel (f32, bf16 or f16 ``x`` and ``res`` of one dtype, float32
    ``scale``/``bias``, rows of 1 to ``MAX_D``) or raises; a CPU ``x``
    takes :func:`fused_layernorm_reference`.  The kernel loads 16-byte
    vectors only when x, res, scale, bias and the output all start on a
    16-byte boundary and ``d * itemsize`` is a multiple of 16; any other
    tensor (an odd d, a view at an odd offset) takes its element-wise
    loads.  ``fused_layernorm.launches`` counts the kernel launches."""
    if out_dtype != torch.float32 and out_dtype != x.dtype:
        raise TypeError(f"fused_layernorm writes float32 or x's dtype "
                        f"{x.dtype}, not {out_dtype}")
    refuse_dtensor("fused_layernorm", x, res, scale, bias)
    if not x.is_cuda:
        if x.device.type == "cpu":
            return fused_layernorm_reference(x, res, scale, bias, eps,
                                             out_dtype)
        raise ValueError(f"fused_layernorm: unsupported device {x.device}")
    code = _check(x, res, scale, bias)
    x, scale, bias = x.contiguous(), scale.contiguous(), bias.contiguous()
    res = res.contiguous() if res is not None else None
    y = torch.empty_like(x, dtype=out_dtype)
    ptrs = (x.data_ptr(), 0 if res is None else res.data_ptr(),
            scale.data_ptr(), bias.data_ptr(), y.data_ptr())
    aligned = not (ptrs[0] | ptrs[1] | ptrs[2] | ptrs[3] | ptrs[4]) % 16
    d = x.shape[-1]
    rows = x.numel() // d
    dev = x.get_device()
    plan = launch_plan(rows, d, x.element_size(), y.element_size(), aligned,
                       _sm_count(dev))
    err = _kernel()(*ptrs, code, 0 if out_dtype == torch.float32 else code,
                    rows, d, plan.vec, plan.nv, plan.tpr, plan.rpb,
                    float(eps), dev, torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"fused_layernorm kernel launch failed: CUDA "
                           f"error {err}")
    fused_layernorm.launches += 1
    return y


fused_layernorm.launches = 0


def empty_launch(x: torch.Tensor,
                 out_dtype: torch.dtype = torch.float32) -> None:
    """An empty kernel on the grid the kernel takes for a contiguous
    ``x`` (aligned as x's storage is) stored as ``out_dtype``: the launch
    floor its time is held against.  Not a LayerNorm launch, so not
    counted."""
    d = x.shape[-1]
    dev = x.get_device()
    plan = launch_plan(x.numel() // d, d, x.element_size(),
                       torch.empty((), dtype=out_dtype).element_size(),
                       not x.data_ptr() % 16, _sm_count(dev))
    err = _library().ff_fused_layernorm_empty(
        plan.blocks, plan.tpr * plan.rpb, dev,
        torch._C._cuda_getCurrentRawStream(dev))
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {err}")


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
    (the JAX package's ``_fused_bwd``) at a float32 output, with the
    incoming gradient cast to float32, as the cast after a float32
    output would give it."""

    @staticmethod
    def forward(ctx, x, res, scale, bias, eps, out_dtype):
        ctx.eps = eps
        ctx.has_res = res is not None
        ctx.save_for_backward(x, res if res is not None else x, scale, bias)
        return fused_layernorm(x, res, scale, bias, eps, out_dtype)

    @staticmethod
    def backward(ctx, g):
        x, res, scale, bias = ctx.saved_tensors
        args = (x, res if ctx.has_res else None, scale, bias)
        leaves = [None if t is None else t.detach().requires_grad_(need)
                  for t, need in zip(args, ctx.needs_input_grad[:4])]
        wanted = [t for t in leaves if t is not None and t.requires_grad]
        if not wanted:
            return None, None, None, None, None, None
        with torch.enable_grad():
            y = fused_layernorm_reference(*leaves, ctx.eps)
        grads = iter(torch.autograd.grad(y, wanted, g.to(torch.float32)))
        return (*[next(grads) if t is not None and t.requires_grad
                  else None for t in leaves], None, None)


def fused_layernorm_autograd(x: torch.Tensor, res: Optional[torch.Tensor],
                             scale: torch.Tensor, bias: torch.Tensor,
                             eps: float,
                             out_dtype: torch.dtype = torch.float32
                             ) -> torch.Tensor:
    """:func:`fused_layernorm` that autograd can differentiate.  When no
    gradient is wanted it is the plain call and saves nothing."""
    wants = torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, res, scale, bias))
    if wants:
        return FusedLayerNorm.apply(x, res, scale, bias, float(eps),
                                    out_dtype)
    return fused_layernorm(x, res, scale, bias, eps, out_dtype)


def _library() -> ctypes.CDLL:
    lib = kernels.load("fused_layernorm")
    if lib.ff_fused_layernorm.argtypes is None:
        fn = lib.ff_fused_layernorm
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 5
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong]
                       + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn = lib.ff_fused_layernorm_empty
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
    return lib


@functools.lru_cache(maxsize=None)
def _kernel():
    """The bound C entry, looked up once."""
    return _library().ff_fused_layernorm
