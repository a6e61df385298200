"""Flash attention, forward and backward: the CUDA kernels' wrappers,
their plain versions and the autograd function that pairs them.

Counterpart of ``flexflow_tpu/ops/attention.py::_flash_attention`` (the
Pallas TPU flash-attention kernel and its dkv/dq backward kernels).  Both
kernels are in ``csrc/flash_attention.cu``; its source note gives the
designs and the bounds.  The bfloat16 and float16 kernels load their tiles
by TMA, which needs a head dim that is a multiple of 8 and 16-byte aligned
operands: :func:`kernel_operands` copies, once per call, the operands that
are not so, and :func:`unpad` slices the results back.

Every function takes the port's (n, s, h, d) layout.  The forward writes
O in q's dtype and the row log-sum-exp (float32, (n, h, sq)) that the
backward reads.  The plain versions repeat the math of the port's
``_dense_attention`` (``ops/attention.py``): float32 scores, the finite
``NEG_INF`` causal mask, a float32 softmax, probabilities rounded to v's
dtype before the product with v.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from .. import kernels

MAX_HEAD_DIM = 128
NEG_INF = -1e30   # the finite mask value of the JAX package's attention


def kernel_takes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the kernels take these operands: one float dtype of
    float32, bfloat16 or float16 and a head dim of at most 128."""
    return (q.dtype in kernels.DTYPE_CODES and q.dtype == k.dtype == v.dtype
            and 1 <= q.shape[-1] <= MAX_HEAD_DIM
            and k.shape[-1] == q.shape[-1] == v.shape[-1])


def attention_scores(q, k, causal: bool, scale: float) -> torch.Tensor:
    """float32 (n, h, sq, sk) scaled scores with the causal mask (the
    products of bf16 or f16 values are exact in float32, so this is the
    JAX einsum's preferred_element_type contract)."""
    s = torch.einsum("nqhd,nkhd->nhqk", q.to(torch.float32),
                     k.to(torch.float32)) * scale
    if causal:
        sq, sk = s.shape[2], s.shape[3]
        masked = (torch.arange(sk, device=s.device)[None, :]
                  > torch.arange(sq, device=s.device)[:, None])
        s = s.masked_fill(masked, NEG_INF)
    return s


def flash_attention_reference(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, causal: bool,
                              scale: float) -> torch.Tensor:
    """The plain forward: ``_dense_attention`` without dropout, a float32
    (n, sq, h, d) result."""
    probs = torch.softmax(attention_scores(q, k, causal, scale), dim=-1)
    return torch.einsum("nhqk,nkhd->nqhd",
                        probs.to(v.dtype).to(torch.float32),
                        v.to(torch.float32))


def flash_attention_lse_reference(q, k, causal: bool,
                                  scale: float) -> torch.Tensor:
    """The row log-sum-exp the forward kernel writes: float32 (n, h, sq)."""
    return torch.logsumexp(attention_scores(q, k, causal, scale), dim=-1)


def flash_attention_backward_reference(q, k, v, o, lse, do, causal: bool,
                                       scale: float
                                       ) -> Tuple[torch.Tensor, ...]:
    """The plain backward, the kernel's recompute-and-reduce steps in
    torch ops with float32 statistics: P = exp(scale q k^T - lse),
    dV = round(P)^T dO, dP = dO v^T, dS = P (dP - rowsum(dO o)),
    dQ = scale dS k, dK = scale dS^T q.  Returns (dq, dk, dv) in the
    dtypes of q, k and v."""
    f32 = torch.float32
    s = attention_scores(q, k, causal, scale)
    p = torch.exp(s - lse.to(f32)[..., None])
    dof = do.to(f32)
    dv = torch.einsum("nhqk,nqhd->nkhd", p.to(v.dtype).to(f32), dof)
    dp = torch.einsum("nqhd,nkhd->nhqk", dof, v.to(f32))
    dvec = torch.einsum("nqhd,nqhd->nhq", dof, o.to(f32))
    ds = p * (dp - dvec[..., None])
    dq = torch.einsum("nhqk,nkhd->nqhd", ds, k.to(f32)) * scale
    dk = torch.einsum("nhqk,nqhd->nkhd", ds, q.to(f32)) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def pad_head_dim(t: torch.Tensor, d: int) -> torch.Tensor:
    """A fresh contiguous copy of ``t`` with its last dim zero-padded to
    ``d`` (a new allocation, so 16-byte aligned)."""
    out = t.new_zeros(t.shape[:-1] + (d,))
    out[..., :t.shape[-1]] = t
    return out


def kernel_operands(*ts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The operands as the kernels read them: contiguous and, for bfloat16
    and float16 (TMA), with a head dim that is a multiple of 8 and a
    16-byte aligned start.  When one of them is not so, all are copied
    with the head dim zero-padded to the next multiple of 8: zero columns
    add nothing to the scores and give zero output columns, which
    :func:`unpad` drops.  float32 operands are only made contiguous: the
    scalar kernels take any head dim and alignment."""
    ts = tuple(t.contiguous() for t in ts)
    d = ts[0].shape[-1]
    if ts[0].dtype == torch.float32 or (
            d % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in ts)):
        return ts
    padded = -(-d // 8) * 8
    return tuple(pad_head_dim(t, padded) for t in ts)


def unpad(t: torch.Tensor, d: int) -> torch.Tensor:
    """``t`` with its last dim cut back to ``d`` (contiguous)."""
    return t if t.shape[-1] == d else t[..., :d].contiguous()


def _check(fn: str, q, k, v) -> int:
    """What the kernels take; returns the dtype code."""
    if q.device.type != "cuda" or not (q.device == k.device == v.device):
        raise ValueError(f"{fn}: q, k and v must be on one CUDA device, got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"{fn}: want q (n, sq, h, d) and k, v (n, sk, h, "
                         f"d), got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    n, sq, h, d = q.shape
    if k.shape[0] != n or k.shape[2] != h or k.shape[3] != d:
        raise ValueError(f"{fn}: q {tuple(q.shape)} and k {tuple(k.shape)} "
                         f"disagree on batch, heads or head dim")
    if not kernel_takes(q, k, v):
        raise TypeError(f"{fn} kernel takes one dtype of float32, bfloat16 "
                        f"or float16 and a head dim of at most "
                        f"{MAX_HEAD_DIM}, got {q.dtype}/{k.dtype}/{v.dtype} "
                        f"and d={d}")
    if min(n, sq, k.shape[1], h) < 1 or n * h > 65535:
        raise ValueError(f"{fn}: bad sizes n={n} h={h} sq={sq} "
                         f"sk={k.shape[1]} (n*h must be at most 65535)")
    return kernels.DTYPE_CODES[q.dtype]


def flash_attention_forward(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, causal: bool, scale: float
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(O, lse): O (n, sq, h, d) in q's dtype and the float32 row
    log-sum-exp (n, h, sq).  CUDA tensors launch the forward kernel or
    raise; CPU tensors take the plain versions.
    ``flash_attention_forward.launches`` counts the kernel launches, and
    ``launches_by_dtype`` counts them by the operands' dtype."""
    if q.device.type == "cpu":
        o = flash_attention_reference(q, k, v, causal, scale)
        return (o.to(q.dtype),
                flash_attention_lse_reference(q, k, causal, scale))
    code = _check("flash_attention_forward", q, k, v)
    d = q.shape[-1]
    q, k, v = kernel_operands(q, k, v)
    n, sq, h, dp = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((n, h, sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _library().ff_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), code, n, h, sq, k.shape[1], dp, float(scale),
        int(bool(causal)), q.device.index or 0, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_forward kernel launch failed: "
                           f"CUDA error {err}")
    flash_attention_forward.launches += 1
    by_dtype = flash_attention_forward.launches_by_dtype
    by_dtype[str(q.dtype)] = by_dtype.get(str(q.dtype), 0) + 1
    return unpad(o, d), lse


flash_attention_forward.launches = 0
flash_attention_forward.launches_by_dtype = {}


def flash_attention_backward(q, k, v, o, lse, do, causal: bool,
                             scale: float) -> Tuple[torch.Tensor, ...]:
    """(dq, dk, dv) from the forward's operands, its O and lse, and the
    gradient ``do`` of O.  CUDA tensors launch the backward (one C call,
    three kernels) or raise; CPU tensors take
    :func:`flash_attention_backward_reference`.
    ``flash_attention_backward.launches`` counts the C calls, and
    ``launches_by_dtype`` counts them by the operands' dtype."""
    if q.device.type == "cpu":
        return flash_attention_backward_reference(q, k, v, o, lse, do,
                                                  causal, scale)
    code = _check("flash_attention_backward", q, k, v)
    n, sq, h, d = q.shape
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype:
        raise ValueError(f"flash_attention_backward: o {tuple(o.shape)} "
                         f"{o.dtype} and do {tuple(do.shape)} must match q "
                         f"{tuple(q.shape)} {q.dtype}")
    if tuple(lse.shape) != (n, h, sq) or lse.dtype != torch.float32:
        raise ValueError(f"flash_attention_backward: lse must be float32 "
                         f"{(n, h, sq)}, got {tuple(lse.shape)} {lse.dtype}")
    q, k, v, o, do = kernel_operands(q, k, v, o, do.to(q.dtype))
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    dvec = torch.empty((n, h, sq), dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _library().ff_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dvec.data_ptr(), code, n, h, sq, k.shape[1],
        q.shape[-1], float(scale), int(bool(causal)), q.device.index or 0,
        stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_backward kernel launch failed: "
                           f"CUDA error {err}")
    flash_attention_backward.launches += 1
    by_dtype = flash_attention_backward.launches_by_dtype
    by_dtype[str(q.dtype)] = by_dtype.get(str(q.dtype), 0) + 1
    return unpad(dq, d), unpad(dk, d), unpad(dv, d)


flash_attention_backward.launches = 0
flash_attention_backward.launches_by_dtype = {}


class FlashAttention(torch.autograd.Function):
    """The forward kernel with the backward kernel as its gradient; saves
    q, k, v, O and the lse."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        o, lse = flash_attention_forward(q, k, v, causal, scale)
        ctx.causal, ctx.scale = causal, scale
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, o, lse, do,
                                              ctx.causal, ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool, scale: float) -> torch.Tensor:
    """Attention through the kernels, differentiable by autograd; O in
    q's dtype.  When no gradient is wanted it is the plain forward call
    and saves nothing."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return FlashAttention.apply(q, k, v, bool(causal), float(scale))
    return flash_attention_forward(q, k, v, causal, scale)[0]


def _library() -> ctypes.CDLL:
    lib = kernels.load("flash_attention")
    if lib.ff_flash_attention_fwd.argtypes is None:
        # the forward's argtypes are set last: once another thread sees
        # them, both functions are declared
        p, i = ctypes.c_void_p, ctypes.c_int
        for fn, n_ptr in ((lib.ff_flash_attention_bwd, 10),
                          (lib.ff_flash_attention_fwd, 5)):
            fn.restype = i
            fn.argtypes = ([p] * n_ptr + [i] * 6
                           + [ctypes.c_float, i, i, p])
    return lib
