"""Plain PyTorch building blocks of the references: float32 with TF32
off, no kernel, no cache, no batching trick.  Nothing here imports the
program.

``prec`` is the arithmetic: ``"float32"``; ``"bf16"``, the
configurations' own precision done plainly; or ``"fp8"``, the control,
float8 e4m3 under a per-tensor scale (amax to 448, as fp8 inference
scales).  Below float32, every matrix product's operands and every
op's output (embedding, projection, attention, GELU, residual sum,
LayerNorm) are rounded to ``prec``, as the program stores each op's
output in its compute dtype; products and reductions accumulate in
float32.  The rounding passes the gradient straight through, so a
training step in ``"fp8"`` is the float32 step with its values in fp8.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def exact_float32():
    """Float32 products as float32 (TF32 off), restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def rounded(x: torch.Tensor, prec: str) -> torch.Tensor:
    """``x`` as a matrix product's operand in ``prec``."""
    if prec == "float32":
        return x
    with torch.no_grad():
        if prec == "bf16":
            q = x.to(torch.bfloat16).to(torch.float32)
        elif prec == "fp8":
            scale = 448.0 / x.abs().amax().clamp_min(1e-30)
            q = (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
        else:
            raise ValueError(f"unknown precision {prec!r}")
    return x + (q - x).detach()


def linear(x, w, b, prec: str):
    """``x @ w.T + b`` with (out, in) ``w``, stored in ``prec``."""
    return rounded(F.linear(rounded(x, prec), rounded(w, prec), b), prec)


def matmul(a, b, prec: str):
    return torch.matmul(rounded(a, prec), rounded(b, prec))


def layer_norm(x, scale, bias, eps: float):
    mean = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, unbiased=False)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def gelu_tanh(x):
    return 0.5 * x * (1.0 + torch.tanh(
        math.sqrt(2.0 / math.pi) * (x + 0.044715 * x * x * x)))


def self_attention(x, w: Dict[str, torch.Tensor], name: str, heads: int,
                   causal: bool, prec: str):
    """Multi-head self-attention of (n, s, d) ``x``: q, k, v and output
    projections without q/k/v biases, one output bias."""
    n, s, d = x.shape
    hd = d // heads

    def split(t):
        return t.view(n, s, heads, hd).transpose(1, 2)

    q = split(linear(x, w[f"{name}/wq"], None, prec))
    k = split(linear(x, w[f"{name}/wk"], None, prec))
    v = split(linear(x, w[f"{name}/wv"], None, prec))
    scores = matmul(q, k.transpose(-1, -2), prec) / math.sqrt(hd)
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        scores = scores.masked_fill(~keep, float("-inf"))
    o = rounded(matmul(torch.softmax(scores, dim=-1), v, prec), prec)
    o = o.transpose(1, 2).reshape(n, s, d)
    return linear(o, w[f"{name}/wo"], w[f"{name}/bias"], prec)


def post_norm_layer(t, w: Dict[str, torch.Tensor], i: int, heads: int,
                    eps: float, causal: bool, prec: str):
    """One post-norm block: attention, add, LayerNorm, GELU (tanh) feed
    forward, add, LayerNorm."""
    def r(x):
        return rounded(x, prec)

    a = self_attention(t, w, f"attention_{i}", heads, causal, prec)
    t = r(layer_norm(r(t + a), w[f"ln_attn_{i}/scale"],
                     w[f"ln_attn_{i}/bias"], eps))
    h = r(gelu_tanh(linear(t, w[f"ffn_up_{i}/kernel"], w[f"ffn_up_{i}/bias"],
                           prec)))
    h = linear(h, w[f"ffn_down_{i}/kernel"], w[f"ffn_down_{i}/bias"], prec)
    return r(layer_norm(r(t + h), w[f"ln_ffn_{i}/scale"],
                        w[f"ln_ffn_{i}/bias"], eps))


def embed(tokens, w: Dict[str, torch.Tensor], prec: str = "float32"):
    """Token embedding plus the learned position table's first rows."""
    x = rounded(w["tok_embedding/table"][tokens.long()], prec)
    return rounded(x + rounded(w["pos_embedding/table"][: tokens.shape[-1]],
                               prec), prec)
