"""MultiHeadAttention and PositionEmbedding, the counterparts of the ops of
the same name in ``flexflow_tpu/ops/attention.py`` (the single-device
forward; ring attention and the decode, paged and verify paths come with
the generation and multi-device slices).

Kernel selection.  The JAX rule (``_use_flash``) allows its Pallas
kernel only on a TPU, with 128-aligned sequence lengths and above a
length threshold measured on a v5e; none of that carries over.  The
port's rule:

* on a CUDA tensor the flash kernels (``ops/cuda_attention.py``, forward
  and, under autograd, backward) run, unless ``flash_attention`` is
  False in the config, or attention-probability dropout is active in
  training (the kernel never holds the probabilities, as in JAX), or
  the kernel does not take the operands (head dim above 128, or a dtype
  other than float32, bfloat16 and float16);
* otherwise, and always on the CPU, :func:`_dense_attention` runs.

There is no length threshold and no alignment rule: the kernel masks
its ragged tiles.  A kernel that fails to build or launch raises; there
is no fallback to the dense path.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..initializers import GlorotUniform, ZeroInitializer
from ..op import Op, OpContext, OpType
from .common import cast_compute
from .cuda_attention import (NEG_INF, attention_scores, flash_attention,
                             flash_attention_reference, kernel_takes)

__all__ = ["MultiHeadAttention", "PositionEmbedding", "NEG_INF",
           "use_flash"]


def use_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              ctx_flag, training_dropout: bool) -> bool:
    """The port's kernel selection (see the module docstring)."""
    return (q.device.type == "cuda" and ctx_flag is not False
            and not training_dropout and kernel_takes(q, k, v))


def _dense_attention(q, k, v, causal: bool, scale: float,
                     dropout_rate: float, generator):
    """(n,sq,h,d),(n,sk,h,d),(n,sk,h,d) -> float32 (n,sq,h,d): float32
    scores and softmax, the finite ``NEG_INF`` causal mask, dropout on
    the probabilities (mask drawn from ``generator``), probabilities
    rounded to v's dtype before the product."""
    if dropout_rate <= 0.0 or generator is None:
        return flash_attention_reference(q, k, v, causal, scale)
    probs = torch.softmax(attention_scores(q, k, causal, scale), dim=-1)
    keep = 1.0 - dropout_rate
    mask = torch.rand(probs.shape, generator=generator,
                      device=probs.device) < keep
    probs = torch.where(mask, probs / keep, torch.zeros_like(probs))
    return torch.einsum("nhqk,nkhd->nqhd",
                        probs.to(v.dtype).to(torch.float32),
                        v.to(torch.float32))


class MultiHeadAttention(Op):
    """Weights follow Linear's (out, in) layout: wq/wk/wv project the
    model dim to ``num_heads * head_dim``, wo projects back; one output
    bias."""

    op_type = OpType.ATTENTION

    def __init__(self, name, query, key, value, embed_dim, num_heads,
                 kdim=0, vdim=0, dropout=0.0, use_bias=True, causal=False,
                 kernel_initializer=None):
        inputs = [query] if key is query and value is query else [
            query, key, value]
        super().__init__(name, inputs)
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.kdim = kdim or key.shape[-1]
        self.vdim = vdim or value.shape[-1]
        if self.kdim != key.shape[-1] or self.vdim != value.shape[-1]:
            raise ValueError(f"{name}: kdim/vdim {self.kdim}/{self.vdim} do "
                             f"not match the key/value feature dims "
                             f"{key.shape[-1]}/{value.shape[-1]}")
        if embed_dim % num_heads:
            raise ValueError(f"{name}: embed_dim {embed_dim} is not a "
                             f"multiple of num_heads {num_heads}")
        self.head_dim = embed_dim // num_heads
        self.dropout, self.causal, self.use_bias = (float(dropout), causal,
                                                    use_bias)
        self._self_attn = len(inputs) == 1
        n, sq, dq = query.shape
        self._add_output((n, sq, embed_dim), query.dtype)
        init = kernel_initializer or GlorotUniform()
        # heads split over the channel axis: q/k/v by output row, the
        # output projection by input column
        self.w_q = self._add_weight((embed_dim, dq), init, "wq",
                                    sharded_dim=0)
        self.w_k = self._add_weight((embed_dim, key.shape[-1]), init, "wk",
                                    sharded_dim=0)
        self.w_v = self._add_weight((embed_dim, value.shape[-1]), init,
                                    "wv", sharded_dim=0)
        self.w_o = self._add_weight((embed_dim, embed_dim), init, "wo",
                                    sharded_dim=1)
        if use_bias:
            self.w_bias = self._add_weight((embed_dim,), ZeroInitializer(),
                                           "bias")

    def _qkv(self, params, xq, xk, xv, ctx):
        """The q/k/v projections: float32 products of compute-dtype
        operands (Linear's contract), cast back to the compute dtype and
        split into heads."""
        n = xq.shape[0]
        h, hd = self.num_heads, self.head_dim

        def proj(x, w):
            y = F.linear(x.to(torch.float32),
                         cast_compute(params[w.name], ctx).to(torch.float32))
            return cast_compute(y, ctx).reshape(n, x.shape[1], h, hd)

        return proj(xq, self.w_q), proj(xk, self.w_k), proj(xv, self.w_v)

    def _out_proj(self, params, attn, n, sq, ctx):
        """The context -> embed output projection (+bias)."""
        attn = cast_compute(attn, ctx).reshape(n, sq, self.embed_dim)
        out = F.linear(attn.to(torch.float32),
                       cast_compute(params[self.w_o.name],
                                    ctx).to(torch.float32))
        if self.use_bias:
            out = out + params[self.w_bias.name].to(out.dtype)
        return cast_compute(out, ctx)

    def parallel_dims(self):
        # (n, s, c): samples, sequence and heads
        return (True, True, True)

    def forward(self, params, inputs, ctx: OpContext):
        xq = cast_compute(inputs[0], ctx)
        xk = xq if self._self_attn else cast_compute(inputs[1], ctx)
        xv = xq if self._self_attn else cast_compute(inputs[2], ctx)
        n, sq, _ = xq.shape
        q, k, v = self._qkv(params, xq, xk, xv, ctx)
        scale = 1.0 / math.sqrt(self.head_dim)
        gen = None
        if ctx.training and self.dropout > 0.0:
            gen = ctx.op_generator(self.outputs[0].uid)
        if use_flash(q, k, v, ctx.flash_attention, gen is not None):
            attn = flash_attention(q, k, v, self.causal, scale)
        else:
            attn = _dense_attention(q, k, v, self.causal, scale,
                                    self.dropout if ctx.training else 0.0,
                                    gen)
        return [self._out_proj(params, attn, n, sq, ctx)]


class PositionEmbedding(Op):
    """Learned absolute position table added to a (n, s, d) sequence."""

    op_type = OpType.EMBEDDING

    def __init__(self, name, input_tensor, max_len=None,
                 kernel_initializer=None):
        super().__init__(name, [input_tensor])
        n, s, d = input_tensor.shape
        self.max_len = max_len or s
        if self.max_len < s:
            raise ValueError(f"{name}: max_len {self.max_len} is shorter "
                             f"than the sequence ({s})")
        self._add_output((n, s, d), input_tensor.dtype)
        self.w_table = self._add_weight(
            (self.max_len, d), kernel_initializer or GlorotUniform(), "table")

    def parallel_dims(self):
        return (True, True, False)

    def forward(self, params, inputs, ctx: OpContext):
        x = inputs[0]
        table = params[self.w_table.name][: x.shape[1]]
        return [x + cast_compute(table, ctx)[None]]
