"""Shared op helpers: dtype policy and activation epilogues.

The policy is the JAX package's (``flexflow_tpu/ops/common.py``):
matmuls and convolutions run in the configured compute dtype (bfloat16
by default) and parameters stay float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import PRECISION_DTYPES

F32 = "float32"
BF16 = "bfloat16"


def torch_dtype(name) -> torch.dtype:
    """The torch dtype of a dtype name ("bfloat16") or torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    dt = getattr(torch, str(name), None)
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dt


def resolve_op_dtype(op, base_dtype: str) -> str:
    """The per-op compute dtype: the strategy's ``precision`` override
    when one is set ("bf16"/"f32"), else the session dtype."""
    pc = getattr(op, "parallel_config", None)
    prec = getattr(pc, "precision", "") if pc is not None else ""
    return PRECISION_DTYPES.get(prec, base_dtype)


def dtype_itemsize(dtype) -> int:
    """Byte width of a dtype (torch dtype or name)."""
    return torch_dtype(dtype).itemsize


def cast_compute(x: torch.Tensor, ctx) -> torch.Tensor:
    dt = torch_dtype(ctx.compute_dtype)
    if x.is_floating_point() and x.dtype != dt:
        return x.to(dt)
    return x


def scale_param_name(weight_name: str) -> str:
    """The params key of a quantized weight's per-output-channel scale
    (the one spelling; ``serving.quantize`` builds the entries)."""
    return weight_name + "::scale"


def dequant_matmul(x: torch.Tensor, q: torch.Tensor,
                   scale: torch.Tensor) -> torch.Tensor:
    """Weight-only int8 product, ``(x @ q.T) * scale``: ``q`` (out, in)
    int8, ``scale`` its float32 per-output-channel scale, ``x`` (..., in)
    in the compute dtype.  ``q`` is cast to float32 (exact, as its cast
    to bf16 or f16 would be for |q| <= 127) and multiplied in float32,
    Linear's contract; the scale multiplies the product, not the weight,
    so the result is ``x @ (q * scale).T`` exactly as the JAX package's
    order has it.  The cast makes a float32 copy of ``q`` for the
    product's life: resident weights are int8, the transient is not."""
    y = F.linear(x.to(torch.float32), q.to(torch.float32))
    return y * scale.to(y.dtype)


class _Relu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = torch.relu(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        # y > 0 exactly where x > 0: a NaN input gives a NaN y
        return torch.where(y > 0, g, 0.0)


def relu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.relu``: the value of ``torch.relu`` (NaN stays NaN) with
    the gradient ``where(x > 0, g, 0)``.  ``torch.relu``'s own gradient
    passes g on at a NaN input, where JAX's gives 0; a NaN row (an
    embedding id out of range) would then spread NaN into rows that JAX
    keeps finite."""
    return _Relu.apply(x)


def apply_activation(x: torch.Tensor, activation):
    """Activation epilogue, with the JAX package's definitions (its
    gelu is the tanh approximation)."""
    if activation is None or activation == "none":
        return x
    if activation == "relu":
        return relu(x)
    if activation == "sigmoid":
        return torch.sigmoid(x)
    if activation == "tanh":
        return torch.tanh(x)
    if activation == "elu":
        return F.elu(x)
    if activation == "gelu":
        return F.gelu(x, approximate="tanh")
    if activation == "exp":
        return torch.exp(x)
    if activation == "silu":
        return F.silu(x)
    if activation == "softmax":
        return torch.softmax(x, dim=-1)
    if callable(activation):
        return activation(x)
    raise ValueError(f"unknown activation {activation!r}")
