"""Linear, the counterpart of ``flexflow_tpu/ops/linear.py`` (Linear only;
Embedding and the int8 serving path come in later slices)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..initializers import GlorotUniform, ZeroInitializer
from ..op import Op, OpContext, OpType
from .common import apply_activation, cast_compute


class Linear(Op):
    op_type = OpType.LINEAR

    def __init__(self, name, input_tensor, out_dim, activation=None,
                 use_bias=True, kernel_initializer=None,
                 bias_initializer=None):
        super().__init__(name, [input_tensor])
        in_dim = input_tensor.shape[-1]
        self.in_dim, self.out_dim = in_dim, out_dim
        self.activation = activation
        self.use_bias = use_bias
        self._add_output(input_tensor.shape[:-1] + (out_dim,),
                         input_tensor.dtype)
        # (out, in) kernel, as the reference and torch keep it
        self.w_kernel = self._add_weight(
            (out_dim, in_dim), kernel_initializer or GlorotUniform(),
            "kernel")
        if use_bias:
            self.w_bias = self._add_weight(
                (out_dim,), bias_initializer or ZeroInitializer(), "bias")

    def forward(self, params, inputs, ctx: OpContext):
        x = cast_compute(inputs[0], ctx)
        k = cast_compute(params[self.w_kernel.name], ctx)
        # the JAX op multiplies compute-dtype operands with float32
        # accumulation and a float32 result (preferred_element_type);
        # products of bf16 or f16 values are exact in float32, so a
        # float32 product of the cast operands is that contract
        y = F.linear(x.to(torch.float32), k.to(torch.float32))
        if self.use_bias:
            y = y + params[self.w_bias.name].to(torch.float32)
        y = apply_activation(y, self.activation)
        return [cast_compute(y, ctx)]
