"""LayerNorm, the counterpart of ``flexflow_tpu/ops/norm.py::LayerNorm``
(BatchNorm and RMSNorm come with the models that use them).

With scale and bias, a CUDA tensor always goes through the fused
LayerNorm kernel (``ops/cuda_norm.py``): the JAX package gates its Pallas
kernel behind a default-off flag for a TPU cost question that does not
carry over, and in the port the kernel is the CUDA path.  A CPU tensor
takes the kernel's plain version.  Without scale or bias the op runs the
stock math.  Statistics are float32 either way, and the output is cast
to the compute dtype.
"""

from __future__ import annotations

import torch

from ..initializers import ConstantInitializer, ZeroInitializer
from ..op import Op, OpContext, OpType
from .common import cast_compute
from .cuda_norm import fused_layernorm_autograd


class LayerNorm(Op):
    op_type = OpType.LAYERNORM

    def __init__(self, name, input_tensor, eps=1e-5, use_scale=True,
                 use_bias=True):
        super().__init__(name, [input_tensor])
        self.eps = eps
        d = input_tensor.shape[-1]
        self._add_output(input_tensor.shape, input_tensor.dtype)
        self.w_scale = (self._add_weight((d,), ConstantInitializer(1.0),
                                         "scale") if use_scale else None)
        self.w_bias = (self._add_weight((d,), ZeroInitializer(), "bias")
                       if use_bias else None)

    def forward(self, params, inputs, ctx: OpContext):
        x = inputs[0]
        if self.w_scale is not None and self.w_bias is not None:
            y = fused_layernorm_autograd(x, None, params[self.w_scale.name],
                                         params[self.w_bias.name], self.eps)
            return [cast_compute(y, ctx)]
        xf = x.to(torch.float32)
        mean = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        y = (xf - mean) * torch.rsqrt(var + self.eps)
        if self.w_scale is not None:
            y = y * params[self.w_scale.name]
        if self.w_bias is not None:
            y = y + params[self.w_bias.name]
        return [cast_compute(y, ctx)]
