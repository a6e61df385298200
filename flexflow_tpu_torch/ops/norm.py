"""BatchNorm, LayerNorm and RMSNorm, the counterparts of the ops of the
same name in ``flexflow_tpu/ops/norm.py``.

BatchNorm is plain torch, as the JAX op is XLA: statistics in float32
over (n, h, w), the population variance, and in training the running
statistics come back through ``OpContext.updates`` as
``m * running + (1 - m) * batch`` (``nn.BatchNorm2d`` weighs the other
way and keeps an unbiased running variance, so its update is not used).

With scale and bias, a CUDA tensor always goes through the fused
LayerNorm kernel (``ops/cuda_norm.py``): the JAX package gates its Pallas
kernel behind a default-off flag for a TPU cost question that does not
carry over, and in the port the kernel is the CUDA path.  A CPU tensor
takes the kernel's plain version.  The kernel stores the compute dtype
itself when that is float32 or the input's dtype (one launch, no cast
after it; bit-equal to the float32 output cast), else it writes float32
and the op casts.  Without scale or bias the op runs the stock math.
Statistics are float32 either way.

RMSNorm is plain torch, as the JAX op is XLA: the float32 mean of
squares, ``rsqrt``, the scale, then a cast to the compute dtype.

On a mesh (DTensor values) BatchNorm and RMSNorm run on DTensors, and
the fused LayerNorm runs on each rank's local rows
(``parallel.sharding.shard_map``): the batch split over ``n`` and the
sequence over ``s`` stay split, a split of the normalized dim is
gathered first, and under ``c`` the replicated residual stream is
normalized whole on every rank.
"""

from __future__ import annotations

import torch

from ..initializers import ConstantInitializer, ZeroInitializer
from ..op import Op, OpContext, OpType
from ..parallel.sharding import is_dtensor, keep_shards, shard_map
from .common import cast_compute, relu, torch_dtype
from .cuda_norm import fused_layernorm_autograd


class BatchNorm(Op):
    """Batch normalization over the channels of an (n, c, h, w) tensor,
    with a fused ReLU by default (reference batch_norm.cu)."""

    op_type = OpType.BATCHNORM

    def __init__(self, name, input_tensor, relu=True, momentum=0.9,
                 eps=1e-5):
        super().__init__(name, [input_tensor])
        self.relu, self.momentum, self.eps = relu, momentum, eps
        c = input_tensor.shape[1]
        self._add_output(input_tensor.shape, input_tensor.dtype)
        self.w_scale = self._add_weight((c,), ConstantInitializer(1.0),
                                        "scale")
        self.w_bias = self._add_weight((c,), ZeroInitializer(), "bias")
        self.s_mean = self._add_weight((c,), ZeroInitializer(),
                                       "running_mean", trainable=False)
        self.s_var = self._add_weight((c,), ConstantInitializer(1.0),
                                      "running_var", trainable=False)

    def parallel_dims(self):
        return (True, False, True, True)

    def flops(self):
        return 8 * self.outputs[0].volume

    def internal_io_bytes(self, flash_attention=None, device="cuda",
                          compute_dtype: str = "bfloat16"):
        # the float32 copy, the statistics pass over the batch and the
        # normalising re-read: 10 bytes an element beyond the boundary
        # tensors (the JAX package's accounting of the same passes)
        return 10 * self.inputs[0].volume

    def forward(self, params, inputs, ctx: OpContext):
        xf = inputs[0].to(torch.float32)   # keeps channels_last memory
        if ctx.training:
            var, mean = torch.var_mean(xf, dim=(0, 2, 3), correction=0)
            m = self.momentum
            ctx.updates[self.s_mean.name] = (
                m * params[self.s_mean.name] + (1 - m) * mean)
            ctx.updates[self.s_var.name] = (
                m * params[self.s_var.name] + (1 - m) * var)
        else:
            mean = params[self.s_mean.name]
            var = params[self.s_var.name]
        inv = torch.rsqrt(var + self.eps) * params[self.w_scale.name]
        y = ((xf - mean.reshape(1, -1, 1, 1)) * inv.reshape(1, -1, 1, 1)
             + params[self.w_bias.name].reshape(1, -1, 1, 1))
        if self.relu:
            y = relu(y)
        return [cast_compute(y, ctx)]


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

    def parallel_dims(self):
        nd = self.outputs[0].num_dims
        return (True,) * (nd - 1) + (False,)

    def flops(self):
        return 8 * self.outputs[0].volume

    def internal_io_bytes(self, flash_attention=None, device="cuda",
                          compute_dtype: str = "bfloat16"):
        # the float32 copy and the per-row statistics pass
        return 8 * self.inputs[0].volume

    def kernel_libraries(self, config):
        return (("fused_layernorm",) if self.w_scale is not None
                and self.w_bias is not None else ())

    def forward(self, params, inputs, ctx: OpContext):
        x = inputs[0]
        if self.w_scale is not None and self.w_bias is not None:
            # the kernel stores the compute dtype itself where it can
            dt = torch_dtype(ctx.compute_dtype)
            out_dtype = (dt if dt in (torch.float32, x.dtype)
                         else torch.float32)

            def norm(xl, scale, bias):
                return fused_layernorm_autograd(xl, None, scale, bias,
                                                self.eps, out_dtype)

            scale, bias = params[self.w_scale.name], params[self.w_bias.name]
            if is_dtensor(x):
                pl = keep_shards(x.placements, range(x.dim() - 1))
                rep = ctx.mesh.replicated()
                y = shard_map(norm, [x, scale, bias],
                              [pl, rep, rep], pl)
            else:
                y = norm(x, scale, bias)
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


class RMSNorm(Op):
    op_type = OpType.RMSNORM

    def __init__(self, name, input_tensor, eps=1e-6):
        super().__init__(name, [input_tensor])
        self.eps = eps
        d = input_tensor.shape[-1]
        self._add_output(input_tensor.shape, input_tensor.dtype)
        self.w_scale = self._add_weight((d,), ConstantInitializer(1.0),
                                        "scale")

    def parallel_dims(self):
        nd = self.outputs[0].num_dims
        return (True,) * (nd - 1) + (False,)

    def flops(self):
        return 4 * self.outputs[0].volume

    def internal_io_bytes(self, flash_attention=None, device="cuda",
                          compute_dtype: str = "bfloat16"):
        return 8 * self.inputs[0].volume

    def forward(self, params, inputs, ctx: OpContext):
        xf = inputs[0].to(torch.float32)
        ms = torch.mean(torch.square(xf), dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + self.eps) * params[self.w_scale.name]
        return [cast_compute(y, ctx)]
