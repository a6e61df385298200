"""Conv2D / Pool2D, the counterparts of ``flexflow_tpu/ops/conv.py``.

Conv2D keeps OIHW weights and runs ``F.conv2d`` (the JAX package leaves
the convolution to XLA, so cuDNN stands in for it here).  Pool2D's max
pool goes through the hand-written kernels (``ops/cuda_pool.py``) for
every floating tensor on a CUDA device, the forward kernel and, under
autograd, the backward kernel; its average pool is ``F.avg_pool2d``
(the JAX op is XLA's reduce_window sum over kh*kw, padding counted),
and autograd differentiates it.  Tensor metadata stays NCHW: under
``conv_layout="nhwc"`` the ops keep activations in
``torch.channels_last`` memory, and the max pool converts to
channels-last at its own boundary in either layout, as the JAX ops
transpose at theirs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..initializers import GlorotUniform, ZeroInitializer
from ..op import Op, OpContext, OpType
from .common import apply_activation, cast_compute
from .cuda_pool import (max_pool_nhwc_autograd, max_pool_nhwc_reference,
                        out_hw)


class Conv2D(Op):
    op_type = OpType.CONV2D

    def __init__(self, name, input_tensor, out_channels, kernel_h, kernel_w,
                 stride_h, stride_w, padding_h, padding_w, activation=None,
                 use_bias=True, groups=1, kernel_initializer=None,
                 bias_initializer=None):
        super().__init__(name, [input_tensor])
        n, c, h, w = input_tensor.shape
        self.in_channels, self.out_channels = c, out_channels
        self.kernel = (kernel_h, kernel_w)
        self.stride = (stride_h, stride_w)
        self.padding = (padding_h, padding_w)
        self.activation = activation
        self.use_bias = use_bias
        self.groups = groups
        oh, ow = out_hw(h, w, self.kernel, self.stride, self.padding)
        self._add_output((n, out_channels, oh, ow), input_tensor.dtype)
        self.w_kernel = self._add_weight(
            (out_channels, c // groups, kernel_h, kernel_w),
            kernel_initializer or GlorotUniform(), "kernel")
        if use_bias:
            self.w_bias = self._add_weight(
                (out_channels,), bias_initializer or ZeroInitializer(),
                "bias")

    def parallel_dims(self):
        # n, h and w split; channels do not
        return (True, False, True, True)

    def forward(self, params, inputs, ctx: OpContext):
        x = cast_compute(inputs[0], ctx)
        k = cast_compute(params[self.w_kernel.name], ctx)
        if ctx.conv_layout == "nhwc":
            x = x.contiguous(memory_format=torch.channels_last)
            k = k.contiguous(memory_format=torch.channels_last)
        b = (params[self.w_bias.name].to(x.dtype) if self.use_bias
             else None)
        y = F.conv2d(x, k, b, stride=self.stride, padding=self.padding,
                     groups=self.groups)
        y = apply_activation(y, self.activation)
        return [cast_compute(y, ctx)]


class Pool2D(Op):
    """Max/avg pooling (reference pool_2d.cu)."""

    op_type = OpType.POOL2D

    def __init__(self, name, input_tensor, kernel_h, kernel_w, stride_h,
                 stride_w, padding_h, padding_w, pool_type="max",
                 activation=None):
        super().__init__(name, [input_tensor])
        n, c, h, w = input_tensor.shape
        self.kernel = (kernel_h, kernel_w)
        self.stride = (stride_h, stride_w)
        self.padding = (padding_h, padding_w)
        self.pool_type = pool_type
        self.activation = activation
        oh, ow = out_hw(h, w, self.kernel, self.stride, self.padding)
        self._add_output((n, c, oh, ow), input_tensor.dtype)

    def parallel_dims(self):
        return (True, False, True, True)

    def forward(self, params, inputs, ctx: OpContext):
        x = cast_compute(inputs[0], ctx)
        if self.pool_type == "max":
            x = x.contiguous(memory_format=torch.channels_last)
            if x.is_floating_point():
                y = max_pool_nhwc_autograd(x, self.kernel, self.stride,
                                           self.padding)
            else:
                y = max_pool_nhwc_reference(x, self.kernel, self.stride,
                                            self.padding)
        else:
            y = self._avg_pool(x)
        y = apply_activation(y, self.activation)
        if ctx.conv_layout == "nchw":
            y = y.contiguous()
        return [y]

    def _avg_pool(self, x: torch.Tensor) -> torch.Tensor:
        """The mean over each zero-padded window, padding counted in the
        divisor kh*kw, as the JAX op's reduce_window sum divides.
        ``F.avg_pool2d`` takes a padding of at most half the window, so a
        larger one is applied as explicit zeros first.  It sums a bf16 or
        f16 input in float32, where the JAX op sums in the input's dtype."""
        (kh, kw), (ph, pw) = self.kernel, self.padding
        if 2 * ph > kh or 2 * pw > kw:
            x = F.pad(x, (pw, pw, ph, ph))
            ph = pw = 0
        return F.avg_pool2d(x, self.kernel, self.stride, (ph, pw),
                            count_include_pad=True)
