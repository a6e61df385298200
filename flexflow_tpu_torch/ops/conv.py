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

On a mesh (DTensor values, ``OpContext.mesh``) each rank convolves its
shard of the batch with the whole kernel, as DTensor's convolution rule
would: a Conv2D whose input is split over h or w gathers h and w first,
and its output is resharded by its strategy after it.  The max pool is lifted onto each rank's local
shard of the batch (``parallel.sharding.shard_map``), where it runs the
same kernels, forward and backward, as the JAX package lifts its Pallas
kernel into ``shard_map`` on each batch shard.  A pool whose strategy
splits h or w takes the JAX package's route there, XLA's
``reduce_window`` with ``-inf`` padding, here in plain torch over the
gathered spatial dims.  ``POOL_ROUTES`` counts the routes taken.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..initializers import GlorotUniform, ZeroInitializer
from ..op import Op, OpContext, OpType, pad_degrees
from ..parallel.sharding import is_dtensor, keep_shards, redistribute, \
    shard_map
from .common import apply_activation, cast_compute
from .cuda_pool import (max_pool_nhwc_autograd, max_pool_nhwc_reference,
                        out_hw)

# the max pool's routes on a mesh: the kernels on each rank's batch
# shard, or the reduce_window equivalent over gathered h and w
POOL_ROUTES = {"kernel_per_shard": 0, "spatial_gathered": 0}


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

    def mxu_efficiency(self, spec=None):
        # ``spec.conv_lane_fill``: the input channels a device needs to
        # fill its contraction; 0 (the H100's spec) charges none
        lanes = getattr(spec, "conv_lane_fill", 0)
        return min(1.0, self.in_channels / lanes) if lanes else 1.0

    def backward_overhead(self, part_degrees=None, spec=None):
        # ``spec.strided_dgrad_law`` k: a stride-s dgrad costs 1 + k s^2/4
        # times the 2x-forward model; 0 (the H100's spec) charges none
        law = getattr(spec, "strided_dgrad_law", 0.0)
        s = max(self.stride)
        return 1.0 + law * (s * s) / 4.0 if s > 1 and law else 1.0

    def flops(self):
        n, c_out, oh, ow = self.outputs[0].shape
        kh, kw = self.kernel
        return (2 * n * c_out * oh * ow * (self.in_channels // self.groups)
                * kh * kw)

    def sub_problem(self, part_degrees):
        # the c split shards the filters (input channels stay whole); the
        # n/h/w splits shard the input box, halo ignored
        n, cin, h, w = self.inputs[0].shape
        out = self.outputs[0]
        dn, dc, dh, dw = pad_degrees(part_degrees, 4)
        dims = (dn, dc, dh, dw)
        if n % max(1, dn) or self.out_channels % max(1, dc):
            raise ValueError(f"conv degrees {dims} don't divide")
        if out.shape[2] % max(1, dh) or out.shape[3] % max(1, dw):
            raise ValueError(f"conv spatial degrees {dims} don't divide")
        in_shape = (n // max(1, dn), cin, max(1, h // max(1, dh)),
                    max(1, w // max(1, dw)))
        kh, kw = self.kernel
        shapes = {self.w_kernel.name: (self.out_channels // max(1, dc),
                                       cin // self.groups, kh, kw)}
        if self.use_bias:
            shapes[self.w_bias.name] = (self.out_channels // max(1, dc),)
        return [in_shape], shapes

    def forward(self, params, inputs, ctx: OpContext):
        x = cast_compute(inputs[0], ctx)
        k = cast_compute(params[self.w_kernel.name], ctx)
        b = params[self.w_bias.name] if self.use_bias else None
        if not is_dtensor(x):
            return [cast_compute(self._conv(x, k, b, ctx), ctx)]
        # each rank convolves its batch shard (h, w and c gathered) with
        # the whole kernel; DTensor's own convolution rule shards the
        # batch only, and in some releases refuses a strided, padded
        # convolution outright
        pl = keep_shards(x.placements, (0,))
        rep = ctx.mesh.replicated()
        y = shard_map(lambda xl, kl, bl: self._conv(xl, kl, bl, ctx),
                      [x, k, b], [pl, rep, rep], pl)
        return [cast_compute(y, ctx)]

    def _conv(self, x, k, b, ctx: OpContext) -> torch.Tensor:
        """The convolution and its activation on one device's (or one
        rank's) tensors."""
        if ctx.conv_layout == "nhwc":
            x = x.contiguous(memory_format=torch.channels_last)
            k = k.contiguous(memory_format=torch.channels_last)
        b = b.to(x.dtype) if b is not None else None
        y = F.conv2d(x, k, b, stride=self.stride, padding=self.padding,
                     groups=self.groups)
        return apply_activation(y, self.activation)


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

    def flops(self):
        return self.outputs[0].volume * self.kernel[0] * self.kernel[1]

    def backward_overhead(self, part_degrees=None, spec=None):
        # ``spec.maxpool_bwd_factor``: a device whose max-pool backward
        # lowers past its bandwidth roofline.  On the H100 the
        # hand-written backward kernel runs (per shard on a mesh), so its
        # spec charges 1.0; measure mode times what really runs
        if self.pool_type != "max":
            return 1.0
        return getattr(spec, "maxpool_bwd_factor", 1.0)

    def kernel_libraries(self, config):
        return ("max_pool_nhwc",) if self.pool_type == "max" else ()

    def _splits_spatial(self) -> bool:
        """Does this op's strategy split h or w?"""
        dims = getattr(self.parallel_config, "dims", None)
        return dims is not None and len(dims) >= 4 and (
            dims[2] > 1 or dims[3] > 1)

    def _max_pool(self, x: torch.Tensor) -> torch.Tensor:
        """The max pool of one device (or of one rank's shard): the
        kernels for a floating tensor, forward and, under autograd,
        backward."""
        x = x.contiguous(memory_format=torch.channels_last)
        if x.is_floating_point():
            return max_pool_nhwc_autograd(x, self.kernel, self.stride,
                                          self.padding)
        return max_pool_nhwc_reference(x, self.kernel, self.stride,
                                       self.padding)

    def _reduce_window_max(self, x: torch.Tensor) -> torch.Tensor:
        """XLA's ``reduce_window`` max, the JAX package's route for a
        spatially split pool: padding is ``-inf`` for a floating tensor
        (the kernels pad with ``finfo.min``)."""
        if not x.is_floating_point():
            return max_pool_nhwc_reference(x, self.kernel, self.stride,
                                           self.padding)
        (ph, pw) = self.padding
        xp = F.pad(x, (pw, pw, ph, ph), value=float("-inf"))
        return F.max_pool2d(xp, self.kernel, self.stride)

    def _sharded_max_pool(self, x, mesh) -> torch.Tensor:
        """The max pool of a DTensor: each rank pools its batch shard
        (h, w and c gathered), through the kernels, or through the
        ``reduce_window`` equivalent when the strategy splits h or w."""
        pl = keep_shards(x.placements, (0,))
        if self._splits_spatial():
            POOL_ROUTES["spatial_gathered"] += 1
            return shard_map(self._reduce_window_max, [x], [pl], pl)
        POOL_ROUTES["kernel_per_shard"] += 1
        return shard_map(self._max_pool, [x], [pl], pl)

    def forward(self, params, inputs, ctx: OpContext):
        x = cast_compute(inputs[0], ctx)
        if self.pool_type == "max":
            y = (self._sharded_max_pool(x, ctx.mesh) if is_dtensor(x)
                 else self._max_pool(x))
        elif is_dtensor(x):
            pl = keep_shards(x.placements, (0,))
            y = shard_map(self._avg_pool, [x], [pl], pl)
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
