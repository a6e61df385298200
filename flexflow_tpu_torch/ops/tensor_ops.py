"""Flat, Softmax, Concat, Split, Reshape, Transpose and Dropout, the
counterparts of the ops of the same name in
``flexflow_tpu/ops/tensor_ops.py``."""

from __future__ import annotations

import functools

import torch

from ..op import Op, OpType
from .common import cast_compute


class Flat(Op):
    """4-D (n,c,h,w) -> 2-D (n, c*h*w), in logical NCHW order whatever
    the memory format."""

    op_type = OpType.FLAT

    def __init__(self, name, input_tensor):
        super().__init__(name, [input_tensor])
        n = input_tensor.shape[0]
        self._add_output((n, input_tensor.volume // n), input_tensor.dtype)

    def forward(self, params, inputs, ctx):
        x = inputs[0]
        return [x.reshape(x.shape[0], -1)]


class Softmax(Op):
    """Softmax computed in float32, then cast to the compute dtype."""

    op_type = OpType.SOFTMAX

    def __init__(self, name, input_tensor, axis=-1):
        super().__init__(name, [input_tensor])
        self.axis = axis
        self._add_output(input_tensor.shape, input_tensor.dtype)

    def forward(self, params, inputs, ctx):
        y = torch.softmax(inputs[0].to(torch.float32), dim=self.axis)
        return [cast_compute(y, ctx)]


class Concat(Op):
    """Concatenate along ``axis`` after promoting the inputs to their
    common dtype (``jnp.result_type`` in the JAX op).  ``torch.cat``
    keeps a memory format that all inputs share, so channels-last
    branches concatenate on the channel axis into a channels-last
    tensor."""

    op_type = OpType.CONCAT

    def __init__(self, name, input_tensors, axis):
        super().__init__(name, list(input_tensors))
        self.axis = axis
        shape = list(input_tensors[0].shape)
        shape[axis] = sum(t.shape[axis] for t in input_tensors)
        self._add_output(tuple(shape), input_tensors[0].dtype)

    def forward(self, params, inputs, ctx):
        dt = functools.reduce(torch.promote_types, [x.dtype for x in inputs])
        return [torch.cat([x.to(dt) for x in inputs], dim=self.axis)]


class Split(Op):
    """Split along ``axis`` into pieces of ``sizes``."""

    op_type = OpType.SPLIT

    def __init__(self, name, input_tensor, sizes, axis):
        super().__init__(name, [input_tensor])
        self.sizes, self.axis = list(sizes), axis
        for i, s in enumerate(self.sizes):
            shape = list(input_tensor.shape)
            shape[axis] = s
            self._add_output(tuple(shape), input_tensor.dtype, idx=i)

    def forward(self, params, inputs, ctx):
        return list(torch.split(inputs[0], self.sizes, dim=self.axis))


class Reshape(Op):
    """Reshape to ``shape``.  A leading dim equal to the graph's batch
    size is batch-relative: the runtime batch (a ``fit(batch_size=...)``
    override) keeps its own leading dim."""

    op_type = OpType.RESHAPE

    def __init__(self, name, input_tensor, shape):
        super().__init__(name, [input_tensor])
        self._shape = tuple(int(s) for s in shape)
        self._batch_relative = (
            len(self._shape) > 0
            and input_tensor.num_dims > 0
            and self._shape[0] == input_tensor.shape[0])
        self._add_output(self._shape, input_tensor.dtype)

    def forward(self, params, inputs, ctx):
        shape = self._shape
        if self._batch_relative:
            shape = (inputs[0].shape[0],) + shape[1:]
        return [inputs[0].reshape(shape)]


class Transpose(Op):
    """Permute the dims by ``perm`` (a view; ``jnp.transpose``)."""

    op_type = OpType.TRANSPOSE

    def __init__(self, name, input_tensor, perm):
        super().__init__(name, [input_tensor])
        self.perm = tuple(perm)
        out_shape = tuple(input_tensor.shape[p] for p in self.perm)
        self._add_output(out_shape, input_tensor.dtype)

    def forward(self, params, inputs, ctx):
        return [inputs[0].permute(self.perm)]


class Dropout(Op):
    """Inverted dropout in training (identity in inference): keep each
    element with probability 1 - rate and scale it by 1/(1 - rate).  The
    mask comes from the op's generator for the step
    (``OpContext.op_generator``); torch's bits are not the JAX
    package's, so only the keep fraction and the scaling compare."""

    op_type = OpType.DROPOUT

    def __init__(self, name, input_tensor, rate, seed=0):
        super().__init__(name, [input_tensor])
        self.rate, self.seed = float(rate), seed
        self._add_output(input_tensor.shape, input_tensor.dtype)

    def parallel_dims(self):
        return (True,) * self.outputs[0].num_dims

    def forward(self, params, inputs, ctx):
        x = inputs[0]
        gen = ctx.op_generator(self.outputs[0].uid) if ctx.training else None
        if gen is None or self.rate <= 0.0:
            return [x]
        keep = 1.0 - self.rate
        mask = torch.rand(x.shape, generator=gen, device=x.device) < keep
        return [torch.where(mask, x / keep, torch.zeros_like(x))]
