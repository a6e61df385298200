"""Flat and Softmax, the counterparts of the ops of the same name in
``flexflow_tpu/ops/tensor_ops.py`` (the other shape ops come with the
models that use them)."""

from __future__ import annotations

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
