"""ElementUnary and ElementBinary, the counterparts of the ops of those
names in ``flexflow_tpu/ops/elementwise.py``.  Unary functions follow
``jax.nn``: ``relu`` has JAX's gradient at a NaN input
(``common.relu``) and ``gelu`` is the tanh form.  The scalar forms
(``scalar_mul``, ``scalar_add``, ``scalar_sub``, ``scalar_truediv``)
take the scalar in the input's dtype.  Binary ops broadcast with numpy's
rules and compute in the promoted dtype of their two inputs."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..op import Op, OpType
from .common import relu

_UNARY = {
    "exp": torch.exp,
    "log": torch.log,
    "relu": relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "elu": F.elu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "identity": lambda x: x,
    "rsqrt": torch.rsqrt,
    "sqrt": torch.sqrt,
    "negative": torch.negative,
}

_SCALAR = {
    "scalar_mul": torch.multiply,
    "scalar_add": torch.add,
    "scalar_sub": torch.subtract,
    "scalar_truediv": torch.divide,
}

_BINARY = {
    "add": torch.add,
    "sub": torch.subtract,
    "subtract": torch.subtract,
    "mul": torch.multiply,
    "multiply": torch.multiply,
    "div": torch.divide,
    "divide": torch.divide,
    "max": torch.maximum,
    "min": torch.minimum,
    "pow": torch.pow,
}


class ElementUnary(Op):
    op_type = OpType.ELEMENT_UNARY

    def __init__(self, name, input_tensor, fn: str, scalar=None):
        super().__init__(name, [input_tensor])
        if fn not in _UNARY and scalar is None:
            raise ValueError(f"unknown unary op {fn!r}")
        self.fn, self.scalar = fn, scalar
        self._add_output(input_tensor.shape, input_tensor.dtype)

    def parallel_dims(self):
        return (True,) * self.outputs[0].num_dims

    def forward(self, params, inputs, ctx):
        x = inputs[0]
        if self.scalar is not None and self.fn in _SCALAR:
            # a fill on the device: no host-to-device copy per call
            s = torch.full((), self.scalar, dtype=x.dtype, device=x.device)
            return [_SCALAR[self.fn](x, s)]
        return [_UNARY[self.fn](x)]


class ElementBinary(Op):
    op_type = OpType.ELEMENT_BINARY

    def __init__(self, name, in1, in2, fn: str):
        super().__init__(name, [in1, in2])
        if fn not in _BINARY:
            raise ValueError(f"unknown binary op {fn!r}")
        self.fn = fn
        out_shape = tuple(np.broadcast_shapes(in1.shape, in2.shape))
        self._add_output(out_shape, in1.dtype)

    def parallel_dims(self):
        return (True,) * self.outputs[0].num_dims

    def forward(self, params, inputs, ctx):
        a, b = inputs
        dt = torch.promote_types(a.dtype, b.dtype)
        return [_BINARY[self.fn](a.to(dt), b.to(dt))]
