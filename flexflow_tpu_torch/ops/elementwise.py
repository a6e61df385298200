"""ElementBinary, the counterpart of the op of that name in
``flexflow_tpu/ops/elementwise.py`` (ElementUnary comes with the models
that use it).  Binary ops broadcast with numpy's rules and compute in
the promoted dtype of their two inputs."""

from __future__ import annotations

import numpy as np
import torch

from ..op import Op, OpType

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


class ElementBinary(Op):
    op_type = OpType.ELEMENT_BINARY

    def __init__(self, name, in1, in2, fn: str):
        super().__init__(name, [in1, in2])
        if fn not in _BINARY:
            raise ValueError(f"unknown binary op {fn!r}")
        self.fn = fn
        out_shape = tuple(np.broadcast_shapes(in1.shape, in2.shape))
        self._add_output(out_shape, in1.dtype)

    def forward(self, params, inputs, ctx):
        a, b = inputs
        dt = torch.promote_types(a.dtype, b.dtype)
        return [_BINARY[self.fn](a.to(dt), b.to(dt))]
