"""Linear and Embedding, the counterparts of the ops of those names in
``flexflow_tpu/ops/linear.py`` (the int8 serving path, the sparse-row
embedding update and host-placed tables come in later slices)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import DeviceType, MemoryType
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


class Embedding(Op):
    """Table lookup: (n, s) ids -> (n, s, d) with ``aggr="none"``, or a
    bag of ids per sample reduced by ``sum``/``avg`` -> (n, d).  The
    table gathers in float32; the result is cast to the compute dtype."""

    op_type = OpType.EMBEDDING

    def __init__(self, name, input_tensor, num_entries, out_dim,
                 aggr="sum", kernel_initializer=None):
        super().__init__(name, [input_tensor])
        self.num_entries, self.out_dim, self.aggr = num_entries, out_dim, aggr
        n = input_tensor.shape[0]
        if aggr in (None, "none"):
            self.aggr = "none"
            self._add_output(input_tensor.shape + (out_dim,), "float32")
        else:
            if aggr not in ("sum", "avg"):
                raise ValueError(f"unknown aggr {aggr!r}")
            self._add_output((n, out_dim), "float32")
        self.w_table = self._add_weight(
            (num_entries, out_dim), kernel_initializer or GlorotUniform(),
            "table")

    def forward(self, params, inputs, ctx: OpContext):
        pc = self.parallel_config
        if pc is not None and (pc.device_type == DeviceType.HOST
                               or MemoryType.ZCM in tuple(pc.memory_types)):
            raise NotImplementedError(
                f"{self.name}: host-placed embedding tables are not ported "
                f"yet")
        idx = inputs[0].to(torch.int32)
        table = params[self.w_table.name].to(torch.float32)
        y = F.embedding(idx, table)   # (n, [s,] d)
        if y.dim() == 3 and self.aggr != "none":
            y = y.sum(dim=1) if self.aggr == "sum" else y.mean(dim=1)
        return [cast_compute(y, ctx)]
