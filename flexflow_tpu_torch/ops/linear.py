"""Linear and Embedding, the counterparts of the ops of those names in
``flexflow_tpu/ops/linear.py``.  A Linear whose kernel was quantized
for serving (``FFModel.quantize_weights``) multiplies through
:func:`~.common.dequant_matmul`.

A host-placed Embedding (a strategy's device type CPU or ZCM memory:
:func:`host_placed`, the reference's hetero DLRM placement) keeps its
table in pinned host memory and gathers there (:func:`host_gather`):
only the looked-up rows cross to the device.  On a mesh every rank
holds the table and gathers the whole batch's rows."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import DeviceType, MemoryType
from ..initializers import GlorotUniform, ZeroInitializer
from ..op import Op, OpContext, OpType
from ..parallel.sharding import gather, linear
from .common import (apply_activation, cast_compute, dequant_matmul,
                     scale_param_name)


def host_placed(pc) -> bool:
    """True when a ParallelConfig asks for host placement: device type
    CPU, or any ZCM (zero-copy host) memory type."""
    return pc is not None and (pc.device_type == DeviceType.HOST
                               or MemoryType.ZCM in tuple(pc.memory_types))


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
            "kernel", sharded_dim=0)
        if use_bias:
            self.w_bias = self._add_weight(
                (out_dim,), bias_initializer or ZeroInitializer(), "bias",
                sharded_dim=0)

    def parallel_dims(self):
        # the sample dims and the output channels
        return (True,) * self.outputs[0].num_dims

    def forward(self, params, inputs, ctx: OpContext):
        x = cast_compute(inputs[0], ctx)
        k = params[self.w_kernel.name]
        if k.dtype == torch.int8:
            # int8 weight-only serving: cast_compute leaves int8 alone,
            # so the dtype is tested here
            y = dequant_matmul(x, k, params[scale_param_name(
                self.w_kernel.name)])
        else:
            # the JAX op multiplies compute-dtype operands with float32
            # accumulation and a float32 result (preferred_element_type);
            # products of bf16 or f16 values are exact in float32, so a
            # float32 product of the cast operands is that contract
            # (on a mesh, on each rank's blocks: parallel.sharding.linear)
            b = (params[self.w_bias.name].to(torch.float32)
                 if self.use_bias else None)
            return [linear(x.to(torch.float32),
                           cast_compute(k, ctx).to(torch.float32), b,
                           lambda y: cast_compute(
                               apply_activation(y, self.activation), ctx))]
        if self.use_bias:
            y = y + params[self.w_bias.name].to(torch.float32)
        y = apply_activation(y, self.activation)
        return [cast_compute(y, ctx)]


def map_ids(idx: torch.Tensor, rows: int):
    """The id rules of ``jnp.take(table, idx, axis=0)``, which the JAX
    Embedding gathers with, for a table of ``rows`` rows: an id in
    ``[-rows, 0)`` wraps to ``id + rows``; an id outside ``[-rows,
    rows)`` is invalid.  Returns the int64 ids with invalid ones set to
    0, and the mask of the valid ones."""
    idx = idx.long()
    idx = torch.where(idx < 0, idx + rows, idx)
    valid = (idx >= 0) & (idx < rows)
    return torch.where(valid, idx, 0), valid


def take_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` by :func:`map_ids`'s rules: an invalid id reads a
    row of NaN, and no gradient reaches the table from it.  The gather
    reads mapped ids only, so nothing indexes out of range on the card
    (no device-side assert)."""
    idx, valid = map_ids(idx, table.shape[0])
    y = F.embedding(idx, table)
    # where()'s gradient is zero on the lanes it does not select, so the
    # invalid lanes' row 0 takes nothing from them
    return torch.where(valid[..., None], y, float("nan"))


class _RowsToDevice(torch.autograd.Function):
    """Host rows to the device: staged in pinned memory and copied
    non-blocking; their gradient comes back to the host."""

    @staticmethod
    def forward(ctx, rows, device):
        return rows.pin_memory().to(device, non_blocking=True)

    @staticmethod
    def backward(ctx, g):
        return g.to("cpu"), None


def host_gather(table: torch.Tensor, idx: torch.Tensor,
                device) -> torch.Tensor:
    """:func:`take_rows` of a host-resident ``table`` on the host, the
    counterpart of the JAX package's ``_host_gather``: the ids come to
    the host, the gather runs there, and only the rows cross to
    ``device``.  Differentiable: the table's gradient builds on the
    host.  A table that is not on the host raises; it never gathers on
    the device instead."""
    if table.device.type != "cpu":
        raise RuntimeError(
            f"host-placed embedding table is on {table.device}, not on "
            f"the host")
    rows = take_rows(table, idx.to("cpu")).to(torch.float32)
    if torch.device(device).type == "cpu":
        return rows
    return _RowsToDevice.apply(rows, device)


class Embedding(Op):
    """Table lookup: (n, s) ids -> (n, s, d) with ``aggr="none"``, or a
    bag of ids per sample reduced by ``sum``/``avg`` -> (n, d).  The
    table gathers in float32 by :func:`map_ids`'s id rules; the result
    is cast to the compute dtype.  In a training step on the sparse
    update path the rows come pre-gathered in ``ctx.embedding_rows``; a
    host-placed table gathers on the host (:func:`host_gather`)."""

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
            "table", sharded_dim=1)

    def parallel_dims(self):
        # the sample (and sequence) dims and the table's columns
        return (True,) * self.outputs[0].num_dims

    def forward(self, params, inputs, ctx: OpContext):
        if ctx.embedding_rows and self.name in ctx.embedding_rows:
            # the train step gathered the rows and differentiates with
            # respect to them; the table is not in the autograd graph
            y = ctx.embedding_rows[self.name]
        elif host_placed(self.parallel_config):
            y = host_gather(params[self.w_table.name], gather(inputs[0]),
                            ctx.device)
            if ctx.mesh is not None:
                # every rank gathers the whole batch's rows, replicated
                # as the JAX package's host gather returns them; their
                # gradient comes back whole on every rank
                from torch.distributed.tensor import DTensor
                y = DTensor.from_local(y, ctx.mesh.device_mesh,
                                       ctx.mesh.replicated(),
                                       run_check=False)
        else:
            y = take_rows(params[self.w_table.name].to(torch.float32),
                          inputs[0])   # (n, [s,] d)
        if y.dim() == 3 and self.aggr != "none":
            y = y.sum(dim=1) if self.aggr == "sum" else y.mean(dim=1)
        return [cast_compute(y, ctx)]
