"""LSTM, the counterpart of ``flexflow_tpu/ops/rnn.py`` (the reference's
NMT cell, ``nmt/lstm.cu``).

The gate arithmetic is the JAX op's, step for step: the input
projection of every timestep is hoisted into one product, the recurrent
product and the gate math run in a loop over the sequence, the gates are
ordered i, f, g, o, the forget bias (default +1.0) is added at run time,
and (h, c) are carried in float32.  Products take their operands in the
compute dtype and multiply them in float32, as ``Linear`` does (the JAX
op's ``preferred_element_type=float32``; a bf16 ``torch.matmul`` would
round its output to bf16).  Autograd through the loop is the
counterpart of the scan's transpose.  cuDNN's fused RNN is not used: it
has two biases and no run-time forget bias, and keeps neither this
carry nor these product dtypes.  ``forward_states`` and ``decode``
belong to token generation and come with it.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..initializers import GlorotUniform, ZeroInitializer
from ..op import Op, OpContext, OpType
from .common import cast_compute


class LSTM(Op):
    """Single-layer LSTM.  Outputs ``[seq (n, s, H), h_n (n, H), c_n (n,
    H)]``; pass ``initial_state=(h0, c0)`` tensors to chain encoder and
    decoder."""

    op_type = OpType.LSTM

    def __init__(self, name, input_tensor, hidden_size, initial_state=None,
                 forget_bias=1.0, kernel_initializer=None):
        inputs = [input_tensor]
        if initial_state is not None:
            inputs += [initial_state[0], initial_state[1]]
        super().__init__(name, inputs)
        n, s, d = input_tensor.shape
        self.hidden_size = int(hidden_size)
        self.forget_bias = float(forget_bias)
        self._has_state = initial_state is not None
        h = self.hidden_size
        self._add_output((n, s, h), input_tensor.dtype, idx=0)
        self._add_output((n, h), input_tensor.dtype, idx=1)
        self._add_output((n, h), input_tensor.dtype, idx=2)
        init = kernel_initializer or GlorotUniform()
        # (out, in) as Linear keeps it; the 4H rows are the i, f, g, o
        # gate blocks
        self.w_x = self._add_weight((4 * h, d), init, "wx", sharded_dim=0)
        self.w_h = self._add_weight((4 * h, h), init, "wh", sharded_dim=0)
        self.w_b = self._add_weight((4 * h,), ZeroInitializer(), "bias")

    def parallel_dims(self):
        # (n, s, c): samples and the hidden dim; the recurrence is serial
        # in s
        return (True, False, True)

    def forward(self, params, inputs, ctx: OpContext):
        f32 = torch.float32
        x = cast_compute(inputs[0], ctx).to(f32)                # (n, s, d)
        wx = cast_compute(params[self.w_x.name], ctx).to(f32)
        wh = cast_compute(params[self.w_h.name], ctx).to(f32)
        b = params[self.w_b.name].to(f32)
        n, s = x.shape[0], x.shape[1]
        xg = F.linear(x, wx)                                    # (n, s, 4H)
        if self._has_state:
            h, c = inputs[1].to(f32), inputs[2].to(f32)
        else:
            h = torch.zeros((n, self.hidden_size), dtype=f32,
                            device=x.device)
            c = torch.zeros_like(h)
        hs = []
        for t in range(s):
            # the carry h goes through the compute dtype before the
            # recurrent product, as the JAX cell casts it
            gates = xg[:, t] + F.linear(cast_compute(h, ctx).to(f32), wh) + b
            i, f, g, o = gates.chunk(4, dim=-1)
            c = (torch.sigmoid(f + self.forget_bias) * c
                 + torch.sigmoid(i) * torch.tanh(g))
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
        seq = torch.stack(hs, dim=1)
        return [cast_compute(seq, ctx), cast_compute(h, ctx),
                cast_compute(c, ctx)]
