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
carry nor these product dtypes.  Token generation runs the same cell
through ``forward_states`` (the prefill, with every step's carry) and
``decode`` (one step from a carried state).
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

    def _run(self, params, x, h, c, ctx: OpContext):
        """The cell over x (n, s, d) from the float32 carry (h, c): the
        input projection of every step in one product, then the
        recurrence.  Returns the float32 ``hs`` (n, s, H) and the list
        of every step's float32 c (n, H)."""
        f32 = torch.float32
        wx = cast_compute(params[self.w_x.name], ctx).to(f32)
        wh = cast_compute(params[self.w_h.name], ctx).to(f32)
        b = params[self.w_b.name].to(f32)
        xg = F.linear(cast_compute(x, ctx).to(f32), wx)         # (n, s, 4H)
        hs, cs = [], []
        for t in range(x.shape[1]):
            # the carry h goes through the compute dtype before the
            # recurrent product, as the JAX cell casts it
            gates = xg[:, t] + F.linear(cast_compute(h, ctx).to(f32), wh) + b
            i, f, g, o = gates.chunk(4, dim=-1)
            c = (torch.sigmoid(f + self.forget_bias) * c
                 + torch.sigmoid(i) * torch.tanh(g))
            h = torch.sigmoid(o) * torch.tanh(c)
            hs.append(h)
            cs.append(c)
        return torch.stack(hs, dim=1), cs

    def _initial_carry(self, inputs, n: int, device):
        if self._has_state:
            return inputs[1].to(torch.float32), inputs[2].to(torch.float32)
        h = torch.zeros((n, self.hidden_size), dtype=torch.float32,
                        device=device)
        return h, torch.zeros_like(h)

    def forward(self, params, inputs, ctx: OpContext):
        return self.forward_states(params, inputs, ctx)[0]

    def forward_states(self, params, inputs, ctx: OpContext):
        """The forward that also returns every step's float32 carry,
        ``(outs, hs, cs)``: hs (n, s, H) and cs a list of s (n, H)
        tensors.  The prefill of token generation reads the carry at the
        prompt's last position to seed :meth:`decode`."""
        x = inputs[0]
        h0, c0 = self._initial_carry(inputs, x.shape[0], x.device)
        hs, cs = self._run(params, x, h0, c0, ctx)
        outs = [cast_compute(hs, ctx), cast_compute(hs[:, -1], ctx),
                cast_compute(cs[-1], ctx)]
        return outs, hs, cs

    def decode(self, params, x, h, c, ctx: OpContext):
        """One step from the carried float32 state: ``x`` (slots, 1, d),
        ``h``/``c`` (slots, H).  Returns ``([seq, h_n, c_n], h, c)`` with
        the new carry."""
        hs, cs = self._run(params, x, h, c, ctx)
        h2, c2 = hs[:, 0], cs[0]
        return ([cast_compute(hs, ctx), cast_compute(h2, ctx),
                 cast_compute(c2, ctx)], h2, c2)
