"""Mixture-of-Experts layer on one device, the counterpart of
``flexflow_tpu/ops/moe.py``.

* a router (dense gate) scores every token against every expert in f32;
* top-k selection with a capacity factor — each expert processes at
  most ``C = ceil(k * T / E * capacity_factor)`` tokens (T from the
  graph's input shape, as the JAX op takes it); overflow tokens fall
  through the zero-contribution combine, GShard's drop policy (slot by
  slot, tokens in order, positions from a cumulative sum);
* dispatch and combine are dense einsums against a (T, E, C) one-hot;
  the per-expert FFN weights are stacked on a leading E dimension, with
  the JAX op's parameter names (``gate``, ``w_up``, ``w_up_bias``,
  ``w_down``, ``w_down_bias``);
* in training the Switch load-balancing loss ``w * E * sum_e f_e * P_e``
  goes into ``ctx.aux_losses``, which the train step adds to the
  objective.

The products multiply the compute-dtype operands in float32, as
``Linear`` does (the JAX op's ``preferred_element_type=float32``), and
cast the results back to the compute dtype where the JAX op does.
Expert parallelism (the ``all_to_all`` over an expert mesh axis) comes
with the multi-device layer.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..initializers import GlorotUniform, ZeroInitializer
from ..op import Op, OpContext, OpType
from .common import apply_activation, cast_compute

F32 = torch.float32


class _PerExpertInit:
    """Stacks a base initializer over the experts: expert i draws like
    an unstacked FFN weight, one after the other from the generator."""

    def __init__(self, base, num_experts: int):
        self.base, self.num_experts = base, num_experts

    def __call__(self, generator, shape, dtype):
        return torch.stack([self.base(generator, tuple(shape[1:]), dtype)
                            for _ in range(self.num_experts)])


def _mm(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An einsum of the two operands (already in the compute dtype) in
    float32, with a float32 result."""
    return torch.einsum(spec, a.to(F32), b.to(F32))


class MoE(Op):
    """Token-routed expert FFN: (n, s, d) -> (n, s, d)."""

    op_type = OpType.MOE

    def __init__(self, name, input_tensor, num_experts, d_ff, k=2,
                 capacity_factor=1.25, activation="gelu",
                 aux_loss_weight=1e-2, kernel_initializer=None):
        super().__init__(name, [input_tensor])
        n, s, d = input_tensor.shape
        self.num_experts = int(num_experts)
        self.d_ff = int(d_ff)
        self.k = min(int(k), self.num_experts)
        self.capacity_factor = float(capacity_factor)
        self.activation = activation
        self.aux_loss_weight = float(aux_loss_weight)
        self._add_output((n, s, d), input_tensor.dtype)
        E = self.num_experts
        base = kernel_initializer or GlorotUniform()
        self.w_gate = self._add_weight((E, d), base, "gate")

        def ew(shape, init, nm):
            # expert-stacked on dim 0, which splits over the 'e' axis
            p = self._add_weight((E,) + shape, _PerExpertInit(init, E), nm,
                                 sharded_dim=0)
            p.shard_axis = "e"
            return p

        # per-expert FFN in Linear's (out, in) layout, stacked on dim 0
        self.w_up = ew((self.d_ff, d), base, "w_up")
        self.w_upb = ew((self.d_ff,), ZeroInitializer(), "w_up_bias")
        self.w_dn = ew((d, self.d_ff), base, "w_down")
        self.w_dnb = ew((d,), ZeroInitializer(), "w_down_bias")

    @property
    def capacity(self) -> int:
        n, s, _ = self.inputs[0].shape
        tokens = n * s
        return max(1, math.ceil(self.k * tokens / self.num_experts
                                * self.capacity_factor))

    def route(self, probs: torch.Tensor, capacity: int):
        """(dispatch, combine, top_idx) for the (T, E) float32 router
        probabilities: the (T, E, C) float32 one-hot of each kept
        token's expert slot, the same weighted by its renormalized gate,
        and the (T, k) chosen experts."""
        T, E = probs.shape
        C = capacity
        top_probs, top_idx = torch.topk(probs, self.k, dim=-1)   # (T, k)
        denom = torch.sum(top_probs, dim=-1, keepdim=True) + 1e-9
        gates_k = top_probs / denom                              # renormalized
        dispatch = torch.zeros((T, E, C), dtype=F32, device=probs.device)
        combine = torch.zeros_like(dispatch)
        base_count = torch.zeros((E,), dtype=torch.int64,
                                 device=probs.device)
        # slot-by-slot position assignment (GShard): slot 0 fills expert
        # buffers first, tokens in order; overflow positions >= C are cut
        for j in range(self.k):
            oh = F.one_hot(top_idx[:, j], E)                     # (T, E)
            pos = torch.cumsum(oh, dim=0) - 1 + base_count[None]
            base_count = base_count + torch.sum(oh, dim=0)
            pos_tok = torch.sum(pos * oh, dim=-1)                # (T,)
            keep = (pos_tok < C).to(F32)
            slot = ((oh.to(F32) * keep[:, None])[..., None]
                    * F.one_hot(torch.clamp(pos_tok, 0, C - 1),
                                C).to(F32)[:, None, :])
            dispatch = dispatch + slot
            combine = combine + slot * gates_k[:, j, None, None]
        return dispatch, combine, top_idx

    def parallel_dims(self):
        # (n, s, c): tokens split; the model dim stays whole
        return (True, True, False)

    def forward(self, params, inputs, ctx: OpContext):
        x = inputs[0]
        n, s, d = x.shape
        T, E = n * s, self.num_experts
        xt = cast_compute(x.reshape(T, d), ctx)
        gate = params[self.w_gate.name].to(F32)
        logits = torch.einsum("td,ed->te", xt.to(F32), gate)
        probs = torch.softmax(logits, dim=-1)                    # (T, E) f32
        dispatch, combine, top_idx = self.route(probs, self.capacity)

        # (T,E,C) x (T,d) -> (E,C,d) expert batches
        xe = cast_compute(_mm("tec,td->ecd", cast_compute(dispatch, ctx),
                              xt), ctx)
        w_up = cast_compute(params[self.w_up.name], ctx)
        w_dn = cast_compute(params[self.w_dn.name], ctx)
        h = _mm("ecd,efd->ecf", xe, w_up)
        h = h + params[self.w_upb.name].to(F32)[:, None, :]
        h = cast_compute(apply_activation(h, self.activation), ctx)
        y = _mm("ecf,edf->ecd", h, w_dn)
        y = y + params[self.w_dnb.name].to(F32)[:, None, :]
        y = cast_compute(y, ctx)
        out = _mm("tec,ecd->td", cast_compute(combine, ctx), y)

        if ctx.training and self.aux_loss_weight > 0.0:
            # Switch load-balance loss: E * sum_e (token fraction * mean
            # router prob); differentiable through P_e
            f_e = torch.mean(F.one_hot(top_idx[:, 0], E).to(F32), dim=0)
            p_e = torch.mean(probs, dim=0)
            ctx.aux_losses[self.name] = (self.aux_loss_weight * E
                                         * torch.sum(f_e * p_e))
        return [cast_compute(out, ctx).reshape(n, s, d)]
