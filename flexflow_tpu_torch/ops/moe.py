"""Mixture-of-Experts layer, the counterpart of
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

Expert parallelism over the ``e`` mesh axis: the expert-stacked weights
are split over ``e`` and each rank runs the up and down products of its
own experts.  The tokens stay split over ``n`` and replicated over ``e``,
as GSPMD keeps them, and the JAX op routes over the global token order:
a token's slot in an expert's buffer counts the tokens before it across
the data shards, and the capacity and the load-balance means are the
global batch's.  So each rank routes its tokens with the counts of the
ranks before it on the ``n`` line added (an all-gather of k x E
integers), which gives every token the slot the one-device op gives it.
The token movement is a reduce/gather pair rather than an all-to-all:
an expert's slots are filled by the data shards' tokens, one token a
slot, so the sum over ``n`` of each shard's dispatch is the expert
batch (exact: every other term is zero), and the experts' outputs come
back to every rank by an all-gather over ``e``, from which each combines
its own tokens.  An all-to-all over ``e`` would move nothing the ranks
of an ``e`` line do not already hold: they hold the same tokens.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..initializers import GlorotUniform, ZeroInitializer
from ..op import Op, OpContext, OpType
from ..parallel import distributed
from ..parallel.sharding import is_dtensor, redistribute
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
    # the global slot order over n, the experts over e
    collective_axes = ("n", "e")

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

    def route(self, probs: torch.Tensor, capacity: int, n_line=None):
        """(dispatch, combine, top_idx) for the (T, E) float32 router
        probabilities: the (T, E, C) float32 one-hot of each kept
        token's expert slot, the same weighted by its renormalized gate,
        and the (T, k) chosen experts.  With ``n_line`` the tokens are
        this rank's share of the batch along it, and the slots are those
        of the global token order."""
        T, E = probs.shape
        C = capacity
        # the k largest, the lower expert first among equals, as
        # jax.lax.top_k orders them (torch.topk leaves ties unordered; a
        # token that reaches the router as zeros ties every expert)
        top_probs, top_idx = torch.sort(probs, dim=-1, descending=True,
                                        stable=True)
        top_probs, top_idx = top_probs[:, :self.k], top_idx[:, :self.k]
        denom = torch.sum(top_probs, dim=-1, keepdim=True) + 1e-9
        gates_k = top_probs / denom                              # renormalized
        dispatch = torch.zeros((T, E, C), dtype=F32, device=probs.device)
        combine = torch.zeros_like(dispatch)
        ohs = [F.one_hot(top_idx[:, j], E) for j in range(self.k)]
        counts = torch.stack([oh.sum(dim=0) for oh in ohs])      # (k, E)
        before = torch.zeros_like(counts)
        if n_line is not None:
            every = distributed.gather_counts(counts, n_line)    # (N, k, E)
            before = every[:n_line.index].sum(dim=0)
            counts = every.sum(dim=0)
        base_count = torch.zeros((E,), dtype=torch.int64,
                                 device=probs.device)
        # slot-by-slot position assignment (GShard): slot 0 fills expert
        # buffers first, tokens in order; overflow positions >= C are cut
        for j in range(self.k):
            oh = ohs[j]                                          # (T, E)
            pos = (torch.cumsum(oh, dim=0) - 1 + base_count[None]
                   + before[j][None])
            base_count = base_count + counts[j]
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
        if is_dtensor(x):
            return [self._forward_mesh(params, x, ctx)]
        groups = ctx.groups or {}
        return [self._forward_local(params, x, ctx, groups.get("n"),
                                    groups.get("e"))]

    def _forward_local(self, params, x, ctx: OpContext, n_line=None,
                       e_line=None):
        """The op on local tensors: ``x`` this rank's tokens (its share of
        the batch along ``n_line``, when given) and the expert weights
        its block of the experts (a block of E / |e_line| when smaller
        than E)."""
        n, s, d = x.shape
        T, E = n * s, self.num_experts
        xt = cast_compute(x.reshape(T, d), ctx)
        gate = params[self.w_gate.name].to(F32)
        logits = torch.einsum("td,ed->te", xt.to(F32), gate)
        probs = torch.softmax(logits, dim=-1)                    # (T, E) f32
        dispatch, combine, top_idx = self.route(probs, self.capacity,
                                                n_line)
        w_up = cast_compute(params[self.w_up.name], ctx)
        w_dn = cast_compute(params[self.w_dn.name], ctx)
        mine = w_up.shape[0]
        if mine < E:
            # this rank's experts; the gradient of the tokens through
            # them is summed over the e line
            lo = e_line.index * mine
            dispatch = dispatch[:, lo:lo + mine]
            xt_e = distributed.copy_to_line(xt, e_line)
        else:
            xt_e = xt
        # (T,E,C) x (T,d) -> (E,C,d) expert batches, summed over the
        # data shards, whose tokens fill distinct slots
        xe = _mm("tec,td->ecd", cast_compute(dispatch, ctx), xt_e)
        if n_line is not None:
            xe = distributed.all_reduce(xe, n_line, grad="sum")
        xe = cast_compute(xe, ctx)
        h = _mm("ecd,efd->ecf", xe, w_up)
        h = h + params[self.w_upb.name].to(F32)[:, None, :]
        h = cast_compute(apply_activation(h, self.activation), ctx)
        y = _mm("ecf,edf->ecd", h, w_dn)
        y = y + params[self.w_dnb.name].to(F32)[:, None, :]
        y = cast_compute(y, ctx)
        if mine < E:
            # every rank combines its own tokens from all the experts
            y = distributed.all_gather(y, e_line, grad="own")
        out = _mm("tec,ecd->td", cast_compute(combine, ctx), y)

        if ctx.training and self.aux_loss_weight > 0.0:
            # Switch load-balance loss: E * sum_e (token fraction * mean
            # router prob); differentiable through P_e
            top1 = F.one_hot(top_idx[:, 0], E).to(F32)
            if n_line is None:
                f_e = torch.mean(top1, dim=0)
                p_e = torch.mean(probs, dim=0)
            else:
                # the global batch's means; every rank computes the same
                # loss term from them
                total = T * n_line.size
                f_e = distributed.all_reduce(top1.sum(dim=0), n_line,
                                             grad="same") / total
                p_e = distributed.all_reduce(probs.sum(dim=0), n_line,
                                             grad="same") / total
            ctx.aux_losses[self.name] = (self.aux_loss_weight * E
                                         * torch.sum(f_e * p_e))
        return cast_compute(out, ctx).reshape(n, s, d)

    def _forward_mesh(self, params, x, ctx: OpContext):
        """The op on DTensors: each rank runs :meth:`_forward_local` on its
        tokens (split over ``n`` where the batch divides, gathered over
        every other axis) and its block of the experts (split over ``e``
        where E divides); the output keeps the tokens' split."""
        from torch.distributed.tensor import DTensor, Partial, Replicate, \
            Shard
        mesh = ctx.mesh
        axes = mesh.dim_axes
        split = (mesh.axis_size("n") > 1
                 and x.shape[0] % mesh.axis_size("n") == 0)
        ep = (mesh.axis_size("e") > 1
              and self.num_experts % mesh.axis_size("e") == 0)
        x_pl = [Shard(0) if a == "n" and split else Replicate()
                for a in axes]
        # the tokens' shards make every weight's gradient a partial sum
        # over n; the experts stay split over e
        local = {}
        for w in self.weights:
            experts = w is not self.w_gate
            pl = [Shard(0) if a == "e" and ep and experts else Replicate()
                  for a in axes]
            gpl = [Partial() if a == "n" and split else p
                   for a, p in zip(axes, pl)]
            local[w.name] = redistribute(params[w.name], pl).to_local(
                grad_placements=gpl)
        xl = redistribute(x, x_pl).to_local(grad_placements=x_pl)
        inner = dataclasses.replace(ctx, mesh=None, out_placements={})
        y = self._forward_local(
            local, xl, inner, mesh.axis_group("n") if split else None,
            mesh.axis_group("e") if ep else None)
        if self.name in ctx.aux_losses:
            # the same loss term on every rank: a replicated DTensor, so
            # its gradient comes back as a plain tensor
            ctx.aux_losses[self.name] = DTensor.from_local(
                ctx.aux_losses[self.name], mesh.device_mesh,
                mesh.replicated(), run_check=False)
        return DTensor.from_local(y, mesh.device_mesh, x_pl,
                                  run_check=False)
