"""PipelineTransformerBlock and PipelineSegment, the counterparts of the
ops of the same name in ``flexflow_tpu/ops/pipeline.py``: a stack of
stages run as a pipeline over the ``p`` mesh axis
(``parallel/pipeline.py``).

Every stage's weights are stacked on a leading stage dim, under the JAX
package's names, and split over ``p``, so each rank holds its own
stages.  Off a pipeline mesh the same stacked weights run stage after
stage over the whole batch, in the schedule's traversal order.

The block's stage is the JAX package's encoder block: einsum attention
(plain torch here, as it is XLA there; no flash kernel in either
package), then ``ln(x + attn)``, the GELU feed-forward and ``ln(t +
ffn)``.  Those two residual LayerNorms run the fused LayerNorm kernel
with its residual operand (``ops/cuda_norm.py``; float32 operands,
float32 out) on a CUDA tensor, and its plain version on a CPU tensor,
as every LayerNorm of the port does (``ops/norm.py``).

On a mesh (DTensor values) the pipeline runs per rank on local tensors:
the batch keeps its split over ``n``, the stacked weights their splits
over ``p`` and, for expert-stacked inner weights, ``e``; a split over
``c`` is gathered, so a stage's products run whole on each rank.  The
gradients of the weights are partial sums over ``n``.  A stage that
mixes rows (a MoE routes over the microbatch's tokens) sees the JAX
package's microbatches, which are slices of the global batch: each
rank takes its share of every global microbatch, and the outputs are
gathered back into the batch's order after the pipeline.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict

import torch
import torch.nn.functional as F

from ..initializers import ConstantInitializer, GlorotUniform, ZeroInitializer
from ..op import Op, OpContext, OpType
from ..parallel import distributed
from ..parallel.pipeline import pipeline_apply
from ..parallel.sharding import is_dtensor, redistribute
from .common import cast_compute
from .cuda_norm import fused_layernorm_autograd

F32 = torch.float32


class _StackedInit:
    """Stacks a base initializer over the stages: stage i draws like an
    unstacked weight, one after the other from the generator."""

    def __init__(self, base, stages: int):
        self.base, self.stages = base, stages

    def __call__(self, generator, shape, dtype):
        return torch.stack([self.base(generator, tuple(shape[1:]), dtype)
                            for _ in range(self.stages)])


def _mm(spec: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """An einsum of compute-dtype operands in float32, with a float32
    result (the JAX einsums' ``preferred_element_type=float32``)."""
    return torch.einsum(spec, a.to(F32), b.to(F32))


def run_pipeline(op, stacked: Dict[str, torch.Tensor], x, ctx: OpContext,
                 make_stage: Callable, mixes_rows: bool):
    """``pipeline_apply`` of ``op``'s stages over ``x``: on plain tensors
    as it is, on DTensors per rank (see the module note).  ``stacked``
    maps the stage function's names to the stacked values;
    ``make_stage(ctx)`` builds the
    stage function for the context its ops run under.  Returns (y,
    aux), on a mesh y placed as x's batch is and aux replicated."""
    kw = dict(num_microbatches=op.num_microbatches, schedule=op.schedule,
              virtual_stages=op.virtual_stages)
    if not is_dtensor(x):
        return pipeline_apply(make_stage(ctx), stacked, x, op.num_stages,
                              **kw)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = ctx.mesh
    line = mesh.axis_group("p")
    S = 1 if line is None else line.size
    M = op.num_microbatches or S
    B, Nn = x.shape[0], mesh.axis_size("n")
    per = M if S > 1 else 1
    split = Nn > 1 and B % (Nn * per) == 0
    # a row-mixing stage needs the global microbatches: each rank takes
    # its share of each from the whole batch (below)
    permute = split and mixes_rows and S > 1 and M > 1
    axes = mesh.dim_axes
    x_pl = [Shard(0) if a == "n" and split and not permute else Replicate()
            for a in axes]
    # only the first stage reads x, and under ``permute`` each rank its
    # own rows: the gradient is a partial sum there
    x_gpl = [Partial() if (a == "p" and S > 1)
             or (a == "n" and permute) else p for a, p in zip(axes, x_pl)]
    loc_x = redistribute(x, x_pl).to_local(grad_placements=x_gpl)
    loc_w = {}
    for k, w in stacked.items():
        pl = [p if isinstance(p, Shard) and a in ("p", "e") else Replicate()
              for a, p in zip(axes, w.placements)]
        gpl = [Partial() if a == "n" and split else p
               for a, p in zip(axes, pl)]
        loc_w[k] = redistribute(w, pl).to_local(grad_placements=gpl)
    n_line = mesh.axis_group("n") if split else None
    inner = dataclasses.replace(ctx, mesh=None, out_placements={},
                                groups={"n": n_line,
                                        "e": mesh.axis_group("e")})
    if permute:
        b = B // (Nn * M)
        rows = torch.tensor([m * (B // M) + n_line.index * b + i
                             for m in range(M) for i in range(b)],
                            device=loc_x.device)
        loc_x = loc_x.index_select(0, rows)
    y, aux = pipeline_apply(make_stage(inner), loc_w, loc_x, op.num_stages,
                            line, **kw)
    if permute:
        # (rank, microbatch, row) back to the batch's (microbatch, rank,
        # row) order; this rank keeps its block of it
        full = distributed.all_gather(y, n_line, grad="sum")
        full = full.reshape((Nn, M, b) + tuple(y.shape[1:])).transpose(
            0, 1).reshape((B,) + tuple(y.shape[1:]))
        y = full.chunk(Nn)[n_line.index]
    y_pl = [Shard(0) if a == "n" and split else Replicate() for a in axes]
    # aux is the same on every rank: replicated, so its gradient comes
    # back as a plain tensor
    return (DTensor.from_local(y, mesh.device_mesh, y_pl, run_check=False),
            DTensor.from_local(aux, mesh.device_mesh, mesh.replicated(),
                               run_check=False))


class PipelineTransformerBlock(Op):
    op_type = OpType.PIPELINE
    collective_axes = ("n", "e", "p")

    def __init__(self, name, input_tensor, num_stages, num_heads,
                 d_ff, num_microbatches=None, eps=1e-5,
                 kernel_initializer=None, schedule="gpipe",
                 virtual_stages=None):
        super().__init__(name, [input_tensor])
        n, s, d = input_tensor.shape
        assert d % num_heads == 0, (d, num_heads)
        self.num_stages = int(num_stages)
        self.num_heads = num_heads
        self.head_dim = d // num_heads
        self.d_ff, self.eps = d_ff, eps
        self.num_microbatches = num_microbatches
        # "gpipe" or "interleaved" (virtual_stages chunks per rank)
        self.schedule = schedule
        self.virtual_stages = virtual_stages
        self._add_output((n, s, d), input_tensor.dtype)
        S = self.num_stages
        base = kernel_initializer or GlorotUniform()
        ones = ConstantInitializer(1.0)
        zeros = ZeroInitializer()

        def w(shape, init, nm):
            p = self._add_weight((S,) + shape, _StackedInit(init, S), nm,
                                 sharded_dim=0)
            p.shard_axis = "p"
            return p

        self.w_q = w((d, d), base, "wq")
        self.w_k = w((d, d), base, "wk")
        self.w_v = w((d, d), base, "wv")
        self.w_o = w((d, d), base, "wo")
        self.w_ab = w((d,), zeros, "attn_bias")
        self.w_ln1s = w((d,), ones, "ln1_scale")
        self.w_ln1b = w((d,), zeros, "ln1_bias")
        self.w_up = w((d_ff, d), base, "ffn_up")
        self.w_upb = w((d_ff,), zeros, "ffn_up_bias")
        self.w_dn = w((d, d_ff), base, "ffn_down")
        self.w_dnb = w((d,), zeros, "ffn_down_bias")
        self.w_ln2s = w((d,), ones, "ln2_scale")
        self.w_ln2b = w((d,), zeros, "ln2_bias")

    def _stage_fn(self, ctx: OpContext):
        h, hd = self.num_heads, self.head_dim
        scale = 1.0 / math.sqrt(hd)
        eps = self.eps

        def ln(x, s, b, res):
            # the residual LayerNorm: the fused kernel on a CUDA tensor
            return fused_layernorm_autograd(x, res, s, b, eps, F32)

        def block(p, x):
            xc = cast_compute(x, ctx)
            n, s, d = xc.shape

            def proj(w):
                y = _mm("nsi,oi->nso", xc, cast_compute(p[w], ctx))
                return cast_compute(y, ctx).reshape(n, s, h, hd)

            q, k, v = proj("wq"), proj("wk"), proj("wv")
            scores = _mm("nqhd,nkhd->nhqk", q, k) * scale
            probs = torch.softmax(scores, dim=-1)
            attn = _mm("nhqk,nkhd->nqhd", probs.to(v.dtype), v)
            attn = cast_compute(attn, ctx).reshape(n, s, d)
            attn = _mm("nsi,oi->nso", attn, cast_compute(p["wo"], ctx))
            attn = attn + p["attn_bias"].to(attn.dtype)
            t = ln(attn, p["ln1_scale"], p["ln1_bias"], x)
            tc = cast_compute(t, ctx)
            up = _mm("nsi,oi->nso", tc, cast_compute(p["ffn_up"], ctx))
            up = F.gelu(up + p["ffn_up_bias"].to(up.dtype),
                        approximate="tanh")
            dn = _mm("nsi,oi->nso", cast_compute(up, ctx),
                     cast_compute(p["ffn_down"], ctx))
            dn = dn + p["ffn_down_bias"].to(dn.dtype)
            out = ln(dn, p["ln2_scale"], p["ln2_bias"], t)
            return out.to(x.dtype)

        return block

    def _weights(self) -> dict:
        return {"wq": self.w_q, "wk": self.w_k, "wv": self.w_v,
                "wo": self.w_o, "attn_bias": self.w_ab,
                "ln1_scale": self.w_ln1s, "ln1_bias": self.w_ln1b,
                "ffn_up": self.w_up, "ffn_up_bias": self.w_upb,
                "ffn_down": self.w_dn, "ffn_down_bias": self.w_dnb,
                "ln2_scale": self.w_ln2s, "ln2_bias": self.w_ln2b}

    def forward(self, params, inputs, ctx: OpContext):
        x = inputs[0].to(F32)
        names = self._weights()
        stacked = {k: params[p.name] for k, p in names.items()}
        y, _ = run_pipeline(self, stacked, x, ctx, self._stage_fn,
                            mixes_rows=False)
        return [cast_compute(y, ctx)]

    def parallel_dims(self):
        # data parallelism over samples composes with the pipeline
        return (True, False, False)

    def flops(self):
        n, s, d = self.outputs[0].shape
        per_block = (4 * 2 * n * s * d * d + 2 * 2 * n * s * s * d
                     + 2 * 2 * n * s * d * self.d_ff)
        return self.num_stages * per_block


class PipelineSegment(Op):
    """A pipeline over stages whose body is any FFModel subgraph.

    ``stage_builder(seg, t) -> Tensor`` builds one stage against a fresh
    throwaway FFModel ``seg`` (on the outer model's device) and a probe
    tensor ``t``; the output must keep ``t``'s shape.  Every weight the
    subgraph declares is declared here again, stacked over the stage dim
    and split over ``p``, under ``<segment>/<inner weight name>``; each
    tick runs the inner ops' forwards on a stage's slices.  A ``c``-split
    inner weight keeps its split dim (``inner_sharded_dim``, shifted by
    the stage dim) and an expert-stacked one splits its expert dim over
    ``e`` inside the stage.

    The inner ops' auxiliary losses (MoE's load balance) are summed per
    microbatch over the valid ticks and divided by the microbatches, and
    surface as this op's entry of ``ctx.aux_losses``.  Running-statistic
    updates (BatchNorm in training) cannot leave the stages and are
    refused."""

    op_type = OpType.PIPELINE
    collective_axes = ("n", "e", "p")

    def __init__(self, name, input_tensor, num_stages, stage_builder,
                 config, num_microbatches=None, schedule="gpipe",
                 virtual_stages=None, device=None):
        super().__init__(name, [input_tensor])
        from ..model import FFModel

        self.num_stages = int(num_stages)
        self.num_microbatches = num_microbatches
        self.schedule = schedule
        self.virtual_stages = virtual_stages
        # trace the stage subgraph once against a probe tensor
        seg = FFModel(config, device=device)
        probe = seg.create_tensor(input_tensor.shape, input_tensor.dtype,
                                  name=f"{name}_probe")
        out = stage_builder(seg, probe)
        if tuple(out.shape) != tuple(input_tensor.shape):
            raise ValueError(
                f"pipeline stage must preserve the activation shape "
                f"(ring invariance): {input_tensor.shape} -> {out.shape}")
        self._seg_layers = seg.layers
        self._probe_uid = probe.uid
        self._out_uid = out.uid
        self._add_output(tuple(input_tensor.shape), input_tensor.dtype)
        # re-declare every subgraph weight stacked over the stage dim
        S = self.num_stages
        self._wmap = {}  # inner weight name -> stacked Parameter
        for op in self._seg_layers:
            for w in op.weights:
                p = self._add_weight((S,) + tuple(w.shape),
                                     _StackedInit(w.initializer
                                                  or GlorotUniform(), S),
                                     w.name, sharded_dim=0)
                p.shard_axis = "p"
                if w.sharded_dim is not None and w.shard_axis == "c":
                    p.inner_sharded_dim = w.sharded_dim + 1
                elif w.shard_axis == "e":
                    # an expert-stacked MoE weight: its expert dim splits
                    # over 'e' inside the stage
                    p.inner_sharded_dim = (w.sharded_dim or 0) + 1
                    p.inner_shard_axis = "e"
                self._wmap[w.name] = p
        # a MoE routes over the tokens of its microbatch
        from .moe import MoE
        self._mixes_rows = any(isinstance(op, MoE)
                               for op in self._seg_layers)

    def _stage_fn(self, ctx: OpContext):
        layers, probe_uid, out_uid = (self._seg_layers, self._probe_uid,
                                      self._out_uid)

        def run(stage_params, x):
            inner = dataclasses.replace(ctx, aux_losses={}, updates={})
            values = {probe_uid: x}
            for op in layers:
                ins = [values[t.uid] for t in op.inputs]
                p = {w.name: stage_params[w.name] for w in op.weights}
                outs = op.forward(p, ins, inner)
                for t, v in zip(op.outputs, outs):
                    values[t.uid] = v
            if inner.updates:
                raise ValueError(
                    "ops with running-stat updates (batchnorm) are not "
                    "supported inside pipeline stages — their state "
                    "cannot escape the pipeline scan")
            aux = (sum(inner.aux_losses.values()) if inner.aux_losses
                   else torch.zeros((), dtype=F32, device=x.device))
            return values[out_uid].to(x.dtype), aux

        return run

    def forward(self, params, inputs, ctx: OpContext):
        x = inputs[0].to(F32)
        stacked = {inner: params[p.name] for inner, p in self._wmap.items()}
        y, aux = run_pipeline(self, stacked, x, ctx, self._stage_fn,
                              self._mixes_rows)
        ctx.aux_losses[self.name] = aux
        return [cast_compute(y, ctx)]

    def parallel_dims(self):
        # data parallelism over samples composes with the pipeline
        nd = self.outputs[0].num_dims
        return (True,) + (False,) * (nd - 1)

