"""MultiHeadAttention and PositionEmbedding, the counterparts of the ops of
the same name in ``flexflow_tpu/ops/attention.py``: the single-device
forward and the token-generation paths (``forward_kv``, the dense-cache
``decode``, the paged ``forward_paged``/``decode_paged`` and speculative
decoding's ``verify_paged``; the position table's ``decode``,
``decode_window`` and ``forward_at``), and on a mesh the head-parallel
attention and ring attention.

On a mesh (DTensor values) the attention runs on each rank's local batch
and local heads (``parallel.sharding.shard_map``; a split sequence is
gathered first), through the same selection rule, so the flash kernels
run forward and backward on the local heads.  Where the op's strategy
(or, without one, the mesh) splits the sequence over the whole ``s``
axis, :func:`ring_attention` runs instead, as the JAX package gates it:
plain torch in both packages (einsums with an online softmax), the
key/value blocks passed round the ring of the ``s`` axis and, in the
backward, round it again with their gradients (the transpose of
``ppermute``).

Kernel selection.  The JAX rule (``_use_flash``) allows its Pallas
kernel only on a TPU, with 128-aligned sequence lengths and above a
length threshold measured on a v5e; none of that carries over.  The
port's rule:

* on a CUDA tensor the flash kernels (``ops/cuda_attention.py``, forward
  and, under autograd, backward) run, unless ``flash_attention`` is
  False in the config, or attention-probability dropout is active in
  training (the kernel never holds the probabilities, as in JAX), or
  the kernel does not take the operands (head dim above 128, or a dtype
  other than float32, bfloat16 and float16);
* otherwise, and always on the CPU, :func:`_dense_attention` runs.

There is no length threshold and no alignment rule: the kernel masks
its ragged tiles.  A kernel that fails to build or launch raises; there
is no fallback to the dense path.

In sharded generation (``GenerationEngine.from_strategy``) the paged
prefill, decode and verify walks run on each rank's local heads, whose
K/V its pools hold, and the output projection's partial products are
summed over the ``c`` line.

The decode, verify-window and paged-prefill attention is plain torch,
as the JAX package computes it outside any kernel (einsums): float32 scores, the finite
``NEG_INF`` mask keyed on global positions, probabilities rounded to v's
dtype.  The page pools are updated in place (the JAX programs donate
them).  A page id at or past the pool's end is the "no page" sentinel:
gathers clamp it (its columns are masked), and the writes name only
real pages (a prefill chunk writes its ``length`` real rows, a decode
step and a verify window the entries the caller lists), so no index
ever leaves its tensor.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..initializers import GlorotUniform, ZeroInitializer
from ..op import Op, OpContext, OpType, fold_seed, pad_degrees, snap_degrees
from ..parallel.sharding import is_dtensor, keep_shards, linear, \
    local_block, shard_map
from .common import cast_compute
from .cuda_attention import (MAX_HEAD_DIM, NEG_INF, attention_scores,
                             flash_attention,
                             flash_attention_reference, kernel_takes)

__all__ = ["MultiHeadAttention", "PositionEmbedding", "NEG_INF",
           "use_flash", "ring_attention"]


def use_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              ctx_flag, training_dropout: bool) -> bool:
    """The port's kernel selection (see the module docstring)."""
    return (q.device.type == "cuda" and ctx_flag is not False
            and not training_dropout and kernel_takes(q, k, v))


def _dense_attention(q, k, v, causal: bool, scale: float,
                     dropout_rate: float, generator, draw=None):
    """(n,sq,h,d),(n,sk,h,d),(n,sk,h,d) -> float32 (n,sq,h,d): float32
    scores and softmax, the finite ``NEG_INF`` causal mask, dropout on
    the probabilities (uniforms drawn from ``generator``, or the
    (n, h, sq, sk) block that ``draw(generator, shape)`` returns),
    probabilities rounded to v's dtype before the product."""
    if dropout_rate <= 0.0 or generator is None:
        return flash_attention_reference(q, k, v, causal, scale)
    probs = torch.softmax(attention_scores(q, k, causal, scale), dim=-1)
    keep = 1.0 - dropout_rate
    uniforms = (draw(generator, probs.shape) if draw is not None else
                torch.rand(probs.shape, generator=generator,
                           device=probs.device))
    mask = uniforms < keep
    probs = torch.where(mask, probs / keep, torch.zeros_like(probs))
    return torch.einsum("nhqk,nkhd->nqhd",
                        probs.to(v.dtype).to(torch.float32),
                        v.to(torch.float32))


class _RingAttention(torch.autograd.Function):
    """The per-rank ring body: this rank's sequence block of q against
    every rank's key/value block in turn, merged by an online softmax
    (running max, running denominator, unnormalized accumulator), as
    the JAX package's ``_ring_attention_local``.  The denominator takes
    the undropped probabilities and dropout masks the numerator only,
    which is dense attention's dropout after the softmax.

    The backward runs the ring again: the key/value blocks go round with
    their gradient accumulators, each rank adds its queries' share, and
    after a full turn each block's dK and dV are home.  ``keep(qi, kj,
    shape)`` returns the dropout keep-mask of a block pair, the same on
    every call, or is None without dropout."""

    @staticmethod
    def forward(ctx, q, k, v, ranks, idx, causal, scale, rate, keep):
        from ..parallel.distributed import ring_shift
        size = len(ranks)
        send_to, recv_from = ranks[(idx - 1) % size], ranks[(idx + 1) % size]
        f32 = torch.float32
        n, sq, h, _ = q.shape
        qf = q.to(f32)
        m = torch.full((n, h, sq), NEG_INF, dtype=f32, device=q.device)
        l = torch.zeros((n, h, sq), dtype=f32, device=q.device)
        o = torch.zeros(q.shape, dtype=f32, device=q.device)
        qpos = idx * sq + torch.arange(sq, device=q.device)
        kb, vb = k, v
        for step in range(size):
            src = (idx + step) % size
            s = _ring_scores(qf, kb, qpos, src, causal, scale)
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(dim=-1)
            pv = p
            if keep is not None:
                pv = torch.where(keep(idx, src, p.shape), p / (1.0 - rate),
                                 0.0)
            o = (o * corr.transpose(1, 2)[..., None]
                 + torch.einsum("nhqk,nkhd->nqhd", pv, vb.to(f32)))
            m = m_new
            if step < size - 1:
                kb, vb = ring_shift([kb, vb], send_to, recv_from)
        out = o / l.transpose(1, 2)[..., None]
        ctx.save_for_backward(q, k, v, out, m + torch.log(l))
        ctx.ring = (ranks, idx, causal, scale, rate, keep)
        return out

    @staticmethod
    def backward(ctx, dout):
        from ..parallel.distributed import ring_shift
        q, k, v, out, lse = ctx.saved_tensors
        ranks, idx, causal, scale, rate, keep = ctx.ring
        size = len(ranks)
        send_to, recv_from = ranks[(idx - 1) % size], ranks[(idx + 1) % size]
        f32 = torch.float32
        qf, do = q.to(f32), dout.to(f32)
        qpos = idx * q.shape[1] + torch.arange(q.shape[1], device=q.device)
        # rowsum(dP * P) = rowsum(dO * O), with dropout or without
        dvec = (do * out).sum(dim=-1).transpose(1, 2)          # (n, h, sq)
        dq = torch.zeros(q.shape, dtype=f32, device=q.device)
        dk = torch.zeros(k.shape, dtype=f32, device=q.device)
        dv = torch.zeros(v.shape, dtype=f32, device=q.device)
        kb, vb = k, v
        for step in range(size):
            src = (idx + step) % size
            s = _ring_scores(qf, kb, qpos, src, causal, scale)
            prob = torch.exp(s - lse[..., None])
            dp = torch.einsum("nqhd,nkhd->nhqk", do, vb.to(f32))
            if keep is not None:
                mask = keep(idx, src, prob.shape)
                dv = dv + torch.einsum(
                    "nhqk,nqhd->nkhd",
                    torch.where(mask, prob / (1.0 - rate), 0.0), do)
                dp = torch.where(mask, dp / (1.0 - rate), 0.0)
            else:
                dv = dv + torch.einsum("nhqk,nqhd->nkhd", prob, do)
            ds = prob * (dp - dvec[..., None])
            dq = dq + torch.einsum("nhqk,nkhd->nqhd", ds, kb.to(f32)) * scale
            dk = dk + torch.einsum("nhqk,nqhd->nkhd", ds, qf) * scale
            if step < size - 1:
                kb, vb, dk, dv = ring_shift([kb, vb, dk, dv], send_to,
                                            recv_from)
            else:
                dk, dv = ring_shift([dk, dv], send_to, recv_from)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype),
                None, None, None, None, None, None)


def _ring_scores(qf, kb, qpos, src: int, causal: bool, scale: float):
    """float32 (n, h, sq, sk) scores of this rank's queries (at global
    positions ``qpos``) against the key block of ring position ``src``,
    causally masked by global position."""
    s = torch.einsum("nqhd,nkhd->nhqk", qf, kb.to(torch.float32)) * scale
    if causal:
        sk = kb.shape[1]
        kpos = src * sk + torch.arange(sk, device=kb.device)
        s = s.masked_fill(kpos[None, None, None, :]
                          > qpos[None, None, :, None], NEG_INF)
    return s


def ring_attention(q, k, v, mesh, causal: bool, scale: float,
                   dropout_rate: float = 0.0, seed=None):
    """Sequence-parallel attention over the mesh's ``s`` axis, the
    counterpart of the JAX package's ``ring_attention``: q, k, v (n, s,
    h, d) DTensors -> float32 (n, s, h, d), one ring per ``n`` shard, the
    sequence split over the whole ``s`` axis and the heads replicated.  A
    batch that the ``n`` axis does not divide is not split (every ring
    then holds the whole batch).  ``seed`` (the op's seed for the step)
    turns dropout on at ``dropout_rate``: the keep-mask of each (query
    block, key block) pair is drawn over the global batch from the seed
    and the pair, and each rank keeps its batch shard of it."""
    n_sharded = (mesh.axis_size("n") > 1
                 and q.shape[0] % mesh.axis_size("n") == 0)
    pl = mesh.sharding(("n" if n_sharded else None, "s", None, None))
    mask_pl = keep_shards(pl, (0,))
    ranks, idx = mesh.axis_ring("s")
    rate = float(dropout_rate) if seed is not None else 0.0
    n_global = q.shape[0]

    def keep(qi, kj, shape):
        gen = torch.Generator(device=mesh.device)
        gen.manual_seed(fold_seed(int(seed), qi * len(ranks) + kj))
        draws = torch.rand((n_global,) + tuple(shape[1:]), generator=gen,
                           device=mesh.device)
        return local_block(draws, mesh, mask_pl) < 1.0 - rate

    def body(ql, kl, vl):
        return _RingAttention.apply(ql, kl, vl, ranks, idx, bool(causal),
                                    float(scale), rate,
                                    keep if rate > 0.0 else None)

    return shard_map(body, [q, k, v], [pl, pl, pl], pl)


def _position_attention(q, kg, vg, qpos, scale: float):
    """Attention of queries at global positions ``qpos`` over a gathered
    key/value view whose column j holds position j: q (n, sq, h, d), kg
    and vg (n, L, h, d), qpos (n or 1, sq) -> float32 (n, sq, h, d).
    Columns past a row's position (unwritten or stale pool rows) get the
    finite mask, whose exp is an exact 0."""
    f32 = torch.float32
    scores = torch.einsum("nqhd,nkhd->nhqk", q.to(f32), kg.to(f32)) * scale
    kpos = torch.arange(kg.shape[1], device=kg.device)
    scores = scores.masked_fill(
        kpos[None, None, None, :] > qpos[:, None, :, None], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("nhqk,nkhd->nqhd", probs.to(vg.dtype).to(f32),
                        vg.to(f32))


def _decode_attention(q, k_cache, v_cache, pos, scale: float):
    """One query a slot against its cache: q (n, 1, h, d), caches (n, L,
    h, d), ``pos`` (n,) the position of the current token, whose K/V the
    caller already wrote."""
    return _position_attention(q, k_cache, v_cache, pos[:, None], scale)


def _paged_chunk_attention(q, kg, vg, qpos, scale: float):
    """A prefill chunk's queries (1, B, h, d) at global positions ``qpos``
    (B,) against the slot's gathered page view (1, L, h, d)."""
    return _position_attention(q, kg, vg, qpos[None], scale)


def _gather_pages(pool: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """The pages a table names, in table order: pool (P, page, h, d) and
    table (..., T) -> (..., T * page, h, d).  Sentinel ids clamp to the
    last page (their columns are masked)."""
    g = pool[table.clamp(0, pool.shape[0] - 1)]
    return g.reshape(*table.shape[:-1], -1, *pool.shape[2:])


def _write_rows(pools, pages, rows, vals) -> None:
    """``pool[pages[i], rows[i]] = vals[i]`` in place, for each pool and
    its values: ``pages``/``rows`` (m,) int, in the pool; each of
    ``vals`` (m, h, d)."""
    for pool, val in zip(pools, vals):
        pool.index_put_((pages, rows), val.to(pool.dtype))


class MultiHeadAttention(Op):
    """Weights follow Linear's (out, in) layout: wq/wk/wv project the
    model dim to ``num_heads * head_dim``, wo projects back; one output
    bias."""

    op_type = OpType.ATTENTION

    def __init__(self, name, query, key, value, embed_dim, num_heads,
                 kdim=0, vdim=0, dropout=0.0, use_bias=True, causal=False,
                 kernel_initializer=None):
        inputs = [query] if key is query and value is query else [
            query, key, value]
        super().__init__(name, inputs)
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.kdim = kdim or key.shape[-1]
        self.vdim = vdim or value.shape[-1]
        if self.kdim != key.shape[-1] or self.vdim != value.shape[-1]:
            raise ValueError(f"{name}: kdim/vdim {self.kdim}/{self.vdim} do "
                             f"not match the key/value feature dims "
                             f"{key.shape[-1]}/{value.shape[-1]}")
        if embed_dim % num_heads:
            raise ValueError(f"{name}: embed_dim {embed_dim} is not a "
                             f"multiple of num_heads {num_heads}")
        self.head_dim = embed_dim // num_heads
        self.dropout, self.causal, self.use_bias = (float(dropout), causal,
                                                    use_bias)
        self._self_attn = len(inputs) == 1
        n, sq, dq = query.shape
        self._add_output((n, sq, embed_dim), query.dtype)
        init = kernel_initializer or GlorotUniform()
        # heads split over the channel axis: q/k/v by output row, the
        # output projection by input column
        self.w_q = self._add_weight((embed_dim, dq), init, "wq",
                                    sharded_dim=0)
        self.w_k = self._add_weight((embed_dim, key.shape[-1]), init, "wk",
                                    sharded_dim=0)
        self.w_v = self._add_weight((embed_dim, value.shape[-1]), init,
                                    "wv", sharded_dim=0)
        self.w_o = self._add_weight((embed_dim, embed_dim), init, "wo",
                                    sharded_dim=1)
        if use_bias:
            self.w_bias = self._add_weight((embed_dim,), ZeroInitializer(),
                                           "bias")

    def _qkv(self, params, xq, xk, xv, ctx):
        """The q/k/v projections: float32 products of compute-dtype
        operands (Linear's contract), cast back to the compute dtype and
        split into heads (those whose rows ``params`` holds: all of
        them, or a rank's local heads in sharded generation)."""
        n = xq.shape[0]
        hd = self.head_dim

        def proj(x, w):
            y = linear(x.to(torch.float32),
                       cast_compute(params[w.name], ctx).to(torch.float32),
                       None, lambda y: cast_compute(y, ctx))
            return y.reshape(n, x.shape[1], -1, hd)

        return proj(xq, self.w_q), proj(xk, self.w_k), proj(xv, self.w_v)

    def _out_proj(self, params, attn, n, sq, ctx, line=None):
        """The context -> embed output projection (+bias).  With
        ``line`` (a ``parallel.distributed.AxisGroup`` over ``c``) the
        context holds this rank's local heads and ``params`` the columns
        of ``wo`` they meet: the partial products are summed over the
        line before the bias, as GSPMD's row-parallel product."""
        attn = cast_compute(attn, ctx).reshape(n, sq, -1)
        bias = params[self.w_bias.name] if self.use_bias else None
        wo = cast_compute(params[self.w_o.name], ctx).to(torch.float32)
        if line is None:
            return linear(attn.to(torch.float32), wo, bias,
                          lambda y: cast_compute(y, ctx))
        import torch.distributed as dist
        y = F.linear(attn.to(torch.float32), wo)
        dist.all_reduce(y, group=line.group)
        if bias is not None:
            y = y + bias.to(y.dtype)
        return cast_compute(y, ctx)

    def parallel_dims(self):
        # (n, s, c): samples, sequence and heads
        return (True, True, True)

    def sub_problem(self, part_degrees):
        # batch and sequence degrees shard the inputs; the head (c)
        # degree is timed at full width (the heads' reshape is tied to
        # num_heads), an upper bound of the c-split cost
        dims = pad_degrees(part_degrees, 3)
        dn, ds = dims[0], dims[1]
        in_shapes = []
        for t in self.inputs:
            d = snap_degrees((dn, ds) + (1,) * (t.num_dims - 2), t.shape)
            in_shapes.append(t.sub_shape(d))
        return in_shapes, {w.name: w.shape for w in self.weights}

    def flops(self):
        n, s, d = self.outputs[0].shape
        proj = 4 * 2 * n * s * d * d          # q,k,v,o projections
        sk = self.inputs[0].shape[1] if self._self_attn else \
            self.inputs[1].shape[1]
        scores = 2 * 2 * n * s * sk * d       # qk^T and probs*v
        return proj + scores

    def takes_flash(self, flash_attention, device,
                    compute_dtype: str) -> bool:
        """:func:`use_flash` for this op's training step on ``device``
        in ``compute_dtype``, from its shapes alone: the kernels run on
        a CUDA device unless ``flash_attention`` is False, probability
        dropout is on (the objective is a training step), or
        ``kernel_takes`` refuses the head dim or the dtype."""
        return (torch.device(device).type == "cuda"
                and flash_attention is not False and self.dropout == 0.0
                and 1 <= self.head_dim <= MAX_HEAD_DIM
                and compute_dtype in ("float32", "bfloat16", "float16"))

    def kernel_libraries(self, config):
        return (("flash_attention",) if self.takes_flash(
            config.flash_attention, "cuda", config.compute_dtype) else ())

    def internal_io_bytes(self, flash_attention=None, device="cuda",
                          compute_dtype: str = "bfloat16"):
        """The dense path's float32 scores written and read (softmax)
        and its probabilities written and read: 12 bytes an element of
        (n, heads, sq, sk); none when the flash kernels run, whose
        scores stay on chip (:meth:`takes_flash`, the port's rule)."""
        if self.takes_flash(flash_attention, device, compute_dtype):
            return 0
        n, sq, _ = self.outputs[0].shape
        sk = self.inputs[0].shape[1] if self._self_attn else \
            self.inputs[1].shape[1]
        return 12 * n * self.num_heads * sq * sk

    def forward(self, params, inputs, ctx: OpContext):
        xq = cast_compute(inputs[0], ctx)
        xk = xq if self._self_attn else cast_compute(inputs[1], ctx)
        xv = xq if self._self_attn else cast_compute(inputs[2], ctx)
        n, sq, _ = xq.shape
        q, k, v = self._qkv(params, xq, xk, xv, ctx)
        scale = 1.0 / math.sqrt(self.head_dim)
        rate = self.dropout if ctx.training else 0.0
        gen = None
        if ctx.training and self.dropout > 0.0:
            gen = ctx.op_generator(self.outputs[0].uid)
        if not is_dtensor(q):
            attn = self._attend(q, k, v, scale, rate, gen, ctx)
        elif self._wants_ring(ctx.mesh):
            attn = ring_attention(q, k, v, ctx.mesh, self.causal, scale,
                                  rate, None if gen is None
                                  else gen.initial_seed())
        else:
            # each rank attends with its local batch and heads; the
            # dropout uniforms are drawn for the global (n, h, sq, sk)
            # and each rank keeps its block
            from torch.distributed.tensor import Shard
            pl = keep_shards(q.placements, (0, 2))
            # the probabilities are (n, h, sq, sk): q's heads, its dim 2,
            # are their dim 1
            mask_pl = [Shard(1) if isinstance(p, Shard) and p.dim == 2
                       else p for p in pl]
            mesh = ctx.mesh

            def draw(generator, shape):
                full = torch.rand((q.shape[0], q.shape[2]) + tuple(
                    shape[2:]), generator=generator, device=mesh.device)
                return local_block(full, mesh, mask_pl)

            attn = shard_map(
                lambda ql, kl, vl: self._attend(ql, kl, vl, scale, rate,
                                                gen, ctx, draw),
                [q, k, v], [pl, pl, pl], pl)
        return [self._out_proj(params, attn, n, sq, ctx)]

    def _attend(self, q, k, v, scale, rate, gen, ctx, draw=None):
        """Attention of one device or of one rank's local shard, by the
        port's selection rule: the flash kernels, or the dense path."""
        if use_flash(q, k, v, ctx.flash_attention, gen is not None):
            return flash_attention(q, k, v, self.causal, scale)
        return _dense_attention(q, k, v, self.causal, scale, rate, gen,
                                draw)

    def _wants_ring(self, mesh) -> bool:
        """The JAX package's gate: self-attention on a mesh with an ``s``
        axis, whose strategy splits the sequence over the whole axis
        (no strategy counts as the whole axis), with a sequence that
        the axis divides."""
        if mesh.axis_size("s") <= 1 or not self._self_attn:
            return False
        pc = self.parallel_config
        s_deg = (pc.dims[1] if pc is not None and len(pc.dims) >= 2
                 else mesh.axis_size("s"))
        return (s_deg == mesh.axis_size("s")
                and self.inputs[0].shape[1] % s_deg == 0)

    # ---- token generation ------------------------------------------------
    def _check_decodable(self, what: str) -> None:
        if not (self._self_attn and self.causal):
            raise ValueError(f"{self.name}: {what} needs causal "
                             f"self-attention")

    def forward_kv(self, params, inputs, ctx: OpContext):
        """The forward that also returns the per-position K/V (n, s, h,
        hd) to seed a decode cache.  Causal self-attention only; on a
        CUDA tensor the causal flash kernel runs under :func:`use_flash`
        (no dropout: this is inference)."""
        self._check_decodable("prefill")
        xq = cast_compute(inputs[0], ctx)
        n, sq, _ = xq.shape
        q, k, v = self._qkv(params, xq, xq, xq, ctx)
        scale = 1.0 / math.sqrt(self.head_dim)
        if use_flash(q, k, v, ctx.flash_attention, False):
            attn = flash_attention(q, k, v, True, scale)
        else:
            attn = _dense_attention(q, k, v, True, scale, 0.0, None)
        return [self._out_proj(params, attn, n, sq, ctx)], k, v

    def forward_paged(self, params, x, k_pool, v_pool, table_row, start,
                      length, ctx: OpContext, line=None):
        """One prefill chunk against the paged cache: project the chunk,
        write its K/V rows into the slot's pages, attend each query over
        the slot's whole gathered table (history pages and the chunk),
        masked on global positions.  ``x`` (1, B, d) holds positions
        ``start .. start+B-1``, of which the first ``length`` are real
        (only those are written; the pad rows' outputs are ignored);
        ``k_pool``/``v_pool`` (num_pages, page, h, hd) are updated in
        place and returned; ``table_row`` (pages_per_slot,) int page ids,
        real at the chunk's real positions, the sentinel at unallocated
        entries.  With ``line`` the walk runs on this rank's local heads
        (``params`` and the pools hold them; see :meth:`_out_proj`)."""
        self._check_decodable("paged prefill")
        xq = cast_compute(x, ctx)
        n, b, _ = xq.shape
        q, k, v = self._qkv(params, xq, xq, xq, ctx)
        page = k_pool.shape[1]
        qpos = start + torch.arange(b, device=xq.device)
        real = qpos[:length]
        _write_rows((k_pool, v_pool), table_row[real // page], real % page,
                    (k[0, :length], v[0, :length]))
        attn = _paged_chunk_attention(
            q, _gather_pages(k_pool, table_row)[None],
            _gather_pages(v_pool, table_row)[None], qpos,
            1.0 / math.sqrt(self.head_dim))
        return [self._out_proj(params, attn, n, b, ctx, line)], k_pool, \
            v_pool

    def decode_paged(self, params, x, k_pool, v_pool, table, pos,
                     write_slots, write_pages, write_rows,
                     ctx: OpContext, line=None):
        """One decode step against the paged cache: project each slot's
        current token, write the K/V of slot ``write_slots[i]`` at
        ``(write_pages[i], write_rows[i])``, gather each slot's table and
        attend.  The JAX op takes a write for every slot, the sentinel
        for inactive and prefilling ones (dropped); here the caller
        lists only the slots that write (``decoder.kept_writes``).
        ``x`` (slots, 1, d); ``table`` (slots, pages_per_slot); ``pos``
        (slots,) the current positions; the write triple (m,) for
        m <= slots.  The pools are updated in place and returned; with
        ``line``, as :meth:`forward_paged`, on the local heads."""
        n = x.shape[0]
        xq = cast_compute(x, ctx)
        q, k, v = self._qkv(params, xq, xq, xq, ctx)
        _write_rows((k_pool, v_pool), write_pages, write_rows,
                    (k[write_slots, 0], v[write_slots, 0]))
        attn = _decode_attention(q, _gather_pages(k_pool, table),
                                 _gather_pages(v_pool, table), pos,
                                 1.0 / math.sqrt(self.head_dim))
        return [self._out_proj(params, attn, n, 1, ctx, line)], k_pool, \
            v_pool

    def verify_paged(self, params, x, k_pool, v_pool, table, pos,
                     write_slots, write_cols, write_pages, write_rows,
                     ctx: OpContext, line=None):
        """A speculative verify window against the paged cache: project
        W tokens a slot, write the K/V of window entry ``(write_slots[i],
        write_cols[i])`` at ``(write_pages[i], write_rows[i])``, gather
        each slot's table and attend every window row over it, causally
        masked on global positions.  The JAX op takes a (slots, W) write
        grid with the sentinel where nothing is written (dropped by
        ``mode="drop"``); here the caller lists only the real writes
        (``decoder.kept_window_writes``).  ``x`` (slots, W, d) at
        positions ``pos[i] .. pos[i]+W-1``; ``table`` (slots,
        pages_per_slot); ``pos`` (slots,); the write lists (m,).
        The attention is the chunk attention batched over slots, masked
        on each slot's global positions, so a window's later rows and the
        rows a rejected round left behind stay invisible until a later
        round overwrites them: they need no cleanup.  The pools are
        updated in place and returned; with ``line``, as
        :meth:`forward_paged`, on the local heads."""
        n, w, _ = x.shape
        xq = cast_compute(x, ctx)
        q, k, v = self._qkv(params, xq, xq, xq, ctx)
        _write_rows((k_pool, v_pool), write_pages, write_rows,
                    (k[write_slots, write_cols], v[write_slots, write_cols]))
        qpos = pos[:, None] + torch.arange(w, device=xq.device)[None, :]
        attn = _position_attention(
            q, _gather_pages(k_pool, table), _gather_pages(v_pool, table),
            qpos, 1.0 / math.sqrt(self.head_dim))
        return [self._out_proj(params, attn, n, w, ctx, line)], k_pool, \
            v_pool

    def decode(self, params, x, k_cache, v_cache, pos, ctx: OpContext):
        """One decode step against the dense per-slot cache: write the
        current token's K/V at ``pos`` (clamped into the cache, as
        ``dynamic_update_slice`` clamps) and attend.  ``x`` (slots, 1,
        d); caches (slots, max_seq, h, hd), updated in place and
        returned; ``pos`` (slots,)."""
        n = x.shape[0]
        xq = cast_compute(x, ctx)
        q, k, v = self._qkv(params, xq, xq, xq, ctx)
        at = pos.clamp(0, k_cache.shape[1] - 1)
        slots = torch.arange(n, device=xq.device)
        k_cache.index_put_((slots, at), k[:, 0].to(k_cache.dtype))
        v_cache.index_put_((slots, at), v[:, 0].to(v_cache.dtype))
        attn = _decode_attention(q, k_cache, v_cache, pos,
                                 1.0 / math.sqrt(self.head_dim))
        return [self._out_proj(params, attn, n, 1, ctx)], k_cache, v_cache


class PositionEmbedding(Op):
    """Learned absolute position table added to a (n, s, d) sequence."""

    op_type = OpType.EMBEDDING

    def __init__(self, name, input_tensor, max_len=None,
                 kernel_initializer=None):
        super().__init__(name, [input_tensor])
        n, s, d = input_tensor.shape
        self.max_len = max_len or s
        if self.max_len < s:
            raise ValueError(f"{name}: max_len {self.max_len} is shorter "
                             f"than the sequence ({s})")
        self._add_output((n, s, d), input_tensor.dtype)
        self.w_table = self._add_weight(
            (self.max_len, d), kernel_initializer or GlorotUniform(), "table")

    def parallel_dims(self):
        return (True, True, False)

    def flops(self):
        return self.outputs[0].volume

    def forward(self, params, inputs, ctx: OpContext):
        x = inputs[0]
        table = params[self.w_table.name][: x.shape[1]]
        return [x + cast_compute(table, ctx)[None]]

    def _rows(self, params, pos: torch.Tensor) -> torch.Tensor:
        # positions past the table clamp to its last row (pad rows only;
        # the JAX gather fills them with NaN)
        return params[self.w_table.name][pos.clamp(0, self.max_len - 1)]

    def decode(self, params, x, pos, ctx: OpContext):
        """``x`` (slots, 1, d) plus the table row at each slot's position
        ``pos`` (slots,)."""
        return [x + cast_compute(self._rows(params, pos), ctx)[:, None, :]]

    def decode_window(self, params, x, pos, ctx: OpContext):
        """A verify window ``x`` (slots, W, d) at global positions
        ``pos[i] .. pos[i]+W-1`` plus those table rows: row for row what
        :meth:`decode` adds one position at a time."""
        qpos = pos[:, None] + torch.arange(x.shape[1], device=x.device)
        return [x + cast_compute(self._rows(params, qpos), ctx)]

    def forward_at(self, params, x, start, ctx: OpContext):
        """A prefill chunk ``x`` (1, B, d) at global positions ``start ..
        start+B-1`` plus those table rows."""
        pos = start + torch.arange(x.shape[1], device=x.device)
        return [x + cast_compute(self._rows(params, pos), ctx)[None]]
