"""MultiHeadAttention and PositionEmbedding, the counterparts of the ops of
the same name in ``flexflow_tpu/ops/attention.py``: the single-device
forward and the token-generation paths (``forward_kv``, the dense-cache
``decode``, the paged ``forward_paged``/``decode_paged`` and speculative
decoding's ``verify_paged``; the position table's ``decode``,
``decode_window`` and ``forward_at``).  Ring attention comes with the
multi-device slice.

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
from ..op import Op, OpContext, OpType
from .common import cast_compute
from .cuda_attention import (NEG_INF, attention_scores, flash_attention,
                             flash_attention_reference, kernel_takes)

__all__ = ["MultiHeadAttention", "PositionEmbedding", "NEG_INF",
           "use_flash"]


def use_flash(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              ctx_flag, training_dropout: bool) -> bool:
    """The port's kernel selection (see the module docstring)."""
    return (q.device.type == "cuda" and ctx_flag is not False
            and not training_dropout and kernel_takes(q, k, v))


def _dense_attention(q, k, v, causal: bool, scale: float,
                     dropout_rate: float, generator):
    """(n,sq,h,d),(n,sk,h,d),(n,sk,h,d) -> float32 (n,sq,h,d): float32
    scores and softmax, the finite ``NEG_INF`` causal mask, dropout on
    the probabilities (mask drawn from ``generator``), probabilities
    rounded to v's dtype before the product."""
    if dropout_rate <= 0.0 or generator is None:
        return flash_attention_reference(q, k, v, causal, scale)
    probs = torch.softmax(attention_scores(q, k, causal, scale), dim=-1)
    keep = 1.0 - dropout_rate
    mask = torch.rand(probs.shape, generator=generator,
                      device=probs.device) < keep
    probs = torch.where(mask, probs / keep, torch.zeros_like(probs))
    return torch.einsum("nhqk,nkhd->nqhd",
                        probs.to(v.dtype).to(torch.float32),
                        v.to(torch.float32))


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
        split into heads."""
        n = xq.shape[0]
        h, hd = self.num_heads, self.head_dim

        def proj(x, w):
            y = F.linear(x.to(torch.float32),
                         cast_compute(params[w.name], ctx).to(torch.float32))
            return cast_compute(y, ctx).reshape(n, x.shape[1], h, hd)

        return proj(xq, self.w_q), proj(xk, self.w_k), proj(xv, self.w_v)

    def _out_proj(self, params, attn, n, sq, ctx):
        """The context -> embed output projection (+bias)."""
        attn = cast_compute(attn, ctx).reshape(n, sq, self.embed_dim)
        out = F.linear(attn.to(torch.float32),
                       cast_compute(params[self.w_o.name],
                                    ctx).to(torch.float32))
        if self.use_bias:
            out = out + params[self.w_bias.name].to(out.dtype)
        return cast_compute(out, ctx)

    def parallel_dims(self):
        # (n, s, c): samples, sequence and heads
        return (True, True, True)

    def forward(self, params, inputs, ctx: OpContext):
        xq = cast_compute(inputs[0], ctx)
        xk = xq if self._self_attn else cast_compute(inputs[1], ctx)
        xv = xq if self._self_attn else cast_compute(inputs[2], ctx)
        n, sq, _ = xq.shape
        q, k, v = self._qkv(params, xq, xk, xv, ctx)
        scale = 1.0 / math.sqrt(self.head_dim)
        gen = None
        if ctx.training and self.dropout > 0.0:
            gen = ctx.op_generator(self.outputs[0].uid)
        if use_flash(q, k, v, ctx.flash_attention, gen is not None):
            attn = flash_attention(q, k, v, self.causal, scale)
        else:
            attn = _dense_attention(q, k, v, self.causal, scale,
                                    self.dropout if ctx.training else 0.0,
                                    gen)
        return [self._out_proj(params, attn, n, sq, ctx)]

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
                      length, ctx: OpContext):
        """One prefill chunk against the paged cache: project the chunk,
        write its K/V rows into the slot's pages, attend each query over
        the slot's whole gathered table (history pages and the chunk),
        masked on global positions.  ``x`` (1, B, d) holds positions
        ``start .. start+B-1``, of which the first ``length`` are real
        (only those are written; the pad rows' outputs are ignored);
        ``k_pool``/``v_pool`` (num_pages, page, h, hd) are updated in
        place and returned; ``table_row`` (pages_per_slot,) int page ids,
        real at the chunk's real positions, the sentinel at unallocated
        entries."""
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
        return [self._out_proj(params, attn, n, b, ctx)], k_pool, v_pool

    def decode_paged(self, params, x, k_pool, v_pool, table, pos,
                     write_slots, write_pages, write_rows,
                     ctx: OpContext):
        """One decode step against the paged cache: project each slot's
        current token, write the K/V of slot ``write_slots[i]`` at
        ``(write_pages[i], write_rows[i])``, gather each slot's table and
        attend.  The JAX op takes a write for every slot, the sentinel
        for inactive and prefilling ones (dropped); here the caller
        lists only the slots that write (``decoder.kept_writes``).
        ``x`` (slots, 1, d); ``table`` (slots, pages_per_slot); ``pos``
        (slots,) the current positions; the write triple (m,) for
        m <= slots.  The pools are updated in place and returned."""
        n = x.shape[0]
        xq = cast_compute(x, ctx)
        q, k, v = self._qkv(params, xq, xq, xq, ctx)
        _write_rows((k_pool, v_pool), write_pages, write_rows,
                    (k[write_slots, 0], v[write_slots, 0]))
        attn = _decode_attention(q, _gather_pages(k_pool, table),
                                 _gather_pages(v_pool, table), pos,
                                 1.0 / math.sqrt(self.head_dim))
        return [self._out_proj(params, attn, n, 1, ctx)], k_pool, v_pool

    def verify_paged(self, params, x, k_pool, v_pool, table, pos,
                     write_slots, write_cols, write_pages, write_rows,
                     ctx: OpContext):
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
        updated in place and returned."""
        n, w, _ = x.shape
        xq = cast_compute(x, ctx)
        q, k, v = self._qkv(params, xq, xq, xq, ctx)
        _write_rows((k_pool, v_pool), write_pages, write_rows,
                    (k[write_slots, write_cols], v[write_slots, write_cols]))
        qpos = pos[:, None] + torch.arange(w, device=xq.device)[None, :]
        attn = _position_attention(
            q, _gather_pages(k_pool, table), _gather_pages(v_pool, table),
            qpos, 1.0 / math.sqrt(self.head_dim))
        return [self._out_proj(params, attn, n, w, ctx)], k_pool, v_pool

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
