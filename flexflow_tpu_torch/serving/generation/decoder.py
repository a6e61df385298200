"""GraphDecoder — autoregressive execution of an FFModel graph over a
paged KV cache, the port of ``flexflow_tpu/serving/generation/decoder.py``.

Both halves come from the layer list itself:

* **prefill chunk** — the forward over a ``(1, bucket)`` padded chunk of
  prompt positions ``start .. start+length-1``: position-wise ops run
  their forward, attention runs ``forward_paged`` (write the chunk's K/V
  into the slot's pages, attend over the slot's gathered table), the
  position table ``forward_at``, the LSTM ``forward_states`` (whole-prompt
  chunks only: cell state does not page).  Buckets are powers of two
  from 2 up to ``max_seq``.
* **decode** — one step for the whole ``slots``-wide batch: embed each
  slot's current token, run every layer's single-position path (K/V
  written at each slot's host-computed ``(write_page, write_row)``, the
  sentinel for inactive and prefilling slots; the host drops those
  before the upload), argmax (or sample) the next token.
* **speculative decoding** — the draft (``draft_fn``): gamma decode
  steps of a draft graph back to back, each proposal fed to the next
  step on the device; the verify (``verify_fn``): the target's walk
  over a W-token window per slot (attention ``verify_paged``, the
  position table ``decode_window``), then the greedy argmax match or
  the sampled rejection test (``sampling.speculative_accept``).

The functions run eagerly under ``torch.inference_mode()`` on the
model's device, update the pool tensors in place (the JAX programs
donate them) and return the next tokens as device tensors; the caller
fetches them once (a speculative round: once after the verify, none
between the draft's steps).  The host's index arrays go to the device in
one copy a call.  Pool geometry comes from ``analysis.kv_memory`` and the
tensors from ``pages.alloc_pool_arrays``.

Supported graphs: one (n, s) integer token input; position-wise ops
(dense, norms, elementwise, softmax, dropout), sequence-mode embeddings,
causal self-attention, LSTMs without an external initial state, learned
position tables.  Anything else is refused at construction.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from ...analysis.kv_memory import (DEFAULT_PAGE_SIZE, default_num_pages,
                                   kv_cache_layout, pages_per_slot)
from ...op import OpContext, OpType
from ...ops.attention import MultiHeadAttention, PositionEmbedding
from ...ops.common import resolve_op_dtype
from ...ops.linear import Embedding
from ...ops.rnn import LSTM
from . import sampling
from .pages import alloc_pool_arrays

# ops that act position-wise over the sequence dim: running them on a
# (slots, 1, d) activation is the decode step
_POINTWISE_TYPES = (OpType.LINEAR, OpType.LAYERNORM, OpType.RMSNORM,
                    OpType.ELEMENT_UNARY, OpType.ELEMENT_BINARY,
                    OpType.SOFTMAX, OpType.DROPOUT)


def kept_writes(write_pages, write_rows, num_pages: int):
    """The decode step's writes that name a page: (slots, pages, rows)
    host arrays of the slots whose write page lies in the pool (the
    others carry the "no page" sentinel and write nothing)."""
    wp = np.asarray(write_pages)
    keep = np.flatnonzero(wp < num_pages)
    return keep, wp[keep], np.asarray(write_rows)[keep]


def kept_window_writes(write_pages, write_rows, num_pages: int):
    """The verify window's writes that name a page, from the (slots, W)
    host grids of the JAX op's form: (slots, columns, pages, rows) host
    arrays of the entries whose page lies in the pool (inactive slots
    and positions past ``max_seq`` carry the sentinel)."""
    wp = np.asarray(write_pages)
    slots, cols = np.nonzero(wp < num_pages)
    return slots, cols, wp[slots, cols], np.asarray(write_rows)[slots, cols]


def prefill_buckets(max_seq: int) -> Tuple[int, ...]:
    """Power-of-two chunk buckets 2, 4, ... capped at ``max_seq``
    (always included)."""
    out: List[int] = []
    b = 2
    while b < max_seq:
        out.append(b)
        b *= 2
    out.append(int(max_seq))
    return tuple(out)


class GraphDecoder:
    """Prefill-chunk and decode functions for one (model, slots, max_seq,
    page geometry).  Use :meth:`for_model`: engines of one geometry
    share an instance."""

    def __init__(self, model, slots: int, max_seq: int,
                 page_size: int = 0, num_pages: int = 0):
        if slots < 2:
            raise ValueError(
                f"slots must be >= 2, got {slots}: a 1-slot decode "
                f"batch lowers matrix-vector kernels whose bits differ "
                f"from the full forward (same floor as serve_buckets)")
        self.model = model
        self.device = model.device
        self.slots = int(slots)
        self.max_seq = int(max_seq)
        cfg = model.config
        self.page_size = int(page_size
                             or getattr(cfg, "serve_kv_page", 0)
                             or DEFAULT_PAGE_SIZE)
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, "
                             f"got {self.page_size}")
        self.pages_per_slot = pages_per_slot(self.max_seq, self.page_size)
        self.num_pages = int(num_pages
                             or getattr(cfg, "serve_kv_pages", 0)
                             or default_num_pages(self.slots, self.max_seq,
                                                  self.page_size))
        if self.num_pages < self.pages_per_slot:
            raise ValueError(
                f"num_pages {self.num_pages} cannot hold even one "
                f"max_seq={self.max_seq} stream "
                f"({self.pages_per_slot} pages of {self.page_size})")
        self._validate()
        self.buckets = prefill_buckets(self.max_seq)
        # one device: no mesh axis shards the pools
        self.layout = kv_cache_layout(model.layers, None, self.slots,
                                      self.max_seq,
                                      page_size=self.page_size,
                                      num_pages=self.num_pages)
        self.has_attention = any(isinstance(op, MultiHeadAttention)
                                 for op in model.layers)
        self.has_state = any(isinstance(op, LSTM) for op in model.layers)
        # an LSTM chunk at an offset would need the previous chunk's
        # carry: whole-prompt chunks and no prefix reuse for such graphs
        self.supports_chunking = not self.has_state

    # ---- validation ----------------------------------------------------
    def _validate(self) -> None:
        model = self.model
        if len(model.input_tensors) != 1:
            raise ValueError(
                f"generation needs exactly one token input, model has "
                f"{len(model.input_tensors)}")
        tin = model.input_tensors[0]
        if len(tin.shape) != 2 or not np.issubdtype(np.dtype(tin.dtype),
                                                    np.integer):
            raise ValueError(
                f"generation input must be (n, s) integer token ids, "
                f"got {tin.shape} {tin.dtype}")
        self._input_uid = tin.uid
        final = getattr(model, "_final_tensor", None) or \
            model.layers[-1].outputs[0]
        if len(final.shape) != 3:
            raise ValueError(
                f"generation needs per-token (n, s, vocab) outputs, "
                f"final tensor is {final.shape} — use an LM graph "
                f"(models.build_transformer_lm / build_lstm_lm), not a "
                f"classifier")
        self._final_uid = final.uid
        for op in model.layers:
            if isinstance(op, MultiHeadAttention):
                if not (op._self_attn and op.causal):
                    raise ValueError(
                        f"{op.name}: generation needs causal "
                        f"self-attention (cross-attention/bidirectional "
                        f"blocks cannot decode autoregressively)")
            elif isinstance(op, PositionEmbedding):
                if op.max_len < self.max_seq:
                    raise ValueError(
                        f"{op.name}: position table holds {op.max_len} "
                        f"positions < max_seq {self.max_seq}")
            elif isinstance(op, LSTM):
                if op._has_state:
                    raise ValueError(
                        f"{op.name}: LSTM with an external initial_state "
                        f"is not decodable (seed states are a prefill "
                        f"product, not a graph input)")
            elif isinstance(op, Embedding):
                if op.aggr != "none":
                    raise ValueError(
                        f"{op.name}: only sequence-mode (aggr='none') "
                        f"embeddings decode; bag aggregation collapses "
                        f"the sequence dim")
            elif op.op_type not in _POINTWISE_TYPES:
                raise ValueError(
                    f"{op.name} ({op.op_type.value}) has no "
                    f"single-position decode path; generation supports "
                    f"causal attention, LSTM, embeddings and "
                    f"position-wise ops")

    # ---- shared pieces -------------------------------------------------
    def _ctx(self) -> OpContext:
        cfg = self.model.config
        return OpContext(device=self.device, training=False,
                         compute_dtype=cfg.compute_dtype,
                         conv_layout=self.model.resolved_conv_layout,
                         flash_attention=cfg.flash_attention)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """A host array on the model's device.  To a card it goes from
        pinned memory without waiting: a plain copy from pageable memory
        would wait for the work queued before it."""
        t = torch.from_numpy(a)
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    def _upload(self, *arrays) -> List[torch.Tensor]:
        """Host integer arrays as int64 tensors on the model's device,
        in one copy."""
        flat = [np.asarray(a, np.int64) for a in arrays]
        buf = self._to_device(np.concatenate([a.reshape(-1)
                                              for a in flat]))
        out, off = [], 0
        for a in flat:
            out.append(buf[off:off + a.size].view(a.shape))
            off += a.size
        return out

    def _upload_floats(self, temp, top_p) -> torch.Tensor:
        """The sampled steps' float strategy arrays as one (2, slots)
        float32 tensor on the device: temperatures, then top-p."""
        return self._to_device(np.stack([np.asarray(temp, np.float32),
                                         np.asarray(top_p, np.float32)]))

    def _walk(self, params, tokens, ctx: OpContext, run_op
              ) -> torch.Tensor:
        """The layer list on ``tokens``, each op in its resolved compute
        dtype; ``run_op(op, ins, ctx)`` returns the op's outputs.  Returns
        the final tensor."""
        base = ctx.compute_dtype
        values: Dict[int, torch.Tensor] = {self._input_uid: tokens}
        for op in self.model.layers:
            ctx.compute_dtype = resolve_op_dtype(op, base)
            outs = run_op(op, [values[t.uid] for t in op.inputs], ctx)
            for t, val in zip(op.outputs, outs):
                values[t.uid] = val
        ctx.compute_dtype = base
        return values[self._final_uid]

    # ---- cache ---------------------------------------------------------
    def init_cache(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The zeroed page pools and LSTM state, through
        ``pages.alloc_pool_arrays``."""
        return alloc_pool_arrays(self.layout, self.device,
                                 self.model.config.compute_dtype)

    # ---- prefill -------------------------------------------------------
    def prefill_bucket(self, chunk_len: int) -> int:
        """Smallest chunk bucket covering ``chunk_len``."""
        for b in self.buckets:
            if b >= chunk_len:
                return b
        raise ValueError(f"prefill chunk of {chunk_len} tokens exceeds "
                         f"max_seq {self.max_seq}")

    def _walk_prefill(self, params, caches, tokens, table_row, slot: int,
                      start: int, length: int) -> torch.Tensor:
        """The chunk's forward (see the module docstring); writes the
        chunk's K/V (or the LSTM carry at ``length - 1``) into the caches
        and returns the logits (V,) at the last real position."""

        def run_op(op, ins, ctx):
            if isinstance(op, MultiHeadAttention):
                c = caches[op.name]
                return op.forward_paged(params, ins[0], c["k"], c["v"],
                                        table_row, start, length, ctx)[0]
            if isinstance(op, LSTM):
                # whole-prompt chunks only: start is 0, so the zero-state
                # forward is the prefill
                outs, hs, cs = op.forward_states(params, ins, ctx)
                caches[op.name]["h"][slot] = hs[0, length - 1]
                caches[op.name]["c"][slot] = cs[length - 1][0]
                return outs
            if isinstance(op, PositionEmbedding):
                return op.forward_at(params, ins[0], start, ctx)
            return op.forward(params, ins, ctx)

        return self._walk(params, tokens, self._ctx(), run_op)[0, length - 1]

    def prefill_fn(self, bucket: int):
        """The prefill-chunk function of one bucket: ``fn(params, caches,
        tokens (1, bucket), table_row (pages_per_slot,), slot, start,
        length) -> next_token`` (a 0-d device tensor: the argmax at the
        chunk's last real position, which for the final chunk is the
        stream's first generated token).  ``tokens`` and ``table_row``
        are host arrays; the caches are updated in place."""
        if bucket not in self.buckets:
            raise ValueError(f"unknown prefill bucket {bucket}")

        def prefill(params, caches, tokens, table_row, slot, start,
                    length):
            with torch.inference_mode():
                tok, row = self._upload(tokens, table_row)
                logits = self._walk_prefill(params, caches, tok, row,
                                            int(slot), int(start),
                                            int(length))
                return logits.argmax()

        return prefill

    # ---- decode --------------------------------------------------------
    def decode_inputs(self, tokens, pos, table, write_pages, write_rows,
                      *more) -> List[torch.Tensor]:
        """A decode step's host arrays on the device, in one copy:
        tokens, pos, table, then the kept writes (write slots, pages,
        rows; see :func:`kept_writes`), then ``more``."""
        return self._upload(tokens, pos, table,
                            *kept_writes(write_pages, write_rows,
                                         self.num_pages), *more)

    def _walk_decode(self, params, caches, tokens, pos, table,
                     write_slots, write_pages, write_rows) -> torch.Tensor:
        """The single-position layer walk: (slots,) device tokens at
        positions ``pos`` -> the (slots, V) logits, caches updated in
        place; the slots ``write_slots`` write their K/V."""

        def run_op(op, ins, ctx):
            if isinstance(op, MultiHeadAttention):
                c = caches[op.name]
                return op.decode_paged(params, ins[0], c["k"], c["v"],
                                       table, pos, write_slots,
                                       write_pages, write_rows, ctx)[0]
            if isinstance(op, LSTM):
                c = caches[op.name]
                outs, h2, c2 = op.decode(params, ins[0], c["h"], c["c"],
                                         ctx)
                c["h"].copy_(h2)
                c["c"].copy_(c2)
                return outs
            if isinstance(op, PositionEmbedding):
                return op.decode(params, ins[0], pos, ctx)
            return op.forward(params, ins, ctx)

        return self._walk(params, tokens[:, None], self._ctx(),
                          run_op)[:, 0]

    def decode_fn(self):
        """THE decode step: ``fn(params, caches, tokens (slots,), pos
        (slots,), table (slots, pages_per_slot), write_pages (slots,),
        write_rows (slots,)) -> next_tokens`` ((slots,) device tensor).
        Every slot advances one position a call; inactive and
        prefilling slots compute on dummy inputs with their write page
        at the sentinel (they write nothing).  Greedy argmax."""

        def decode(params, caches, tokens, pos, table, write_pages,
                   write_rows):
            with torch.inference_mode():
                dev = self.decode_inputs(tokens, pos, table, write_pages,
                                         write_rows)
                return self._walk_decode(params, caches, *dev).argmax(-1)

        return decode

    def decode_sampled_fn(self):
        """The sampled decode step: the same walk, then per-slot
        temperature/top-k/top-p (``sampling.filtered_probs``) and a draw
        keyed on (seed, position of the token drawn, ``STREAM_MAIN``).
        Slots at temperature 0 get their argmax.  ``fn(params, caches,
        tokens, pos, table, write_pages, write_rows, temp, top_k, top_p,
        seeds) -> next_tokens``."""

        def decode_s(params, caches, tokens, pos, table, write_pages,
                     write_rows, temp, top_k, top_p, seeds):
            with torch.inference_mode():
                tok, p, tab, ws, wp, wr, k, sd = self.decode_inputs(
                    tokens, pos, table, write_pages, write_rows, top_k,
                    seeds)
                fl = self._upload_floats(temp, top_p)
                logits = self._walk_decode(params, caches, tok, p, tab, ws,
                                           wp, wr)
                probs = sampling.filtered_probs(logits, fl[0], k, fl[1])
                return sampling.categorical(probs, sd, p + 1,
                                            sampling.STREAM_MAIN)

        return decode_s

    # ---- speculative decoding ------------------------------------------
    def _walk_window(self, params, caches, window, pos, table, write_slots,
                     write_cols, write_pages, write_rows) -> torch.Tensor:
        """The W-position verify walk: ``window`` (slots, W) device
        tokens at global positions ``pos[i] .. pos[i]+W-1`` through every
        op's window path (attention ``verify_paged``, the position table
        ``decode_window``, position-wise ops unchanged).  Returns the
        (slots, W, V) logits; the window entries listed write their
        K/V."""

        def run_op(op, ins, ctx):
            if isinstance(op, MultiHeadAttention):
                c = caches[op.name]
                return op.verify_paged(params, ins[0], c["k"], c["v"],
                                       table, pos, write_slots, write_cols,
                                       write_pages, write_rows, ctx)[0]
            if isinstance(op, PositionEmbedding):
                return op.decode_window(params, ins[0], pos, ctx)
            return op.forward(params, ins, ctx)

        return self._walk(params, window, self._ctx(), run_op)

    def _check_speculable(self, what: str) -> None:
        if not self.supports_chunking:
            raise ValueError(f"speculative {what} needs a chunkable "
                             f"graph (LSTM state cannot roll back)")

    def verify_fn(self, width: int, sampled: bool = False):
        """The speculative verify for windows of ``width`` W (the
        round's gamma): the target's walk over ``[first, d_1 ..
        d_{W-1}]`` at positions ``pos .. pos+W-1`` a slot; window row t's
        logits decide the token at ``pos+t+1``, judged against proposal
        ``d_{t+1}``.

        Greedy: ``fn(params, caches, first (slots,), d (slots, W), pos,
        table, wp (slots, W), wr (slots, W)) -> (n_accept (slots,), out
        (slots, W))``, ``out`` the target's argmax a row: rows below
        n_accept equal the accepted proposals and row n_accept (when
        < W) is the correction, so the host emits ``out[i, :min(n+1,
        W)]``.  Sampled adds ``q`` (slots, W, V), the draft's
        probabilities, after ``d`` and the strategy arrays ``temp,
        top_k, top_p, seeds`` at the end, and applies
        :func:`sampling.speculative_accept`.  ``first``, ``pos``,
        ``table`` and the write grids are host arrays (uploaded in one
        copy; the grids in the JAX form, the sentinel where nothing is
        written); ``d`` and ``q`` are the draft's device tensors.
        Nothing is fetched."""
        self._check_speculable("verify")
        w = int(width)

        def inputs(first, pos, table, wp, wr, *more):
            return self._upload(first, pos, table,
                                *kept_window_writes(wp, wr, self.num_pages),
                                *more)

        def walk(params, caches, tok, d, p, tab, ws, wc, wpg, wrw):
            window = torch.cat([tok[:, None], d[:, :w - 1]], dim=1)
            return self._walk_window(params, caches, window, p, tab, ws,
                                     wc, wpg, wrw)

        def verify(params, caches, first, d, pos, table, wp, wr):
            with torch.inference_mode():
                tok, p, tab, ws, wc, wpg, wrw = inputs(first, pos, table,
                                                       wp, wr)
                logits = walk(params, caches, tok, d, p, tab, ws, wc, wpg,
                              wrw)
                tgt = logits.argmax(-1)
                n_acc = torch.cumprod((d == tgt).to(torch.int64),
                                      dim=1).sum(dim=1)
                return n_acc, tgt

        def verify_s(params, caches, first, d, q, pos, table, wp, wr, temp,
                     top_k, top_p, seeds):
            with torch.inference_mode():
                tok, p, tab, ws, wc, wpg, wrw, k, sd = inputs(
                    first, pos, table, wp, wr, top_k, seeds)
                fl = self._upload_floats(temp, top_p)
                logits = walk(params, caches, tok, d, p, tab, ws, wc, wpg,
                              wrw)
                slots = logits.shape[0]
                probs = sampling.filtered_probs(
                    logits.reshape(slots * w, -1),
                    fl[0].repeat_interleave(w), k.repeat_interleave(w),
                    fl[1].repeat_interleave(w)).reshape(slots, w, -1)
                tpos = p[:, None] + 1 + torch.arange(w, device=p.device)
                return sampling.speculative_accept(d, probs, q, sd, tpos)

        return verify_s if sampled else verify

    def draft_fn(self, gamma: int, sampled: bool = False):
        """The speculative draft: ``gamma`` decode steps of this (draft)
        graph back to back.  Step t feeds the token at position
        ``pos+t`` (step 0 the stream's last token, later steps the
        previous proposal, which stays on the device), writes the
        draft's K/V there and proposes the token for ``pos+t+1``.  With
        the no-bonus verify window the draft cache covers exactly ``pos
        .. pos+gamma-1`` after every round, accepted or not.  The JAX
        package scans the steps in one program; here they are gamma
        eager walks after one upload, with no host sync between them.

        Greedy: ``fn(params, caches, first (slots,), pos, table, wp
        (gamma, slots), wr (gamma, slots)) -> d (slots, gamma)``.
        Sampled adds ``temp, top_k, top_p, seeds`` and returns ``(d, q)``
        with the steps' filtered draft probabilities ``q`` (slots,
        gamma, V), each draw keyed on ``STREAM_DRAFT``."""
        self._check_speculable("draft")
        g = int(gamma)

        def inputs(first, pos, table, wp, wr, *more):
            per_step = []
            for t in range(g):
                per_step += kept_writes(wp[t], wr[t], self.num_pages)
            dev = self._upload(first, pos, table, *per_step, *more)
            steps = [dev[3 + 3 * t:6 + 3 * t] for t in range(g)]
            return dev[:3], steps, dev[3 + 3 * g:]

        def draft(params, caches, first, pos, table, wp, wr):
            with torch.inference_mode():
                (tok, p, tab), steps, _ = inputs(first, pos, table, wp, wr)
                props = []
                for t, (ws, wpg, wrw) in enumerate(steps):
                    tok = self._walk_decode(params, caches, tok, p + t, tab,
                                            ws, wpg, wrw).argmax(-1)
                    props.append(tok)
                return torch.stack(props, dim=1)

        def draft_s(params, caches, first, pos, table, wp, wr, temp, top_k,
                    top_p, seeds):
            with torch.inference_mode():
                (tok, p, tab), steps, (k, sd) = inputs(
                    first, pos, table, wp, wr, top_k, seeds)
                fl = self._upload_floats(temp, top_p)
                props, qs = [], []
                for t, (ws, wpg, wrw) in enumerate(steps):
                    logits = self._walk_decode(params, caches, tok, p + t,
                                               tab, ws, wpg, wrw)
                    qt = sampling.filtered_probs(logits, fl[0], k, fl[1])
                    tok = sampling.categorical(qt, sd, p + t + 1,
                                               sampling.STREAM_DRAFT)
                    props.append(tok)
                    qs.append(qt)
                return torch.stack(props, dim=1), torch.stack(qs, dim=1)

        return draft_s if sampled else draft

    # ---- shared-instance registry --------------------------------------
    @classmethod
    def for_model(cls, model, slots: int, max_seq: int,
                  page_size: int = 0, num_pages: int = 0
                  ) -> "GraphDecoder":
        """One decoder per (model, slots, max_seq, page geometry), keyed
        on the resolved geometry (a later config change gets its own)."""
        cfg = model.config
        ps = int(page_size
                 or getattr(cfg, "serve_kv_page", 0)
                 or DEFAULT_PAGE_SIZE)
        pool = int(num_pages
                   or getattr(cfg, "serve_kv_pages", 0)
                   or (default_num_pages(slots, max_seq, ps)
                       if ps > 0 else 0))
        reg = model.__dict__.setdefault("_gen_decoders", {})
        key = (int(slots), int(max_seq), ps, pool)
        dec = reg.get(key)
        if dec is None:
            dec = cls(model, slots, max_seq, page_size=ps,
                      num_pages=pool)
            reg[key] = dec
        return dec


__all__ = ["GraphDecoder", "kept_writes", "kept_window_writes",
           "prefill_buckets"]
