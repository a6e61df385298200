"""GenerationEngine — iteration-level continuous batching over the paged
KV-cached decode path, the port of
``flexflow_tpu/serving/generation/engine.py``.

A request is a stream whose length is unknown up front (EOS may land
anywhere), so the engine schedules at step granularity: a fixed
``slots``-wide decode batch shares one KV page pool, a request joins a
free slot at any step boundary, every step runs ONE decode dispatch and
ONE token fetch (one ``.cpu()``) for the whole batch, and a finished or
cancelled stream frees its slot and its pages at once.

* **Paged KV** — a slot's state is a page table into fixed-size pool
  pages (``pages.KVPagePool``); ``analysis.kv_memory.kv_page_plan`` is
  the accounting of what ``pages.alloc_pool_arrays`` allocates.
* **Shared-prefix reuse** — a ref-counted trie over full pages of prompt
  ids (``pages.PrefixCache``): a prompt extending a cached prefix borrows
  its pages and prefills only the suffix.  ``serve_prefix_cache=off``
  turns it off.
* **Chunked prefill** — prompts prefill in ``serve_prefill_chunk``-token
  chunks, at most one chunk a step boundary, so a long join stalls the
  streams in flight by one bounded chunk (0 = whole-prompt chunks).

Admission is the dense engine's :class:`~..batcher.MicroBatcher` (one row
a request): the bounded queue with block/reject/shed_oldest, deadlines
(a prompt still queued at its deadline expires before any prefill) and
priority classes.

* **Speculative decoding** — with a ``draft_model`` (a smaller LM of
  the same vocabulary) a step boundary runs a round: the draft proposes
  gamma tokens a slot (gamma eager decode steps, proposals kept on the
  device), the target verifies the whole window in one walk, and one
  fetch brings back the accept counts and the tokens to emit.  The
  draft owns its own page pool, table and caches with the target's
  geometry.  The ``adaptive`` policy re-prices gamma from the accept
  rate and each gamma's round cost; a collapsing accept rate or a
  draft-side failure demotes the engine to plain decode, freeing the
  draft pool, and fails no stream.

Not ported yet, and refused where a caller asks for them: KV page
migration between engines (A.10b),
``from_strategy`` (more than one device, A.8), fleet-managed dispatch
(``begin_external_dispatch``, ``dispatch_pending``; with
``serving/fleet/``).  ``serve_quantize`` is refused for good with the
JAX engine's ValueError: weight quantization covers dense serving only.
Span tracing, the flight recorder, lock instrumentation and the
``FF_FAULT`` generation faults come with A.11.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np
import torch

from ...analysis.kv_memory import dtype_bytes, kv_page_plan
from ..batcher import MicroBatcher, Request
from ..errors import (GenerationCancelled, KVCacheExhausted, OverloadError,
                      SheddedError)
from ..events import event
from ..metrics import ServingMetrics, quantiles
from .decoder import GraphDecoder
from .pages import KVPagePool, PrefixCache
from .sampling import SamplingParams

_END = object()  # token-stream sentinel


def _not_ported(what: str, item: str):
    return NotImplementedError(
        f"{what} is not ported to flexflow_tpu_torch yet (ROADMAP {item})")


def _resolve(fut: Future, out) -> bool:
    """Complete a stream future with a result or exception whether it is
    pending (failures before the engine claimed it) or running (claimed
    at prefill).  A cancelled or finished future returns False."""
    try:
        if isinstance(out, BaseException):
            fut.set_exception(out)
        else:
            fut.set_result(out)
        return True
    except Exception:  # noqa: BLE001 — InvalidStateError and kin
        return False


class GenerationStream:
    """Client handle for one generation request: iterate it for tokens as
    decode steps retire them, or wait on :meth:`result` for the whole
    sequence.  ``cancel()`` is safe at any time: a queued request is
    dropped before any prefill; a prefilling or generating one frees its
    slot and pages at the next step boundary and fails only this stream
    with :class:`~..errors.GenerationCancelled`."""

    def __init__(self, prompt_len: int, max_new: int, t_submit: float,
                 deadlined: bool = False,
                 sampling: Optional[SamplingParams] = None):
        self.future: Future = Future()
        self.prompt_len = int(prompt_len)
        self.max_new = int(max_new)
        self.t_submit = t_submit
        self.deadlined = deadlined
        # None or greedy keeps the stream on the argmax decode
        self.sampling = sampling
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._tokens: List[int] = []  # engine-thread writes, then frozen
        self._cancelled = threading.Event()
        # submit -> first token, set at the final prefill chunk
        self.ttft: Optional[float] = None

    # ---- client side ---------------------------------------------------
    def cancel(self) -> None:
        """Request cancellation (see the class docstring)."""
        self._cancelled.set()
        # succeeds only while still queued: the engine claims the future
        # before prefill, and a claimed one fails at the next boundary
        if self.future.cancel():
            self._q.put(_END)

    @property
    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def tokens_so_far(self) -> List[int]:
        """Snapshot of the tokens retired so far."""
        return list(self._tokens)

    def __iter__(self):
        while True:
            item = self._q.get()
            if item is _END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """The generated tokens (np.int32, at most ``max_new``); blocks
        until EOS or the token budget, and raises the stream's
        failure."""
        return self.future.result(timeout)

    # ---- engine side ---------------------------------------------------
    def _emit(self, tok: int) -> None:
        self._tokens.append(tok)
        self._q.put(tok)

    def _finish(self) -> bool:
        done = _resolve(self.future, np.asarray(self._tokens, np.int32))
        self._q.put(_END)
        return done

    def _fail(self, exc: BaseException) -> bool:
        done = _resolve(self.future, exc)
        if done:
            self._q.put(exc)
        self._q.put(_END)
        return done


class _GenRequest(Request):
    """A queued prompt: a 1-row batcher Request carrying its stream (no
    ``stale`` predicate: a stream cancelled while queued is dropped when
    the engine fails to claim its future)."""

    __slots__ = ("stream",)

    def __init__(self, stream: GenerationStream, prompt: np.ndarray,
                 on_done, t_submit: float, deadline=None, priority=0):
        super().__init__((prompt,), 1, on_done, t_submit,
                         deadline=deadline, priority=priority)
        self.stream = stream


class _Slot:
    """Dispatcher-thread state of one decode slot: its stream, its pages
    (prefix-cache hits first, private pages after) and its prefill
    progress.  A prefilling slot owns pages but writes nothing in decode
    steps (its write page is the sentinel)."""

    __slots__ = ("stream", "prompt", "pages", "draft_pages", "hit_tokens",
                 "next_pos", "chunks", "last_token", "length", "generated",
                 "prefilling", "t_join")

    def __init__(self, stream: GenerationStream, prompt: np.ndarray,
                 hit_pages: List[int], page_size: int, t_join: float):
        self.stream = stream
        self.prompt = prompt
        self.pages: List[int] = list(hit_pages)
        # the slot's pages in the draft's pool under speculation (private:
        # draft rows are never shared through the prefix trie)
        self.draft_pages: List[int] = []
        self.hit_tokens = len(hit_pages) * int(page_size)
        self.next_pos = self.hit_tokens  # next prompt position to prefill
        self.chunks = 0
        self.last_token = 0
        self.length = 0     # positions materialised in the cache
        self.generated = 0
        self.prefilling = True
        self.t_join = t_join


class GenerationMetrics(ServingMetrics):
    """ServingMetrics plus the generation figures: windowed tokens/s,
    TTFT (submit to first token: queue wait and prefill) and TPOT (a
    decode step's wall time, which every active stream pays; under
    speculation a round's) percentiles, token and prefill totals, the
    speculation totals, and the engine's page-pool and speculation views
    through ``pool_stats_fn`` and ``spec_stats_fn``."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self._ttfts: deque = deque(maxlen=4096)  # guarded by self._lock
        self._steps: deque = deque()             # guarded by self._lock
        self._tokens = 0                         # guarded by self._lock
        self._prefills = 0                       # guarded by self._lock
        # speculation totals                      guarded by self._lock
        self._draft_dispatches = 0
        self._spec_proposed = 0
        self._spec_accepted = 0
        self._spec_fallbacks = 0
        self.pool_stats_fn = None
        self.spec_stats_fn = None

    def _trim_steps(self, now: float) -> None:
        horizon = now - self.window_s
        while self._steps and self._steps[0][0] < horizon:
            self._steps.popleft()

    def record_ttft(self, seconds: float) -> None:
        now = self.clock()
        with self._lock:
            self._prefills += 1
            self._ttfts.append((now, float(seconds)))

    def record_decode_step(self, ntokens: int, step_s: float) -> None:
        now = self.clock()
        with self._lock:
            self._tokens += int(ntokens)
            self._steps.append((now, int(ntokens), float(step_s)))
            self._trim_steps(now)

    def record_spec_round(self, proposed: int, accepted: int) -> None:
        """One speculative round: one draft dispatch, ``proposed`` draft
        tokens judged, ``accepted`` of them kept."""
        with self._lock:
            self._draft_dispatches += 1
            self._spec_proposed += int(proposed)
            self._spec_accepted += int(accepted)

    def record_spec_fallback(self) -> None:
        with self._lock:
            self._spec_fallbacks += 1

    def record_prefill_token(self) -> None:
        """The prefill's first token counts toward tokens/s too."""
        now = self.clock()
        with self._lock:
            self._tokens += 1
            self._steps.append((now, 1, 0.0))
            self._trim_steps(now)

    def snapshot(self) -> Dict:
        snap = super().snapshot()
        now = self.clock()
        with self._lock:
            steps = list(self._steps)
            ttfts = [v for _, v in self._ttfts]
            tokens, prefills = self._tokens, self._prefills
            proposed, accepted = self._spec_proposed, self._spec_accepted
            drafts, fallbacks = self._draft_dispatches, self._spec_fallbacks
        span = self.window_s
        if steps:
            span = min(self.window_s, max(1e-6, now - steps[0][0]))
        qt = quantiles(ttfts)
        qp = quantiles([s[2] for s in steps if s[2] > 0])

        def ms(v):
            return None if v != v else round(v * 1e3, 3)

        snap.update({
            "tokens_per_s": round(sum(s[1] for s in steps) / span, 3),
            "tokens": tokens, "prefills": prefills,
            "ttft_p50_ms": ms(qt[0.5]), "ttft_p95_ms": ms(qt[0.95]),
            "ttft_p99_ms": ms(qt[0.99]),
            "tpot_p50_ms": ms(qp[0.5]), "tpot_p95_ms": ms(qp[0.95]),
            "tpot_p99_ms": ms(qp[0.99]),
            # under speculation a "step" is a draft + verify round, so
            # the tpot_* percentiles are rounds; tokens_per_s compares
            "draft_dispatches": drafts,
            "spec_proposed_tokens": proposed,
            "spec_accepted_tokens": accepted,
            "accept_rate": (round(accepted / proposed, 4)
                            if proposed else 0.0),
            "spec_fallbacks": fallbacks,
        })
        for fn in (self.pool_stats_fn, self.spec_stats_fn):
            if fn is not None:
                snap.update(fn())
        return snap


class GenerationEngine:
    """Continuous-batching token generation over a compiled and
    initialised FFModel LM graph.

    ::

        engine = GenerationEngine(model, slots=8, eos_id=0)
        with engine:
            stream = engine.submit(prompt_ids, max_new_tokens=32)
            for tok in stream: ...
            out = stream.result()

    Knobs resolve from ``model.config`` (``serve_gen_slots``,
    ``serve_gen_max_seq``, ``serve_gen_max_new_tokens``,
    ``serve_kv_page``, ``serve_kv_pages``, ``serve_prefix_cache``,
    ``serve_prefill_chunk``, and ``serve_max_queue_rows`` /
    ``serve_admission`` / ``serve_starvation_ms`` for admission, the
    queue bound counting requests) unless given here.  The engine runs on
    ``model.device``; ``clock`` is injectable for tests.

    ``draft_model`` (compiled and initialised, on the target's device,
    with the target's vocabulary) turns on speculative decoding with
    ``spec_gamma`` (``serve_spec_gamma``: 0 off, else >= 2),
    ``spec_gamma_max`` and ``spec_policy`` (``fixed``, or ``adaptive``:
    gamma re-priced among 2, 4 and ``spec_gamma_max``).  Without a draft
    the engine serves plain decode whatever the gamma, as the JAX
    engine does; the policy is checked either way."""

    # speculation guardrails (class attributes, so tests can tighten
    # them): a draft whose accept-rate EWMA sits below
    # _SPEC_COLLAPSE_ACCEPT after _SPEC_COLLAPSE_MIN_PROPOSED proposals
    # costs more than it saves, and the engine demotes to plain decode
    _SPEC_COLLAPSE_MIN_PROPOSED = 64
    _SPEC_COLLAPSE_ACCEPT = 0.1
    _SPEC_EWMA_ALPHA = 0.2        # per-round accept and cost EWMA weight
    _SPEC_RETUNE_EVERY = 16       # adaptive gamma re-pricing cadence

    def __init__(self, model, slots: Optional[int] = None,
                 max_seq: Optional[int] = None,
                 max_new_tokens: Optional[int] = None,
                 eos_id: Optional[int] = None,
                 max_queue_requests: Optional[int] = None,
                 admission: Optional[str] = None,
                 starvation_ms: Optional[float] = None,
                 page_size: Optional[int] = None,
                 num_pages: Optional[int] = None,
                 prefill_chunk: Optional[int] = None,
                 prefix_cache: Optional[str] = None,
                 draft_model=None,
                 spec_gamma: Optional[int] = None,
                 spec_gamma_max: Optional[int] = None,
                 spec_policy: Optional[str] = None,
                 metrics_window_s: float = 30.0,
                 clock=time.monotonic, name: str = ""):
        if not model._compiled or not model._params:
            raise RuntimeError("compile() + init_layers() the model first")
        cfg = model.config
        if cfg.serve_quantize or getattr(model, "_quantized", ""):
            # weight quantization covers dense serving only, in the JAX
            # package too: the KV + weight plan assumes full weights
            raise ValueError(
                "serve_quantize is not supported by the generation "
                "engine (weight quantization covers dense serving "
                "only); unset FFConfig.serve_quantize for this model")
        # as the JAX engine: without a draft, gamma is 0 whatever
        # spec_gamma says and the engine serves plain decode; the policy
        # is checked either way
        policy = str(cfg.serve_spec_policy if spec_policy is None
                     else spec_policy)
        if policy not in ("fixed", "adaptive"):
            raise ValueError(f"spec_policy must be 'fixed' or "
                             f"'adaptive', got {policy!r}")
        self.model = model
        self._params = model._params
        self.slots = int(slots or cfg.serve_gen_slots)
        seq_len = (model.input_tensors[0].shape[1]
                   if model.input_tensors else 0)
        self.max_seq = int(max_seq or cfg.serve_gen_max_seq or seq_len)
        self.max_new_tokens = int(max_new_tokens
                                  or cfg.serve_gen_max_new_tokens)
        self.eos_id = eos_id
        self.clock = clock
        self.admission = (cfg.serve_admission if admission is None
                          else admission)
        self.max_queue_requests = int(
            cfg.serve_max_queue_rows if max_queue_requests is None
            else max_queue_requests)
        self._batcher = MicroBatcher(
            1, 0.0, clock=clock, max_queue_rows=self.max_queue_requests,
            admission=self.admission,
            starvation_ms=float(cfg.serve_starvation_ms
                                if starvation_ms is None
                                else starvation_ms))
        self.name = str(name or cfg.serve_model_name)
        self.metrics = GenerationMetrics(
            window_s=metrics_window_s, clock=clock,
            queue_depth_fn=lambda: self._batcher.queue_depth,
            model=self.name)
        self._decoder = GraphDecoder.for_model(
            model, self.slots, self.max_seq,
            page_size=int(page_size or 0), num_pages=int(num_pages or 0))
        self.page_size = self._decoder.page_size
        self.num_pages = self._decoder.num_pages
        # what the memory gate charges is what the pool allocates
        self.kv_plan = kv_page_plan(
            model.layers, None, self.slots, self.max_seq,
            kv_dtype_bytes=dtype_bytes(cfg.compute_dtype),
            page_size=self.page_size, num_pages=self.num_pages)
        self.kv_cache_bytes = self.kv_plan["total_bytes"]
        chunk = int(cfg.serve_prefill_chunk if prefill_chunk is None
                    else prefill_chunk)
        if chunk < 0:
            raise ValueError(f"serve_prefill_chunk must be >= 0, "
                             f"got {chunk}")
        self.prefill_chunk = (chunk if self._decoder.supports_chunking
                              else 0)
        pc = (cfg.serve_prefix_cache if prefix_cache is None
              else prefix_cache)
        self.prefix_cache_enabled = (
            str(pc).lower() not in ("off", "0", "false", "no")
            and self._decoder.has_attention
            and self._decoder.supports_chunking)
        # dispatcher-thread-only state (single writer, no lock)
        self._slots_state: List[Optional[_Slot]] = [None] * self.slots
        self._pool = KVPagePool(self.num_pages, self.page_size)
        self._prefix: Optional[PrefixCache] = (
            PrefixCache(self._pool) if self.prefix_cache_enabled
            else None)
        self._table = np.full((self.slots, self._decoder.pages_per_slot),
                              self._pool.no_page, np.int32)
        self._prefill_q: deque = deque()  # (slot, _Slot) FIFO
        self._caches = None
        self._n_steps = 0
        self._chunks_total = 0
        self._hit_tokens = 0
        self._prompt_tokens = 0
        # lifetime counters kept across the pool rebuild a failed
        # dispatch forces
        self._evictions_base = 0
        self._pool_high_base = 0
        self.metrics.pool_stats_fn = self._pool_stats
        self._init_spec(draft_model, spec_gamma, spec_gamma_max, policy)
        # lifecycle (single use, as ServingEngine)
        self._lifecycle = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        self._draining = False
        self._closing = threading.Event()
        self._abort = threading.Event()
        self._shutdown_done = threading.Event()

    def _init_spec(self, draft_model, spec_gamma, spec_gamma_max,
                   policy: str) -> None:
        """Speculative decoding's state, with the JAX engine's checks and
        texts.  The draft gets its own decoder (the target's slots,
        max_seq, page size and page count), page pool, table and caches;
        ``draft_kv_cache_bytes`` is its pool's allocation."""
        cfg = self.model.config
        self.draft_model = draft_model
        self._draft_params = None
        self._draft_decoder: Optional[GraphDecoder] = None
        self._draft_pool: Optional[KVPagePool] = None
        self._draft_table = None
        self._draft_caches = None
        self.draft_kv_plan = None
        self.draft_kv_cache_bytes = 0
        g = (int(cfg.serve_spec_gamma if spec_gamma is None
                 else spec_gamma) if draft_model is not None else 0)
        gmax = int(cfg.serve_spec_gamma_max if spec_gamma_max is None
                   else spec_gamma_max)
        if draft_model is not None:
            if not (draft_model._compiled and draft_model._params):
                raise RuntimeError("compile() + init_layers() the draft "
                                   "model first")
            if policy == "fixed" and g == 0:
                raise ValueError(
                    "draft_model given but speculation is off "
                    "(serve_spec_gamma=0, policy 'fixed'): set "
                    "--serve-spec-gamma >= 2 or policy 'adaptive'")
            if g != 0 and g < 2:
                raise ValueError(
                    f"spec_gamma must be 0 (off) or >= 2, got {g}: a "
                    f"1-row verify window lowers matrix-vector kernels "
                    f"whose bits drift from the full forward (same "
                    f"floor as slots/serve_buckets)")
            if gmax < max(g, 2):
                raise ValueError(f"spec_gamma_max {gmax} < gamma "
                                 f"{max(g, 2)}")
            if not (self._decoder.has_attention
                    and self._decoder.supports_chunking):
                raise ValueError(
                    "speculative decoding needs a chunkable causal-"
                    "attention graph (LSTM state cannot roll back to "
                    "an accept point)")
            if draft_model.device != self.model.device:
                raise ValueError(
                    f"draft model is on {draft_model.device}, the target "
                    f"on {self.model.device}: both must share the device")
            self._draft_decoder = GraphDecoder.for_model(
                draft_model, self.slots, self.max_seq,
                page_size=self.page_size, num_pages=self.num_pages)
            if not self._draft_decoder.supports_chunking:
                raise ValueError("draft model must be a chunkable "
                                 "attention graph too")
            tv = self.model.layers[-1].outputs[0].shape[-1]
            dv = draft_model.layers[-1].outputs[0].shape[-1]
            if tv != dv:
                raise ValueError(f"draft vocab {dv} != target vocab "
                                 f"{tv}: the proposals would not be "
                                 f"token ids of the target")
            self.draft_kv_plan = kv_page_plan(
                draft_model.layers, None, self.slots, self.max_seq,
                kv_dtype_bytes=dtype_bytes(cfg.compute_dtype),
                page_size=self.page_size, num_pages=self.num_pages)
            self.draft_kv_cache_bytes = self.draft_kv_plan["total_bytes"]
            self._draft_params = draft_model._params
            self._draft_pool = KVPagePool(self.num_pages, self.page_size)
            self._draft_table = np.full(
                (self.slots, self._draft_decoder.pages_per_slot),
                self._draft_pool.no_page, np.int32)
        self.spec_policy = policy
        self.spec_gamma_max = gmax
        # the gammas the adaptive controller prices (fixed: just gamma)
        if draft_model is None:
            self._spec_candidates: List[int] = []
        elif policy == "fixed":
            self._spec_candidates = [g]
        else:
            self._spec_candidates = sorted(
                {c for c in (2, 4, gmax) if 2 <= c <= gmax})
        self._spec_gamma = (self._spec_candidates[0]
                            if self._spec_candidates else 0)
        if policy == "fixed" and g:
            self._spec_gamma = g
        self._spec_on = draft_model is not None
        self._spec_rounds = 0
        self._accept_ewma: Optional[float] = None
        self._spec_seen_proposed = 0
        self._spec_costs: Dict[int, float] = {}  # per-gamma round EWMA
        # the draft's dispatches: decode steps (gamma a round) and
        # prompt prefills, for launch accounting
        self._draft_steps = 0
        self._draft_prefills = 0
        self.metrics.spec_stats_fn = self._spec_stats

    # ---- not ported ----------------------------------------------------
    @classmethod
    def from_strategy(cls, model, strategy_file: str, mesh=None, **kw):
        raise _not_ported("GenerationEngine.from_strategy (a sharded "
                          "engine)", "A.8")

    def begin_external_dispatch(self, warmup: bool = True):
        raise _not_ported("fleet-managed dispatch", "with serving/fleet/")

    def dispatch_pending(self):
        raise _not_ported("fleet-managed dispatch", "with serving/fleet/")

    def adopt_migrated(self, payload: Dict) -> bool:
        raise _not_ported("KV page migration", "A.10b")

    # ---- lifecycle -----------------------------------------------------
    def _warmup(self) -> None:
        """One dispatch of the smallest prefill bucket and one decode
        step before serving, so the first request pays no kernel build,
        library load or cuBLAS set-up.  The chunk has no real position
        and every table and write page is the sentinel: nothing is
        written and the pools stay zero."""
        no_page = self._pool.no_page
        b = self._decoder.buckets[0]
        self._decoder.prefill_fn(b)(
            self._params, self._caches, np.zeros((1, b), np.int32),
            np.full((self._decoder.pages_per_slot,), no_page, np.int32),
            0, 0, 0)
        nxt = self._decoder.decode_fn()(
            self._params, self._caches, np.zeros((self.slots,), np.int32),
            np.zeros((self.slots,), np.int32),
            np.full((self.slots, self._decoder.pages_per_slot), no_page,
                    np.int32),
            np.full((self.slots,), no_page, np.int32),
            np.zeros((self.slots,), np.int32))
        nxt.cpu()
        if self._spec_on:
            self._warmup_spec()

    def _warmup_spec(self) -> None:
        """The draft's smallest prefill bucket, then for every candidate
        gamma two draft + verify rounds on sentinel tables (nothing is
        written), the second timed: the per-gamma round cost the
        adaptive controller starts from."""
        ddec = self._draft_decoder
        dno = self._draft_pool.no_page
        b = ddec.buckets[0]
        ddec.prefill_fn(b)(
            self._draft_params, self._draft_caches,
            np.zeros((1, b), np.int32),
            np.full((ddec.pages_per_slot,), dno, np.int32), 0, 0, 0)
        dtable = np.full((self.slots, ddec.pages_per_slot), dno, np.int32)
        vtable = np.full((self.slots, self._decoder.pages_per_slot),
                         self._pool.no_page, np.int32)
        tokens = np.zeros((self.slots,), np.int32)
        pos = np.zeros((self.slots,), np.int32)
        for g in self._spec_candidates:
            dwp = np.full((g, self.slots), dno, np.int32)
            dwr = np.zeros((g, self.slots), np.int32)
            vwp = np.full((self.slots, g), self._pool.no_page, np.int32)
            vwr = np.zeros((self.slots, g), np.int32)
            dfn = ddec.draft_fn(g)
            vfn = self._decoder.verify_fn(g)
            for probe in range(2):
                t0 = self.clock()
                d = dfn(self._draft_params, self._draft_caches, tokens, pos,
                        dtable, dwp, dwr)
                n_acc, out = vfn(self._params, self._caches, tokens, d,
                                 pos, vtable, vwp, vwr)
                torch.cat([n_acc[:, None], out], dim=1).cpu()
                if probe:
                    self._spec_costs[g] = max(1e-6, self.clock() - t0)

    def start(self, warmup: bool = True) -> "GenerationEngine":
        with self._lifecycle:
            if self._stopped:
                raise RuntimeError(
                    "engine was stopped; create a new GenerationEngine")
            if self._thread is None:
                self._caches = self._decoder.init_cache()
                if self._spec_on:
                    self._draft_caches = self._draft_decoder.init_cache()
                if warmup:
                    self._warmup()
                self._thread = threading.Thread(
                    target=self._decode_loop, name="ff-generate",
                    daemon=True)
                self._thread.start()
        return self

    def stop(self) -> None:
        """Close admissions, serve everything queued and in flight to
        completion, stop the dispatcher.  Idempotent; single use.  For a
        bounded shutdown see :meth:`drain`."""
        to_fail: List[Request] = []
        with self._lifecycle:
            self._closing.set()
            self._batcher.close()
            if self._thread is not None:
                # the dispatcher never takes _lifecycle: joining under it
                # cannot deadlock
                self._thread.join()
                self._thread = None
            else:
                to_fail = self._batcher.fail_pending()
            self._stopped = True
        now = self.clock()
        for r in to_fail:
            r.on_done(SheddedError("engine stopped before it was started"),
                      now)
        self._shutdown_done.set()

    def drain(self, timeout: Optional[float] = None) -> Dict:
        """Stop admitting, give work in flight ``timeout`` seconds, then
        shed the stragglers (queued prompts and active streams fail with
        SheddedError).  Returns the final stats; the engine is stopped
        afterwards."""
        with self._lifecycle:
            already = self._stopped or self._draining
            thread = self._thread
            if not already:
                self._draining = True
                self._closing.set()
                self._batcher.close()
        if already:
            self._shutdown_done.wait()
            return self.stats()
        if thread is not None:
            thread.join(timeout)
            if thread.is_alive():
                self._abort.set()
                now = self.clock()
                for r in self._batcher.fail_pending():
                    r.on_done(SheddedError(
                        f"engine drained with work still queued (drain "
                        f"timeout {timeout}s)"), now)
                thread.join(timeout)
        else:
            now = self.clock()
            for r in self._batcher.fail_pending():
                r.on_done(SheddedError(
                    "engine drained before it was started"), now)
        with self._lifecycle:
            self._stopped = True
            self._draining = False
            self._thread = None
        self._shutdown_done.set()
        return self.stats()

    def __enter__(self) -> "GenerationEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---- producer side -------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               deadline_ms: Optional[float] = None, priority: int = 0,
               sampling: Optional[SamplingParams] = None
               ) -> GenerationStream:
        """Queue one prompt (1-D int token ids) and return its
        :class:`GenerationStream`.  Thread-safe.  ``max_new_tokens`` caps
        the stream (default from config); generation also ends at
        ``eos_id``.  ``deadline_ms`` and ``priority`` behave as the dense
        engine's.  ``sampling`` selects temperature/top-k/top-p with a
        seed; None or temperature 0 is greedy argmax, and a step with no
        sampled stream runs the argmax decode."""
        arr = np.asarray(prompt, dtype=np.int32).reshape(-1)
        if arr.size < 1:
            raise ValueError("empty prompt")
        if sampling is not None and not isinstance(sampling,
                                                   SamplingParams):
            raise TypeError(f"sampling must be a SamplingParams, "
                            f"got {type(sampling).__name__}")
        # an explicit 0 must hit the guard, not fall back to the default
        max_new = (self.max_new_tokens if max_new_tokens is None
                   else int(max_new_tokens))
        if max_new < 1:
            raise ValueError(f"max_new_tokens must be >= 1, got {max_new}")
        if arr.size + max_new > self.max_seq:
            raise ValueError(
                f"prompt ({arr.size}) + max_new_tokens ({max_new}) "
                f"exceeds the KV cache length max_seq={self.max_seq}")
        t0 = self.clock()
        self.metrics.record_submitted()
        stream = GenerationStream(arr.size, max_new, t0,
                                  deadlined=deadline_ms is not None,
                                  sampling=sampling)
        deadline = None if deadline_ms is None else t0 + deadline_ms / 1e3
        metrics = self.metrics

        def on_done(out, now: float) -> bool:
            # the failure paths (expiry, shed, drain, stop); success is
            # the decode loop's _finish
            if isinstance(out, BaseException) and stream._fail(out):
                metrics.record_failure(out)
                return True
            return False

        req = _GenRequest(stream, arr.copy(), on_done, t0,
                          deadline=deadline, priority=priority)

        def count_cancel(f):
            # a cancel while queued resolves through no engine path:
            # count it here (a claimed future cannot be cancelled)
            if f.cancelled():
                metrics.record_cancelled()

        stream.future.add_done_callback(count_cancel)
        try:
            self._batcher.submit(req)
        except OverloadError:
            self.metrics.record_rejected()
            raise
        except RuntimeError as e:
            self.metrics.record_rejected()
            raise OverloadError(
                f"engine is not admitting new work ({e})") from e
        return stream

    def _pool_stats(self) -> Dict:
        """The page-pool and prefix-cache view merged into stats();
        lifetime counters stay monotonic across pool rebuilds."""
        pool = self._pool
        prefix = self._prefix
        hw = max(self._pool_high_base, pool.high_water)
        prompt_toks = self._prompt_tokens
        return {
            "kv_page_size": self.page_size,
            "kv_num_pages": self.num_pages,
            "kv_pages_in_use": pool.pages_in_use,
            "kv_pages_high_water": hw,
            "kv_high_water_bytes": (hw * self.kv_plan["page_bytes"]
                                    + self.kv_plan["state_bytes"]),
            "prefix_cache": "on" if prefix is not None else "off",
            "prefix_hit_tokens": self._hit_tokens,
            "prefix_hit_rate": (round(self._hit_tokens / prompt_toks, 4)
                                if prompt_toks else 0.0),
            "prefix_pages_cached": len(prefix) if prefix else 0,
            "evictions": (self._evictions_base
                          + (prefix.evictions if prefix else 0)),
            "prefill_chunks": self._chunks_total,
        }

    def _spec_stats(self) -> Dict:
        """The speculation view merged into stats(): ``spec`` is off (no
        draft), on, or fallback (demoted)."""
        state = ("off" if self.draft_model is None
                 else ("on" if self._spec_on else "fallback"))
        return {"spec": state, "spec_gamma": self._spec_gamma,
                "spec_policy": self.spec_policy,
                "draft_kv_cache_bytes": self.draft_kv_cache_bytes}

    def stats(self) -> Dict:
        active = sum(1 for s in self._slots_state if s is not None)
        return {**self.metrics.snapshot(), "slots": self.slots,
                "active_slots": active, "max_seq": self.max_seq,
                "kv_cache_bytes": self.kv_cache_bytes,
                "prefill_chunk": self.prefill_chunk,
                "admission": self.admission,
                "max_queue_requests": self.max_queue_requests,
                "peak_queue_requests": self._batcher.peak_rows}

    # ---- dispatcher thread ---------------------------------------------
    def _decode_loop(self) -> None:
        """One iteration a step: expire queued deadlines, admit queued
        prompts into free slots, advance prefill by at most one chunk,
        then advance every active stream one token with one dispatch
        and one fetch."""
        device = self.model.device
        if device.type == "cuda" and device.index is not None:
            torch.cuda.set_device(device)
        while True:
            if self._abort.is_set():
                self._abort_active()
                return
            # expiry at every boundary: with every slot busy _admit never
            # polls, and a deadline must fail at the deadline
            self._batcher.reap_expired()
            self._admit()
            progressed = self._prefill_step()
            self._grow_active_pages()
            if any(s is not None and not s.prefilling
                   for s in self._slots_state):
                try:
                    self._step_active()
                except Exception as e:  # noqa: BLE001 — a failed step
                    # fails the active streams, not the dispatcher
                    self._recover_from_dispatch_error(e)
                continue
            if progressed or any(s is not None
                                 for s in self._slots_state):
                continue  # prefill still in flight: keep chunking
            reqs = self._batcher.next_batch(timeout=0.05)
            if reqs:
                for r in reqs:
                    self._assign(r)
                continue
            if (self._closing.is_set()
                    and self._batcher.queue_depth == 0):
                return

    def _admit(self) -> None:
        """Join queued prompts into free slots (the continuous-batching
        join point); the prefill runs chunk by chunk at later
        boundaries."""
        for slot in range(self.slots):
            if self._slots_state[slot] is not None:
                continue
            batch = self._batcher.poll()
            if not batch:
                return
            for r in batch:
                self._assign(r, slot)

    def _assign(self, req: _GenRequest,
                slot: Optional[int] = None) -> None:
        if slot is None or self._slots_state[slot] is not None:
            slot = next((i for i, s in enumerate(self._slots_state)
                         if s is None), None)
            if slot is None:
                req.stream._fail(SheddedError(
                    "internal: no free decode slot at join"))
                return
        stream = req.stream
        try:
            claimed = stream.future.set_running_or_notify_cancel()
        except RuntimeError:
            claimed = False
        if not claimed:
            return  # cancelled while queued (counted at cancel time)
        prompt = req.xs[0]
        hits: List[int] = []
        if self._prefix is not None:
            hits = self._prefix.lookup(prompt)
        st = _Slot(stream, prompt, hits, self.page_size, self.clock())
        for i, pg in enumerate(hits):
            self._table[slot, i] = pg
        self._slots_state[slot] = st
        self._prefill_q.append((slot, st))
        self._prompt_tokens += int(prompt.size)
        self._hit_tokens += st.hit_tokens

    # ---- paged prefill (chunked) ---------------------------------------
    def _prefill_step(self) -> bool:
        """Advance prefill by at most one chunk dispatch.  True when a
        chunk ran or a prefilling slot retired."""
        while self._prefill_q:
            slot, st = self._prefill_q[0]
            if self._slots_state[slot] is not st or not st.prefilling:
                self._prefill_q.popleft()  # slot retired or reassigned
                continue
            if st.stream.cancelled:
                self._prefill_q.popleft()
                self._fail_slot(slot, st, GenerationCancelled(
                    f"stream cancelled during prefill after "
                    f"{st.chunks} chunk(s); KV slot {slot} and "
                    f"{len(st.pages)} page(s) freed"))
                return True
            return self._run_chunk(slot, st)
        return False

    def _run_chunk(self, slot: int, st: _Slot) -> bool:
        """Dispatch one prefill chunk for the queue-head slot; on the
        final chunk fetch the stream's first token (the one host sync of
        a join), activate the slot and promote its full prompt pages
        into the prefix cache."""
        prompt = st.prompt
        start = st.next_pos
        remaining = int(prompt.size) - start
        chunk = (remaining if self.prefill_chunk <= 0
                 else min(self.prefill_chunk, remaining))
        if not self._ensure_pages(slot, st, start + chunk):
            self._prefill_q.popleft()
            self._fail_slot(slot, st, KVCacheExhausted(
                f"no KV page free for prefill at position {start} "
                f"(pool {self.num_pages} pages, "
                f"{self._pool.pages_in_use} in use, prefix cache "
                f"fully referenced)"))
            return True
        bucket = self._decoder.prefill_bucket(chunk)
        tokens = np.zeros((1, bucket), np.int32)
        tokens[0, :chunk] = prompt[start:start + chunk]
        fn = self._decoder.prefill_fn(bucket)
        final = start + chunk >= int(prompt.size)
        tok = 0
        try:
            first = fn(self._params, self._caches, tokens,
                       self._table[slot].copy(), slot, start, chunk)
            if final:
                tok = int(first.cpu())
        except Exception as e:  # noqa: BLE001 — a failed chunk fails the
            # joining stream and (the pools may hold partial writes)
            # every stream in flight; the engine re-arms and serves on
            self._prefill_q.popleft()
            if st.stream._fail(e):
                self.metrics.record_failure(e)
            self._recover_from_dispatch_error(e)
            return True
        st.next_pos = start + chunk
        st.chunks += 1
        self._chunks_total += 1
        if not final:
            return True  # next chunk at a later step boundary
        self._prefill_q.popleft()
        now = self.clock()
        st.prefilling = False
        st.length = int(prompt.size)
        st.last_token = tok
        st.generated = 1
        stream = st.stream
        stream.ttft = now - stream.t_submit
        stream._emit(tok)
        self.metrics.record_ttft(stream.ttft)
        self.metrics.record_prefill_token()
        if self._prefix is not None:
            full = max(0, (int(prompt.size) - 1) // self.page_size)
            self._prefix.insert(prompt, st.pages[:full])
        if self._spec_active():
            self._draft_prefill(slot, st)
        self._retire(slot, st, now)
        return True

    # ---- page bookkeeping ----------------------------------------------
    def _alloc_page(self) -> Optional[int]:
        """One page, evicting unreferenced prefix pages (LRU) under
        pressure; None only when every page backs a live slot."""
        pg = self._pool.alloc()
        while pg is None and self._prefix is not None \
                and self._prefix.evict(1):
            pg = self._pool.alloc()
        return pg

    def _ensure_pages(self, slot: int, st: _Slot, upto_pos: int) -> bool:
        """Grow the slot's pages to cover positions ``[0, upto_pos)``,
        evicting the whole deficit in one trie walk up front."""
        need = (int(upto_pos) - 1) // self.page_size + 1
        deficit = need - len(st.pages) - self._pool.pages_free
        if deficit > 0 and self._prefix is not None:
            self._prefix.evict(deficit)
        while len(st.pages) < need:
            pg = self._alloc_page()
            if pg is None:
                return False
            self._table[slot, len(st.pages)] = pg
            st.pages.append(pg)
        return True

    def _grow_active_pages(self) -> None:
        """Before a decode dispatch every active slot needs a page for
        the position it writes; a slot the pool cannot serve is shed,
        and only that stream fails."""
        for i, s in enumerate(self._slots_state):
            if s is None or s.prefilling:
                continue
            if not self._ensure_pages(i, s, s.length + 1):
                self._fail_slot(i, s, KVCacheExhausted(
                    f"no KV page free for decode at position "
                    f"{s.length} (pool {self.num_pages} pages, "
                    f"{self._pool.pages_in_use} in use)"))

    def _release_slot(self, slot: int, st: _Slot) -> None:
        """Return the slot's pages (shared prefix pages drop one
        reference; the trie keeps them) and reset its table row to the
        sentinel."""
        for pg in st.pages:
            self._pool.release(pg)
        st.pages = []
        self._table[slot, :] = self._pool.no_page
        if self._draft_pool is not None:
            for pg in st.draft_pages:
                self._draft_pool.release(pg)
            self._draft_table[slot, :] = self._draft_pool.no_page
        st.draft_pages = []
        self._slots_state[slot] = None

    def _fail_slot(self, slot: int, st: _Slot,
                   exc: BaseException) -> None:
        if st.stream._fail(exc):
            self.metrics.record_failure(exc)
        self._release_slot(slot, st)

    # ---- decode --------------------------------------------------------
    def _step_active(self) -> None:
        """Advance every active stream one boundary: a speculative round
        while a live draft is attached, else one plain decode step."""
        if self._spec_active():
            self._spec_decode_once()
        else:
            self._decode_once()

    def _spec_active(self) -> bool:
        return self._spec_on and self._spec_gamma >= 2

    def _batch_sampling(self) -> bool:
        """Whether any active slot samples: an all-greedy step runs the
        argmax decode."""
        for s in self._slots_state:
            if s is None or s.prefilling or s.stream.sampling is None:
                continue
            if not s.stream.sampling.is_greedy:
                return True
        return False

    def _sampling_arrays(self):
        """Per-slot strategy arrays; inactive and greedy slots ride the
        defaults (temperature 0: the exact one-hot argmax)."""
        temp = np.zeros((self.slots,), np.float32)
        top_k = np.zeros((self.slots,), np.int32)
        top_p = np.ones((self.slots,), np.float32)
        seeds = np.zeros((self.slots,), np.int64)
        for i, s in enumerate(self._slots_state):
            if s is None or s.prefilling or s.stream.sampling is None:
                continue
            sp = s.stream.sampling
            temp[i] = sp.temperature
            top_k[i] = sp.top_k
            top_p[i] = sp.top_p
            seeds[i] = sp.seed
        return temp, top_k, top_p, seeds

    def _decode_once(self) -> None:
        """Advance the whole batch one position: one dispatch, one token
        fetch, tokens scattered to the streams.  Inactive and
        prefilling slots write through the sentinel (dropped)."""
        tokens = np.zeros((self.slots,), np.int32)
        pos = np.zeros((self.slots,), np.int32)
        wp = np.full((self.slots,), self._pool.no_page, np.int32)
        wr = np.zeros((self.slots,), np.int32)
        nactive = 0
        for i, s in enumerate(self._slots_state):
            if s is not None and not s.prefilling:
                tokens[i] = s.last_token
                pos[i] = s.length
                wp[i] = self._table[i, s.length // self.page_size]
                wr[i] = s.length % self.page_size
                nactive += 1
        t0 = self.clock()
        if self._batch_sampling():
            nxt = self._decoder.decode_sampled_fn()(
                self._params, self._caches, tokens, pos, self._table, wp,
                wr, *self._sampling_arrays())
        else:
            nxt = self._decoder.decode_fn()(
                self._params, self._caches, tokens, pos, self._table, wp,
                wr)
        # THE host sync of the step, for the whole batch
        host = nxt.cpu().numpy()
        now = self.clock()
        self._n_steps += 1
        for i, s in enumerate(self._slots_state):
            if s is None or s.prefilling:
                continue
            tok = int(host[i])
            s.length += 1
            s.generated += 1
            s.last_token = tok
            s.stream._emit(tok)
            self._retire(i, s, now)
        self.metrics.record_decode_step(nactive, now - t0)

    # ---- speculative round ---------------------------------------------
    def _spec_decode_once(self) -> None:
        """One speculative round for the whole batch: the draft's gamma
        steps, one verify walk of the target, and one fetch of the accept
        counts with the rows to emit.  ``out[i, :min(n+1, gamma)]`` is
        emitted as it stands (the accepted proposals, then the
        correction), stopping where the plain engine stops (EOS or
        ``max_new_tokens`` may land inside the window).  The draft cache
        is caught up after every round by construction (no bonus token),
        rows written past the accept point stay masked until they are
        overwritten, and pages past the accepted length go back to both
        pools at once."""
        g = self._spec_gamma
        # both pools cover the whole window up front; positions past
        # max_seq keep the sentinel (their writes drop, and the stream
        # retires before such a row could be emitted)
        for i, s in enumerate(self._slots_state):
            if s is None or s.prefilling:
                continue
            upto = min(s.length + g, self.max_seq)
            if not self._ensure_pages(i, s, upto):
                self._fail_slot(i, s, KVCacheExhausted(
                    f"no KV page free for a gamma={g} verify window at "
                    f"position {s.length} (pool {self.num_pages} pages, "
                    f"{self._pool.pages_in_use} in use)"))
                continue
            if not self._ensure_draft_pages(i, s, upto):
                self._fail_slot(i, s, KVCacheExhausted(
                    f"no draft KV page free at position {s.length} "
                    f"(draft pool {self.num_pages} pages, "
                    f"{self._draft_pool.pages_in_use} in use)"))
        active = [(i, s) for i, s in enumerate(self._slots_state)
                  if s is not None and not s.prefilling]
        if not active:
            return
        nactive = len(active)
        tokens = np.zeros((self.slots,), np.int32)
        pos = np.zeros((self.slots,), np.int32)
        vwp = np.full((self.slots, g), self._pool.no_page, np.int32)
        vwr = np.zeros((self.slots, g), np.int32)
        dwp = np.full((g, self.slots), self._draft_pool.no_page, np.int32)
        dwr = np.zeros((g, self.slots), np.int32)
        for i, s in active:
            tokens[i] = s.last_token
            pos[i] = s.length
            for t in range(g):
                p = s.length + t
                if p >= self.max_seq:
                    break  # the sentinel stays: the write drops
                vwp[i, t] = self._table[i, p // self.page_size]
                vwr[i, t] = p % self.page_size
                dwp[t, i] = self._draft_table[i, p // self.page_size]
                dwr[t, i] = p % self.page_size
        sampled = self._batch_sampling()
        arrays = self._sampling_arrays() if sampled else ()
        t0 = self.clock()
        try:
            dfn = self._draft_decoder.draft_fn(g, sampled=sampled)
            drafted = dfn(self._draft_params, self._draft_caches, tokens,
                          pos, self._draft_table, dwp, dwr, *arrays)
        except Exception as e:  # noqa: BLE001 — draft side only: the
            # target's caches are untouched, so no stream fails; demote
            # and decode this boundary plain
            self._spec_demote("draft_error", e)
            self._decode_once()
            return
        self._draft_steps += g
        # a failed verify reaches the caller's containment: the target's
        # pools may hold a partial window, so its streams must fail
        vfn = self._decoder.verify_fn(g, sampled=sampled)
        if sampled:
            d, q = drafted
            n_acc, out = vfn(self._params, self._caches, tokens, d, q, pos,
                             self._table, vwp, vwr, *arrays)
        else:
            n_acc, out = vfn(self._params, self._caches, tokens, drafted,
                             pos, self._table, vwp, vwr)
        # THE host sync of the round, for the whole batch: the accept
        # counts and the rows to emit in one fetch
        host = torch.cat([n_acc[:, None], out], dim=1).cpu().numpy()
        now = self.clock()
        self._n_steps += 1
        emitted = proposed = accepted = 0
        for i, s in active:
            n = int(host[i, 0])
            proposed += g
            accepted += n
            for t in range(min(n + 1, g)):
                tok = int(host[i, 1 + t])
                s.length += 1
                s.generated += 1
                s.last_token = tok
                s.stream._emit(tok)
                emitted += 1
                if s.generated >= s.stream.max_new or (
                        self.eos_id is not None and tok == self.eos_id):
                    break
            self._trim_slot_pages(i, s)
            self._retire(i, s, now)
        self.metrics.record_spec_round(proposed, accepted)
        self.metrics.record_decode_step(emitted, now - t0)
        self._spec_account(g, proposed, accepted, now - t0)

    def _ensure_draft_pages(self, slot: int, st: _Slot,
                            upto_pos: int) -> bool:
        """Grow the slot's draft pages to cover positions ``[0,
        upto_pos)``: the target's geometry, but no prefix sharing and so
        no eviction to fall back on."""
        need = (int(upto_pos) - 1) // self.page_size + 1
        while len(st.draft_pages) < need:
            pg = self._draft_pool.alloc()
            if pg is None:
                return False
            self._draft_table[slot, len(st.draft_pages)] = pg
            st.draft_pages.append(pg)
        return True

    def _trim_slot_pages(self, slot: int, st: _Slot) -> None:
        """Return the trailing pages a partly accepted window provisioned
        past the accept point, in both pools (rejected rows inside kept
        pages need no rollback: the mask hides them).  Trimmed target
        pages lie past the prompt's shared prefix, so each has one
        reference and goes back to the pool."""
        keep = st.length // self.page_size + 1
        while len(st.pages) > keep:
            pg = st.pages.pop()
            self._table[slot, len(st.pages)] = self._pool.no_page
            self._pool.release(pg)
        while len(st.draft_pages) > keep:
            pg = st.draft_pages.pop()
            self._draft_table[slot, len(st.draft_pages)] = \
                self._draft_pool.no_page
            self._draft_pool.release(pg)

    def _draft_prefill(self, slot: int, st: _Slot) -> None:
        """Mirror a joined stream's prompt into the draft's cache with one
        prefill of the whole prompt (no chunking, no prefix sharing).  No
        host sync: the draft's own next token is unused (round 0 starts
        from the target's first token).  A draft-side failure demotes
        speculation; the stream is untouched."""
        prompt = st.prompt
        size = int(prompt.size)
        if st.generated >= st.stream.max_new or (
                self.eos_id is not None and st.last_token == self.eos_id):
            return  # retiring at this boundary: no draft rows needed
        try:
            if not self._ensure_draft_pages(slot, st, size):
                raise KVCacheExhausted(
                    f"no draft KV page free for a {size}-token prompt "
                    f"({self._draft_pool.pages_in_use} of "
                    f"{self.num_pages} in use)")
            bucket = self._draft_decoder.prefill_bucket(size)
            tokens = np.zeros((1, bucket), np.int32)
            tokens[0, :size] = prompt
            self._draft_decoder.prefill_fn(bucket)(
                self._draft_params, self._draft_caches, tokens,
                self._draft_table[slot].copy(), slot, 0, size)
            self._draft_prefills += 1
        except Exception as e:  # noqa: BLE001 — draft side only
            self._spec_demote("draft_prefill_error", e)

    def _spec_account(self, g: int, proposed: int, accepted: int,
                      wall: float) -> None:
        """After a round: the accept-rate EWMA, the gamma's round-cost
        EWMA, the collapse guard, and under ``adaptive`` the periodic
        re-pricing of gamma."""
        self._spec_rounds += 1
        self._spec_seen_proposed += proposed
        a = self._SPEC_EWMA_ALPHA
        if proposed:
            rate = accepted / proposed
            self._accept_ewma = (
                rate if self._accept_ewma is None
                else (1 - a) * self._accept_ewma + a * rate)
        prev = self._spec_costs.get(g)
        self._spec_costs[g] = (wall if prev is None
                               else (1 - a) * prev + a * wall)
        if (self._spec_seen_proposed >= self._SPEC_COLLAPSE_MIN_PROPOSED
                and self._accept_ewma is not None
                and self._accept_ewma < self._SPEC_COLLAPSE_ACCEPT):
            # a useless draft costs a dispatch a round for nothing
            self._spec_demote("accept_collapse", None)
            return
        if (self.spec_policy == "adaptive"
                and len(self._spec_candidates) > 1
                and self._spec_rounds % self._SPEC_RETUNE_EVERY == 0):
            self._spec_gamma = self._spec_retune()

    def _spec_retune(self) -> int:
        """Price each candidate gamma with the accept EWMA alpha and its
        round-cost EWMA: a round emits ``(1 - alpha^gamma) / (1 -
        alpha)`` tokens on average (the accepted prefix and the
        correction, no bonus token), so the winner has the most tokens
        over cost."""
        alpha = (self._accept_ewma if self._accept_ewma is not None
                 else 0.5)
        alpha = min(0.999, max(0.001, alpha))
        best, best_rate = self._spec_gamma, -1.0
        for g in self._spec_candidates:
            cost = self._spec_costs.get(g)
            if not cost or cost <= 0:
                continue
            rate = (1.0 - alpha ** g) / (1.0 - alpha) / cost
            if rate > best_rate:
                best, best_rate = g, rate
        return best

    def _spec_demote(self, reason: str, exc) -> None:
        """Plain decode for the rest of the engine's life: drop the draft
        pool, table and caches (their device memory is freed), count the
        fallback and emit one ``serve_health`` event.  No stream fails:
        the target's state is untouched, and every active stream goes on
        from where it is."""
        if not self._spec_on:
            return
        self._spec_on = False
        self._spec_gamma = 0
        self._draft_caches = None
        self._draft_pool = None
        self._draft_table = None
        self.draft_kv_cache_bytes = 0
        for s in self._slots_state:
            if s is not None:
                s.draft_pages = []
        self.metrics.record_spec_fallback()
        event("serve_health", level=logging.WARNING, model=self.name,
              component="speculation", status="fallback", reason=reason,
              error=("" if exc is None
                     else f"{type(exc).__name__}: {exc}"[:300]),
              step=self._n_steps,
              accept_ewma=(round(self._accept_ewma, 4)
                           if self._accept_ewma is not None else None))

    def _recover_from_dispatch_error(self, e: BaseException) -> None:
        """A prefill or decode dispatch raised part way: the pools may
        hold a partial step, so every stream in flight and every cached
        prefix page is lost.  Fail them all, rebuild the pool, trie and
        zeroed pools (lifetime counters carry over) and keep serving the
        queue."""
        for i, s in enumerate(self._slots_state):
            if s is None:
                continue
            if s.stream._fail(e):
                self.metrics.record_failure(e)
            self._slots_state[i] = None
        self._prefill_q.clear()
        if self._prefix is not None:
            self._evictions_base += self._prefix.evictions
        self._pool_high_base = max(self._pool_high_base,
                                   self._pool.high_water)
        self._pool = KVPagePool(self.num_pages, self.page_size)
        self._prefix = (PrefixCache(self._pool)
                        if self.prefix_cache_enabled else None)
        self._table = np.full((self.slots, self._decoder.pages_per_slot),
                              self._pool.no_page, np.int32)
        self._caches = self._decoder.init_cache()
        if self._spec_on:
            # a failed round may have written either side, and the slots
            # the draft state described are gone: re-arm it too
            self._draft_pool = KVPagePool(self.num_pages, self.page_size)
            self._draft_table = np.full(
                (self.slots, self._draft_decoder.pages_per_slot),
                self._draft_pool.no_page, np.int32)
            self._draft_caches = self._draft_decoder.init_cache()

    def _retire(self, slot: int, s: _Slot, now: float) -> None:
        """Free the slot and its pages if its stream finished or was
        cancelled (at every step boundary, so a cancel frees capacity
        for the next queued prompt at once)."""
        if s.stream.cancelled:
            self._fail_slot(slot, s, GenerationCancelled(
                f"stream cancelled after {s.generated} token(s); "
                f"KV slot {slot} and {len(s.pages)} page(s) freed"))
            return
        done = s.generated >= s.stream.max_new or (
            self.eos_id is not None and s.last_token == self.eos_id)
        if done:
            if s.stream._finish():
                self.metrics.record_request(now - s.stream.t_submit,
                                            deadlined=s.stream.deadlined)
            self._release_slot(slot, s)

    def _abort_active(self) -> None:
        """drain(timeout) expired: shed whatever is still decoding or
        prefilling (pages go back with the slots)."""
        for i, s in enumerate(self._slots_state):
            if s is not None:
                self._fail_slot(i, s, SheddedError(
                    "engine drained mid-generation (drain timeout)"))
        self._prefill_q.clear()


__all__ = ["GenerationEngine", "GenerationStream", "GenerationMetrics"]
