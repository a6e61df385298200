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

Not ported yet, and refused where a caller asks for them: speculative
decoding with a ``draft_model`` (ROADMAP A.10b; without a draft,
``serve_spec_gamma`` is 0 and the engine serves plain decode, as the JAX
engine does), KV page migration between engines (A.10b),
``from_strategy`` (more than one device, A.8), fleet-managed dispatch
(``begin_external_dispatch``, ``dispatch_pending``; with
``serving/fleet/``).  ``serve_quantize`` is refused for good with the
JAX engine's ValueError: weight quantization covers dense serving only.
Span tracing, the flight recorder, lock instrumentation and the
``FF_FAULT`` generation faults come with A.11.
"""

from __future__ import annotations

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

    __slots__ = ("stream", "prompt", "pages", "hit_tokens", "next_pos",
                 "chunks", "last_token", "length", "generated",
                 "prefilling", "t_join")

    def __init__(self, stream: GenerationStream, prompt: np.ndarray,
                 hit_pages: List[int], page_size: int, t_join: float):
        self.stream = stream
        self.prompt = prompt
        self.pages: List[int] = list(hit_pages)
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
    decode step's wall time, which every active stream pays)
    percentiles, token and prefill totals, and the engine's page-pool
    view through ``pool_stats_fn``."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self._ttfts: deque = deque(maxlen=4096)  # guarded by self._lock
        self._steps: deque = deque()             # guarded by self._lock
        self._tokens = 0                         # guarded by self._lock
        self._prefills = 0                       # guarded by self._lock
        self.pool_stats_fn = None

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
        })
        fn = self.pool_stats_fn
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

    ``draft_model``, ``spec_gamma``, ``spec_gamma_max`` and
    ``spec_policy`` are the JAX engine's speculative-decoding arguments,
    taken so that its callers run unchanged.  Without a draft the JAX
    engine serves plain decode whatever the gamma, and so does this one:
    the two gammas are ignored, and only ``spec_policy`` is checked
    (``fixed`` or ``adaptive``).  A draft model raises
    ``NotImplementedError`` until speculative decoding is ported."""

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
        if draft_model is not None:
            raise _not_ported("speculative decoding (draft_model)",
                              "A.10b")
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
        # lifecycle (single use, as ServingEngine)
        self._lifecycle = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        self._draining = False
        self._closing = threading.Event()
        self._abort = threading.Event()
        self._shutdown_done = threading.Event()

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

    def start(self, warmup: bool = True) -> "GenerationEngine":
        with self._lifecycle:
            if self._stopped:
                raise RuntimeError(
                    "engine was stopped; create a new GenerationEngine")
            if self._thread is None:
                self._caches = self._decoder.init_cache()
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
                    self._decode_once()
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
        self._slots_state[slot] = None

    def _fail_slot(self, slot: int, st: _Slot,
                   exc: BaseException) -> None:
        if st.stream._fail(exc):
            self.metrics.record_failure(exc)
        self._release_slot(slot, st)

    # ---- decode --------------------------------------------------------
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
