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

* **KV page migration** (disaggregated prefill/decode) — a stream
  submitted with a ``handoff`` exports its page chain at prefill
  completion (``pages.export_pages``: one device-to-host copy) and offers
  it to the handoff; a decode engine's :meth:`GenerationEngine.adopt_migrated`
  queues it, and that engine's own dispatch thread imports it
  (``pages.import_pages``) and decodes on from where the prefill left
  off.  A declined or failed handoff decodes co-located with one
  ``serve_health`` event and fails no stream.
* **Fleet mode** — :meth:`GenerationEngine.begin_external_dispatch` and
  :meth:`GenerationEngine.dispatch_pending` let a
  :class:`~..fleet.FleetEngine` drive the steps from its one dispatcher.

Events (``gen_engine_start``, ``gen_stats``, ``gen_drain``,
``serve_health``, ``gen_*_error``) go through
:mod:`~flexflow_tpu_torch.fflogger`; sampled streams record spans; the
``serve_slow_decode``, ``serve_cancel_at_token`` and ``spec_draft_fail``
``FF_FAULT`` kinds fire at step boundaries.

* **Sharded generation** — :meth:`GenerationEngine.from_strategy`
  compiles (or re-places) the model under a strategy file on a mesh of
  one process a device and shards the KV pools' heads over ``c``.  The
  JAX engine is one controller; here rank 0 owns every decision (it
  admits, assigns slots and pages, runs the prefix trie, samples and
  runs the speculation controller) and, before each dispatch, broadcasts
  one step plan (which function, and its host arguments: slots,
  positions, token ids, page-table rows, write pages and rows, sampling
  floats; a verify's draft proposals) over a gloo group of its own, so
  it works under NCCL too.  The other ranks' ``start()`` runs a follower
  loop that applies each plan to its own shard and decides nothing;
  their ``submit`` raises.  The tokens a step emits reach them inside
  the next plan, so no rank's rounding can fork a stream.  A dispatch
  error fails the group loudly (rank 0 fails every stream and aborts
  the followers; a follower whose own step fails exits its process);
  KV migration and fleet mode are not taken on a mesh.

``serve_quantize`` is refused for good with the JAX engine's ValueError:
weight quantization covers dense serving only.
"""

from __future__ import annotations

import os
import pickle
import queue
import sys
import threading
import time
import traceback
from collections import deque
from concurrent.futures import Future
from typing import Dict, List, Optional

import numpy as np
import torch

from ... import faults
from ...analysis.kv_memory import dtype_bytes, kv_page_plan
from ...fflogger import get_logger
from ...obs import lockwatch
from ...obs.flight import flight_dump, get_flight
from ...obs.registry import get_registry
from ...obs.trace import phase_of, tracer_from_config
from ..batcher import MicroBatcher, Request
from ..errors import (GenerationCancelled, KVCacheExhausted, OverloadError,
                      SheddedError)
from ..metrics import ServingMetrics, quantiles
from .decoder import GraphDecoder
from .pages import KVPagePool, PrefixCache, export_pages, import_pages
from .sampling import SamplingParams

_END = object()  # token-stream sentinel


def _params_on(model, device: torch.device) -> Dict[str, torch.Tensor]:
    """The model's parameters on ``device``: the model's own dict when it
    lives there (engines of one model on one card share it), else a
    copy."""
    if _canon(device) == _canon(model.device):
        return model._params
    return {k: v.to(device) for k, v in model._params.items()}


def _on_mesh(model) -> bool:
    return bool(getattr(model, "_on_mesh", False))


class _PlanChannel:
    """Rank 0's step plans to the other ranks of a sharded engine: one
    pickled tuple a dispatch, broadcast as a length and a byte tensor
    over a gloo group the engine creates (CPU tensors, so it runs under
    an NCCL default group too).  ``dispatches`` and ``plan_bytes`` count
    what went through, on every rank."""

    def __init__(self):
        import torch.distributed as dist
        self._dist = dist
        # collective: every rank builds the engine at one point
        self.group = dist.new_group(backend="gloo")
        self.dispatches = 0
        self.plan_bytes = 0

    def send(self, plan) -> None:
        payload = pickle.dumps(plan, protocol=pickle.HIGHEST_PROTOCOL)
        n = torch.tensor([len(payload)], dtype=torch.int64)
        self._dist.broadcast(n, 0, group=self.group)
        self._dist.broadcast(
            torch.frombuffer(bytearray(payload), dtype=torch.uint8), 0,
            group=self.group)
        self._count(plan, len(payload))

    def recv(self):
        n = torch.zeros(1, dtype=torch.int64)
        self._dist.broadcast(n, 0, group=self.group)
        buf = torch.empty(int(n[0]), dtype=torch.uint8)
        self._dist.broadcast(buf, 0, group=self.group)
        plan = pickle.loads(buf.numpy().tobytes())
        self._count(plan, int(n[0]))
        return plan

    def _count(self, plan, nbytes: int) -> None:
        if plan[0] != "stop":
            self.dispatches += 1
            self.plan_bytes += nbytes


class _DeviceArg:
    """A device tensor argument of a plan (a verify's draft proposals or
    probabilities), shipped as its host array."""

    def __init__(self, t: torch.Tensor):
        self.array = t.detach().cpu().numpy()


class _PlannedDecoder:
    """Rank 0's view of a decoder in a sharded engine: each dispatch
    function sends its plan (``role``, kind, its argument and the call's
    host arguments) before it runs; everything else is the decoder's."""

    def __init__(self, decoder: GraphDecoder, role: str,
                 channel: _PlanChannel):
        self._dec, self._role, self._chan = decoder, role, channel

    def __getattr__(self, name):
        return getattr(self._dec, name)

    def _planned(self, kind: str, arg, fn):
        def call(params, caches, *args):
            self._chan.send((self._role, kind, arg, tuple(
                _DeviceArg(a) if isinstance(a, torch.Tensor) else a
                for a in args)))
            return fn(params, caches, *args)
        return call

    def prefill_fn(self, bucket: int):
        return self._planned("prefill", bucket, self._dec.prefill_fn(bucket))

    def decode_fn(self):
        return self._planned("decode", None, self._dec.decode_fn())

    def decode_sampled_fn(self):
        return self._planned("decode_s", None,
                             self._dec.decode_sampled_fn())

    def verify_fn(self, width: int, sampled: bool = False):
        return self._planned("verify", (width, sampled),
                             self._dec.verify_fn(width, sampled))

    def draft_fn(self, gamma: int, sampled: bool = False):
        return self._planned("draft", (gamma, sampled),
                             self._dec.draft_fn(gamma, sampled))


def _dispatch_fn(decoder: GraphDecoder, kind: str, arg):
    """The decoder function a plan names."""
    if kind == "prefill":
        return decoder.prefill_fn(arg)
    if kind == "decode":
        return decoder.decode_fn()
    if kind == "decode_s":
        return decoder.decode_sampled_fn()
    if kind == "verify":
        return decoder.verify_fn(*arg)
    if kind == "draft":
        return decoder.draft_fn(*arg)
    raise ValueError(f"unknown plan kind {kind!r}")


def _canon(device: torch.device) -> torch.device:
    """``cuda`` as the index it means on this thread."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


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
                 deadlined: bool = False, trace: Optional[str] = None,
                 sampling: Optional[SamplingParams] = None,
                 handoff=None):
        self.future: Future = Future()
        # disaggregated prefill/decode: when set, the engine offers the
        # stream's KV page chain to ``handoff(payload) -> bool`` at
        # prefill completion.  True: a decode engine adopted the stream
        # and this engine frees its slot; False or a raise: the stream
        # decodes here and nothing fails.  Set at submit() by the router.
        self.handoff = handoff
        self.prompt_len = int(prompt_len)
        self.max_new = int(max_new)
        self.t_submit = t_submit
        self.deadlined = deadlined
        # None or greedy keeps the stream on the argmax decode
        self.sampling = sampling
        # sampled trace id (obs.trace) or None
        self.trace = trace
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
    through ``pool_stats_fn`` and ``spec_stats_fn``.  The totals are
    registry counters like every serving counter; emitted as
    ``gen_stats`` events."""

    def __init__(self, **kw):
        super().__init__(**kw)
        self._ttfts: deque = deque(maxlen=4096)  # guarded_by: self._lock
        self._steps: deque = deque()             # guarded_by: self._lock
        # the engine's pool and speculation views, merged into
        # snapshot(); only this object holds them (the registry holds
        # no reference to it once released), so stats() keeps them
        # after the engine stops
        self.pool_stats_fn = None
        self.spec_stats_fn = None
        reg = get_registry()
        kv = {"model": self.model_tag, "eng": self.eng_id}
        labels = ("model", "eng")
        # into self._fams too: unregister() reclaims these series with
        # the rest
        for key, name, text in (
                ("tokens", "ff_gen_tokens_total",
                 "Tokens generated (incl. the prefill's first token)"),
                ("prefills", "ff_gen_prefills_total",
                 "Prefill completions (stream joins)"),
                ("draft_dispatches", "ff_gen_draft_dispatches_total",
                 "Speculative draft dispatches (one a round)"),
                ("spec_proposed", "ff_gen_spec_proposed_tokens_total",
                 "Draft tokens proposed to the verifier"),
                ("spec_accepted", "ff_gen_spec_accepted_tokens_total",
                 "Draft tokens the verifier accepted"),
                ("spec_fallbacks", "ff_gen_spec_fallbacks_total",
                 "Demotions to plain decode (draft failure or "
                 "accept-rate collapse)")):
            self._fams[key] = reg.counter(name, text, labels)
            self._ctr[key] = self._fams[key].labels(**kv)

    @property
    def total_tokens(self) -> int:
        return int(self._ctr["tokens"].value)

    @property
    def total_prefills(self) -> int:
        return int(self._ctr["prefills"].value)

    def _trim_steps(self, now: float) -> None:
        horizon = now - self.window_s
        while self._steps and self._steps[0][0] < horizon:
            self._steps.popleft()

    def record_ttft(self, seconds: float) -> None:
        now = self.clock()
        self._ctr["prefills"].inc()
        with self._lock:
            self._ttfts.append((now, float(seconds)))

    def record_decode_step(self, ntokens: int, step_s: float) -> None:
        now = self.clock()
        self._ctr["tokens"].inc(int(ntokens))
        with self._lock:
            self._steps.append((now, int(ntokens), float(step_s)))
            self._trim_steps(now)

    def record_spec_round(self, proposed: int, accepted: int) -> None:
        """One speculative round: one draft dispatch, ``proposed`` draft
        tokens judged, ``accepted`` of them kept."""
        self._ctr["draft_dispatches"].inc()
        self._ctr["spec_proposed"].inc(int(proposed))
        self._ctr["spec_accepted"].inc(int(accepted))

    def record_spec_fallback(self) -> None:
        self._ctr["spec_fallbacks"].inc()

    def record_prefill_token(self) -> None:
        """The prefill's first token counts toward tokens/s too."""
        now = self.clock()
        self._ctr["tokens"].inc()
        with self._lock:
            self._steps.append((now, 1, 0.0))
            self._trim_steps(now)

    def snapshot(self) -> Dict:
        snap = super().snapshot()
        now = self.clock()
        with self._lock:
            steps = list(self._steps)
            ttfts = [v for _, v in self._ttfts]
        span = self.window_s
        if steps:
            span = min(self.window_s, max(1e-6, now - steps[0][0]))
        qt = quantiles(ttfts)
        qp = quantiles([s[2] for s in steps if s[2] > 0])

        def ms(v):
            return None if v != v else round(v * 1e3, 3)

        proposed = int(self._ctr["spec_proposed"].value)
        accepted = int(self._ctr["spec_accepted"].value)
        snap.update({
            "tokens_per_s": round(sum(s[1] for s in steps) / span, 3),
            "tokens": self.total_tokens, "prefills": self.total_prefills,
            "ttft_p50_ms": ms(qt[0.5]), "ttft_p95_ms": ms(qt[0.95]),
            "ttft_p99_ms": ms(qt[0.99]),
            "tpot_p50_ms": ms(qp[0.5]), "tpot_p95_ms": ms(qp[0.95]),
            "tpot_p99_ms": ms(qp[0.99]),
            # under speculation a "step" is a draft + verify round, so
            # the tpot_* percentiles are rounds; tokens_per_s compares
            "draft_dispatches": int(self._ctr["draft_dispatches"].value),
            "spec_proposed_tokens": proposed,
            "spec_accepted_tokens": accepted,
            "accept_rate": (round(accepted / proposed, 4)
                            if proposed else 0.0),
            "spec_fallbacks": int(self._ctr["spec_fallbacks"].value),
        })
        for fn in (self.pool_stats_fn, self.spec_stats_fn):
            if fn is not None:
                snap.update(fn())
        return snap

    def emit(self, extra: Optional[Dict] = None) -> None:
        # eng rides as an event field, as serve_stats': the cluster
        # router's load scrape keys on it
        get_logger("serve").event("gen_stats", eng=self.eng_id,
                                  **self.snapshot(), **(extra or {}))


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
    ``model.device`` unless ``device`` names another (the engine then
    keeps its own copy of the parameters there); ``clock`` and ``sleep``
    are injectable for tests.

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
                 stats_every: int = 32, metrics_window_s: float = 30.0,
                 clock=time.monotonic, sleep=time.sleep,
                 name: str = "", device=None):
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
        # the device this engine's pools live on and its steps run on;
        # two engines of one model on one card share the parameters
        self.device = (model.device if device is None
                       else torch.device(device))
        # sharded generation: one process a device, rank 0 the owner
        self._mesh = model.mesh if _on_mesh(model) else None
        self._plan_chan: Optional[_PlanChannel] = None
        self.is_owner = True
        self._group_error: Optional[str] = None
        if self._mesh is not None:
            import torch.distributed as dist
            if _canon(self.device) != _canon(model.device):
                raise ValueError(
                    f"a sharded engine runs on its rank's device "
                    f"{model.device}, not {self.device}")
            self.is_owner = dist.get_rank() == 0
        self.slots = int(slots or cfg.serve_gen_slots)
        seq_len = (model.input_tensors[0].shape[1]
                   if model.input_tensors else 0)
        self.max_seq = int(max_seq or cfg.serve_gen_max_seq or seq_len)
        self.max_new_tokens = int(max_new_tokens
                                  or cfg.serve_gen_max_new_tokens)
        self.eos_id = eos_id
        self.clock = clock
        self._sleep = sleep
        self.stats_every = int(stats_every)
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
        # one lock-free `active` read a step when tracing is off; flight
        # taps installed for post-mortem dumps
        self._tracer = tracer_from_config(cfg)
        get_flight()
        self._decoder = GraphDecoder.for_model(
            model, self.slots, self.max_seq,
            page_size=int(page_size or 0), num_pages=int(num_pages or 0),
            device=self.device, mesh=self._mesh)
        # the walks' parameters: the model's own (a copy on another
        # device), on a mesh this rank's local tensors
        self._params = (self._decoder.local_params(model._params)
                        if self._mesh is not None
                        else _params_on(model, self.device))
        self.page_size = self._decoder.page_size
        self.num_pages = self._decoder.num_pages
        # what the memory gate charges is what the pool allocates (on a
        # mesh, a device's bytes)
        self.kv_plan = kv_page_plan(
            model.layers, self._mesh_sizes(model), self.slots,
            self.max_seq,
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
        # migrated-stream inbox: the router's handoff appends payloads
        # from the SOURCE engine's thread; this engine's dispatch thread
        # drains it at step boundaries (deque append and popleft are
        # atomic, so no lock and no cross-engine lock edge)
        self._adopt_q: deque = deque()
        # per-migration wall costs (ms): export here as a source, import
        # here as a destination
        self.migrate_export_ms: List[float] = []
        self.migrate_import_ms: List[float] = []
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
        # the decoders the followers apply plans to; rank 0 dispatches
        # through planned views of them
        self._raw_decoder = self._decoder
        self._raw_draft_decoder = self._draft_decoder
        if self._mesh is not None:
            self._plan_chan = _PlanChannel()
            if self.is_owner:
                self._decoder = _PlannedDecoder(self._decoder, "t",
                                                self._plan_chan)
                if self._draft_decoder is not None:
                    self._draft_decoder = _PlannedDecoder(
                        self._draft_decoder, "d", self._plan_chan)
        self._gen_faults: List[Dict] = []
        # set by each host fetch, so dispatch_pending knows whether its
        # charged time already waited for the device
        self._fetched = False
        # lifecycle (single use, as ServingEngine)
        self._lifecycle = lockwatch.lock("GenerationEngine._lifecycle")
        self._thread: Optional[  # guarded_by: self._lifecycle
            threading.Thread] = None
        self._stopped = False    # guarded_by: self._lifecycle
        self._draining = False   # guarded_by: self._lifecycle
        self._finalized = False  # guarded_by: self._lifecycle
        self._closing = threading.Event()
        self._abort = threading.Event()
        self._shutdown_done = threading.Event()

    @staticmethod
    def _mesh_sizes(model) -> Optional[Dict[str, int]]:
        return dict(model.mesh.sizes) if _on_mesh(model) else None

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
            if _on_mesh(draft_model) != (self._mesh is not None):
                raise ValueError(
                    "a sharded engine's draft runs on the same ranks: "
                    "compile it in the same process group (a replicated "
                    "draft is data parallel over every rank)")
            self._draft_decoder = GraphDecoder.for_model(
                draft_model, self.slots, self.max_seq,
                page_size=self.page_size, num_pages=self.num_pages,
                device=self.device,
                mesh=draft_model.mesh if _on_mesh(draft_model) else None)
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
                draft_model.layers, self._mesh_sizes(draft_model),
                self.slots, self.max_seq,
                kv_dtype_bytes=dtype_bytes(cfg.compute_dtype),
                page_size=self.page_size, num_pages=self.num_pages)
            self.draft_kv_cache_bytes = self.draft_kv_plan["total_bytes"]
            self._draft_params = (
                self._draft_decoder.local_params(draft_model._params)
                if _on_mesh(draft_model)
                else _params_on(draft_model, self.device))
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

    # ---- strategy-sharded construction -------------------------------
    @classmethod
    def from_strategy(cls, model, strategy_file: str, mesh=None, **kw):
        """Build a tensor-parallel generation engine from a strategy
        ``.pb``: load the per-op ParallelConfigs, compile the model
        against them (verified; the mesh inferred from the strategies
        over the world when not given) and initialise it, or, for a
        model already initialised, re-place its live parameters under
        the strategies (``FFModel.reshard`` onto the strategy's mesh),
        then build the engine, whose KV pools shard their heads over
        ``c``.  One process per device: every rank calls it at the same
        point with the same arguments, and rank 0 owns the engine (see
        the module docstring)."""
        from ...parallel.mesh import MachineMesh
        from ...strategy.proto import load_strategy_file
        strategies = load_strategy_file(strategy_file)
        model.config.strategies.update(strategies)
        if not model._compiled:
            model.compile(mesh=mesh)
            model.init_layers(seed=model.config.seed)
        else:
            for op in model.layers:
                op.parallel_config = model.config.strategies.get(
                    op.name, op.parallel_config)
            if mesh is None:
                from ...parallel import distributed
                mesh = MachineMesh(
                    model._infer_mesh_shape(distributed.world_size()),
                    device=model.device)
            model.reshard(new_mesh=mesh)
        return cls(model, **kw)

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

    def _arm(self, warmup: bool, external: bool) -> None:
        """Allocate the pools, warm the programs, read the fault plan and
        announce the engine (``gen_engine_start``).  Lifecycle lock
        held."""
        self._caches = self._decoder.init_cache()
        if self._spec_on:
            self._draft_caches = self._draft_decoder.init_cache()
        if warmup:
            self._warmup()
        self._gen_faults = _load_gen_faults()
        get_logger("serve").event(
            "gen_engine_start", model=self.name, slots=self.slots,
            max_seq=self.max_seq, kv_cache_bytes=self.kv_cache_bytes,
            kv_page_size=self.page_size, kv_num_pages=self.num_pages,
            prefix_cache="on" if self.prefix_cache_enabled else "off",
            prefill_chunk=self.prefill_chunk, admission=self.admission,
            max_queue_requests=self.max_queue_requests,
            external=external, **self._spec_stats())

    def start(self, warmup: bool = True) -> "GenerationEngine":
        with self._lifecycle:
            if self._stopped:
                raise RuntimeError(
                    "engine was stopped; create a new GenerationEngine")
            if self._thread is None:
                if self._caches is not None:
                    raise RuntimeError("engine is fleet-managed "
                                       "(begin_external_dispatch)")
                # a follower applies rank 0's plans, warm-up included
                self._arm(warmup and self.is_owner, external=False)
                target = (self._follow_loop if not self.is_owner
                          else self._owner_loop if self._mesh is not None
                          else self._decode_loop)
                self._thread = threading.Thread(
                    target=target, name="ff-generate", daemon=True)
                self._thread.start()
        return self

    def stop(self) -> None:
        """Close admissions, serve everything queued and in flight to
        completion, stop the dispatcher and emit the final stats.
        Idempotent; single use.  For a bounded shutdown see
        :meth:`drain`."""
        to_fail: List[Request] = []
        with self._lifecycle:
            self._closing.set()
            self._batcher.close()
            if self._thread is not None:
                # lock-ok: the dispatcher never takes _lifecycle, so
                # joining it under the lock cannot deadlock
                self._thread.join()
                self._thread = None
                if not self._finalized:
                    self._finalized = True
                    self.metrics.emit(extra={"final": True,
                                             "slots": self.slots})
            else:
                to_fail = self._batcher.fail_pending()
            self._stopped = True
        now = self.clock()
        for r in to_fail:
            r.on_done(SheddedError("engine stopped before it was started"),
                      now)
        # a stopped engine must not be retained by the process registry
        self.metrics.release()
        self._shutdown_done.set()
        if self._group_error is not None:
            raise RuntimeError(f"the sharded engine's group failed: "
                               f"{self._group_error}")

    # ---- sharded engine: rank 0's loop and the followers' ---------------
    def _owner_loop(self) -> None:
        """Rank 0's dispatcher, then the stop plan that ends the
        followers' loops."""
        try:
            self._decode_loop()
        finally:
            self._plan_chan.send(("stop", self._group_error))

    def _follow_loop(self) -> None:
        """A follower's dispatcher: apply each of rank 0's plans to this
        rank's shard (its parameters, pools and caches) until the stop
        plan.  A step that fails here exits the process: the group's
        collectives cannot go on without this rank, and a silent rank
        would leave the others waiting."""
        device = self.model.device
        if device.type == "cuda" and device.index is not None:
            torch.cuda.set_device(device)
        chan = self._plan_chan
        while True:
            plan = chan.recv()
            if plan[0] == "stop":
                self._group_error = plan[1]
                if plan[1] is not None:
                    get_logger("serve").event(
                        "gen_group_error", model=self.name, error=plan[1])
                return
            role, kind, arg, args = plan
            try:
                if role == "t":
                    dec, params, caches = (self._raw_decoder, self._params,
                                           self._caches)
                else:
                    dec, params, caches = (self._raw_draft_decoder,
                                           self._draft_params,
                                           self._draft_caches)
                args = tuple(torch.from_numpy(a.array).to(self.device)
                             if isinstance(a, _DeviceArg) else a
                             for a in args)
                _dispatch_fn(dec, kind, arg)(params, caches, *args)
            except BaseException:  # noqa: BLE001 — the group fails loudly
                print(f"sharded generation: rank "
                      f"{torch.distributed.get_rank()} failed its "
                      f"{kind} step; exiting the group",
                      file=sys.stderr, flush=True)
                traceback.print_exc()
                sys.stderr.flush()
                os._exit(1)

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
        get_logger("serve").event(
            "gen_drain", model=self.name, timeout_s=timeout,
            queue_depth=self._batcher.queue_depth)
        shed = 0
        if thread is not None:
            thread.join(timeout)
            if thread.is_alive():
                self._abort.set()
                now = self.clock()
                for r in self._batcher.fail_pending():
                    if r.on_done(SheddedError(
                            f"engine drained with work still queued (drain "
                            f"timeout {timeout}s)"), now):
                        shed += 1
                thread.join(timeout)
        else:
            now = self.clock()
            for r in self._batcher.fail_pending():
                if r.on_done(SheddedError(
                        "engine drained before it was started"), now):
                    shed += 1
        with self._lifecycle:
            self._stopped = True
            self._draining = False
            self._thread = None
            first = not self._finalized
            self._finalized = True
        snap = self.stats()
        if first:
            self.metrics.emit(extra={"final": True, "slots": self.slots,
                                     "drain_shed": shed})
        self.metrics.release()
        self._shutdown_done.set()
        return snap

    def __enter__(self) -> "GenerationEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---- fleet-managed (external) dispatch -----------------------------
    def begin_external_dispatch(self, warmup: bool = True
                                ) -> "GenerationEngine":
        """Fleet mode: ready the engine without its own decode thread; a
        :class:`~..fleet.FleetEngine` drives :meth:`dispatch_pending`
        from one shared dispatcher, interleaved with its co-resident
        tenants.  The producer side behaves exactly as under
        :meth:`start`."""
        with self._lifecycle:
            if self._stopped:
                raise RuntimeError(
                    "engine was stopped; create a new GenerationEngine")
            if self._thread is not None:
                raise RuntimeError(
                    "engine already runs its own decode thread")
            if self._mesh is not None:
                raise ValueError("a sharded engine runs its own "
                                 "dispatcher (rank 0's plans); fleet "
                                 "mode takes one-device engines")
            if self._caches is None:
                self._arm(warmup, external=True)
        return self

    def dispatch_pending(self) -> Optional[float]:
        """One externally driven step (fleet mode): expire queued
        deadlines, adopt one migrated stream, join queued prompts into
        free slots, advance prefill by at most one chunk and every active
        stream by one token.  Returns the seconds the fleet's fair
        scheduler charges this tenant, or None when nothing was due.  The
        charge ends once the step's work has finished on the device: a
        step that ended without a host fetch (a prefill chunk short of
        the prompt's end) waits for the device first.  A failed step
        fails the active streams; the engine serves on."""
        t0 = self.clock()
        self._fetched = False
        self._batcher.reap_expired()
        adopted = self._join_adopted()
        self._admit()
        progressed = self._prefill_step() or adopted
        self._grow_active_pages()
        if any(s is not None and not s.prefilling
               for s in self._slots_state):
            self._fire_slow_decode()
            try:
                self._step_active()
            except Exception as e:  # noqa: BLE001 — the step's failure
                # is the streams', not the fleet dispatcher's
                self._recover_from_dispatch_error(e, "gen_decode_error")
        elif not progressed:
            return None
        if not self._fetched and self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        return max(0.0, self.clock() - t0)

    @property
    def has_pending(self) -> bool:
        """Whether an external dispatcher has work to schedule here:
        occupied slots, queued prompts or migrated streams to adopt."""
        return (any(s is not None for s in self._slots_state)
                or self._batcher.queue_depth > 0
                or len(self._adopt_q) > 0)

    # ---- producer side -------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               deadline_ms: Optional[float] = None, priority: int = 0,
               sampling: Optional[SamplingParams] = None,
               handoff=None) -> GenerationStream:
        """Queue one prompt (1-D int token ids) and return its
        :class:`GenerationStream`.  Thread-safe.  ``max_new_tokens`` caps
        the stream (default from config); generation also ends at
        ``eos_id``.  ``deadline_ms`` and ``priority`` behave as the dense
        engine's.  ``sampling`` selects temperature/top-k/top-p with a
        seed; None or temperature 0 is greedy argmax, and a step with no
        sampled stream runs the argmax decode.  ``handoff`` (disaggregated
        serving) is a ``callable(payload) -> bool`` offered the stream's
        exported KV pages at prefill completion (see
        :meth:`adopt_migrated`)."""
        if not self.is_owner:
            raise RuntimeError(
                "submit on a follower rank of a sharded engine: rank 0 "
                "owns every request (the other ranks apply its plans)")
        if handoff is not None and self._mesh is not None:
            raise ValueError("KV migration (handoff) takes one-device "
                             "engines, not a sharded one")
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
        tr = self._tracer
        trace = tr.new_trace() if tr.active else None
        stream = GenerationStream(arr.size, max_new, t0,
                                  deadlined=deadline_ms is not None,
                                  trace=trace, sampling=sampling,
                                  handoff=handoff)
        deadline = None if deadline_ms is None else t0 + deadline_ms / 1e3
        metrics = self.metrics
        trace_term = self._trace_terminal

        def on_done(out, now: float) -> bool:
            # the failure paths (expiry, shed, drain, stop); success is
            # the decode loop's _finish
            if isinstance(out, BaseException) and stream._fail(out):
                metrics.record_failure(out)
                trace_term(stream, phase_of(out), now)
                return True
            return False

        req = _GenRequest(stream, arr.copy(), on_done, t0,
                          deadline=deadline, priority=priority)
        req.trace = trace

        def count_cancel(f):
            # a cancel while queued resolves through no engine path:
            # count it here (a claimed future cannot be cancelled)
            if f.cancelled():
                metrics.record_cancelled()
                trace_term(stream, "cancelled", self.clock())

        stream.future.add_done_callback(count_cancel)
        try:
            self._batcher.submit(req)
        except OverloadError:
            self.metrics.record_rejected()
            self._trace_terminal(stream, "rejected", self.clock())
            raise
        except RuntimeError as e:
            self.metrics.record_rejected()
            self._trace_terminal(stream, "rejected", self.clock())
            raise OverloadError(
                f"engine is not admitting new work ({e})") from e
        return stream

    def _trace_terminal(self, stream: GenerationStream, phase: str,
                        now: float) -> None:
        """The stream's one terminal ``request`` span (no-op for an
        unsampled stream)."""
        if stream.trace is None:
            return
        self._tracer.span(
            "request", stream.trace, stream.t_submit, now,
            tid=self.name or "generate", phase=phase,
            tokens=len(stream._tokens), model=self.name)

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
        plan = ({} if self._plan_chan is None else
                {"plan_dispatches": self._plan_chan.dispatches,
                 "plan_bytes": self._plan_chan.plan_bytes})
        return {**self.metrics.snapshot(), **plan, "slots": self.slots,
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
            self._join_adopted()
            self._admit()
            progressed = self._prefill_step()
            self._grow_active_pages()
            if any(s is not None and not s.prefilling
                   for s in self._slots_state):
                self._fire_slow_decode()
                try:
                    self._step_active()
                except Exception as e:  # noqa: BLE001 — a failed step
                    # fails the active streams, not the dispatcher
                    self._recover_from_dispatch_error(e,
                                                      "gen_decode_error")
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
                    f"{len(st.pages)} page(s) freed"), "cancelled")
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
                f"fully referenced)"), "shed")
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
                # one fetch a join, not a chunk: the first token
                tok = int(first.cpu())
                self._fetched = True
        except Exception as e:  # noqa: BLE001 — a failed chunk fails the
            # joining stream and (the pools may hold partial writes)
            # every stream in flight; the engine re-arms and serves on
            self._prefill_q.popleft()
            if st.stream._fail(e):
                self.metrics.record_failure(e)
                self._trace_terminal(st.stream, "error", self.clock())
            self._recover_from_dispatch_error(e, "gen_prefill_error")
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
        if self._tracer.active and stream.trace is not None:
            tname = self.name or "generate"
            self._tracer.span("queue", stream.trace, stream.t_submit,
                              st.t_join, tid=tname, slot=slot)
            self._tracer.span("prefill", stream.trace, st.t_join, now,
                              tid=tname, slot=slot, phase="target",
                              prompt_len=int(prompt.size),
                              prefix_hit_tokens=st.hit_tokens,
                              prefill_chunks=st.chunks)
        if stream.handoff is not None and not (
                st.generated >= stream.max_new
                or (self.eos_id is not None and tok == self.eos_id)):
            # disaggregated serving: offer the page chain to the
            # router's handoff.  A stream retiring at this boundary stays
            # (its pages would ship with nothing left to decode).
            if self._migrate_out(slot, st, now):
                return True
        if self._spec_active():
            self._draft_prefill(slot, st)
        self._retire(slot, st, now)
        return True

    # ---- disaggregated prefill/decode migration ------------------------
    def _migrate_out(self, slot: int, st: _Slot, now: float) -> bool:
        """Export the slot's KV pages and stream state and offer them to
        ``stream.handoff``.  True: a decode engine adopted the stream and
        the slot is freed (prefix pages the trie holds stay cached
        here).  False: the stream decodes here, with one ``serve_health``
        event and no stream failed; the slot is untouched either way
        until adoption is confirmed.  The chain ships unpadded: torch
        has no per-shape compile to amortize."""
        stream = st.stream
        t0 = self.clock()
        try:
            if not (self._decoder.has_attention
                    and self._decoder.supports_chunking):
                raise RuntimeError(
                    "graph state is not pageable (no paged attention): "
                    "KV migration needs a chunkable attention graph")
            e0 = time.perf_counter()
            host = export_pages(self._caches, st.pages, self.num_pages)
            self.migrate_export_ms.append(
                (time.perf_counter() - e0) * 1e3)
            self._fetched = True
            # the real chain's bytes
            nbytes = sum(t.numel() * t.element_size() // int(t.shape[0])
                         for sub in host.values()
                         for t in sub.values()) * len(st.pages)
            payload = {
                "stream": stream,
                "prompt": st.prompt,
                "pages": host,
                "pages_used": len(st.pages),
                "nbytes": nbytes,
                "page_size": self.page_size,
                "last_token": int(st.last_token),
                "length": int(st.length),
                "generated": int(st.generated),
                "source": self.name,
            }
            adopted = bool(stream.handoff(payload))
        except Exception as e:  # noqa: BLE001 — a failed export or
            # handoff costs this stream nothing but staying here
            self._migrate_fallback(slot, e)
            return False
        if not adopted:
            self._migrate_fallback(slot, None)
            return False
        if self._tracer.active and stream.trace is not None:
            self._tracer.span("migrate", stream.trace, t0, self.clock(),
                              tid=self.name or "generate", slot=slot,
                              phase="export", pages=len(st.pages),
                              bytes=payload["nbytes"])
        # the destination owns the stream now: free the slot without
        # finishing it (the trie keeps its own references)
        self._release_slot(slot, st)
        return True

    def _migrate_fallback(self, slot: int, exc) -> None:
        """Migration declined or failed: one ``serve_health`` event (no
        stream fails, the stream decodes here) and a flight dump when it
        was an error rather than a routing decision."""
        err = ("" if exc is None
               else f"{type(exc).__name__}: {exc}"[:300])
        get_logger("serve").event(
            "serve_health", model=self.name, component="migration",
            status="fallback", slot=slot,
            reason=("handoff_declined" if exc is None
                    else "handoff_error"),
            error=err, step=self._n_steps)
        if exc is not None:
            flight_dump("gen_migrate_error",
                        extra={"model": self.name, "slot": slot,
                               "error": err, "step": self._n_steps})

    def adopt_migrated(self, payload: Dict) -> bool:
        """Decode-engine side of migration: queue an
        :func:`~.pages.export_pages` payload (with its stream state) for
        adoption at this engine's next step boundary.  Thread-safe: the
        source engine's thread calls it through the router's handoff.
        The payload's pages are complete where they are (host, or this
        engine's device after ``pages.pages_to_device``); the import runs
        on this engine's own dispatch thread, which alone writes its
        pools.  Returns False once the engine is stopping."""
        with self._lifecycle:
            if (self._stopped or self._closing.is_set()
                    or self._mesh is not None):
                return False
        self._adopt_q.append(payload)
        return True

    def _join_adopted(self) -> bool:
        """Import one queued migrated stream into a free slot.  A payload
        with no free slot waits at the queue head.  One adoption a step
        boundary bounds the gap an arriving burst costs the streams in
        flight.  True when a stream joined."""
        if not self._adopt_q:
            return False
        if not any(s is None for s in self._slots_state):
            return False
        try:
            payload = self._adopt_q.popleft()
        except IndexError:
            return False
        self._import_migrated(payload)
        return True

    def _import_migrated(self, payload: Dict) -> None:
        """Allocate destination pages, write the payload into them
        (:func:`~.pages.import_pages`) and seat the stream in a free slot
        mid-generation: decode goes on here where the source's prefill
        stopped.  The prompt's full pages join this engine's prefix
        trie, as a co-located join's do; an exhausted pool sheds the
        stream, as a co-located allocation failure does."""
        stream: GenerationStream = payload["stream"]
        prompt = np.asarray(payload["prompt"], np.int32).reshape(-1)
        now = self.clock()
        slot = next((i for i, s in enumerate(self._slots_state)
                     if s is None), None)
        if slot is None:  # _join_adopted guards this; never strand
            self._adopt_q.appendleft(payload)
            return
        first = next(iter(next(iter(payload["pages"].values())).values()))
        need = int(payload.get("pages_used") or first.shape[0])
        pages: List[int] = []
        while len(pages) < need:
            pg = self._alloc_page()
            if pg is None:
                break
            pages.append(pg)
        if len(pages) < need or int(payload["page_size"]) != \
                self.page_size:
            for pg in pages:
                self._pool.release(pg)
            exc = KVCacheExhausted(
                f"cannot adopt migrated stream: need {need} page(s) "
                f"of size {payload['page_size']} (pool {self.num_pages} "
                f"pages of {self.page_size}, {self._pool.pages_in_use} "
                f"in use)")
            if stream._fail(exc):
                self.metrics.record_failure(exc)
                self._trace_terminal(stream, "shed", now)
            return
        try:
            i0 = time.perf_counter()
            import_pages(self._caches, payload["pages"], pages)
            self.migrate_import_ms.append(
                (time.perf_counter() - i0) * 1e3)
        except Exception as e:  # noqa: BLE001 — a poisoned import fails
            # only the migrating stream (import_pages validates every
            # leaf before its first write)
            for pg in pages:
                self._pool.release(pg)
            if stream._fail(e):
                self.metrics.record_failure(e)
                self._trace_terminal(stream, "error", now)
            return
        st = _Slot(stream, prompt, [], self.page_size, now)
        st.pages = pages
        st.prefilling = False
        st.length = int(payload["length"])
        st.next_pos = st.length
        st.last_token = int(payload["last_token"])
        st.generated = int(payload["generated"])
        for i, pg in enumerate(pages):
            self._table[slot, i] = pg
        self._slots_state[slot] = st
        if self._tracer.active and stream.trace is not None:
            self._tracer.span("migrate", stream.trace, now, self.clock(),
                              tid=self.name or "generate", slot=slot,
                              phase="import", pages=len(pages),
                              bytes=int(payload.get("nbytes", 0)),
                              source=str(payload.get("source", "")))
        if self._prefix is not None:
            full = max(0, (int(prompt.size) - 1) // self.page_size)
            self._prefix.insert(prompt, st.pages[:full])
        if self._spec_active():
            # speculation composes with migration by hosting the draft
            # with the decode engine: mirror the prompt into its cache
            self._draft_prefill(slot, st)

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
                    f"{self._pool.pages_in_use} in use)"), "shed")

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

    def _fail_slot(self, slot: int, st: _Slot, exc: BaseException,
                   phase: str) -> None:
        if st.stream._fail(exc):
            self.metrics.record_failure(exc)
            self._trace_terminal(st.stream, phase, self.clock())
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
        traced = self._tracer.active
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
        self._fetched = True
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
        if traced:
            self._tracer.span("decode_step", None, t0, now,
                              tid=self.name or "generate",
                              step=self._n_steps - 1, active=nactive,
                              phase="decode")
        self.metrics.record_decode_step(nactive, now - t0)
        self._fire_cancel_at_token(now)
        self._maybe_emit(nactive)

    def _maybe_emit(self, nactive: int) -> None:
        if self.stats_every and self._n_steps % self.stats_every == 0:
            self.metrics.emit(extra={"slots": self.slots,
                                     "active": nactive})

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
                    f"{self._pool.pages_in_use} in use)"), "shed")
                continue
            if not self._ensure_draft_pages(i, s, upto):
                self._fail_slot(i, s, KVCacheExhausted(
                    f"no draft KV page free at position {s.length} "
                    f"(draft pool {self.num_pages} pages, "
                    f"{self._draft_pool.pages_in_use} in use)"), "shed")
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
        traced = self._tracer.active
        t0 = self.clock()
        try:
            self._fire_spec_draft_fail()
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
        t1 = self.clock()
        if traced:
            self._tracer.span("decode_step", None, t0, t1,
                              tid=self.name or "generate",
                              step=self._n_steps, phase="draft",
                              gamma=g, active=nactive)
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
        self._fetched = True
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
        if traced:
            self._tracer.span("decode_step", None, t1, now,
                              tid=self.name or "generate",
                              step=self._n_steps - 1, phase="verify",
                              gamma=g, active=nactive,
                              proposed=proposed, accepted=accepted)
        self.metrics.record_spec_round(proposed, accepted)
        self.metrics.record_decode_step(emitted, now - t0)
        self._spec_account(g, proposed, accepted, now - t0)
        self._fire_cancel_at_token(now)
        self._maybe_emit(nactive)

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
            t0 = self.clock()
            self._draft_decoder.prefill_fn(bucket)(
                self._draft_params, self._draft_caches, tokens,
                self._draft_table[slot].copy(), slot, 0, size)
            self._draft_prefills += 1
            if self._tracer.active and st.stream.trace is not None:
                self._tracer.span("prefill", st.stream.trace, t0,
                                  self.clock(),
                                  tid=self.name or "generate",
                                  slot=slot, phase="draft",
                                  prompt_len=size)
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
        get_logger("serve").event(
            "serve_health", model=self.name, component="speculation",
            status="fallback", reason=reason,
            error=("" if exc is None
                   else f"{type(exc).__name__}: {exc}"[:300]),
            step=self._n_steps,
            accept_ewma=(round(self._accept_ewma, 4)
                         if self._accept_ewma is not None else None))

    def _recover_from_dispatch_error(self, e: BaseException,
                                     event: str) -> None:
        """A prefill or decode dispatch raised part way: the pools may
        hold a partial step, so every stream in flight and every cached
        prefix page is lost.  Fail them all, rebuild the pool, trie and
        zeroed pools (lifetime counters carry over) and keep serving the
        queue.  A sharded engine cannot rebuild one rank's shard alone:
        its group fails loudly instead (:meth:`_fail_group`)."""
        if self._mesh is not None:
            self._fail_group(e, event)
            return
        failed = 0
        now = self.clock()
        for i, s in enumerate(self._slots_state):
            if s is None:
                continue
            if s.stream._fail(e):
                self.metrics.record_failure(e)
                self._trace_terminal(s.stream, "error", now)
                failed += 1
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
        err = f"{type(e).__name__}: {e}"[:300]
        # event is gen_decode_error or gen_prefill_error
        get_logger("serve").event(event, model=self.name,
                                  step=self._n_steps, error=err,
                                  failed_streams=failed)
        flight_dump(event, extra={"model": self.name,
                                  "step": self._n_steps, "error": err,
                                  "failed_streams": failed})

    def _fail_group(self, e: BaseException, event: str) -> None:
        """Rank 0 of a sharded engine after a failed dispatch: fail every
        stream in flight and queued with the error, record it (the event
        and a flight dump), and stop serving; the stop plan carries the
        error to the followers, whose ``stop`` raises it, as this
        engine's does."""
        err = f"{type(e).__name__}: {e}"[:300]
        self._group_error = err
        now = self.clock()
        failed = 0
        for i, s in enumerate(self._slots_state):
            if s is not None and s.stream._fail(e):
                self.metrics.record_failure(e)
                self._trace_terminal(s.stream, "error", now)
                failed += 1
            self._slots_state[i] = None
        self._prefill_q.clear()
        self._closing.set()
        self._batcher.close()
        for r in self._batcher.fail_pending():
            if r.on_done(e, now):
                failed += 1
        get_logger("serve").event(event, model=self.name,
                                  step=self._n_steps, error=err,
                                  failed_streams=failed, group=True)
        flight_dump(event, extra={"model": self.name, "error": err,
                                  "failed_streams": failed})

    def _retire(self, slot: int, s: _Slot, now: float) -> None:
        """Free the slot and its pages if its stream finished or was
        cancelled (at every step boundary, so a cancel frees capacity
        for the next queued prompt at once)."""
        if s.stream.cancelled:
            self._fail_slot(slot, s, GenerationCancelled(
                f"stream cancelled after {s.generated} token(s); "
                f"KV slot {slot} and {len(s.pages)} page(s) freed"),
                "cancelled")
            return
        done = s.generated >= s.stream.max_new or (
            self.eos_id is not None and s.last_token == self.eos_id)
        if done:
            if s.stream._finish():
                self.metrics.record_request(now - s.stream.t_submit,
                                            deadlined=s.stream.deadlined)
                self._trace_terminal(s.stream, "completed", now)
            self._release_slot(slot, s)

    def _abort_active(self) -> None:
        """drain(timeout) expired: shed whatever is still decoding or
        prefilling (pages go back with the slots)."""
        for i, s in enumerate(self._slots_state):
            if s is not None:
                self._fail_slot(i, s, SheddedError(
                    "engine drained mid-generation (drain timeout)"),
                    "shed")
        self._prefill_q.clear()
        now = self.clock()
        while self._adopt_q:
            try:
                payload = self._adopt_q.popleft()
            except IndexError:
                break
            exc = SheddedError(
                "engine drained before adopting a migrated stream")
            if payload["stream"]._fail(exc):
                self.metrics.record_failure(exc)
                self._trace_terminal(payload["stream"], "shed", now)

    # ---- fault injection (FF_FAULT generation kinds) -------------------
    def _fire_slow_decode(self) -> None:
        for st in self._gen_faults:
            if st["kind"] == "serve_slow_decode" and st["fired"] < st["n"]:
                st["fired"] += 1
                self._sleep(st["ms"] / 1e3)

    def _fire_spec_draft_fail(self) -> None:
        """``spec_draft_fail:N``: the Nth draft round raises (once), so
        the engine demotes to plain decode and no stream fails."""
        for st in self._gen_faults:
            if st["kind"] == "spec_draft_fail" and not st["fired"] \
                    and self._spec_rounds + 1 >= st["n"]:
                st["fired"] = 1
                raise RuntimeError(
                    f"FF_FAULT spec_draft_fail: injected draft "
                    f"failure at round {self._spec_rounds + 1}")

    def _fire_cancel_at_token(self, now: float) -> None:
        for st in self._gen_faults:
            if st["kind"] != "serve_cancel_at_token" or st["fired"]:
                continue
            for i, s in enumerate(self._slots_state):
                if s is not None and not s.prefilling \
                        and s.generated >= st["n"]:
                    st["fired"] = 1
                    get_logger("serve").event(
                        "gen_fault_cancel", model=self.name, slot=i,
                        generated=s.generated, at_token=st["n"])
                    s.stream.cancel()
                    self._retire(i, s, now)
                    break


def _load_gen_faults() -> List[Dict]:
    """The FF_FAULT generation specs as per-engine firing state (read
    once a start)."""
    return [{"kind": spec.kind, "n": int(spec.arg),
             "ms": float(spec.extras.get("ms", "50")), "fired": 0}
            for spec in faults.generation_faults()]


__all__ = ["GenerationEngine", "GenerationStream", "GenerationMetrics"]
