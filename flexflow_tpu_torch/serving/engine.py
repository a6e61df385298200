"""ServingEngine — shape-bucketed forwards plus dynamic micro-batching over
a compiled FFModel, the port of ``flexflow_tpu/serving/engine.py``.

Any number of producer threads call :meth:`ServingEngine.submit`
(returns a ``concurrent.futures.Future``); ONE dispatcher thread owns
all device work: it pulls coalesced batches from the
:class:`~.batcher.MicroBatcher`, packs them into the smallest covering
bucket, runs the model's bucket forward (``FFModel.forward_compiled``)
with the model's parameters, fetches the packed output to the host once,
and scatters per-request row slices to the futures.  Oversize requests
are split at submit and reassembled (:class:`_Join`).

Overload handling is the JAX engine's: a bounded queue with
block/reject/shed_oldest admission, per-request deadlines (expired
before packing) and priority classes, the health states
``starting -> serving -> degraded -> draining -> stopped`` and a
bounded :meth:`ServingEngine.drain`.

Differences from the JAX engine:

* results are numpy rows in float32 when the compute dtype is bfloat16
  (an exact upcast; numpy has no bfloat16), where the JAX engine returns
  ml_dtypes bfloat16 rows;
* ``torch.inference_mode`` is thread-local, so the dispatcher enters it
  in its own thread (inside the bucket forward).

Observability is the JAX engine's: ``serve_stats`` (every
``stats_every`` dispatches and once at shutdown), ``serve_health`` on
health edges, ``serve_drain`` and ``serve_dispatch_error`` events
through :mod:`~flexflow_tpu_torch.fflogger`, request spans when the
tracer samples (``FFConfig.trace_sample_rate``), flight-recorder dumps
on a dispatch error or a health edge into ``degraded``, and the
``serve_slow_dispatch`` / ``serve_fail_dispatch`` / ``serve_queue_spike``
``FF_FAULT`` kinds (``clock`` and ``sleep`` are injectable).  A
:class:`~..fleet.FleetEngine` drives the engine through
:meth:`ServingEngine.begin_external_dispatch` and
:meth:`ServingEngine.dispatch_pending` instead of its own thread.

``serve_quantize="int8"`` quantizes the model's eligible weights
(``FFModel.quantize_weights``) before the buckets warm, and refuses to
serve when the report's quality bound is violated.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, InvalidStateError
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import faults
from ..fflogger import get_logger
from ..model import to_host
from ..obs import lockwatch
from ..obs.flight import flight_dump, get_flight
from ..obs.trace import phase_of, tracer_from_config
from .batcher import (ADMISSION_POLICIES, MicroBatcher, Request, bucket_for,
                      derive_buckets, split_sizes)
from .errors import OverloadError, ServingError, SheddedError
from .metrics import ServingMetrics

HEALTH_STATES = ("starting", "serving", "degraded", "draining", "stopped")


def _resolve_future(fut: Future, out) -> bool:
    """Complete ``fut`` with a result or exception unless the client
    cancelled it or it is already done (which must never raise on the
    dispatcher thread).  Returns True when ``fut`` was completed here."""
    try:
        if not fut.set_running_or_notify_cancel():
            return False
    except (RuntimeError, InvalidStateError):
        return False
    if isinstance(out, BaseException):
        fut.set_exception(out)
    else:
        fut.set_result(out)
    return True


class _Join:
    """Reassembles an oversize request split into chunks at submit: the
    logical future resolves once, with the concatenated rows, when the
    last chunk arrives.  The first failing chunk resolves it with the
    error; the queued siblings then turn stale and the batcher drops
    them before packing."""

    def __init__(self, future: Future, nparts: int, t_submit: float,
                 metrics: ServingMetrics, deadlined: bool = False,
                 trace_done: Optional[Callable] = None):
        self.future = future
        self.parts: list = [None] * nparts
        self.missing = nparts
        self.t_submit = t_submit
        self.metrics = metrics
        self.deadlined = deadlined
        # trace_done(phase, now): the logical request's one terminal
        # span (None when the request was not sampled)
        self.trace_done = trace_done
        self.lock = lockwatch.lock("_Join.lock")

    def part(self, i: int) -> Callable:
        def on_done(out, now: float) -> bool:
            return self._complete(i, out, now)
        return on_done

    def _complete(self, i: int, out, now: float) -> bool:
        """Returns True iff THIS call completed the logical future."""
        with self.lock:
            if self.future.done():
                return False
            if not isinstance(out, BaseException):
                self.parts[i] = out
                self.missing -= 1
                if self.missing:
                    return False
        # resolve outside the lock: done-callbacks run synchronously
        if isinstance(out, BaseException):
            if _resolve_future(self.future, out):
                self.metrics.record_failure(out)
                if self.trace_done is not None:
                    self.trace_done(phase_of(out), now)
                return True
            return False
        if _resolve_future(self.future,
                           np.concatenate(self.parts, axis=0)):
            self.metrics.record_request(now - self.t_submit,
                                        deadlined=self.deadlined)
            if self.trace_done is not None:
                self.trace_done("completed", now)
            return True
        return False


class ServingEngine:
    """Inference engine over a compiled and initialized FFModel.

    ::

        engine = ServingEngine(model)          # warms every bucket
        with engine:                           # starts the dispatcher
            fut = engine.submit(x_rows)        # (n, ...) rows, n >= 1
            y = fut.result()                   # (n, num_classes)

    Knobs resolve from ``model.config`` (``serve_max_batch``,
    ``serve_max_wait_ms``, ``serve_buckets``, ``serve_max_queue_rows``,
    ``serve_admission``, ``serve_starvation_ms``) unless given here;
    ``clock`` and ``sleep`` are injectable for deterministic tests
    (``sleep`` is used only by the ``serve_slow_dispatch`` fault)."""

    def __init__(self, model, max_batch: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 buckets: Optional[str] = None, stats_every: int = 64,
                 metrics_window_s: float = 30.0,
                 max_queue_rows: Optional[int] = None,
                 admission: Optional[str] = None,
                 starvation_ms: Optional[float] = None,
                 degraded_after_errors: int = 2,
                 degraded_drop_frac: float = 0.5,
                 clock: Callable[[], float] = time.monotonic,
                 sleep: Callable[[float], None] = time.sleep,
                 name: str = ""):
        if not model._compiled or not model._params:
            raise RuntimeError(
                "compile() + init_layers() the model first")
        cfg = model.config
        self.model = model
        self.max_batch = int(max_batch or cfg.serve_max_batch
                             or cfg.batch_size)
        self.max_wait_ms = float(
            cfg.serve_max_wait_ms if max_wait_ms is None else max_wait_ms)
        self.buckets: Tuple[int, ...] = derive_buckets(
            self.max_batch, cfg.serve_buckets if buckets is None else buckets)
        self.max_queue_rows = int(
            cfg.serve_max_queue_rows if max_queue_rows is None
            else max_queue_rows)
        self.admission = (cfg.serve_admission if admission is None
                          else admission)
        if self.admission not in ADMISSION_POLICIES:
            raise ValueError(
                f"unknown serve_admission {self.admission!r} (want one "
                f"of {', '.join(ADMISSION_POLICIES)})")
        self.clock = clock
        self._sleep = sleep
        self.stats_every = int(stats_every)
        self._batcher = MicroBatcher(
            self.max_batch, self.max_wait_ms, clock=clock,
            max_queue_rows=self.max_queue_rows, admission=self.admission,
            starvation_ms=float(cfg.serve_starvation_ms
                                if starvation_ms is None else starvation_ms))
        # tenant identity, stamped on serve_* events so co-resident
        # engines emit distinguishable streams
        self.name = str(name or cfg.serve_model_name)
        self.metrics = ServingMetrics(
            window_s=metrics_window_s, clock=clock,
            queue_depth_fn=lambda: self._batcher.queue_depth,
            model=self.name)
        # the tracer's `active` bool is the one lock-free check the
        # dispatch path reads when tracing is off; get_flight() installs
        # the flight recorder's taps for this engine's lifetime
        self._tracer = tracer_from_config(cfg)
        get_flight()
        self._n_inputs = len(model.input_tensors)
        self._in_dtypes = [t.dtype for t in model.input_tensors]
        self._in_shapes = [tuple(t.shape[1:]) for t in model.input_tensors]
        # int8 weight-only quantization (serve_quantize): applied before
        # any bucket warms, with the quality bound checked first; a
        # violating table means the quantizer is broken, and refusing to
        # start beats serving wrong numbers
        self.quantize = str(cfg.serve_quantize or "")
        if self.quantize:
            qrep = model.quantize_weights(self.quantize)
            if not qrep["bound_ok"]:
                raise RuntimeError(
                    f"int8 quantization quality bound violated at "
                    f"warmup: max_abs_err {qrep['max_abs_err']:.3e} > "
                    f"bound {qrep['error_bound']:.3e} "
                    f"({len(qrep['weights'])} weight(s)); refusing to "
                    f"serve")
        # warm every bucket once at startup (kernel build and load,
        # cuDNN algorithm choice), so no request pays it
        for b in self.buckets:
            zeros = tuple(np.zeros((b,) + s, d)
                          for s, d in zip(self._in_shapes, self._in_dtypes))
            model.forward_compiled(b)(model._params,
                                      model._to_device(zeros))
        if model.device.type == "cuda":
            torch.cuda.synchronize(model.device)
        # lifecycle fields are written under self._lifecycle; the health
        # property reads them without it
        self._lifecycle = lockwatch.lock("ServingEngine._lifecycle")
        self._thread: Optional[  # guarded_by: self._lifecycle
            threading.Thread] = None
        # fleet mode: a FleetEngine drives dispatch_pending() instead of
        # an owned thread
        self._external = False   # guarded_by: self._lifecycle
        self._stopped = False    # guarded_by: self._lifecycle
        self._draining = False   # guarded_by: self._lifecycle
        # the final serve_stats, emitted once
        self._finalized = False  # guarded_by: self._lifecycle
        self._shutdown_done = threading.Event()
        self._health_lock = lockwatch.lock("ServingEngine._health_lock")
        self._last_health = "starting"  # guarded_by: self._health_lock
        self._serve_faults: List[Dict] = []
        # dispatcher-thread-only (single writer)
        self._n_dispatch = 0
        self._consec_errors = 0
        self._degraded_after_errors = int(degraded_after_errors)
        self._degraded_drop_frac = float(degraded_drop_frac)

    # ---- health ----------------------------------------------------------
    @property
    def health(self) -> str:
        """``starting`` (no dispatcher yet), ``serving``, ``degraded``
        (consecutive dispatch errors, or a windowed shed+reject rate
        over threshold), ``draining`` or ``stopped``, computed from live
        state."""
        if self._stopped:      # unguarded-ok: lock-free health read
            return "stopped"
        if self._draining:     # unguarded-ok: lock-free health read
            return "draining"
        if (self._thread is None  # unguarded-ok: lock-free health read
                and not self._external):  # unguarded-ok: lock-free read
            return "starting"
        if self._consec_errors >= self._degraded_after_errors:
            return "degraded"
        rate, submitted = self.metrics.drop_stats()
        if submitted >= 4 and rate >= self._degraded_drop_frac:
            return "degraded"
        return "serving"

    def _health_tick(self) -> None:
        """Emit one ``serve_health`` event on a state edge.  The
        compare-and-set is locked: ticks fire from producer threads
        (reject paths) and the dispatcher."""
        with self._health_lock:
            state = self.health
            prev = self._last_health
            if state == prev:
                return
            self._last_health = state
            rate, submitted = self.metrics.drop_stats()
            get_logger("serve").event(
                "serve_health", model=self.name, prev=prev, state=state,
                consec_errors=self._consec_errors,
                drop_rate=round(rate, 4), window_submitted=submitted,
                queue_depth=self._batcher.queue_depth)
        if state == "degraded":
            # a flight-recorder trigger; outside the lock, dump I/O must
            # never serialize health ticks
            flight_dump("health_degraded",
                        extra={"model": self.name, "prev": prev,
                               "drop_rate": round(rate, 4)})

    # ---- lifecycle -------------------------------------------------------
    def start(self) -> "ServingEngine":
        with self._lifecycle:
            if self._stopped:
                raise RuntimeError(
                    "engine was stopped; create a new ServingEngine")
            if self._external:
                raise RuntimeError(
                    "engine is fleet-managed (begin_external_dispatch)")
            if self._thread is None:
                self._serve_faults = _load_serve_faults()
                self._thread = threading.Thread(
                    target=self._dispatch_loop, name="ff-serve-dispatch",
                    daemon=True)
                self._thread.start()
        self._health_tick()
        return self

    def stop(self) -> None:
        """Drain pending requests fully, stop the dispatcher, emit the
        final stats.  Idempotent; the engine is single-use.  For a
        bounded drain see :meth:`drain`."""
        to_fail: List[Request] = []
        err = now = None
        with self._lifecycle:
            self._stopped = True
            self._batcher.close()
            if self._thread is not None:
                # lock-ok: the dispatcher never takes _lifecycle, so
                # joining it under the lock cannot deadlock
                self._thread.join()
                self._thread = None
                if not self._finalized:
                    self._finalized = True
                    self.metrics.emit(extra={"final": True,
                                             "max_batch": self.max_batch,
                                             "health": "stopped"})
            else:
                # no dispatcher thread (never started, or fleet-managed):
                # nothing will drain the queue, so fail what is queued
                now = self.clock()
                err = SheddedError(
                    "engine stopped with work still queued (fleet "
                    "unload)" if self._external
                    else "engine stopped before it was started")
                while True:
                    reqs = self._batcher.poll()
                    if not reqs:
                        break
                    to_fail.extend(reqs)
        # resolve outside _lifecycle: done-callbacks take other locks
        for r in to_fail:
            r.on_done(err, now)
        self._health_tick()
        # a stopped engine must not be retained by the process registry
        self.metrics.release()
        self._shutdown_done.set()

    def drain(self, timeout: Optional[float] = None) -> Dict:
        """Stop admitting, flush what is queued, and after ``timeout``
        seconds fail the stragglers with :class:`SheddedError` (None =
        wait, like stop()).  Returns the final stats snapshot."""
        with self._lifecycle:
            already = self._stopped or self._draining
            thread = self._thread
            if not already:
                self._draining = True
                self._batcher.close()
        if already:
            self._shutdown_done.wait()
            return self.stats()
        self._health_tick()
        get_logger("serve").event(
            "serve_drain", model=self.name, timeout_s=timeout,
            queue_depth=self._batcher.queue_depth,
            pending_rows=self._batcher.pending_rows)
        shed = 0
        if thread is not None:
            thread.join(timeout)
            if thread.is_alive():
                now = self.clock()
                for r in self._batcher.fail_pending():
                    if r.on_done(SheddedError(
                            f"engine drained with work still queued "
                            f"(drain timeout {timeout}s)"), now):
                        shed += 1
                # bounded second join: a dispatcher wedged in a device
                # call must not hang shutdown
                thread.join(timeout)
                if thread.is_alive():
                    get_logger("serve").event(
                        "serve_drain_abandoned", model=self.name,
                        timeout_s=timeout,
                        note="dispatcher wedged in an in-flight "
                             "dispatch; daemon thread abandoned")
        else:
            now = self.clock()
            for r in self._batcher.fail_pending():
                if r.on_done(SheddedError(
                        "engine drained before it was started"), now):
                    shed += 1
        with self._lifecycle:
            # _stopped before clearing _draining: health never shows a
            # stopped engine as serving
            self._stopped = True
            self._draining = False
            self._thread = None
            first = not self._finalized
            self._finalized = True
        self._health_tick()
        snap = self.stats()
        if first:
            self.metrics.emit(extra={"final": True,
                                     "max_batch": self.max_batch,
                                     "health": "stopped",
                                     "drain_shed": shed})
        self.metrics.release()
        self._shutdown_done.set()
        return snap

    def __enter__(self) -> "ServingEngine":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---- producer side ---------------------------------------------------
    def submit(self, *xs, deadline_ms: Optional[float] = None,
               priority: int = 0) -> Future:
        """Queue one request of ``n`` rows (one positional array per
        model input, leading dim ``n``) and return a Future of the
        ``(n, ...)`` output rows.  Thread-safe.  Requests larger than
        ``max_batch`` are split and reassembled.  ``deadline_ms`` (from
        submit) expires a still-queued request with DeadlineExceeded;
        ``priority`` (higher first) picks the class.  A full bounded
        queue raises OverloadError under ``reject`` and may shed other
        queued futures under ``shed_oldest``."""
        if len(xs) != self._n_inputs:
            raise ValueError(f"model has {self._n_inputs} input(s), got "
                             f"{len(xs)}")
        # the engine owns a copy: the caller may reuse its buffer while
        # the rows wait in the queue
        arrs = []
        for i, (a, d) in enumerate(zip(xs, self._in_dtypes)):
            try:
                arrs.append(np.array(a, dtype=d, copy=True))
            except (ValueError, TypeError) as e:
                raise ValueError(
                    f"input {i}: cannot coerce to a "
                    f"{np.dtype(d).name} array of rows shaped "
                    f"{self._in_shapes[i]}: {e}") from e
        arrs = tuple(arrs)
        if any(a.ndim == 0 for a in arrs):
            raise ValueError("request inputs must have a leading row "
                             "dimension (shape (n, ...))")
        n = int(arrs[0].shape[0])
        if n < 1:
            raise ValueError("empty request (0 rows)")
        if any(a.shape[0] != n for a in arrs):
            raise ValueError(f"inputs disagree on row count: "
                             f"{[a.shape[0] for a in arrs]}")
        for i, (a, want) in enumerate(zip(arrs, self._in_shapes)):
            # a bad trailing shape would fail the whole packed batch
            if tuple(a.shape[1:]) != want:
                raise ValueError(
                    f"input {i}: request rows shaped {tuple(a.shape[1:])} "
                    f"do not match the model input {want}")
        fut: Future = Future()
        t0 = self.clock()
        deadline = None if deadline_ms is None else t0 + deadline_ms / 1e3
        self.metrics.record_submitted()
        metrics = self.metrics
        # one trace id per sampled logical request; trace_done records
        # its one terminal `request` span
        tr = self._tracer
        trace = tr.new_trace() if tr.active else None
        trace_done = None
        if trace is not None:
            tname = self.name or "serve"

            def trace_done(phase: str, now: float,
                           _t=trace, _n=n) -> None:
                tr.span("request", _t, t0, now, tid=tname,
                        phase=phase, rows=_n, model=self.name)
        sizes = split_sizes(n, self.max_batch)
        if len(sizes) == 1:
            deadlined = deadline is not None
            done_trace = trace_done

            def on_done(out, now: float) -> bool:
                if not _resolve_future(fut, out):
                    return False
                if isinstance(out, BaseException):
                    metrics.record_failure(out)
                    if done_trace is not None:
                        done_trace(phase_of(out), now)
                else:
                    metrics.record_request(now - t0, deadlined=deadlined)
                    if done_trace is not None:
                        done_trace("completed", now)
                return True

            reqs = [Request(arrs, n, on_done, t0, deadline=deadline,
                            priority=priority, trace=trace)]
        else:
            join = _Join(fut, len(sizes), t0, metrics,
                         deadlined=deadline is not None,
                         trace_done=trace_done)
            reqs = []
            off = 0
            for i, sz in enumerate(sizes):
                chunk = tuple(a[off:off + sz] for a in arrs)
                # once any sibling resolves the join, the rest are stale
                reqs.append(Request(chunk, sz, join.part(i), t0,
                                    deadline=deadline, priority=priority,
                                    stale=fut.done, trace=trace))
                off += sz
        try:
            blocked_s = self._batcher.submit_all(reqs)
        except OverloadError:
            metrics.record_rejected()
            if trace_done is not None:
                trace_done("rejected", self.clock())
            self._health_tick()
            raise
        except RuntimeError as e:
            # the batcher is closed exactly when the engine drains or
            # stopped: surface the typed admission error, and count it
            metrics.record_rejected()
            if trace_done is not None:
                trace_done("rejected", self.clock())
            raise OverloadError(
                f"engine is not admitting new work ({e})") from e
        if blocked_s > 0:
            metrics.record_blocked(blocked_s)
            if trace is not None:
                tr.span("admission_wait", trace, t0, t0 + blocked_s,
                        tid=self.name or "serve")

        def count_cancel(f, _done=trace_done):
            # a client cancel() while queued resolves through no engine
            # path: count the outcome here (fires at most once)
            if f.cancelled():
                metrics.record_cancelled()
                if _done is not None:
                    _done("cancelled", self.clock())

        fut.add_done_callback(count_cancel)
        return fut

    def stats(self) -> Dict:
        """Metrics snapshot plus engine shape and health."""
        return {**self.metrics.snapshot(), "max_batch": self.max_batch,
                "max_wait_ms": self.max_wait_ms,
                "buckets": list(self.buckets),
                "health": self.health,
                "admission": self.admission,
                "max_queue_rows": self.max_queue_rows,
                "peak_queue_rows": self._batcher.peak_rows,
                "quantize": self.quantize}

    # ---- fault injection (FF_FAULT serve_* kinds) ------------------------
    def _fire_serve_faults(self) -> None:
        """Consult the FF_FAULT serve kinds before dispatch
        ``self._n_dispatch``: sleep (``serve_slow_dispatch``, through the
        injectable ``sleep``), raise (``serve_fail_dispatch``: the batch's
        futures fail and serving goes on) or push a synthetic queue spike
        through the real admission path (``serve_queue_spike``)."""
        if not self._serve_faults:
            return
        idx = self._n_dispatch
        for st in self._serve_faults:
            kind, n = st["kind"], st["n"]
            if kind == "serve_slow_dispatch":
                if st["fired"] < n:
                    st["fired"] += 1
                    self._sleep(st["ms"] / 1e3)
            elif kind == "serve_queue_spike":
                if idx == n and not st["fired"]:
                    st["fired"] += 1
                    self._inject_spike(st["rows"] or 4 * self.max_batch)
            elif kind == "serve_fail_dispatch":
                st["seen"] += 1
                if st["fired"] < n and st["seen"] % st["every"] == 0:
                    st["fired"] += 1
                    raise RuntimeError(
                        f"FF_FAULT: injected serve dispatch failure "
                        f"{st['fired']}/{n} (dispatch {idx})")

    def _inject_spike(self, rows: int) -> None:
        """Queue-spike fault: ``rows`` rows of zeros through the real
        admission path, with ``block`` downgraded to ``reject`` (the
        dispatcher must never wait for room only it can free)."""
        zeros = tuple(np.zeros((min(rows, self.max_batch),) + s, d)
                      for s, d in zip(self._in_shapes, self._in_dtypes))
        metrics = self.metrics
        policy = "reject" if self.admission == "block" else self.admission

        def on_done(out, now: float) -> bool:
            if isinstance(out, BaseException):
                metrics.record_failure(out)
            return True

        left = rows
        while left > 0:
            sz = min(left, self.max_batch)
            xs = tuple(z[:sz] for z in zeros)
            metrics.record_submitted()
            try:
                self._batcher.submit_all(
                    [Request(xs, sz, on_done, self.clock(),
                             priority=-(1 << 30))],
                    admission=policy)
            except ServingError:
                metrics.record_rejected()
            except RuntimeError:
                return  # batcher closed mid-spike: the drain wins
            left -= sz

    # ---- fleet-managed (external) dispatch -------------------------------
    def begin_external_dispatch(self) -> "ServingEngine":
        """Fleet mode: mark the engine live without its own dispatcher
        thread; a :class:`~..fleet.FleetEngine` drives
        :meth:`dispatch_pending` from one shared dispatcher, interleaving
        this engine's batches with its co-resident tenants'.  The
        producer side behaves exactly as under :meth:`start`."""
        with self._lifecycle:
            if self._stopped:
                raise RuntimeError(
                    "engine was stopped; create a new ServingEngine")
            if self._thread is not None:
                raise RuntimeError(
                    "engine already runs its own dispatcher thread")
            self._serve_faults = _load_serve_faults()
            self._external = True
        self._health_tick()
        return self

    @property
    def has_pending(self) -> bool:
        """Whether queued work waits for an external dispatcher."""
        return self._batcher.queue_depth > 0

    def dispatch_pending(self) -> Optional[float]:
        """One externally driven dispatch (fleet mode): pop one due
        coalesced batch without blocking and dispatch it.  Returns the
        seconds the fleet's fair scheduler charges this tenant, or None
        when nothing was due.  The charge ends after the batch's rows
        reached the host (the dispatch's one fetch waits for the
        device), not when its launches were queued.  A poisoned batch
        fails only its own futures, and its time is still charged."""
        reqs = self._batcher.poll()
        if not reqs:
            return None
        t0 = self.clock()
        self._dispatch_guarded(reqs)
        return max(0.0, self.clock() - t0)

    # ---- dispatcher thread -----------------------------------------------
    def _dispatch_loop(self) -> None:
        device = self.model.device
        if device.type == "cuda" and device.index is not None:
            torch.cuda.set_device(device)
        while True:
            reqs = self._batcher.next_batch()
            if reqs is None:
                return  # closed and drained
            self._dispatch_guarded(reqs)

    def _dispatch_guarded(self, reqs) -> None:
        try:
            self._fire_serve_faults()
            self._dispatch_batch(reqs)
        except Exception as e:  # noqa: BLE001 — a poisoned batch fails
            # its own futures; the dispatcher keeps serving
            self._consec_errors += 1
            now = self.clock()
            failed = sum(1 for r in reqs if r.on_done(e, now))
            err = f"{type(e).__name__}: {e}"[:300]
            get_logger("serve").event(
                "serve_dispatch_error", model=self.name,
                dispatch=self._n_dispatch, error=err,
                failed_requests=failed,
                errors_total=self.metrics.total_errors)
            flight_dump("serve_dispatch_error",
                        extra={"model": self.name,
                               "dispatch": self._n_dispatch,
                               "error": err, "failed_requests": failed})
            self._health_tick()

    def _dispatch_batch(self, reqs) -> None:
        model = self.model
        rows = sum(r.n for r in reqs)
        bucket = bucket_for(rows, self.buckets)
        depth = self._batcher.queue_depth
        # the one tracing check of the dispatch path
        tr = self._tracer
        traced = tr.active
        t0 = self.clock()
        packed = []
        for j in range(self._n_inputs):
            packed.append(reqs[0].xs[j] if len(reqs) == 1 else
                          np.concatenate([r.xs[j] for r in reqs], axis=0))
        if rows < bucket:
            packed = list(model._pad_tail(packed, bucket))
        idx = self._n_dispatch
        self._n_dispatch = idx + 1
        # looked up through the model's cache: a re-compile() clears it
        fwd = model.forward_compiled(bucket)
        t_pack = self.clock() if traced else 0.0
        out = fwd(model._params, model._to_device(packed))
        t_exec = self.clock() if traced else 0.0
        # the ONE host fetch for the whole packed batch
        host = to_host(out)
        now = self.clock()
        # the dispatch succeeded: reset the error streak and emit the
        # recovery edge before any future resolves
        self._consec_errors = 0
        self._health_tick()
        self.metrics.record_dispatch(rows, bucket, len(reqs), depth,
                                     now - t0)
        off = 0
        for r in reqs:
            # a copy, so a client holding one request's rows does not
            # keep the whole packed buffer alive
            r.on_done(host[off:off + r.n].copy(), now)
            off += r.n
        if traced:
            t_scatter = self.clock()
            tname = self.name or "serve"
            for r in reqs:
                if r.trace is not None:
                    tr.span("queue", r.trace, r.t_submit, t0, tid=tname,
                            dispatch=idx)
            traces = [r.trace for r in reqs if r.trace is not None]
            tr.span("pack", None, t0, t_pack, tid=tname, dispatch=idx,
                    rows=rows, bucket=bucket, requests=len(reqs))
            tr.span("dispatch", None, t_pack, t_exec, tid=tname,
                    dispatch=idx, bucket=bucket, traces=traces)
            tr.span("fetch", None, t_exec, now, tid=tname, dispatch=idx)
            tr.span("scatter", None, now, t_scatter, tid=tname,
                    dispatch=idx)
        if self.stats_every and self._n_dispatch % self.stats_every == 0:
            self.metrics.emit(extra={"max_batch": self.max_batch,
                                     "health": self.health})


def _load_serve_faults() -> List[Dict]:
    """The FF_FAULT serve_* specs as per-engine firing state (read once
    a start)."""
    out: List[Dict] = []
    for spec in faults.serve_faults():
        out.append({
            "kind": spec.kind,
            "n": int(spec.arg),
            "ms": float(spec.extras.get("ms", "50")),
            "every": max(1, int(spec.extras.get("every", "1"))),
            "rows": int(spec.extras.get("rows", "0")),
            "seen": 0,
            "fired": 0,
        })
    return out
