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
  in its own thread (inside the bucket forward);
* span tracing, the flight recorder, the ``FF_FAULT`` serve faults,
  the event stream and fleet-managed dispatch come in a later slice.

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

from ..model import to_host
from .batcher import (ADMISSION_POLICIES, MicroBatcher, Request, bucket_for,
                      derive_buckets, split_sizes)
from .errors import OverloadError, SheddedError
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
                 metrics: ServingMetrics, deadlined: bool = False):
        self.future = future
        self.parts: list = [None] * nparts
        self.missing = nparts
        self.t_submit = t_submit
        self.metrics = metrics
        self.deadlined = deadlined
        self.lock = threading.Lock()

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
                return True
            return False
        if _resolve_future(self.future,
                           np.concatenate(self.parts, axis=0)):
            self.metrics.record_request(now - self.t_submit,
                                        deadlined=self.deadlined)
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
    ``clock`` is injectable for deterministic tests."""

    def __init__(self, model, max_batch: Optional[int] = None,
                 max_wait_ms: Optional[float] = None,
                 buckets: Optional[str] = None,
                 metrics_window_s: float = 30.0,
                 max_queue_rows: Optional[int] = None,
                 admission: Optional[str] = None,
                 starvation_ms: Optional[float] = None,
                 degraded_after_errors: int = 2,
                 degraded_drop_frac: float = 0.5,
                 clock: Callable[[], float] = time.monotonic,
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
        self._batcher = MicroBatcher(
            self.max_batch, self.max_wait_ms, clock=clock,
            max_queue_rows=self.max_queue_rows, admission=self.admission,
            starvation_ms=float(cfg.serve_starvation_ms
                                if starvation_ms is None else starvation_ms))
        self.name = str(name or cfg.serve_model_name)
        self.metrics = ServingMetrics(
            window_s=metrics_window_s, clock=clock,
            queue_depth_fn=lambda: self._batcher.queue_depth,
            model=self.name)
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
        self._lifecycle = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stopped = False
        self._draining = False
        self._shutdown_done = threading.Event()
        # dispatcher-thread-only (single writer)
        self._n_dispatch = 0
        self._consec_errors = 0
        self._degraded_after_errors = int(degraded_after_errors)
        self._degraded_drop_frac = float(degraded_drop_frac)

    # ---- health ----------------------------------------------------------
    @property
    def health(self) -> str:
        """``starting`` (dispatcher not running), ``serving``,
        ``degraded`` (consecutive dispatch errors, or a windowed
        shed+reject rate over threshold), ``draining`` or ``stopped``,
        computed from live state."""
        if self._stopped:
            return "stopped"
        if self._draining:
            return "draining"
        if self._thread is None:
            return "starting"
        if self._consec_errors >= self._degraded_after_errors:
            return "degraded"
        rate, submitted = self.metrics.drop_stats()
        if submitted >= 4 and rate >= self._degraded_drop_frac:
            return "degraded"
        return "serving"

    # ---- lifecycle -------------------------------------------------------
    def start(self) -> "ServingEngine":
        with self._lifecycle:
            if self._stopped:
                raise RuntimeError(
                    "engine was stopped; create a new ServingEngine")
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._dispatch_loop, name="ff-serve-dispatch",
                    daemon=True)
                self._thread.start()
        return self

    def stop(self) -> None:
        """Drain pending requests fully, stop the dispatcher.  Idempotent;
        the engine is single-use.  For a bounded drain see
        :meth:`drain`."""
        to_fail: List[Request] = []
        with self._lifecycle:
            self._stopped = True
            self._batcher.close()
            if self._thread is not None:
                # the dispatcher never takes _lifecycle: joining under it
                # cannot deadlock
                self._thread.join()
                self._thread = None
            else:
                # never started: nothing will drain the queue, so fail
                # what is still queued rather than leave it pending
                while True:
                    reqs = self._batcher.poll()
                    if not reqs:
                        break
                    to_fail.extend(reqs)
        if to_fail:
            now = self.clock()
            err = SheddedError("engine stopped before it was started")
            for r in to_fail:
                r.on_done(err, now)
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
        if thread is not None:
            thread.join(timeout)
            if thread.is_alive():
                now = self.clock()
                for r in self._batcher.fail_pending():
                    r.on_done(SheddedError(
                        f"engine drained with work still queued (drain "
                        f"timeout {timeout}s)"), now)
                # bounded second join: a dispatcher wedged in a device
                # call must not hang shutdown
                thread.join(timeout)
        else:
            now = self.clock()
            for r in self._batcher.fail_pending():
                r.on_done(SheddedError(
                    "engine drained before it was started"), now)
        with self._lifecycle:
            # _stopped before clearing _draining: health never shows a
            # stopped engine as serving
            self._stopped = True
            self._draining = False
            self._thread = None
        self._shutdown_done.set()
        return self.stats()

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
        sizes = split_sizes(n, self.max_batch)
        if len(sizes) == 1:
            deadlined = deadline is not None

            def on_done(out, now: float) -> bool:
                if not _resolve_future(fut, out):
                    return False
                if isinstance(out, BaseException):
                    metrics.record_failure(out)
                else:
                    metrics.record_request(now - t0, deadlined=deadlined)
                return True

            reqs = [Request(arrs, n, on_done, t0, deadline=deadline,
                            priority=priority)]
        else:
            join = _Join(fut, len(sizes), t0, metrics,
                         deadlined=deadline is not None)
            reqs = []
            off = 0
            for i, sz in enumerate(sizes):
                chunk = tuple(a[off:off + sz] for a in arrs)
                # once any sibling resolves the join, the rest are stale
                reqs.append(Request(chunk, sz, join.part(i), t0,
                                    deadline=deadline, priority=priority,
                                    stale=fut.done))
                off += sz
        try:
            blocked_s = self._batcher.submit_all(reqs)
        except OverloadError:
            metrics.record_rejected()
            raise
        except RuntimeError as e:
            # the batcher is closed exactly when the engine drains or
            # stopped: surface the typed admission error, and count it
            metrics.record_rejected()
            raise OverloadError(
                f"engine is not admitting new work ({e})") from e
        if blocked_s > 0:
            metrics.record_blocked(blocked_s)

        def count_cancel(f):
            # a client cancel() while queued resolves through no engine
            # path: count the outcome here (fires at most once)
            if f.cancelled():
                metrics.record_cancelled()

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
            self._dispatch_batch(reqs)
        except Exception as e:  # noqa: BLE001 — a poisoned batch fails
            # its own futures; the dispatcher keeps serving
            self._consec_errors += 1
            now = self.clock()
            for r in reqs:
                r.on_done(e, now)

    def _dispatch_batch(self, reqs) -> None:
        model = self.model
        rows = sum(r.n for r in reqs)
        bucket = bucket_for(rows, self.buckets)
        depth = self._batcher.queue_depth
        t0 = self.clock()
        packed = []
        for j in range(self._n_inputs):
            packed.append(reqs[0].xs[j] if len(reqs) == 1 else
                          np.concatenate([r.xs[j] for r in reqs], axis=0))
        if rows < bucket:
            packed = list(model._pad_tail(packed, bucket))
        self._n_dispatch += 1
        # looked up through the model's cache: a re-compile() clears it
        fwd = model.forward_compiled(bucket)
        out = fwd(model._params, model._to_device(packed))
        # the ONE host fetch for the whole packed batch
        host = to_host(out)
        now = self.clock()
        self._consec_errors = 0
        self.metrics.record_dispatch(rows, bucket, len(reqs), depth,
                                     now - t0)
        off = 0
        for r in reqs:
            # a copy, so a client holding one request's rows does not
            # keep the whole packed buffer alive
            r.on_done(host[off:off + r.n].copy(), now)
            off += r.n
