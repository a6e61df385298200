"""Serving statistics, the port of ``flexflow_tpu/serving/metrics.py``:
lifetime counters, rolling QPS, batch occupancy, queue depth and
nearest-rank latency percentiles (``profiling.quantiles``), emitted as
``serve_stats`` events through :mod:`~flexflow_tpu_torch.fflogger`.

The lifetime counters live in the process metrics registry
(:mod:`~flexflow_tpu_torch.obs.registry`) under the labels ``model`` and
``eng``; :meth:`ServingMetrics.snapshot` and the ``serve_stats`` events
read them back, so the events and the registry's exposition are one set
of numbers.  Every outcome of a submitted request lands in exactly one
counter, so ``submitted == requests + rejected + shed + expired + errors
+ cancelled`` holds whenever no request is in flight.  All windowed
state is bounded.
"""

from __future__ import annotations

import time
import weakref
from collections import deque
from typing import Callable, Dict, Optional, Sequence, Tuple

from ..fflogger import get_logger
from ..obs import lockwatch
from ..obs.registry import get_registry
from ..obs.trace import phase_of
from ..profiling import quantiles


# per-process engine-generation sequence: the ``eng`` label that keeps
# two engines serving the SAME model name (bench legs, a fleet swap's
# old/new generation) from merging their registry counters
_ENG_SEQ = [0]
_ENG_LOCK = lockwatch.lock("metrics._ENG_LOCK")


def next_engine_id() -> str:
    """Draw the next per-process ``eng`` label value (also used by the
    FleetEngine and the FleetRouter for their own families: one
    sequence, so every engine-shaped thing gets a unique id)."""
    with _ENG_LOCK:
        _ENG_SEQ[0] += 1
        return str(_ENG_SEQ[0])


def _lifetime_counters(model_tag: str):
    """Declare (idempotently) the serving counter families and return
    this engine's children.  These ARE the lifetime counters: the
    ``serve_stats`` event stream and ``stats()`` snapshots read them
    back, so the JSON events and the registry's exposition are views
    over one set of numbers."""
    reg = get_registry()
    labels = ("model", "eng")
    eng = next_engine_id()
    kv = {"model": model_tag, "eng": eng}
    fams = {
        "submitted": reg.counter(
            "ff_serve_submitted_total",
            "Logical requests entering submit(), admitted or not",
            labels),
        "requests": reg.counter(
            "ff_serve_requests_total",
            "Logical requests completed successfully", labels),
        "rows": reg.counter(
            "ff_serve_rows_total", "Rows dispatched to the device",
            labels),
        "dispatches": reg.counter(
            "ff_serve_dispatches_total", "Packed device dispatches",
            labels),
        "errors": reg.counter(
            "ff_serve_errors_total",
            "Logical requests failed by dispatch errors", labels),
        "rejected": reg.counter(
            "ff_serve_rejected_total",
            "Requests refused at admission (OverloadError)", labels),
        "shed": reg.counter(
            "ff_serve_shed_total",
            "Queued requests evicted under overload (SheddedError)",
            labels),
        "expired": reg.counter(
            "ff_serve_expired_total",
            "Queued requests past their deadline (DeadlineExceeded)",
            labels),
        "cancelled": reg.counter(
            "ff_serve_cancelled_total",
            "Streams cancelled by the client (GenerationCancelled)",
            labels),
        "blocked_s": reg.counter(
            "ff_serve_admission_blocked_seconds_total",
            "Producer seconds spent blocked for admission", labels),
    }
    fams["latency"] = reg.histogram(
        "ff_serve_latency_seconds",
        "Logical request latency, submit to resolution", labels)
    fams["queue_depth"] = reg.gauge(
        "ff_serve_queue_depth",
        "Live pending requests in the micro-batcher", labels)
    children = {k: fam.labels(**kv) for k, fam in fams.items()}
    return children, fams, kv, eng


class ServingMetrics:
    """Thread-safe rolling serving statistics.

    Dispatch-side records (`record_dispatch`) come from the dispatcher
    thread, one per packed batch; request-side records
    (`record_request`) fire when a logical request's future resolves.
    `snapshot()` reduces the rolling window to the flat dict that both
    the ``serve_stats`` JSON event and ``stats()`` report.

    ``queue_depth_fn`` (settable after construction) makes the reported
    queue depth LIVE: without it, depth freezes at the last dispatch —
    a wedged dispatcher behind a growing queue would look healthy.  The
    engine points it at ``batcher.queue_depth``; ``last_dispatch_age_s``
    is the stall gauge's other half."""

    def __init__(self, window_s: float = 30.0, max_latency_samples: int = 4096,
                 clock: Callable[[], float] = time.monotonic,
                 queue_depth_fn: Optional[Callable[[], int]] = None,
                 model: str = ""):
        self.window_s = float(window_s)
        self.clock = clock
        self.queue_depth_fn = queue_depth_fn
        # tenant identity: every snapshot/serve_stats row carries
        # ``model=<name>`` so two engines in one process (a model
        # fleet) emit distinguishable event streams ("" = untagged)
        self.model_tag = str(model)
        # lifetime counters live in the process metrics registry
        # (obs.registry): snapshot()/serve_stats READ them back — one
        # set of numbers behind both the event stream and /metrics
        self._ctr, self._fams, self._label_kv, self.eng_id = \
            _lifetime_counters(self.model_tag)
        # the live gauge reaches this object through a weak reference:
        # the process registry must never keep an engine alive, not even
        # one whose construction raised before it could be stopped
        ref = weakref.ref(self)

        def live_depth() -> int:
            m = ref()
            fn = m.queue_depth_fn if m is not None else None
            return fn() if fn is not None else 0

        self._ctr["queue_depth"].set_fn(live_depth)
        self._released = False
        self._lock = lockwatch.lock("ServingMetrics._lock")
        # every rolling-window structure below is guarded by
        # self._lock: records arrive from producer threads AND the
        # dispatcher concurrently
        # (t, rows, bucket, n_reqs, dispatch_s) per packed batch
        self._dispatches: deque = deque()  # guarded_by: self._lock
        # (t, latency_s) per completed logical request
        self._latencies: deque = deque(  # guarded_by: self._lock
            maxlen=max_latency_samples)
        # (t, latency_s) for the subset that carried a deadline — the
        # SLO-attainment population deadline_p99_ms reports on
        self._deadline_lats: deque = deque(  # guarded_by: self._lock
            maxlen=max_latency_samples)
        # (t, n) windowed admission/drop event streams for the health
        # state machine's shed-rate threshold, with RUNNING sums so
        # drop_stats() is O(1) on the hot dispatcher path; trimmed on
        # every append (not only on reads) and hard-capped so a wedged
        # dispatcher under a submit storm cannot grow metrics memory
        self._submit_ts: deque = deque()  # guarded_by: self._lock
        self._drop_ts: deque = deque()    # guarded_by: self._lock
        self._submit_n = 0   # guarded_by: self._lock
        self._drop_n = 0     # guarded_by: self._lock
        self._queue_depth = 0  # guarded_by: self._lock
        # the dispatcher's heartbeat: last dispatch completion time,
        # the stall gauge last_dispatch_age_s reads
        self._last_dispatch_t: Optional[float] = None  # guarded_by: self._lock

    # lifetime counters: views over the registry children (each child
    # synchronizes itself) — the serve_stats/stats() population and the
    # Prometheus exposition are the SAME numbers by construction
    @property
    def total_submitted(self) -> int:
        return int(self._ctr["submitted"].value)

    @property
    def total_dispatches(self) -> int:
        return int(self._ctr["dispatches"].value)

    @property
    def total_requests(self) -> int:
        return int(self._ctr["requests"].value)

    @property
    def total_rows(self) -> int:
        return int(self._ctr["rows"].value)

    @property
    def total_errors(self) -> int:
        return int(self._ctr["errors"].value)

    @property
    def total_rejected(self) -> int:
        return int(self._ctr["rejected"].value)

    @property
    def total_shed(self) -> int:
        return int(self._ctr["shed"].value)

    @property
    def total_expired(self) -> int:
        return int(self._ctr["expired"].value)

    @property
    def total_cancelled(self) -> int:
        return int(self._ctr["cancelled"].value)

    @property
    def blocked_ms_total(self) -> float:
        return self._ctr["blocked_s"].value * 1e3

    # hard cap on windowed admission/drop EVENTS (not requests — each
    # entry may carry n>1): bounds memory even when the window itself
    # would hold more
    _MAX_WINDOW_EVENTS = 65536

    # ---- recording -----------------------------------------------------
    def _trim(self, now: float) -> None:  # guarded_by: self._lock
        horizon = now - self.window_s
        for dq in (self._dispatches, self._latencies, self._deadline_lats):
            while dq and dq[0][0] < horizon:
                dq.popleft()
        while self._submit_ts and (self._submit_ts[0][0] < horizon
                                   or len(self._submit_ts)
                                   > self._MAX_WINDOW_EVENTS):
            self._submit_n -= self._submit_ts.popleft()[1]
        while self._drop_ts and (self._drop_ts[0][0] < horizon
                                 or len(self._drop_ts)
                                 > self._MAX_WINDOW_EVENTS):
            self._drop_n -= self._drop_ts.popleft()[1]

    def record_dispatch(self, rows: int, bucket: int, n_reqs: int,
                        queue_depth: int, dispatch_s: float) -> None:
        now = self.clock()
        self._ctr["dispatches"].inc()
        self._ctr["rows"].inc(rows)
        with self._lock:
            self._dispatches.append((now, rows, bucket, n_reqs, dispatch_s))
            self._queue_depth = queue_depth
            self._last_dispatch_t = now
            self._trim(now)

    def record_request(self, latency_s: float,
                       deadlined: bool = False) -> None:
        now = self.clock()
        self._ctr["requests"].inc()
        self._ctr["latency"].observe(latency_s)
        with self._lock:
            self._latencies.append((now, latency_s))
            if deadlined:
                self._deadline_lats.append((now, latency_s))

    def record_submitted(self, n: int = 1) -> None:
        """Offered-load denominator for the windowed drop rate: one per
        LOGICAL request entering submit(), admitted or not."""
        now = self.clock()
        self._ctr["submitted"].inc(n)
        with self._lock:
            self._submit_ts.append((now, int(n)))
            self._submit_n += int(n)
            self._trim(now)

    def record_rejected(self, n: int = 1) -> None:
        """Requests refused at admission (OverloadError from submit —
        they never queued, so no future carries the failure)."""
        now = self.clock()
        self._ctr["rejected"].inc(n)
        with self._lock:
            self._drop_ts.append((now, int(n)))
            self._drop_n += int(n)
            self._trim(now)

    def record_blocked(self, seconds: float) -> None:
        """Producer time spent blocked for admission (`block` policy) —
        invisible in latency percentiles (the request had not been
        submitted yet) but very visible to the caller."""
        self._ctr["blocked_s"].inc(float(seconds))

    def record_cancelled(self, n: int = 1) -> None:
        """A client cancelled a QUEUED request before the engine ever
        claimed it: no future resolution carries an exception, but the
        request WAS submitted — without this the
        ``submitted == requests + ... + cancelled`` reconciliation
        (and its terminal-span mirror) would leak one per cancel."""
        self._ctr["cancelled"].inc(n)

    def record_failure(self, exc: BaseException) -> None:
        """Count the exception that resolved a LOGICAL request's
        future.  The classification IS ``obs.trace.phase_of`` — the
        same chain that names the terminal span's phase — so the
        counters and the trace cannot disagree about an outcome.
        Expiry/shedding are load management (their own counters; sheds
        and rejects feed the windowed drop rate), client cancels are
        not dispatch failures, anything unrecognized is an error.
        Split chunks count their request once — the caller only
        invokes this for the completion that actually resolved the
        future, so the population matches every other per-request
        metric."""
        now = self.clock()
        phase = phase_of(exc)
        if phase in ("shed", "rejected"):
            # `rejected` here is the anomalous resolved-future case
            # (admission rejects raise synchronously and never build a
            # future) — counted as rejected so both surfaces agree
            self._ctr[phase].inc()
            with self._lock:
                self._drop_ts.append((now, 1))
                self._drop_n += 1
                self._trim(now)
        elif phase in ("expired", "cancelled"):
            self._ctr[phase].inc()
        else:
            self._ctr["errors"].inc()

    def release(self) -> None:
        """Retire this metrics object's LIVE hooks from the process
        registry: freeze the queue-depth gauge at its final value and
        drop the provider closure.  Counters stay readable forever
        (scrape continuity across engine generations), but a stopped
        engine — and through ``queue_depth_fn`` its batcher, and
        through the batcher the model — must not be retained by the
        process-global registry for the rest of the process lifetime.
        Called by the engines' stop()/drain() finalization."""
        if self._released:
            return  # idempotent: a second stop() must not re-zero
        self._released = True
        fn = self.queue_depth_fn
        last = 0
        if fn is not None:
            try:
                last = int(fn())
            except Exception:  # noqa: BLE001 — provider already dead
                last = 0
        child = self._ctr["queue_depth"]
        child.set(last)
        child.set_fn(None)
        self.queue_depth_fn = None

    def unregister(self) -> None:
        """Remove this object's label series from the registry entirely
        (implies :meth:`release`).  Direct child references — including
        this object's own properties — keep working, but the series
        stop being rendered/summed: the fleet's bounded-retirement
        scheme folds an old engine generation's final counts into a
        static carry and then reclaims its series, so a week of hot
        swaps cannot grow registry memory without bound."""
        self.release()
        for key, fam in self._fams.items():
            fam.remove(**self._label_kv)

    def drop_stats(self) -> Tuple[float, int]:
        """Windowed (drop_rate, submitted) — drops are shed + rejected;
        the rate is over requests submitted in the window.  The
        engine's `degraded` health threshold reads this per dispatch,
        so it is O(1): running sums, trim only walks expired entries."""
        now = self.clock()
        with self._lock:
            self._trim(now)
            submitted, dropped = self._submit_n, self._drop_n
        return (dropped / submitted if submitted else 0.0), submitted

    # ---- reporting -----------------------------------------------------
    def snapshot(self) -> Dict[str, float]:
        """Flat rolling-window stats: ``qps`` (completed LOGICAL
        requests over the window — same population as the latency
        percentiles, so an oversize request split into chunks counts
        once), ``rows_per_sec`` (dispatched rows over the window),
        ``batch_occupancy`` (mean rows/bucket fill of dispatched
        batches — 1.0 means every dispatch ran a full bucket),
        ``queue_depth`` (LIVE when the engine wired ``queue_depth_fn``,
        else at the last dispatch), ``last_dispatch_age_s`` (stall
        gauge: None until the first dispatch), ``dispatch_ms`` (mean
        device dispatch+fetch wall time), nearest-rank latency
        percentiles in ms, the overload counters
        (``rejected``/``shed``/``expired``/``admission_blocked_ms``)
        and ``deadline_p99_ms`` (latency tail of deadlined requests).
        ``per_bucket`` breaks the dispatch wall times down by shape
        bucket (p50/p95/p99 + counts per bucket): a global mean hides
        which executables are slow, and the per-shape-bucket medians
        are what a cost-model calibration would read."""
        now = self.clock()
        depth_fn = self.queue_depth_fn
        live_depth = depth_fn() if depth_fn is not None else None
        with self._lock:
            self._trim(now)
            disp = list(self._dispatches)
            lat_rows = list(self._latencies)
            lats = [l for _, l in lat_rows]
            dlats = [l for _, l in self._deadline_lats]
            depth = self._queue_depth if live_depth is None else live_depth
            last_t = self._last_dispatch_t
            totals = (self.total_dispatches, self.total_requests,
                      self.total_rows, self.total_errors,
                      self.total_rejected, self.total_shed,
                      self.total_expired, self.blocked_ms_total,
                      self.total_cancelled, self.total_submitted)
        span = self.window_s
        if disp:
            span = min(self.window_s, max(1e-6, now - disp[0][0]))
        req_span = self.window_s
        if lat_rows:
            req_span = min(self.window_s,
                           max(1e-6, now - lat_rows[0][0]))
        rows = sum(d[1] for d in disp)
        occ = (sum(d[1] / d[2] for d in disp) / len(disp)) if disp else 0.0
        q = quantiles(lats)
        qd = quantiles(dlats)

        def ms(v):
            # None, not NaN: json.dumps writes bare `NaN` (invalid
            # JSON) and would break the one-parseable-line contract
            # for any strict consumer when the latency window is empty
            return None if v != v else round(v * 1e3, 3)

        by_bucket: Dict[int, list] = {}
        for d in disp:
            by_bucket.setdefault(d[2], []).append(d)
        per_bucket = {}
        for b in sorted(by_bucket):
            rows_b = by_bucket[b]
            qb = quantiles([d[4] for d in rows_b])
            per_bucket[str(b)] = {
                "dispatches": len(rows_b),
                "rows": sum(d[1] for d in rows_b),
                "dispatch_p50_ms": ms(qb[0.5]),
                "dispatch_p95_ms": ms(qb[0.95]),
                "dispatch_p99_ms": ms(qb[0.99]),
            }

        return {
            "model": self.model_tag,
            "qps": round(len(lats) / req_span, 3),
            "rows_per_sec": round(rows / span, 3),
            "batch_occupancy": round(occ, 4),
            "queue_depth": depth,
            "last_dispatch_age_s": (None if last_t is None
                                    else round(now - last_t, 3)),
            "dispatch_ms": round(
                sum(d[4] for d in disp) / len(disp) * 1e3, 3) if disp
                else 0.0,
            "p50_ms": ms(q[0.5]),
            "p95_ms": ms(q[0.95]),
            "p99_ms": ms(q[0.99]),
            "deadline_p99_ms": ms(qd[0.99]),
            "per_bucket": per_bucket,
            "dispatches": totals[0],
            "requests": totals[1],
            "rows": totals[2],
            "errors": totals[3],
            "rejected": totals[4],
            "shed": totals[5],
            "expired": totals[6],
            "cancelled": totals[8],
            # offered-load lifetime total: submitted == requests +
            # rejected + shed + expired + errors + cancelled, the exact
            # reconciliation the trace's terminal-span counts mirror
            "submitted": totals[9],
            "admission_blocked_ms": round(totals[7], 3),
        }

    def emit(self, extra: Dict | None = None) -> None:
        """One ``serve_stats`` JSON event line on the ``serve`` logger
        (fflogger.Category.event)."""
        # eng rides as an event field (not in snapshot(): stats() is a
        # per-engine view already) so stream consumers — the cluster
        # router's load scrape — can attribute same-named tenants on
        # different hosts to the right engine generation
        get_logger("serve").event("serve_stats", eng=self.eng_id,
                                  **self.snapshot(), **(extra or {}))
