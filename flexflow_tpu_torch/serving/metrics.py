"""Serving statistics: lifetime counters, rolling QPS, batch occupancy,
queue depth and nearest-rank latency percentiles — the counters and
snapshot of ``flexflow_tpu/serving/metrics.py``.  Publishing to a
metrics registry and the ``serve_stats`` event stream come with the
tooling slice.

Every outcome of a submitted request lands in exactly one counter, so
``submitted == requests + rejected + shed + expired + errors +
cancelled`` holds at every snapshot taken when no request is in flight.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, Optional, Sequence, Tuple

from .errors import (DeadlineExceeded, GenerationCancelled, OverloadError,
                     SheddedError)


def quantiles(samples: Sequence[float],
              qs=(0.5, 0.95, 0.99)) -> Dict[float, float]:
    """Nearest-rank quantiles (every reported value is a sample that
    happened); NaN for an empty input."""
    xs = sorted(samples)
    if not xs:
        return {q: float("nan") for q in qs}
    n = len(xs)
    return {q: float(xs[min(n - 1, _nearest_rank(q, n))]) for q in qs}


def _nearest_rank(q: float, n: int) -> int:
    """0-based ceil(q*n) - 1 in integer arithmetic, so float jitter
    (0.95*20 == 18.999...96) cannot shift the rank."""
    num = int(round(q * 10000))
    return max(0, -(-num * n // 10000) - 1)


def phase_of(exc: BaseException) -> str:
    """The counter a request that resolved with ``exc`` lands in."""
    if isinstance(exc, DeadlineExceeded):
        return "expired"
    if isinstance(exc, SheddedError):
        return "shed"
    if isinstance(exc, GenerationCancelled):
        return "cancelled"
    if isinstance(exc, OverloadError):
        return "rejected"
    return "errors"


_COUNTERS = ("submitted", "requests", "rows", "dispatches", "errors",
             "rejected", "shed", "expired", "cancelled")


class ServingMetrics:
    """Thread-safe serving statistics.  `record_dispatch` comes from the
    dispatcher thread once per packed batch; `record_request` and
    `record_failure` when a logical request's future resolves;
    `snapshot()` reduces everything to one flat dict.
    ``queue_depth_fn`` makes the reported depth live."""

    _MAX_WINDOW_EVENTS = 65536

    def __init__(self, window_s: float = 30.0,
                 max_latency_samples: int = 4096,
                 clock: Callable[[], float] = time.monotonic,
                 queue_depth_fn: Optional[Callable[[], int]] = None,
                 model: str = ""):
        self.window_s = float(window_s)
        self.clock = clock
        self.queue_depth_fn = queue_depth_fn
        self.model_tag = str(model)
        # every field below is guarded by self._lock: records arrive
        # from producer threads and the dispatcher concurrently
        self._lock = threading.Lock()
        self._totals = {k: 0 for k in _COUNTERS}
        self._blocked_s = 0.0
        # (t, rows, bucket, n_reqs, dispatch_s) per packed batch
        self._dispatches: deque = deque()
        # (t, latency_s) per completed logical request, and the subset
        # that carried a deadline
        self._latencies: deque = deque(maxlen=max_latency_samples)
        self._deadline_lats: deque = deque(maxlen=max_latency_samples)
        # (t, n) windowed submit/drop streams with running sums, for the
        # engine's degraded-health threshold
        self._submit_ts: deque = deque()
        self._drop_ts: deque = deque()
        self._submit_n = 0
        self._drop_n = 0
        self._queue_depth = 0
        self._last_dispatch_t: Optional[float] = None

    # ---- recording -----------------------------------------------------
    def _trim(self, now: float) -> None:
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

    def _drop(self, now: float, n: int) -> None:
        self._drop_ts.append((now, n))
        self._drop_n += n
        self._trim(now)

    def record_dispatch(self, rows: int, bucket: int, n_reqs: int,
                        queue_depth: int, dispatch_s: float) -> None:
        now = self.clock()
        with self._lock:
            self._totals["dispatches"] += 1
            self._totals["rows"] += rows
            self._dispatches.append((now, rows, bucket, n_reqs, dispatch_s))
            self._queue_depth = queue_depth
            self._last_dispatch_t = now
            self._trim(now)

    def record_request(self, latency_s: float,
                       deadlined: bool = False) -> None:
        now = self.clock()
        with self._lock:
            self._totals["requests"] += 1
            self._latencies.append((now, latency_s))
            if deadlined:
                self._deadline_lats.append((now, latency_s))

    def record_submitted(self, n: int = 1) -> None:
        """One per logical request entering submit(), admitted or not."""
        now = self.clock()
        with self._lock:
            self._totals["submitted"] += n
            self._submit_ts.append((now, n))
            self._submit_n += n
            self._trim(now)

    def record_rejected(self, n: int = 1) -> None:
        """Requests refused at admission (they never queued)."""
        now = self.clock()
        with self._lock:
            self._totals["rejected"] += n
            self._drop(now, n)

    def record_blocked(self, seconds: float) -> None:
        """Producer time spent blocked for admission (`block`)."""
        with self._lock:
            self._blocked_s += float(seconds)

    def record_cancelled(self, n: int = 1) -> None:
        """A client cancelled a queued request's future."""
        with self._lock:
            self._totals["cancelled"] += n

    def record_failure(self, exc: BaseException) -> None:
        """Count the exception that resolved a logical request's future
        (once per logical request, split chunks included)."""
        now = self.clock()
        phase = phase_of(exc)
        with self._lock:
            self._totals[phase] += 1
            if phase in ("shed", "rejected"):
                self._drop(now, 1)

    def drop_stats(self) -> Tuple[float, int]:
        """Windowed (drop_rate, submitted); drops are shed + rejected."""
        now = self.clock()
        with self._lock:
            self._trim(now)
            submitted, dropped = self._submit_n, self._drop_n
        return (dropped / submitted if submitted else 0.0), submitted

    # ---- reporting -----------------------------------------------------
    def snapshot(self) -> Dict:
        """Flat stats: ``qps`` (completed logical requests over the
        window), ``rows_per_sec``, ``batch_occupancy`` (mean rows/bucket
        of dispatched batches), live ``queue_depth``,
        ``last_dispatch_age_s``, ``dispatch_ms`` (mean dispatch+fetch
        wall time), nearest-rank latency percentiles in ms, per-bucket
        dispatch percentiles and the lifetime counters."""
        now = self.clock()
        depth_fn = self.queue_depth_fn
        live_depth = depth_fn() if depth_fn is not None else None
        with self._lock:
            self._trim(now)
            disp = list(self._dispatches)
            lat_rows = list(self._latencies)
            dlats = [lat for _, lat in self._deadline_lats]
            depth = self._queue_depth if live_depth is None else live_depth
            last_t = self._last_dispatch_t
            totals = dict(self._totals)
            blocked_ms = self._blocked_s * 1e3
        lats = [lat for _, lat in lat_rows]
        span = self.window_s
        if disp:
            span = min(self.window_s, max(1e-6, now - disp[0][0]))
        req_span = self.window_s
        if lat_rows:
            req_span = min(self.window_s, max(1e-6, now - lat_rows[0][0]))
        rows = sum(d[1] for d in disp)
        occ = (sum(d[1] / d[2] for d in disp) / len(disp)) if disp else 0.0
        q = quantiles(lats)
        qd = quantiles(dlats)

        def ms(v):
            # None, not NaN: a bare NaN is not valid JSON
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
            **totals,
            "admission_blocked_ms": round(blocked_ms, 3),
        }
