"""Dynamic micro-batcher — the request-coalescing half of the serving
engine, the port's copy of ``flexflow_tpu/serving/batcher.py``.

Pure queueing logic, free of torch: requests enter a thread-safe
priority-class queue via :meth:`MicroBatcher.submit`; the dispatcher
pulls coalesced batches with :meth:`next_batch`, which returns as soon
as ``max_batch`` rows are pending OR the oldest pending request has
waited ``max_wait_ms``.

Overload handling:

* the queue is bounded (``max_queue_rows``; 0 = unbounded) and
  ``submit`` applies an admission policy when it is full — ``block``
  (wait for room), ``reject`` (raise :class:`~.errors.OverloadError`,
  nothing enqueued) or ``shed_oldest`` (evict the oldest queued request
  of the lowest priority class <= the incoming one, failing it with
  :class:`~.errors.SheddedError`).  ``block`` is unordered: woken
  producers race for freed room;
* requests carry an optional absolute ``deadline``: queued work whose
  deadline has passed is expired before packing (its ``on_done`` fires
  with :class:`~.errors.DeadlineExceeded`);
* requests carry an integer ``priority`` class (higher = served first);
  FIFO holds within a class, and a class whose oldest request has
  waited ``starvation_ms`` jumps the order.

The clock is injectable (``clock=``) so the deadline and overload tests
drive a fake clock through :meth:`poll` instead of sleeping.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..obs import lockwatch
from .errors import DeadlineExceeded, OverloadError, SheddedError

ADMISSION_POLICIES = ("block", "reject", "shed_oldest")


def derive_buckets(max_batch: int, spec: str = "") -> Tuple[int, ...]:
    """The engine's shape buckets: ``spec`` ("2,4,16,64") when given,
    else powers of two ``2, 4, ..., max_batch``; always sorted, unique,
    ending at ``max_batch``.  The default starts at 2: a one-row
    program can take a matrix-vector path whose sums round differently,
    which would make a request's bits depend on its packing."""
    if max_batch < 1:
        raise ValueError(f"max_batch must be >= 1, got {max_batch}")
    if spec:
        try:
            buckets = sorted({int(v) for v in spec.split(",") if v.strip()})
        except ValueError:
            raise ValueError(f"bad bucket spec {spec!r} (want e.g. "
                             f"'2,4,16,64')")
        if not buckets or buckets[0] < 1:
            raise ValueError(f"bucket sizes must be >= 1, got {spec!r}")
        if buckets[-1] > max_batch:
            raise ValueError(f"bucket {buckets[-1]} exceeds max_batch "
                             f"{max_batch}")
    else:
        buckets, b = [], 2
        while b < max_batch:
            buckets.append(b)
            b *= 2
    if not buckets or buckets[-1] != max_batch:
        buckets.append(max_batch)
    return tuple(buckets)


def bucket_for(n: int, buckets: Sequence[int]) -> Optional[int]:
    """Smallest bucket covering ``n`` rows; None when ``n`` exceeds the
    largest bucket (the caller splits first — `split_sizes`)."""
    for b in buckets:
        if b >= n:
            return b
    return None


def split_sizes(n: int, max_batch: int) -> List[int]:
    """Chunk row counts for an oversize request: ``max_batch``-row
    chunks plus the remainder, in order."""
    if n <= max_batch:
        return [n]
    sizes = [max_batch] * (n // max_batch)
    if n % max_batch:
        sizes.append(n % max_batch)
    return sizes


class Request:
    """One queued unit of work: ``xs`` is a tuple of per-input row
    blocks (all leading dim ``n``); ``on_done(outputs, now)`` fires on
    the dispatcher thread with this request's rows or an exception, and
    returns True iff that call completed the LOGICAL request's future
    (split chunks share one).

    ``deadline`` is an absolute clock() time (None = none);
    ``priority`` the admission class; ``stale`` an optional predicate —
    True means the logical request is already resolved and the entry is
    dropped silently at the next scan; ``trace`` the request's sampled
    trace id (``obs.trace``) or None, which only the dispatcher reads."""

    __slots__ = ("xs", "n", "on_done", "t_submit", "deadline", "priority",
                 "stale", "trace")

    def __init__(self, xs, n: int, on_done, t_submit: float,
                 deadline: Optional[float] = None, priority: int = 0,
                 stale: Optional[Callable[[], bool]] = None,
                 trace: Optional[str] = None):
        self.xs = xs
        self.n = n
        self.on_done = on_done
        self.t_submit = t_submit
        self.deadline = deadline
        self.priority = int(priority)
        self.stale = stale
        self.trace = trace

    @property
    def _watched(self) -> bool:
        return self.deadline is not None or self.stale is not None


class MicroBatcher:
    """Thread-safe coalescing queue between `submit()` callers and the
    single dispatcher thread, with bounded-queue admission control."""

    def __init__(self, max_batch: int, max_wait_ms: float,
                 clock: Callable[[], float] = time.monotonic,
                 max_queue_rows: int = 0, admission: str = "block",
                 starvation_ms: float = 0.0):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        if admission not in ADMISSION_POLICIES:
            raise ValueError(
                f"unknown admission policy {admission!r} "
                f"(want one of {', '.join(ADMISSION_POLICIES)})")
        if 0 < max_queue_rows < max_batch:
            raise ValueError(
                f"max_queue_rows {max_queue_rows} < max_batch {max_batch}: "
                f"a full batch could never queue")
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.max_queue_rows = int(max_queue_rows)
        self.admission = admission
        self.starvation_s = float(starvation_ms) / 1e3
        self.clock = clock
        self._cv = lockwatch.condition("MicroBatcher._cv")
        # priority class -> FIFO deque; every field below is guarded by
        # self._cv
        self._classes: Dict[int, deque] = {}  # guarded_by: self._cv
        self._rows = 0        # guarded_by: self._cv
        self._count = 0       # guarded_by: self._cv
        # queued requests with a deadline or stale
        self._watch = 0       # guarded_by: self._cv
        self._peak_rows = 0   # guarded_by: self._cv
        # when the dispatcher's current wait self-expires (-inf while it
        # is awake): submit wakes it only for a deadline before this
        self._armed_wake = float("-inf")  # guarded_by: self._cv
        self._closed = False  # guarded_by: self._cv

    # ---- producer side -------------------------------------------------
    def submit(self, req: Request) -> float:
        return self.submit_all((req,))

    def submit_all(self, reqs: Sequence[Request],
                   admission: Optional[str] = None) -> float:
        """Enqueue ``reqs`` atomically: every request is accepted or
        none is (closed batcher, rejected or unsheddable overload), so
        the chunks of a split request never half-enqueue.  Applies the
        admission policy when the queue bound is set (``admission=``
        overrides the instance policy: the engine's injected queue
        spikes must never block the dispatcher thread).  Returns the
        seconds spent blocked for admission."""
        if not reqs:
            return 0.0
        total = 0
        for req in reqs:
            if req.n > self.max_batch:
                raise ValueError(
                    f"request of {req.n} rows exceeds max_batch "
                    f"{self.max_batch}; split first (split_sizes)")
            total += req.n
        policy = admission or self.admission
        blocked_s = 0.0
        shed: List[Request] = []
        overload: Optional[OverloadError] = None
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is closed")
            if self.max_queue_rows > 0:
                if total > self.max_queue_rows:
                    raise OverloadError(
                        f"request of {total} rows exceeds the queue bound "
                        f"serve_max_queue_rows={self.max_queue_rows}")
                if policy == "block":
                    t0 = self.clock()
                    while (self._rows + total > self.max_queue_rows
                           and not self._closed):
                        self._cv.wait()
                    blocked_s = self.clock() - t0
                    if self._closed:
                        raise RuntimeError("batcher is closed")
                elif policy == "reject":
                    if self._rows + total > self.max_queue_rows:
                        overload = OverloadError(
                            f"queue full ({self._rows} rows pending, "
                            f"bound {self.max_queue_rows}): request of "
                            f"{total} rows rejected")
                else:
                    shed = self._evict_for(
                        total, min(r.priority for r in reqs))
                    if self._rows + total > self.max_queue_rows:
                        overload = OverloadError(
                            f"queue full of higher-priority work "
                            f"({self._rows} rows pending, bound "
                            f"{self.max_queue_rows}): request of {total} "
                            f"rows not admitted")
            if overload is None:
                was_rows = self._rows
                was_empty = self._count == 0
                for req in reqs:
                    self._classes.setdefault(req.priority,
                                             deque()).append(req)
                    self._rows += req.n
                    self._count += 1
                    if req._watched:
                        self._watch += 1
                self._peak_rows = max(self._peak_rows, self._rows)
                # wake the dispatcher only on a state change it must act
                # on (queue turned nonempty, batch turned full, or a
                # deadline before its armed wake); notify_all because
                # blocked producers share the condition
                if (was_empty or was_rows < self.max_batch <= self._rows
                        or any(r.deadline is not None
                               and r.deadline < self._armed_wake
                               for r in reqs)):
                    self._cv.notify_all()
        # shed callbacks fire outside the lock: a future callback may
        # re-enter submit(), and the condition's lock is not re-entrant
        if shed:
            now = self.clock()
            for r in shed:
                r.on_done(SheddedError(
                    f"shed after queueing {now - r.t_submit:.3f}s to admit "
                    f"newer work (shed_oldest, bound "
                    f"{self.max_queue_rows} rows)"), now)
        if overload is not None:
            raise overload
        return blocked_s

    def _evict_for(self, need_rows: int,  # guarded_by: self._cv
                   incoming_priority: int) -> List[Request]:
        """shed_oldest eviction (lock held): pop the oldest request of
        the lowest priority class not above the incoming one until
        ``need_rows`` fit.  Evicts nothing when even shedding every
        eligible victim could not make room."""
        eligible = sum(r.n for p, dq in self._classes.items()
                       if p <= incoming_priority for r in dq)
        if self._rows - eligible + need_rows > self.max_queue_rows:
            return []
        out: List[Request] = []
        while self._rows + need_rows > self.max_queue_rows:
            victim_cls = min(
                (p for p, dq in self._classes.items()
                 if dq and p <= incoming_priority), default=None)
            if victim_cls is None:
                break
            r = self._classes[victim_cls].popleft()
            if not self._classes[victim_cls]:
                del self._classes[victim_cls]
            self._unlink(r)
            out.append(r)
        return out

    def close(self) -> None:
        """Stop accepting work; `next_batch` drains what is pending and
        then returns None.  Blocked producers fail with the closed
        error."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def requeue(self, reqs: Sequence[Request]) -> None:
        """Move already-admitted requests into this batcher, bypassing
        admission: a fleet hot swap moves the outgoing engine's queue to
        its replacement, and a router drains a downed host's queue to a
        survivor.  Work admitted once is never judged again.  Requeued
        requests keep their submit times."""
        with self._cv:
            if self._closed:
                raise RuntimeError("batcher is closed")
            was_empty = self._count == 0
            for req in reqs:
                self._classes.setdefault(req.priority,
                                         deque()).append(req)
                self._rows += req.n
                self._count += 1
                if req._watched:
                    self._watch += 1
            self._peak_rows = max(self._peak_rows, self._rows)
            if reqs and (was_empty or self._rows >= self.max_batch):
                self._cv.notify_all()

    def fail_pending(self) -> List[Request]:
        """Atomically remove everything still queued and hand it to the
        caller (drain-timeout stragglers), oldest first."""
        with self._cv:
            out: List[Request] = []
            for dq in self._classes.values():
                out.extend(dq)
            self._classes.clear()
            self._rows = 0
            self._count = 0
            self._watch = 0
            self._cv.notify_all()
        out.sort(key=lambda r: r.t_submit)
        return out

    # ---- consumer side -------------------------------------------------
    @property
    def queue_depth(self) -> int:
        """Pending requests (live snapshot)."""
        with self._cv:
            return self._count

    @property
    def pending_rows(self) -> int:
        """Rows pending (live snapshot)."""
        with self._cv:
            return self._rows

    @property
    def peak_rows(self) -> int:
        """High-water mark of queued rows."""
        with self._cv:
            return self._peak_rows

    def _unlink(self, r: Request) -> None:  # guarded_by: self._cv
        self._rows -= r.n
        self._count -= 1
        if r._watched:
            self._watch -= 1

    def _oldest_t(self) -> Optional[float]:  # guarded_by: self._cv
        return min((dq[0].t_submit for dq in self._classes.values() if dq),
                   default=None)

    def _ready(self, now: float) -> bool:  # guarded_by: self._cv
        if not self._count:
            return False
        if self._rows >= self.max_batch:
            return True
        oldest = self._oldest_t()
        return oldest is not None and now - oldest >= self.max_wait_s

    def _collect_expired(self, now: float  # guarded_by: self._cv
                         ) -> List[Request]:
        """Remove deadline-expired and stale requests (lock held) and
        return the expired ones; stale entries are dropped silently.
        Skipped when nothing queued carries a deadline or predicate."""
        if not self._watch:
            return []
        fire: List[Request] = []
        freed = False
        for p in list(self._classes):
            dq = self._classes[p]
            dead = []
            for r in dq:
                stale = r.stale is not None and r.stale()
                expired = r.deadline is not None and now >= r.deadline
                if stale or expired:
                    dead.append((r, expired and not stale))
            if not dead:
                continue
            gone = {id(r) for r, _ in dead}
            keep: deque = deque(r for r in dq if id(r) not in gone)
            for r, do_fire in dead:
                self._unlink(r)
                if do_fire:
                    fire.append(r)
            freed = True
            if keep:
                self._classes[p] = keep
            else:
                del self._classes[p]
        if freed:
            self._cv.notify_all()
        return fire

    def _fire_expired(self, fire: List[Request]) -> None:
        if not fire:
            return
        now = self.clock()
        for r in fire:
            r.on_done(DeadlineExceeded(
                f"deadline passed {now - r.deadline:.3f}s ago while "
                f"queued (waited {now - r.t_submit:.3f}s; expired before "
                f"packing, no dispatch burned)"), now)

    def _class_order(self, now: float) -> List[int]:  # guarded_by: self._cv
        """Service order over priority classes (lock held): higher class
        first, except that starving classes jump ahead, oldest first."""
        classes = [p for p, dq in self._classes.items() if dq]
        if len(classes) <= 1:
            return classes
        starving = []
        if self.starvation_s > 0:
            starving = [p for p in classes
                        if now - self._classes[p][0].t_submit
                        >= self.starvation_s]
            starving.sort(key=lambda p: self._classes[p][0].t_submit)
        rest = sorted((p for p in classes if p not in starving),
                      reverse=True)
        return starving + rest

    def _take(self, now: float) -> List[Request]:  # guarded_by: self._cv
        """Pop a coalesced batch of at most ``max_batch`` rows (lock
        held): classes in `_class_order`, a FIFO prefix of whole
        requests within each."""
        out: List[Request] = []
        rows = 0
        for p in self._class_order(now):
            dq = self._classes[p]
            while dq and rows + dq[0].n <= self.max_batch:
                r = dq.popleft()
                self._unlink(r)
                rows += r.n
                out.append(r)
            if not dq:
                del self._classes[p]
            if rows >= self.max_batch:
                break
        if out:
            self._cv.notify_all()
        return out

    def reap_expired(self) -> int:
        """Expire deadline-passed and stale queued requests now, taking
        no batch: a consumer that takes work on another cadence (the
        generation engine, whose slots can stay busy for seconds) calls
        it at its own boundaries.  Returns the count expired."""
        with self._cv:
            if not self._watch:
                return 0
            fire = self._collect_expired(self.clock())
        self._fire_expired(fire)
        return len(fire)

    def poll(self) -> Optional[List[Request]]:
        """Non-blocking `next_batch`: a coalesced batch if one is due
        (full, past the wait, or draining after close), else None.
        Expires dead requests first."""
        while True:
            with self._cv:
                now = self.clock()
                fire = self._collect_expired(now)
                batch = None
                if not fire and self._count and (self._closed
                                                 or self._ready(now)):
                    batch = self._take(now)
            if not fire:
                return batch
            self._fire_expired(fire)

    def _wake_in(self, now: float) -> Optional[float]:  # guarded_by: self._cv
        """Seconds until the next self-scheduled event (lock held): the
        oldest request's flush time and the earliest deadline."""
        wait = None
        oldest = self._oldest_t()
        if oldest is not None:
            wait = oldest + self.max_wait_s - now
        if self._watch:
            ed = min((r.deadline for dq in self._classes.values()
                      for r in dq if r.deadline is not None), default=None)
            if ed is not None:
                wait = ed - now if wait is None else min(wait, ed - now)
        return wait

    def next_batch(self, timeout: Optional[float] = None
                   ) -> Optional[List[Request]]:
        """Block until a batch is due, the batcher is closed AND drained
        (returns None), or ``timeout`` expires (returns None)."""
        deadline = None if timeout is None else self.clock() + timeout
        while True:
            with self._cv:
                now = self.clock()
                fire = self._collect_expired(now)
                if not fire:
                    if self._count and (self._closed or self._ready(now)):
                        return self._take(now)
                    if self._closed and not self._count:
                        return None
                    wait = self._wake_in(now)
                    if deadline is not None:
                        if now >= deadline:
                            return None
                        wait = (deadline - now if wait is None
                                else min(wait, deadline - now))
                    self._armed_wake = (float("inf") if wait is None
                                        else now + max(0.0, wait))
                    self._cv.wait(None if wait is None
                                  else max(0.0, wait))
                    self._armed_wake = float("-inf")
                    continue
            self._fire_expired(fire)
