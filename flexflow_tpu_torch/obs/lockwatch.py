"""Runtime lock-order observation, the port of
``flexflow_tpu/obs/lockwatch.py``.

:func:`lock` / :func:`rlock` / :func:`condition` are the one
construction point the serving stack uses for its threading primitives,
keyed by the canonical lock id (``"ClassName.attr"`` for instance locks,
``"modulebasename.NAME"`` for module globals), the JAX package's names.

With ``FF_LOCKWATCH`` unset (the default) the factories return plain
``threading`` objects.  With ``FF_LOCKWATCH=1`` they return instrumented
wrappers recording, process-wide, the acquisition-order graph (an edge
``A -> B`` whenever a thread acquires ``B`` while holding ``A``,
reentrant re-acquisitions excluded, attributed to the thread's name) and
per-lock hold times.  :func:`report` returns the graph with a cycle
verdict; :func:`publish` mirrors it into the metrics registry, never from
the acquire/release path.  Enablement is sampled at construction time.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional, Set, Tuple

# same latency-shaped bounds the metrics registry defaults to; kept
# literal so this module stays stdlib-only (import-cycle safety)
_HOLD_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)

# process-wide observation state: a PLAIN lock (never instrumented —
# it guards the instrumentation itself) over the edge and hold maps
_state_lock = threading.Lock()
_edges: Dict[Tuple[str, str], Dict] = {}   # guarded_by: _state_lock
_holds: Dict[str, Dict] = {}               # guarded_by: _state_lock
_tls = threading.local()


def enabled() -> bool:
    """True when new factory calls return instrumented primitives."""
    return os.environ.get("FF_LOCKWATCH", "") not in ("", "0")


def _stack() -> List[str]:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def _note_acquired(name: str) -> None:
    """Bookkeeping after ``name`` was acquired by this thread."""
    st = _stack()
    if name not in st:           # reentrant re-acquire adds no edges
        held = dict.fromkeys(st)  # distinct, in acquisition order
        if held:
            tname = threading.current_thread().name
            with _state_lock:
                for h in held:
                    e = _edges.setdefault((h, name),
                                          {"count": 0, "threads": set()})
                    e["count"] += 1
                    e["threads"].add(tname)
    st.append(name)


def _note_released(name: str, t_acquired: float) -> None:
    """Bookkeeping before/after ``name`` is released by this thread."""
    st = _stack()
    for i in range(len(st) - 1, -1, -1):
        if st[i] == name:
            del st[i]
            break
    dt = time.monotonic() - t_acquired
    with _state_lock:
        h = _holds.setdefault(name, {
            "count": 0, "total_s": 0.0, "max_s": 0.0,
            "buckets": [0] * (len(_HOLD_BUCKETS) + 1)})
        h["count"] += 1
        h["total_s"] += dt
        h["max_s"] = max(h["max_s"], dt)
        for i, b in enumerate(_HOLD_BUCKETS):
            if dt <= b:
                h["buckets"][i] += 1
                break
        else:
            h["buckets"][-1] += 1


class _Watched:
    """Instrumented Lock/RLock: context manager + acquire/release with
    the ``threading`` signatures the call sites use."""

    def __init__(self, name: str, inner):
        self.name = name
        self._inner = inner
        # per-thread stack of acquisition times (RLock may nest)
        self._t_tls = threading.local()

    def _times(self) -> List[float]:
        ts = getattr(self._t_tls, "ts", None)
        if ts is None:
            ts = self._t_tls.ts = []
        return ts

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._inner.acquire(blocking, timeout)
        if got:
            self._times().append(time.monotonic())
            _note_acquired(self.name)
        return got

    def release(self) -> None:
        ts = self._times()
        t0 = ts.pop() if ts else time.monotonic()
        self._inner.release()
        _note_released(self.name, t0)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        return f"<lockwatch {self.name} over {self._inner!r}>"


class _WatchedCondition:
    """Instrumented Condition over its own (plain) lock.  ``wait``
    releases the lock, so the held-stack entry is dropped for the
    duration and re-recorded on wake — the re-acquisition is a real
    runtime ordering event."""

    def __init__(self, name: str):
        self.name = name
        self._cond = threading.Condition()
        self._t_tls = threading.local()

    def _times(self) -> List[float]:
        ts = getattr(self._t_tls, "ts", None)
        if ts is None:
            ts = self._t_tls.ts = []
        return ts

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        got = self._cond.acquire(blocking, timeout)
        if got:
            self._times().append(time.monotonic())
            _note_acquired(self.name)
        return got

    def release(self) -> None:
        ts = self._times()
        t0 = ts.pop() if ts else time.monotonic()
        self._cond.release()
        _note_released(self.name, t0)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def wait(self, timeout: Optional[float] = None) -> bool:
        ts = self._times()
        t0 = ts.pop() if ts else time.monotonic()
        _note_released(self.name, t0)
        try:
            # lock-ok: callers hold _cond via this wrapper's own
            # acquire(); only the held-stack BOOKKEEPING is dropped
            # here (the lock itself is released inside _cond.wait)
            return self._cond.wait(timeout)
        finally:
            self._times().append(time.monotonic())
            _note_acquired(self.name)

    def wait_for(self, predicate, timeout: Optional[float] = None):
        # reimplemented over self.wait so the release/re-acquire
        # bookkeeping above applies to every iteration
        end = None if timeout is None else time.monotonic() + timeout
        result = predicate()
        while not result:
            wt = None if end is None else max(0.0, end - time.monotonic())
            if wt == 0.0:
                break
            self.wait(wt)
            result = predicate()
        return result

    def notify(self, n: int = 1) -> None:
        self._cond.notify(n)

    def notify_all(self) -> None:
        self._cond.notify_all()

    def __repr__(self) -> str:
        return f"<lockwatch cv {self.name}>"


# ---------------------------------------------------------------------------
# the factories (the one construction point)
# ---------------------------------------------------------------------------

def lock(name: str):
    """A ``threading.Lock`` — instrumented iff ``FF_LOCKWATCH`` was set
    when this was called.  ``name`` is the canonical lock id."""
    if enabled():
        return _Watched(name, threading.Lock())
    return threading.Lock()


def rlock(name: str):
    """A ``threading.RLock`` (reentrant re-acquisitions record no
    edges)."""
    if enabled():
        return _Watched(name, threading.RLock())
    return threading.RLock()


def condition(name: str):
    """A ``threading.Condition`` over its own lock."""
    if enabled():
        return _WatchedCondition(name)
    return threading.Condition()


# ---------------------------------------------------------------------------
# observation readout
# ---------------------------------------------------------------------------

def edges() -> Set[Tuple[str, str]]:
    """The observed nested-acquisition edges so far."""
    with _state_lock:
        return set(_edges)


def find_cycle(graph: Set[Tuple[str, str]]) -> Optional[List[str]]:
    """First directed cycle in ``graph`` as a node list (closed walk,
    first == last), or None.  Iterative colored DFS."""
    adj: Dict[str, List[str]] = {}
    for a, b in sorted(graph):
        adj.setdefault(a, []).append(b)
    color: Dict[str, int] = {}   # 0 absent, 1 on stack, 2 done
    parent: Dict[str, str] = {}
    for root in sorted(adj):
        if color.get(root):
            continue
        work: List[Tuple[str, int]] = [(root, 0)]
        while work:
            node, idx = work.pop()
            if idx == 0:
                color[node] = 1
            outs = adj.get(node, ())
            if idx < len(outs):
                work.append((node, idx + 1))
                nxt = outs[idx]
                c = color.get(nxt, 0)
                if c == 1:       # back edge: found a cycle
                    cyc = [nxt]
                    cur = node
                    while cur != nxt:
                        cyc.append(cur)
                        cur = parent[cur]
                    cyc.append(nxt)
                    cyc.reverse()
                    return cyc
                if c == 0:
                    parent[nxt] = node
                    work.append((nxt, 0))
            else:
                color[node] = 2
    return None


def report() -> Dict:
    """Snapshot of everything observed: edge list (with counts and the
    thread names that drove them), per-lock hold stats, and the cycle
    verdict."""
    with _state_lock:
        edge_list = [
            {"src": a, "dst": b, "count": e["count"],
             "threads": sorted(e["threads"])}
            for (a, b), e in sorted(_edges.items())]
        holds = {n: {"count": h["count"], "total_s": h["total_s"],
                     "max_s": h["max_s"], "buckets": list(h["buckets"])}
                 for n, h in sorted(_holds.items())}
        graph = set(_edges)
    return {"enabled": enabled(), "edges": edge_list, "holds": holds,
            "cycle": find_cycle(graph)}


def reset() -> None:
    """Drop all observations (tests only; thread-local held stacks of
    live threads are untouched)."""
    with _state_lock:
        _edges.clear()
        _holds.clear()


def publish(registry=None) -> None:
    """Mirror the observation state into the metrics registry as
    gauges: ``ff_lock_acq_order_edge{src,dst}``,
    ``ff_lock_hold_seconds_{sum,count,max}{lock}`` and bucketed
    ``ff_lock_hold_seconds_bucket{lock,le}``.  Call from a scrape
    hook or test teardown — NEVER from under an instrumented lock."""
    from .registry import get_registry
    reg = registry if registry is not None else get_registry()
    snap = report()
    fam_e = reg.gauge("ff_lock_acq_order_edge",
                      "runtime nested lock acquisitions (lockwatch)",
                      labels=("src", "dst"))
    for e in snap["edges"]:
        fam_e.labels(src=e["src"], dst=e["dst"]).set(e["count"])
    fam_s = reg.gauge("ff_lock_hold_seconds_sum",
                      "total observed hold time (lockwatch)",
                      labels=("lock",))
    fam_c = reg.gauge("ff_lock_hold_seconds_count",
                      "observed hold count (lockwatch)",
                      labels=("lock",))
    fam_m = reg.gauge("ff_lock_hold_seconds_max",
                      "max observed hold time (lockwatch)",
                      labels=("lock",))
    fam_b = reg.gauge("ff_lock_hold_seconds_bucket",
                      "hold-time histogram (lockwatch, cumulative le)",
                      labels=("lock", "le"))
    for n, h in snap["holds"].items():
        fam_s.labels(lock=n).set(h["total_s"])
        fam_c.labels(lock=n).set(h["count"])
        fam_m.labels(lock=n).set(h["max_s"])
        cum = 0
        for bound, cnt in zip(_HOLD_BUCKETS, h["buckets"]):
            cum += cnt
            fam_b.labels(lock=n, le=f"{bound:g}").set(cum)
        cum += h["buckets"][-1]
        fam_b.labels(lock=n, le="+Inf").set(cum)
