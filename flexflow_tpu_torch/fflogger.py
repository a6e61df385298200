"""Structured logging with named categories, the port of
``flexflow_tpu/fflogger.py``.

* ``get_logger("serve"|"obs"|...)`` returns a category logger;
* levels come from the environment: ``FF_LOG_LEVEL=debug|info|warning|
  error|none`` globally, refined per category by
  ``FF_LOG_LEVELS="serve=debug,obs=info"``;
* ``Category.event(name, **fields)`` emits one JSON line
  (``{"cat": ..., "event": ..., ...}``) on stdout;
* :func:`capture_events` collects the event dicts in-process (tests and
  harnesses), :func:`add_tap` registers a passive observer (the flight
  recorder, the cluster router's load scrape), :func:`silenced` mutes
  categories' info output.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import threading
import time
from typing import Any, Callable, Dict

from .obs import lockwatch

_LEVELS = {"debug": 10, "info": 20, "warning": 30, "error": 40, "none": 100}
_DEFAULT_LEVEL = "info"


def _configured_level(name: str) -> int:
    per_cat = os.environ.get("FF_LOG_LEVELS", "")
    for part in per_cat.split(","):
        if "=" in part:
            cat, _, lvl = part.partition("=")
            if cat.strip() == name:
                return _LEVELS.get(lvl.strip().lower(), _LEVELS["info"])
    glob = os.environ.get("FF_LOG_LEVEL", _DEFAULT_LEVEL).lower()
    return _LEVELS.get(glob, _LEVELS["info"])


class Category:
    """One named log channel (≙ one Legion Logger::Category)."""

    def __init__(self, name: str):
        self.name = name
        self.level = _configured_level(name)

    def _emit(self, lvl: str, msg: str) -> None:
        if _LEVELS[lvl] >= self.level:
            print(f"[{self.name}] {lvl}: {msg}", file=sys.stderr, flush=True)

    def debug(self, msg: str) -> None:
        self._emit("debug", msg)

    def info(self, msg: str) -> None:
        self._emit("info", msg)

    def warning(self, msg: str) -> None:
        self._emit("warning", msg)

    def error(self, msg: str) -> None:
        self._emit("error", msg)

    def event(self, event: str, **fields: Any) -> None:
        """One JSON line per event on stdout (info level): the structured
        metrics stream (e.g. one line per training epoch from fit()).
        Active :func:`capture_events` contexts receive the record dict
        regardless of level: a harness harvesting events must see them
        even while the stdout stream is silenced.

        Timestamps: ``t`` is the human wall clock (coarse, steppable);
        ``t_ns`` is ``time.monotonic_ns()`` — the ORDERING field.  The
        old wall-clock-only stamp rounded to 1 ms, collapsing
        sub-millisecond serving/decode events and running backwards
        under NTP steps; consumers ordering events must use
        ``t_ns``."""
        rec: Dict[str, Any] = {"cat": self.name, "event": event,
                               "t": round(time.time(), 3),
                               "t_ns": time.monotonic_ns()}
        rec.update(fields)
        # snapshot the capture/tap lists under the lock, then call
        # outside it: the serving dispatcher thread emits events while
        # other threads enter/exit capture_events contexts — iterating
        # the live list would race its mutation
        with _capture_lock:
            captures = list(_captures)
            taps = list(_taps)
        muted = False
        for names, sink, mute in captures:
            if names is None or self.name in names:
                sink.append(dict(rec))
                muted = muted or mute
        for tap in taps:
            # passive observers (the obs.flight ring, the router's
            # scrape): mute-agnostic, and a broken tap must never take
            # the emitting path down.
            # may-acquire: FlightRecorder._lock
            # (the flight tap records into its ring under that lock; a
            # stored callable is beyond the walk, so the contract puts
            # the edge in the static graph)
            try:
                tap(dict(rec))
            except Exception:  # noqa: BLE001
                pass
        if muted or _LEVELS["info"] < self.level:
            return
        print(json.dumps(rec), flush=True)


_registry: Dict[str, Category] = {}
# guards _captures and _taps: entries are added/removed from producer
# threads while Category.event iterates concurrently
_capture_lock = lockwatch.lock("fflogger._capture_lock")
# active capture_events contexts: (category-name filter | None, sink, mute)
_captures: list = []  # guarded_by: _capture_lock
# passive event observers: fn(record_dict), called for EVERY event
# regardless of level/mute (the flight recorder's tap)
_taps: list = []  # guarded_by: _capture_lock


def add_tap(fn: Callable[[Dict], None]) -> None:
    """Register a passive observer of every event record (idempotent)."""
    with _capture_lock:
        if fn not in _taps:
            _taps.append(fn)


def remove_tap(fn: Callable[[Dict], None]) -> None:
    with _capture_lock:
        if fn in _taps:
            _taps.remove(fn)


@contextlib.contextmanager
def capture_events(*names: str, mute: bool = True):
    """Record every ``Category.event`` dict emitted by the given
    categories (all categories when none given) into the yielded list:
    the programmatic consumer of the event stream.  ``mute=True`` (default) suppresses the captured events' stdout lines
    so a harness's JSON payload cannot interleave with them; capture
    works even under :func:`silenced` (it hooks before the level gate)."""
    sink: list = []
    entry = (frozenset(names) or None, sink, mute)
    with _capture_lock:
        _captures.append(entry)
    try:
        yield sink
    finally:
        # remove by identity, not equality: two nested captures with the
        # same filter compare equal once their sinks hold equal events,
        # and list.remove() would pop the OUTER entry
        with _capture_lock:
            for i in range(len(_captures) - 1, -1, -1):
                if _captures[i] is entry:
                    del _captures[i]
                    break


def get_logger(name: str) -> Category:
    if name not in _registry:
        _registry[name] = Category(name)
    return _registry[name]


@contextlib.contextmanager
def silenced(*names: str):
    """Temporarily mute the given categories' info-level output
    (levels restored on exit), for harnesses whose stdout is a JSON
    payload that must not interleave with the event stream.  Warnings and
    errors stay visible: they go to stderr, which cannot corrupt the
    stdout payload, and a failing bench run needs its diagnostics."""
    logs = [get_logger(n) for n in names]
    prev = [log.level for log in logs]
    for log in logs:
        log.level = _LEVELS["info"] + 1  # events + info off, warn+ on
    try:
        yield
    finally:
        for log, lvl in zip(logs, prev):
            log.level = lvl
