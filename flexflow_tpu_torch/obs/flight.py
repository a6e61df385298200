"""Flight recorder, the port of ``flexflow_tpu/obs/flight.py``: what was
the process doing just before it went wrong?

A bounded, lock-guarded ring passively retains the most recent
structured fflogger events and tracer spans (taps installed on first
:func:`get_flight`).  On a trigger (an engine health edge into
``degraded``, a ``serve_dispatch_error``, a generation dispatch error, a
failed KV migration handoff) the ring is dumped as one JSON post-mortem
into ``FF_FLIGHT_DIR``.  With the variable unset nothing is written.
Dumps are rate-limited per reason and atomically renamed into place.
:func:`install_excepthook` (installed by the ``flexflow-tpu-torch``
runner) dumps the ring on a fatal uncaught exception.  :func:`flight_main`
is the runner's ``flight`` verb (``flexflow-tpu-torch flight dump|show``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from . import lockwatch

DUMP_SCHEMA = "ff-flight-v1"
ENV_DIR = "FF_FLIGHT_DIR"

# at most one dump per reason per this many wall seconds (storms), and
# a hard per-reason lifetime cap so a flapping health state cannot fill
# a disk over a week
_MIN_INTERVAL_S = 1.0
_MAX_DUMPS_PER_REASON = 8


class FlightRecorder:
    """Bounded ring of recent events + spans, dumpable on demand."""

    def __init__(self, capacity: int = 2048):
        self._lock = lockwatch.lock("FlightRecorder._lock")
        self._ring: deque = deque(maxlen=int(capacity))  # guarded_by: self._lock
        self._seq = 0                    # guarded_by: self._lock
        # both keyed (directory, reason) — see dump()'s limiter note
        self._last_dump: Dict = {}    # guarded_by: self._lock
        self._dump_counts: Dict = {}  # guarded_by: self._lock

    # ---- passive recording (the taps) ----------------------------------
    def record_event(self, rec: Dict) -> None:
        """fflogger tap: retain one structured event record."""
        with self._lock:
            self._ring.append({"kind": "event", **rec})

    def record_span(self, rec: Dict) -> None:
        """Tracer sink: retain one finished span."""
        with self._lock:
            self._ring.append({"kind": "span", **rec})

    def snapshot(self) -> List[Dict]:
        with self._lock:
            return list(self._ring)

    # ---- dumping -------------------------------------------------------
    def dump(self, reason: str, directory: Optional[str] = None,
             extra: Optional[Dict] = None,
             force: bool = False) -> Optional[str]:
        """Write the ring to ``directory`` (default ``$FF_FLIGHT_DIR``;
        None/"" = recorder-only mode, nothing written) and return the
        dump path.  Rate-limited per ``reason`` unless ``force``."""
        directory = (os.environ.get(ENV_DIR, "") if directory is None
                     else directory)
        if not directory:
            return None
        now = time.monotonic()
        # limiter keyed per (directory, reason): a storm into ONE dump
        # dir is limited, while a process redirected to a fresh dir
        # (tests, a rotated post-mortem location) starts a fresh budget
        key = (directory, reason)
        with self._lock:
            if not force:
                if now - self._last_dump.get(key, -1e9) < _MIN_INTERVAL_S:
                    return None
                if self._dump_counts.get(key, 0) >= _MAX_DUMPS_PER_REASON:
                    return None
            # stamp the interval now (concurrent triggers see it), but
            # charge the LIFETIME budget only after a successful write
            # — 8 attempts against a briefly full/readonly volume must
            # not exhaust the cap before the real post-mortem can land
            prev_last = self._last_dump.get(key)
            self._last_dump[key] = now
            self._seq += 1
            seq = self._seq
            records = list(self._ring)
        payload = {
            "schema": DUMP_SCHEMA,
            "reason": reason,
            "t_unix": round(time.time(), 3),
            "t_ns": time.monotonic_ns(),
            "pid": os.getpid(),
            "extra": extra or {},
            "records": records,
        }
        os.makedirs(directory, exist_ok=True)
        name = f"flight_{reason}_{os.getpid()}_{seq:04d}.json"
        path = os.path.join(directory, name)
        tmp = f"{path}.tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(payload, f, indent=1)
                f.write("\n")
            os.replace(tmp, path)
        except OSError:
            # a full/readonly disk must never take the serving path
            # down with it — the dump is best-effort by design; give
            # the interval stamp back so recovery can retry promptly
            with self._lock:
                if prev_last is None:
                    self._last_dump.pop(key, None)
                else:
                    self._last_dump[key] = prev_last
            return None
        with self._lock:
            self._dump_counts[key] = self._dump_counts.get(key, 0) + 1
        from ..fflogger import get_logger
        get_logger("obs").event("flight_dump", reason=reason, path=path,
                                records=len(records))
        return path


_flight: Optional[FlightRecorder] = None
_flight_lock = lockwatch.lock("flight._flight_lock")


def get_flight() -> FlightRecorder:
    """The process flight recorder.  First call installs the passive
    taps (fflogger events + tracer spans); the engines call this at
    startup so the ring covers their lifetime."""
    global _flight
    if _flight is None:
        with _flight_lock:
            if _flight is None:
                rec = FlightRecorder()
                from .. import fflogger
                from .trace import get_tracer
                fflogger.add_tap(rec.record_event)
                get_tracer().add_sink(rec.record_span)
                _flight = rec
    return _flight


def flight_dump(reason: str, extra: Optional[Dict] = None,
                force: bool = False) -> Optional[str]:
    """Module-level trigger: dump the process ring (no-op without
    ``$FF_FLIGHT_DIR``)."""
    return get_flight().dump(reason, extra=extra, force=force)


_orig_excepthook = None
_orig_thread_hook = None


def install_excepthook() -> None:
    """Dump the flight ring on a FATAL uncaught exception, then defer
    to the previous hook (installed by the ``flexflow-tpu-torch``
    runner — a crashed serving process leaves its last seconds on
    disk).  Hooks BOTH ``sys.excepthook`` and ``threading.excepthook``:
    the most likely serving crash is an exception escaping a dispatcher
    daemon THREAD's loop, which Python routes to the threading hook —
    the sys hook alone would never see it."""
    import sys
    global _orig_excepthook, _orig_thread_hook
    if _orig_excepthook is not None:
        return  # idempotent
    _orig_excepthook = sys.excepthook
    _orig_thread_hook = threading.excepthook

    def _dump(exc_type, exc, where: str) -> None:
        try:
            get_flight().dump(
                "fatal_exception", force=True,
                extra={"type": exc_type.__name__,
                       "error": str(exc)[:300], "where": where})
        except Exception:  # noqa: BLE001 — never mask the real crash
            pass

    def hook(exc_type, exc, tb):
        _dump(exc_type, exc, "main")
        _orig_excepthook(exc_type, exc, tb)

    def thread_hook(args):
        _dump(args.exc_type, args.exc_value,
              getattr(args.thread, "name", "") or "thread")
        _orig_thread_hook(args)

    sys.excepthook = hook
    threading.excepthook = thread_hook


def validate_flight_dump(obj) -> List[str]:
    """Schema problems of a flight dump ([] = valid)."""
    probs: List[str] = []
    if not isinstance(obj, dict):
        return ["payload is not an object"]
    if obj.get("schema") != DUMP_SCHEMA:
        probs.append(f"schema is {obj.get('schema')!r}, want "
                     f"{DUMP_SCHEMA!r}")
    for key in ("reason", "t_unix", "pid", "records"):
        if key not in obj:
            probs.append(f"missing {key!r}")
    recs = obj.get("records")
    if not isinstance(recs, list):
        probs.append("records is not a list")
        return probs
    for i, r in enumerate(recs):
        if not isinstance(r, dict) or r.get("kind") not in ("event",
                                                            "span"):
            probs.append(f"records[{i}] has no kind event|span")
        if len(probs) > 20:
            probs.append("... (truncated)")
            break
    return probs


# ---------------------------------------------------------------------------
# ``flexflow-tpu-torch flight`` CLI
# ---------------------------------------------------------------------------

def _list_dumps(directory: str) -> List[str]:
    try:
        names = [n for n in os.listdir(directory)
                 if n.startswith("flight_") and n.endswith(".json")]
    except OSError:
        return []
    paths = [os.path.join(directory, n) for n in names]
    return sorted(paths, key=lambda p: (os.path.getmtime(p), p))


def flight_main(argv) -> int:
    """``flexflow-tpu-torch flight dump [--dir D] [--json]``: locate the
    newest flight dump in D (default ``$FF_FLIGHT_DIR``), validate it,
    print its path (``--json``: its full content).  ``flight show
    [FILE] [--dir D] [--last N]``: human-readable tail of a dump.
    Exit: 0 ok, 1 no/invalid dump, 2 usage."""
    import argparse
    import sys

    parser = argparse.ArgumentParser(
        prog="flexflow-tpu-torch flight",
        description="inspect flight-recorder post-mortem dumps")
    sub = parser.add_subparsers(dest="cmd")
    p_dump = sub.add_parser("dump", help="newest dump: path / content")
    p_dump.add_argument("--dir", default="",
                        help=f"dump directory (default ${ENV_DIR})")
    p_dump.add_argument("--json", action="store_true",
                        help="print the dump's JSON content")
    p_show = sub.add_parser("show", help="human-readable dump timeline")
    p_show.add_argument("file", nargs="?", default="",
                        help="dump file (default: newest in --dir)")
    p_show.add_argument("--dir", default="",
                        help=f"dump directory (default ${ENV_DIR})")
    p_show.add_argument("--last", type=int, default=40,
                        help="records to show (default 40)")
    args = parser.parse_args(argv)
    if args.cmd is None:
        parser.print_help(sys.stderr)
        return 2

    path = getattr(args, "file", "") or ""
    if not path:
        directory = args.dir or os.environ.get(ENV_DIR, "")
        if not directory:
            print(f"flight: no dump directory (pass --dir or set "
                  f"${ENV_DIR})", file=sys.stderr)
            return 2
        dumps = _list_dumps(directory)
        if not dumps:
            print(f"flight: no dumps in {directory}", file=sys.stderr)
            return 1
        path = dumps[-1]
    try:
        with open(path) as f:
            obj = json.load(f)
    except (OSError, ValueError) as e:
        print(f"flight: cannot load {path}: {e}", file=sys.stderr)
        return 1
    probs = validate_flight_dump(obj)
    if probs:
        for p in probs:
            print(f"flight: {path}: {p}", file=sys.stderr)
        return 1
    if args.cmd == "dump":
        if args.json:
            print(json.dumps(obj, indent=1))
        else:
            print(path)
        return 0
    recs = obj["records"][-args.last:] if args.last > 0 else []
    print(f"flight dump {path}")
    print(f"  reason={obj['reason']} pid={obj['pid']} "
          f"t_unix={obj['t_unix']} records={len(obj['records'])} "
          f"(showing last {len(recs)})")
    for r in recs:
        if r["kind"] == "event":
            head = f"[event] {r.get('cat', '?')}/{r.get('event', '?')}"
            rest = {k: v for k, v in r.items()
                    if k not in ("kind", "cat", "event", "t", "t_ns")}
            print(f"  {head} t={r.get('t')} "
                  f"{json.dumps(rest, default=str)[:160]}")
        else:
            dur_us = (r.get("t1_ns", 0) - r.get("t0_ns", 0)) / 1e3
            trace = f" trace={r['trace']}" if r.get("trace") else ""
            print(f"  [span ] {r.get('name', '?')}{trace} "
                  f"dur={dur_us:.1f}us "
                  f"{json.dumps(r.get('args', {}), default=str)[:120]}")
    return 0
