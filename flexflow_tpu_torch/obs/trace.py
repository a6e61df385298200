"""Request-scoped span tracing, the port of ``flexflow_tpu/obs/trace.py``.

Every ``submit()`` (dense, generation, fleet, router) draws a
``trace_id`` from the process :class:`Tracer`; the engines then record
the request's lifecycle as completed spans: ``admission_wait``,
``queue``, the per-dispatch ``pack``/``dispatch``/``fetch``/``scatter``
quartet, generation's ``prefill``/``decode_step``, the router's
``route`` and the two ``migrate`` legs, and exactly one terminal
``request`` span per logical request whose ``phase`` arg names its
outcome (:data:`TERMINAL_PHASES`), so span counts reconcile exactly
with the serving counters.

* off means off: the hot path reads one lock-free boolean
  (``tracer.active``) when tracing is disabled;
* span times come from the recording component's injected clock, kept
  as monotonic integer nanoseconds;
* spans land in a bounded ring, with a ``dropped`` counter;
* ``FFConfig.trace_sample_rate`` drives a systematic accumulator (no
  RNG), so two runs of one workload sample the same requests.

:func:`to_chrome` converts the raw ``ff-trace-v1`` snapshot to
Chrome-trace JSON; :func:`trace_main` is the ``trace`` verb of the
runner (``flexflow-tpu-torch trace export|summary``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

from . import lockwatch

RAW_SCHEMA = "ff-trace-v1"
CHROME_SCHEMA = "ff-chrome-trace-v1"

# the exhaustive outcomes of one logical request: every submitted
# request resolves with exactly one, recorded as its terminal
# ``request`` span's ``phase`` arg — the same classification
# ServingMetrics.record_failure counts, so span counts and the
# requests/rejected/shed/expired/errors/cancelled counters reconcile
TERMINAL_PHASES = ("completed", "rejected", "shed", "expired", "error",
                   "cancelled")


def phase_of(exc: BaseException) -> str:
    """The terminal phase of a request that resolved with ``exc`` —
    ONE classification, shared with ServingMetrics.record_failure."""
    from ..serving.errors import (DeadlineExceeded, GenerationCancelled,
                                  OverloadError, SheddedError)
    if isinstance(exc, DeadlineExceeded):
        return "expired"
    if isinstance(exc, SheddedError):
        return "shed"
    if isinstance(exc, GenerationCancelled):
        return "cancelled"
    if isinstance(exc, OverloadError):
        return "rejected"
    return "error"


class Tracer:
    """Process-wide span collector.  ``active`` is a plain attribute —
    the one lock-free check the hot path reads per dispatch; everything
    else happens only while tracing is on."""

    def __init__(self, capacity: int = 65536):
        self.active = False   # unguarded-ok: lock-free hot-path gate —
        #   single bool, written under _lock, racy read only skips/keeps
        #   one span
        self.sample_rate = 0.0  # unguarded-ok: single float, same deal
        self._lock = lockwatch.lock("Tracer._lock")
        # bounded span ring
        self._spans: deque = deque(maxlen=int(capacity))  # guarded_by: self._lock
        self._seq = 0      # guarded_by: self._lock
        self._acc = 0.0    # guarded_by: self._lock (systematic sampler)
        self._dropped = 0  # guarded_by: self._lock
        # passive sinks (the flight recorder's tap): mutated/snapshot
        # under the lock, CALLED outside it
        self._sinks: List[Callable[[Dict], None]] = []  # guarded_by: self._lock

    # ---- configuration -------------------------------------------------
    def configure(self, sample_rate: Optional[float] = None,
                  capacity: Optional[int] = None) -> "Tracer":
        """Enable/retune tracing.  ``sample_rate`` in [0, 1]: fraction
        of submits that get a trace_id (0 disables).  ``capacity``
        resizes the span ring (existing spans kept up to the new
        bound)."""
        with self._lock:
            if capacity is not None:
                self._spans = deque(self._spans, maxlen=int(capacity))
            if sample_rate is not None:
                rate = float(sample_rate)
                if not 0.0 <= rate <= 1.0:
                    raise ValueError(
                        f"trace_sample_rate must be in [0, 1], got {rate}")
                self.sample_rate = rate
                self.active = rate > 0.0
        return self

    def disable(self) -> None:
        with self._lock:
            self.active = False
            self.sample_rate = 0.0

    def reset(self) -> None:
        """Drop all recorded spans and restart ids (tests)."""
        with self._lock:
            self._spans.clear()
            self._seq = 0
            self._acc = 0.0
            self._dropped = 0

    def add_sink(self, fn: Callable[[Dict], None]) -> None:
        with self._lock:
            if fn not in self._sinks:
                self._sinks.append(fn)

    # ---- recording -----------------------------------------------------
    def new_trace(self) -> Optional[str]:
        """Draw a trace id for one incoming request, or None when the
        sampler skips it (callers then record nothing for the request).
        Systematic sampling: the accumulator admits exactly
        ``sample_rate`` of the submit stream, deterministically."""
        if not self.active:
            return None
        with self._lock:
            self._seq += 1
            seq = self._seq
            self._acc += self.sample_rate
            if self._acc < 1.0 - 1e-12:
                return None
            self._acc -= 1.0
        return f"t{seq:08d}"

    def span(self, name: str, trace: Optional[str], t0_s: float,
             t1_s: float, cat: str = "serve", tid: str = "",
             **args) -> None:
        """Record one completed span.  ``t0_s``/``t1_s`` are seconds on
        the recording component's injected clock (monotonic); stored as
        integer nanoseconds.  ``trace`` is the request's trace id (None
        for dispatch-scope spans like ``pack``/``decode_step``)."""
        if not self.active:
            return
        rec: Dict = {"name": name, "cat": cat,
                     "t0_ns": int(t0_s * 1e9), "t1_ns": int(t1_s * 1e9)}
        if trace:
            rec["trace"] = trace
        if tid:
            rec["tid"] = tid
        if args:
            rec["args"] = args
        with self._lock:
            if len(self._spans) == self._spans.maxlen:
                self._dropped += 1
            self._spans.append(rec)
            sinks = list(self._sinks)
        for fn in sinks:
            try:
                fn(rec)
            except Exception:  # noqa: BLE001 — a broken diagnostic
                pass           # sink must never fail the serving path

    # ---- export --------------------------------------------------------
    def snapshot(self) -> Dict:
        """The raw ``ff-trace-v1`` payload: bounded span list + enough
        provenance to interpret it offline."""
        with self._lock:
            spans = list(self._spans)
            dropped = self._dropped
            rate = self.sample_rate
        return {"schema": RAW_SCHEMA, "pid": os.getpid(),
                "sample_rate": rate, "dropped": dropped,
                "created_unix": round(time.time(), 3), "spans": spans}

    def save(self, path: str) -> Dict:
        """Write the raw snapshot to ``path`` (atomic) and return it."""
        snap = self.snapshot()
        tmp = f"{path}.tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            # compact: traces run to thousands of spans
            json.dump(snap, f, separators=(",", ":"))
            f.write("\n")
        os.replace(tmp, path)
        return snap

    def terminal_phase_counts(self) -> Dict[str, int]:
        """``phase -> count`` over the terminal ``request`` spans still
        in the ring: the half that reconciles against the ServingMetrics
        counters."""
        with self._lock:
            spans = list(self._spans)
        out: Dict[str, int] = {}
        for s in spans:
            if s["name"] == "request":
                ph = (s.get("args") or {}).get("phase", "?")
                out[ph] = out.get(ph, 0) + 1
        return out


_tracer: Optional[Tracer] = None
_tracer_lock = lockwatch.lock("trace._tracer_lock")


def get_tracer() -> Tracer:
    """The process tracer (created disabled on first use)."""
    global _tracer
    if _tracer is None:
        with _tracer_lock:
            if _tracer is None:
                _tracer = Tracer()
    return _tracer


def tracer_from_config(cfg) -> Tracer:
    """The engines' entry point: returns the process tracer, enabling it
    when ``cfg.trace_sample_rate > 0`` and it is not already on (an
    explicitly configured tracer wins)."""
    t = get_tracer()
    rate = float(getattr(cfg, "trace_sample_rate", 0.0) or 0.0)
    if rate > 0.0 and not t.active:
        t.configure(sample_rate=rate)
    return t


# ---------------------------------------------------------------------------
# Chrome-trace export + schema validation
# ---------------------------------------------------------------------------

def to_chrome(raw: Dict) -> Dict:
    """Convert a raw ``ff-trace-v1`` snapshot to the Chrome-trace JSON
    object format (chrome://tracing / Perfetto): one complete-duration
    ``"ph": "X"`` event per span, microsecond timestamps, the trace id
    carried in ``args.trace_id``."""
    probs = validate_raw_trace(raw)
    if probs:
        raise ValueError(f"not a valid {RAW_SCHEMA} payload: {probs[0]}")
    events = []
    pid = int(raw.get("pid", 0))
    for s in raw["spans"]:
        args = dict(s.get("args") or {})
        if s.get("trace"):
            args["trace_id"] = s["trace"]
        events.append({
            "name": s["name"],
            "cat": s.get("cat", "serve"),
            "ph": "X",
            "ts": s["t0_ns"] / 1e3,                       # microseconds
            "dur": max(0, s["t1_ns"] - s["t0_ns"]) / 1e3,
            "pid": pid,
            "tid": s.get("tid") or s.get("cat", "serve"),
            "args": args,
        })
    return {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {
            "schema": CHROME_SCHEMA,
            "source": RAW_SCHEMA,
            "sample_rate": raw.get("sample_rate"),
            "dropped": raw.get("dropped", 0),
            "created_unix": raw.get("created_unix"),
        },
    }


def validate_raw_trace(obj) -> List[str]:
    """Schema problems of a raw ``ff-trace-v1`` payload ([] = valid)."""
    probs: List[str] = []
    if not isinstance(obj, dict):
        return ["payload is not an object"]
    if obj.get("schema") != RAW_SCHEMA:
        probs.append(f"schema is {obj.get('schema')!r}, want {RAW_SCHEMA!r}")
    spans = obj.get("spans")
    if not isinstance(spans, list):
        return probs + ["spans is not a list"]
    for i, s in enumerate(spans):
        if not isinstance(s, dict):
            probs.append(f"spans[{i}] is not an object")
            continue
        for key in ("name", "t0_ns", "t1_ns"):
            if key not in s:
                probs.append(f"spans[{i}] missing {key!r}")
        if not isinstance(s.get("name", ""), str):
            probs.append(f"spans[{i}].name is not a string")
        for key in ("t0_ns", "t1_ns"):
            if key in s and not isinstance(s[key], int):
                probs.append(f"spans[{i}].{key} is not an integer (ns)")
        if (isinstance(s.get("t0_ns"), int) and isinstance(s.get("t1_ns"), int)
                and s["t1_ns"] < s["t0_ns"]):
            probs.append(f"spans[{i}] ends before it starts")
        if s.get("name") == "request":
            ph = (s.get("args") or {}).get("phase")
            if ph not in TERMINAL_PHASES:
                probs.append(
                    f"spans[{i}] terminal phase {ph!r} not in "
                    f"{TERMINAL_PHASES}")
        if len(probs) > 20:
            probs.append("... (truncated)")
            break
    return probs


def validate_chrome_trace(obj) -> List[str]:
    """Schema problems of an exported Chrome-trace JSON ([] = valid)."""
    probs: List[str] = []
    if not isinstance(obj, dict):
        return ["payload is not an object"]
    events = obj.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents is not a list"]
    if obj.get("displayTimeUnit") not in ("ms", "ns"):
        probs.append(f"displayTimeUnit {obj.get('displayTimeUnit')!r} "
                     f"invalid (want 'ms' or 'ns')")
    other = obj.get("otherData")
    if not isinstance(other, dict) or other.get("schema") != CHROME_SCHEMA:
        probs.append(f"otherData.schema missing or not {CHROME_SCHEMA!r}")
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            probs.append(f"traceEvents[{i}] is not an object")
            continue
        for key in ("name", "ph", "ts", "pid", "tid"):
            if key not in ev:
                probs.append(f"traceEvents[{i}] missing {key!r}")
        if ev.get("ph") == "X" and "dur" not in ev:
            probs.append(f"traceEvents[{i}] is 'X' without dur")
        if not isinstance(ev.get("ts", 0.0), (int, float)):
            probs.append(f"traceEvents[{i}].ts is not numeric")
        if len(probs) > 20:
            probs.append("... (truncated)")
            break
    return probs


# ---------------------------------------------------------------------------
# ``flexflow-tpu-torch trace`` CLI
# ---------------------------------------------------------------------------

def trace_main(argv) -> int:
    """``flexflow-tpu-torch trace export RAW.json [--out chrome.json]``:
    validate a raw ``ff-trace-v1`` file (serve-bench ``--trace-out``,
    ``Tracer.save``) and export it as Chrome-trace JSON, which
    chrome://tracing and Perfetto load.  ``trace summary`` prints span
    counts by name and the terminal-phase counts instead.  Exit: 0 ok,
    1 validation failure, 2 usage."""
    import argparse
    import sys

    parser = argparse.ArgumentParser(
        prog="flexflow-tpu-torch trace",
        description="export/inspect recorded request traces")
    sub = parser.add_subparsers(dest="cmd")
    p_exp = sub.add_parser("export", help="raw trace -> Chrome-trace JSON")
    p_exp.add_argument("raw", help="raw ff-trace-v1 JSON file")
    p_exp.add_argument("--out", default="",
                       help="output path (default: stdout)")
    p_sum = sub.add_parser("summary", help="span/phase counts of a trace")
    p_sum.add_argument("raw", help="raw ff-trace-v1 JSON file")
    args = parser.parse_args(argv)
    if args.cmd is None:
        parser.print_help(sys.stderr)
        return 2
    try:
        with open(args.raw) as f:
            raw = json.load(f)
    except (OSError, ValueError) as e:
        print(f"trace: cannot load {args.raw}: {e}", file=sys.stderr)
        return 2
    probs = validate_raw_trace(raw)
    if probs:
        for p in probs:
            print(f"trace: {args.raw}: {p}", file=sys.stderr)
        return 1
    if args.cmd == "summary":
        by_name: Dict[str, int] = {}
        phases: Dict[str, int] = {}
        for s in raw["spans"]:
            by_name[s["name"]] = by_name.get(s["name"], 0) + 1
            if s["name"] == "request":
                ph = (s.get("args") or {}).get("phase", "?")
                phases[ph] = phases.get(ph, 0) + 1
        print(json.dumps({"spans": by_name,
                          "terminal_phases": phases,
                          "dropped": raw.get("dropped", 0)}, indent=2))
        return 0
    chrome = to_chrome(raw)
    probs = validate_chrome_trace(chrome)
    if probs:  # only if to_chrome and the validator disagree
        for p in probs:
            print(f"trace: export failed self-validation: {p}",
                  file=sys.stderr)
        return 1
    text = json.dumps(chrome, separators=(",", ":"))
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
        print(f"# wrote {args.out} ({len(chrome['traceEvents'])} events)",
              file=sys.stderr)
    else:
        print(text)
    return 0
