"""Typed metrics registry with Prometheus text exposition, the port of
``flexflow_tpu/obs/registry.py``.

One process-wide :class:`MetricsRegistry` holds counter / gauge /
histogram families; :class:`~flexflow_tpu_torch.serving.metrics.ServingMetrics`
(and its generation subclass), the FleetEngine and the FleetRouter write
into it, and their ``serve_stats`` / ``gen_stats`` events read the same
children back, so the event stream and a scrape of :meth:`render` are
two views of one set of numbers.

Families are label-keyed (``model`` = tenant, ``eng`` = per-process
engine generation: two engines serving one model name never merge
counts).  Rendering follows the Prometheus text exposition format 0.0.4;
:func:`validate_prometheus_text` checks a rendered exposition.

The scrape endpoint (:func:`start_metrics_server`, ``--metrics-port``) is
a stdlib ``ThreadingHTTPServer`` on a daemon thread, stopped by
``server.shutdown()``.
"""

from __future__ import annotations

import re
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from . import lockwatch

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")

# latency-shaped default buckets (seconds): sub-ms serving dispatches
# up through multi-second stragglers, + the mandatory +Inf
DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                   0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _escape(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _fmt(v: float) -> str:
    if v == float("inf"):
        return "+Inf"
    if v == float("-inf"):
        return "-Inf"
    f = float(v)
    return repr(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class _Child:
    """One labeled series of a counter/gauge family."""

    __slots__ = ("_lock", "_v", "_fn")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self._v = 0.0       # guarded_by: self._lock
        # unguarded-ok: single atomic ref, published by set_fn and read
        # lock-free by value() (a stale fn for one read is harmless)
        self._fn: Optional[Callable[[], float]] = None

    def inc(self, n: float = 1.0) -> None:
        with self._lock:
            self._v += n

    def set(self, v: float) -> None:
        with self._lock:
            self._v = float(v)

    def set_fn(self, fn: Optional[Callable[[], float]]) -> None:
        """Make this series LIVE: rendered/read through ``fn`` (a gauge
        over state that already exists, e.g. the batcher's queue
        depth) instead of a stored value."""
        self._fn = fn

    @property
    def value(self) -> float:
        fn = self._fn
        if fn is not None:
            try:
                return float(fn())
            except Exception:  # noqa: BLE001 — a dead provider must
                return 0.0     # not break the scrape/snapshot path
        with self._lock:
            return self._v


class _HistChild:
    """One labeled histogram series: cumulative bucket counts + sum."""

    __slots__ = ("_lock", "bounds", "_counts", "_sum", "_n")

    def __init__(self, lock: threading.Lock, bounds: Tuple[float, ...]):
        self._lock = lock
        self.bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # guarded_by: self._lock
        self._sum = 0.0                         # guarded_by: self._lock
        self._n = 0                             # guarded_by: self._lock

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            for i, b in enumerate(self.bounds):
                if v <= b:
                    self._counts[i] += 1
                    break
            else:
                self._counts[-1] += 1
            self._sum += v
            self._n += 1

    def snapshot(self) -> Tuple[List[int], float, int]:
        with self._lock:
            return list(self._counts), self._sum, self._n


class _Family:
    """One metric family: name + type + help + labeled children."""

    def __init__(self, name: str, kind: str, help_text: str,
                 labelnames: Tuple[str, ...],
                 buckets: Tuple[float, ...] = ()):
        if not _NAME_RE.match(name):
            raise ValueError(f"invalid metric name {name!r}")
        for ln in labelnames:
            if not _LABEL_RE.match(ln):
                raise ValueError(f"invalid label name {ln!r} on {name}")
        self.name = name
        self.kind = kind
        self.help_text = help_text
        self.labelnames = labelnames
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._lock = lockwatch.lock("_Family._lock")
        self._children: Dict[Tuple[str, ...], object] = {}

    def labels(self, **labels: str):
        """The child series for one label-value combination (created on
        first use).  Label names must match the family declaration."""
        if tuple(sorted(labels)) != tuple(sorted(self.labelnames)):
            raise ValueError(
                f"{self.name} wants labels {self.labelnames}, got "
                f"{tuple(sorted(labels))}")
        key = tuple(str(labels[ln]) for ln in self.labelnames)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = (_HistChild(lockwatch.lock("_HistChild._lock"),
                                    self.buckets)
                         if self.kind == "histogram"
                         else _Child(lockwatch.lock("_Child._lock")))
                self._children[key] = child
            return child

    def remove(self, **labels: str) -> None:
        """Drop one labeled series from the family (no-op when
        absent).  Existing direct references to the child keep working
        — removal only ends its exposure in render()/total(), which is
        what lets a retired engine generation's counters be folded
        into a static carry and the series reclaimed (the fleet's
        bounded retirement, ``serving/fleet``)."""
        key = tuple(str(labels.get(ln, "")) for ln in self.labelnames)
        with self._lock:
            self._children.pop(key, None)

    def _series(self) -> List[Tuple[Tuple[str, ...], object]]:
        with self._lock:
            return sorted(self._children.items())

    def total(self) -> float:
        """Sum over every child: the whole-process view across engine
        generations."""
        return sum(c.value for _, c in self._series()
                   if isinstance(c, _Child))


class MetricsRegistry:
    """Name -> family map with idempotent declaration (re-declaring an
    existing name returns the existing family; a TYPE conflict
    raises)."""

    def __init__(self):
        self._lock = lockwatch.lock("MetricsRegistry._lock")
        self._families: Dict[str, _Family] = {}  # guarded_by: self._lock

    def _declare(self, name: str, kind: str, help_text: str,
                 labels: Sequence[str], buckets=()) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is not None:
                if fam.kind != kind:
                    raise ValueError(
                        f"metric {name} already declared as {fam.kind}, "
                        f"not {kind}")
                return fam
            fam = _Family(name, kind, help_text, tuple(labels), buckets)
            self._families[name] = fam
            return fam

    def counter(self, name: str, help_text: str,
                labels: Sequence[str] = ()) -> _Family:
        return self._declare(name, "counter", help_text, labels)

    def gauge(self, name: str, help_text: str,
              labels: Sequence[str] = ()) -> _Family:
        return self._declare(name, "gauge", help_text, labels)

    def histogram(self, name: str, help_text: str,
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> _Family:
        return self._declare(name, "histogram", help_text, labels,
                             buckets)

    def families(self) -> List[_Family]:
        with self._lock:
            return [self._families[n] for n in sorted(self._families)]

    def reset(self) -> None:
        """Forget every family (tests needing a clean slate; live code
        never calls this)."""
        with self._lock:
            self._families.clear()

    # ---- exposition ----------------------------------------------------
    def render(self) -> str:
        """Prometheus text exposition (format 0.0.4) over every family;
        function gauges are evaluated at render time."""
        lines: List[str] = []
        for fam in self.families():
            lines.append(f"# HELP {fam.name} {fam.help_text}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for key, child in fam._series():
                base = ",".join(
                    f'{ln}="{_escape(lv)}"'
                    for ln, lv in zip(fam.labelnames, key))
                if fam.kind == "histogram":
                    counts, total, n = child.snapshot()
                    cum = 0
                    for b, c in zip(fam.buckets, counts):
                        cum += c
                        lab = (base + "," if base else "") + \
                            f'le="{_fmt(b)}"'
                        lines.append(
                            f"{fam.name}_bucket{{{lab}}} {cum}")
                    cum += counts[-1]
                    lab = (base + "," if base else "") + 'le="+Inf"'
                    lines.append(f"{fam.name}_bucket{{{lab}}} {cum}")
                    suffix = f"{{{base}}}" if base else ""
                    lines.append(f"{fam.name}_sum{suffix} {_fmt(total)}")
                    lines.append(f"{fam.name}_count{suffix} {n}")
                else:
                    suffix = f"{{{base}}}" if base else ""
                    lines.append(
                        f"{fam.name}{suffix} {_fmt(child.value)}")
        return "\n".join(lines) + "\n"


_registry: Optional[MetricsRegistry] = None
_registry_lock = lockwatch.lock("registry._registry_lock")


def get_registry() -> MetricsRegistry:
    global _registry
    if _registry is None:
        with _registry_lock:
            if _registry is None:
                _registry = MetricsRegistry()
    return _registry


def render_prometheus() -> str:
    """The process registry's exposition."""
    return get_registry().render()


# ---------------------------------------------------------------------------
# exposition validation
# ---------------------------------------------------------------------------

_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
    r"(\{[^{}]*\})?"
    # full float grammar incl. NEGATIVE exponents: repr(4.5e-05) is a
    # value the renderer itself produces (sub-100us blocked seconds)
    r" (-?[0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?|[+-]Inf|NaN)$")


def validate_prometheus_text(text: str) -> List[str]:
    """Problems with a Prometheus text exposition ([] = valid): every
    sample line parses, every sample's base name was TYPE-declared,
    histogram series carry a ``+Inf`` bucket and ``_count`` ==
    cumulative ``+Inf``."""
    probs: List[str] = []
    typed: Dict[str, str] = {}
    inf_buckets: Dict[str, int] = {}
    counts: Dict[str, int] = {}
    for i, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4 or parts[3] not in (
                    "counter", "gauge", "histogram", "summary",
                    "untyped"):
                probs.append(f"line {i}: malformed TYPE line")
            else:
                typed[parts[2]] = parts[3]
            continue
        if line.startswith("#"):
            continue
        m = _SAMPLE_RE.match(line)
        if not m:
            probs.append(f"line {i}: unparseable sample: {line[:80]!r}")
            continue
        name = m.group(1)
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            if name.endswith(suffix) and name[:-len(suffix)] in typed:
                base = name[:-len(suffix)]
                break
        if base not in typed:
            probs.append(f"line {i}: sample {name} has no TYPE "
                         f"declaration")
            continue
        if typed[base] == "histogram":
            labels = m.group(2) or ""
            rest = re.sub(r'(,?le="[^"]*",?)', "", labels)
            series = base + ("" if rest in ("", "{}") else rest)
            if name.endswith("_bucket") and 'le="+Inf"' in labels:
                inf_buckets[series] = int(float(m.group(3)))
            elif name.endswith("_count"):
                counts[series] = int(float(m.group(3)))
    for series, n in counts.items():
        if series not in inf_buckets:
            probs.append(f"histogram {series}: no +Inf bucket")
        elif inf_buckets[series] != n:
            probs.append(
                f"histogram {series}: _count {n} != +Inf bucket "
                f"{inf_buckets[series]}")
    return probs


# ---------------------------------------------------------------------------
# scrape endpoint (stdlib HTTP)
# ---------------------------------------------------------------------------

def start_metrics_server(port: int, host: str = "127.0.0.1",
                         registry: Optional[MetricsRegistry] = None):
    """Serve ``GET /metrics`` (Prometheus text exposition of
    ``registry``, default the process registry) on a daemon thread.
    Binds loopback by default: the exposition names tenants and their
    traffic, so reaching it from another host is an explicit choice
    (``host="0.0.0.0"`` / ``--metrics-host``).  ``port=0`` binds an
    ephemeral port; the bound port is ``server.server_port``.  Returns
    the server: ``shutdown()`` and ``server_close()`` stop it."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    reg = registry or get_registry()

    class _Handler(BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (http.server's API)
            if self.path.split("?")[0] != "/metrics":
                self.send_error(404, "try /metrics")
                return
            body = reg.render().encode()
            self.send_response(200)
            self.send_header("Content-Type",
                             "text/plain; version=0.0.4; charset=utf-8")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *a):  # scrapes must not spam stderr
            pass

    server = ThreadingHTTPServer((host, int(port)), _Handler)
    thread = threading.Thread(target=server.serve_forever,
                              name="ff-metrics-http", daemon=True)
    thread.start()
    return server
