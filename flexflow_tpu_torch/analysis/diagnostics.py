"""Structured diagnostics of the static verifier, the JAX package's
``analysis/diagnostics.py``.

Every check emits a :class:`Diagnostic` with a STABLE code (``FFxxx``),
a severity, the op it concerns, a message and a fix hint.  Codes are
append-only and shared with the JAX package, so a report means the same
in either package.
"""

from __future__ import annotations

import dataclasses
import enum
import json
from typing import Dict, Iterable, List, Optional


class Severity(enum.IntEnum):
    """Ordered so ``max()`` over a report gives the worst finding."""

    INFO = 0
    WARN = 1
    ERROR = 2

    def __str__(self) -> str:  # render "ERROR", not "Severity.ERROR"
        return self.name


# The stable code registry: code -> (default severity, short title).
# Append-only; docs/verifier.md mirrors this table.
CODES: Dict[str, tuple] = {
    # graph passes (FF0xx)
    "FF001": (Severity.ERROR, "shape re-inference mismatch"),
    "FF002": (Severity.ERROR, "dtype mismatch"),
    "FF003": (Severity.ERROR, "duplicate op name"),
    "FF004": (Severity.WARN, "dangling input tensor"),
    "FF005": (Severity.WARN, "dead op (unreachable from the final tensor)"),
    "FF006": (Severity.WARN, "unused parameter"),
    # strategy passes (FF1xx)
    "FF101": (Severity.ERROR, "partition degree does not divide dim extent"),
    "FF102": (Severity.ERROR, "strategy rank mismatch"),
    "FF103": (Severity.ERROR, "device count != product of degrees"),
    "FF104": (Severity.ERROR, "device id outside the machine"),
    "FF105": (Severity.ERROR, "degree not expressible on the mesh axis"),
    "FF106": (Severity.WARN, "runtime replicate fallback"),
    "FF107": (Severity.WARN, "host-memory placement rule violation"),
    "FF108": (Severity.ERROR, "per-device peak memory exceeds HBM budget"),
    "FF109": (Severity.INFO, "producer/consumer resharding hotspot"),
    "FF110": (Severity.WARN, "strategy entry names no op in the graph"),
    "FF111": (Severity.INFO, "non-canonical device_ids (mesh-linearized)"),
    "FF112": (Severity.ERROR, "strategy needs more devices than the machine"),
    # static sharding-propagation passes
    "FF120": (Severity.WARN, "predicted trace-time replicate fallback"),
    "FF121": (Severity.WARN,
              "liveness HBM high-water exceeds the budget"),
    # fleet co-residency passes
    "FF130": (Severity.ERROR,
              "fleet co-residency: summed per-device memory exceeds HBM"),
    "FF131": (Severity.INFO, "fleet per-model residency breakdown"),
    # disaggregated prefill/decode topology
    "FF132": (Severity.ERROR,
              "disagg topology: decode pool undersized for migrated "
              "pages, page-geometry mismatch, or prefill with no "
              "decode target"),
    # precision-axis passes
    "FF140": (Severity.ERROR,
              "precision override on an fp32-pinned op (loss/norm stats)"),
    "FF141": (Severity.INFO, "per-op precision policy summary"),
    # concurrency passes
    "FF150": (Severity.ERROR,
              "shared field accessed outside its inferred/declared guard"),
    "FF151": (Severity.ERROR,
              "lock-order inversion (cycle in the static lock graph)"),
    "FF152": (Severity.WARN, "blocking call while holding a lock"),
    "FF153": (Severity.WARN,
              "cv.wait without predicate loop or without its lock"),
    "FF154": (Severity.ERROR,
              "annotation drift (# guarded_by: disagrees with inference)"),
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One finding.  ``op`` is the op (or tensor/parameter) name the finding
    anchors to, empty for whole-graph findings; ``count`` aggregates
    repeated occurrences of the same site class (e.g. N tensors that would
    replicate-fallback under one config)."""

    code: str
    severity: Severity
    op: str
    message: str
    hint: str = ""
    count: int = 1

    def render(self) -> str:
        agg = f" [x{self.count}]" if self.count > 1 else ""
        where = f" {self.op}:" if self.op else ""
        hint = f"  (fix: {self.hint})" if self.hint else ""
        return f"{self.code} {self.severity}{agg}{where} {self.message}{hint}"

    def to_dict(self) -> dict:
        return {"code": self.code, "severity": str(self.severity),
                "op": self.op, "message": self.message, "hint": self.hint,
                "count": self.count}


def make(code: str, op: str, message: str, hint: str = "",
         severity: Optional[Severity] = None, count: int = 1) -> Diagnostic:
    """Build a Diagnostic with the registry's default severity (override
    only where context changes the judgement — e.g. a dead prediction
    head is INFO, a dead trunk op WARN)."""
    default_sev, _title = CODES[code]
    # explicit "is not None": Severity.INFO is falsy (IntEnum value 0)
    return Diagnostic(code=code,
                      severity=default_sev if severity is None else severity,
                      op=op, message=message, hint=hint, count=count)


class DiagnosticReport:
    """An ordered collection of diagnostics with the text/JSON renderers
    the CLI and ``FFModel.compile(verify=...)`` share."""

    def __init__(self, diags: Optional[Iterable[Diagnostic]] = None):
        self.diagnostics: List[Diagnostic] = list(diags or ())

    def extend(self, diags: Iterable[Diagnostic]) -> None:
        self.diagnostics.extend(diags)

    def add(self, diag: Diagnostic) -> None:
        self.diagnostics.append(diag)

    def by_severity(self, severity: Severity) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == severity]

    @property
    def errors(self) -> List[Diagnostic]:
        return self.by_severity(Severity.ERROR)

    @property
    def warnings(self) -> List[Diagnostic]:
        return self.by_severity(Severity.WARN)

    def codes(self) -> List[str]:
        return [d.code for d in self.diagnostics]

    def counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for d in self.diagnostics:
            out[str(d.severity)] = out.get(str(d.severity), 0) + 1
        return out

    def __len__(self) -> int:
        return len(self.diagnostics)

    def __iter__(self):
        return iter(self.diagnostics)

    def ok(self, max_severity: Severity = Severity.WARN) -> bool:
        """True when nothing above ``max_severity`` was found."""
        return all(d.severity <= max_severity for d in self.diagnostics)

    def render_text(self) -> str:
        if not self.diagnostics:
            return "no diagnostics"
        order = sorted(self.diagnostics,
                       key=lambda d: (-int(d.severity), d.code, d.op))
        lines = [d.render() for d in order]
        c = self.counts()
        lines.append("summary: " + ", ".join(
            f"{c.get(s, 0)} {s}" for s in ("ERROR", "WARN", "INFO")))
        return "\n".join(lines)

    def render_json(self) -> str:
        return json.dumps(
            {"diagnostics": [d.to_dict() for d in self.diagnostics],
             "counts": self.counts()}, indent=2)


def validate_report_json(obj) -> List[str]:
    """Schema check for a ``render_json()`` report.  Returns problem
    strings — empty means valid."""
    probs: List[str] = []
    if not isinstance(obj, dict):
        return ["report must be an object"]
    diags = obj.get("diagnostics")
    if not isinstance(diags, list):
        probs.append("diagnostics: want a list")
        diags = []
    for d in diags:
        if not isinstance(d, dict):
            probs.append(f"diagnostic must be an object, got {d!r}")
            continue
        code = d.get("code")
        if code not in CODES:
            probs.append(f"unknown code {code!r}")
        if d.get("severity") not in ("INFO", "WARN", "ERROR"):
            probs.append(f"{code}: bad severity {d.get('severity')!r}")
        for key in ("op", "message", "hint"):
            if not isinstance(d.get(key), str):
                probs.append(f"{code}: {key} must be a string")
        if not (isinstance(d.get("count"), int) and d["count"] >= 1):
            probs.append(f"{code}: count must be a positive int")
    counts = obj.get("counts")
    if not isinstance(counts, dict):
        probs.append("counts: want an object")
    else:
        for sev, n in counts.items():
            if sev not in ("INFO", "WARN", "ERROR") \
                    or not isinstance(n, int):
                probs.append(f"counts[{sev!r}]: bad entry")
        got = {}
        for d in diags:
            if isinstance(d, dict):
                got[d.get("severity")] = got.get(d.get("severity"), 0) + 1
        if got != counts:
            probs.append(f"counts {counts} disagree with diagnostics "
                         f"{got}")
    return probs


class VerificationError(ValueError):
    """Raised by ``FFModel.compile(verify="error")`` when the verifier
    finds ERROR diagnostics; carries the full report."""

    def __init__(self, report: DiagnosticReport):
        self.report = report
        errs = report.errors
        super().__init__(
            f"{len(errs)} verifier error(s):\n"
            + "\n".join(d.render() for d in errs))
