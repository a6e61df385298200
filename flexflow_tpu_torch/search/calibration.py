"""The start of the JAX package's ``search/calibration.py``: the content
digest its tables and the warm-start store share, and the uncalibrated
branch of ``estimator_from_config``.  The calibration tables, the table
and ridge estimators, harvesting and ``calibrate`` are ROADMAP A.9b.
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict, Optional, Tuple


def content_digest(payload: Dict) -> str:
    """Canonical content digest (sorted-key JSON, ``digest`` excluded):
    two payloads with the same content have the same digest on any
    machine, and in either package."""
    body = {k: v for k, v in payload.items() if k != "digest"}
    blob = json.dumps(body, sort_keys=True,
                      separators=(",", ":")).encode()
    return "sha256:" + hashlib.sha256(blob).hexdigest()[:16]


def estimator_from_config(cfg) -> Tuple[Optional[object], Optional[object]]:
    """(estimator, table) for ``cfg.cost_estimator`` /
    ``cfg.calibration_file``: ``(None, None)`` — the analytic roofline,
    no table — for the uncalibrated default (no file, estimator
    ``"auto"`` or ``"analytic"``).  Any other setting raises
    NotImplementedError: the calibration tables and their estimators
    are not ported yet (ROADMAP A.9b)."""
    path = getattr(cfg, "calibration_file", "") or ""
    name = getattr(cfg, "cost_estimator", "auto") or "auto"
    if not path and name in ("auto", "analytic"):
        return None, None
    raise NotImplementedError(
        f"calibrated cost model (calibration_file={path!r}, "
        f"cost_estimator={name!r}) is not ported yet (ROADMAP A.9b); "
        f"the port's search runs the analytic roofline or measure mode")
