"""Static strategy and graph verification with structured diagnostics,
the JAX package's ``analysis`` package.

One legality story: the search's candidate degrees, the sharding specs'
replicate fallbacks and this verifier all judge a ``ParallelConfig``
through :mod:`analysis.legality`.  Entry points:

* :func:`verify` — static, device-free graph + strategy verification;
* :func:`verify_compile` — the ``FFModel.compile(verify=...)`` hook;
* :func:`kv_cache_bytes` / :func:`kv_page_plan` — the paged KV pool's
  bytes, which the generation engine allocates and the memory gate
  charges;
* :func:`explain_report` / :func:`render_explain_text` /
  :func:`validate_explain_json` — the device-free ``explain`` report of
  a (graph, strategy, mesh).
"""

from .diagnostics import (CODES, Diagnostic, DiagnosticReport, Severity,
                          VerificationError, make, validate_report_json)
from .kv_memory import (kv_cache_bytes, kv_cache_layout, kv_page_plan,
                        pages_per_slot)
from .legality import config_diagnostics, degree_executable, per_dim_degrees
from .sharding_passes import (comm_plan_digest, comm_plan_digest_for_model,
                              communication_plan, explain_report,
                              predict_fallbacks, propagate_specs,
                              render_explain_text, validate_explain_json)
from .verifier import (drain_fallback_sites, drain_replicate_fallbacks,
                       record_replicate_fallback, verify, verify_compile)

__all__ = [
    "CODES", "Diagnostic", "DiagnosticReport", "Severity",
    "VerificationError", "make", "config_diagnostics", "degree_executable",
    "per_dim_degrees", "verify", "verify_compile",
    "record_replicate_fallback", "drain_replicate_fallbacks",
    "drain_fallback_sites", "predict_fallbacks", "propagate_specs",
    "communication_plan", "comm_plan_digest", "comm_plan_digest_for_model",
    "explain_report", "render_explain_text", "validate_explain_json",
    "validate_report_json", "kv_cache_bytes", "kv_cache_layout",
    "kv_page_plan", "pages_per_slot",
]
