"""The event-name registry: every structured event the port emits
through ``fflogger.Category.event`` is declared here with a one-line
contract, the names and contracts of ``flexflow_tpu/obs/events.py``
(the training and elastic names are kept for the slices that port
them).  Dependency-free on purpose: fflogger must never import anything
that imports fflogger back."""

from __future__ import annotations

# name -> one-line contract (who emits it, what a consumer may rely on)
EVENTS = {
    # ---- training / elastic ------------------------------------------
    "epoch": "fit(): one record per epoch (loss/metrics, dispatch_ms)",
    "reshard": "FFModel.reshard(): in-process mesh change applied",
    "reshard_on_resume": "load_checkpoint/elastic_resume: topology "
                         "mismatch detected, params re-placed",
    "checkpoint_skipped": "elastic resume skipped a corrupt/invalid "
                          "newest checkpoint for an older valid one",
    "degrade": "elastic supervisor halved the process group after "
               "repeated topology-class failures",
    # ---- serving (dense) ---------------------------------------------
    "serve_stats": "ServingMetrics.emit(): rolling snapshot (a view "
                   "over the obs.registry counters)",
    "serve_health": "ServingEngine health-state edge "
                    "(starting/serving/degraded/draining/stopped)",
    "serve_drain": "ServingEngine.drain() began",
    "serve_drain_abandoned": "drain timeout twice over: dispatcher "
                             "wedged in-flight, daemon thread abandoned",
    "quantize_weights": "FFModel.quantize_weights(): eligible kernels "
                        "replaced by int8 + per-channel scales "
                        "(bytes before/after, max-abs-error vs bound)",
    "serve_dispatch_error": "one poisoned packed dispatch failed its "
                            "futures (engine keeps serving)",
    # ---- serving (generation) ----------------------------------------
    "gen_stats": "GenerationMetrics.emit(): serve_stats + token gauges",
    "gen_engine_start": "GenerationEngine started (slots, KV bytes)",
    "gen_drain": "GenerationEngine.drain() began",
    "gen_fault_cancel": "serve_cancel_at_token fault cancelled a stream",
    "gen_decode_error": "a poisoned decode step failed the active "
                        "streams; cache re-armed, engine keeps serving",
    "gen_prefill_error": "a poisoned prefill failed the joining stream "
                         "(and in-flight streams: donated cache)",
    # ---- serving (fleet) ---------------------------------------------
    "fleet_start": "FleetEngine dispatcher started",
    "fleet_stats": "periodic fleet fairness snapshot (per-tenant vtime)",
    "fleet_publish": "atomic tenant publish (load/swap) applied",
    "fleet_publish_discarded": "publish raced shutdown and was dropped",
    "fleet_load_error": "background tenant build failed; serving "
                        "tenants untouched",
    "fleet_unload": "tenant unloaded (drained through normal dispatch)",
    "fleet_retired": "swapped-out generation engine finished its last "
                     "in-flight stream and stopped",
    "fleet_drain": "FleetEngine.drain() began",
    "fleet_autoscale": "autoscaler changed a tenant's weight from its "
                       "rolling queue-depth window (old/new weight)",
    # ---- serving (disaggregated cluster) ------------------------------
    "router_start": "FleetRouter started fronting role-tagged hosts",
    "router_host_down": "a host was marked down; its tenants' queued "
                        "requests drained to surviving hosts",
    "router_stop": "FleetRouter stopped (routes/migrations totals)",
    # ---- observability plane (this package) --------------------------
    "flight_dump": "flight recorder wrote a post-mortem dump "
                   "(reason + path)",
}


def declared_events() -> frozenset:
    """The declared event names."""
    return frozenset(EVENTS)
