"""flexflow_tpu_torch.obs — the observability plane, the port of
``flexflow_tpu/obs``: span tracing (:mod:`.trace`), the flight recorder
(:mod:`.flight`), the typed metrics registry with Prometheus text
exposition and its HTTP scrape endpoint (:mod:`.registry`), runtime
lock-order observation (:mod:`.lockwatch`) and the declared event names
(:mod:`.events`).
Host-only: nothing here imports torch.
"""

from .events import EVENTS, declared_events
from .flight import FlightRecorder, flight_dump, get_flight
from .registry import (MetricsRegistry, get_registry, render_prometheus,
                       start_metrics_server, validate_prometheus_text)
from .trace import (TERMINAL_PHASES, Tracer, get_tracer, phase_of,
                    to_chrome, tracer_from_config, validate_chrome_trace,
                    validate_raw_trace)

__all__ = [
    "EVENTS", "declared_events",
    "FlightRecorder", "get_flight", "flight_dump",
    "MetricsRegistry", "get_registry", "render_prometheus",
    "start_metrics_server", "validate_prometheus_text",
    "TERMINAL_PHASES", "Tracer", "get_tracer", "phase_of", "to_chrome",
    "tracer_from_config", "validate_chrome_trace", "validate_raw_trace",
]
