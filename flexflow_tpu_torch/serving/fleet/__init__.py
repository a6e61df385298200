"""flexflow_tpu_torch.serving.fleet — multi-tenant serving, the port of
``flexflow_tpu/serving/fleet``: N models on one card.

* :class:`ModelRegistry` / :class:`TenantSpec` — name -> builder,
  checkpoint, strategy, engine kind and fairness/admission knobs (a JSON
  file of the JAX package's schema, or programmatic);
* :class:`FleetEngine` — one dispatcher multiplexing every resident
  engine under weighted-fair device-time scheduling, with hot
  load/unload/swap at dispatch boundaries;
* :func:`fleet_gate_report` — the device-free co-residency gate.
"""

from .autoscale import TenantAutoscaler
from .engine import FleetEngine
from .gate import fleet_gate_report, model_residency, static_params_bytes
from .registry import (ENGINE_KINDS, TENANT_ROLES, ModelRegistry,
                       TenantSpec, build_model, builtin_builders,
                       validate_fleet_json)

__all__ = ["FleetEngine", "ModelRegistry", "TenantSpec",
           "TenantAutoscaler",
           "fleet_gate_report", "model_residency", "static_params_bytes",
           "validate_fleet_json", "builtin_builders", "build_model",
           "ENGINE_KINDS", "TENANT_ROLES"]
