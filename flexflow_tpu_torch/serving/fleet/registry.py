"""Model fleet registry, the port of
``flexflow_tpu/serving/fleet/registry.py``: name -> (builder, checkpoint,
strategy, engine kind, fairness and admission knobs) for multi-tenant
serving.

A fleet is declared programmatically (``ModelRegistry().register(...)``)
or as a JSON file (``ModelRegistry.from_file``) of the JAX package's
schema, for example ``examples/serving/fleet.json``.  ``model`` names a
builtin graph builder (:func:`builtin_builders`: the same names and
zero-config widths as the JAX package's table); programmatic
registration takes any ``builder(cfg, device) -> FFModel`` returning the
uncompiled graph on ``device``.  :meth:`ModelRegistry.graph` builds that
graph on the CPU, allocating no parameters (what the co-residency gate
reads), and :func:`build_model` compiles and initialises it on the
serving device.  :func:`validate_fleet_json` is the one schema check.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Callable, Dict, List, Optional

# roles a host/tenant may take in a disaggregated cluster: "prefill" engines
# serve prefill chunks then migrate the KV page chain out, "decode"
# engines adopt migrated streams and dispatch nothing but decode
# steps, "mixed" (the default) does both co-located
TENANT_ROLES = ("prefill", "decode", "mixed")

# "draft" tenants are graphs co-hosted ONLY as a generation tenant's
# speculative-decoding draft (referenced via generation.draft): the
# fleet builds their params but never starts an engine for them — the
# referencing tenant's GenerationEngine drives the draft directly
ENGINE_KINDS = ("dense", "generation", "draft")

# knobs a fleet entry may override per engine kind; validated here so a
# typo'd knob fails at load, not as an ignored key
_SERVE_KEYS = frozenset((
    "max_batch", "max_wait_ms", "buckets", "max_queue_rows", "admission",
    "starvation_ms", "stats_every"))
_GEN_KEYS = frozenset((
    "slots", "max_seq", "max_new_tokens", "eos_id", "max_queue_requests",
    "admission", "starvation_ms", "stats_every",
    # paged KV knobs: the co-residency gate reads the SAME keys
    # (serving/fleet/gate.py), so a tenant's page geometry and its FF130
    # accounting cannot diverge
    "page_size", "num_pages", "prefill_chunk", "prefix_cache",
    # speculative decoding: "draft" names a co-registered
    # engine="draft" entry; the gate charges its params + draft KV pool
    # against the same hbm_gb budget (FF130)
    "draft", "spec_gamma", "spec_gamma_max", "spec_policy"))


@dataclasses.dataclass
class TenantSpec:
    """One fleet entry: everything needed to build, gate and serve a
    tenant.  ``builder(cfg, device) -> FFModel`` returns the UNCOMPILED
    graph on ``device``;
    ``weight`` is the weighted-fair device-time share, ``qps_rows`` an
    optional rows/s budget (0 = unlimited; generation tenants budget
    requests/s — one row each)."""

    name: str
    builder: Callable
    engine: str = "dense"
    checkpoint: str = ""
    strategy: str = ""
    weight: float = 1.0
    qps_rows: float = 0.0
    batch_size: int = 0
    # "" = full precision; "int8" = weight-only quantized serving
    # (dense tenants only — FFModel.quantize_weights at engine warmup;
    # the co-residency gate accounts the int8 footprint byte-for-byte)
    quantize: str = ""
    # disaggregated-cluster role (TENANT_ROLES); only meaningful for
    # generation tenants — the router routes prompts to "prefill"/
    # "mixed" and migrates KV pages to "decode", and the FF132 gate
    # sizes decode pools / charges prefill staging bytes off this tag
    role: str = "mixed"
    serve: Dict = dataclasses.field(default_factory=dict)
    generation: Dict = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if "quantize" in self.serve:
            # quantize rides ONLY as the top-level TenantSpec field:
            # smuggled through the serve{} pass-through it would reach
            # the engine (cfg.serve_quantize) while the co-residency
            # gate — which keys on spec.quantize — still predicted f32
            # bytes, breaking the byte-for-byte pin
            raise ValueError(
                f"tenant {self.name!r}: put quantize at the tenant "
                f"level, not inside serve{{}}")
        if self.quantize not in ("", "int8"):
            raise ValueError(
                f"tenant {self.name!r}: quantize must be '' or 'int8', "
                f"got {self.quantize!r}")
        if self.quantize and self.engine != "dense":
            raise ValueError(
                f"tenant {self.name!r}: quantize applies to dense "
                f"tenants only (generation decode caches are not "
                f"weight-quantized)")
        if self.engine not in ENGINE_KINDS:
            raise ValueError(
                f"tenant {self.name!r}: engine must be one of "
                f"{ENGINE_KINDS}, got {self.engine!r}")
        if self.weight <= 0:
            raise ValueError(
                f"tenant {self.name!r}: weight must be > 0, got "
                f"{self.weight}")
        if self.qps_rows < 0:
            raise ValueError(
                f"tenant {self.name!r}: qps_rows must be >= 0 "
                f"(0 = unlimited), got {self.qps_rows}")
        if self.role not in TENANT_ROLES:
            raise ValueError(
                f"tenant {self.name!r}: role must be one of "
                f"{TENANT_ROLES}, got {self.role!r}")
        if self.role != "mixed" and self.engine != "generation":
            raise ValueError(
                f"tenant {self.name!r}: role {self.role!r} applies to "
                f"generation tenants only (dense/draft tenants have no "
                f"prefill/decode split to disaggregate)")
        if self.engine == "draft" and (self.serve or self.generation):
            raise ValueError(
                f"tenant {self.name!r}: draft entries serve no traffic "
                f"of their own — no serve{{}}/generation{{}} sections "
                f"(the referencing tenant's generation section carries "
                f"the speculation knobs)")


def builtin_builders() -> Dict[str, Callable]:
    """The fleet's builtin graph table: the JAX package's lint zoo under
    its names and zero-config widths, plus the token-generation LM
    builders.  Each takes ``(cfg, device)``."""
    from ...models import (build_alexnet, build_candle_uno, build_dlrm,
                           build_inception_v3, build_lstm_lm, build_nmt,
                           build_resnet50, build_transformer,
                           build_transformer_lm)
    return {
        "transformer": lambda cfg, device: build_transformer(
            cfg, device=device)[0],
        # 8 tables make the default interact width (8*64+64) match
        # mlp_top[0]=576
        "dlrm": lambda cfg, device: build_dlrm(
            cfg, embedding_size=(1000000,) * 8, device=device)[0],
        "alexnet": lambda cfg, device: build_alexnet(cfg,
                                                     device=device)[0],
        "resnet": lambda cfg, device: build_resnet50(cfg,
                                                     device=device)[0],
        "inception": lambda cfg, device: build_inception_v3(
            cfg, device=device)[0],
        "nmt": lambda cfg, device: build_nmt(cfg, device=device)[0],
        "candle_uno": lambda cfg, device: build_candle_uno(
            cfg, device=device)[0],
        "transformer_lm": lambda cfg, device: build_transformer_lm(
            cfg, num_layers=2, d_model=64, num_heads=4, d_ff=128,
            seq_len=64, vocab_size=128, device=device)[0],
        "lstm_lm": lambda cfg, device: build_lstm_lm(cfg,
                                                     device=device)[0],
    }


def validate_fleet_json(obj) -> List[str]:
    """Schema problems of a fleet registry JSON (empty list = valid):
    the JAX package's schema and messages, used by
    :meth:`ModelRegistry.from_json`."""
    probs: List[str] = []
    if not isinstance(obj, dict):
        return ["fleet file must be a JSON object"]
    fleet = obj.get("fleet")
    if not isinstance(fleet, list) or not fleet:
        return ["'fleet' must be a non-empty list of tenant entries"]
    if "hbm_gb" in obj and not isinstance(obj["hbm_gb"], (int, float)):
        probs.append("hbm_gb: want a number")
    # name -> engine kind pre-pass: generation.draft references another
    # entry IN THIS FILE, so the check needs the whole fleet first
    kinds = {e.get("name"): e.get("engine", "dense")
             for e in fleet if isinstance(e, dict)}
    seen = set()
    for i, e in enumerate(fleet):
        where = f"fleet[{i}]"
        if not isinstance(e, dict):
            probs.append(f"{where}: want an object")
            continue
        name = e.get("name")
        if not isinstance(name, str) or not name:
            probs.append(f"{where}: 'name' must be a non-empty string")
        elif name in seen:
            probs.append(f"{where}: duplicate tenant name {name!r}")
        else:
            seen.add(name)
        if not isinstance(e.get("model"), str) or not e.get("model"):
            probs.append(f"{where}: 'model' must name a builtin builder")
        kind = e.get("engine", "dense")
        if kind not in ENGINE_KINDS:
            probs.append(f"{where}: engine must be one of "
                         f"{', '.join(ENGINE_KINDS)}, got {kind!r}")
        role = e.get("role", "mixed")
        if role not in TENANT_ROLES:
            probs.append(f"{where}: role must be one of "
                         f"{', '.join(TENANT_ROLES)}, got {role!r}")
        elif role != "mixed" and kind != "generation":
            probs.append(f"{where}: role {role!r} applies to generation "
                         f"tenants only")
        for key, want in (("checkpoint", str), ("strategy", str)):
            if key in e and not isinstance(e[key], want):
                probs.append(f"{where}: {key} must be a string")
        if "quantize" in e and e["quantize"] not in ("", "int8"):
            probs.append(f"{where}: quantize must be '' or 'int8'")
        if e.get("quantize") and kind != "dense":
            probs.append(f"{where}: quantize applies to dense tenants "
                         f"only")
        for key in ("weight", "qps_rows"):
            if key in e and not isinstance(e[key], (int, float)):
                probs.append(f"{where}: {key} must be a number")
        if "weight" in e and isinstance(e["weight"], (int, float)) \
                and e["weight"] <= 0:
            probs.append(f"{where}: weight must be > 0")
        if "qps_rows" in e and isinstance(e["qps_rows"], (int, float)) \
                and e["qps_rows"] < 0:
            probs.append(f"{where}: qps_rows must be >= 0")
        if "batch_size" in e and not (isinstance(e["batch_size"], int)
                                      and e["batch_size"] >= 1):
            probs.append(f"{where}: batch_size must be an int >= 1")
        for section, allowed in (("serve", _SERVE_KEYS),
                                 ("generation", _GEN_KEYS)):
            sec = e.get(section)
            if sec is None:
                continue
            if not isinstance(sec, dict):
                probs.append(f"{where}: {section} must be an object")
                continue
            unknown = sorted(set(sec) - allowed)
            if unknown:
                probs.append(f"{where}: unknown {section} key(s) "
                             f"{unknown} (have {sorted(allowed)})")
            # paged-KV geometry keys: a negative value would flow into
            # the gate's kv_memory math as a NEGATIVE HBM charge
            for key in ("page_size", "num_pages", "prefill_chunk"):
                if key in sec and not (isinstance(sec[key], int)
                                       and sec[key] >= 0):
                    probs.append(f"{where}: {section}.{key} must be an "
                                 f"int >= 0 (0 = default/auto)")
            if section != "generation":
                continue
            # speculative-decoding knobs: the draft reference must
            # resolve INSIDE this file to an engine="draft" entry, or
            # the gate would charge a tenant the file never declares
            if "draft" in sec:
                d = sec["draft"]
                if not isinstance(d, str) or not d:
                    probs.append(f"{where}: generation.draft must name "
                                 f"a fleet entry")
                elif d not in kinds:
                    probs.append(f"{where}: generation.draft {d!r} is "
                                 f"not a fleet entry in this file")
                elif kinds[d] != "draft":
                    probs.append(f"{where}: generation.draft {d!r} "
                                 f"must have engine 'draft', has "
                                 f"{kinds[d]!r}")
            for key in ("spec_gamma", "spec_gamma_max"):
                if key in sec and not (isinstance(sec[key], int)
                                       and sec[key] >= 0):
                    probs.append(f"{where}: generation.{key} must be "
                                 f"an int >= 0")
            if "spec_gamma" in sec and isinstance(sec["spec_gamma"],
                                                  int) \
                    and sec["spec_gamma"] == 1:
                probs.append(f"{where}: generation.spec_gamma must be "
                             f"0 (off) or >= 2")
            if sec.get("spec_policy") is not None \
                    and sec["spec_policy"] not in ("fixed", "adaptive"):
                probs.append(f"{where}: generation.spec_policy must be "
                             f"'fixed' or 'adaptive'")
        if kind == "generation" and e.get("serve"):
            probs.append(f"{where}: generation tenants take a "
                         f"'generation' section, not 'serve'")
        if kind == "draft" and (e.get("serve") or e.get("generation")):
            probs.append(f"{where}: draft entries take no serve/"
                         f"generation sections (they serve no traffic "
                         f"of their own)")
    return probs


class ModelRegistry:
    """name → :class:`TenantSpec`.  The fleet engine builds serving
    tenants from it; the co-residency gate reads its device-free
    graphs."""

    def __init__(self):
        self._specs: Dict[str, TenantSpec] = {}
        self.hbm_gb: float = 0.0

    # ---- construction --------------------------------------------------
    def register(self, name: str, builder: Callable, **kw) -> TenantSpec:
        """Register (or replace — hot-swap re-registers) one tenant."""
        spec = TenantSpec(name=name, builder=builder, **kw)
        self._specs[name] = spec
        return spec

    @classmethod
    def from_json(cls, obj, builders: Optional[Dict] = None
                  ) -> "ModelRegistry":
        probs = validate_fleet_json(obj)
        if probs:
            raise ValueError("invalid fleet registry: "
                             + "; ".join(probs[:5]))
        builders = builders or builtin_builders()
        reg = cls()
        reg.hbm_gb = float(obj.get("hbm_gb", 0.0))
        for e in obj["fleet"]:
            if e["model"] not in builders:
                raise ValueError(
                    f"tenant {e['name']!r}: unknown model "
                    f"{e['model']!r} (have {', '.join(sorted(builders))})")
            reg.register(
                e["name"], builders[e["model"]],
                engine=e.get("engine", "dense"),
                checkpoint=e.get("checkpoint", ""),
                strategy=e.get("strategy", ""),
                weight=float(e.get("weight", 1.0)),
                qps_rows=float(e.get("qps_rows", 0.0)),
                batch_size=int(e.get("batch_size", 0)),
                quantize=str(e.get("quantize", "")),
                role=str(e.get("role", "mixed")),
                serve=dict(e.get("serve", {})),
                generation=dict(e.get("generation", {})))
        return reg

    @classmethod
    def from_file(cls, path: str, builders: Optional[Dict] = None
                  ) -> "ModelRegistry":
        with open(path) as f:
            obj = json.load(f)
        return cls.from_json(obj, builders)

    # ---- access --------------------------------------------------------
    def names(self) -> List[str]:
        return sorted(self._specs)

    def spec(self, name: str) -> TenantSpec:
        try:
            return self._specs[name]
        except KeyError:
            raise KeyError(f"no tenant {name!r} in the fleet registry "
                           f"(have {', '.join(self.names())})") from None

    def __contains__(self, name: str) -> bool:
        return name in self._specs

    def __len__(self) -> int:
        return len(self._specs)

    # ---- building ------------------------------------------------------
    def graph(self, name: str):
        """The tenant's UNCOMPILED graph + resolved strategies, built on
        the CPU with no parameter allocated: what the co-residency gate
        reads.  Returns ``(model, strategies_or_None)``."""
        spec = self.spec(name)
        model = spec.builder(_tenant_config(spec), "cpu")
        strategies = None
        if spec.strategy:
            from ...strategy.proto import load_strategy_file
            strategies = load_strategy_file(spec.strategy)
        return model, strategies

    def build(self, name: str, device=None):
        """Compile + initialize the tenant's model for serving (see
        :func:`build_model`)."""
        return build_model(self.spec(name), device=device)


def _tenant_config(spec: TenantSpec):
    from ...config import FFConfig
    cfg = FFConfig(compute_dtype="float32")
    if spec.batch_size:
        cfg.batch_size = spec.batch_size
    if spec.quantize:
        # the ServingEngine quantizes at warmup when this is set
        cfg.serve_quantize = spec.quantize
    for k, v in spec.serve.items():
        attr = "serve_" + k
        if hasattr(cfg, attr):
            setattr(cfg, attr, v)
    return cfg


def build_model(spec: TenantSpec, device=None):
    """Compile + initialize one tenant's model for serving on ``device``
    (None: the card): strategy ``.pb`` resolved into per-op configs
    (verified at compile), checkpoint restored when given.  This is the
    expensive path; the fleet engine runs a load on a background thread
    so it never stalls serving.  The ``fleet_load_fail:<name>`` FF_FAULT
    kind injects a deterministic build failure here."""
    from ... import faults
    for fspec in faults.fleet_faults():
        if fspec.kind == "fleet_load_fail" and fspec.arg == spec.name:
            raise RuntimeError(
                f"FF_FAULT: injected fleet load failure for "
                f"model {spec.name!r}")
    cfg = _tenant_config(spec)
    if spec.strategy:
        cfg.import_strategy_file = spec.strategy
    from ...model import default_device
    model = spec.builder(cfg, default_device() if device is None
                         else device)
    from ...optimizers import SGDOptimizer
    model.compile(SGDOptimizer(lr=0.01))
    model.init_layers(seed=cfg.seed)
    if spec.checkpoint:
        model.load_checkpoint(spec.checkpoint)
    return model


__all__ = ["ModelRegistry", "TenantSpec", "validate_fleet_json",
           "builtin_builders", "build_model", "ENGINE_KINDS",
           "TENANT_ROLES"]
