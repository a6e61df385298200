"""Static co-residency gate, the port of
``flexflow_tpu/serving/fleet/gate.py``: do N models fit on one card?

Device-free: per tenant it builds the registry's uncompiled graph,
resolves its strategy, and computes

* ``ff108_bytes``: the peak through the accounting the single-model
  FF108 check uses (``Simulator.peak_memory_bytes`` times the port's
  measured :data:`~...search.cost_model.TEMP_FACTOR`, with
  ``opt_slot_bytes=0``: a serving tenant holds no optimizer state), plus
  the KV cache of a generation tenant;
* ``resident_bytes``: the always-resident part alone, parameter bytes
  placed by ``param_spec`` on the AbstractMesh plus
  ``analysis.kv_memory``'s KV bytes (and a speculative draft's
  parameters and pool).  It equals the engines' allocated tensor bytes
  byte for byte (``FleetEngine.stats()[name]["resident_bytes"]``).

The verdict sums ``ff108_bytes`` over tenants against the card's memory
(``search.cost_model.spec_for_device``; an H100 SXM's 80 GB): over it,
**FF130** (ERROR); each tenant adds an **FF131** INFO row; **FF132**
refuses a role-tagged topology KV migration cannot serve.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ...analysis.diagnostics import DiagnosticReport, make
from ...analysis.kv_memory import (DEFAULT_PAGE_SIZE, default_serve_seq,
                                   dtype_bytes, kv_cache_bytes,
                                   kv_page_plan)
from ...analysis.strategy_passes import infer_mesh_shape
from ...parallel.mesh import AbstractMesh
from .registry import ModelRegistry, TenantSpec

# parameters are held in the f32 master dtype (FFConfig.param_dtype)
PARAM_BYTES = 4


def _subaxis_sizes(mesh: AbstractMesh) -> Dict[str, int]:
    """size of every axis name a PartitionSpec entry can mention:
    canonical axes ("n") and their prime sub-axes ("n0", "n1", ...)."""
    out: Dict[str, int] = {}
    for a, size in mesh.sizes.items():
        out[a] = size
        for nm, f in zip(mesh.subaxes(a), mesh._subfactors[a]):
            out[nm] = f
    return out


def static_params_bytes(layers, strategies, mesh: AbstractMesh) -> float:
    """Per-device parameter bytes under the strategy — placed by the
    SAME ``param_spec`` the model uses (on the AbstractMesh), so the
    static number equals what ``init_layers`` actually allocates per
    device."""
    from ...parallel.sharding import param_spec
    sizes = _subaxis_sizes(mesh)
    total = 0.0
    for op in layers:
        pc = (strategies or {}).get(op.name)
        for w in op.weights:
            spec = param_spec(w, pc, mesh, on_fallback=lambda *a: None)
            parts = 1
            for entry in spec:
                if entry is None:
                    continue
                names = ((entry,) if isinstance(entry, str)
                         else tuple(entry))
                for nm in names:
                    parts *= sizes.get(nm, 1)
            vol = 1
            for s in w.shape:
                vol *= int(s)
            total += vol * PARAM_BYTES / parts
    return total


def model_residency(spec: TenantSpec, layers, input_tensors, strategies,
                    mesh_shape: Optional[Dict[str, int]] = None,
                    device_spec=None,
                    xla_temp_factor: Optional[float] = None,
                    compute_dtype: str = "float32",
                    model_config=None, draft=None) -> Dict:
    """One tenant's per-device memory prediction (see module
    docstring).  ``mesh_shape`` defaults to the strategy-inferred mesh
    (as the verifier infers it).  ``model_config`` (the built tenant's
    FFConfig) supplies the SAME fallbacks the GenerationEngine resolves
    — page geometry (``serve_kv_page``/``serve_kv_pages``) and the
    compute dtype — so a knob set in the builder's config rather than
    the fleet spec still reaches the gate's accounting.

    ``draft`` — ``(draft_name, draft_layers, draft_strategies)`` when
    the tenant's generation section references a speculative-decoding
    draft entry: the draft's params PLUS its own KV page pool (SAME
    slots/seq/page geometry/dtype as the target — the engine mirrors
    positions 1:1) are charged onto this tenant's residency, because
    that is exactly what its GenerationEngine allocates."""
    from ...search.cost_model import spec_for_device
    from ...search.simulator import Simulator

    device_spec = device_spec or spec_for_device()
    factor = (float(xla_temp_factor) if xla_temp_factor
              else device_spec.temp_factor)
    if mesh_shape is None:
        if strategies:
            mesh_shape, _ = infer_mesh_shape(strategies, layers, 10 ** 9)
        else:
            # no strategy: the tenant serves replicated — every device
            # holds the full model, so the per-device view is {n: 1}
            mesh_shape = {"n": 1}
    mesh = AbstractMesh(mesh_shape)
    kv = 0.0
    slots = seq = 0
    kv_pages = kv_page = 0
    plan = None
    if model_config is not None:
        compute_dtype = getattr(model_config, "compute_dtype",
                                compute_dtype)
    if spec.engine == "generation":
        slots = int(spec.generation.get("slots", 8))
        seq = (int(spec.generation.get("max_seq", 0))
               or default_serve_seq(input_tensors) or 0)
        # the tenant's paged-KV geometry: the SAME resolution chain
        # the GenerationEngine runs — spec key, else the builder's
        # FFConfig, else the kv_memory defaults — so gate and runtime
        # integrate one pool no matter where the knob was set
        kv_page = (int(spec.generation.get("page_size", 0))
                   or int(getattr(model_config, "serve_kv_page", 0)))
        kv_pages = (int(spec.generation.get("num_pages", 0))
                    or int(getattr(model_config, "serve_kv_pages", 0)))
        if slots > 0 and seq > 0:
            plan = kv_page_plan(layers, mesh_shape, slots, seq,
                                kv_dtype_bytes=dtype_bytes(compute_dtype),
                                page_size=kv_page or DEFAULT_PAGE_SIZE,
                                num_pages=kv_pages)
            kv = plan["total_bytes"]
    sim = Simulator(spec=device_spec,
                    num_devices=max(1, mesh.mesh_product),
                    opt_slot_bytes=0)
    peak = sim.peak_memory_bytes(layers, strategies or {}, mesh_shape,
                                 assume_remat=False) * factor
    params = static_params_bytes(layers, strategies, mesh)
    quant_delta = 0.0
    if getattr(spec, "quantize", "") == "int8":
        # int8 weight-quantized tenant: the eligible f32
        # kernel shards are replaced by int8 shards + replicated
        # per-channel scales — the SAME eligibility predicate and
        # placement rules quantize_params applies at engine warmup,
        # so resident_bytes stays pinned byte-for-byte against the
        # engine's real allocation
        from ..quantize import quantized_params_bytes_delta
        quant_delta = quantized_params_bytes_delta(layers, strategies,
                                                   mesh)
        params += quant_delta
    draft_name = ""
    draft_bytes = 0.0
    if draft is not None:
        draft_name, draft_layers, draft_strategies = draft
        draft_bytes = static_params_bytes(draft_layers,
                                          draft_strategies, mesh)
        if slots > 0 and seq > 0:
            draft_bytes += kv_cache_bytes(
                draft_layers, mesh_shape, slots, seq,
                kv_dtype_bytes=dtype_bytes(compute_dtype),
                page_size=kv_page or DEFAULT_PAGE_SIZE,
                num_pages=kv_pages)
    role = getattr(spec, "role", "mixed")
    staging = 0.0
    if plan is not None and role == "prefill":
        # disaggregated prefill engines: at migration one stream's
        # covering page chain is materialized as a contiguous staging
        # copy (export_pages' packed gather feeding the host copy).
        # Transient, but the FF132 topology contract charges one
        # chain's worth as prefill headroom so the gate and the router
        # cannot diverge on whether a migrating fleet fits.
        staging = plan["pages_per_slot"] * plan["page_bytes"]
    return {
        "name": spec.name,
        "engine": spec.engine,
        "role": role,
        "mesh": {a: s for a, s in mesh_shape.items() if s > 1} or {"n": 1},
        "params_bytes": params,
        "quantize": getattr(spec, "quantize", ""),
        "quantize_bytes_delta": quant_delta,
        "kv_bytes": kv,
        "kv_slots": slots,
        "kv_seq": seq,
        # resolved page geometry (0 = not a sized generation tenant):
        # the FF132 disagg checks compare these across roles
        "kv_page_size": plan["page_size"] if plan else 0,
        "kv_num_pages": plan["num_pages"] if plan else 0,
        "kv_pages_per_slot": plan["pages_per_slot"] if plan else 0,
        "staging_bytes": staging,
        "draft": draft_name,
        "draft_bytes": draft_bytes,
        # the byte-for-byte pin vs the engine's real allocation (the
        # staging copy is a migration-time transient, NOT part of the
        # always-resident pin)
        "resident_bytes": params + kv + draft_bytes,
        # the gate quantity: FF108 accounting + the unscaled KV scalar
        # (a preallocated buffer has no temporaries).  The quantization
        # delta rides UNSCALED too, like the KV cache: an int8 buffer
        # swap has no temporary component.  The draft's params + pool
        # are preallocated residency of the SAME kind.  Prefill-role
        # tenants additionally carry the migration staging chain.
        "ff108_bytes": peak + kv + quant_delta + draft_bytes + staging,
    }


def resolve_budget(hbm_gb: float, device_spec=None) -> float:
    """The per-device memory budget in bytes: an explicit ``hbm_gb``
    override, else the device spec's capacity."""
    from ...search.cost_model import spec_for_device
    device_spec = device_spec or spec_for_device()
    return hbm_gb * 1e9 if hbm_gb > 0 else device_spec.hbm_capacity


def fleet_gate_report(registry: ModelRegistry,
                      hbm_gb: float = 0.0,
                      device_spec=None,
                      xla_temp_factor: Optional[float] = None
                      ) -> Tuple[DiagnosticReport, List[Dict]]:
    """The co-residency verdict for a whole registry: per-tenant
    residency rows (FF131 INFO) and the summed-vs-HBM gate (FF130
    ERROR when the fleet does not fit).  ``hbm_gb`` overrides the
    device spec's HBM capacity (the registry file's ``hbm_gb`` is the
    caller's usual source)."""
    from ...search.cost_model import spec_for_device

    device_spec = device_spec or spec_for_device()
    hbm = resolve_budget(hbm_gb, device_spec)
    report = DiagnosticReport()
    rows: List[Dict] = []
    total = 0.0
    for name in registry.names():
        spec = registry.spec(name)
        if spec.engine == "draft":
            # draft entries are charged onto the tenant that references
            # them (exactly where their params + pool live at runtime),
            # never as standalone rows — a double count would fail
            # fleets that actually fit
            continue
        model, strategies = registry.graph(name)
        draft = None
        dname = str(spec.generation.get("draft", ""))
        if dname:
            dmodel, dstrat = registry.graph(dname)
            draft = (dname, dmodel.layers, dstrat)
        row = model_residency(spec, model.layers, model.input_tensors,
                              strategies, device_spec=device_spec,
                              xla_temp_factor=xla_temp_factor,
                              model_config=model.config, draft=draft)
        rows.append(row)
        total += row["ff108_bytes"]
        kv_note = (f" + {row['kv_bytes'] / 1e9:.2f} GB KV "
                   f"({row['kv_slots']} slots x {row['kv_seq']})"
                   if row["kv_bytes"] else "")
        draft_note = (f" + {row['draft_bytes'] / 1e9:.2f} GB draft "
                      f"({row['draft']})" if row["draft_bytes"] else "")
        report.add(make(
            "FF131", name,
            f"[{row['engine']}] mesh {row['mesh']}: "
            f"{row['ff108_bytes'] / 1e9:.2f} GB peak "
            f"({row['params_bytes'] / 1e9:.2f} GB params{kv_note}"
            f"{draft_note})"))
    # ---- FF132: disaggregated-topology checks ------------------------
    # A role-tagged fleet is a migration contract: the router ships KV
    # page chains from prefill-role tenants into decode-role pools, so
    # the gate must refuse topologies the migration protocol cannot
    # serve — BEFORE the first stream fails at import time.
    gen_rows = [r for r in rows if r["engine"] == "generation"]
    prefill_rows = [r for r in gen_rows if r["role"] == "prefill"]
    decode_rows = [r for r in gen_rows if r["role"] == "decode"]
    if prefill_rows and not any(r["role"] in ("decode", "mixed")
                                for r in gen_rows):
        report.add(make(
            "FF132", "",
            f"prefill-role tenant(s) "
            f"{[r['name'] for r in prefill_rows]} have no decode/mixed "
            f"migration target in this fleet",
            hint="tag a generation tenant role='decode' (or 'mixed') "
                 "or drop the prefill tag — a prefill engine with "
                 "nowhere to migrate decodes co-located forever"))
    for r in decode_rows:
        need = r["kv_slots"] * r["kv_pages_per_slot"]
        if need and r["kv_num_pages"] < need:
            report.add(make(
                "FF132", r["name"],
                f"decode pool has {r['kv_num_pages']} pages but "
                f"adopting {r['kv_slots']} migrated full-length "
                f"streams needs {need} "
                f"({r['kv_pages_per_slot']} pages x {r['kv_slots']} "
                f"slots)",
                hint="migrated chains arrive at full prompt length "
                     "with no shared-prefix guarantee — size "
                     "num_pages to slots x ceil(max_seq/page_size) "
                     "or lower slots"))
    role_sizes = {r["kv_page_size"] for r in gen_rows
                  if r["role"] != "mixed" and r["kv_page_size"]}
    if len(role_sizes) > 1:
        report.add(make(
            "FF132", "",
            f"prefill/decode tenants disagree on page_size "
            f"{sorted(role_sizes)} — import_pages requires identical "
            f"page geometry on both ends",
            hint="set one generation.page_size across every "
                 "role-tagged tenant"))
    if total > hbm:
        worst = max(rows, key=lambda r: r["ff108_bytes"])
        report.add(make(
            "FF130", "",
            f"fleet of {len(rows)} model(s) needs "
            f"{total / 1e9:.2f} GB per device, budget is "
            f"{hbm / 1e9:.2f} GB; largest tenant: {worst['name']} "
            f"({worst['ff108_bytes'] / 1e9:.2f} GB)",
            hint="unload a tenant, shard the largest one wider, or "
                 "serve on more HBM — the same fleet minus one model "
                 "may already pass"))
    return report, rows


__all__ = ["fleet_gate_report", "model_residency", "resolve_budget",
           "static_params_bytes"]
